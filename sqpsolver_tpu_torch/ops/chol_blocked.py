"""Batched Cholesky of small SPD tiles + triangular inverse (torch port of
the JAX package's ``ops/chol_blocked.py``).

* :func:`chol_tile` is the wrapper of the hand-written Hopper kernel
  ``csrc/chol_tile.cu``, the port of the JAX package's one Pallas kernel
  (``_diag_kernel`` via ``chol_diag128``): an unblocked right-looking
  Cholesky of a batch of float32 SPD matrices with n <= 128, rsqrt pivots
  (a non-positive pivot yields a non-finite factor) and an exact-zero strict
  upper triangle.  A tensor on the CPU goes to :func:`chol_tile_plain`, the
  same column-step algorithm in torch ops; a CUDA tensor launches the kernel
  or raises.  Each launch adds one to ``chol_tile.launches``.
* :func:`tri_inv_doubling` is the log-depth product-doubling inverse of a
  lower-triangular matrix, as batched ``torch.matmul`` rounds.
* :func:`cholesky_blocked` and :func:`tri_inv_blocked` take any n.  Up to
  128 one tile is the whole matrix.  Beyond, the factorization is
  left-looking over 128-wide panels: per panel one batched correction
  product, one :func:`chol_tile` launch on the diagonal block, one doubling
  inverse of it and one panel-solve product; the inverse takes all
  diagonal-block inverses in one batched doubling pass and then the
  row-block recurrence.  The JAX package pads n to a multiple of 128 with an
  identity block because its kernel takes 128 only; ``chol_tile`` takes any
  n <= 128, so the last panel keeps its true width here (the padded rows only
  ever contribute exact zeros).

Float32 products here must be true float32: the solver turns TF32 off for
the duration of each solve (TF32 keeps ~3 digits and ruins the factor that
seeds the mixed-precision refinement).
"""

from __future__ import annotations

import ctypes
import functools

import torch

BLK = 128

def _check_tiles(M: torch.Tensor) -> None:
    if M.dtype != torch.float32:
        raise TypeError(f"chol_tile takes float32, got {M.dtype}")
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"chol_tile takes (B, n, n), got {tuple(M.shape)}")
    if M.shape[1] > BLK:
        raise ValueError(f"chol_tile takes n <= {BLK}, got n = {M.shape[1]}")


def chol_tile_plain(M: torch.Tensor) -> torch.Tensor:
    """The kernel's algorithm in torch ops: for each column j, an rsqrt pivot,
    the column scaled by it, and the rank-1 update of the trailing block.
    ``(B, n, n)`` float32 in and out."""
    _check_tiles(M)
    A = M.clone()
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    for j in range(n):
        inv_s = torch.rsqrt(A[:, j, j])
        colv = torch.where(rows >= j, A[:, :, j] * inv_s[:, None], 0.0)
        tail = colv[:, j + 1 :]
        A[:, j + 1 :, j + 1 :] -= tail[:, :, None] * tail[:, None, :]
        A[:, :, j] = colv
    return A


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built if needed, with its C signatures bound once."""
    from ._build import load_library

    lib = load_library("chol_tile")
    lib.sqp_chol_tile_f32.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.sqp_chol_tile_f32.restype = ctypes.c_int
    lib.sqp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sqp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def chol_tile(M: torch.Tensor) -> torch.Tensor:
    """Cholesky factor L of each SPD tile of ``M`` (B, n, n), n <= 128,
    float32, contiguous.  CPU tensors take :func:`chol_tile_plain`; CUDA
    tensors launch ``csrc/chol_tile.cu`` on the current stream."""
    if M.device.type == "cpu":
        return chol_tile_plain(M)
    if M.device.type != "cuda":
        raise ValueError(f"chol_tile runs on cuda or cpu, got {M.device}")
    _check_tiles(M)
    if not M.is_contiguous():
        raise ValueError("chol_tile takes a contiguous tensor")
    out = torch.empty_like(M)
    if M.shape[0] == 0:
        return out
    lib = _library()
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        rc = lib.sqp_chol_tile_f32(M.data_ptr(), out.data_ptr(), M.shape[0], M.shape[1], stream)
    if rc != 0:
        msg = lib.sqp_cuda_error_string(rc).decode()
        raise RuntimeError(f"chol_tile launch failed: CUDA error {rc} ({msg})")
    chol_tile.launches += 1
    return out


chol_tile.launches = 0


def tri_inv_doubling(L: torch.Tensor) -> torch.Tensor:
    """Inverse of batched lower-triangular ``(..., m, m)`` matrices by product
    doubling: ``L = (I + N) D`` with ``N`` nilpotent, so
    ``(I + N)^-1 = (I + A)(I + A^2)...(I + A^(2^(k-1)))``, ``A = -N``, is exact
    once ``2^k >= m`` -- log2(m) rounds of two batched matmuls."""
    m = L.shape[-1]
    d = torch.diagonal(L, dim1=-2, dim2=-1).unsqueeze(-1)
    rdi = 1.0 / d
    eye = torch.eye(m, dtype=L.dtype, device=L.device)
    A = -(L * rdi) + eye
    X = eye + A
    for _ in range(max(1, (m - 1).bit_length())):
        A = torch.matmul(A, A)
        X = X + torch.matmul(X, A)
    return X * rdi.transpose(-1, -2)


def cholesky_blocked(M: torch.Tensor) -> torch.Tensor:
    """Cholesky of batched SPD matrices ``(B, n, n)``, float32 factors with an
    exact-zero strict upper triangle.  Non-SPD input gives a non-finite
    factor: a bad pivot in panel k makes that panel and every later one
    non-finite on that lane (nothing on the way masks it)."""
    M = M.to(torch.float32).contiguous()
    B, n = M.shape[0], M.shape[-1]
    cholesky_blocked.calls += 1
    if n <= BLK:
        return chol_tile(M)
    L = M.new_zeros((B, n, n))
    for r0 in range(0, n, BLK):
        r1 = min(r0 + BLK, n)
        Sk = M[:, r0:, r0:r1]  # (B, n - r0, width)
        if r0 > 0:
            # left-looking correction: rows r0.. of L[:, :, :r0] times the
            # transpose of the panel's own rows of it
            Lrows = L[:, r0:, :r0]
            Sk = Sk - torch.matmul(Lrows, Lrows[:, : r1 - r0, :].transpose(-1, -2))
        Dk = chol_tile(Sk[:, : r1 - r0, :].contiguous())
        L[:, r0:r1, r0:r1] = Dk
        if r1 < n:
            Dk_inv = tri_inv_doubling(Dk)
            L[:, r1:, r0:r1] = torch.matmul(Sk[:, r1 - r0 :, :], Dk_inv.transpose(-1, -2))
    return L


#: factorizations asked for so far (each one launches ceil(n / 128) tiles)
cholesky_blocked.calls = 0


def tri_inv_blocked(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of batched lower-triangular ``(B, n, n)`` matrices by
    128-blocked forward substitution with doubling diagonal inverses:
    ``X[i] = Dinv_i (I[i] - L[i, :i] X[:i])``."""
    B, n = L.shape[0], L.shape[-1]
    if n <= BLK:
        return tri_inv_doubling(L)
    starts = range(0, n, BLK)
    # all diagonal-block inverses in one batched doubling pass; the ragged
    # last block is completed by an identity corner to stack with the others
    diags = L.new_zeros((B, len(starts), BLK, BLK))
    for i, r0 in enumerate(starts):
        w = min(BLK, n - r0)
        diags[:, i, :w, :w] = L[:, r0 : r0 + w, r0 : r0 + w]
        if w < BLK:
            diags[:, i, w:, w:] = torch.eye(BLK - w, dtype=L.dtype, device=L.device)
    dinv = tri_inv_doubling(diags.reshape(B * len(starts), BLK, BLK)).reshape(
        B, len(starts), BLK, BLK
    )
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    X = L.new_zeros((B, n, n))
    for i, r0 in enumerate(starts):
        w = min(BLK, n - r0)
        rhs = eye[r0 : r0 + w, :].expand(B, w, n)
        if i > 0:
            rhs = rhs - torch.matmul(L[:, r0 : r0 + w, :r0], X[:, :r0, :])
        X[:, r0 : r0 + w, :] = torch.matmul(dinv[:, i, :w, :w], rhs)
    return X
