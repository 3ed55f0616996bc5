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
* :func:`cholesky_blocked` and :func:`tri_inv_blocked` cover n <= 128, where
  one tile is the whole matrix.  The 128-panel paths for larger n are not
  ported yet (ROADMAP Queue 2, item 2).

Float32 products here must be true float32: the solver turns TF32 off for
the duration of each solve (TF32 keeps ~3 digits and ruins the factor that
seeds the mixed-precision refinement).
"""

from __future__ import annotations

import ctypes
import functools

import torch

BLK = 128

_NOT_PORTED = (
    "n > 128 needs the 128-panel path, not ported yet "
    "(ROADMAP Queue 2, item 2)"
)


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
    """Cholesky of batched SPD matrices ``(B, n, n)``, float32 factors.
    Non-SPD input gives a non-finite factor."""
    if M.shape[-1] > BLK:
        raise NotImplementedError(_NOT_PORTED)
    return chol_tile(M.to(torch.float32).contiguous())


def tri_inv_blocked(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of batched lower-triangular ``(B, n, n)`` matrices."""
    if L.shape[-1] > BLK:
        raise NotImplementedError(_NOT_PORTED)
    return tri_inv_doubling(L)
