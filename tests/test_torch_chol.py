"""The port's Cholesky tile kernel and triangular inverse.

On the CPU the kernel's wrapper runs its plain PyTorch version
(``chol_tile_plain``), which is held here against the JAX package's Pallas
kernel ``chol_diag128`` in interpret mode (the same way ``test_pallas.py``
runs it): max|dL| / max|L| < 5e-6, the tolerance of ``test_pallas.py``.  The
CUDA kernel itself is held against the plain version by ``test_torch_gpu.py``
(``gpu``-marked; skips without a card, as the kernel has no CPU mode) and by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqpsolver_tpu.ops.chol_blocked import chol_diag128, tri_inv_blocked as j_tri_inv
from sqpsolver_tpu_torch.ops import _build
from sqpsolver_tpu_torch.ops.chol_blocked import (
    chol_tile,
    chol_tile_plain,
    cholesky_blocked,
    tri_inv_blocked,
)
from sqpsolver_tpu_torch.ops.linsolve import tri_inv

NS = [16, 72, 96, 128, 1, 33]  # one tile, the slice's K and S, full, a single element, odd


def _spd(rng, n, B=3):
    L = rng.standard_normal((B, n, n))
    return (L @ L.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _pad128(M):
    B, n, _ = M.shape
    P = np.tile(np.eye(128, dtype=np.float32), (B, 1, 1))
    P[:, :n, :n] = M
    return P


@pytest.fixture(scope="module")
def jax_factors():
    """One interpret-mode chol_diag128 call for every n (identity-padded to
    the kernel's 128 tile, as the JAX package pads)."""
    rng = np.random.default_rng(7)
    mats = {n: _spd(rng, n) for n in NS}
    stacked = np.concatenate([_pad128(mats[n]) for n in NS])
    L = np.asarray(chol_diag128(jnp.asarray(stacked), interpret=True))
    out = {}
    for k, n in enumerate(NS):
        out[n] = (mats[n], L[3 * k : 3 * k + 3, :n, :n])
    return out


@pytest.mark.parametrize("n", NS)
def test_plain_matches_pallas_interpret(jax_factors, n):
    M, L_ref = jax_factors[n]
    L = chol_tile_plain(torch.as_tensor(M)).numpy()
    assert np.abs(L - L_ref).max() / np.abs(L_ref).max() < 5e-6
    assert np.abs(np.triu(L, 1)).max() == 0.0  # exact-zero strict upper


@pytest.mark.parametrize("n", [16, 96])
def test_non_finite_on_indefinite(n):
    M = _spd(np.random.default_rng(n), n)
    M[1, 5, 5] = -1e3
    L = cholesky_blocked(torch.as_tensor(M))
    finite = torch.isfinite(L).flatten(1).all(-1)
    assert finite.tolist() == [True, False, True]


def test_wrapper_on_cpu_is_plain_and_launches_nothing():
    """The module imports and runs without CUDA: a CPU tensor takes the plain
    version, no library is built or loaded, no launch is counted."""
    M = torch.as_tensor(_spd(np.random.default_rng(0), 24))
    before = chol_tile.launches
    assert torch.equal(chol_tile(M), chol_tile_plain(M))
    assert chol_tile.launches == before
    assert "chol_tile" not in _build._LIBS


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        chol_tile(torch.eye(4, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        chol_tile(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        chol_tile(torch.zeros(1, 130, 130))
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent fallback
        chol_tile(torch.zeros(1, 4, 4, device="meta"))
    # beyond one tile the blocked routines take over: n = 130 factors and
    # inverts (two panels, the second two columns wide)
    M = torch.as_tensor(_spd(np.random.default_rng(130), 130))
    L = cholesky_blocked(M)
    assert torch.allclose(L @ L.transpose(-1, -2), M, rtol=0, atol=1e-3 * 130)
    eye = torch.eye(130)
    assert (tri_inv_blocked(L) @ L - eye).abs().max() < 5e-5


@pytest.mark.parametrize("n", [16, 72, 96, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tri_inv_matches_jax(n, dtype):
    """Product-doubling inverse against the JAX tri_inv_blocked (rel 1e-5 in
    float32, 1e-12 in float64; both run the same matmul rounds)."""
    rng = np.random.default_rng(n + 1)
    L = np.linalg.cholesky(_spd(rng, n, B=2).astype(np.float64)).astype(dtype)
    got = tri_inv(torch.as_tensor(L)).numpy()
    want = np.asarray(j_tri_inv(jnp.asarray(L)))
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert np.abs(got - want).max() / np.abs(want).max() < tol
    assert np.abs(got @ L - np.eye(n)).max() < (5e-5 if dtype == np.float32 else 1e-12)
