"""The port's 128-panel Cholesky and blocked triangular inverse for n > 128.

Seeded numpy matrices go through the JAX package's ``cholesky_blocked`` (its
Pallas tile kernel in interpret mode, as ``test_pallas.py`` runs it) and
``tri_inv_blocked``, and through the port's functions of the same names on
the CPU, where the tile wrapper runs its plain version.

* ``cholesky_blocked`` at n in {130, 200, 344}: max|dL| / max|L| <= 1e-5 on
  equilibrated SPD input, an exact-zero strict upper triangle;
* an indefinite lane with its bad pivot in the second and in the third panel:
  a non-finite factor on that lane and a finite one on the others;
* ``tri_inv_blocked`` at n in {130, 313, 344}: max|dX| / max|X| <= 1e-5 in
  float32 and 1e-12 in float64;
* ``factorize_spd(backend="pallas", equilibrate=True, invert=True)`` at
  n = 200 against the JAX one under ``vmap``: delta equal, solves through the
  factor within 1e-5 relative.

The port keeps the last panel at its true width where the JAX package pads it
to 128 with an identity block; the padded rows contribute exact zeros, so the
factors agree to float32 rounding all the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqpsolver_tpu.ops import linsolve as j_lin
from sqpsolver_tpu.ops.chol_blocked import cholesky_blocked as j_chol
from sqpsolver_tpu.ops.chol_blocked import tri_inv_blocked as j_tri_inv
from sqpsolver_tpu_torch.ops import linsolve as t_lin
from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile, cholesky_blocked, tri_inv_blocked

B = 2


def _spd(rng, n, batch=B):
    """Seeded SPD matrices equilibrated to a unit diagonal, as the KKT
    matrices the solver factors."""
    G = rng.standard_normal((batch, n, n))
    M = G @ G.transpose(0, 2, 1) / n + 0.05 * np.eye(n)
    d = 1.0 / np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    return (M * d[:, :, None] * d[:, None, :]).astype(np.float32)


@pytest.mark.parametrize("n", [130, 200, 344])
def test_cholesky_blocked_matches_jax(n):
    M = _spd(np.random.default_rng(n), n)
    want = np.asarray(j_chol(jnp.asarray(M), interpret=True))
    got = cholesky_blocked(torch.as_tensor(M)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, n, n)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5
    assert np.abs(np.triu(got, 1)).max() == 0.0
    ref = np.linalg.cholesky(M.astype(np.float64))
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5


@pytest.mark.parametrize("pivot,panel", [(150, 2), (300, 3)])
def test_non_finite_on_indefinite_lane_only(pivot, panel):
    """A bad pivot born in a later panel reaches the whole-factor finiteness
    test, and only on its lane."""
    n = 344
    M = _spd(np.random.default_rng(pivot), n, batch=3)
    M[1, pivot, pivot] = -1.0e3
    L = cholesky_blocked(torch.as_tensor(M))
    assert t_lin._chol_ok(L).tolist() == [True, False, True]
    first_bad = 128 * (panel - 1)
    assert torch.isfinite(L[1, :, :first_bad]).all()  # earlier panels stand
    assert not torch.isfinite(L[1, pivot:, pivot]).any()


def test_cpu_panels_launch_nothing():
    before = chol_tile.launches
    cholesky_blocked(torch.as_tensor(_spd(np.random.default_rng(1), 130)))
    assert chol_tile.launches == before


@pytest.mark.parametrize("n", [130, 313, 344])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tri_inv_blocked_matches_jax(n, dtype):
    rng = np.random.default_rng(n + 1)
    L = np.linalg.cholesky(_spd(rng, n).astype(np.float64)).astype(dtype)
    got = tri_inv_blocked(torch.as_tensor(L)).numpy()
    want = np.asarray(j_tri_inv(jnp.asarray(L)))
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert got.dtype == dtype
    assert np.abs(got - want).max() / np.abs(want).max() <= tol
    assert np.abs(np.triu(got, 1)).max() == 0.0
    assert np.abs(got @ L - np.eye(n)).max() <= (1e-4 if dtype == np.float32 else 1e-11)


def test_factorize_spd_pallas_n200_matches_jax():
    """The whole ladder over two panels: float32 kernel-path factors of the
    equilibrated matrix with the explicit inverse, one lane needing delta."""
    n = 200
    rng = np.random.default_rng(5)
    G = rng.standard_normal((3, n, n))
    M = G @ G.transpose(0, 2, 1) / n + 0.05 * np.eye(n)
    M[1] -= 0.2 * np.eye(n)  # indefinite: the ladder must escalate here
    b = rng.standard_normal((3, n))
    kw = dict(min_pivot=1e-3, equilibrate=True, invert=True, backend="pallas")

    def one(Mi, bi):
        f = j_lin.factorize_spd(Mi, 0.0, factor_dtype=jnp.float32, **kw)
        return f.delta, f.ok, j_lin.solve_factorized(f, bi, ir_steps=2)

    jd, jok, jx = jax.vmap(one)(jnp.asarray(M), jnp.asarray(b))
    f = t_lin.factorize_spd(torch.as_tensor(M), 0.0, factor_dtype=torch.float32, **kw)
    tx = t_lin.solve_factorized(f, torch.as_tensor(b), ir_steps=2).numpy()
    assert f.chol.dtype == torch.float32 and f.inv_chol.shape == (3, n, n)
    np.testing.assert_array_equal(f.ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(f.delta.numpy(), np.asarray(jd), rtol=1e-12)
    assert f.delta[1] > 0 and f.delta[0] == 0 and f.delta[2] == 0
    assert np.abs(tx - np.asarray(jx)).max() / np.abs(np.asarray(jx)).max() <= 1e-5
