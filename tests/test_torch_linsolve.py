"""The port's regularization ladder and refined solves against the JAX
package's ``factorize_spd`` under ``vmap``.

A batch mixes SPD lanes with indefinite lanes of several depths, so some
lanes never escalate, some escalate a few rungs and then bisect.  Every lane
must end with the same ``delta`` as the vmapped JAX ladder (rtol 1e-12: the
rungs and the bisection are the same float64 arithmetic; only the float32
factors behind each accept/reject decision are computed by different code),
and ``solve_factorized`` must agree to 1e-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqpsolver_tpu.ops import linsolve as j_lin
from sqpsolver_tpu_torch._lanes import any_lane
from sqpsolver_tpu_torch.ops import linsolve as t_lin

N = 24
SHIFTS = [0.0, 0.0, -0.5, -3.0, -40.0, 0.0]  # smallest-eigenvalue shifts per lane


def _batch(seed):
    rng = np.random.default_rng(seed)
    B = len(SHIFTS)
    G = rng.standard_normal((B, N, N))
    M = G @ G.transpose(0, 2, 1) / N
    # scale rows/cols over 4 decades so the equilibration matters
    s = 10.0 ** rng.uniform(-2, 2, (B, N))
    M = M * s[:, :, None] * s[:, None, :]
    for b, sh in enumerate(SHIFTS):
        if sh:
            v = rng.standard_normal(N)
            v /= np.linalg.norm(v)
            M[b] += sh * np.outer(v * s[b], v * s[b]) * 4.0
    rhs = rng.standard_normal((B, N))
    return M, rhs


CONFIGS = {
    "pallas_f32_equilibrated": dict(
        factor_dtype=jnp.float32, backend="pallas", min_pivot=1e-3,
        equilibrate=True, invert=True,
    ),
    "xla_f64_direct": dict(backend="xla", invert=True),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def both(request):
    kw = CONFIGS[request.param]
    M, rhs = _batch(3)
    delta0 = np.array([0.0, 1e-3, 0.0, 0.0, 0.0, 0.0])

    def one(Mi, d0, bi):
        f = j_lin.factorize_spd(Mi, d0, **kw)
        return f.delta, f.ok, j_lin.solve_factorized(f, bi, ir_steps=2)

    j_delta, j_ok, j_x = jax.jit(jax.vmap(one))(
        jnp.asarray(M), jnp.asarray(delta0), jnp.asarray(rhs)
    )
    t_kw = dict(kw)
    if "factor_dtype" in t_kw:
        t_kw["factor_dtype"] = torch.float32
    syncs = any_lane.syncs
    fact = t_lin.factorize_spd(torch.as_tensor(M), torch.as_tensor(delta0), **t_kw)
    t_x = t_lin.solve_factorized(fact, torch.as_tensor(rhs), ir_steps=2)
    return dict(
        j=(np.asarray(j_delta), np.asarray(j_ok), np.asarray(j_x)),
        t=(fact.delta.numpy(), fact.ok.numpy(), t_x.numpy()),
        syncs=any_lane.syncs - syncs,
    )


def test_same_delta_per_lane(both):
    (jd, jok, _), (td, tok, _) = both["j"], both["t"]
    np.testing.assert_array_equal(tok, jok)
    assert tok.all()
    np.testing.assert_allclose(td, jd, rtol=1e-12, atol=0.0)
    # the batch really exercises the ladder: SPD lanes stay put, others escalate
    assert td[0] == 0.0 and td[1] == 1e-3 and (td[2:5] > 0).all()
    assert both["syncs"] >= 2  # one host sync per ladder trip


def test_solve_factorized_agrees(both):
    jx, tx = both["j"][2], both["t"][2]
    assert np.abs(tx - jx).max() / np.abs(jx).max() <= 1e-8


def test_solve_matrix_rhs_and_triangular_path():
    """(B, n, k) right-hand sides, and the solve without explicit inverse
    factors (triangular solves), agree with a float64 direct solve."""
    M, _ = _batch(5)
    M = M[:2] + 50.0 * np.eye(N) * np.abs(M[:2]).max()
    R = np.random.default_rng(1).standard_normal((2, N, 3))
    for invert in (True, False):
        fact = t_lin.factorize_spd(torch.as_tensor(M), invert=invert)
        X = t_lin.solve_factorized(fact, torch.as_tensor(R)).numpy()
        np.testing.assert_allclose(X, np.linalg.solve(M, R), rtol=1e-10, atol=1e-14)


def test_library_factor_symmetrizes_its_input_as_jax_does():
    """``jnp.linalg.cholesky`` factors ``(A + A^T) / 2``; the port's library
    route must too (``cholesky_ex`` alone reads the lower triangle).  An
    assembled Schur complement is symmetric only to rounding, and a factor of
    its lower triangle misfits the matrix the refinement sweep takes
    residuals against (ROADMAP Queue 3: the interior-point solve of hs047's
    first SQP-LS subproblem stalled in the port and converged in JAX)."""
    rng = np.random.default_rng(7)
    G = rng.standard_normal((3, 8, 8))
    M = G @ G.transpose(0, 2, 1) / 8 + 0.1 * np.eye(8)
    M = M + 1e-3 * np.triu(rng.standard_normal((3, 8, 8)), 1)  # upper triangle off
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(M)))
    got = t_lin._chol_library(torch.as_tensor(M)).numpy()
    lower_only = np.linalg.cholesky(np.tril(M) + np.tril(M, -1).transpose(0, 2, 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    assert np.abs(lower_only - want).max() > 1e-5
