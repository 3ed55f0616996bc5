"""Tests of the port that need a CUDA card (``gpu`` marker).

The hand-written kernel has no CPU mode, so these skip without a card.  This
file imports neither JAX nor the JAX package, so on a GPU machine without
JAX it runs on its own, without the suite's JAX conftest::

    python -m pytest --noconftest -q tests/test_torch_gpu.py

* the Cholesky kernel against its plain PyTorch version on the card, at
  every width it is compiled for, odd sizes and batches of 1, 32 and 300:
  max|dL| / max|L| <= 1e-5, exact-zero upper triangle, one launch counted
  per call; a non-finite factor on an indefinite tile and on no other; a
  non-contiguous or float64 CUDA tensor raises;
* a whole solve on the card against the same solve on the CPU (plain version
  of the kernel there): ACOPF case5 in the slice configuration, 4 load
  scenarios -- statuses equal, objectives within 1e-7 relative (float32
  factor rounding differs between the two devices; the converged objective
  does not, to the solve's tolerance).
"""

import numpy as np
import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
from sqpsolver_tpu_torch.models.matpower import load_case
from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile, chol_tile_plain

SLICE = dict(
    max_iter=40, OutputFlag=0, tol_infeas=1.0e-6, tol_residual=1.0e-4,
    qp_max_iter=30, kkt_precision="mixed_ir", hessian_shift="ladder",
    qp_rescue=False, init_projection="off", kkt_backend="pallas",
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd(n, batch, device):
    rng = np.random.default_rng(1000 * batch + n)
    G = rng.standard_normal((batch, n, n))
    M = G @ G.transpose(0, 2, 1) + n * np.eye(n)
    return torch.tensor(M, dtype=torch.float32, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 32, 300])
@pytest.mark.parametrize("n", [1, 7, 33, 72, 96, 127, 128])
def test_kernel_matches_plain(cuda, n, batch):
    M = _spd(n, batch, cuda)
    before = chol_tile.launches
    L = chol_tile(M)
    Lp = chol_tile_plain(M)
    torch.cuda.synchronize()
    assert chol_tile.launches == before + 1
    assert ((L - Lp).abs().max() / Lp.abs().max()).item() <= 1e-5
    assert torch.triu(L, 1).abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [7, 72, 96, 128])
def test_indefinite_tile_alone_is_non_finite(cuda, n):
    M = _spd(n, 32, cuda)
    M[3, 5, 5] = -1e3
    bad = ~torch.isfinite(chol_tile(M)).flatten(1).all(-1)
    assert bad.tolist() == [i == 3 for i in range(32)]


@pytest.mark.gpu
def test_kernel_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    """No fallback to the plain version for a CUDA tensor."""
    M = _spd(8, 4, cuda)
    before = chol_tile.launches
    with pytest.raises(ValueError, match="contiguous"):
        chol_tile(M.transpose(1, 2))
    with pytest.raises(TypeError, match="float32"):
        chol_tile(M.double())
    assert chol_tile.launches == before


@pytest.mark.gpu
def test_entry_points_default_to_the_card(cuda):
    nlp = acopf_polar(load_case("case5"))
    assert nlp.data().x0.device.type == "cuda"
    assert tp.batch_data(nlp, 2).x0.device.type == "cuda"
    assert tp.theta_to_torch({"a": np.zeros(3)})["a"].device.type == "cuda"


@pytest.mark.gpu
def test_solve_on_card_matches_cpu(cuda):
    case = load_case("case5")
    nlp = acopf_polar(case)
    theta = load_scenarios(case, 4, seed=7, spread=0.03)
    solver = tp.make_batch_solver(nlp, tp.Parameters(**SLICE))
    before = chol_tile.launches
    gpu = tp.result_to_numpy(solver(tp.batch_data(nlp, 4, theta=theta, device=cuda)))
    assert chol_tile.launches > before
    cpu = tp.result_to_numpy(solver(tp.batch_data(nlp, 4, theta=theta, device="cpu")))
    np.testing.assert_array_equal(gpu["status"], cpu["status"])
    assert np.isin(gpu["status"], [0, 1, 6]).all()
    np.testing.assert_allclose(gpu["obj_val"], cpu["obj_val"], rtol=1e-7)
