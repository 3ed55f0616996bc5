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
  does not, to the solve's tolerance);
* the 128-panel ``cholesky_blocked`` at n = 344 on the card (three launches
  of the kernel) against the same call on the CPU (the plain version there):
  max|dL| / max|L| <= 1e-5;
* the dense case118 path on the card against the same on the CPU: two of
  the 16 scenarios of ``chip_smoke.py`` (lanes 0 and 8, which solve within
  nine iterations through the rescue fallback) through
  ``make_chunked_batch_solver(rescue_fallback=True)`` -- statuses equal and
  solved, objectives within 1e-6 relative, the float64 phase 2 taken on both
  devices;
* the case118 model evaluates bit for bit the same every time on the card
  (constraints, Jacobian, Lagrangian Hessian: bus sums in a fixed order, no
  atomics), and so do two solves of the first five iterations, in the polar
  formulation (16 scenarios) and the rectangular one (4 scenarios);
* the polar formulation's extensions on the card: case9 with 4-segment
  piecewise-linear costs and a free HVDC line, 4 load scenarios, float64
  throughout (the reference example's ACOPF parameters with the ``ladder``
  shift: the default ``eigh`` estimates its shift in float32, whose last
  bits differ between the card and the CPU), against the same solve on the
  CPU (statuses equal and solved, objectives within 1e-6 relative: the free
  line's reactive ends cost nothing, and where a lane stops along that flat
  direction moves its objective by ~1.5e-7 between the two devices' float64
  sums);
* the W-space formulation on the card: ``acopf_wr`` on case30 through
  ``optimize`` (float64) ends as on the CPU: the same status and iterations,
  objectives within 1e-10 relative;
* ``optimize`` runs on the card by default, and hs014 (SQP-TR and SQP-LS)
  and hs071 (SQP-TR) end there as on the CPU: the same status and
  iterations, objectives within 1e-10 relative;
* the line search on the card: ACOPF case5 under SQP-LS, 4 load scenarios,
  against the same solve on the CPU (statuses equal and solved, objectives
  within 1e-7 relative, the kernel launched);
* the float32 matrix plane on the card: ACOPF case5 in the slice
  configuration under ``kkt_precision="mixed_plane"``, 4 load scenarios,
  against the same solve on the CPU (statuses equal and solved, objectives
  within 1e-7 relative, the kernel launched on the plane's factors);
* the structured (BBD) path on the card is bit-reproducible: structured
  case9's coloring-compressed constraints, Jacobian and Hessian blocks
  evaluated eleven times, and two five-iteration solves (float32 factors,
  the kernel launched), agree bit for bit;
* the structured entry points run on the card by default: ``optimize`` of
  structured case9 and the batched data of the coupled two-stage problem.
"""

import numpy as np
import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
from sqpsolver_tpu_torch.models.matpower import load_case
from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile, chol_tile_plain, cholesky_blocked
from sqpsolver_tpu_torch.ops.qp_ipm import solve_qp

SLICE = dict(
    max_iter=40, OutputFlag=0, tol_infeas=1.0e-6, tol_residual=1.0e-4,
    qp_max_iter=30, kkt_precision="mixed_ir", hessian_shift="ladder",
    qp_rescue=False, init_projection="off", kkt_backend="pallas",
)
#: the reference example's ACOPF parameters (``tests/test_acopf.py``)
ACOPF = dict(max_iter=100, OutputFlag=0, tol_infeas=1e-6, tol_residual=1e-4, use_soc=True)


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


@pytest.mark.gpu
def test_cholesky_blocked_n344_matches_cpu(cuda):
    rng = np.random.default_rng(344)
    G = rng.standard_normal((4, 344, 344))
    M = G @ G.transpose(0, 2, 1) / 344 + 0.05 * np.eye(344)
    d = 1.0 / np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    M = torch.tensor(M * d[:, :, None] * d[:, None, :], dtype=torch.float32)
    before = chol_tile.launches
    L = cholesky_blocked(M.to(cuda))
    assert chol_tile.launches == before + 3
    Lc = cholesky_blocked(M)
    assert chol_tile.launches == before + 3  # the CPU call launches nothing
    assert ((L.cpu() - Lc).abs().max() / Lc.abs().max()).item() <= 1e-5
    assert torch.triu(L, 1).abs().max().item() == 0.0


@pytest.mark.gpu
def test_case118_chunked_solve_on_card_matches_cpu(cuda):
    case = load_case("case118")
    nlp = acopf_polar(case)
    lanes = [0, 8]
    theta = {k: v[lanes] for k, v in load_scenarios(case, 16, seed=7, spread=0.03).items()}
    params = tp.Parameters(**dict(SLICE, max_iter=10, kkt_ir_steps=2, schur_cap=-1))
    out = {}
    for device in (cuda, "cpu"):
        solver = tp.make_chunked_batch_solver(nlp, params, sub_batch=128, rescue_fallback=True)
        trips = solve_qp.loop_trips[2]
        res = solver(tp.batch_data(nlp, len(lanes), theta=theta, device=device))
        assert solve_qp.loop_trips[2] > trips
        assert solver.stats["fallback_lanes"]  # some lanes needed the rescue
        out[str(device)] = tp.result_to_numpy(res)
    gpu, cpu = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(gpu["status"], cpu["status"])
    assert np.isin(gpu["status"], [0, 1, 6]).all()
    np.testing.assert_allclose(gpu["obj_val"], cpu["obj_val"], rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("form,batch", [("polar", 16), ("rect", 4)])
def test_case118_is_bit_reproducible_on_the_card(cuda, form, batch):
    from sqpsolver_tpu_torch.models import acopf

    case = load_case("case118")
    nlp = getattr(acopf, f"acopf_{form}")(case)
    theta = load_scenarios(case, batch, seed=7, spread=0.03)
    data = tp.batch_data(nlp, batch, theta=theta, device=cuda)
    gen = torch.Generator(device="cuda").manual_seed(118)
    x = data.x0 + 0.05 * torch.randn(data.x0.shape, generator=gen, device=cuda, dtype=data.x0.dtype)
    lam = torch.randn((batch, nlp.m), generator=gen, device=cuda, dtype=x.dtype)

    def evaluate():
        return (nlp.obj_cons(x, data.theta)[1], nlp.cons_jac(x, data.theta),
                nlp.lag_hess(x, lam, data.theta))

    first = evaluate()
    for _ in range(10):
        for a, b in zip(first, evaluate()):
            assert torch.equal(a, b)

    solver = tp.make_batch_solver(nlp, tp.Parameters(**dict(SLICE, max_iter=5)))
    one, two = solver(data), solver(data)
    for key in ("x", "obj_val", "qp_iters_total", "status"):
        assert torch.equal(getattr(one, key), getattr(two, key)), key


@pytest.mark.gpu
def test_pwl_dcline_case9_on_card_matches_cpu(cuda, tmp_path):
    from sqpsolver_tpu_torch.models.matpower import case9_variant

    case = case9_variant(str(tmp_path), 4, "free")
    nlp = acopf_polar(case)
    assert nlp.structure is None and nlp.num_linear == 1 + 12
    theta = load_scenarios(case, 4, seed=7, spread=0.03)
    solver = tp.make_batch_solver(nlp, tp.Parameters(**ACOPF, hessian_shift="ladder"))
    gpu = tp.result_to_numpy(solver(tp.batch_data(nlp, 4, theta=theta, device=cuda)))
    cpu = tp.result_to_numpy(solver(tp.batch_data(nlp, 4, theta=theta, device="cpu")))
    np.testing.assert_array_equal(gpu["status"], cpu["status"])
    assert np.isin(gpu["status"], [0, 1, 6]).all()
    np.testing.assert_allclose(gpu["obj_val"], cpu["obj_val"], rtol=1e-6)


@pytest.mark.gpu
def test_wr_case30_on_card_matches_cpu(cuda):
    from sqpsolver_tpu_torch.models.acopf import acopf_wr

    nlp = acopf_wr(load_case("case30"), scenario_batchable=False)
    params = tp.Parameters(**ACOPF)
    gpu = tp.optimize(nlp, params)  # the card by default
    cpu = tp.optimize(nlp, params, device="cpu")
    assert gpu.success and gpu.status == cpu.status
    assert gpu.iterations == cpu.iterations
    assert abs(gpu.obj_val - cpu.obj_val) <= 1e-10 * max(1.0, abs(cpu.obj_val))


@pytest.mark.gpu
@pytest.mark.parametrize("name,algorithm", [("hs014", "SQP-TR"), ("hs014", "SQP-LS"),
                                            ("hs071", "SQP-TR")])
def test_optimize_on_card_matches_cpu(cuda, name, algorithm):
    from sqpsolver_tpu_torch.models.hs import hs_problem

    nlp = hs_problem(name).nlp
    params = tp.Parameters(max_iter=300, OutputFlag=0, algorithm=algorithm)
    gpu = tp.optimize(nlp, params)  # the card by default
    cpu = tp.optimize(nlp, params, device="cpu")
    assert gpu.success and gpu.status == cpu.status
    assert gpu.iterations == cpu.iterations
    assert abs(gpu.obj_val - cpu.obj_val) <= 1e-10 * max(1.0, abs(cpu.obj_val))


@pytest.mark.gpu
def test_line_search_on_card_matches_cpu(cuda):
    case = load_case("case5")
    nlp = acopf_polar(case)
    theta = load_scenarios(case, 4, seed=7, spread=0.03)
    solver = tp.make_solver(nlp, tp.Parameters(**SLICE, algorithm="SQP-LS"))
    before = chol_tile.launches
    gpu = tp.result_to_numpy(solver(tp.batch_data(nlp, 4, theta=theta, device=cuda)))
    assert chol_tile.launches > before
    cpu = tp.result_to_numpy(solver(tp.batch_data(nlp, 4, theta=theta, device="cpu")))
    np.testing.assert_array_equal(gpu["status"], cpu["status"])
    assert np.isin(gpu["status"], [0, 1, 6]).all()
    np.testing.assert_allclose(gpu["obj_val"], cpu["obj_val"], rtol=1e-7)


@pytest.mark.gpu
def test_plane_on_card_matches_cpu(cuda):
    case = load_case("case5")
    nlp = acopf_polar(case)
    theta = load_scenarios(case, 4, seed=7, spread=0.03)
    solver = tp.make_batch_solver(nlp, tp.Parameters(**dict(SLICE, kkt_precision="mixed_plane")))
    before = chol_tile.launches
    gpu = tp.result_to_numpy(solver(tp.batch_data(nlp, 4, theta=theta, device=cuda)))
    assert chol_tile.launches > before
    cpu = tp.result_to_numpy(solver(tp.batch_data(nlp, 4, theta=theta, device="cpu")))
    np.testing.assert_array_equal(gpu["status"], cpu["status"])
    assert np.isin(gpu["status"], [0, 1, 6]).all()
    np.testing.assert_allclose(gpu["obj_val"], cpu["obj_val"], rtol=1e-7)


@pytest.mark.gpu
def test_structured_case9_is_bit_reproducible_on_the_card(cuda):
    from sqpsolver_tpu_torch.algorithms.sqp_tr import structured_derivatives
    from sqpsolver_tpu_torch.models.power import case9
    from sqpsolver_tpu_torch.ops.kkt_bbd import BlockMaps
    from sqpsolver_tpu_torch.structure import build_block_structure

    case = case9()
    nlp = acopf_polar(case)
    theta = load_scenarios(case, 4, seed=7, spread=0.03)
    data = tp.batch_data(nlp, 4, theta=theta, device=cuda)
    eq = np.isfinite(nlp.g_l) & (nlp.g_l == nlp.g_u)
    maps = BlockMaps(build_block_structure(nlp.n, nlp.m, nlp.structure, eq), cuda)
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = data.x0 + 0.05 * torch.randn(data.x0.shape, generator=gen, device=cuda, dtype=data.x0.dtype)
    lam = torch.randn((4, nlp.m), generator=gen, device=cuda, dtype=x.dtype)

    def evaluate():
        J, H = structured_derivatives(nlp, maps, x, lam, data.theta)
        return (nlp.obj_cons(x, data.theta)[1],) + tuple(J) + tuple(H)

    first = evaluate()
    for _ in range(10):
        for a, b in zip(first, evaluate()):
            assert torch.equal(a, b)

    params = tp.Parameters(**dict(SLICE, max_iter=5, kkt_structured=True))
    solver = tp.make_batch_solver(nlp, params)
    before = chol_tile.launches
    one = solver(data)
    assert chol_tile.launches > before
    two = solver(data)
    for key in ("x", "obj_val", "qp_iters_total", "status"):
        assert torch.equal(getattr(one, key), getattr(two, key)), key


@pytest.mark.gpu
def test_structured_entry_points_default_to_the_card(cuda):
    from sqpsolver_tpu_torch.models.power import case9
    from sqpsolver_tpu_torch.models.stochastic import couple_scenarios, pg_shared_mask

    case = case9()
    nlp = acopf_polar(case)
    coupled = couple_scenarios(nlp, load_scenarios(case, 3, seed=3, spread=0.03),
                               pg_shared_mask(case, nlp))
    assert tp.batch_data(coupled, 2).theta["pd"].device.type == "cuda"
    params = tp.Parameters(max_iter=60, OutputFlag=0, tol_infeas=1e-6, tol_residual=1e-4,
                           kkt_structured=True)
    single = acopf_polar(case, scenario_batchable=False)
    raw = tp.make_solver(single, params)(tp.batch_data(single, 1))
    assert raw.x.device.type == "cuda"
    res = tp.optimize(single, params)  # the card by default
    assert res.success
    assert abs(res.obj_val - 5296.69) / 5296.69 < 1e-4
