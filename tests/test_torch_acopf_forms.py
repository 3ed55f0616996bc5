"""The port's other ACOPF formulations against the JAX package's.

``acopf_rect``, ``acopf_ivr`` and ``acopf_wr``, and ``acopf_polar`` on cases
with piecewise-linear (PWL) costs and HVDC lines (dclines), built by both
packages from the same data, float64, on the CPU:

* the NLP metadata (n, m, ``num_linear``, bounds, start, name, no structure)
  is exactly equal;
* f, g, the constraint Jacobian and the Lagrangian Hessian at three seeded
  points with three load scenarios and seeded multipliers agree within
  1e-12 of the entry scale;
* the cases the JAX package rejects, the port rejects with the same
  exception type;
* whole solves: the port's versions of the JAX package's parity tests
  (``tests/test_acopf.py``: ivr, rect and wr against polar;
  ``tests/test_pwl_dcline.py``: the PWL epigraph and the dclines), and one-lane
  solves that end in the JAX package's status and iterations with its
  objective within 1e-6 relative, or, with the float64 ``ladder`` shift on
  case9, within 1e-9 at its QP trip count too.  The JAX results come from
  ``sqpsolver_tpu_torch/data/anchor_forms_single.json``
  (``scripts/torch_anchor.py --forms-single``), not from JAX solves run here.

The PWL and dcline cases are MATPOWER text from the port's
``matpower.case9_m_text``, written to a temporary directory and parsed by
each package's own parser.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqpsolver_tpu as sqp
import sqpsolver_tpu_torch as tp
from sqpsolver_tpu.models import acopf as j_acopf
from sqpsolver_tpu.models import matpower as j_matpower
from sqpsolver_tpu_torch.models import acopf as t_acopf
from sqpsolver_tpu_torch.models import matpower as t_matpower
from sqpsolver_tpu_torch.models import power as t_power

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sqpsolver_tpu_torch", "data")
#: ``tests/test_acopf.py``'s parameters (the reference example's)
PARAMS = dict(max_iter=100, OutputFlag=0, tol_infeas=1e-6, tol_residual=1e-4, use_soc=True)
CASE9_OPT = 5296.69  # published MATPOWER case9 AC-OPF optimum

#: model key -> (formulation, case, PWL segments, ``matpower.DCLINES`` key)
MODELS = {
    "rect-case9": ("rect", "case9", 0, None),
    "rect-case30": ("rect", "case30", 0, None),
    "rect-case118": ("rect", "case118", 0, None),
    "ivr-case9": ("ivr", "case9", 0, None),
    "ivr-case30": ("ivr", "case30", 0, None),
    "ivr-case118": ("ivr", "case118", 0, None),
    "wr-case9": ("wr", "case9", 0, None),
    "wr-case30": ("wr", "case30", 0, None),
    "polar-case9-pwl12": ("polar", "case9", 12, None),
    "polar-case9-dcfree": ("polar", "case9", 0, "free"),
    "polar-case9-pwl4-dclossy": ("polar", "case9", 4, "lossy"),
}


@pytest.fixture(scope="module")
def tmp_cases(tmp_path_factory):
    return tmp_path_factory.mktemp("cases")


def _cases(spec, directory):
    """(JAX case, port case) of one spec; variants of case9 are written once
    by the port and parsed by each package's own parser."""
    _, name, segs, dc = spec
    if not (segs or dc):
        return j_matpower.load_case(name), t_matpower.load_case(name)
    t_case = t_matpower.case9_variant(str(directory), segs, dc)
    path = os.path.join(str(directory), f"{t_case.name}.m")
    return j_matpower.parse_matpower(path, name=t_case.name), t_case


@pytest.fixture(scope="module")
def models(tmp_cases):
    """key -> (JAX NLP, port NLP, JAX case), built once per module."""
    out = {}
    for key, spec in MODELS.items():
        j_case, t_case = _cases(spec, tmp_cases)
        build = f"acopf_{spec[0]}"
        out[key] = (getattr(j_acopf, build)(j_case), getattr(t_acopf, build)(t_case), j_case)
    return out


@pytest.fixture(scope="module")
def anchor():
    with open(os.path.join(DATA, "anchor_forms_single.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("key", sorted(MODELS))
def test_metadata_equals_jax(models, key):
    j, t, _ = models[key]
    assert (t.n, t.m, t.num_linear, t.name) == (j.n, j.m, j.num_linear, j.name)
    for field in ("x_l", "x_u", "g_l", "g_u", "x0"):
        np.testing.assert_array_equal(getattr(t, field), np.asarray(getattr(j, field)), err_msg=field)
    for field in ("pd", "qd"):
        np.testing.assert_array_equal(t.theta[field], np.asarray(j.theta[field]))
    assert t.structure is None and j.structure is None


def test_extension_layouts(models):
    """The polar extensions' rows and tail variables, counted: 12 segments of
    3 PWL generators add 36 linear rows and 3 epigraph variables; one dcline
    adds [pf, qf, qt]."""
    assert models["polar-case9-pwl12"][1].num_linear == 1 + 36
    assert models["polar-case9-pwl12"][1].n == 2 * 9 + 2 * 3 + 3
    assert models["polar-case9-dcfree"][1].n == 2 * 9 + 2 * 3 + 3
    assert models["polar-case9-pwl4-dclossy"][1].n == 2 * 9 + 2 * 3 + 3 + 3
    assert models["wr-case30"][1].num_linear == 1 + 2 * 30


@pytest.mark.parametrize("key", sorted(MODELS))
def test_evaluations_match_jax(models, key):
    """f, g, Jacobian and Lagrangian Hessian at three seeded points, with
    three load scenarios and seeded multipliers."""
    j, t, case = models[key]
    batch = 3
    rng = np.random.default_rng(sorted(MODELS).index(key))
    X = np.asarray(j.x0)[None] + 0.01 * rng.standard_normal((batch, j.n))
    lam = rng.standard_normal((batch, j.m))
    theta = j_acopf.load_scenarios(case, batch, seed=11, spread=0.05)

    def one(x, lm, th):
        val = j.f(x, th)
        return (val, j.g(x, th), jax.jacfwd(lambda v: j.g(v, th))(x),
                jax.hessian(lambda v: j.f(v, th) + jnp.dot(lm, j.g(v, th)))(x))

    want = jax.jit(jax.vmap(one))(jnp.asarray(X), jnp.asarray(lam), jax.tree.map(jnp.asarray, theta))
    xt = torch.as_tensor(X)
    th = {k: torch.as_tensor(v) for k, v in theta.items()}
    f, g = t.obj_cons(xt, th)
    got = (f, g, t.cons_jac(xt, th), t.lag_hess(xt, torch.as_tensor(lam), th))
    for name, a, b in zip(("f", "g", "jac", "hess"), got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(b).max()), name


@pytest.mark.parametrize("name", ["case9", "case30", "case118"])
def test_wr_bus_pairs(name):
    """The canonical bus pairs: one per connected pair (parallel branches
    share one), each branch's pair and orientation, and the inverse map a
    flat array as the JAX module uses it, whatever numpy's release."""
    case = t_matpower.load_case(name)
    pairs, br_pair, orient = t_acopf._bus_pairs(case)
    lo = np.minimum(case.br_f, case.br_t)
    hi = np.maximum(case.br_f, case.br_t)
    want_pairs, want_inv = np.unique(np.stack([lo, hi], axis=1), axis=0, return_inverse=True)
    np.testing.assert_array_equal(pairs, want_pairs)
    assert br_pair.shape == (case.nl,)
    np.testing.assert_array_equal(br_pair, want_inv.reshape(-1))
    np.testing.assert_array_equal(pairs[br_pair], np.stack([lo, hi], axis=1))
    np.testing.assert_array_equal(orient, np.where(case.br_f == lo, 1.0, -1.0))
    if name == "case118":
        assert len(pairs) < case.nl  # case118 has parallel branches


@pytest.mark.parametrize("form", ["rect", "ivr", "wr"])
@pytest.mark.parametrize("segs,dc", [(4, None), (0, "free")])
def test_other_formulations_reject_extensions(tmp_cases, form, segs, dc):
    j_case, t_case = _cases(("polar", "case9", segs, dc), tmp_cases)
    with pytest.raises(NotImplementedError, match="acopf_polar"):
        getattr(j_acopf, f"acopf_{form}")(j_case)
    with pytest.raises(NotImplementedError, match="acopf_polar"):
        getattr(t_acopf, f"acopf_{form}")(t_case)


def test_wr_rejects_taps():
    with pytest.raises(ValueError, match="tap=1, shift=0"):
        j_acopf.acopf_wr(j_matpower.load_case("case118"))
    with pytest.raises(ValueError, match="tap=1, shift=0"):
        t_acopf.acopf_wr(t_matpower.load_case("case118"))


@pytest.mark.parametrize("key", ["polar-case9-pwl12", "polar-case9-dcfree"])
def test_structured_mode_rejects_extension_cases(models, key):
    j, t, _ = models[key]
    with pytest.raises(ValueError, match="kkt_structured=True requires nlp.structure"):
        sqp.make_solver(j, sqp.Parameters(kkt_structured=True))
    with pytest.raises(ValueError, match="kkt_structured=True requires nlp.structure"):
        tp.make_solver(t, tp.Parameters(kkt_structured=True))


def _solve(form, name, segs=0, dc=None, directory=None, hessian_shift="eigh"):
    """One port solve on the CPU with ``PARAMS`` (cached per worker)."""
    return _solve_cached(form, name, segs, dc, directory, hessian_shift)


@functools.lru_cache(maxsize=None)
def _solve_cached(form, name, segs, dc, directory, hessian_shift):
    if segs or dc:
        case = t_matpower.case9_variant(directory, segs, dc)
    else:
        case = t_matpower.load_case(name)
    nlp = getattr(t_acopf, f"acopf_{form}")(case, scenario_batchable=False)
    params = tp.Parameters(**PARAMS, hessian_shift=hessian_shift)
    return tp.optimize(nlp, params, device="cpu")


@pytest.mark.parametrize("form,name,rtol", [
    ("ivr", "case9", 2e-3), ("ivr", "case30", 2e-3), ("rect", "case9", 1e-4),
    ("wr", "case9", 1e-4),
])
def test_formulation_matches_polar(form, name, rtol):
    """``tests/test_acopf.py``'s parity tests: each formulation's optimum
    against polar's (IVR's rational current balance against the 1e-4 dual
    tolerance leaves a gap, hence 2e-3 there, as in the JAX test)."""
    res_p = _solve("polar", name)
    res = _solve(form, name)
    assert res_p.success and res.success, (res_p.status_name, res.status_name)
    assert float(res.prim_infeas) < 1e-6
    np.testing.assert_allclose(res.obj_val, res_p.obj_val, rtol=rtol)


def test_pwl_gencost_epigraph(tmp_cases):
    """12-segment PWL outer approximation of the case9 quadratics: the PWL
    curve lies on the quadratic at breakpoints and above between them, so
    the optimum is at least the quadratic one, and within 1%."""
    parsed = t_matpower.case9_variant(str(tmp_cases), 12)
    assert parsed.pwl_gen is not None and len(parsed.pwl_gen) == 36
    assert parsed.n_pwl_gen == 3
    assert np.all(parsed.cost_c2 == 0) and np.all(parsed.cost_c1 == 0)
    res = _solve("polar", "case9", 12, None, str(tmp_cases))
    assert res.success, res.status_name
    assert CASE9_OPT * (1 - 1e-4) <= float(res.obj_val) <= CASE9_OPT * 1.01


def test_pwl_nonconvex_rejected(tmp_path):
    import re

    bad = ("mpc.gencost = [\n"
           "  1 0 0 3 10 100 20 190 30 200;\n"
           "  2 0 0 3 0.085 1.2 0;\n"
           "  2 0 0 3 0.1225 1 0;\n"
           "];")
    text = re.sub(r"mpc\.gencost = \[.*?\];", bad, t_matpower.case9_m_text(), flags=re.DOTALL)
    path = tmp_path / "case9bad.m"
    path.write_text(text)
    with pytest.raises(ValueError, match="convex"):
        t_matpower.parse_matpower(str(path), name="case9bad")


@pytest.mark.parametrize("dc", ["zero", "free", "lossy"])
def test_dcline_solves(tmp_cases, dc):
    """A dcline pinned to zero transfer does not move the optimum; a free
    lossless one can only help; forcing 40 MW through a 10% loss costs."""
    parsed = t_matpower.case9_variant(str(tmp_cases), 0, dc)
    assert parsed.ndc == 1
    res = _solve("polar", "case9", 0, dc, str(tmp_cases))
    assert res.success, res.status_name
    if dc == "zero":
        np.testing.assert_allclose(float(res.obj_val), CASE9_OPT, rtol=1e-4)
    elif dc == "free":
        assert float(res.obj_val) <= CASE9_OPT * (1 + 1e-6)
    else:
        assert float(res.obj_val) > CASE9_OPT * (1 + 1e-5)


def test_replicate_tiles_extensions(tmp_cases):
    parsed = t_matpower.case9_variant(str(tmp_cases), 4, "free")
    rep = t_power.replicate_case(parsed, 3)
    assert rep.ndc == 3 and rep.n_pwl_gen == 9
    assert rep.dc_f[1] == parsed.dc_f[0] + 9
    assert rep.pwl_gen[len(parsed.pwl_gen)] == parsed.pwl_gen[0] + 3
    nlp = t_acopf.acopf_polar(rep)
    assert nlp.num_linear == 1 + 3 * len(parsed.pwl_gen) and nlp.structure is None


#: the anchor's one-lane solves that this file repeats on the CPU (case118
#: is left to the card: ``chip_smoke.py --paths forms_single``)
ANCHORED = ["rect_case9", "ivr_case9", "ivr_case30", "wr_case9", "wr_case30",
            "polar_case9_pwl12", "polar_case9_dcline"]


def _solve_anchored(anchor, tmp_cases, name, hessian_shift):
    form, case, segs, dc = anchor["forms"][name]
    return _solve(form, case, segs, dc, str(tmp_cases) if (segs or dc) else None, hessian_shift)


@pytest.mark.parametrize("name", ANCHORED)
def test_solve_matches_jax_anchor(anchor, tmp_cases, name):
    """The reference example's parameters: JAX's status and iterations, the
    objective within 1e-6 relative (the gate of ``chip_smoke.py``).  The
    default ``eigh`` shift estimates the smallest Hessian eigenvalue in
    float32, whose last bits differ between LAPACK builds; on the
    near-linear PWL epigraph and on IVR case30 that moves the objective by
    ~2e-8 and ~7e-8 relative in the same number of iterations."""
    assert anchor["params"] == PARAMS
    res = _solve_anchored(anchor, tmp_cases, name, "eigh")
    want = anchor["solves"][name]
    assert int(res.status) == want["status"], res.status_name
    assert int(res.iterations) == want["iterations"]
    assert abs(res.obj_val - want["obj"]) <= 1e-6 * abs(want["obj"])


@pytest.mark.parametrize("name", ["rect_case9", "ivr_case9", "wr_case9", "polar_case9_pwl12",
                                  "polar_case9_dcline"])
def test_float64_solve_matches_jax_exactly(anchor, tmp_cases, name):
    """One case9 solve per formulation with the ``ladder`` shift, float64
    throughout: JAX's status, iterations and QP trips, the objective within
    1e-9 relative."""
    assert anchor["params_ladder"] == dict(PARAMS, hessian_shift="ladder")
    res = _solve_anchored(anchor, tmp_cases, name, "ladder")
    want = anchor["solves_ladder"][name]
    assert int(res.status) == want["status"], res.status_name
    assert (int(res.iterations), int(res.qp_iters_total)) == (want["iterations"], want["qp_iters_total"])
    assert abs(res.obj_val - want["obj"]) <= 1e-9 * abs(want["obj"])
