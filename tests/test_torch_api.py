"""The port's single-NLP entry point against the JAX package's, live.

Both packages run ``optimize`` on the same problem on the CPU, float64 with
``kkt_precision="direct"`` (the defaults), and must agree: the same status,
the same iteration count and counters (QP trips, accepts, rejects, SOC
accepts, FR entries), the objective within 1e-10 relative and ``x`` within
1e-8 (relative to the largest entry).  Cases: the toy problem, hs071, the
infeasible and the unbounded problem under SQP-TR, and the
``tests/test_api_conformance.py`` cases built with ``build_nlp``: maximize
un-scaling with its duals, ranged-row duals (upper and lower side active),
a fixed variable with its reduced cost, and the dual warm start.

One count differs, and not through the port: under the default ``eigh``
Hessian shift hs071 takes 377 QP trips in the port and 376 in the JAX
package.  The shift is the float32 ``eigvalsh`` of each LAPACK build (MKL
under torch), whose last bits differ; the shifted QP then differs at 1e-8
and its second solve crosses its tolerance one trip later (ROADMAP Queue 3).
hs071 is therefore also compared under the ``gershgorin`` shift, which uses
no LAPACK, where every count agrees.

The iteration printer (``OutputFlag=1``) prints the JAX package's header and
lines, character for character but the time column, and ``StatisticsFlag=1``
fills the same arrays; the dispatch on ``Parameters.algorithm``, ``Results``
and ``from_raw`` behave as the JAX package's.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqpsolver_tpu as jsqp
import sqpsolver_tpu_torch as tp
from sqpsolver_tpu.models import hs as j_hs
from sqpsolver_tpu.models import toy as j_toy
from sqpsolver_tpu_torch.models import hs as t_hs
from sqpsolver_tpu_torch.models import toy as t_toy

P = dict(max_iter=200, OutputFlag=0)
COUNTERS = ("iterations", "qp_iters_total", "n_accept", "n_reject", "n_soc_accept", "n_fr_iters")


def assert_same_solve(tr, jr, what=""):
    """The port's Results ``tr`` against the JAX package's ``jr``."""
    assert tr.status == jr.status, f"{what}: {tr.status_name} vs {jr.status_name}"
    for key in COUNTERS:
        assert getattr(tr, key) == getattr(jr, key), f"{what}: {key}"
    scale = max(1.0, float(np.abs(jr.x).max()))
    assert float(np.abs(tr.x - jr.x).max()) <= 1e-8 * scale, f"{what}: x {tr.x} vs {jr.x}"
    assert abs(tr.obj_val - jr.obj_val) <= 1e-10 * max(1.0, abs(jr.obj_val)), what
    for key in ("mult_g", "mult_x_L", "mult_x_U"):
        a, b = getattr(tr, key), getattr(jr, key)
        assert float(np.abs(a - b).max(initial=0.0)) <= 1e-6 * max(1.0, float(np.abs(b).max(initial=0.0))), key


def _conformance(lib, xp):
    """The build_nlp cases of tests/test_api_conformance.py, written once for
    either package (``lib``: the package, ``xp``: its array module)."""

    def vec(*rows):
        return xp.stack(list(rows))

    return {
        "maximize": lib.build_nlp(
            lambda x: -((x[0] - 3.0) ** 2) - (x[1] + 1.0) ** 2,
            np.zeros(2),
            linear=lambda x: vec(x[0]),
            linear_u=np.array([1.0]),
            maximize=True,
        ),
        "ranged_upper": lib.build_nlp(
            lambda x: xp.sum((x - 2.0) ** 2),
            np.zeros(2),
            linear=lambda x: vec(x[0] + x[1]),
            linear_l=np.array([0.0]),
            linear_u=np.array([2.0]),
        ),
        "ranged_lower": lib.build_nlp(
            lambda x: xp.sum((x + 2.0) ** 2),
            np.zeros(2),
            linear=lambda x: vec(x[0] + x[1]),
            linear_l=np.array([-2.0]),
            linear_u=np.array([5.0]),
        ),
        "fixed_variable": lib.build_nlp(
            lambda x: (x[0] - 1.0) ** 2 + (x[1] - 5.0) ** 2,
            np.array([0.0, 3.0]),
            x_l=np.array([-np.inf, 3.0]),
            x_u=np.array([np.inf, 3.0]),
        ),
        "warm_start": lib.build_nlp(
            lambda x: xp.sum((x - 2.0) ** 2),
            np.zeros(2),
            eq=lambda x: vec(x[0] + x[1] - 2.0),
        ),
    }


def _problem(name):
    """(port NLP, JAX NLP) of a live case."""
    if name == "toy":
        return t_toy.toy_nlp(), j_toy.toy_nlp()
    if name == "hs071":
        return t_hs.hs_problem(name).nlp, j_hs.hs_problem(name).nlp
    if name in ("infeasible", "unbounded"):
        return getattr(t_hs, f"{name}_nlp")(), getattr(j_hs, f"{name}_nlp")()
    return _conformance(tp, torch)[name], _conformance(jsqp, jnp)[name]


@pytest.mark.parametrize(
    "name,shift",
    [("toy", "eigh"), ("hs071", "eigh"), ("hs071", "gershgorin"), ("infeasible", "eigh"),
     ("unbounded", "eigh"), ("maximize", "eigh"), ("ranged_upper", "eigh"),
     ("ranged_lower", "eigh"), ("fixed_variable", "eigh")],
)
def test_optimize_matches_jax(name, shift):
    t_nlp, j_nlp = _problem(name)
    kw = dict(P, max_iter=500) if name in ("infeasible", "unbounded") else dict(P)
    kw["hessian_shift"] = shift
    jr = jsqp.optimize(j_nlp, jsqp.Parameters(**kw))
    tr = tp.optimize(t_nlp, tp.Parameters(**kw), device="cpu")
    if (name, shift) == ("hs071", "eigh"):  # the LAPACK eigenvalue (module docstring)
        assert (tr.qp_iters_total, jr.qp_iters_total) == (377, 376)
        tr.qp_iters_total = jr.qp_iters_total
    assert_same_solve(tr, jr, name)
    expected = {"infeasible": tp.Status.INFEASIBLE_PROBLEM_DETECTED,
                "unbounded": tp.Status.DIVERGING_ITERATES}.get(name, tp.Status.SOLVE_SUCCEEDED)
    assert tr.status == expected, tr.status_name
    if name == "maximize":
        # reported in the max sense; the row's upper side is active
        np.testing.assert_allclose(tr.obj_val, -4.0, atol=1e-6)
        np.testing.assert_allclose(tr.mult_g, [4.0], atol=1e-4)
    if name.startswith("ranged"):
        np.testing.assert_allclose(tr.mult_g, [2.0 if name == "ranged_upper" else -2.0], atol=1e-4)
    if name == "fixed_variable":
        np.testing.assert_allclose(tr.x, [1.0, 3.0], atol=1e-6)
        np.testing.assert_allclose(tr.mult_x_U[1], 4.0, atol=1e-4)


def test_dual_warm_start_matches_jax():
    t_nlp, j_nlp = _problem("warm_start")
    j_solver = jsqp.make_solver(j_nlp, jsqp.Parameters(**P))
    t_solver = tp.make_solver(t_nlp, tp.Parameters(**P))
    j_data = j_nlp.data()
    t_data = tp.batch_data(t_nlp, 1, device="cpu")
    j_cold = jsqp.from_raw(j_solver(j_data), 0.0)
    t_cold = tp.from_raw(t_solver(t_data), 0.0)
    assert_same_solve(t_cold, j_cold, "cold")
    j_data.lam0 = jnp.asarray(j_cold.mult_g)
    t_data.lam0 = torch.as_tensor(t_cold.mult_g)[None]
    j_warm = jsqp.from_raw(j_solver(j_data), 0.0)
    t_warm = tp.from_raw(t_solver(t_data), 0.0)
    assert_same_solve(t_warm, j_warm, "warm")
    assert t_warm.success and t_warm.iterations <= t_cold.iterations
    np.testing.assert_allclose(t_warm.x, t_cold.x, atol=1e-8)


NUMBER = re.compile(r"[-+]?\d\.\d{8}e[-+]\d{2}|\s+Inf|[-+]?inf|nan")


def _layout(text):
    """The printed lines with the time column (an iteration line's last 12
    characters) cut and every printed number replaced by a mark of its
    width, and the numbers themselves: the layout must match character for
    character, the numbers to rounding (values at round-off level, such as
    an objective of 1e-12, differ in their leading digits between the two
    packages' arithmetic)."""
    lines, numbers = [], []
    for line in text.splitlines():
        if re.match(r"^(FR|  )\s*\d+", line):
            line = line[:-12]
            numbers.append([float(v) for v in NUMBER.findall(line)])
            line = NUMBER.sub(lambda mt: "#" * len(mt.group()), line)
        lines.append(line)
    return lines, numbers


@pytest.mark.parametrize("algorithm", ["SQP-TR", "SQP-LS"])
def test_printer_and_statistics_match_jax(algorithm, capsys):
    kw = dict(max_iter=200, OutputFlag=1, StatisticsFlag=1, algorithm=algorithm)
    jr = jsqp.optimize(j_toy.toy_nlp(), jsqp.Parameters(**kw))
    jax.effects_barrier()
    j_out = capsys.readouterr().out
    tr = tp.optimize(t_toy.toy_nlp(), tp.Parameters(**kw), device="cpu")
    t_out = capsys.readouterr().out
    assert_same_solve(tr, jr, algorithm)
    (t_lines, t_nums), (j_lines, j_nums) = _layout(t_out), _layout(j_out)
    assert len(t_lines) == tr.iterations  # the header and one line per iteration
    assert t_lines == j_lines
    assert t_lines[0] == j_out.splitlines()[0] and "#" in t_lines[1]
    np.testing.assert_allclose(np.array(t_nums), np.array(j_nums), rtol=1e-7, atol=1e-9)
    if algorithm == "SQP-LS":  # the line search keeps no statistics, as in JAX
        assert tr.statistics is None and jr.statistics is None
        return
    assert set(tr.statistics) == set(jr.statistics)
    for key, want in jr.statistics.items():
        got = tr.statistics[key]
        assert got.shape == (tr.iterations + 1,) and got.dtype == want.dtype, key
        scale = max(1.0, float(np.abs(want).max()))  # relative to the largest entry
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * scale, err_msg=key)


def test_verbose_false_and_batches_print_nothing(capsys):
    nlp = t_toy.toy_nlp()
    tp.optimize(nlp, tp.Parameters(max_iter=200), device="cpu", verbose=False)
    tp.make_solver(nlp, tp.Parameters(max_iter=200))(tp.batch_data(nlp, 2, device="cpu"))
    tp.make_batch_solver(nlp, tp.Parameters(max_iter=200))(tp.batch_data(nlp, 1, device="cpu"))
    assert capsys.readouterr().out == ""


def test_statistics_of_a_batch_keep_each_lanes_rows():
    """Three lanes from three starts: each lane's statistics equal those of
    its own one-lane solve, and rows past its last iteration stay zero."""
    nlp = t_hs.hs_problem("hs071").nlp
    rng = np.random.default_rng(7)
    x0 = np.clip(nlp.x0 + 0.3 * rng.standard_normal((3, nlp.n)), nlp.x_l, nlp.x_u)
    params = tp.Parameters(max_iter=100, OutputFlag=0, StatisticsFlag=1)
    solver = tp.make_solver(nlp, params)
    out = solver(tp.batch_data(nlp, 3, x0=x0, device="cpu"))
    for lane in range(3):
        res = tp.from_raw(out, 0.0, lane=lane)
        solo = tp.from_raw(solver(tp.batch_data(nlp, 1, x0=x0[lane:lane + 1], device="cpu")), 0.0)
        assert res.iterations == solo.iterations
        for key, val in res.statistics.items():
            assert val.shape == (res.iterations + 1,)
            np.testing.assert_allclose(val, solo.statistics[key], rtol=1e-12, err_msg=key)
        assert float(out.stats["f"][lane, res.iterations + 1:].abs().max()) == 0.0


def test_dispatch_and_results():
    nlp = t_hs.hs_problem("hs071").nlp
    with pytest.raises(ValueError, match="Invalid_Option"):
        tp.make_solver(nlp, tp.Parameters(algorithm="bogus"))
    with pytest.raises(ValueError, match="Invalid_Option"):
        tp.optimize(nlp, tp.Parameters(algorithm="bogus"), device="cpu")
    res = tp.optimize(nlp, tp.Parameters(max_iter=200, OutputFlag=0), device="cpu")
    assert isinstance(res, tp.Results) and res.success
    assert res.status_name == "Solve_Succeeded"
    np.testing.assert_allclose(res.obj_val, 17.0140173, rtol=1e-6)
    assert res.statistics is None and res.solve_time > 0.0
    assert repr(res).startswith("Results(status=Solve_Succeeded, obj=1.70140173e+01, iter=47,")
    j_res = jsqp.Results(**{**res.__dict__, "status": jsqp.Status(int(res.status))})
    assert repr(j_res) == repr(res)
