"""Write the per-lane JAX references that ``chip_smoke.py`` holds the port to.

Runs the JAX package on the CPU with one of the PyTorch port's two path
configurations and writes each lane's status, objective, SQP iterations and
IPM trips to ``sqpsolver_tpu_torch/data/anchor_<case>_b<batch>.json``.  The
file also holds the configuration itself, so the smoke run and this script
cannot drift apart.

* ``--case case30 --batch 32`` (the default): real MATPOWER case30, dense
  SQP-TR with ``mixed_ir`` factorizations, the ``ladder`` Hessian shift,
  rescue and initial projection off, one monolithic batched solve.
* ``--case case118 --batch 16``: real IEEE case118 (n=344, m=609) with the
  same parameters through ``make_chunked_batch_solver(sub_batch=128,
  rescue_fallback=True)``: a float32-factor first pass, then a rescue-enabled
  re-solve (float64 IPM phase 2) of the lanes that ended in
  ``Error_In_Step_Computation``.  The first pass is also run on its own, so
  the file can say which lanes took the fallback.
* ``--algorithm SQP-LS`` (case30 b32): the same configuration under the
  line-search driver, one vmapped solve of the JAX package's
  ``make_ls_solver(...)._raw``; written to ``anchor_ls_case30_b32.json``.
* ``--hs``: the single-NLP battery: every Hock-Schittkowski problem, the
  toy problem and the two pathological problems (``infeasible_nlp``,
  ``unbounded_nlp``) through ``optimize`` under SQP-TR with the TR battery's
  parameters and under SQP-LS with the LS battery's, plus the three drives
  of the verify recipe (toy and hs071 at ``max_iter=200``, ACOPF case9 with
  its tolerances).  Each solve's status, objective, ``x``, iterations,
  ``prim_infeas`` and counters go to ``anchor_hs.json``.
* ``--structured``: the block-structured (BBD) KKT path.  With a case and
  batch (default case118 b16) the batched configuration above with
  ``kkt_structured=True``; case118 goes through
  ``make_chunked_batch_solver(sub_batch=8, rescue_fallback=True)`` as the
  JAX bench drives it with ``SQP_BENCH_STRUCTURED=1``, case30 through
  ``make_batch_solver``.  Written to ``anchor_structured_<case>_b<batch>.json``.
* ``--structured --single``: one-lane structured solves through
  ``optimize``: real case118 under the ``ladder`` shift with SOC, case9 under
  the defaults and under ``mixed_ir`` + ``ladder``, and the coupled
  two-stage case9 problem (K=3, shared dispatch) both structured and dense.
  Written to ``anchor_structured_single.json``.
* ``--form {polar,rect,ivr,wr}`` (default ``polar``): the batched
  configurations above with another ACOPF formulation.  A formulation other
  than polar writes ``anchor_<form>_<case>_b<batch>.json`` and records the
  formulation as ``form``; polar files are written as before.
* ``--one-thread`` with a batched configuration: the same reference run on
  one core with XLA's CPU matmuls single-threaded, its lanes added to the
  existing anchor file as ``one_thread``.  On rectangular case118 lane 0
  that rounding alone moves the JAX package's own objective by 4.7e-6 (13
  iterations against 25): the smoke run accepts a lane within 1e-6 of either
  reference run.
* ``--forms-single``: one-lane float64 solves of the other formulations and
  of the polar extensions through ``optimize`` with ``tests/test_acopf.py``'s
  parameters: ``acopf_rect`` on case9 and case118, ``acopf_ivr`` and
  ``acopf_wr`` on case9 and case30, and ``acopf_polar`` on case9 with 12 PWL
  cost segments and with one dcline (built from
  ``sqpsolver_tpu_torch.models.matpower.case9_m_text`` in a temporary
  directory); the case9 solves also with ``hessian_shift="ladder"``
  (float64 throughout).  Written to ``anchor_forms_single.json``.

* ``--block-sharded``: ``tests/test_block_sharding.py``'s problem and
  parameters, the coupled two-stage case9 problem (K=4 load scenarios,
  ``kkt_parts=8``, ``power`` shift), solved by the JAX package block-sharded
  over a fake 8-device CPU mesh and unsharded: status, objective,
  iterations and QP trips of each.  Written to
  ``anchor_block_sharded_case9.json``.
* ``--multiprocess``: ``tests/test_multiprocess.py``'s fleet, a global
  batch of 4 case9 load scenarios (``load_scenarios(case9, 4, seed=7,
  spread=0.03)``) with its parameters, solved by the JAX package's
  ``make_sharded_solver`` over a fake 4-device CPU mesh (one lane a device,
  as its two processes of two devices hold them): each lane's status,
  objective, iterations and QP trips.  Written to
  ``anchor_multiprocess_case9_b4.json``.
* ``--plane``: the float32 matrix plane (``kkt_precision="mixed_plane"``).
  With a batched configuration (default case30 b32) the configuration above
  with that one change, written to ``anchor_plane_<case>_b<batch>.json``.
  ``--plane --single`` writes ``anchor_plane_single.json``: one-lane case30
  through ``optimize`` with ``tests/test_schur_cap.py``'s plane parameters
  (``power`` shift, SOC), SQP-LS hs071, structured case9 under ``ladder``, and
  case30 b4 at the batched configuration through ``make_batch_solver``, the
  batch also through the ``"xla"`` factor route (``batch_lanes_xla``: on
  these float32-factor solves the two routes' rounding alone moves lanes'
  iteration counts).

* ``--replicated``: interconnected copies of a real network
  (``models/power.replicate_case``), the pegase-scale configuration of
  ``scripts/pegase_solve.py``: the block-structure summaries of case118 x4,
  x12 and x24 (P, nd, ns, the per-part stiff cap, the Schur size and hashes
  of the part assignment and colorings); case118x4 solved through
  ``optimize`` with that script's parameters; case118x12 stopped after two
  SQP iterations (status, objective, ``x``); ten copies of case30 through
  ``tests/test_structured.py``'s presolve-then-structured flow, as the test
  runs it and with the float64 ``ladder`` shift, and its presolve's
  first iterate (``x0`` / ``lam0`` after one SQP iteration); and three
  copies of case9 under the script's parameters and under the structured
  bench configuration (``mixed_ir`` on ``xla``).  Each piece also records
  its JAX wall.  ``--only NAME[,NAME]`` runs the named pieces and merges
  them into the existing file (``REPLICATED_PIECES``).  Written to
  ``anchor_replicated.json``.
* ``--tests``: the JAX halves of port CPU tests whose live JAX solve cost
  more than ten seconds of compiling, each a piece named after its test
  (``TESTS_PIECES``): ``ls_case9_b4`` (``tests/test_torch_ls.py``'s batch of
  four case9 load scenarios under SQP-LS, ``jax.vmap`` of the JAX LS solve),
  ``chunked_hs071_b3`` (``tests/test_torch_chunked.py``'s hs071 lanes under
  ``mixed_ir`` with ``qp_rescue`` and under ``mixed_polish``, through the
  JAX package's batched solver), ``toy_sharded_b16`` (the toy fleet of
  ``tests/test_torch_sharding.py`` through the JAX package's
  ``make_sharded_solver`` on the fake 8-device CPU mesh) and ``slice_case5_b4``
  (``tests/test_torch_slice.py``'s case5 slice, interpret-mode Pallas).  Run
  on the tests' own fake 8-device mesh; ``--only NAME[,NAME]`` runs the
  named pieces and merges them into ``anchor_tests.json``.  The tests take
  each piece's configuration (sizes, seeds, starts, parameters) from the
  file, so it is written once, here; hs071 comes from
  ``tests/hs071_problem.py``, which the test imports too.

Usage::

    JAX_PLATFORMS=cpu python scripts/torch_anchor.py [--case C] [--batch B]
        [--algorithm SQP-TR|SQP-LS] [--backend pallas|xla] [--max-iter N]
        [--form polar|rect|ivr|wr] [--cache-dir DIR] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_anchor.py --hs [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_anchor.py --forms-single [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_anchor.py --structured [--single]
        [--case C] [--batch B] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_anchor.py --block-sharded [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_anchor.py --multiprocess [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_anchor.py --plane [--single]
        [--case C] [--batch B] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_anchor.py --replicated
        [--only NAME[,NAME]] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_anchor.py --tests
        [--only NAME[,NAME]] [--out PATH]

The reference's factorization backend defaults to the path's own,
``kkt_backend="pallas"``: on the CPU the JAX Cholesky kernel runs in
interpret mode, the closest reference to the port's hand-written kernel.
``--backend xla`` runs the reference through ``jnp.linalg.cholesky`` instead
(the file's ``params`` keep the path's own backend, ``reference`` names the
one that ran).  The rescue path needs it: the JAX package's blocked route
casts every matrix to float32, float64 phase-2 factors included, while its
xla route factors them in float64 as the port does.  ``--cache-dir`` names a
JAX persistent compilation cache, which lets the two case118 solves share
their compiled programs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "sqpsolver_tpu_torch", "data")

#: bench.py's dense configuration plus the kernel backend
PARAMS = dict(
    max_iter=40,
    OutputFlag=0,
    tol_infeas=1.0e-6,
    tol_residual=1.0e-4,
    qp_max_iter=30,
    dtype="float64",
    kkt_precision="mixed_ir",
    hessian_shift="ladder",
    kkt_ir_steps=2,
    qp_rescue=False,
    schur_cap=-1,
    init_projection="off",
    kkt_backend="pallas",
)

#: how bench.py drives each case: case118 goes through the chunked solver
CHUNKED = {
    "case30": None,
    "case118": dict(sub_batch=128, rescue_fallback=True),
}
#: ... and under ``SQP_BENCH_STRUCTURED=1`` (its slab is 8 wide there)
CHUNKED_STRUCTURED = {
    "case30": None,
    "case118": dict(sub_batch=8, rescue_fallback=True),
}


XLA_NOTE = (
    "reference run with kkt_backend='xla': the JAX package's blocked "
    "(pallas) route casts every matrix to float32, so under it the IPM's "
    "phase 2 is not a float64 phase; the xla route factors phase 2 in true "
    "float64, which is what the port does under either backend"
)


ONE_THREAD_NOTE = (
    "the same reference run on one core with XLA's CPU matmuls single-"
    "threaded: their rounding differs from the multi-threaded run's, and on a "
    "lane whose float32 first-pass trajectory that rounding decides, the "
    "reference itself stops at another point of the same optimum, more than "
    "1e-6 away in objective"
)


def lanes_of(out) -> dict:
    return dict(
        status=np.asarray(out.status).astype(int).tolist(),
        obj=[float(v) for v in np.asarray(out.obj_val)],
        iterations=np.asarray(out.iterations).astype(int).tolist(),
        qp_trips=np.asarray(out.qp_iters_total).astype(int).tolist(),
    )


#: the single-NLP battery's parameters: the JAX package's HS batteries
#: (``tests/test_hs.py`` ``PARAMS``, ``tests/test_ls.py`` ``BATTERY_PARAMS``)
#: and the verify recipe's drives
HS_PARAMS = {
    "SQP-TR": dict(max_iter=500, OutputFlag=0),
    "SQP-LS": dict(algorithm="SQP-LS", max_iter=500, OutputFlag=0),
}
DRIVE_PARAMS = {
    "toy": dict(max_iter=200, OutputFlag=0),
    "hs071": dict(max_iter=200, OutputFlag=0),
    "case9": dict(max_iter=100, OutputFlag=0, tol_infeas=1e-6, tol_residual=1e-4,
                  use_soc=True),
}


def result_record(res) -> dict:
    """One ``optimize`` result as stored in ``anchor_hs.json``."""
    return dict(
        status=int(res.status),
        obj=float(res.obj_val),
        x=[float(v) for v in np.asarray(res.x)],
        iterations=int(res.iterations),
        prim_infeas=float(res.prim_infeas),
        dual_infeas=float(res.dual_infeas),
        qp_iters_total=int(res.qp_iters_total),
        n_accept=int(res.n_accept),
        n_reject=int(res.n_reject),
        n_soc_accept=int(res.n_soc_accept),
        n_fr_iters=int(res.n_fr_iters),
    )


def _hs_problems() -> dict:
    from sqpsolver_tpu.models import hs
    from sqpsolver_tpu.models.toy import toy_nlp

    problems = {name: hs.hs_problem(name).nlp for name in hs.hs_names()}
    problems.update(toy=toy_nlp(), infeasible=hs.infeasible_nlp(),
                    unbounded=hs.unbounded_nlp())
    return problems


def _drive_problem(name: str):
    from sqpsolver_tpu.models.acopf import acopf_polar
    from sqpsolver_tpu.models.power import case9

    if name == "case9":
        return acopf_polar(case9(), scenario_batchable=False)
    return _hs_problems()[name]


#: the structured single-NLP solves: ``tests/test_structured.py``'s case118
#: ladder test and case9 optimum test (also under ``mixed_ir`` + ``ladder``,
#: with two and three refinement sweeps), and ``tests/test_stochastic.py``'s
#: coupled structured-vs-dense test
_ACOPF_TOL = dict(OutputFlag=0, tol_infeas=1e-6, tol_residual=1e-4)
STRUCTURED_SINGLE = {
    "case118": dict(_ACOPF_TOL, max_iter=40, use_soc=True, kkt_structured=True,
                    hessian_shift="ladder"),
    "case9": dict(_ACOPF_TOL, max_iter=60, kkt_structured=True),
    "case9_mixed": dict(_ACOPF_TOL, max_iter=60, kkt_structured=True,
                        kkt_precision="mixed_ir", hessian_shift="ladder"),
    "case9_mixed_ir3": dict(_ACOPF_TOL, max_iter=60, kkt_structured=True,
                            kkt_precision="mixed_ir", hessian_shift="ladder",
                            kkt_ir_steps=3),
    "coupled_case9": dict(_ACOPF_TOL, max_iter=100, use_soc=True,
                          kkt_structured=True, hessian_shift="power"),
    "coupled_case9_dense": dict(_ACOPF_TOL, max_iter=100, use_soc=True),
}
#: the coupled problem: K load scenarios of case9 sharing the non-slack pg
COUPLED = dict(case="case9", K=3, seed=3, spread=0.03)


def _structured_problem(name: str):
    from sqpsolver_tpu.models.acopf import acopf_polar, load_scenarios
    from sqpsolver_tpu.models.matpower import load_case
    from sqpsolver_tpu.models.power import case9
    from sqpsolver_tpu.models.stochastic import couple_scenarios, pg_shared_mask

    if name == "case118":
        return acopf_polar(load_case("case118"), scenario_batchable=False)
    if name.startswith("case9"):
        return acopf_polar(case9(), scenario_batchable=False)
    case = case9()
    nlp = acopf_polar(case)
    thetas = load_scenarios(case, COUPLED["K"], seed=COUPLED["seed"],
                            spread=COUPLED["spread"])
    return couple_scenarios(nlp, thetas, pg_shared_mask(case, nlp))


def run_structured_single(out_path: str) -> None:
    """``--structured --single``: the one-lane structured anchors."""
    import jax

    import sqpsolver_tpu as sqp

    t0 = time.time()
    record = dict(
        reference=dict(
            package="JAX reference package",
            platform=jax.devices()[0].platform,
            jax_version=jax.__version__,
        ),
        params=STRUCTURED_SINGLE,
        coupled=COUPLED,
        solves={},
    )
    for name, kw in STRUCTURED_SINGLE.items():
        t1 = time.time()
        rec = result_record(sqp.optimize(_structured_problem(name), sqp.Parameters(**kw)))
        rec["seconds_with_compile"] = round(time.time() - t1, 1)
        record["solves"][name] = rec
        print(f"[{time.time() - t0:7.1f}s] {name}: {rec['status']} "
              f"{rec['obj']:.10g} in {rec['iterations']}", file=sys.stderr, flush=True)
    with open(out_path, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")


#: ``--forms-single``: ``tests/test_acopf.py``'s ``PARAMS`` for every solve
FORMS_PARAMS = dict(max_iter=100, OutputFlag=0, tol_infeas=1e-6, tol_residual=1e-4,
                    use_soc=True)
#: name -> (formulation, case, PWL segments, ``DCLINES`` key of the dcline)
FORMS_SINGLE = {
    "rect_case9": ("rect", "case9", 0, None),
    "rect_case118": ("rect", "case118", 0, None),
    "ivr_case9": ("ivr", "case9", 0, None),
    "ivr_case30": ("ivr", "case30", 0, None),
    "wr_case9": ("wr", "case9", 0, None),
    "wr_case30": ("wr", "case30", 0, None),
    "polar_case9_pwl12": ("polar", "case9", 12, None),
    "polar_case9_dcline": ("polar", "case9", 0, "free"),
}
#: the case9 solves again with the ``ladder`` shift: float64 arithmetic
#: throughout, where the default ``eigh`` shift estimates the smallest
#: eigenvalue in float32, whose last bits differ between LAPACK builds
FORMS_LADDER = [name for name, spec in FORMS_SINGLE.items() if spec[1] == "case9"]


def forms_case(spec, directory):
    """The case of one ``FORMS_SINGLE`` entry, parsed by the JAX package;
    PWL and dcline variants of case9 are written to ``directory`` from the
    port's ``case9_m_text``, under the name its ``case9_variant`` gives them."""
    from sqpsolver_tpu.models import matpower

    import sqpsolver_tpu_torch.models.matpower as t_matpower

    _, case, segs, dc = spec
    if not (segs or dc):
        return matpower.load_case(case)
    name = t_matpower.case9_variant_name(segs, dc)
    path = os.path.join(directory, f"{name}.m")
    with open(path, "w") as fh:
        fh.write(t_matpower.case9_m_text(segs, t_matpower.DCLINES[dc] if dc else None))
    return matpower.parse_matpower(path, name=name)


def run_forms_single(out_path: str) -> None:
    """``--forms-single``: the one-lane anchors of the other formulations."""
    import tempfile

    import jax

    import sqpsolver_tpu as sqp
    from sqpsolver_tpu.models import acopf

    t0 = time.time()
    record = dict(
        reference=dict(
            package="JAX reference package",
            platform=jax.devices()[0].platform,
            jax_version=jax.__version__,
        ),
        params=FORMS_PARAMS,
        params_ladder=dict(FORMS_PARAMS, hessian_shift="ladder"),
        forms={k: list(v) for k, v in FORMS_SINGLE.items()},
        solves={},
        solves_ladder={},
    )
    runs = [("solves", name, "params") for name in FORMS_SINGLE]
    runs += [("solves_ladder", name, "params_ladder") for name in FORMS_LADDER]
    with tempfile.TemporaryDirectory() as tmp:
        for kind, name, params in runs:
            spec = FORMS_SINGLE[name]
            case = forms_case(spec, tmp)
            nlp = getattr(acopf, f"acopf_{spec[0]}")(case, scenario_batchable=False)
            t1 = time.time()
            rec = result_record(sqp.optimize(nlp, sqp.Parameters(**record[params])))
            rec["seconds_with_compile"] = round(time.time() - t1, 1)
            rec.update(n=nlp.n, m=nlp.m, num_linear=nlp.num_linear)
            record[kind][name] = rec
            print(f"[{time.time() - t0:7.1f}s] {kind} {name}: {rec['status']} "
                  f"{rec['obj']:.10g} in {rec['iterations']}", file=sys.stderr, flush=True)
    with open(out_path, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")


#: ``--block-sharded``: ``tests/test_block_sharding.py``'s ``PARAMS`` and problem
BLOCK_SHARDED_PARAMS = dict(_ACOPF_TOL, max_iter=100, use_soc=True, kkt_structured=True,
                            hessian_shift="power", kkt_parts=8)
BLOCK_SHARDED = dict(case="case9", K=4, seed=5, spread=0.02, devices=8)
#: ``--multiprocess``: ``tests/test_multiprocess.py``'s fleet and parameters
MULTIPROCESS_PARAMS = dict(_ACOPF_TOL, max_iter=40, init_projection="off")
MULTIPROCESS = dict(case="case9", batch=4, seed=7, spread=0.03, devices=4)


#: ``--plane --single``: the one-lane plane solves and the batch of four
PLANE_SINGLE = {
    "case30": dict(_ACOPF_TOL, kkt_precision="mixed_plane", hessian_shift="power",
                   max_iter=100, use_soc=True),
    "hs071_ls": dict(algorithm="SQP-LS", kkt_precision="mixed_plane", max_iter=500,
                     OutputFlag=0),
    "structured_case9": dict(_ACOPF_TOL, max_iter=60, kkt_structured=True,
                             kkt_precision="mixed_plane", hessian_shift="ladder"),
}
PLANE_BATCH = dict(case="case30", batch=4, seed=7, spread=0.03,
                   params=dict(PARAMS, kkt_precision="mixed_plane"))


def _plane_problem(name: str):
    from sqpsolver_tpu.models.acopf import acopf_polar
    from sqpsolver_tpu.models.hs import hs_problem
    from sqpsolver_tpu.models.matpower import load_case
    from sqpsolver_tpu.models.power import case9

    if name == "case30":
        return acopf_polar(load_case("case30"), scenario_batchable=False)
    if name == "hs071_ls":
        return hs_problem("hs071").nlp
    return acopf_polar(case9(), scenario_batchable=False)


def run_plane_single(out_path: str) -> None:
    """``--plane --single``: the float32 matrix plane's whole-solve anchors."""
    import jax
    import jax.numpy as jnp

    import sqpsolver_tpu as sqp
    from sqpsolver_tpu.models.acopf import acopf_polar, load_scenarios
    from sqpsolver_tpu.models.matpower import load_case
    from sqpsolver_tpu.parallel.batch import batch_data, make_batch_solver

    t0 = time.time()
    record = dict(reference=_reference(), params=PLANE_SINGLE, solves={}, batch=PLANE_BATCH)
    for name, kw in PLANE_SINGLE.items():
        t1 = time.time()
        rec = result_record(sqp.optimize(_plane_problem(name), sqp.Parameters(**kw)))
        rec["seconds_with_compile"] = round(time.time() - t1, 1)
        record["solves"][name] = rec
        print(f"[{time.time() - t0:7.1f}s] {name}: {rec['status']} {rec['obj']!r} in "
              f"{rec['iterations']} ({rec['qp_iters_total']} QP trips)", file=sys.stderr, flush=True)
    cfg = PLANE_BATCH
    case = load_case(cfg["case"])
    theta = load_scenarios(case, cfg["batch"], seed=cfg["seed"], spread=cfg["spread"])
    for key, backend in (("batch_lanes", cfg["params"]["kkt_backend"]), ("batch_lanes_xla", "xla")):
        t1 = time.time()
        params = sqp.Parameters(**dict(cfg["params"], kkt_backend=backend))
        out = make_batch_solver(acopf_polar(case), params)(
            batch_data(acopf_polar(case), cfg["batch"], theta=theta, dtype=jnp.float64))
        jax.block_until_ready(out.x)
        record[key] = dict(lanes_of(out), seconds_with_compile=round(time.time() - t1, 1))
        print(f"[{time.time() - t0:7.1f}s] {cfg['case']} b{cfg['batch']} ({backend}): "
              f"{json.dumps(record[key])}", file=sys.stderr, flush=True)
    with open(out_path, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")


def _reference() -> dict:
    import jax

    return dict(package="JAX reference package", platform=jax.devices()[0].platform,
                jax_version=jax.__version__, devices=len(jax.devices()))


def run_block_sharded(out_path: str) -> None:
    """``--block-sharded``: the coupled case9 problem, block-sharded over the
    fake 8-device mesh and unsharded."""
    import sqpsolver_tpu as sqp
    from sqpsolver_tpu.models.acopf import acopf_polar, load_scenarios
    from sqpsolver_tpu.models.power import case9
    from sqpsolver_tpu.models.stochastic import couple_scenarios, pg_shared_mask
    from sqpsolver_tpu.parallel import sharding as shd
    from sqpsolver_tpu.results import from_raw

    case = case9()
    nlp = acopf_polar(case)
    thetas = load_scenarios(case, BLOCK_SHARDED["K"], seed=BLOCK_SHARDED["seed"],
                            spread=BLOCK_SHARDED["spread"])
    coupled = couple_scenarios(nlp, thetas, pg_shared_mask(case, nlp))
    params = sqp.Parameters(**BLOCK_SHARDED_PARAMS)
    mesh = shd.instance_mesh(axis="block")
    assert mesh.devices.size == BLOCK_SHARDED["devices"], mesh.devices.size
    record = dict(reference=_reference(), params=BLOCK_SHARDED_PARAMS, coupled=BLOCK_SHARDED,
                  n=coupled.n, m=coupled.m, solves={})
    t0 = time.time()
    solvers = dict(block_sharded=shd.make_block_sharded_solver(coupled, params, mesh),
                   unsharded=sqp.make_solver(coupled, params))
    for name, solver in solvers.items():
        t1 = time.time()
        rec = result_record(from_raw(solver(coupled.data()), 0.0))
        rec["seconds_with_compile"] = round(time.time() - t1, 1)
        record["solves"][name] = rec
        print(f"[{time.time() - t0:7.1f}s] {name}: {rec['status']} {rec['obj']!r} in "
              f"{rec['iterations']} ({rec['qp_iters_total']} QP trips)", file=sys.stderr, flush=True)
    with open(out_path, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")


def run_multiprocess(out_path: str) -> None:
    """``--multiprocess``: the two-process test's global case9 batch of 4,
    one lane a device of a fake 4-device mesh."""
    import jax
    import jax.numpy as jnp

    import sqpsolver_tpu as sqp
    from sqpsolver_tpu.models.acopf import acopf_polar, load_scenarios
    from sqpsolver_tpu.models.power import case9
    from sqpsolver_tpu.parallel import sharding as shd
    from sqpsolver_tpu.parallel.batch import batch_data

    case = case9()
    nlp = acopf_polar(case)
    cfg = MULTIPROCESS
    theta = load_scenarios(case, cfg["batch"], seed=cfg["seed"], spread=cfg["spread"])
    mesh = shd.instance_mesh(jax.devices()[:cfg["devices"]])
    data = shd.shard_data(batch_data(nlp, cfg["batch"], theta=theta, dtype=jnp.float64), mesh)
    t0 = time.time()
    out = shd.make_sharded_solver(nlp, sqp.Parameters(**MULTIPROCESS_PARAMS), mesh)(data)
    jax.block_until_ready(out.x)
    record = dict(reference=dict(_reference(), seconds_with_compile=round(time.time() - t0, 1)),
                  params=MULTIPROCESS_PARAMS, **cfg, lanes=lanes_of(out))
    with open(out_path, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")
    print(json.dumps(record["lanes"]))


def _worker_init() -> None:
    sys.path.insert(0, ROOT)
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_enable_x64", True)


def _solve_one(task) -> dict:
    """One single-NLP solve through the JAX package's ``optimize``."""
    import sqpsolver_tpu as sqp

    kind, name, kw = task
    nlp = _drive_problem(name) if kind == "drives" else _hs_problems()[name]
    return result_record(sqp.optimize(nlp, sqp.Parameters(**kw)))


#: ``--replicated``: ``scripts/pegase_solve.py``'s parameters (``max_iter`` 40
#: there; float64 ``direct`` factors, ``qp_rescue`` on: the defaults)
PEGASE_PARAMS = dict(_ACOPF_TOL, max_iter=40, use_soc=True, kkt_structured=True,
                     hessian_shift="ladder", init_projection="off")
#: ``tests/test_structured.py::test_structured_case30x10_300bus``'s parameters
#: (the presolve runs them dense, the solve adds ``kkt_structured``)
CASE30X10_PARAMS = dict(_ACOPF_TOL, max_iter=200, use_soc=True)
#: the structured bench configuration (``bench.py`` with
#: ``SQP_BENCH_STRUCTURED=1``; the kernel backend): ``chip_smoke.py``'s kernel
#: path on case118x12
BENCH_STRUCTURED_PARAMS = dict(PARAMS, max_iter=100, kkt_structured=True)
#: the small network of the CPU test, and its second configuration: the
#: structured bench's on the library route
SMALL = dict(case="case9", k=3)
SMALL_MIXED_PARAMS = dict(BENCH_STRUCTURED_PARAMS, kkt_backend="xla")
#: the piece names of ``--replicated --only``
REPLICATED_PIECES = ("structure", "small", "case30x10", "case30x10_ladder",
                     "case30x10_presolve1", "case118x4", "case118x12_iter2")


def replicated_case(base: str, k: int):
    """``k`` interconnected copies of ``base``, by the JAX package."""
    from sqpsolver_tpu.models.matpower import load_case
    from sqpsolver_tpu.models.power import case9, replicate_case

    return replicate_case(case9() if base == "case9" else load_case(base), k)


def structure_summary(nlp, bs, cap: int) -> dict:
    """What the port's block structure must equal: sizes, the stiff cap and
    Schur size, and SHA-256 hashes of the assignment and colorings."""
    import hashlib

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(np.asarray(a, dtype=np.int64)).tobytes()).hexdigest()

    return dict(n=int(nlp.n), m=int(nlp.m), P=int(bs.P), nd=int(bs.nd), ns=int(bs.ns),
                mr=int(bs.mr), mre=int(bs.mre), cap_p=int(cap), nS=int(bs.P * cap),
                nJ=int(np.max(bs.colorJ)) + 1, nH=int(np.max(bs.colorH)) + 1,
                var_part=digest(bs.var_part), var_slot=digest(bs.var_slot),
                sep_idx=digest(bs.sep_idx), colorJ=digest(bs.colorJ),
                colorH=digest(bs.colorH))


def run_replicated(out_path: str, only: list[str]) -> None:
    """``--replicated``: the pegase-scale anchors, merged piece by piece."""
    import sqpsolver_tpu as sqp
    from sqpsolver_tpu import results as _results
    from sqpsolver_tpu.models.acopf import acopf_polar
    from sqpsolver_tpu.ops.kkt_bbd import part_schur_cap
    from sqpsolver_tpu.structure import build_block_structure
    from sqpsolver_tpu.utils.warmstart import presolve_start

    record = dict(reference=_reference(), pegase_params=PEGASE_PARAMS,
                  bench_params=BENCH_STRUCTURED_PARAMS,
                  case30x10_params=CASE30X10_PARAMS, small=SMALL,
                  small_mixed_params=SMALL_MIXED_PARAMS)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:7.1f}s] {msg}", file=sys.stderr, flush=True)

    def save():
        # merged into the file as it is now, so that pieces run by
        # separate processes keep each other's results
        merged = {}
        if os.path.exists(out_path):
            with open(out_path) as fh:
                merged = json.load(fh)
        merged.update(record)
        with open(out_path, "w") as fh:
            json.dump(merged, fh, indent=1)
            fh.write("\n")

    def solve(nlp, kw):
        t1 = time.time()
        rec = result_record(sqp.optimize(nlp, sqp.Parameters(**kw)))
        rec["seconds_with_compile"] = round(time.time() - t1, 1)
        return rec

    def nlp_of(base, k):
        return acopf_polar(replicated_case(base, k), scenario_batchable=False)

    for piece in only:
        if piece == "structure":
            summ = {}
            for k in (4, 12, 24):
                nlp = nlp_of("case118", k)
                g_l, g_u = np.asarray(nlp.g_l), np.asarray(nlp.g_u)
                t1 = time.time()
                bs = build_block_structure(nlp.n, nlp.m, nlp.structure,
                                           np.isfinite(g_l) & (g_l == g_u))
                summ[f"case118x{k}"] = dict(structure_summary(nlp, bs, part_schur_cap(bs)),
                                            seconds=round(time.time() - t1, 3))
            record["structure"] = summ
        elif piece == "small":
            nlp = nlp_of(SMALL["case"], SMALL["k"])
            record["small_solves"] = dict(pegase=solve(nlp, PEGASE_PARAMS),
                                          mixed=solve(nlp, SMALL_MIXED_PARAMS))
        elif piece in ("case30x10", "case30x10_ladder"):
            # the test's flow, and the same with the float64 ladder shift:
            # the default shift's float32 eigenvalue estimate rounds
            # differently in another LAPACK, and the loose presolve stops
            # at another point
            nlp = nlp_of("case30", 10)
            params = sqp.Parameters(**CASE30X10_PARAMS)
            if piece == "case30x10_ladder":
                params = params.replace(hessian_shift="ladder")
            t1 = time.time()
            warm = presolve_start(nlp, params)
            solver = sqp.make_solver(nlp, params.replace(kkt_structured=True))
            rec = result_record(_results.from_raw(solver(warm), 0.0))
            rec["seconds_with_compile"] = round(time.time() - t1, 1)
            record[piece] = rec
        elif piece == "case30x10_presolve1":
            # the test's presolve stopped after one SQP iteration: the point
            # where the two packages still agree under the default shift
            nlp = nlp_of("case30", 10)
            t1 = time.time()
            warm = presolve_start(nlp, sqp.Parameters(**CASE30X10_PARAMS), max_iter=1)
            record[piece] = dict(x=[float(v) for v in np.asarray(warm.x0)],
                                 lam=[float(v) for v in np.asarray(warm.lam0)],
                                 seconds_with_compile=round(time.time() - t1, 1))
        elif piece == "case118x4":
            record["case118x4"] = solve(nlp_of("case118", 4), PEGASE_PARAMS)
        elif piece == "case118x12_iter2":
            record["case118x12_iter2"] = solve(nlp_of("case118", 12),
                                               dict(PEGASE_PARAMS, max_iter=2))
        else:
            raise SystemExit(f"--only: unknown piece {piece!r}; one of {REPLICATED_PIECES}")
        log(f"{piece} done")
        save()


#: ``--tests``: the piece names, and the configurations the tests take from
#: the file
TESTS_PIECES = ("ls_case9_b4", "chunked_hs071_b3", "toy_sharded_b16", "slice_case5_b4")
LS_CASE9 = dict(batch=4, seed=11, spread=0.05,
                params=dict(_ACOPF_TOL, algorithm="SQP-LS", max_iter=100))
CHUNKED_HS071 = dict(batch=3, step=1.0e-3, params=dict(
    mixed_ir_rescue=dict(max_iter=200, OutputFlag=0, qp_rescue=True, kkt_precision="mixed_ir"),
    mixed_polish=dict(max_iter=200, OutputFlag=0, qp_rescue=False, kkt_precision="mixed_polish",
                      tol_infeas=1e-8, tol_residual=1e-8, qp_tol=1e-8)))
TOY_SHARDED = dict(batch=16, seed=11, devices=8, params=dict(max_iter=200, OutputFlag=0))
SLICE_CASE5 = dict(batch=4, seed=7, spread=0.03, params=PARAMS)


def run_tests(out_path: str, only: list[str]) -> None:
    """``--tests``: the JAX halves of the port's CPU tests, merged piece by piece."""
    import jax
    import jax.numpy as jnp

    import sqpsolver_tpu as sqp
    from sqpsolver_tpu.algorithms.sqp_ls import make_ls_solver
    from sqpsolver_tpu.models.acopf import acopf_polar
    from sqpsolver_tpu.models.matpower import load_case
    from sqpsolver_tpu.models.power import case9
    from sqpsolver_tpu.models.toy import toy_nlp
    from sqpsolver_tpu.nlp import build_nlp
    from sqpsolver_tpu.parallel import batch, sharding

    import sqpsolver_tpu_torch.models.acopf as t_acopf
    import sqpsolver_tpu_torch.models.matpower as t_matpower
    import sqpsolver_tpu_torch.models.power as t_power

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import hs071_problem  # the test's hs071, written out for both packages

    assert len(jax.devices()) == TOY_SHARDED["devices"], jax.devices()
    record = {}
    t0 = time.time()

    def lane_records(out, lanes):
        recs = []
        for k in range(lanes):
            res = sqp.from_raw(jax.tree.map(lambda a: a[k], out), 0.0)
            recs.append(dict(result_record(res), success=bool(res.success)))
        return recs

    for piece in only:
        t1 = time.time()
        if piece == "ls_case9_b4":
            cfg = LS_CASE9
            nlp = acopf_polar(case9())
            theta = t_acopf.load_scenarios(t_power.case9(), cfg["batch"], seed=cfg["seed"],
                                           spread=cfg["spread"])
            solve = make_ls_solver(nlp, sqp.Parameters(**cfg["params"]), verbose=False)._raw
            out = jax.jit(jax.vmap(solve))(batch.batch_data(nlp, cfg["batch"], theta=theta))
            record[piece] = dict(cfg, lanes=lane_records(out, cfg["batch"]))
        elif piece == "chunked_hs071_b3":
            cfg = CHUNKED_HS071
            nlp = hs071_problem.hs071(build_nlp, jnp)
            x0 = hs071_problem.starts(cfg["step"])[:cfg["batch"]]
            runs = {}
            for name, kw in cfg["params"].items():
                out = batch.make_batch_solver(nlp, sqp.Parameters(**kw))(
                    batch.batch_data(nlp, cfg["batch"], x0=x0))
                runs[name] = lanes_of(out) | dict(x=np.asarray(out.x).tolist())
            record[piece] = dict(cfg, runs=runs)
        elif piece == "toy_sharded_b16":
            cfg = TOY_SHARDED
            x0 = np.random.default_rng(cfg["seed"]).uniform(-0.5, 0.5, (cfg["batch"], 2))
            mesh = sharding.instance_mesh(jax.devices()[:cfg["devices"]])
            nlp = toy_nlp()
            data = sharding.shard_data(batch.batch_data(nlp, cfg["batch"], x0=x0), mesh)
            out = sharding.make_sharded_solver(nlp, sqp.Parameters(**cfg["params"]), mesh)(data)
            record[piece] = dict(cfg, x0=x0.tolist(),
                                 lanes=lanes_of(out) | dict(x=np.asarray(out.x).tolist()))
        elif piece == "slice_case5_b4":
            cfg = SLICE_CASE5
            theta = t_acopf.load_scenarios(t_matpower.load_case("case5"), cfg["batch"],
                                           seed=cfg["seed"], spread=cfg["spread"])
            nlp = acopf_polar(load_case("case5"))
            out = batch.make_batch_solver(nlp, sqp.Parameters(**cfg["params"]))(
                batch.batch_data(nlp, cfg["batch"], theta=theta, dtype=jnp.float64))
            record[piece] = dict(cfg, lanes=lanes_of(out))
        else:
            raise SystemExit(f"--only: unknown piece {piece!r}; one of {TESTS_PIECES}")
        record[piece]["seconds_with_compile"] = round(time.time() - t1, 1)
        print(f"[{time.time() - t0:7.1f}s] {piece} done", file=sys.stderr, flush=True)
    merged = {}
    if os.path.exists(out_path):
        with open(out_path) as fh:
            merged = json.load(fh)
    with open(out_path, "w") as fh:
        json.dump(merged | dict(reference=_reference()) | record, fh, indent=1)
        fh.write("\n")


def run_hs(out_path: str) -> None:
    """``--hs``: the single-NLP anchors (see the module docstring).  Each
    solve compiles its own program; XLA:CPU runs out of code memory after
    some 80 of them in one process, so the solves run in worker processes of
    20 solves each."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import jax

    t0 = time.time()
    tasks = [(alg, name, kw) for alg, kw in HS_PARAMS.items() for name in _hs_problems()]
    tasks += [("drives", name, kw) for name, kw in DRIVE_PARAMS.items()]
    record = dict(
        reference=dict(
            package="JAX reference package",
            platform=jax.devices()[0].platform,
            jax_version=jax.__version__,
        ),
        params=dict(HS_PARAMS, drives=DRIVE_PARAMS),
        **{kind: {} for kind in list(HS_PARAMS) + ["drives"]},
    )
    for start in range(0, len(tasks), 20):
        part = tasks[start:start + 20]
        with ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init,
        ) as pool:
            for (kind, name, _), rec in zip(part, pool.map(_solve_one, part)):
                record[kind][name] = rec
                print(f"[{time.time() - t0:7.1f}s] {kind} {name}: {rec['status']} "
                      f"{rec['obj']:.10g} in {rec['iterations']}", file=sys.stderr, flush=True)
    record["reference"]["seconds_with_compile"] = round(time.time() - t0, 1)
    with open(out_path, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")
    print(f"{len(tasks)} solves in {time.time() - t0:.1f}s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", default=None, choices=sorted(CHUNKED),
                    help="case30 (default), or case118 (default with --structured)")
    ap.add_argument("--batch", type=int, default=None,
                    help="32 for case30, 16 for case118 (default)")
    ap.add_argument("--algorithm", default="SQP-TR", choices=["SQP-TR", "SQP-LS"])
    ap.add_argument("--hs", action="store_true",
                    help="write the single-NLP anchors (anchor_hs.json) instead")
    ap.add_argument("--structured", action="store_true",
                    help="the block-structured (BBD) KKT path (reference on xla)")
    ap.add_argument("--single", action="store_true",
                    help="with --structured: the one-lane structured anchors")
    ap.add_argument("--form", default="polar", choices=["polar", "rect", "ivr", "wr"],
                    help="the ACOPF formulation of a batched anchor (default polar)")
    ap.add_argument("--forms-single", action="store_true",
                    help="write the one-lane anchors of the other formulations "
                         "(anchor_forms_single.json) instead")
    ap.add_argument("--block-sharded", action="store_true",
                    help="write the block-sharded coupled case9 anchor "
                         "(anchor_block_sharded_case9.json) instead")
    ap.add_argument("--multiprocess", action="store_true",
                    help="write the two-process case9 b4 anchor "
                         "(anchor_multiprocess_case9_b4.json) instead")
    ap.add_argument("--plane", action="store_true",
                    help="the float32 matrix plane (kkt_precision='mixed_plane'); with "
                         "--single the one-lane anchors (anchor_plane_single.json)")
    ap.add_argument("--replicated", action="store_true",
                    help="write the pegase-scale replicated-network anchors "
                         "(anchor_replicated.json) instead")
    ap.add_argument("--tests", action="store_true",
                    help="write the JAX halves of the port's CPU tests "
                         "(anchor_tests.json) instead")
    ap.add_argument("--only", default=None,
                    help="with --replicated or --tests: comma-separated pieces to run and "
                         f"merge (default all: {','.join(REPLICATED_PIECES)}; "
                         f"{','.join(TESTS_PIECES)})")
    ap.add_argument("--backend", default="pallas", choices=["pallas", "xla"])
    ap.add_argument("--max-iter", type=int, default=None,
                    help=f"default {PARAMS['max_iter']}; 100 for structured case118")
    ap.add_argument("--one-thread", action="store_true",
                    help="run a batched reference again on one core and add its lanes to "
                         "the existing anchor file as 'one_thread' (see ONE_THREAD_NOTE)")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    ls = "ls_" if args.algorithm == "SQP-LS" else ""
    args.case = args.case or ("case118" if args.structured else "case30")
    args.batch = args.batch or (16 if args.case == "case118" else 32)
    if args.max_iter is None:
        args.max_iter = 100 if (args.structured and args.case == "case118") else PARAMS["max_iter"]
    if args.structured:
        # the structured reference runs the library backend, as the dense
        # case118 one does (see XLA_NOTE)
        args.backend = "xla"
        ls = "structured_"
    if args.plane:
        ls = "plane_"
    form = "" if args.form == "polar" else f"{args.form}_"
    name = f"anchor_{ls}{form}{args.case}_b{args.batch}.json"
    if args.forms_single:
        name = "anchor_forms_single.json"
    elif args.block_sharded:
        name = "anchor_block_sharded_case9.json"
    elif args.multiprocess:
        name = "anchor_multiprocess_case9_b4.json"
    elif args.hs:
        name = "anchor_hs.json"
    elif args.replicated:
        name = "anchor_replicated.json"
    elif args.tests:
        name = "anchor_tests.json"
    elif args.single:
        name = "anchor_plane_single.json" if args.plane else "anchor_structured_single.json"
    out_path = args.out or os.path.join(DATA, name)

    sys.path.insert(0, ROOT)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if args.one_thread:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
        ).strip()
        os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
    if args.block_sharded or args.multiprocess or args.tests:
        # the fake CPU mesh of the JAX package's tests (tests/conftest.py)
        devices = (BLOCK_SHARDED if args.block_sharded else MULTIPROCESS if args.multiprocess
                   else TOY_SHARDED)["devices"]
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={devices}"
        ).strip()
    import jax

    jax.config.update("jax_enable_x64", True)
    if args.hs:
        run_hs(out_path)
        return
    if args.replicated:
        run_replicated(out_path, args.only.split(",") if args.only else list(REPLICATED_PIECES))
        return
    if args.tests:
        run_tests(out_path, args.only.split(",") if args.only else list(TESTS_PIECES))
        return
    if args.single:
        (run_plane_single if args.plane else run_structured_single)(out_path)
        return
    if args.forms_single:
        run_forms_single(out_path)
        return
    if args.block_sharded:
        run_block_sharded(out_path)
        return
    if args.multiprocess:
        run_multiprocess(out_path)
        return
    if args.algorithm == "SQP-LS" and CHUNKED[args.case]:
        raise SystemExit("--algorithm SQP-LS drives the monolithic case30 path only")
    if args.cache_dir:
        jax.config.update("jax_compilation_cache_dir", args.cache_dir)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    import jax.numpy as jnp

    from sqpsolver_tpu.models import acopf
    from sqpsolver_tpu.models.acopf import load_scenarios
    from sqpsolver_tpu.models.matpower import load_case
    from sqpsolver_tpu.parallel.batch import (
        batch_data,
        make_batch_solver,
        make_chunked_batch_solver,
        summarize_batch,
    )
    from sqpsolver_tpu.parameters import Parameters
    from sqpsolver_tpu.status import Status

    config = dict(
        **({} if args.form == "polar" else {"form": args.form}),
        case=args.case,
        batch=args.batch,
        seed=7,
        spread=0.03,
        params=dict(PARAMS, max_iter=args.max_iter, algorithm=args.algorithm,
                    kkt_structured=args.structured,
                    **({"kkt_precision": "mixed_plane"} if args.plane else {})),
    )
    chunked = (CHUNKED_STRUCTURED if args.structured else CHUNKED)[args.case]
    if chunked:
        config["chunked"] = chunked
    case = load_case(config["case"])
    nlp = getattr(acopf, f"acopf_{args.form}")(case)
    # the file's ``params`` are the path's own (the kernel backend); the
    # reference may run the library backend instead, and says so
    params = Parameters(**dict(config["params"], kkt_backend=args.backend))
    theta = load_scenarios(
        case, config["batch"], seed=config["seed"], spread=config["spread"]
    )
    data = batch_data(nlp, config["batch"], theta=theta, dtype=jnp.float64)

    def log(msg: str) -> None:
        print(f"[{time.time() - t0:7.1f}s] {msg}", file=sys.stderr, flush=True)

    t0 = time.time()
    extra = {}
    if args.one_thread:
        out = (make_chunked_batch_solver(nlp, params, log=log, **chunked) if chunked
               else make_batch_solver(nlp, params))(data)
        jax.block_until_ready(out.x)
        with open(out_path) as fh:
            record = json.load(fh)
        record["one_thread"] = dict(
            lanes_of(out), seconds_with_compile=round(time.time() - t0, 1),
            note=ONE_THREAD_NOTE,
        )
        with open(out_path, "w") as fh:
            json.dump(record, fh, indent=1)
            fh.write("\n")
        print(json.dumps(record["one_thread"]["obj"]))
        return
    if chunked:
        first = make_chunked_batch_solver(
            nlp, params, sub_batch=chunked["sub_batch"], log=log
        )(data)
        jax.block_until_ready(first.x)
        failed = np.asarray(first.status) == int(
            Status.ERROR_IN_STEP_COMPUTATION
        )
        extra["first_pass"] = dict(
            lanes_of(first),
            seconds_with_compile=round(time.time() - t0, 1),
        )
        extra["fallback_lanes"] = np.where(failed)[0].astype(int).tolist()
        log(f"first pass done; fallback lanes {extra['fallback_lanes']}")
        if failed.any():
            out = make_chunked_batch_solver(nlp, params, log=log, **chunked)(data)
        else:  # no lane falls back: the full solve is the first pass
            out = first
    elif args.algorithm == "SQP-LS":
        from sqpsolver_tpu.algorithms.sqp_ls import make_ls_solver

        out = jax.jit(jax.vmap(make_ls_solver(nlp, params, verbose=False)._raw))(data)
    else:
        out = make_batch_solver(nlp, params)(data)
    jax.block_until_ready(out.x)
    seconds = time.time() - t0
    summ = summarize_batch(out)
    record = dict(
        config,
        reference=dict(
            package="JAX reference package",
            platform=jax.devices()[0].platform,
            jax_version=jax.__version__,
            kkt_backend=params.kkt_backend,
            seconds_with_compile=round(seconds, 1),
            **({"note": XLA_NOTE} if args.backend == "xla" else {}),
        ),
        lanes=lanes_of(out),
        **extra,
        totals=dict(
            iterations=int(np.asarray(out.iterations).sum()),
            qp_trips=summ["qp_trips"],
            n_reject=summ["n_reject"],
            n_success=summ["n_success"],
            obj_mean=summ["obj_mean"],
            prim_infeas_max=summ["prim_infeas_max"],
        ),
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")
    print(json.dumps(record["totals"]), f"{seconds:.1f}s")


if __name__ == "__main__":
    main()
