"""Pegase-scale replicated networks in the port against the JAX package.

* ``replicate_case``: case118 x4, x12 and x24 (472 to 2,832 buses) build
  arrays EQUAL to the JAX package's.
* The block structure: every ``BlockStructure`` array equal to the JAX
  package's, live, on three copies of case9; and the port's partition of
  case118 x4, x12 and x24 equal to the JAX summaries in
  ``data/anchor_replicated.json`` (P, nd, ns, the per-part stiff cap and the
  stiff Schur size nS, the coloring widths, and SHA-256 hashes of the part
  assignment, slots, separator and colorings).  x12's nS is the
  ``chip_smoke.PEGASE_NS`` that phases 3-4 time.
* Three copies of case9 solved in one lane through the structured path on
  the CPU: under ``scripts/pegase_solve.py``'s parameters (float64
  ``direct``, ``ladder``, SOC) status and iterations equal to JAX's and the
  objective within 1e-9 relative (float64 throughout); under the structured
  bench configuration (``mixed_ir``, float32 factors, JAX on its ``xla``
  route) status equal, objective within 1e-6 relative (the solve's
  ``tol_infeas``) and iterations within two (float32 rounding moves the
  stopping iteration).
* The panel matvecs of the structured operator: a (B, n, k) panel through
  ``h_mv`` / ``j_mv`` / ``j_rmv`` equals the k columns taken one at a time
  to 1e-12 (they round differently), and both small solves above with every
  K panel applied that way (the fault they repair: mapping the vector
  matvec over 11,016 columns with ``torch.func.vmap`` asked the H100 for
  95.7 GiB at case118x12).
* ``tests/test_structured.py``'s 300-bus flow (ten copies of case30) where
  the two packages still agree: its presolve's first iterate, x0 and lam0
  within 1e-8 of JAX's.
* ``chip_smoke.py`` phase 19's gates on numbers that pass and numbers that
  fail, each tolerance stated there.

The JAX results come from ``data/anchor_replicated.json``
(``scripts/torch_anchor.py --replicated``, JAX on the CPU), not from JAX
solves run here.
"""

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu import structure as j_structure
from sqpsolver_tpu.models import acopf as j_acopf
from sqpsolver_tpu.models import matpower as j_matpower
from sqpsolver_tpu.models import power as j_power
from sqpsolver_tpu.ops.kkt_bbd import part_schur_cap as j_part_schur_cap
from sqpsolver_tpu_torch import structure as t_structure
from sqpsolver_tpu_torch.models import acopf as t_acopf
from sqpsolver_tpu_torch.models import matpower as t_matpower
from sqpsolver_tpu_torch.models import power as t_power
from sqpsolver_tpu_torch.ops.kkt_bbd import BlockMaps, HessBlocks, JacBlocks, part_schur_cap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

with open(os.path.join(ROOT, "sqpsolver_tpu_torch", "data", "anchor_replicated.json")) as fh:
    ANCHOR = json.load(fh)


def _eq_mask(nlp):
    g_l, g_u = np.asarray(nlp.g_l, dtype=np.float64), np.asarray(nlp.g_u, dtype=np.float64)
    return np.isfinite(g_l) & (g_l == g_u)


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a, dtype=np.int64)).tobytes()).hexdigest()


@pytest.mark.parametrize("k", [4, 12, 24])
def test_replicated_case118_equals_jax(k):
    t = t_power.replicate_case(t_matpower.load_case("case118"), k)
    j = j_power.replicate_case(j_matpower.load_case("case118"), k)
    assert t.nb == j.nb == 118 * k
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(np.asarray(a), b), f.name
            assert np.asarray(a).dtype == b.dtype, f.name
        else:
            assert a == b, f.name


def test_small_block_structure_equals_jax():
    """Three copies of case9: every array of the block structure, live."""
    t_nlp = t_acopf.acopf_polar(t_power.replicate_case(t_power.case9(), 3), scenario_batchable=False)
    j_nlp = j_acopf.acopf_polar(j_power.replicate_case(j_power.case9(), 3), scenario_batchable=False)
    t_bs = t_structure.build_block_structure(t_nlp.n, t_nlp.m, t_nlp.structure, _eq_mask(t_nlp))
    j_bs = j_structure.build_block_structure(j_nlp.n, j_nlp.m, j_nlp.structure, _eq_mask(j_nlp))
    assert t_bs.P == j_bs.P >= 2
    for f in dataclasses.fields(j_bs):
        a, b = getattr(t_bs, f.name), getattr(j_bs, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(np.asarray(a), b), f.name
        else:
            assert a == b, f.name
    assert part_schur_cap(t_bs) == j_part_schur_cap(j_bs)


@pytest.mark.parametrize("k", [4, 12, 24])
def test_replicated_partition_equals_jax_anchor(k):
    want = ANCHOR["structure"][f"case118x{k}"]
    _, nlp = cs.replicated_nlp("case118", k)
    bs = t_structure.build_block_structure(nlp.n, nlp.m, nlp.structure, _eq_mask(nlp))
    cap = part_schur_cap(bs)
    got = dict(n=nlp.n, m=nlp.m, P=bs.P, nd=bs.nd, ns=bs.ns, mr=bs.mr, mre=bs.mre, cap_p=cap,
               nS=bs.P * cap, nJ=int(bs.colorJ.max()) + 1, nH=int(bs.colorH.max()) + 1)
    for key, val in got.items():
        assert val == want[key], key
    for key in ("var_part", "var_slot", "sep_idx", "colorJ", "colorH"):
        assert _digest(getattr(bs, key)) == want[key], key
    part, _ = cs.block_partition(nlp)
    json.dumps(part)  # the summary goes into torch_pegase_solve.py's --out record
    assert {key: part[key] for key in ("P", "nd", "ns", "cap_p", "nS", "nJ", "nH")} == {
        key: want[key] for key in ("P", "nd", "ns", "cap_p", "nS", "nJ", "nH")}
    if k == cs.PEGASE_K:
        assert want["nS"] == cs.PEGASE_NS
        assert cs.panel_launches(want["nS"]) == 87
        assert cs.PEGASE_PANELS == ((1, 128), (1, want["nS"] - 86 * 128))


@pytest.mark.parametrize("config", ["pegase", "mixed"])
def test_small_replicated_solve_matches_jax(config):
    want = ANCHOR["small_solves"][config]
    kw = ANCHOR["pegase_params"] if config == "pegase" else ANCHOR["small_mixed_params"]
    _, nlp = cs.replicated_nlp(ANCHOR["small"]["case"], ANCHOR["small"]["k"])
    res = tp.optimize(nlp, tp.Parameters(**kw), device="cpu")
    assert int(res.status) == want["status"] == 0
    rel = abs(res.obj_val - want["obj"]) / abs(want["obj"])
    if config == "pegase":
        assert rel <= 1e-9, rel
        assert res.iterations == want["iterations"]
    else:
        assert rel <= 1e-6, rel
        assert abs(res.iterations - want["iterations"]) <= 2
    assert res.prim_infeas <= cs.PRIM_TOL


def test_case30x10_presolve_first_iterate_matches_jax():
    """``tests/test_structured.py``'s 300-bus flow where the two packages
    still agree: its presolve (the default ``eigh`` shift) stopped after one
    SQP iteration, x0 and lam0 within ``chip_smoke.PRESOLVE_RTOL`` (1e-8,
    max|d| / max|ref|) of JAX's."""
    from sqpsolver_tpu_torch.utils.warmstart import presolve_start

    _, nlp = cs.replicated_nlp("case30", 10)
    first = presolve_start(nlp, tp.Parameters(**ANCHOR["case30x10_params"]), device="cpu",
                           max_iter=1)
    bad, gaps = cs.presolve_failures("presolve", first.x0[0].numpy(), first.lam0[0].numpy(),
                                     ANCHOR["case30x10_presolve1"])
    assert bad == [], gaps


@pytest.mark.parametrize("config", ["pegase", "mixed"])
def test_small_replicated_solve_through_panel_products(monkeypatch, config):
    """Both small solves again with every K panel applied as block products
    (the branch case118x12 takes).  Under the pegase parameters (float64
    throughout) status and iterations equal to JAX's, objective within 1e-9
    relative.  Under ``mixed_ir`` (float32 factors, refined in float64)
    status equal and objective within 1e-6 (the solve's ``tol_infeas``); its
    iteration count is left free: the two forms agree to rounding, and here
    rounding alone sets it in float32 factors (the mapped form takes JAX's
    8, the block products 19)."""
    from sqpsolver_tpu_torch.ops import kkt_bbd

    monkeypatch.setattr(kkt_bbd, "MAPPED_PANEL_ELEMS", 0)
    want = ANCHOR["small_solves"][config]
    kw = ANCHOR["pegase_params"] if config == "pegase" else ANCHOR["small_mixed_params"]
    _, nlp = cs.replicated_nlp(ANCHOR["small"]["case"], ANCHOR["small"]["k"])
    res = tp.optimize(nlp, tp.Parameters(**kw), device="cpu")
    assert int(res.status) == want["status"] == 0
    if config == "pegase":
        assert res.iterations == want["iterations"]
        assert abs(res.obj_val - want["obj"]) <= 1e-9 * abs(want["obj"])
    else:
        assert abs(res.obj_val - want["obj"]) <= 1e-6 * abs(want["obj"])
    assert res.prim_infeas <= cs.PRIM_TOL


def test_panel_matvecs_equal_columns():
    _, nlp = cs.replicated_nlp("case9", 3)
    bs = t_structure.build_block_structure(nlp.n, nlp.m, nlp.structure, _eq_mask(nlp))
    maps = BlockMaps(bs)
    rng = np.random.default_rng(11)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape))

    B, k = 2, 5
    H = HessBlocks(t(B, bs.P, bs.nd, bs.nd), t(B, bs.P, bs.nd, bs.ns), t(B, bs.ns, bs.ns))
    J = JacBlocks(t(B, bs.P, bs.mr, bs.nd), t(B, bs.P, bs.mr, bs.ns))
    X, Y = t(B, bs.n, k), t(B, bs.m, k)
    for f, A in ((lambda v: maps.h_mv(H, v), X), (lambda v: maps.j_mv(J, v), X),
                 (lambda v: maps.j_rmv(J, v), Y)):
        panel = f(A)
        cols = torch.stack([f(A[..., c]) for c in range(k)], dim=-1)
        assert panel.shape == cols.shape
        torch.testing.assert_close(panel, cols, rtol=0, atol=1e-12)


def test_phase19_gates():
    single = 129660.70
    # a solved lane: status 0/1/6 and prim_infeas <= 1e-6
    assert cs.lane_failures("x", 0, 9.9e-7) == []
    assert cs.lane_failures("x", 6, 0.0) == []
    assert cs.lane_failures("x", 0, 1.1e-6)
    assert cs.lane_failures("x", -1, 0.0)
    # the replication band [0.98, 1.001] x k x the single optimum
    assert cs.band_failures("x", 0.9992 * 12 * single, 12, single) == []
    assert cs.band_failures("x", 1.0009 * 12 * single, 12, single) == []
    assert cs.band_failures("x", 1.0011 * 12 * single, 12, single)
    assert cs.band_failures("x", 0.979 * 12 * single, 12, single)
    # agreement of (a) and (b): 1e-6 relative
    assert cs.agree_failures("x", 1.0e6, 1.0e6 * (1 + 9e-7)) == []
    assert cs.agree_failures("x", 1.0e6, 1.0e6 * (1 + 2e-6))
    # a JAX anchor: the same status, objective within 1e-6 relative
    want = dict(status=0, obj=518226.1)
    assert cs.anchor_failures("x", 0, 518226.1 * (1 + 5e-7), want) == []
    assert cs.anchor_failures("x", 0, 518226.1 * (1 + 2e-6), want)
    assert cs.anchor_failures("x", 1, 518226.1, want)
    # the two-iteration iterate: objective 1e-8, max|dx|/max|x| 1e-6
    x = np.linspace(-1.0, 2.0, 7)
    it = dict(obj=1.5e6, x=x.tolist())
    assert cs.iterate_failures("x", 1.5e6 * (1 + 5e-9), x + 1e-6, it) == []
    assert cs.iterate_failures("x", 1.5e6 * (1 + 2e-8), x, it)
    assert cs.iterate_failures("x", 1.5e6, x + 3e-6, it)
    # the presolve's first iterate: x0 and lam0 each within 1e-8 (max|d|/max|ref|)
    pre = dict(x=x.tolist(), lam=(10 * x).tolist())
    assert cs.presolve_failures("x", x + 1e-8, 10 * x, pre)[0] == []
    assert cs.presolve_failures("x", x + 3e-8, 10 * x, pre)[0]
    assert cs.presolve_failures("x", x, 10 * x + 3e-7, pre)[0]
    assert cs.presolve_failures("x", x * np.nan, 10 * x, pre)[0]
    # a bus-sum incidence product: a matrix product with an (nb, ng) or
    # (nb, nl) operand, either way round; not an elementwise op on bus vectors
    assert cs.incidence_product("aten::mm", [[1416, 648], [648, 21]], 1416, (648, 2244))
    assert cs.incidence_product("aten::mm", [[21, 2244], [2244, 1416]], 1416, (648, 2244))
    assert not cs.incidence_product("aten::mul", [[21, 1416], [21, 1416]], 1416, (648, 2244))
    assert not cs.incidence_product("aten::mm", [[21, 1416], [1416, 1416]], 1416, (648, 2244))
    # the kernel path: ceil(nS / 128) launches per factorization, and some
    assert cs.panel_launches(11016) == 87 and cs.panel_launches(896) == 7
    assert cs.launch_failures("x", 87 * 3, 3, 11016) == []
    assert cs.launch_failures("x", 87 * 3 - 1, 3, 11016)
    assert cs.launch_failures("x", 0, 0, 11016)
