"""The port's ``structure.py`` and ``acopf_polar_structure`` against the JAX
package's.

Every ``BlockStructure`` array (partition, padding, colorings, masks,
equality slots) must be EQUAL to the JAX package's on case9, case30, case118
and a seeded synthetic 57-bus case: the partition is deterministic numpy in
both packages.  ``detect_structure`` probes the Jacobian at the same
numpy-seeded points through ``torch.func.jacfwd`` and must find the same
supports as ``jax.jacfwd``.
"""

import dataclasses

import numpy as np
import pytest

from sqpsolver_tpu import structure as j_structure
from sqpsolver_tpu.models import acopf as j_acopf
from sqpsolver_tpu.models import matpower as j_matpower
from sqpsolver_tpu.models import power as j_power
from sqpsolver_tpu_torch import structure as t_structure
from sqpsolver_tpu_torch.models import acopf as t_acopf
from sqpsolver_tpu_torch.models import matpower as t_matpower
from sqpsolver_tpu_torch.models import power as t_power


CASES = {
    "case9": (t_power.case9, j_power.case9),
    "case30": (lambda: t_matpower.load_case("case30"), lambda: j_matpower.load_case("case30")),
    "case118": (lambda: t_matpower.load_case("case118"), lambda: j_matpower.load_case("case118")),
    "synth57": (
        lambda: t_power.synthetic_case(57, seed=3),
        lambda: j_power.synthetic_case(57, seed=3),
    ),
}


def _eq_mask(nlp):
    g_l, g_u = np.asarray(nlp.g_l), np.asarray(nlp.g_u)
    return np.isfinite(g_l) & (g_l == g_u)


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_structure_equals_jax(name):
    t_case, j_case = (make() for make in CASES[name])
    t_nlp = t_acopf.acopf_polar(t_case)
    j_nlp = j_acopf.acopf_polar(j_case)
    t_bs = t_structure.build_block_structure(t_nlp.n, t_nlp.m, t_nlp.structure, _eq_mask(t_nlp))
    j_bs = j_structure.build_block_structure(j_nlp.n, j_nlp.m, j_nlp.structure, _eq_mask(j_nlp))
    for field in dataclasses.fields(j_bs):
        got, want = getattr(t_bs, field.name), getattr(j_bs, field.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, field.name
            np.testing.assert_array_equal(got, want, err_msg=field.name)
        else:
            assert got == want, field.name
    if name == "case118":  # the sizes the structured case118 path runs at
        assert (t_bs.P, t_bs.nd, t_bs.ns, t_bs.mr) == (8, 96, 73, 208)


@pytest.mark.parametrize("name", sorted(CASES))
def test_acopf_polar_structure_equals_jax(name):
    t_case, j_case = (make() for make in CASES[name])
    got = t_acopf.acopf_polar(t_case).structure
    want = j_acopf.acopf_polar_structure(j_case)
    assert len(got.row_cols) == len(want.row_cols)
    for i, (a, b) in enumerate(zip(got.row_cols, want.row_cols)):
        np.testing.assert_array_equal(a, b, err_msg=f"row {i}")
    np.testing.assert_array_equal(got.obj_pairs, want.obj_pairs)


def test_detect_structure_equals_jax_on_case9():
    got = t_structure.detect_structure(t_acopf.acopf_polar(t_power.case9()))
    want = j_structure.detect_structure(j_acopf.acopf_polar(j_power.case9()))
    assert len(got.row_cols) == len(want.row_cols)
    for i, (a, b) in enumerate(zip(got.row_cols, want.row_cols)):
        np.testing.assert_array_equal(a, b, err_msg=f"row {i}")
    # ... and the detected support lies inside the analytic one
    ana = t_acopf.acopf_polar(t_power.case9()).structure
    for a, b in zip(got.row_cols, ana.row_cols):
        assert set(a.tolist()) <= set(b.tolist())


def test_color_groups_and_partition_equal_jax():
    rng = np.random.default_rng(5)
    n = 40
    rows = tuple(np.unique(rng.integers(0, n, size=rng.integers(1, 6))) for _ in range(60))
    st_t = t_structure.NLPStructure(row_cols=rows)
    st_j = j_structure.NLPStructure(row_cols=rows)
    np.testing.assert_array_equal(
        t_structure.color_groups(n, rows), j_structure.color_groups(n, rows)
    )
    adj_t = t_structure.interaction_graph(n, st_t)
    assert adj_t == j_structure.interaction_graph(n, st_j)
    parts_t, sep_t = t_structure.partition_vertex_separator(adj_t, 4)
    parts_j, sep_j = j_structure.partition_vertex_separator(adj_t, 4)
    np.testing.assert_array_equal(sep_t, sep_j)
    assert len(parts_t) == len(parts_j)
    for a, b in zip(parts_t, parts_j):
        np.testing.assert_array_equal(a, b)
