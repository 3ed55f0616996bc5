"""The PyTorch port's numpy-level foundations equal the JAX package's.

Status tables, ``Parameters`` fields and defaults, parsed MATPOWER cases,
``load_scenarios`` draws, the KKT/violation formulas of
``algorithms/common.py`` and the ``convert`` round trip.  Exact equality
unless a tolerance is stated.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu import parameters as j_parameters
from sqpsolver_tpu import status as j_status
from sqpsolver_tpu.algorithms import common as j_common
from sqpsolver_tpu.models import acopf as j_acopf
from sqpsolver_tpu.models import matpower as j_matpower
from sqpsolver_tpu.nlp import NLPData as JNLPData
from sqpsolver_tpu_torch import convert
from sqpsolver_tpu_torch.algorithms import common as t_common
from sqpsolver_tpu_torch.models import acopf as t_acopf
from sqpsolver_tpu_torch.models import matpower as t_matpower



def test_status_tables_identical():
    assert {s.name: int(s) for s in tp.Status} == {
        s.name: int(s) for s in j_status.Status
    }
    assert {int(k): v for k, v in tp.STATUS_NAME.items()} == {
        int(k): v for k, v in j_status.STATUS_NAME.items()
    }
    for code in (0, 6, -3, 42):
        assert tp.status_name(code) == j_status.status_name(code)
        assert tp.is_success(code) == j_status.is_success(code)


def test_parameters_fields_and_defaults_identical():
    def table(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert table(tp.Parameters) == table(j_parameters.Parameters)
    p = tp.set_parameter(tp.Parameters(), "kkt_backend", "pallas")
    assert tp.get_parameter(p, "kkt_backend") == "pallas"
    with pytest.raises(KeyError):
        tp.set_parameter(p, "no_such_knob", 1)


@pytest.mark.parametrize("name", ["case5", "case14", "case30"])
def test_parsed_cases_equal(name):
    a, b = t_matpower.load_case(name), j_matpower.load_case(name)
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("seed,batch,spread", [(7, 32, 0.03), (0, 5, 0.1)])
def test_load_scenarios_byte_identical(seed, batch, spread):
    case = t_matpower.load_case("case30")
    a = t_acopf.load_scenarios(case, batch, seed=seed, spread=spread)
    b = j_acopf.load_scenarios(case, batch, seed=seed, spread=spread)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def _random_parts(seed, B=4, n=7, m=5):
    rng = np.random.default_rng(seed)
    return dict(
        E=rng.standard_normal((B, m)),
        g_l=np.where(rng.random((B, m)) < 0.3, -np.inf, -0.5),
        g_u=np.where(rng.random((B, m)) < 0.3, np.inf, 0.5),
        x=rng.standard_normal((B, n)) * 2,
        x_l=np.full((B, n), -1.0),
        x_u=np.full((B, n), 1.0),
        df=rng.standard_normal((B, n)),
        lam=rng.standard_normal((B, m)),
        mu=np.abs(rng.standard_normal((B, n))),
        ml=np.abs(rng.standard_normal((B, n))),
        J=rng.standard_normal((B, m, n)),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_common_formulas_match_jax(seed):
    """norm_violations (ord 1 and inf) and kt_residuals, per lane, rel 1e-14."""
    d = _random_parts(seed)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    for ord_ in (1, np.inf):
        got = t_common.norm_violations(
            t["E"], t["g_l"], t["g_u"], t["x"], t["x_l"], t["x_u"], ord=ord_
        ).numpy()
        want = np.array([
            float(j_common.norm_violations(
                jnp.asarray(d["E"][i]), jnp.asarray(d["g_l"][i]), jnp.asarray(d["g_u"][i]),
                jnp.asarray(d["x"][i]), jnp.asarray(d["x_l"][i]), jnp.asarray(d["x_u"][i]),
                ord=ord_,
            ))
            for i in range(len(d["E"]))
        ])
        np.testing.assert_allclose(got, want, rtol=1e-14)
    got = t_common.kt_residuals(t["df"], t["lam"], t["mu"], t["ml"], t["J"]).numpy()
    want = np.array([
        float(j_common.kt_residuals(
            jnp.asarray(d["df"][i]), jnp.asarray(d["lam"][i]), jnp.asarray(d["mu"][i]),
            jnp.asarray(d["ml"][i]), jnp.asarray(d["J"][i]),
        ))
        for i in range(len(d["df"]))
    ])
    np.testing.assert_allclose(got, want, rtol=1e-14)


@pytest.mark.parametrize(
    "kw",
    [
        dict(kkt_precision="mixed_ir"),
        dict(kkt_precision="mixed_ir", schur_cap=40),
        dict(kkt_precision="direct"),
        dict(kkt_precision="mixed_ir", schur_cap=0),
    ],
)
def test_schur_cap_for_matches_jax(kw):
    case = t_matpower.load_case("case30")
    t_nlp = t_acopf.acopf_polar(case)
    j_nlp = j_acopf.acopf_polar(j_matpower.load_case("case30"))
    got = t_common.schur_cap_for(tp.Parameters(**kw), t_nlp)
    assert got == j_common.schur_cap_for(j_parameters.Parameters(**kw), j_nlp)


def test_convert_round_trip():
    rng = np.random.default_rng(3)
    jd = JNLPData(
        x_l=jnp.asarray(rng.standard_normal((2, 4))),
        x_u=jnp.asarray(rng.standard_normal((2, 4))),
        g_l=jnp.asarray(rng.standard_normal((2, 3))),
        g_u=jnp.asarray(rng.standard_normal((2, 3))),
        x0=jnp.asarray(rng.standard_normal((2, 4))),
        theta={"pd": jnp.asarray(rng.standard_normal((2, 5)))},
    )
    td = convert.nlp_data_to_torch(jd, dtype=torch.float64, device="cpu")
    for name in ("x_l", "x_u", "g_l", "g_u", "x0"):
        t = getattr(td, name)
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jd, name)))
    np.testing.assert_array_equal(td.theta["pd"].numpy(), np.asarray(jd.theta["pd"]))
    assert td.lam0 is None
    res = tp.SqpResult(*(torch.arange(3.0) for _ in range(15)))
    out = convert.result_to_numpy(res)
    assert set(out) == set(tp.SqpResult._fields) - {"stats"}
    np.testing.assert_array_equal(out["x"], np.arange(3.0))
