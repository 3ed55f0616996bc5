"""The interior-point solver over n > 128 on the CPU: the first SQP
iteration's QP of two interconnected copies of MATPOWER case30
(``replicate_case``: n = 144, m = 287, Schur cap 168), the smallest real
network whose KKT matrices K and S both span two 128-panels.

The QP data (Hessian with the ``ladder`` floor, gradient, Jacobian, row and
trust-region bounds at the flat start of two load scenarios) is evaluated once
by the port and handed to both packages as numpy arrays.  Both solve it with
float32 factors in phase 1 and the strict float64 polish (``polish_iters=20``,
``tol=1e-8``): the port through ``kkt_backend="pallas"`` (the 128-panel
``cholesky_blocked`` / ``tri_inv_blocked`` over the tile kernel's plain
version; float64 factors through the library), the JAX package through
``kkt_backend="xla"``, whose phase 2 is float64 too.  Phase 1 alone is not
comparable at this size (its float32 exits differ by 1e-4 between the JAX
package's own two backends); the polished solution is: ``converged`` equal,
``p`` within 1e-6 absolute (per-unit steps of order 0.1) and ``y`` within 1e-6
relative to its largest entry.

A whole solve at this size needs the rescue on every lane and takes over
90 s in the two packages together on one worker, so it runs on the card only
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu.ops import qp_ipm as j_qp
from sqpsolver_tpu_torch.algorithms.common import schur_cap_for
from sqpsolver_tpu_torch.models import acopf as t_acopf
from sqpsolver_tpu_torch.models import matpower as t_matpower
from sqpsolver_tpu_torch.models import power as t_power
from sqpsolver_tpu_torch.ops import qp_ipm as t_qp
from sqpsolver_tpu_torch.ops.chol_blocked import cholesky_blocked

B = 2


def _first_qp():
    case = t_power.replicate_case(t_matpower.load_case("case30"), 2)
    nlp = t_acopf.acopf_polar(case)
    theta = t_acopf.load_scenarios(case, B, seed=7, spread=0.03)
    d = tp.batch_data(nlp, B, theta=theta, device="cpu")
    x = tp.initial_point(d)
    lam = x.new_zeros((B, nlp.m))
    _, df = nlp.obj_grad(x, d.theta)
    _, E = nlp.obj_cons(x, d.theta)
    J = nlp.cons_jac(x, d.theta)
    H = nlp.lag_hess(x, lam, d.theta)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    off = H.abs().sum(-1) - diag.abs()
    floor = 4.0e-7 * (1.0 + (diag.abs() + off).amax(-1))
    Q = H + floor[:, None, None] * torch.eye(nlp.n, dtype=H.dtype)
    tr = 1.0
    lb = torch.maximum(torch.full_like(x, -tr), d.x_l - x)
    ub = torch.minimum(torch.full_like(x, tr), d.x_u - x)
    w = torch.full_like(E, 1.0e6)
    arrs = [a.numpy() for a in (Q, df, J, d.g_l - E, d.g_u - E, lb, ub, w)]
    cap = schur_cap_for(tp.Parameters(kkt_precision="mixed_ir", schur_cap=-1), nlp)
    return nlp, arrs, cap


def test_two_panel_qp_matches_jax():
    nlp, arrs, cap = _first_qp()
    assert (nlp.n, nlp.m) == (144, 287) and cap == 168
    kw = dict(factor_dtype="float32", ir_steps=4, invE_floor=3e-7, schur_cap=cap,
              tol=1e-8, max_iter=30, polish_iters=20)
    j_opts = j_qp.IpmOptions(kkt_backend="xla", **kw)
    jsol = jax.jit(jax.vmap(lambda *a: j_qp.solve_qp(*a, opts=j_opts)))(
        *(jnp.asarray(a) for a in arrs)
    )
    calls = cholesky_blocked.calls
    trips = dict(t_qp.solve_qp.loop_trips)
    tsol = t_qp.solve_qp(
        *(torch.as_tensor(a) for a in arrs), opts=t_qp.IpmOptions(kkt_backend="pallas", **kw)
    )
    assert cholesky_blocked.calls > calls  # phase 1 went through the panels
    assert t_qp.solve_qp.loop_trips[2] > trips[2]  # and phase 2 ran
    np.testing.assert_array_equal(tsol.converged.numpy(), np.asarray(jsol.converged))
    assert tsol.converged.all()
    np.testing.assert_allclose(tsol.p.numpy(), np.asarray(jsol.p), rtol=0, atol=1e-6)
    y = np.asarray(jsol.y)
    assert np.abs(tsol.y.numpy() - y).max() <= 1e-6 * np.abs(y).max()
