"""Multi-process helpers (``parallel/multihost.py``) in the port against the
JAX package.

* ``initialize_distributed()`` is a no-op in one process with no launcher,
  as the JAX package's (``tests/test_multihost.py``); asked to start a group
  without naming the CPU, it wants the card (NCCL) and raises here.
* ``global_instance_mesh`` plus ``host_local_batch`` and a sharded toy solve
  in one process; ``global_instance_mesh()`` takes the card unless asked
  for the CPU.
* ``convergence_census`` equals the JAX package's on the same status
  arrays (an empty one too), tensors and host arrays, and through a
  world-size-1 gloo group its ``all_reduce``.
* Two processes over gloo, modelled on ``tests/test_multiprocess.py``: a
  global case9 batch of 4 load scenarios, 2 lanes per rank; the census must
  read 4 of 4 solved on both ranks and each rank's objectives must match the
  JAX package's lanes (``data/anchor_multiprocess_case9_b4.json``) within
  1e-8 relative.  Each worker runs one torch thread and has its own time
  limit.
"""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu.parallel import multihost as j_mh
from sqpsolver_tpu_torch.models.toy import toy_nlp
from sqpsolver_tpu_torch.parallel import multihost as mh
from sqpsolver_tpu_torch.parallel.sharding import make_sharded_solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STATUSES = [
    [],
    [0, 0, 0, 0],
    [0, 1, 6, 2, -3, 2, -1, 0],
    [2, 2, -4],
]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mh.initialize_distributed()  # must not raise on a single process
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    mh.initialize_distributed()
    assert not dist.is_initialized()


def test_initialize_wants_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: NCCL would start")
    with pytest.raises(RuntimeError, match="NCCL"):
        mh.initialize_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}",
                                  world_size=1, rank=0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mh.global_instance_mesh()


def test_global_mesh_and_host_local_batch():
    mesh = mh.global_instance_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),) and (mesh.rank, mesh.world) == (0, 1)
    nlp = toy_nlp()
    data = tp.batch_data(nlp, 4, device="cpu")
    gdata = mh.host_local_batch(data, mesh)
    assert (gdata.global_batch, len(gdata.shards)) == (4, 1)
    out = make_sharded_solver(nlp, tp.Parameters(max_iter=100, OutputFlag=0), mesh)(gdata)
    census = mh.convergence_census(out.status)
    assert census["n_done_ok"] == census["n_total"] == 4


@pytest.mark.parametrize("status", STATUSES, ids=lambda s: f"n{len(s)}")
def test_census_matches_jax(status):
    arr = np.asarray(status, dtype=np.int32)
    want = j_mh.convergence_census(jnp.asarray(arr))
    assert j_mh.convergence_census(arr) == want
    assert mh.convergence_census(torch.as_tensor(arr)) == want
    assert mh.convergence_census(arr) == want
    assert mh.convergence_census(list(status)) == want


def test_census_all_reduce_in_a_one_process_group():
    mh.initialize_distributed(device="cpu", init_method=f"tcp://127.0.0.1:{_free_port()}",
                              world_size=1, rank=0)
    try:
        assert dist.get_backend() == "gloo"
        mesh = mh.global_instance_mesh(device="cpu")
        assert (mesh.rank, mesh.world) == (0, 1)
        mh.initialize_distributed(device="cpu")  # already up: a no-op
        status = torch.tensor([0, 2, -3, 1], dtype=torch.int32)
        assert mh.convergence_census(status, mesh) == j_mh.convergence_census(np.asarray(status))
    finally:
        dist.destroy_process_group()


_WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
import datetime
import numpy as np
import torch.distributed as dist
import sqpsolver_tpu_torch as tp
from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
from sqpsolver_tpu_torch.models.power import case9
from sqpsolver_tpu_torch.parallel import multihost as mh
from sqpsolver_tpu_torch.parallel import sharding as shd

rank, port, anchor_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
with open(anchor_path) as fh:
    anchor = json.load(fh)
mh.initialize_distributed(device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                          world_size=2, rank=rank, timeout=datetime.timedelta(seconds=120))
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
mesh = mh.global_instance_mesh(device="cpu")
assert (mesh.rank, mesh.world) == (rank, 2), mesh
case = case9()
nlp = acopf_polar(case)
theta = load_scenarios(case, anchor["batch"], seed=anchor["seed"], spread=anchor["spread"])
local = anchor["batch"] // 2
lo = rank * local
theta_local = {k: v[lo:lo + local] for k, v in theta.items()}
data = tp.batch_data(nlp, local, theta=theta_local, device="cpu")
gdata = mh.host_local_batch(data, mesh)
assert gdata.global_batch == anchor["batch"], gdata.global_batch
out = shd.make_sharded_solver(nlp, tp.Parameters(**anchor["params"]), mesh)(gdata)
census = mh.convergence_census(out.status, mesh)
assert census == {"n_total": 4, "n_done_ok": 4, "n_infeasible": 0, "n_other": 0}, census
obj = out.obj_val.numpy()
want = np.asarray(anchor["lanes"]["obj"][lo:lo + local])
rel = np.abs(obj / want - 1.0)
assert np.all(rel <= 1e-8), (obj, want, rel)
assert out.status.tolist() == anchor["lanes"]["status"][lo:lo + local]
dist.destroy_process_group()
print(f"MPOK {rank} {rel.max():.3e}", flush=True)
"""


def test_two_process_gloo_census_and_lanes():
    port = _free_port()
    anchor = os.path.join(REPO, "sqpsolver_tpu_torch", "data", "anchor_multiprocess_case9_b4.json")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(rank), str(port), anchor],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO,
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=100)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-4000:]}"
        assert f"MPOK {rank}" in out, out[-2000:]
