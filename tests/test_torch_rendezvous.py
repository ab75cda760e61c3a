"""Distributed rendezvous through the port's control plane, end to end.

Twin of ``tests/test_rendezvous_e2e.py``: a 2-replica gang with the svc
and env job plugins goes through each package's controllers, scheduler
and simulator; the bound pods' env (``VC_COORDINATOR_ADDRESS``,
``VC_PROCESS_COUNT``, ``VC_PROCESS_ID``, ``<TASK>_HOSTS`` / ``_NUM``,
``VK_TASK_INDEX``) is the same in both packages, and two real OS processes
complete a ``torch.distributed`` gloo handshake (``init_process_group``
with the rendered address, world size and rank, then an all-reduce) from
the port's env -- the test plays the kubelet and the cluster DNS (the
coordinator's port is rebound to a free local one).

Run as ``python tests/test_torch_rendezvous.py`` with that env, the module
is the worker.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _worker() -> None:
    import torch
    import torch.distributed as dist

    count = int(os.environ["VC_PROCESS_COUNT"])
    rank = int(os.environ["VC_PROCESS_ID"])
    _host, _, port = os.environ["VC_COORDINATOR_ADDRESS"].rpartition(":")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=count, rank=rank)
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    print(json.dumps({"rank": dist.get_rank(),
                      "world_size": dist.get_world_size(),
                      "sum": float(t.item())}), flush=True)
    dist.destroy_process_group()


def _bound_env(pkg):
    """The env of the gang's pods once bound and running, by pod name."""
    from test_torch_fixtures import reset_uid_counters

    mods = {m: importlib.import_module(f"{pkg.__name__}.{m}")
            for m in ("api", "cache", "controllers", "scheduler", "sim")}
    reset_uid_counters()
    store = mods["cache"].ClusterStore()
    for i in range(2):
        store.add_node(mods["api"].Node(
            name=f"n{i}", allocatable={"cpu": "8", "memory": "16Gi",
                                       "pods": 110}))
    ctrl = mods["controllers"]
    cm = ctrl.ControllerManager(store)
    kw = {"device": "cpu"} if pkg.__name__ == "volcano_tpu_torch" else {}
    sched = mods["scheduler"].Scheduler(store, **kw)
    sim = mods["sim"].ClusterSimulator(store)
    store.add_batch_job(ctrl.Job(
        name="torchdist", min_available=2,
        tasks=[ctrl.TaskSpec(name="worker", replicas=2,
                             containers=[{"cpu": "1", "memory": "1Gi"}])],
        plugins={"svc": [], "env": []}))
    for _ in range(4):
        cm.process()
        sched.run_once()
        sim.step()
        cm.process()
    pods = [p for p in store.pods.values()
            if p.owner_job == "default/torchdist"]
    assert len(pods) == 2 and all(p.node_name for p in pods), \
        "gang not fully bound"
    out = {p.name: dict(p.env) for p in pods}
    store.close()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_rendered_env_equals_jax_and_two_processes_rendezvous():
    import volcano_tpu
    import volcano_tpu_torch

    want = _bound_env(volcano_tpu)
    got = _bound_env(volcano_tpu_torch)
    assert got == want
    assert {e["VC_PROCESS_ID"] for e in got.values()} == {"0", "1"}
    assert all(e["VC_PROCESS_COUNT"] == "2" for e in got.values())
    assert all(e["VC_COORDINATOR_ADDRESS"]
               == "torchdist-worker-0.torchdist:8476" for e in got.values())

    port = _free_port()
    procs = []
    try:
        for name in sorted(got, key=lambda n: int(got[n]["VC_PROCESS_ID"])):
            env = dict(os.environ)
            env.update(got[name])
            host, _, _ = env["VC_COORDINATOR_ADDRESS"].rpartition(":")
            env["VC_COORDINATOR_ADDRESS"] = f"{host}:{port}"
            env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get(
                "PYTHONPATH", "")
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve())],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
                text=True))
        results = []
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert sorted(r["rank"] for r in results) == [0, 1]
    assert all(r["world_size"] == 2 for r in results)
    assert all(r["sum"] == 3.0 for r in results)


if __name__ == "__main__":
    _worker()
