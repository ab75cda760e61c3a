"""The port's remote side-effect boundary against the JAX package's.

Twins of ``tests/test_remote_binder.py``: each of its tests runs against
both packages (``test_torch_fixtures.run_twin_case``) -- for the port, its
fixture starts ``python -m volcano_tpu_torch.cache.remote --port 0`` (the
readiness line names the port it took) and its stores bind, evict and
write PodGroup status through the port's ``HttpBinder``, ``HttpEvictor``
and ``HttpStatusUpdater`` across that process boundary, with the injected
failures' backoff and revert paths -- its assertions holding on each and
the store's control digest after every cycle equal.  The JAX package runs
its Python reclaim walk there (its native replay skips the mirror's dirty
mark, ROADMAP.md queue 3).

Also: the flow of ``examples/remote_boundary.py`` (a gang bound and its
PodGroup status written through all three drop-ins against an in-process
``RemoteBindService``) on both packages, the remote tables equal; and the
two wire protocols interchangeable (the JAX package's clients against the
port's child).
"""

import importlib
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import volcano_tpu
import volcano_tpu_torch
from test_torch_fixtures import reset_uid_counters, run_twin_case, twin_cases

ROOT = Path(__file__).resolve().parent
MODULE = ROOT / "test_remote_binder.py"
CASES = twin_cases(MODULE)


@pytest.mark.parametrize("case", CASES)
def test_jax_remote_binder_case_twin(case):
    want = run_twin_case(MODULE, case, volcano_tpu)
    got = run_twin_case(MODULE, case, volcano_tpu_torch)
    assert got == want


def _boundary_flow(pkg):
    """``examples/remote_boundary.py`` on ``pkg``: returns the remote
    bind table and PodGroup status table."""
    api = importlib.import_module(f"{pkg.__name__}.api")
    cache = importlib.import_module(f"{pkg.__name__}.cache")
    remote = importlib.import_module(f"{pkg.__name__}.cache.remote")
    sched_mod = importlib.import_module(f"{pkg.__name__}.scheduler")
    reset_uid_counters()
    svc = remote.RemoteBindService(port=0)
    t = threading.Thread(target=svc.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{svc.port}"
    store = cache.ClusterStore()
    try:
        store.binder = remote.HttpBinder(url)
        store.evictor = remote.HttpEvictor(url)
        store.status_updater = remote.HttpStatusUpdater(url)
        store.async_bind = True
        for i in range(3):
            store.add_node(api.Node(name=f"n{i}", allocatable={
                "cpu": "8", "memory": "16Gi"}))
        store.add_pod_group(api.PodGroup(name="demo", min_member=3))
        for k in range(3):
            store.add_pod(api.Pod(
                name=f"demo-{k}",
                annotations={api.GROUP_NAME_ANNOTATION: "demo"},
                containers=[{"cpu": "2", "memory": "2Gi"}]))
        kw = {"device": "cpu"} if pkg is volcano_tpu_torch else {}
        sched_mod.Scheduler(store, **kw).run_once()
        assert store.flush_binds(timeout=30)
        return (remote.HttpBinder(url).binds(),
                remote.HttpStatusUpdater(url).pod_groups())
    finally:
        store.close()
        svc.shutdown()
        t.join(30)


def test_remote_boundary_example_flow_equals_jax():
    want = _boundary_flow(volcano_tpu)
    got = _boundary_flow(volcano_tpu_torch)
    assert got == want
    binds, groups = got
    assert len(binds) == 3
    assert groups["default/demo"]["phase"] == "Running"


def test_jax_clients_against_the_port_child():
    """The wire is the JAX package's: its clients drive the port's child
    (binds, a failed batch, evictions, status) as they drive their own."""
    from volcano_tpu.cache.remote import (HttpBinder, HttpEvictor,
                                          HttpStatusUpdater)
    from volcano_tpu.cache.interface import BindFailure

    proc = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.cache.remote", "--port",
         "0"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=ROOT.parent)
    try:
        line = proc.stdout.readline()
        assert line.startswith("remote-binder listening on 127.0.0.1:")
        url = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        b = HttpBinder(url)
        b.bind_keys(["default/a", "default/b"], ["n0", "n1"])
        b.chaos_fail_next(1)
        with pytest.raises(BindFailure):
            b.bind_keys(["default/c"], ["n2"])
        assert b.binds() == {"default/a": "n0", "default/b": "n1"}
        e = HttpEvictor(url)
        e.evict_keys(["default/a"])
        assert e.evicts() == ["default/a"]
        HttpStatusUpdater(url).update_pod_groups([type("PG", (), {
            "uid": "default/g", "status": type("S", (), {
                "phase": "Running", "running": 2, "failed": 0,
                "succeeded": 0})()})()])
        assert HttpStatusUpdater(url).pod_groups()["default/g"][
            "running"] == 2
    finally:
        proc.terminate()
        proc.wait(timeout=30)
