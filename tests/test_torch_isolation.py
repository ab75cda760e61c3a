"""The port stands alone.

(a) With ``jax``, ``jaxlib`` and ``volcano_tpu`` unimportable, the port's
    modules import and run a tiny CPU solve, also single-phase
    (``VOLCANO_TPU_TWOPHASE=0``) with live steering
    (``VOLCANO_TPU_AFF_STEER=1``) on an affinity mix.
(b) No module of the port, and not ``chip_smoke.py``, imports ``jax`` or
    anything of ``volcano_tpu``.
(c) Without CUDA, the default-device entry points raise.
(d) Every unsupported feature raises ``NotImplementedError``; host ports,
    inter-pod affinity, anti-affinity and spread, which the port runs, give
    the JAX package's placements on the same small stores.
(e) The same for the scheduler cycle: it runs with ``jax``, ``volcano_tpu``
    and ``yaml`` unimportable (preempt / reclaim on the device lane and on
    the host victim walk with its native engine, and the rebalance lane on
    a fabric, included), no module imports ``yaml``, the default device
    raises without CUDA; with the walk selected preempt and reclaim evict
    and bind what the JAX package's walk does, and the rebalance lane,
    which ignores the host-walk switch, runs under it; the walk's native
    loader builds the port's own source only; a cycle with inter-pod terms
    binds what the JAX package's cycle binds.
(f) The store's observability (auditor, SLO tracker, journey, Perfetto
    export), checkpoints and the lease are the port's own modules: they
    import neither ``jax`` nor ``volcano_tpu``, and a default store with
    them wired runs an audited cycle, exports a trace and round-trips a
    checkpoint with the JAX package unimportable.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import volcano_tpu_torch
import volcano_tpu_torch.api
import volcano_tpu_torch.cache
from volcano_tpu_torch.ops import wave as port_wave
from volcano_tpu_torch.synth import solve_args_from_store, synthetic_cluster

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "volcano_tpu_torch"

_BLOCKER = r'''
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "volcano_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
'''

_TINY_SOLVE = r'''
import pkgutil, importlib
import numpy as np
import volcano_tpu_torch
for m in pkgutil.walk_packages(volcano_tpu_torch.__path__, "volcano_tpu_torch."):
    importlib.import_module(m.name)
from volcano_tpu_torch.synth import synthetic_cluster, solve_args_from_store
from volcano_tpu_torch.ops.wave import solve_wave
args, _ = solve_args_from_store(synthetic_cluster(n_nodes=8, n_pods=32),
                                device="cpu")
res = solve_wave(*args, wave=16, device="cpu")
assert int((res.assigned >= 0).sum()) == 32
assert not any(k.split(".")[0] in ("jax", "jaxlib", "volcano_tpu")
               for k in sys.modules)
print("ok")
'''


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER + "import sys\n" + _TINY_SOLVE],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imported_names(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "volcano_tpu"), (f, name)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = synthetic_cluster(n_nodes=4, n_pods=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_args_from_store(store)
    args, _ = solve_args_from_store(store, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_wave.solve_wave(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_wave.solve_wave(*args, device="cuda")


def _store_with(pkg=volcano_tpu_torch, **pod_extra):
    api = pkg.api
    store = pkg.cache.ClusterStore()
    for i in range(4):
        store.add_node(api.Node(name=f"n{i}",
                                allocatable={"cpu": "8", "memory": "16Gi"},
                                labels={"zone": f"z{i % 2}"}))
    store.add_pod_group(api.PodGroup(name="g", min_member=2))
    for k in range(2):
        store.add_pod(api.Pod(name=f"g-{k}", labels={"app": "g"},
                              annotations={api.GROUP_NAME_ANNOTATION: "g"},
                              containers=[{"cpu": "1", "memory": "1Gi"}],
                              **pod_extra))
    return store


def _args(**pod_extra):
    return solve_args_from_store(_store_with(**pod_extra), device="cpu")[0]


# Pod fields of the features the port runs, built from either package's
# api: each case's store goes through both packages' encode and solve.
PORTED = {
    "host ports": lambda api: dict(host_ports=[8080]),
    "inter-pod affinity": lambda api: dict(affinity=[api.AffinityTerm(
        match_labels={"app": "g"}, topology_key="zone")]),
    "anti-affinity": lambda api: dict(anti_affinity=[api.AffinityTerm(
        match_labels={"app": "g"})]),
    "spread": lambda api: dict(topology_spread=[("zone", 5)]),
}


@pytest.mark.parametrize("what", sorted(PORTED))
def test_ported_features_match_jax(what):
    """Each store goes through the JAX package's encode and solve and the
    port's own; the results are equal field by field (exact: every sum
    is of whole CPUs and GiB), and the gang places whole."""
    import volcano_tpu
    import volcano_tpu.api
    from volcano_tpu.ops.wave import solve_wave as jax_solve_wave
    from volcano_tpu.synth import solve_args_from_store as jax_args

    from volcano_tpu_torch import interop

    jargs = jax_args(_store_with(volcano_tpu,
                                 **PORTED[what](volcano_tpu.api)))[0]
    jr = jax_solve_wave(*jargs, wave=8)
    tr = interop.result_to_numpy(port_wave.solve_wave(
        *_args(**PORTED[what](volcano_tpu_torch.api)), wave=8,
        device="cpu"))
    for f in ("assigned", "pipelined", "never_ready", "fit_failed", "idle",
              "q_alloc", "iters", "fb_exhausted", "fb_affinity"):
        assert np.array_equal(np.asarray(getattr(jr, f)),
                              np.asarray(getattr(tr, f))), f
    placed = np.asarray(tr.assigned)[:2]
    assert (placed >= 0).all()
    if what in ("host ports", "anti-affinity"):
        assert placed[0] != placed[1]
    if what == "inter-pod affinity":
        assert placed[0] % 2 == placed[1] % 2  # one zone


def _extra(kind, P, N):
    """A custom plugin's [P, N] plane: node 0 vetoed, or scored up."""
    if kind == "extra_ok":
        ok = np.ones((P, N), bool)
        ok[:, 0] = False
        return ok
    score = np.zeros((P, N), np.float32)
    score[:, 3] = 50.0
    return score


@pytest.mark.parametrize("kind", ["extra_ok", "extra_score"])
def test_custom_plugin_planes_match_jax(kind):
    """The custom-plugin planes the object session hands the wave solve:
    equal to the JAX package's, and they steer the gang."""
    import volcano_tpu
    from volcano_tpu.ops.wave import solve_wave as jax_solve_wave
    from volcano_tpu.synth import solve_args_from_store as jax_args

    from volcano_tpu_torch import interop

    jargs = jax_args(_store_with(volcano_tpu))[0]
    P, N = np.asarray(jargs[1].req).shape[0], np.asarray(
        jargs[0].idle).shape[0]
    kw = {kind: _extra(kind, P, N)}
    jr = jax_solve_wave(*jargs, wave=8, **kw)
    tr = interop.result_to_numpy(port_wave.solve_wave(
        *_args(), wave=8, device="cpu", **kw))
    for f in ("assigned", "pipelined", "never_ready", "fit_failed", "idle",
              "q_alloc", "iters"):
        assert np.array_equal(np.asarray(getattr(jr, f)),
                              np.asarray(getattr(tr, f))), f
    placed = np.asarray(tr.assigned)[:2]
    assert (placed >= 0).all()
    if kind == "extra_ok":
        assert (placed != 0).all()
    else:
        assert (placed == 3).any()


UNSUPPORTED = {
    "mesh_shards": (_args, {"mesh_shards": 2}),
}


@pytest.mark.parametrize("what", sorted(UNSUPPORTED))
def test_unsupported_features_raise(what):
    make, kw = UNSUPPORTED[what]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_wave.solve_wave(*make(), wave=8, device="cpu", **kw)


_STEERED_SOLVE = r'''
import volcano_tpu_torch.ops.wave as tw
args, _ = solve_args_from_store(synthetic_cluster(
    n_nodes=16, n_pods=96, gang_size=8, zones=4, affinity_fraction=0.3,
    anti_affinity_fraction=0.3, seed=1), device="cpu")
res = solve_wave(*args, wave=32, device="cpu")
assert int((res.assigned >= 0).sum()) > 0
assert tw.LAST_TWOPHASE["enabled"] is False and tw.LAST_TWOPHASE["affinity"]
assert tw.AFF_STEER == 1
assert not any(k.split(".")[0] in ("jax", "jaxlib", "volcano_tpu")
               for k in sys.modules)
print("ok")
'''


def test_single_phase_and_steering_run_with_jax_and_reference_blocked():
    """The single-phase solve and live steering, switched on from the
    environment, run with the JAX package unimportable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), VOLCANO_TPU_TWOPHASE="0",
               VOLCANO_TPU_AFF_STEER="1")
    out = subprocess.run(
        [sys.executable, "-c",
         _BLOCKER + "import sys\n" + _TINY_SOLVE + _STEERED_SOLVE],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["ok", "ok"]


_CYCLE = r'''
import sys
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
from volcano_tpu_torch.synth import synthetic_cluster
store = synthetic_cluster(n_nodes=8, n_pods=32, gang_size=4)
Scheduler(store, conf_str=DEPLOYED_SCHEDULER_CONF, device="cpu").run_once()
assert len(store.binder.binds) == 32, store.binder.binds
assert store.device_snapshot.full_uploads == 1
assert store._devincr_cache.counts["full"] == 1
import os
os.environ["VOLCANO_TPU_EVICT_DEVICE"] = "1"
from volcano_tpu_torch.sim import ClusterSimulator
from volcano_tpu_torch.synth import preempt_cluster
store = preempt_cluster(n_nodes=4, n_pending=8)
sched = Scheduler(store, conf_str=(
    'actions: "enqueue, allocate, preempt, reclaim, backfill"\n'
    'tiers:\n- plugins:\n  - name: priority\n  - name: gang\n'
    '  - name: conformance\n- plugins:\n  - name: drf\n'
    '  - name: predicates\n  - name: proportion\n'), device="cpu")
sim = ClusterSimulator(store, grace_steps=1)
for _ in range(3):
    sched.run_once()
    sim.step()
assert store.migrations.committed_plans >= 1
os.environ["VOLCANO_TPU_EVICT_DEVICE"] = "0"
store = preempt_cluster(n_nodes=4, n_pending=8)
sched = Scheduler(store, conf_str=(
    'actions: "enqueue, allocate, preempt, reclaim, backfill"\n'
    'tiers:\n- plugins:\n  - name: priority\n  - name: gang\n'
    '  - name: conformance\n- plugins:\n  - name: drf\n'
    '  - name: predicates\n  - name: proportion\n'), device="cpu")
sim = ClusterSimulator(store, grace_steps=1)
for _ in range(3):
    sched.run_once()
    sim.step()
assert store.evictor.evicts and store.migrations is None
assert any(p.node_name for p in store.pods.values()
           if p.name.startswith("hi-"))
from volcano_tpu_torch import native
assert native.reclaim_lib() is not None
from volcano_tpu_torch.cache import FakeBinder
from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF
from volcano_tpu_torch.synth import fabric_cluster
os.environ["VOLCANO_TPU_REBALANCE_DRAIN_CAP"] = "64"
store = fabric_cluster(binder=FakeBinder())
sched = Scheduler(store, conf_str=REBALANCE_SCHEDULER_CONF, device="cpu")
sim = ClusterSimulator(store, grace_steps=2)
for _ in range(5):
    sched.run_once()
    sim.step()
assert store.migrations.committed_plans == 1
assert sum(1 for p in store.pods.values()
           if p.name.startswith("fabgang") and p.node_name) == 32
assert not any(k.split(".")[0] in ("jax", "jaxlib", "volcano_tpu", "yaml")
               for k in sys.modules)
print("ok")
'''


def test_cycle_runs_with_jax_reference_and_yaml_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    blocker = _BLOCKER.replace('("jax", "jaxlib", "volcano_tpu")',
                               '("jax", "jaxlib", "volcano_tpu", "yaml")')
    out = subprocess.run(
        [sys.executable, "-c", blocker + _CYCLE],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_native_loader_builds_port_sources_only(monkeypatch, tmp_path):
    """The host reclaim engine's loader compiles one source, under
    ``volcano_tpu_torch/csrc/host``, into a directory of the port's, and
    imports nothing of ``volcano_tpu`` (not ``volcano_tpu.native``, not
    the JAX package's ``csrc/libvcsnap.so``)."""
    import subprocess as sp

    from volcano_tpu_torch import native

    names = list(_imported_names(PORT / "native.py"))
    assert not any(n.split(".")[0] in ("jax", "volcano_tpu") for n in names)
    text = (PORT / "native.py").read_text()
    assert "libvcsnap" not in text and "volcano_tpu.native" not in text
    assert native.SOURCE.resolve().is_relative_to(PORT / "csrc" / "host")
    assert native._BUILD.resolve().is_relative_to(PORT)
    calls = []
    real = sp.run

    def spy(cmd, *a, **k):
        calls.append([str(c) for c in cmd])
        return real(cmd, *a, **k)

    monkeypatch.setattr(native, "_BUILD", tmp_path)
    monkeypatch.setattr(sp, "run", spy)
    native.build()
    assert len(calls) == 1
    paths = [c for c in calls[0] if c.startswith("/")]
    sources = [c for c in paths if not c.startswith(str(tmp_path))]
    assert sources == [str(native.SOURCE)]
    assert all(Path(c).resolve().is_relative_to(PORT) for c in sources)


def test_no_yaml_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for name in _imported_names(f):
            assert name.split(".")[0] != "yaml", (f, name)


def test_scheduler_default_device_raises_without_cuda(monkeypatch):
    from volcano_tpu_torch.scheduler import Scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = synthetic_cluster(n_nodes=4, n_pods=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(store)
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(store, device="cuda")
    assert not store.binder.binds


def _cycle_store():
    return synthetic_cluster(n_nodes=4, n_pods=8, gang_size=2)


def _conf(actions="enqueue, allocate, backfill", extra_plugin=""):
    return (f"actions: \"{actions}\"\ntiers:\n- plugins:\n"
            f"  - name: priority\n  - name: gang\n{extra_plugin}")


# The host victim walk (VOLCANO_TPU_EVICT_DEVICE=0) of each evict action,
# on a store where it evicts.
CYCLE_WALK = {
    "preempt": _conf("enqueue, allocate, preempt"),
    "reclaim": _conf("enqueue, allocate, reclaim"),
}


@pytest.mark.parametrize("what", sorted(CYCLE_WALK))
def test_cycle_host_walk_matches_jax(what, monkeypatch):
    """With the walk selected, preempt and reclaim run on the port (no
    ``NotImplementedError``) and evict, pipeline and bind what the JAX
    package's walk does, cycle by cycle."""
    import volcano_tpu
    import volcano_tpu.sim
    import volcano_tpu.synth

    from test_torch_fixtures import tier_store, walk_run

    import volcano_tpu_torch.sim

    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "0")
    if what == "preempt":
        build = tier_store  # in-queue victims of lower priority
    else:
        build = lambda pkg: pkg.synth.preempt_cluster(  # noqa: E731
            n_nodes=4, n_pending=8, seed=0)
    want = walk_run(volcano_tpu, build, conf=CYCLE_WALK[what], cycles=4,
                    grace=1)
    got = walk_run(volcano_tpu_torch, build, conf=CYCLE_WALK[what],
                   cycles=4, grace=1)
    assert got == want
    assert got[0]["evicted"] and got[0]["pipelined"]
    assert got[-1]["binds"]


# Confs the fast path does not run, and the switched-off fast path: the
# object session runs them, as the JAX Scheduler does.
OBJECT_SESSION = {
    "custom plugin": (_conf(extra_plugin="  - name: mine\n"), "1"),
    "unknown action": (_conf("enqueue, allocate, shuffle"), "1"),
    "sequential solver": (_conf() + (
        "configurations:\n- name: allocate\n  arguments:\n"
        "    solver: seq\n"), "1"),
    "fastpath off": (_conf(), "0"),
}


@pytest.mark.parametrize("what", sorted(OBJECT_SESSION))
def test_object_session_cases_match_jax(what, monkeypatch):
    """Each case runs the object session on both packages (a flight
    record with ``path == "object"``) and binds the same pods."""
    import volcano_tpu.synth
    from volcano_tpu.scheduler import Scheduler as JaxScheduler

    from volcano_tpu_torch.scheduler import Scheduler

    conf, fastpath = OBJECT_SESSION[what]
    monkeypatch.setenv("VOLCANO_TPU_FASTPATH", fastpath)
    jstore = volcano_tpu.synth.synthetic_cluster(n_nodes=4, n_pods=8,
                                                 gang_size=2)
    jstore.pipeline = False
    JaxScheduler(jstore, conf_str=conf).run_once()
    store = _cycle_store()
    Scheduler(store, conf_str=conf, device="cpu").run_once()
    assert store.flight.last().path == "object"
    assert len(store.binder.binds) == 8
    assert dict(store.binder.binds) == dict(jstore.binder.binds)


CYCLE_PORTED = {
    "inter-pod affinity": PORTED["inter-pod affinity"],
    "anti-affinity": PORTED["anti-affinity"],
    "preferred affinity": lambda api: dict(preferred_affinity=[(
        api.AffinityTerm(match_labels={"app": "g"}), 5)]),
    "spread": PORTED["spread"],
}


@pytest.mark.parametrize("what", sorted(CYCLE_PORTED))
def test_cycle_affinity_matches_jax(what):
    """A cycle over a store whose gang carries inter-pod terms binds on
    the port what it binds on the JAX package, and the gang runs."""
    import volcano_tpu
    import volcano_tpu.api
    from volcano_tpu.scheduler import Scheduler as JaxScheduler

    from volcano_tpu_torch.scheduler import Scheduler

    jstore = _store_with(volcano_tpu, **CYCLE_PORTED[what](volcano_tpu.api))
    jstore.pipeline = False
    JaxScheduler(jstore, conf_str=_conf()).run_once()
    store = _store_with(**CYCLE_PORTED[what](volcano_tpu_torch.api))
    Scheduler(store, conf_str=_conf(), device="cpu").run_once()
    assert len(store.binder.binds) == 2
    assert dict(store.binder.binds) == dict(jstore.binder.binds)


def test_rebalance_runs_with_host_victim_walk_selected(monkeypatch):
    """VOLCANO_TPU_EVICT_DEVICE=0 selects the preempt / reclaim host walk;
    the rebalance lane ignores the switch (as the JAX package's does) and
    plans, proves and commits through the what-if engine under it."""
    from volcano_tpu_torch.cache import FakeBinder
    from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.synth import fabric_cluster

    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "0")
    monkeypatch.setenv("VOLCANO_TPU_REBALANCE_DRAIN_CAP", "64")
    store = fabric_cluster(binder=FakeBinder())
    Scheduler(store, conf_str=REBALANCE_SCHEDULER_CONF,
              device="cpu").run_once()
    assert store.migrations.committed_plans == 1
    assert sum(p.deleting for p in store.pods.values()) == 2


@pytest.mark.parametrize("attr,value", [
    pytest.param("solve_mesh", object(), id="solve_mesh-value1"),
])
def test_store_slots_not_ported_raise(attr, value):
    store = _cycle_store()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        setattr(store, attr, value)


def test_store_takes_a_port_remote_solver_and_mesh_still_raises(
        monkeypatch):
    """``remote_solver`` is a plain slot that takes the port's
    ``RemoteSolver`` (or ``SolverPool``), and a cycle on such a store
    runs without raising; ``check_ported`` still raises for a mesh."""
    import threading

    from volcano_tpu_torch.fastpath import FastCycle
    from volcano_tpu_torch.solver_pool import SolverPool
    from volcano_tpu_torch.solver_service import RemoteSolver, SolverServer

    server = SolverServer(port=0, device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        store = _cycle_store()
        client = RemoteSolver(f"127.0.0.1:{server.port}", timeout=60.0)
        store.remote_solver = client
        assert store.remote_solver is client
        from volcano_tpu_torch.scheduler import Scheduler

        sched = Scheduler(store, conf_str=_conf(), device="cpu")
        sched.run_once()
        store.flush_binds()
        assert store.binder.binds and client.frame_counts["full"] == 1
        FastCycle(store, sched._load_conf(), device="cpu").check_ported()
        pool = SolverPool([f"127.0.0.1:{server.port}"] * 2)
        store.remote_solver = pool
        assert store.remote_solver is pool
        monkeypatch.setenv("VOLCANO_TPU_MESH", "2")
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            FastCycle(store, sched._load_conf(),
                      device="cpu").check_ported()
        pool.close()
        client.close()
        store.close()
    finally:
        server.shutdown()


_SOLVER_CHILD = r'''
import threading
from volcano_tpu_torch.solver_service import SolverServer, RemoteSolver
from volcano_tpu_torch.synth import synthetic_cluster
from volcano_tpu_torch.scheduler import Scheduler
server = SolverServer(port=0, device="cpu")
threading.Thread(target=server.serve_forever, daemon=True).start()
store = synthetic_cluster(n_nodes=8, n_pods=32, gang_size=4, seed=5)
store.pipeline = True
store.remote_solver = RemoteSolver(f"127.0.0.1:{server.port}", timeout=60)
sched = Scheduler(store, device="cpu")
for _ in range(3):
    sched.run_once()
store.flush_binds()
assert len(store.binder.binds) == 32
assert store.remote_solver.frame_counts["full"] >= 1
store.close()
store.remote_solver.close()
server.shutdown()
assert not any(k.split(".")[0] in ("jax", "jaxlib", "volcano_tpu")
               for k in sys.modules)
print("ok")
'''


def test_solver_service_runs_with_jax_and_reference_blocked():
    """The solver child, its client, the codec and a pipelined remote
    cycle run with ``jax``, ``jaxlib`` and ``volcano_tpu`` unimportable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER + "import sys\n" + _SOLVER_CHILD],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_pipelined_cycle_binds_like_jax():
    """A pipelined run_once() (store.pipeline) no longer raises: its
    second cycle binds what the JAX package's pipelined cycles bind."""
    import volcano_tpu.synth
    from volcano_tpu.scheduler import Scheduler as JaxScheduler

    from volcano_tpu_torch.scheduler import Scheduler

    jstore = volcano_tpu.synth.synthetic_cluster(n_nodes=4, n_pods=8,
                                                 gang_size=2)
    jstore.pipeline = True
    jsched = JaxScheduler(jstore, conf_str=_conf())
    store = _cycle_store()
    store.pipeline = True
    sched = Scheduler(store, conf_str=_conf(), device="cpu")
    for _ in range(2):
        jsched.run_once()
        sched.run_once()
    jstore.flush_binds()
    store.flush_binds()
    assert len(store.binder.binds) == 8
    assert dict(store.binder.binds) == dict(jstore.binder.binds)
    jstore.close()
    store.close()


def test_store_accepts_async_bind():
    """store.async_bind = True is accepted and queues the cycle's binds
    on the bind dispatcher."""
    from volcano_tpu_torch.cache.bindqueue import BindDispatcher
    from volcano_tpu_torch.scheduler import Scheduler

    store = _cycle_store()
    store.async_bind = True
    assert store.async_bind is True
    Scheduler(store, conf_str=_conf(), device="cpu").run_once()
    assert isinstance(store._bind_dispatcher, BindDispatcher)
    assert store.flush_binds(10)
    assert len(store.binder.binds) == 8
    store.close()


@pytest.mark.parametrize("fail", [False, True])
def test_store_evict_marks_releasing_or_reverts(fail):
    """The object session's eviction: the pod turns Releasing and reaches
    the evictor; a failed dispatch reverts the record (cache.go:461-466)."""
    from volcano_tpu_torch.cache import FakeEvictor

    class Failing(FakeEvictor):
        def evict(self, pod):
            raise RuntimeError("evict refused")

    store = _cycle_store()
    store.evictor = Failing() if fail else FakeEvictor()
    pod = next(iter(store.pods.values()))
    task = store.jobs[next(iter(store.jobs))].tasks[pod.uid]
    store.evict(task, "test")
    assert store.pods[pod.uid].deleting is not fail
    reason = "EvictFailed" if fail else "Evict"
    assert any(e["reason"] == reason
               for e in store.events_for(f"Pod/{pod.namespace}/{pod.name}"))
    gone = type("Gone", (), {"uid": "no-such-pod"})()
    with pytest.raises(KeyError):
        store.evict(gone, "test")


def test_unsupported_conf_raises_on_first_load():
    """A conf the parser does not read raises from the first cycle: it is
    never swapped for the default conf."""
    from volcano_tpu_torch.scheduler import Scheduler

    store = _cycle_store()
    sched = Scheduler(store, conf_str=_conf() + "shuffle: true\n",
                      device="cpu")
    with pytest.raises(ValueError, match="unknown keys"):
        sched.run_once()
    assert not store.binder.binds


def test_conf_hot_reload_keeps_last_good(tmp_path):
    """After a conf has parsed, a broken reload keeps the last good one."""
    from volcano_tpu_torch.scheduler import Scheduler

    path = tmp_path / "conf.yaml"
    path.write_text(_conf())
    store = _cycle_store()
    sched = Scheduler(store, conf_path=str(path), device="cpu")
    sched.run_once()
    first = len(store.binder.binds)
    assert first
    path.write_text(_conf() + "shuffle: true\n")
    assert sched._load_conf() is sched._last_conf
    sched.run_once()
    assert len(store.binder.binds) == first


def test_run_and_stop_loop():
    """``run`` starts the periodic loop, which binds the pending pods;
    ``stop`` joins it and a second ``run`` restarts it."""
    import time

    from volcano_tpu_torch.scheduler import Scheduler

    store = _cycle_store()
    sched = Scheduler(store, conf_str=_conf(), schedule_period=0.01,
                      device="cpu")
    for _ in range(2):
        sched.run()
        deadline = time.time() + 60
        while not store.binder.binds and time.time() < deadline:
            time.sleep(0.01)
        sched.stop()
        assert sched._thread is None
    assert len(store.binder.binds) == 8


OBS_AND_HA = ("obs/slo.py", "obs/audit.py", "obs/journey.py",
              "obs/export.py", "persistence.py", "ha.py", "obs/lockdep.py",
              "obs/annotations.py")


@pytest.mark.parametrize("module", OBS_AND_HA)
def test_observability_and_ha_modules_import_no_jax(module):
    path = PORT / module
    assert path.is_file(), module
    names = list(_imported_names(path))
    assert not any(n.split(".")[0] in ("jax", "jaxlib", "volcano_tpu")
                   for n in names), (module, names)


_OBS_HA = r'''
import os, sys, tempfile
os.environ["VOLCANO_TPU_AUDIT_SAMPLE"] = "1"
from volcano_tpu_torch.cache import ClusterStore
from volcano_tpu_torch.ha import LeaderElector
from volcano_tpu_torch.obs import export
from volcano_tpu_torch.persistence import load_store, save_store
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.synth import synthetic_cluster
assert ClusterStore().auditor is not None
store = synthetic_cluster(n_nodes=8, n_pods=32, gang_size=4)
assert store.auditor.slo is not None and store.journey is not None
d = tempfile.mkdtemp()
save_store(store, os.path.join(d, "ckpt"))
again = load_store(os.path.join(d, "ckpt"))
for s in (store, again):
    Scheduler(s, device="cpu").run_once()
assert dict(store.binder.binds) == dict(again.binder.binds)
assert len(store.binder.binds) == 32
assert store.auditor.total_anomalies() == 0
assert store.auditor.audit_stats()["sampled_cycles"] == 1
assert store.journey.conservation_check(list(store.pods)) == []
export.write_trace(os.path.join(d, "t.json"), store.flight.recent(),
                   journey=store.journey.trace_rows())
el = LeaderElector(os.path.join(d, "lease"), identity="x")
assert el.try_acquire()
el.stop()
assert not any(k.split(".")[0] in ("jax", "jaxlib", "volcano_tpu")
               for k in sys.modules)
print("ok")
'''


def test_observability_and_ha_run_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER + _OBS_HA],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


_LOCKDEP = r'''
import os, sys
os.environ["VOLCANO_TPU_LOCKDEP"] = "1"
os.environ["VOLCANO_TPU_FALLBACK"] = "never"
from volcano_tpu_torch.obs import lockdep
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.synth import synthetic_cluster
store = synthetic_cluster(n_nodes=8, n_pods=32, gang_size=4)
store.pipeline = True
store.async_bind = True
assert isinstance(store._lock, lockdep._LockProxy)
sched = Scheduler(store, device="cpu")
for _ in range(3):
    sched.run_once()
assert store.flush_binds(timeout=60)
assert len(store.binder.binds) == 32
assert store.auditor.total_anomalies() == 0
assert lockdep.stats()["order_edges"] > 0
store.close()
assert not any(k.split(".")[0] in ("jax", "jaxlib", "volcano_tpu", "tools")
               for k in sys.modules)
print("ok")
'''


def test_lockdep_runs_with_jax_tools_and_reference_blocked():
    """Lockdep reads the port's own annotation parser: with ``jax``, the
    JAX package and ``tools`` (whose parser the JAX lockdep loads)
    unimportable, a pipelined store arms it and runs clean."""
    blocker = _BLOCKER.replace('("jax", "jaxlib", "volcano_tpu")',
                               '("jax", "jaxlib", "volcano_tpu", "tools")')
    assert blocker != _BLOCKER
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", blocker + _LOCKDEP],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
