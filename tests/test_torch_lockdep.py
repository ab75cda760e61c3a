"""The port's runtime lockdep (``volcano_tpu_torch/obs/lockdep.py``,
``VOLCANO_TPU_LOCKDEP=1``): the twins of ``tests/test_lockdep.py``.

The annotation-derived enforcement must catch an injected unguarded
cross-thread write and an injected lock-order inversion, honour the static
suppression comment, stay inert behind its kill switch, and run the port's
pipelined store with asynchronous binds and a preempt conf with no report
(the JAX test runs its sharded store there; the sharded control plane is
not ported).  The flush-failure revert stamps ``mutation_seq``.

The port keeps its own annotation parser (``obs/annotations.py``): over
the port's ``LOCK_FILES`` it must give the guarded attribute -> lock map the
JAX package's parser (``tools/vclint/annotations.py``) gives over the JAX
files, for every class both have, but for the differences listed here with
their reasons.  Every test that arms lockdep resets it in a ``finally``.
"""

from __future__ import annotations

import threading

import pytest

from tools.vclint import annotations as jax_annotations

from volcano_tpu_torch.cache import (ClusterStore, FakeBinder,
                                     FakeEvictor)
from volcano_tpu_torch.cache.interface import EvictFailure
from volcano_tpu_torch.obs import annotations as port_annotations
from volcano_tpu_torch.obs import lockdep
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.sim import ClusterSimulator
from volcano_tpu_torch.synth import synthetic_cluster

EVICT_CONF = """
actions: "enqueue, allocate, preempt, reclaim, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""


def _lockdep_anomalies(store):
    with store.auditor._lock:
        return [a.to_dict() for a in store.auditor._ring
                if a.reason in ("lockdep-violation", "lock-order-cycle")]


# ------------------------------------------------------- kill switch
# Runs first in this file: the probe never armed in this process before
# an enabling test below turns it on.


def test_kill_switch_leaves_store_unwrapped(monkeypatch):
    monkeypatch.delenv("VOLCANO_TPU_LOCKDEP", raising=False)
    lockdep.reset()
    store = ClusterStore()
    try:
        assert lockdep.stats()["active"] is False
        assert not isinstance(store._lock, lockdep._LockProxy)
        assert "_vclockdep_armed" not in store.__dict__
        if not lockdep._installed:
            assert not any(
                isinstance(v, lockdep._GuardedDescriptor)
                for v in vars(ClusterStore).values()
            )
        # Unguarded access reports nothing with the switch off.
        store._solve_seq = 7
        _ = store._solve_seq
        assert _lockdep_anomalies(store) == []
    finally:
        store.close()


# -------------------------------------------------------- fixtures


@pytest.fixture()
def armed_store(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_LOCKDEP", "1")
    store = ClusterStore()
    try:
        assert lockdep.stats()["active"] is True
        assert isinstance(store._lock, lockdep._LockProxy)
        yield store
    finally:
        store.close()
        lockdep.reset()


# ------------------------------------------------------- violations


def test_injected_unguarded_cross_thread_write_caught(armed_store):
    store = armed_store

    def rogue():
        store._solve_seq = 99  # guarded-by _lock, no lock held

    t = threading.Thread(target=rogue, name="rogue-writer")
    t.start()
    t.join(30)
    assert not t.is_alive()

    got = _lockdep_anomalies(store)
    assert len(got) == 1
    detail = got[0]["detail"]
    assert got[0]["reason"] == "lockdep-violation"
    assert detail["attribute"] == "_solve_seq"
    assert detail["lock"] == "_lock"
    assert detail["access"] == "write"
    assert detail["thread"] == "rogue-writer"
    assert detail["class"] == "volcano_tpu_torch.cache.store.ClusterStore"
    assert any("test_torch_lockdep" in fr for fr in detail["stack"])
    # The same broken site reports once, not per hit.
    t2 = threading.Thread(target=rogue, name="rogue-writer-2")
    t2.start()
    t2.join(30)
    assert len(_lockdep_anomalies(store)) == 1


def test_guarded_access_under_lock_is_clean(armed_store):
    store = armed_store
    with store._lock:
        store._solve_seq = 3
        assert store._solve_seq == 3
    assert lockdep.held_locks() == {}
    assert _lockdep_anomalies(store) == []


def test_injected_lock_order_inversion_caught(armed_store):
    store = armed_store

    def ab():
        with store._lock:
            with store._events_lock:
                pass

    def ba():
        with store._events_lock:
            with store._lock:
                pass

    for name, fn in (("t-ab", ab), ("t-ba", ba)):
        t = threading.Thread(target=fn, name=name)
        t.start()
        t.join(30)
        assert not t.is_alive()

    cycles = [a for a in _lockdep_anomalies(store)
              if a["reason"] == "lock-order-cycle"]
    assert len(cycles) == 1
    detail = cycles[0]["detail"]
    assert {detail["held"], detail["acquiring"]} == {
        "_lock", "_events_lock"}
    assert detail["cycle"][0] == detail["cycle"][-1]
    assert set(detail["cycle"]) == {"_lock", "_events_lock"}


def test_static_suppression_honored_at_runtime(armed_store):
    store = armed_store
    # vclint: disable=VCL101 -- reviewed unguarded probe (this test)
    _ = store.bind_backoff
    assert _lockdep_anomalies(store) == []
    # ... and the same read WITHOUT the annotation is a violation.
    _ = store.bind_backoff
    got = _lockdep_anomalies(store)
    assert len(got) == 1
    assert got[0]["detail"]["attribute"] == "bind_backoff"


def test_walk_skips_tensors_and_foreign_objects(armed_store):
    """``attach`` enters only the port's own objects: a tensor, a numpy
    array and a JAX-package-free foreign object keep their own locks."""
    import numpy as np
    import torch

    class Foreign:
        pass

    foreign = Foreign()
    foreign._lock = threading.Lock()
    store = armed_store
    store.cycle_feed = {"t": torch.zeros(4), "a": np.zeros(4),
                        "f": foreign}
    lockdep.attach(store)
    assert not isinstance(foreign._lock, lockdep._LockProxy)
    assert isinstance(store.mirror.audit._lock, lockdep._LockProxy)


# ------------------------------------------------- enforcement smoke


def _serving_bound(store, n):
    with store._lock:
        return sum(1 for p in store.pods.values()
                   if p.name.startswith("serving-") and p.node_name) >= n


def test_pipelined_store_runs_clean_under_enforcement(monkeypatch):
    """The pipelined store with asynchronous binds schedules a synthetic
    cluster end to end, and a pipelined preempt plan commits, with
    enforcement on and no report -- the solve worker and the bind
    dispatcher on their own threads throughout."""
    monkeypatch.setenv("VOLCANO_TPU_LOCKDEP", "1")
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    stores = []
    try:
        store = synthetic_cluster(n_nodes=8, n_pods=32, gang_size=4)
        stores.append(store)
        store.pipeline = True
        store.async_bind = True
        sched = Scheduler(store, device="cpu")
        for _ in range(4):
            sched.run_once()
        assert store.flush_binds(timeout=30)
        assert _lockdep_anomalies(store) == []
        with store._lock:
            assert all(p.node_name for p in store.pods.values())

        store = ClusterStore(binder=FakeBinder(), evictor=FakeEvictor())
        stores.append(store)
        ClusterSimulator.priority_tier_workload(store, workers=8,
                                                serving_tasks=4)
        store.pipeline = True
        store.async_bind = True
        sched = Scheduler(store, conf_str=EVICT_CONF, device="cpu")
        sim = ClusterSimulator(store, grace_steps=2)
        for _ in range(12):
            sched.run_once()
            assert store.flush_binds(timeout=30)
            sim.step()
            if _serving_bound(store, 4):
                break
        assert _serving_bound(store, 4)
        assert len(store.evictor.evicts) >= 4
        assert _lockdep_anomalies(store) == []
        st = lockdep.stats()
        assert st["active"] and st["order_edges"] > 0
        assert st["violations"] == 0 and st["order_cycles"] == 0
    finally:
        for s in stores:
            s.close()
        lockdep.reset()


# ------------------------------------- flush revert mutation_seq fix


class _AlwaysFailEvictor:
    """Evictor whose batch dispatch rejects every key."""

    def __init__(self):
        self.batches = 0

    def evict_keys(self, keys, reason="preempted"):
        self.batches += 1
        raise EvictFailure(list(keys))

    def evict(self, pod):
        raise EvictFailure([f"{pod.namespace}/{pod.name}"])


def _flush_revert_run(pkg, monkeypatch):
    """``priority_tier_workload(8 workers, a 4-task serving gang)`` under
    the evict conf, every eviction rejected: the cycles until the first
    rejected batch, and each flush's mutation_seq delta."""
    import importlib

    cache = importlib.import_module(f"{pkg}.cache")
    sim = importlib.import_module(f"{pkg}.sim")
    sched_mod = importlib.import_module(f"{pkg}.scheduler")
    EvictState = importlib.import_module(f"{pkg}.fastpath_evict").EvictState
    deltas = []
    orig_flush = EvictState.flush

    def spy(self):
        before = self.cyc.m.mutation_seq
        orig_flush(self)
        if self.evicted_rows:
            deltas.append(self.cyc.m.mutation_seq - before)

    monkeypatch.setattr(EvictState, "flush", spy)
    store = cache.ClusterStore(binder=cache.FakeBinder(),
                               evictor=cache.FakeEvictor())
    sim.ClusterSimulator.priority_tier_workload(store, workers=8,
                                                serving_tasks=4)
    evictor = _AlwaysFailEvictor()
    store.evictor = evictor
    kw = {} if pkg == "volcano_tpu" else {"device": "cpu"}
    sched = sched_mod.Scheduler(store, conf_str=EVICT_CONF, **kw)
    try:
        for _ in range(6):
            sched.run_once()
            if evictor.batches:
                break
        with store._lock:
            deleting = [p.name for p in store.pods.values() if p.deleting]
    finally:
        store.close()
        monkeypatch.setattr(EvictState, "flush", orig_flush)
    return evictor.batches, deltas, deleting


def test_flush_failure_revert_stamps_mutation_seq(monkeypatch):
    """When evictions fail and flush() reverts the victims to Running,
    the revert itself must advance mutation_seq -- the action loop
    stamped BEFORE flush ran, so without the fresh stamp the pipelined
    staleness guard would validate an in-flight solve against pre-revert
    state.  The device evict lane (the port's only one) on a store where
    it plans a wave; the JAX package on the same store and lane."""
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    got = _flush_revert_run("volcano_tpu_torch", monkeypatch)
    want = _flush_revert_run("volcano_tpu", monkeypatch)
    assert got == want
    batches, deltas, deleting = got
    assert batches >= 1, "preempt never dispatched evictions"
    # All victims reverted (nothing left terminating) ...
    assert deleting == []
    # ... and the revert batch stamped the mutation counter.
    assert deltas and all(d >= 1 for d in deltas), deltas


# ------------------------------------------------- the annotation parser


def _guarded_maps(ann, files):
    out = {}
    for rel in files:
        with open(rel) as f:
            model = ann.build_model(rel, f.read())
        assert model.annotation_errors == [], (rel, model.annotation_errors)
        for info in model.classes:
            if info.guarded:
                out[info.name] = {k: (g.lock, g.any_receiver)
                                  for k, g in info.guarded.items()}
    return out


# The JAX files whose classes the port has no counterpart of: the sharded
# control plane (ShardOwnershipTable; ROADMAP.md queue 1, multi-GPU).
JAX_ONLY_FILES = {"volcano_tpu/shard.py"}
# Guarded attributes of a shared class that exist on one side only.
JAX_ONLY_ATTRS = {
    # The per-shard parked solves, the shard table and the mesh plane
    # cache: the sharded control plane and the device mesh (queue 1,
    # multi-GPU) are not ported, and the port's store has no such slots.
    "ClusterStore": {"_shard_inflight", "shard_table", "_mesh_plane_cache"},
}
# The port's journey has a `# guarded-by:` the JAX file lacks (and the
# JAX LOCK_FILES leaves journey.py out): its per-kind event counters.
PORT_ONLY = {"JourneyLog": {"_kind_counts": ("_lock", False)}}


def test_port_lock_files_are_the_jax_counterparts():
    want = [f.replace("volcano_tpu/", "volcano_tpu_torch/", 1)
            for f in jax_annotations.LOCK_FILES if f not in JAX_ONLY_FILES]
    want.append("volcano_tpu_torch/obs/journey.py")
    assert port_annotations.LOCK_FILES == want
    assert port_annotations.KNOWN_LOCKS == jax_annotations.KNOWN_LOCKS


def test_port_parser_gives_the_jax_guarded_map():
    jax_files = [f for f in jax_annotations.LOCK_FILES
                 if f not in JAX_ONLY_FILES]
    want = _guarded_maps(jax_annotations, jax_files)
    got = _guarded_maps(port_annotations, port_annotations.LOCK_FILES)
    assert set(got) - set(want) == set(PORT_ONLY)
    assert set(want) - set(got) == set()
    for cls, attrs in want.items():
        exp = {k: v for k, v in attrs.items()
               if k not in JAX_ONLY_ATTRS.get(cls, ())}
        assert got[cls] == exp, cls
    for cls, attrs in PORT_ONLY.items():
        assert got[cls] == attrs


@pytest.mark.parametrize("source", [
    "class A:\n    def __init__(self):\n"
    "        self.x = 0  # guarded-by: _lock\n",
    "class A:\n    def __init__(self):\n        # guarded-by: _lock\n"
    "        self.x = 0\n",
    "class A:\n    def __init__(self):\n"
    "        self.x = 0  # guarded-by: _lock (any-receiver)\n",
    "class A:\n    def f(self):\n        pass\n"
    "# guarded-by: _lock\n",
    "class A:\n    # vclint: class-holds: _lock\n"
    "    # holds: _lock, _events_lock\n    def f(self):\n        pass\n",
])
def test_port_parser_equals_jax_parser(source):
    a = jax_annotations.build_model("x.py", source)
    b = port_annotations.build_model("x.py", source)
    assert a.annotation_errors == b.annotation_errors
    assert [(c.name, {k: (g.lock, g.any_receiver, g.line)
                      for k, g in c.guarded.items()},
             c.class_holds, c.holds) for c in a.classes] == \
        [(c.name, {k: (g.lock, g.any_receiver, g.line)
                   for k, g in c.guarded.items()},
          c.class_holds, c.holds) for c in b.classes]


def _holds(ann, rel):
    with open(rel) as f:
        model = ann.build_model(rel, f.read())
    return (model.fn_holds,
            {c.name: (c.class_holds, c.holds) for c in model.classes})


@pytest.mark.parametrize("rel,fns,classes", [
    # whatif: the eight module functions that run under the store lock.
    ("whatif.py", True, ()),
    # FastCycle runs under run_cycle_fast's store lock.
    ("fastpath.py", False, ("FastCycle",)),
    # EvictState and the host victim walk's FastEvictor.
    ("fastpath_evict.py", False, ("EvictState", "FastEvictor")),
    ("ops/devsnap.py", False, ("DeviceSnapshot",)),
    ("cache/store.py", False, ("ClusterStore",)),
])
def test_holds_annotations_match_jax(rel, fns, classes):
    jf, jc = _holds(jax_annotations, f"volcano_tpu/{rel}")
    pf, pc = _holds(port_annotations, f"volcano_tpu_torch/{rel}")
    if fns:
        assert pf == jf and len(pf) == 8
    for cls in classes:
        assert pc[cls][0] == jc[cls][0]
        assert {k: v for k, v in jc[cls][1].items()
                if k in pc[cls][1]} == pc[cls][1]
        assert pc[cls][0] or pc[cls][1]
