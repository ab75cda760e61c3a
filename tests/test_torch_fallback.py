"""The port's fast-path fallback to the object session, against the JAX
package's (``VOLCANO_TPU_FALLBACK``: ``auto`` / ``always`` / ``never``),
and the per-cycle device trace (``VOLCANO_TPU_TRACE_DIR``).

The twins of ``tests/test_scheduler_e2e.py``'s fallback guard tests and of
``tests/test_fastpath.py::test_enqueue_transition_survives_failed_cycle``,
given the same injection (the fast path raising a non-crash error): the
same binds and PodGroup phases.  A pipelined store whose parked solve is
abandoned on the fallback binds no pod twice.  The trace writes one
Chrome-trace JSON a cycle; an unwritable directory or a profiler already
running logs a warning and the cycle still binds every pod.

``tests/conftest.py`` sets ``VOLCANO_TPU_FALLBACK=never`` for the suite;
the tests that need another mode set it with ``monkeypatch``.
"""

import glob
import itertools
import json
import logging
import os

import pytest
import torch

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.fastpath as jax_fp
import volcano_tpu.synth  # noqa: F401
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.fastpath as port_fp
import volcano_tpu_torch.synth  # noqa: F401
from volcano_tpu_torch.cache.mirror import StoreMirror
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _sched(pkg, store):
    if pkg is volcano_tpu:
        return JaxScheduler(store)
    return PortScheduler(store, device="cpu")


def _fp(pkg):
    return jax_fp if pkg is volcano_tpu else port_fp


def _small(pkg, **kw):
    _reset_uid_counters()
    kw.setdefault("n_nodes", 4)
    kw.setdefault("n_pods", 8)
    kw.setdefault("gang_size", 2)
    return pkg.synth.synthetic_cluster(**kw)


def _boom(*a, **k):
    raise RuntimeError("device exploded")


def _guard_run(pkg, monkeypatch, mode):
    monkeypatch.setattr(_fp(pkg), "run_cycle_fast", _boom)
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", mode)
    store = _small(pkg)
    try:
        _sched(pkg, store).run_once()
        return {"binds": dict(store.binder.binds),
                "path": store.flight.last().path,
                "phases": {u: pg.status.phase
                           for u, pg in sorted(store.pod_groups.items())}}
    finally:
        store.close()
        monkeypatch.undo()


@pytest.mark.parametrize("mode", ["auto", "always"])
def test_fastpath_failure_falls_back_equal_jax(mode, monkeypatch):
    """Small clusters fall back to the object session when the fast path
    fails, and the object session binds as the JAX package's does."""
    want = _guard_run(volcano_tpu, monkeypatch, mode)
    got = _guard_run(volcano_tpu_torch, monkeypatch, mode)
    assert got == want
    assert len(got["binds"]) == 8
    assert got["path"] == "object"


def test_fastpath_failure_never_reraises(monkeypatch):
    monkeypatch.setattr(port_fp, "run_cycle_fast", _boom)
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "never")
    store = _small(volcano_tpu_torch)
    try:
        with pytest.raises(RuntimeError, match="device exploded"):
            PortScheduler(store, device="cpu").run_once()
        assert store.binder.binds == {}
    finally:
        store.close()


@pytest.mark.parametrize("mode,raises", [("auto", True), ("always", False)])
def test_fastpath_failure_no_fallback_at_hyperscale(mode, raises,
                                                    monkeypatch):
    """auto refuses the object-session fallback when pending tasks x nodes
    exceeds FALLBACK_MAX_WORK (an hours-long Python walk); always falls
    back regardless."""
    monkeypatch.setattr(port_fp, "run_cycle_fast", _boom)
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", mode)
    # 8 real pending tasks x a faked 10M-node cluster exceeds the
    # pending x nodes work bound.
    monkeypatch.setattr(StoreMirror, "n_nodes",
                        property(lambda self: 10_000_000))
    store = _small(volcano_tpu_torch)
    try:
        sched = PortScheduler(store, device="cpu")
        assert sched.FALLBACK_MAX_WORK == JaxScheduler.FALLBACK_MAX_WORK
        if raises:
            with pytest.raises(RuntimeError, match="device exploded"):
                sched.run_once()
            assert sched._fallback_sensible() is False
        else:
            sched.run_once()
            assert len(store.binder.binds) == 8
    finally:
        store.close()


def test_fallback_sensible_counts_pending_times_nodes(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "auto")
    store = _small(volcano_tpu_torch, n_nodes=4, n_pods=8)
    try:
        sched = PortScheduler(store, device="cpu")
        assert sched._fallback_sensible()  # 8 x 4
        monkeypatch.setattr(type(sched), "FALLBACK_MAX_WORK", 31)
        assert not sched._fallback_sensible()
        monkeypatch.setattr(type(sched), "FALLBACK_MAX_WORK", 32)
        assert sched._fallback_sensible()
    finally:
        store.close()


def _enqueue_run(pkg, monkeypatch):
    api = pkg.api
    store = pkg.cache.ClusterStore()
    store.add_node(api.Node(name="n0", allocatable={"cpu": "4",
                                                    "memory": "8Gi"}))
    store.add_pod_group(api.PodGroup(name="g", min_member=1,
                                     min_resources={"cpu": "1"}))
    phases = []
    orig_update = store.status_updater.update_pod_group
    store.status_updater.update_pod_group = (
        lambda pg: (phases.append(pg.status.phase), orig_update(pg))[1]
    )
    fp = _fp(pkg)
    orig_alloc = fp.FastCycle._allocate
    calls = {"n": 0}

    def failing_alloc(self):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device failure after enqueue")
        return orig_alloc(self)

    monkeypatch.setattr(fp.FastCycle, "_allocate", failing_alloc)
    # The production fallback path, by design.
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "auto")
    try:
        sched = _sched(pkg, store)
        sched.run_once()  # fast cycle fails post-enqueue; object path
        first = list(phases)
        phases.clear()
        # A later FAST cycle must persist the still-pending transition
        # even though the phase compares equal.
        store._phase_dirty_uids.add("default/g")
        sched.run_once()
        return first, list(phases), set(store._phase_dirty_uids)
    finally:
        store.close()
        monkeypatch.undo()


def test_enqueue_transition_survives_failed_cycle(monkeypatch):
    """A cycle that fails AFTER enqueue's in-place Inqueue mutation must
    not strand the transition: the next successful cycle still persists
    it."""
    want = _enqueue_run(volcano_tpu, monkeypatch)
    got = _enqueue_run(volcano_tpu_torch, monkeypatch)
    assert got == want
    first, later, dirty = got
    assert "Inqueue" in later or "Running" in later, later
    assert dirty == set()


def _pipelined_fallback(pkg, monkeypatch):
    """Cycle 1 dispatches a pipelined solve; cycle 2's fast path fails
    before its fetch, so the parked solve is abandoned and the object
    session places every pod; cycle 3 is a clean fast cycle."""
    store = _small(pkg, n_nodes=8, n_pods=32, gang_size=4)
    store.pipeline = True
    store.async_bind = True
    fp = _fp(pkg)
    sched = _sched(pkg, store)
    try:
        sched.run_once()
        assert store._inflight_solve is not None
        real_run = fp.run_cycle_fast

        def fail(store_, conf, *a, **k):
            raise RuntimeError("device exploded")

        monkeypatch.setattr(fp, "run_cycle_fast", fail)
        monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "auto")
        sched.run_once()  # falls back; the parked solve is abandoned
        parked = store._inflight_solve
        path = store.flight.last().path
        monkeypatch.setattr(fp, "run_cycle_fast", real_run)
        sched.run_once()
        store.flush_binds(timeout=30)
        with store._lock:
            all_bound = all(p.node_name for p in store.pods.values())
        channel = store.binder.channel  # every bind, in order
        return {"parked": parked, "path": path, "all_bound": all_bound,
                "binds": dict(store.binder.binds),
                "twice": len(channel) - len(set(channel))}
    finally:
        store.close()
        monkeypatch.undo()


def test_pipelined_solve_abandoned_on_fallback(monkeypatch):
    want = _pipelined_fallback(volcano_tpu, monkeypatch)
    got = _pipelined_fallback(volcano_tpu_torch, monkeypatch)
    assert got == want
    assert got["parked"] is None and got["path"] == "object"
    assert got["all_bound"] and got["twice"] == 0
    assert len(got["binds"]) == 32


# ------------------------------------------------------------ the trace


def _trace_cycle(monkeypatch, trace_dir, outer=False):
    monkeypatch.setenv("VOLCANO_TPU_TRACE_DIR", str(trace_dir))
    store = _small(volcano_tpu_torch, n_nodes=8, n_pods=32, gang_size=4)
    try:
        sched = PortScheduler(store, device="cpu")
        if outer:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as p:
                sched.run_once()
            assert p.key_averages()  # the caller's trace survived
        else:
            sched.run_once()
        return len(store.binder.binds)
    finally:
        store.close()


def test_trace_dir_writes_one_trace_a_cycle(tmp_path, monkeypatch):
    d = tmp_path / "traces"
    assert _trace_cycle(monkeypatch, d) == 32
    files = glob.glob(str(d / "cycle-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert any("aten::" in str(n) for n in names)
    assert _trace_cycle(monkeypatch, d) == 32
    assert len(glob.glob(str(d / "cycle-*.json"))) == 2


def test_trace_dir_unwritable_still_binds(tmp_path, monkeypatch, caplog):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    with caplog.at_level(logging.WARNING, "volcano_tpu_torch.scheduler"):
        assert _trace_cycle(monkeypatch, blocker / "traces") == 32
    assert any("device trace" in r.getMessage() for r in caplog.records)
    assert not os.path.isdir(blocker)


def test_trace_dir_under_an_outer_profiler_still_binds(tmp_path,
                                                       monkeypatch,
                                                       caplog):
    d = tmp_path / "traces"
    with caplog.at_level(logging.WARNING, "volcano_tpu_torch.scheduler"):
        assert _trace_cycle(monkeypatch, d, outer=True) == 32
    assert any("already running" in r.getMessage() for r in caplog.records)
    assert glob.glob(str(d / "cycle-*.json")) == []


def test_trace_dir_unset_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("VOLCANO_TPU_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    store = _small(volcano_tpu_torch)
    try:
        PortScheduler(store, device="cpu").run_once()
    finally:
        store.close()
    assert os.listdir(tmp_path) == []
