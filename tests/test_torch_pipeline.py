"""The port's pipelined sessions against the JAX package's.

A pipelined cycle dispatches its wave solve without waiting for it and
commits it at the top of the next cycle, behind a staleness guard against
the store mutations that landed in between (``volcano_tpu_torch/
pipeline.py``; the JAX package's ``pipeline.py``).  The port runs the
solve on a worker thread (its own CUDA stream on the card; on the CPU the
same thread, so these tests exercise the overlap).

Twins: the JAX ``Scheduler`` and the port's ``Scheduler(device="cpu")``
with ``store.pipeline = True`` on the same store, the same seed and the
same mutation script; after every cycle the binds (pod -> node), the drop
counts by reason of the staleness guard and the flight-record ids
(``dispatched_solve_id``, ``committed_solve_id``,
``mutation_seq_at_dispatch``) must be equal -- exactly, placements are
integers.  The twins of ``tests/test_pipeline.py`` that do not need the
fast path's fallback are here, the three cases of the ``"remote"``
payload kind among them (lost replies failing the cycle past the cap, a
pipelined remote deployment over a solver child process, the remote
protocol's one outstanding solve); the pipelined version of
``tests/test_torch_cycle.py``'s 10-cycle churn run, pipelined preempt and
rebalance plans, and the port's own traps: inputs owned by the worker, no
resident plane written under an in-flight solve, a worker failure failing
the fetching cycle, exact per-solve launch counts and ``LAST_TWOPHASE``
records under two launching threads.
"""

import itertools
import random
import threading

import numpy as np
import pytest
import torch

from test_torch_fixtures import churn as _churn
from test_torch_fixtures import mirror_state as _mirror_state
from test_torch_fixtures import repend_feed as _partial_feed

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.sim
import volcano_tpu.synth
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.sim
import volcano_tpu_torch.synth
from volcano_tpu_torch import pipeline
from volcano_tpu_torch.ops import kernels
from volcano_tpu_torch.ops import wave as port_wave
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

ST_PENDING = 1  # TaskStatus.Pending
ST_BOUND = 16  # TaskStatus.Bound


@pytest.fixture(autouse=True)
def _lanes_on(monkeypatch):
    for k in ("VOLCANO_TPU_DEVINCR", "VOLCANO_TPU_DEVSNAP",
              "VOLCANO_TPU_PIPELINE", "VOLCANO_TPU_EVICT_CAP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    # The suite's setting (tests/conftest.py), pinned: a test that ran
    # earlier in the same worker may have unset it, and under the default
    # ("auto") the errors these tests expect fall back instead.
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "never")


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _sched(pkg, store, conf=None):
    if pkg is volcano_tpu:
        return JaxScheduler(store, conf_str=conf)
    return PortScheduler(store, conf_str=conf, device="cpu")


def _small(pkg, seed=7, **kw):
    kw.setdefault("n_nodes", 8)
    kw.setdefault("n_pods", 32)
    kw.setdefault("gang_size", 4)
    return pkg.synth.synthetic_cluster(seed=seed, **kw)


def _record(store) -> dict:
    """What a twin cycle must agree on."""
    store.flush_binds()
    rec = store.flight.last()
    return {
        "binds": dict(store.binder.binds),
        "drops": (rec.pods_dropped, dict(rec.drop_reasons)),
        "ids": (rec.dispatched_solve_id, rec.committed_solve_id,
                rec.mutation_seq_at_dispatch),
        "mirror": _mirror_state(store),
    }


def _run(pkg, make, cycles, script=None, pipe=True, conf=None):
    """``cycles`` cycles of ``make(pkg)`` with ``script(pkg, store, step)``
    run after each; the per-cycle records."""
    _reset_uid_counters()
    store = make(pkg)
    store.pipeline = pipe
    sched = _sched(pkg, store, conf)
    trace = []
    for step in range(cycles):
        sched.run_once()
        trace.append(_record(store))
        if script is not None:
            script(pkg, store, step)
    store.close()
    return trace


def _twins(make, cycles, script=None, conf=None):
    want = _run(volcano_tpu, make, cycles, script, conf=conf)
    got = _run(volcano_tpu_torch, make, cycles, script, conf=conf)
    assert len(want) == len(got) == cycles
    for step, (a, b) in enumerate(zip(want, got)):
        for field in a:
            assert a[field] == b[field], (field, step, a[field], b[field])
    return got


def _placements(store):
    return {f"{p.namespace}/{p.name}": p.node_name
            for p in store.pods.values()}


def _assert_capacity_respected(store):
    used = {}
    for p in store.pods.values():
        if p.node_name:
            used[p.node_name] = (used.get(p.node_name, 0)
                                 + p.resource_request().milli_cpu)
    for name, milli in used.items():
        node = next(n for n in store.mirror.node_objs
                    if n is not None and n.name == name)
        assert milli <= node.allocatable_resource().milli_cpu, name


# ------------------------------------------------------------- parity


def test_pipelined_matches_synchronous_one_cycle_later():
    """tests/test_pipeline.py:69: with nothing moving during the overlap
    the pipelined loop lands the synchronous loop's placements, one cycle
    later; port and JAX agree cycle by cycle."""
    got = _twins(_small, 3)
    assert got[0]["binds"] == {} and got[0]["ids"][0] == 1
    assert got[1]["ids"][1] == 1
    _reset_uid_counters()
    sync = _small(volcano_tpu_torch)
    PortScheduler(sync, device="cpu").run_once()
    assert got[1]["binds"] == dict(sync.binder.binds)
    assert len(got[1]["binds"]) == 32
    sync.close()


def test_unmutated_overlap_skips_revalidation(monkeypatch):
    """tests/test_pipeline.py:90: mutation_seq equality at the fetch
    proves nothing moved -- the commit never re-validates."""
    from volcano_tpu_torch import fastpath

    def boom(self, task_rows, assigned, node_churn=False):
        raise AssertionError("revalidation ran on an unmutated overlap")

    monkeypatch.setattr(fastpath.FastCycle, "_revalidate_inflight", boom)
    got = _twins(_small, 2)
    assert len(got[1]["binds"]) == 32


def _two_node_store(pkg, n_pods=4, node_cpu="2"):
    api = pkg.api
    store = pkg.cache.ClusterStore()
    for i in range(2):
        store.add_node(api.Node(
            name=f"n{i}",
            allocatable={"cpu": node_cpu, "memory": "8Gi", "pods": 64}))
    store.add_pod_group(api.PodGroup(name="g", min_member=1))
    for k in range(n_pods):
        store.add_pod(api.Pod(
            name=f"p{k}", annotations={api.GROUP_NAME_ANNOTATION: "g"},
            containers=[{"cpu": "1", "memory": "1Gi"}]))
    return store


def test_overlap_delete_and_competing_bind():
    """tests/test_pipeline.py:130: a delete and a competing bind during
    the overlap: no double bind, no lost pod."""
    def script(pkg, store, step):
        if step != 0:
            return
        api = pkg.api
        victim = next(p for p in store.pods.values() if p.name == "p0")
        store.delete_pod(victim)
        store.add_pod(api.Pod(
            name="intruder", annotations={api.GROUP_NAME_ANNOTATION: "g"},
            containers=[{"cpu": "1", "memory": "1Gi"}], node_name="n0"))

    got = _twins(lambda pkg: _two_node_store(pkg, 4, "2"), 4, script)
    assert got[1]["drops"][0] >= 1
    _reset_uid_counters()
    store = _two_node_store(volcano_tpu_torch, 4, "2")
    store.pipeline = True
    sched = PortScheduler(store, device="cpu")
    sched.run_once()
    script(volcano_tpu_torch, store, 0)
    for _ in range(3):
        sched.run_once()
    store.flush_binds()
    live = list(store.pods.values())
    assert len(live) == 4 and all(p.node_name for p in live)
    _assert_capacity_respected(store)
    m = store.mirror
    rows = [m.p_row[p.uid] for p in live]
    assert all(m.p_status[r] == ST_BOUND for r in rows)
    assert [m.p_node_name[r] for r in rows] == [p.node_name for p in live]
    store.close()


def test_overlap_capacity_theft_drops_rows_then_replaces():
    """tests/test_pipeline.py:172: every cpu the solve counted on is
    stolen; the guard drops the rows (capacity-taken), nothing
    oversubscribes."""
    def script(pkg, store, step):
        if step == 0:
            for i in range(2):
                store.add_pod(pkg.api.Pod(
                    name=f"thief{i}",
                    annotations={pkg.api.GROUP_NAME_ANNOTATION: "g"},
                    containers=[{"cpu": "1", "memory": "1Gi"}],
                    node_name=f"n{i}"))

    got = _twins(lambda pkg: _two_node_store(pkg, 2, "1"), 3, script)
    assert got[1]["drops"] == (2, {"capacity-taken": 2})
    assert not any(k.startswith("default/p") for k in got[-1]["binds"])


def test_compaction_mid_flight_voids_whole_result():
    """tests/test_pipeline.py:200: a compaction between dispatch and
    fetch voids the result wholesale; the pods re-place."""
    def script(pkg, store, step):
        if step == 0:
            store.mirror.compact_gen += 1

    got = _twins(lambda pkg: _small(pkg, seed=9), 3, script)
    assert got[1]["binds"] == {}
    assert got[1]["drops"] == (32, {"compaction": 32})
    assert len(got[2]["binds"]) == 32


def _gpu_store(pkg):
    api = pkg.api
    store = pkg.cache.ClusterStore()
    store.add_node(api.Node(
        name="gpu-node", labels={"gpu": "true"},
        allocatable={"cpu": "4", "memory": "8Gi", "pods": 16}))
    store.add_node(api.Node(
        name="plain-node",
        allocatable={"cpu": "4", "memory": "8Gi", "pods": 16}))
    store.add_pod_group(api.PodGroup(name="g", min_member=1))
    store.add_pod(api.Pod(
        name="needs-gpu", annotations={api.GROUP_NAME_ANNOTATION: "g"},
        containers=[{"cpu": "1", "memory": "1Gi"}],
        node_selector={"gpu": "true"}))
    return store


def test_node_relabel_mid_flight_drops_selector_rows():
    """tests/test_pipeline.py:216: the label a selector row matched goes
    away during the overlap: the row drops (node-epoch-churn) and stays
    Pending."""
    def script(pkg, store, step):
        if step == 0:
            store.add_node(pkg.api.Node(
                name="gpu-node",
                allocatable={"cpu": "4", "memory": "8Gi", "pods": 16}))

    got = _twins(_gpu_store, 3, script)
    assert got[1]["drops"] == (1, {"node-epoch-churn": 1})
    assert got[-1]["binds"] == {}


def test_fetch_programming_error_propagates(monkeypatch):
    """tests/test_pipeline.py:288: an error at the fetch propagates, as
    from a synchronous solve, on both packages."""
    from volcano_tpu import pipeline as jax_pipeline

    def boom(self):
        raise ValueError("shape mismatch: solver returned garbage")

    for pkg, mod in ((volcano_tpu, jax_pipeline),
                     (volcano_tpu_torch, pipeline)):
        store = _small(pkg, seed=31)
        store.pipeline = True
        sched = _sched(pkg, store)
        sched.run_once()
        assert store._inflight_solve is not None
        with monkeypatch.context() as mp:
            mp.setattr(mod.InflightSolve, "fetch", boom)
            with pytest.raises(ValueError, match="shape mismatch"):
                sched.run_once()
        assert not store.binder.binds
        store.close()


def _garbage_run(pkg, monkeypatch):
    if pkg is volcano_tpu:
        from volcano_tpu import pipeline as pl
        from volcano_tpu.fastpath import FastCycle, run_cycle_fast
    else:
        pl = pipeline
        from volcano_tpu_torch.fastpath import FastCycle, run_cycle_fast

    store = _small(pkg, seed=33)
    store.pipeline = True
    sched = _sched(pkg, store)
    conf = sched._load_conf()
    sched.run_once()
    assert store._inflight_solve is not None

    def garbage(self):
        raise ValueError("malformed snapshot frame")

    out = []
    with monkeypatch.context() as mp:
        mp.setattr(pl.InflightSolve, "fetch", garbage)
        for _ in range(FastCycle.REMOTE_FETCH_FAIL_CAP - 1):
            # The parked handle presented as a remote dispatch: the
            # failure counts as a lost reply and the cycle re-dispatches.
            store._inflight_solve.kind = "remote"
            run_cycle_fast(store, conf, **({} if pkg is volcano_tpu
                                           else {"device": "cpu"}))
            assert store._inflight_solve is not None
            rec = store.flight.last()
            out.append((dict(rec.drop_reasons), store._remote_fetch_fails))
        store._inflight_solve.kind = "remote"
        with pytest.raises(ValueError, match="malformed"):
            run_cycle_fast(store, conf, **({} if pkg is volcano_tpu
                                           else {"device": "cpu"}))
    sched.run_once()
    sched.run_once()
    out.append(store._remote_fetch_fails)
    store.close()
    return out


def test_remote_garbage_replies_fail_cycle_after_cap(monkeypatch):
    """tests/test_pipeline.py:309: a child that keeps replying garbage
    fails the cycle past ``REMOTE_FETCH_FAIL_CAP`` consecutive lost
    replies; one success resets the count -- on both packages alike."""
    want = _garbage_run(volcano_tpu, monkeypatch)
    _reset_uid_counters()
    got = _garbage_run(volcano_tpu_torch, monkeypatch)
    assert got == want
    assert got[-1] == 0 and got[0][0].get("lost-reply", 0) >= 1


def test_remote_pipelined_two_process_parity():
    """tests/test_pipeline.py:463: a pipelined remote deployment over a
    port solver child process sends frame N+1 while frame N's reply is
    outstanding, and places what the local synchronous cycle and the JAX
    package's pipelined remote deployment place."""
    import threading as _threading

    from test_torch_remote_solver import spawn_child, stop_child

    from volcano_tpu.solver_service import RemoteSolver as JaxRemote
    from volcano_tpu.solver_service import SolverServer as JaxServer
    from volcano_tpu_torch.solver_service import RemoteSolver

    _reset_uid_counters()
    local = _small(volcano_tpu_torch, seed=23)
    _sched(volcano_tpu_torch, local).run_once()
    local.flush_binds()
    placements = {"local": _placements(local)}
    local.close()
    jsrv = JaxServer(port=0)
    _threading.Thread(target=jsrv.serve_forever, daemon=True).start()
    proc, port = spawn_child()
    try:
        for pkg, cls, p in ((volcano_tpu, JaxRemote, jsrv.port),
                            (volcano_tpu_torch, RemoteSolver, port)):
            _reset_uid_counters()
            remote = _small(pkg, seed=23)
            remote.pipeline = True
            client = cls(f"127.0.0.1:{p}", timeout=60.0)
            remote.remote_solver = client
            sched = _sched(pkg, remote)
            sched.run_once()
            inflight = remote._inflight_solve
            assert inflight is not None and inflight.kind == "remote"
            sched.run_once()
            remote.flush_binds()
            placements[pkg.__name__] = _placements(remote)
            assert client.ping()["solves"] >= 1  # the child solved
            client.close()
            remote.close()
    finally:
        stop_child(proc)
        jsrv.shutdown()
    assert placements["volcano_tpu_torch"] == placements["local"]
    assert placements["volcano_tpu"] == placements["local"]


def test_dispatch_slot_is_exclusive_remote_contract():
    """tests/test_pipeline.py:502: the remote protocol allows one
    outstanding solve: a round trip beside a parked one raises, and
    abandoning clears the slot."""
    from volcano_tpu_torch.solver_service import (PendingSolve,
                                                  RemoteSolver, _WireCache)

    client = RemoteSolver.__new__(RemoteSolver)
    client._lock = threading.Lock()
    client._sock = None
    client._wire = _WireCache()
    client._shm = None
    client.wire_fallbacks = {}
    client._pending = PendingSolve(client)
    with pytest.raises(RuntimeError):
        client._roundtrip(b"x")
    client._pending.abandon()
    assert client._pending is None


def test_stop_mid_flight_abandons_and_restart_places_all():
    """tests/test_pipeline.py:351: stop() drains the parked dispatch; a
    fresh scheduler on the same store places every pod."""
    traces = {}
    for pkg in (volcano_tpu, volcano_tpu_torch):
        _reset_uid_counters()
        store = _small(pkg, seed=11)
        store.pipeline = True
        sched = _sched(pkg, store)
        sched.run_once()
        assert store._inflight_solve is not None
        sched.stop()
        assert store._inflight_solve is None
        sched2 = _sched(pkg, store)
        sched2.run_once()
        sched2.run_once()
        store.flush_binds()
        assert all(p.node_name for p in store.pods.values())
        traces[pkg] = _placements(store)
        store.close()
    assert traces[volcano_tpu] == traces[volcano_tpu_torch]


def test_devsnap_delta_upload_on_node_change():
    """tests/test_pipeline.py:398: a one-node change between cycles
    re-ships only the dirty rows; counters equal to the JAX package's."""
    def run(pkg):
        api = pkg.api
        _reset_uid_counters()
        store = _small(pkg, seed=17, n_nodes=8, n_pods=16, gang_size=2)
        store.pipeline = True
        sched = _sched(pkg, store)
        sched.run_once()
        snap = store.device_snapshot
        full_before = snap.full_uploads
        store.add_node(api.Node(
            name="node-000000", labels={"freshly": "relabelled"},
            allocatable={"cpu": "64", "memory": "256Gi", "pods": 256}))
        store.add_pod_group(api.PodGroup(name="late", min_member=1))
        store.add_pod(api.Pod(
            name="late-0", annotations={api.GROUP_NAME_ANNOTATION: "late"},
            containers=[{"cpu": "1", "memory": "1Gi"}]))
        sched.run_once()
        sched.run_once()
        store.flush_binds()
        out = (full_before, snap.full_uploads, snap.delta_uploads,
               snap.hits, _placements(store))
        store.close()
        return out

    want, got = run(volcano_tpu), run(volcano_tpu_torch)
    assert want == got
    full_before, full, delta, _hits, placed = got
    assert delta >= 1 and full == full_before
    assert all(placed.values())


def test_devsnap_steady_state_hits_without_node_changes():
    """tests/test_pipeline.py:430: re-pended pods re-solve at an unchanged
    node epoch: the planes hit, one full upload ever."""
    def run(pkg):
        _reset_uid_counters()
        store = _small(pkg, seed=19)
        store.pipeline = True
        sched = _sched(pkg, store)
        sched.run_once()
        snap = store.device_snapshot
        sched.run_once()
        store.flush_binds()
        hits_before = snap.hits
        m = store.mirror
        rows = np.flatnonzero((m.p_status[:m.n_pods] == ST_BOUND)
                              & m.p_alive[:m.n_pods])
        m.p_status[rows] = ST_PENDING
        m.p_node[rows] = -1
        m.p_node_name[rows] = None
        m.mutation_seq += 1
        for p in store.pods.values():
            p.node_name = None
        store.mark_objects_stale()
        sched.run_once()
        out = (hits_before, snap.hits, snap.full_uploads)
        store.close()
        return out

    want, got = run(volcano_tpu), run(volcano_tpu_torch)
    assert want == got
    assert got[1] > got[0] and got[2] == 1


# ------------------------------------------- the 10-cycle churn twin run


def _churn_twin(pkg, cycles=10):
    """tests/test_torch_cycle.py's _twin with pipeline=True on both
    packages; the port's trace is read once its worker is idle (the JAX
    solve computes the device-incremental counters at dispatch)."""
    _reset_uid_counters()
    store = pkg.synth.synthetic_cluster(n_nodes=24, n_pods=72, gang_size=4,
                                        seed=13)
    store.pipeline = True
    sched = _sched(pkg, store)
    store.cycle_feed = _partial_feed([0, 1])
    rng = random.Random(7)
    trace = []
    for step in range(cycles):
        sched.run_once()
        worker = getattr(store, "_solve_worker", None)
        if pkg is volcano_tpu_torch:
            assert worker is not None and worker.idle(60)
        dv = store._devincr_cache
        snap = store.device_snapshot
        rec = store.flight.last()
        trace.append({
            "mirror": _mirror_state(store),
            "binds": dict(store.binder.binds),
            "phases": {uid: pg.status.phase
                       for uid, pg in sorted(store.pod_groups.items())},
            "devincr": (None if dv is None else
                        (dict(dv.counts), dv.static_hits,
                         dv.static_builds)),
            "devsnap": (None if snap is None else
                        (snap.full_uploads, snap.delta_uploads, snap.hits)),
            "flight": (rec.dispatched_solve_id, rec.committed_solve_id,
                       rec.mutation_seq_at_dispatch,
                       rec.mutation_seq_at_commit, rec.pods_dropped,
                       dict(rec.drop_reasons)),
        })
        if step % 2 == 1:
            _churn(pkg.api, store, rng, step)
    store.close()
    return trace


_CACHE = {}


@pytest.mark.parametrize("field", ["mirror", "binds", "phases", "devincr",
                                   "devsnap", "flight"])
def test_pipelined_churn_cycles_equal_jax(field):
    if "jax" not in _CACHE:
        _CACHE["jax"] = _churn_twin(volcano_tpu)
    want = _CACHE["jax"]
    got = _churn_twin(volcano_tpu_torch)
    assert len(got) == len(want) == 10
    for step, (a, b) in enumerate(zip(want, got)):
        assert a[field] == b[field], (field, step)
    if field == "flight":
        # Not vacuous: every cycle after the first commits what the one
        # before dispatched.
        assert all(t["flight"][1] is not None for t in got[1:])


# ------------------------------------------------ pipelined what-if plans


PREEMPT_CONF = """
actions: "enqueue, allocate, preempt, backfill"
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


def _plan_twin(pkg, make, conf, cycles, script=None, grace=2):
    _reset_uid_counters()
    store = make(pkg)
    store.pipeline = True
    sched = _sched(pkg, store, conf)
    sim = pkg.sim.ClusterSimulator(store, grace_steps=grace)
    trace = []
    for step in range(cycles):
        sched.run_once()
        rec = store.flight.last()
        led = store.migrations
        trace.append({
            "binds": dict(store.binder.binds),
            "evictions": list(store.evictor.evicts),
            "whatif": rec.whatif, "rebalance": rec.rebalance,
            "plan_parked": store._inflight_plan is not None,
            "ids": (rec.dispatched_solve_id, rec.committed_solve_id,
                    rec.mutation_seq_at_dispatch),
            "drops": (rec.pods_dropped, dict(rec.drop_reasons)),
            "committed_plans": None if led is None else led.committed_plans,
            "mirror": _mirror_state(store),
        })
        sim.step()
        if script is not None:
            script(pkg, store, step)
    store.close()
    return trace


def _tier_store(pkg):
    cache = pkg.cache
    store = cache.ClusterStore(binder=cache.FakeBinder(),
                               evictor=cache.FakeEvictor())
    pkg.sim.ClusterSimulator.priority_tier_workload(
        store, workers=8, serving_tasks=4)
    return store


def _outcomes(trace, key):
    return [None if t[key] is None else t[key].get("outcome")
            for t in trace]


def _plan_twins(make, conf, cycles, script=None):
    want = _plan_twin(volcano_tpu, make, conf, cycles, script)
    got = _plan_twin(volcano_tpu_torch, make, conf, cycles, script)
    for step, (a, b) in enumerate(zip(want, got)):
        for field in a:
            assert a[field] == b[field], (field, step, a[field], b[field])
    return got


def test_pipelined_preempt_plan_commits_next_cycle():
    """A preempt plan parked in one cycle commits at the next cycle's top
    when nothing moved; the serving gang ends bound."""
    got = _plan_twins(_tier_store, PREEMPT_CONF, 10)
    assert any(t["plan_parked"] for t in got)
    assert "committed" in _outcomes(got, "whatif")
    assert sum(k.startswith("default/serving-")
               for k in got[-1]["binds"]) == 4


def test_pipelined_preempt_plan_stale_voided_by_a_new_pod():
    """A pod added while the plan is parked voids it (stale-voided); the
    planner re-plans and the gang still binds."""
    state = {"done": False}

    def script(pkg, store, step):
        if store._inflight_plan is not None and not state["done"]:
            state["done"] = True
            api = pkg.api
            store.add_pod_group(api.PodGroup(name="late", min_member=1))
            store.add_pod(api.Pod(
                name="late-0", annotations={api.GROUP_NAME_ANNOTATION: "late"},
                containers=[{"cpu": "1", "memory": "1Gi"}]))

    def run_both():
        out = []
        for pkg in (volcano_tpu, volcano_tpu_torch):
            state["done"] = False
            out.append(_plan_twin(pkg, _tier_store, PREEMPT_CONF, 12,
                                  script))
        return out

    want, got = run_both()
    for step, (a, b) in enumerate(zip(want, got)):
        for field in a:
            assert a[field] == b[field], (field, step, a[field], b[field])
    assert "stale-voided" in _outcomes(got, "whatif")


def _rebalance_store(pkg):
    """bench.py config_rebalance at 16 workers, the fillers placed and
    Running, then a 8-task whole-node gang."""
    api = pkg.api
    store = pkg.cache.ClusterStore(binder=pkg.cache.FakeBinder())
    store.add_priority_class(api.PriorityClass(name="bench-high",
                                               value=100))
    for i in range(16):
        store.add_node(api.Node(name=f"w{i}", allocatable={
            "cpu": "4", "memory": "16Gi", "pods": 110}))
        store.add_node(api.Node(name=f"s{i}", allocatable={
            "cpu": "3", "memory": "16Gi", "pods": 110}))
    for i in range(16):
        store.add_pod_group(api.PodGroup(name=f"bf{i}", min_member=1))
        store.add_pod(api.Pod(
            name=f"bfill{i}", annotations={api.GROUP_NAME_ANNOTATION: f"bf{i}"},
            containers=[{"cpu": "3", "memory": "1Gi"}],
            phase=api.PodPhase.Running, node_name=f"w{i}"))
    store.add_pod_group(api.PodGroup(name="benchgang", min_member=8,
                                     priority_class="bench-high"))
    for i in range(8):
        store.add_pod(api.Pod(
            name=f"bg{i}", annotations={api.GROUP_NAME_ANNOTATION: "benchgang"},
            containers=[{"cpu": "4", "memory": "1Gi"}]))
    return store


@pytest.fixture
def rebalance_env(monkeypatch):
    for k in ("VOLCANO_TPU_REBALANCE", "VOLCANO_TPU_REBALANCE_MIN_GAIN",
              "VOLCANO_TPU_REBALANCE_MAX_UNAVAIL", "VOLCANO_TPU_TOPOLOGY",
              "VOLCANO_TPU_TOPO_WEIGHT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("VOLCANO_TPU_REBALANCE_DRAIN_CAP", "32")


def _rebalance_conf():
    from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF

    return REBALANCE_SCHEDULER_CONF


def test_pipelined_rebalance_plan_commits_next_cycle(rebalance_env):
    """A rebalance plan needs a starvation streak of 2 when pipelined,
    parks, and commits at the next cycle's top; the gang ends bound."""
    got = _plan_twins(_rebalance_store, _rebalance_conf(), 8)
    outs = _outcomes(got, "rebalance")
    assert "committed" in outs
    assert outs[0] is None  # streak 1: no plan yet
    assert sum(k.startswith("default/bg") for k in got[-1]["binds"]) == 8


def test_pipelined_rebalance_plan_stale_voided_by_a_new_pod(rebalance_env):
    """A pod added while the rebalance plan is parked voids it."""
    state = {"done": False}

    def script(pkg, store, step):
        if store._inflight_plan is not None and not state["done"]:
            state["done"] = True
            api = pkg.api
            store.add_pod_group(api.PodGroup(name="late", min_member=1))
            store.add_pod(api.Pod(
                name="late-0", annotations={api.GROUP_NAME_ANNOTATION: "late"},
                containers=[{"cpu": "1", "memory": "1Gi"}]))

    runs = []
    for pkg in (volcano_tpu, volcano_tpu_torch):
        state["done"] = False
        runs.append(_plan_twin(pkg, _rebalance_store, _rebalance_conf(), 10,
                               script))
    want, got = runs
    for step, (a, b) in enumerate(zip(want, got)):
        for field in a:
            assert a[field] == b[field], (field, step, a[field], b[field])
    assert "stale-voided" in _outcomes(got, "rebalance")


# ------------------------------------------------------ the port's traps


class _Gate:
    """Holds the worker's solve until released (``wave.solve_wave``
    wrapped: the dispatch reads the attribute)."""

    def __init__(self, monkeypatch):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.finished = threading.Event()
        real = port_wave.solve_wave

        def gated(*a, **kw):
            self.entered.set()
            assert self.release.wait(60)
            try:
                return real(*a, **kw)
            finally:
                self.finished.set()

        monkeypatch.setattr(port_wave, "solve_wave", gated)


def _arrays_of(obj):
    """Every numpy array reachable from ``obj`` (its attributes, or its
    values when a dict, and the tuples, lists and dicts they hold, three
    levels deep)."""
    out = []

    def walk(v, depth):
        if isinstance(v, np.ndarray):
            out.append(v)
        elif depth and isinstance(v, (tuple, list)):
            for x in v:
                walk(x, depth - 1)
        elif depth and isinstance(v, dict):
            for x in v.values():
                walk(x, depth - 1)
        elif depth and hasattr(v, "_fields"):
            for x in v:
                walk(x, depth - 1)

    for v in (obj if isinstance(obj, dict) else vars(obj)).values():
        walk(v, 3)
    return out


def test_owned_inputs_survive_overwritten_mirror(monkeypatch):
    """After the dispatch and before the worker reads its inputs, every
    mirror array (and the encode cache's) is overwritten in place: the
    fetched assignment equals an untouched run's."""
    fetched = []
    real_fetch = pipeline.InflightSolve.fetch

    def record(self):
        out = real_fetch(self)
        fetched.append(out.copy())
        return out

    monkeypatch.setattr(pipeline.InflightSolve, "fetch", record)

    def run(overwrite):
        _reset_uid_counters()
        store = _small(volcano_tpu_torch, seed=5, n_nodes=12, n_pods=48)
        store.pipeline = True
        sched = PortScheduler(store, device="cpu")
        with monkeypatch.context() as mp:
            gate = _Gate(mp)
            sched.run_once()
            assert gate.entered.wait(60)
            saved = []
            if overwrite:
                arrays = (_arrays_of(store.mirror)
                          + _arrays_of(store)
                          + _arrays_of(store._encode_cache or {}))
                for a in arrays:
                    if a.flags.writeable and a.size:
                        saved.append((a, a.copy()))
                        a[...] = (None if a.dtype == object
                                  else np.ones(1, a.dtype) * 3)
            gate.release.set()
            assert gate.finished.wait(60)
            assert store._solve_worker.idle(60)
            for a, copy in saved:
                a[...] = copy
        sched.run_once()
        store.flush_binds()
        out = dict(store.binder.binds)
        store.close()
        return out, len(saved)

    clean, _ = run(False)
    dirty, n_overwritten = run(True)
    assert n_overwritten > 20
    assert len(fetched) == 2
    assert np.array_equal(fetched[0], fetched[1])
    assert clean == dirty and len(clean) == 48


def test_worker_failure_fails_the_fetching_cycle(monkeypatch):
    """A solve that raises in the worker makes the next run_once() raise
    the same exception type; no pod is bound, and no path re-runs the
    solve synchronously."""
    class SolveBroke(RuntimeError):
        pass

    calls = []

    def broken(*a, **kw):
        calls.append(threading.current_thread().name)
        raise SolveBroke("injected worker failure")

    store = _small(volcano_tpu_torch, seed=3)
    store.pipeline = True
    sched = PortScheduler(store, device="cpu")
    monkeypatch.setattr(port_wave, "solve_wave", broken)
    sched.run_once()  # dispatch only: the cycle does not wait
    with pytest.raises(SolveBroke, match="injected"):
        sched.run_once()
    assert calls == ["vc-solve-dispatch"]
    assert not store.binder.binds
    m = store.mirror
    assert (m.p_status[:m.n_pods][m.p_alive[:m.n_pods]] == ST_PENDING).all()
    # The null-delta proof of the lost solve is void: once the solve
    # works again every pod binds.
    monkeypatch.undo()
    sched.run_once()
    sched.run_once()
    store.flush_binds()
    assert len(store.binder.binds) == 32
    store.close()


def test_fetch_on_a_wedged_worker_raises(monkeypatch):
    """fetch() never hangs: past pipeline.FETCH_TIMEOUT_S it raises."""
    store = _small(volcano_tpu_torch, seed=3)
    store.pipeline = True
    sched = PortScheduler(store, device="cpu")
    gate = _Gate(monkeypatch)
    sched.run_once()
    assert gate.entered.wait(60)
    monkeypatch.setattr(pipeline, "FETCH_TIMEOUT_S", 0.2)
    with pytest.raises(TimeoutError):
        sched.run_once()
    gate.release.set()
    monkeypatch.undo()
    store.close()


def test_no_resident_plane_written_while_a_solve_is_in_flight(monkeypatch):
    """A node-table delta waits for the in-flight solve before its
    scatter writes the resident planes in place."""
    api = volcano_tpu_torch.api
    store = _small(volcano_tpu_torch, seed=21)
    store.pipeline = True
    sched = PortScheduler(store, device="cpu")
    sched.run_once()
    assert store._solve_worker.idle(60)
    sched.run_once()  # commit; the planes are resident now
    store.flush_binds()
    gate = _Gate(monkeypatch)
    store.add_pod_group(api.PodGroup(name="late", min_member=1))
    store.add_pod(api.Pod(
        name="late-0", annotations={api.GROUP_NAME_ANNOTATION: "late"},
        containers=[{"cpu": "1", "memory": "1Gi"}]))
    sched.run_once()  # dispatches a solve reading the resident planes
    assert gate.entered.wait(60)
    snap = store.device_snapshot
    writes = []
    real_scatter = kernels.scatter_planes

    def watched(bufs, staged, k):
        writes.append(gate.finished.is_set())
        return real_scatter(bufs, staged, k)

    monkeypatch.setattr(kernels, "scatter_planes", watched)
    node = store.mirror.node_objs[0]
    store.update_node(api.Node(
        name=node.name, labels={"late": "label"},
        allocatable=dict(node.allocatable)))
    m = store.mirror
    planes = {k: v.numpy().copy() for k, v in snap._planes.items()}
    build = {k: (lambda rows, a=a: a if rows is None else a[rows])
             for k, a in planes.items()}
    key = (m.epoch,) + snap._key[1:]
    done = threading.Event()
    t = threading.Thread(target=lambda: (snap.node_planes(m, key, build),
                                         done.set()))
    t.start()
    assert not done.wait(0.3), "the delta did not wait for the solve"
    gate.release.set()
    t.join(60)
    assert done.is_set()
    assert writes == [True]
    assert snap.delta_uploads >= 1
    store.close()


def test_launch_counts_exact_under_two_threads():
    """Two threads counting launches: the totals are exact, and a thread
    inside own_counts sees exactly its own."""
    kernels.reset_launches()
    own = {}
    n = 20000

    def worker():
        with kernels.own_counts(own):
            for _ in range(n):
                kernels.count_launch("apply_commit")
                kernels.count_launch("coarse_shortlist",
                                     fused="static_planes")

    t = threading.Thread(target=worker)
    t.start()
    for _ in range(n):
        kernels.count_launch("apply_commit")
    t.join()
    assert kernels.LAUNCHES["apply_commit"] == 2 * n
    assert kernels.LAUNCHES["coarse_shortlist"] == n
    assert kernels.FUSED["static_planes"] == n
    assert own == {"apply_commit": n, "coarse_shortlist": n,
                   "static_planes:fused": n}
    kernels.reset_launches()


def test_twophase_record_is_per_solve():
    """The worker's solve writes its own LAST_TWOPHASE record; the cycle
    publishes it at the fetch, and a solve on another thread never
    clobbers it."""
    _reset_uid_counters()
    store = _small(volcano_tpu_torch, seed=23)
    store.pipeline = True
    sched = PortScheduler(store, device="cpu")
    seen = []
    real_fetch = pipeline.InflightSolve.fetch

    def record(self):
        out = real_fetch(self)
        seen.append(dict(self.twophase))
        return out

    pipeline.InflightSolve.fetch = record
    try:
        sched.run_once()
        assert store._solve_worker.idle(60)
        # The worker's record did not land in the module's.
        port_wave.LAST_TWOPHASE.clear()
        port_wave.LAST_TWOPHASE["marker"] = True
        sched.run_once()
    finally:
        pipeline.InflightSolve.fetch = real_fetch
    assert len(seen) == 1 and seen[0]["enabled"]
    assert seen[0]["host_reads"] == 0
    assert port_wave.LAST_TWOPHASE == seen[0]
    rec = {}
    with port_wave.own_twophase(rec):
        port_wave._twophase()["x"] = 1
    assert rec == {"x": 1} and "x" not in port_wave.LAST_TWOPHASE
    store.close()


def test_async_bind_and_pipeline_together():
    """store.pipeline and store.async_bind together: cycle 1 only
    dispatches, cycle 2 commits and queues the binds on the dispatcher
    (vc-bind-dispatch), flush_binds() lands them: the synchronous
    placements."""
    _reset_uid_counters()
    sync = _small(volcano_tpu_torch, seed=29)
    PortScheduler(sync, device="cpu").run_once()
    _reset_uid_counters()
    store = _small(volcano_tpu_torch, seed=29)
    store.pipeline = True
    store.async_bind = True
    sched = PortScheduler(store, device="cpu")
    sched.run_once()
    assert store.flush_binds(10) and not store.binder.binds
    sched.run_once()
    assert store._bind_dispatcher is not None
    assert store._bind_dispatcher._thread.name == "vc-bind-dispatch"
    assert store.flush_binds(10)
    assert dict(store.binder.binds) == dict(sync.binder.binds)
    assert all(p.node_name for p in store.pods.values())
    store.close()
    sync.close()


def test_object_session_abandons_the_inflight_solve(monkeypatch):
    """A cycle that leaves the fast path (``VOLCANO_TPU_FASTPATH=0``) after
    a pipelined dispatch abandons the parked solve first: the object
    session places the pods, and no later fast cycle commits the stale
    result over them (tests/test_pipeline.py:318's contract)."""
    store = _small(volcano_tpu_torch, seed=13)
    store.pipeline = True
    sched = PortScheduler(store, device="cpu")
    sched.run_once()
    assert store._inflight_solve is not None
    monkeypatch.setenv("VOLCANO_TPU_FASTPATH", "0")
    sched.run_once()
    assert store._inflight_solve is None
    assert store.flight.last().path == "object"
    binds = dict(store.binder.binds)
    assert len(binds) == 32
    monkeypatch.delenv("VOLCANO_TPU_FASTPATH")
    sched.run_once()
    sched.run_once()
    store.flush_binds()
    assert dict(store.binder.binds) == binds
    assert store.flight.last().committed_solve_id is None
    _assert_capacity_respected(store)
    store.close()
