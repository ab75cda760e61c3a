"""The port's flight records, Perfetto export and drop journeys against the
JAX package's.

Twins of ``tests/test_obs.py``: one store and one mutation script, built
from each package's own api, through both schedulers; the flight records
(solve ids, considered / bound / dropped counts, drop reasons, device
events, anomalies), the exported trace's flow arrows and the journeys'
drop events must be equal.  Timings are never compared.  Cases: a
pipelined run's dispatch -> commit flow, the record's overlap accounting,
staleness drops whose reasons sum to the dropped rows, capacity theft, a
lost reply, a compaction void, tracing off, the bounded ring and the
object session's records.  The ``/debug`` endpoint case belongs to the
service (ROADMAP.md, queue 1, item 6): not twinned here.
"""

import copy
import itertools
import json

import pytest

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.obs.export
import volcano_tpu.pipeline
import volcano_tpu.synth
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.pipeline
import volcano_tpu_torch.synth
from volcano_tpu_torch.metrics import metrics as port_metrics
from volcano_tpu_torch.obs import CycleRecord, FlightRecorder, export
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("VOLCANO_TPU_PIPELINE", "VOLCANO_TPU_TRACE",
              "VOLCANO_TPU_AUDIT", "VOLCANO_TPU_JOURNEY",
              "VOLCANO_TPU_FASTPATH", "VOLCANO_TPU_DEVINCR",
              "VOLCANO_TPU_DEVSNAP"):
        monkeypatch.delenv(k, raising=False)


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _sched(pkg, store):
    if pkg is volcano_tpu:
        return JaxScheduler(store)
    return PortScheduler(store, device="cpu")


def _export(pkg):
    return volcano_tpu.obs.export if pkg is volcano_tpu else export


def _both(run):
    return run(volcano_tpu), run(volcano_tpu_torch)


def _small(pkg, seed=7, **kw):
    _reset_uid_counters()
    kw.setdefault("n_nodes", 8)
    kw.setdefault("n_pods", 32)
    kw.setdefault("gang_size", 4)
    return pkg.synth.synthetic_cluster(seed=seed, **kw)


def _rec(rec):
    """A flight record's fields the twins must agree on (no timings)."""
    return {
        "path": rec.path,
        "considered": rec.pods_considered,
        "bound": rec.pods_bound,
        "dropped": rec.pods_dropped,
        "reasons": dict(rec.drop_reasons),
        "ids": (rec.dispatched_solve_id, rec.committed_solve_id),
        "seqs": (rec.mutation_seq_at_dispatch, rec.mutation_seq_at_commit,
                 rec.epoch_at_dispatch, rec.epoch_at_commit),
        "events": list(rec.device_events),
        "anomalies": [a["reason"] for a in rec.anomalies],
        "error": rec.error,
    }


def _drops(store):
    return sorted((r["uid"], r.get("detail"), r.get("solve_id", 0))
                  for r in store.journey.trace_rows()
                  if r["kind"] == "dropped")


# ------------------------------------------------------------ trace export


def _pipelined_run(pkg):
    store = _small(pkg)
    store.pipeline = True
    sched = _sched(pkg, store)
    sched.run_once()  # cycle 1: dispatch only
    sched.run_once()  # cycle 2: the commit lands
    store.flush_binds()
    recs = store.flight.recent()
    c1, c2 = recs
    trace = json.loads(json.dumps(_export(pkg).perfetto_trace(
        recs, journey=store.journey.trace_rows())))
    evs = trace["traceEvents"]
    sid = c1.dispatched_solve_id
    out = {
        "records": [_rec(r) for r in recs],
        "dispatch": [s.flow for s in c1.spans if s.name == "dispatch"],
        "commit": sorted((s.name, s.flow) for s in c2.spans
                         if s.name in ("inflight_fetch", "inflight_commit")),
        "arrows": sorted((e["ph"], e["id"]) for e in evs
                         if e.get("cat") == "flow"),
        "x": sorted({e["name"] for e in evs if e["ph"] == "X"}
                    & {"dispatch", "inflight_fetch", "inflight_commit"}),
        "ordered": [e["ts"] for e in evs if e.get("cat") == "flow"
                    and e["id"] == sid and e["ph"] in ("s", "f")],
        "journey_sids": sorted({e["args"].get("solve_id") for e in evs
                                if e.get("cat") == "journey"
                                and e.get("ph") == "n"} - {None}),
    }
    store.close()
    return out


def test_pipelined_trace_links_dispatch_and_commit_across_cycles():
    """The dispatch span of cycle 1 and the fetch and commit spans of
    cycle 2 carry one solve id; the export links them with one flow
    arrow (start before finish), the pods' journey instants join it, and
    the whole trace round-trips as JSON -- as in the JAX package."""
    want, got = _both(_pipelined_run)
    sid = got["records"][0]["ids"][0]
    assert sid is not None and got["records"][1]["ids"][1] == sid
    assert got["dispatch"] == [sid]
    assert got["commit"] == [("inflight_commit", sid),
                             ("inflight_fetch", sid)]
    assert got["x"] == ["dispatch", "inflight_commit", "inflight_fetch"]
    s_ts, f_ts = got["ordered"][0], got["ordered"][-1]
    assert s_ts < f_ts
    assert got["journey_sids"] == [sid]
    for key in ("records", "dispatch", "commit", "x", "journey_sids"):
        assert got[key] == want[key], key
    # One arrow per solve id: one start, one finish (journey instants
    # step between them).
    for pkg_out in (want, got):
        phases = [ph for ph, i in pkg_out["arrows"] if i == sid]
        assert phases.count("s") == 1 and phases.count("f") == 1


def _overlap_run(pkg):
    store = _small(pkg, seed=11)
    store.pipeline = True
    sched = _sched(pkg, store)
    sched.run_once()
    sched.run_once()
    store.flush_binds()
    recs = store.flight.recent()
    rec = recs[-1]
    d = rec.to_dict()
    json.dumps(d)
    out = ([_rec(r) for r in recs], rec.inflight_fetch_wait_ms is not None,
           rec.duration_s > 0, "derive" in d["lanes_ms"])
    store.close()
    return out


def test_cycle_record_fields_cover_overlap_accounting():
    want, got = _both(_overlap_run)
    assert got == want
    recs = got[0]
    assert recs[0]["considered"] == 32 and recs[-1]["bound"] == 32
    seqs = recs[-1]["seqs"]
    assert seqs[0] == seqs[1] and seqs[2] == seqs[3]
    assert got[1:] == (True, True, True)


# ------------------------------------------------------ staleness reasons


def _drop_scenario_store(pkg):
    """Two roomy nodes, five plain pods, one selector pod: each staleness
    drop below can be forced during the overlap."""
    _reset_uid_counters()
    api = pkg.api
    store = pkg.cache.ClusterStore()
    store.add_node(api.Node(name="n0", allocatable={
        "cpu": "8", "memory": "32Gi", "pods": 64}, labels={"zone": "a"}))
    store.add_node(api.Node(name="n1", allocatable={
        "cpu": "8", "memory": "32Gi", "pods": 64}))
    store.add_pod_group(api.PodGroup(name="g", min_member=1))
    for k in range(5):
        store.add_pod(api.Pod(
            name=f"p{k}", annotations={api.GROUP_NAME_ANNOTATION: "g"},
            containers=[{"cpu": "1", "memory": "1Gi"}]))
    store.add_pod(api.Pod(
        name="picky", annotations={api.GROUP_NAME_ANNOTATION: "g"},
        containers=[{"cpu": "1", "memory": "1Gi"}],
        node_selector={"zone": "a"}))
    store.pipeline = True
    return store


def _drop_run(pkg):
    api = pkg.api
    metrics = jax_metrics if pkg is volcano_tpu else port_metrics
    store = _drop_scenario_store(pkg)
    sched = _sched(pkg, store)
    sched.run_once()  # dispatch over the 6 pending pods
    assert store._inflight_solve is not None
    store.delete_pod(next(p for p in store.pods.values() if p.name == "p0"))
    p1 = copy.copy(next(p for p in store.pods.values() if p.name == "p1"))
    p1.node_name = "n1"
    store.update_pod(p1)  # competing bind
    store.add_node(api.Node(name="n1", allocatable={
        "cpu": "8", "memory": "32Gi", "pods": 64},
        labels={"freshly": "labelled"}))  # node-epoch churn
    before = dict(metrics.pipeline_stale_drops.data)
    sched.run_once()  # fetch + staleness-guarded commit
    store.flush_binds()
    rec = next(r for r in reversed(store.flight.recent())
               if r.committed_solve_id is not None)
    after = metrics.pipeline_stale_drops.data
    moved = {k[0][1]: after.get(k, 0.0) - before.get(k, 0.0)
             for k in after if after.get(k, 0.0) != before.get(k, 0.0)}
    out = (_rec(rec), moved, _drops(store), dict(store.binder.binds))
    store.close()
    return out


def test_drop_reasons_sum_exactly_to_dropped_rows():
    """Concurrent delete, competing bind and node churn during the
    overlap: the per-reason counts sum to the dropped rows, the counter
    series moved by exactly them, and each dropped pod's journey holds
    its one reason -- equal to the JAX package's."""
    want, got = _both(_drop_run)
    assert got == want
    rec, moved, drops, _binds = got
    assert rec["dropped"] > 0
    assert sum(rec["reasons"].values()) == rec["dropped"]
    assert rec["reasons"].get("deleted") == 1
    assert rec["reasons"].get("competing-bind") == 1
    assert rec["reasons"].get("node-epoch-churn", 0) >= 1
    assert moved == {k: float(v) for k, v in rec["reasons"].items()}
    # Every dropped pod that still exists carries its one reason (the
    # deleted pod's row is tombstoned: it has no journey left).
    assert sorted(d for _u, d, _s in drops) == sorted(
        r for r, n in rec["reasons"].items() for _ in range(n)
        if r != "deleted")


def _theft_run(pkg):
    _reset_uid_counters()
    api = pkg.api
    store = pkg.cache.ClusterStore()
    for i in range(2):
        store.add_node(api.Node(name=f"n{i}", allocatable={
            "cpu": "1", "memory": "8Gi", "pods": 64}))
    store.add_pod_group(api.PodGroup(name="g", min_member=1))
    for k in range(2):
        store.add_pod(api.Pod(
            name=f"p{k}", annotations={api.GROUP_NAME_ANNOTATION: "g"},
            containers=[{"cpu": "1", "memory": "1Gi"}]))
    store.pipeline = True
    sched = _sched(pkg, store)
    sched.run_once()
    for i in range(2):
        store.add_pod(api.Pod(
            name=f"thief{i}", annotations={api.GROUP_NAME_ANNOTATION: "g"},
            containers=[{"cpu": "1", "memory": "1Gi"}], node_name=f"n{i}"))
    sched.run_once()
    rec = next(r for r in reversed(store.flight.recent())
               if r.committed_solve_id is not None)
    out = (_rec(rec), _drops(store))
    store.close()
    return out


def test_capacity_theft_attributed_as_capacity_taken():
    want, got = _both(_theft_run)
    assert got == want
    assert got[0]["reasons"] == {"capacity-taken": 2}
    assert got[0]["dropped"] == 2
    assert [d for _u, d, _s in got[1]] == ["capacity-taken"] * 2


def _lost_reply_run(pkg, monkeypatch):
    store = _small(pkg, seed=19)
    store.pipeline = True
    sched = _sched(pkg, store)
    sched.run_once()
    inflight = store._inflight_solve
    assert inflight is not None
    n_rows, sid = len(inflight.task_rows), inflight.solve_id
    inflight.kind = "remote"  # present the handle as a remote dispatch

    def lost(self):
        raise OSError("connection reset by peer")

    with monkeypatch.context() as mp:
        mp.setattr(pkg.pipeline.InflightSolve, "fetch", lost)
        sched.run_once()
    rec = store.flight.recent()[-1]
    out = (_rec(rec), (n_rows, sid), _drops(store))
    store.close()
    return out


def test_lost_reply_recorded_not_as_clean_commit(monkeypatch):
    """A remote solve whose reply is lost records no committed solve id;
    its rows count under ``lost-reply`` and each pod's journey drops with
    the solve's id -- as in the JAX package.  (The handle is a local
    solve presented as the remote kind; ``tests/test_torch_remote_solver.
    py`` loses a real one.)"""
    want, got = _both(lambda pkg: _lost_reply_run(pkg, monkeypatch))
    assert got == want
    rec, (n_rows, sid), drops = got
    assert rec["ids"][1] is None
    assert rec["reasons"].get("lost-reply") == n_rows
    assert any(f"solve {sid} reply lost" in ev for ev in rec["events"])
    assert len(drops) == n_rows
    assert {(d, s) for _u, d, s in drops} == {("lost-reply", sid)}


def _compaction_run(pkg):
    store = _small(pkg, seed=9)
    store.pipeline = True
    sched = _sched(pkg, store)
    sched.run_once()
    n_inflight = len(store._inflight_solve.task_rows)
    store.mirror.compact_gen += 1  # what maybe_compact() does
    unbinds0 = store.journey.unbinds_bulk
    sched.run_once()
    rec = store.flight.recent()[-1]
    out = (_rec(rec), n_inflight, store.journey.unbinds_bulk - unbinds0)
    store.close()
    return out


def test_compaction_void_counts_whole_result():
    want, got = _both(_compaction_run)
    assert got == want
    rec, n_inflight, voided = got
    assert rec["reasons"].get("compaction") == n_inflight
    assert voided == n_inflight


def test_flight_recorder_ring_is_bounded():
    fr = FlightRecorder(capacity=4)
    for i in range(10):
        fr.record(CycleRecord(session=f"s{i}"))
    assert len(fr) == 4
    assert [r.seq for r in fr.recent()] == [7, 8, 9, 10]
    assert fr.get(10).session == "s9"
    assert fr.get(1) is None
    assert fr.recent(2)[0].seq == 9
    assert fr.recent(0) == [] and fr.recent(-3) == []
    assert fr.last().seq == 10


def _untraced_run(pkg, monkeypatch):
    with monkeypatch.context() as mp:
        mp.setenv("VOLCANO_TPU_TRACE", "0")
        store = _small(pkg, seed=13)
        store.pipeline = False
        _sched(pkg, store).run_once()
        store.flush_binds()
        rec = store.flight.recent()[-1]
        out = (_rec(rec), rec.spans, "derive" in store.last_cycle_lanes,
               bool(rec.lanes))
    store.close()
    return out


def test_lanes_survive_tracing_disabled(monkeypatch):
    want, got = _both(lambda pkg: _untraced_run(pkg, monkeypatch))
    assert got == want
    assert got[1:] == ([], True, True)


def _object_run(pkg, monkeypatch):
    with monkeypatch.context() as mp:
        mp.setenv("VOLCANO_TPU_FASTPATH", "0")
        store = _small(pkg, seed=17, n_nodes=4, n_pods=8, gang_size=2)
        store.pipeline = False
        _sched(pkg, store).run_once()
        store.flush_binds()
        rec = store.flight.recent()[-1]
        names = {s.name for s in rec.spans}
        out = (rec.path, "snapshot" in names,
               sorted(n for n in names if n.startswith("action:")),
               any(n.startswith("plugin:") for n in names),
               dict(store.binder.binds),
               store.auditor.total_anomalies())
    store.close()
    return out


def test_object_session_cycles_are_recorded(monkeypatch):
    """The object session (fast path off) records its cycles with
    snapshot, action and plugin spans; its status writes go through the
    mirror's audited writers, so the auditor sees no anomaly."""
    want, got = _both(lambda pkg: _object_run(pkg, monkeypatch))
    assert got[0] == "object" and got[1] and got[3]
    assert got[2] and got[4]
    assert got == want
    assert got[5] == 0
