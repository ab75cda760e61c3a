"""The port's pod-journey log against the JAX package's.

Twins of ``tests/test_journey.py``: the same store and feed, made from one
seed, through both packages' schedulers; the journeys must agree -- event
kind counts, bulk counters, per-pod timelines (kinds in order), the
``why_pending`` verdict of every pending pod, and ``conservation_check``
clean over every bound pod.  Latencies are never compared.  The fabric
drive of the verify notes (a require-contiguous gang held as
``topology-infeasible``, then placed by a rebalance wave with
``migration-planned`` / ``restored`` stitches) and a preempt drive
(``evicted``) are twinned too, and so is the ``/debug/pods/<uid>``
endpoint of each package's service (fetched while the store lock is
held: the timeline, its event kinds and verdict, a missing pod's error,
and ``/debug/health``'s journey rollup equal).  The cross-shard and
work-stealing cases of ``tests/test_journey.py`` belong to the sharded
control plane (ROADMAP.md, queue 1, item 7): not twinned here.
"""

import collections
import itertools
import json

import numpy as np
import pytest

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.cache
import volcano_tpu.obs
import volcano_tpu.obs.export
import volcano_tpu.sim
import volcano_tpu.synth
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.cache
import volcano_tpu_torch.obs
import volcano_tpu_torch.sim
import volcano_tpu_torch.synth
from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF
from volcano_tpu_torch.metrics import metrics as port_metrics
from volcano_tpu_torch.obs import JourneyLog, export
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

PKGS = (volcano_tpu, volcano_tpu_torch)
ST_BOUND = 16
ST_PENDING = 1
BOUND_MASK = 2 | 8 | 16 | 32 | 128  # Allocated|Binding|Bound|Running|Succ


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    for k in ("VOLCANO_TPU_AUDIT", "VOLCANO_TPU_JOURNEY",
              "VOLCANO_TPU_JOURNEY_EVENTS", "VOLCANO_TPU_PIPELINE",
              "VOLCANO_TPU_EVICT_CAP", "VOLCANO_TPU_REBALANCE",
              "VOLCANO_TPU_TOPOLOGY", "VOLCANO_TPU_DEVINCR",
              "VOLCANO_TPU_DEVSNAP"):
        monkeypatch.delenv(k, raising=False)


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _sched(pkg, store, conf=None):
    if pkg is volcano_tpu:
        return JaxScheduler(store, conf_str=conf)
    return PortScheduler(store, conf_str=conf, device="cpu")


def _both(run):
    return run(volcano_tpu), run(volcano_tpu_torch)


def _churn_store(pkg, n_nodes=16, n_pods=64, frac=3):
    _reset_uid_counters()
    store = pkg.synth.synthetic_cluster(n_nodes=n_nodes, n_pods=n_pods,
                                        gang_size=4, seed=3)
    store.pipeline = True

    def feed(fc):
        m = fc.m
        rows = np.flatnonzero(
            (m.p_status[:fc.Pn] == ST_BOUND) & m.p_alive[:fc.Pn])
        if len(rows):
            fc._unbind_rows(rows[:max(1, len(rows) // frac)])

    store.cycle_feed = feed
    return store


def _bound_uids(store):
    with store._lock:
        m = store.mirror
        return [m.p_uid[i] for i in range(len(m.p_uid))
                if m.p_alive[i] and m.p_uid[i]
                and int(m.p_status[i]) & BOUND_MASK]


def _pending_verdicts(store):
    with store._lock:
        m = store.mirror
        uids = [m.p_uid[i] for i in range(len(m.p_uid))
                if m.p_alive[i] and m.p_uid[i]
                and not int(m.p_status[i]) & BOUND_MASK]
    return {u: store.journey.why_pending(u) for u in sorted(uids)}


def _journey_view(store):
    """What the twins must agree on: kind counts (ring and bulk), the
    counters of stats() that are not latencies, every pod's kinds in
    order, and the verdicts of the pending pods."""
    jr = store.journey
    rows = jr.trace_rows()
    st = jr.stats()
    by_uid = collections.defaultdict(list)
    for r in rows:
        by_uid[r["uid"]].append((r["kind"], r.get("detail"),
                                 r.get("solve_id", 0)))
    return {
        "kinds": dict(collections.Counter(r["kind"] for r in rows)),
        "stats": {k: st[k] for k in ("events", "events_dropped", "pods",
                                     "bound", "rebinds", "reconsiders")},
        "unbinds_bulk": jr.unbinds_bulk,
        "timelines": dict(by_uid),
        "pending": _pending_verdicts(store),
        "conservation": [a.reason for a in
                         jr.conservation_check(_bound_uids(store))],
    }


# ------------------------------------------------------- conservation


def _churn_run(pkg):
    store = _churn_store(pkg)
    assert store.journey is not None
    sched = _sched(pkg, store)
    for _ in range(8):
        sched.run_once()
    store.flush_binds()
    view = _journey_view(store)
    bound = _bound_uids(store)
    tl = store.journey.timeline(bound[0])
    st = store.journey.stats()
    view["first"] = ([e["kind"] for e in tl["events"]], tl["monotone"],
                     tl["why_pending"], tl["time_to_bind_ms"] is not None)
    view["latencies_filled"] = (st["ttb_p50_ms"] is not None,
                                st["gang_ttfb_p50_ms"] is not None)
    store.close()
    return view


def test_churned_store_journeys_equal_jax_and_conserved():
    """Sustained re-pend churn over a pipelined store: the same journeys
    on both packages, every bound pod's complete and orphan-free, the
    steady-state repeats folded into bulk counters."""
    want, got = _both(_churn_run)
    assert got == want
    assert got["conservation"] == []
    assert got["stats"]["events"] > 0 and got["stats"]["rebinds"] > 0
    kinds, monotone, verdict, ttb = got["first"]
    assert kinds[0] == "enqueued" and "bound" in kinds
    assert monotone and verdict == "bound" and ttb
    assert got["latencies_filled"] == (True, True)
    # Dispatches and binds of the pipelined solve carry its flow id.
    assert any(sid for tl in got["timelines"].values()
               for kind, _d, sid in tl if kind == "bound")


def test_conservation_check_flags_orphans_and_incomplete():
    def run(pkg):
        jr = pkg.obs.JourneyLog(capacity=256)
        jr.pod_event("u-root", "enqueued", status=ST_PENDING, queue="q")
        first = sorted((a.reason, tuple(a.detail["uids"]))
                       for a in jr.conservation_check(["u-root",
                                                       "u-ghost"]))
        jr.pod_event("u-root", "bound")
        jr.pod_resync([("u-adopted", ST_BOUND)])
        return first, jr.conservation_check(["u-root", "u-adopted"])

    want, got = _both(run)
    assert got == want
    assert got[0] == [("journey-incomplete", ("u-root",)),
                      ("journey-orphan", ("u-ghost",))]
    assert got[1] == []


# -------------------------------------------------------- why-pending


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
    sched.run_once()  # dispatch: p0 -> one node, p1 -> the other
    for i in range(2):
        store.add_pod(api.Pod(
            name=f"thief{i}", annotations={api.GROUP_NAME_ANNOTATION: "g"},
            containers=[{"cpu": "1", "memory": "1Gi"}], node_name=f"n{i}"))
    sched.run_once()  # the guard voids both rows as capacity-taken
    view = _journey_view(store)
    starved = sorted(p.uid for p in store.pods.values()
                     if p.name.startswith("p") and not p.node_name)
    tl = store.journey.timeline(starved[0])
    view["starved"] = (len(starved), tl["why_pending"],
                       tl["time_to_bind_ms"])
    store.close()
    return view


def test_why_pending_for_capacity_starved_gang():
    want, got = _both(_theft_run)
    assert got == want
    n, verdict, ttb = got["starved"]
    assert n >= 1 and verdict.startswith("capacity-taken") and ttb is None


def test_why_pending_compresses_drop_chain():
    def run(pkg):
        jr = pkg.obs.JourneyLog(capacity=256)
        jr.pod_event("u1", "enqueued", status=ST_PENDING, queue="q")
        jr.pod_event("u1", "dispatched", solve_id=7)
        for _ in range(4):
            jr.pod_event("u1", "dropped", detail="capacity-taken")
        jr.pod_event("u1", "dropped", detail="topology-infeasible")
        jr.pod_event("u2", "enqueued", status=ST_PENDING)
        out = [jr.why_pending("u1"), jr.why_pending("nobody"),
               jr.why_pending("u2")]
        jr.pod_event("u2", "dispatched")
        jr.pod_event("u3", "enqueued", status=ST_PENDING)
        jr.pod_event("u3", "evicted")
        return out + [jr.why_pending("u2"), jr.why_pending("u3")]

    want, got = _both(run)
    assert got == want
    assert got == ["capacity-taken x4, topology-infeasible",
                   "unknown (no journey state)",
                   "never considered (queue backlog)",
                   "considered, no drops recorded (awaiting commit)",
                   "evicted (awaiting restore)"]


def _fabric_run(pkg, cycles=5):
    """The fabric drive: cycle 0 holds the require-contiguous gang as
    topology-infeasible and commits one rebalance wave; the victims are
    restored and the gang binds inside one block."""
    _reset_uid_counters()
    store = pkg.synth.fabric_cluster(binder=pkg.cache.FakeBinder())
    store.pipeline = False
    sched = _sched(pkg, store, REBALANCE_SCHEDULER_CONF)
    sim = pkg.sim.ClusterSimulator(store, grace_steps=2)
    views = []
    for _ in range(cycles):
        sched.run_once()
        views.append(_journey_view(store))
        sim.step()
    gang = sorted(p.uid for p in store.pods.values()
                  if p.name.startswith("fabgang"))
    store.close()
    return views, gang


def test_fabric_drive_why_pending_equal_jax(monkeypatch):
    """Every pending pod's verdict after every cycle equals the JAX
    package's; the gang first reads ``topology-infeasible``, the
    rebalance wave's victims are stitched to their restored pods, and at
    the end every gang pod is bound with a conserved journey."""
    monkeypatch.setenv("VOLCANO_TPU_REBALANCE_DRAIN_CAP", "64")
    (want, _), (got, gang) = _both(_fabric_run)
    assert len(got) == len(want)
    for step, (a, b) in enumerate(zip(want, got)):
        assert a == b, step
    first = got[0]["pending"]
    assert all(first[u] == "topology-infeasible" for u in gang)
    kinds = got[-1]["kinds"]
    assert kinds.get("migration-planned", 0) >= 1
    assert kinds.get("restored", 0) == kinds["migration-planned"]
    assert not any(u in got[-1]["pending"] for u in gang)
    assert got[-1]["conservation"] == []


CONF_PREEMPT = """
actions: "enqueue, allocate, preempt"
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
"""


def _preempt_run(pkg, cycles=8):
    _reset_uid_counters()
    cache = pkg.cache
    store = cache.ClusterStore(binder=cache.FakeBinder(),
                               evictor=cache.FakeEvictor())
    store.pipeline = False
    pkg.sim.ClusterSimulator.priority_tier_workload(
        store, workers=8, serving_tasks=4)
    sched = _sched(pkg, store, CONF_PREEMPT)
    sim = pkg.sim.ClusterSimulator(store, grace_steps=2)
    views = []
    for _ in range(cycles):
        sched.run_once()
        views.append(_journey_view(store))
        sim.step()
    store.close()
    return views


def test_preempt_drive_journeys_equal_jax():
    want, got = _both(_preempt_run)
    assert got == want
    kinds = got[-1]["kinds"]
    assert kinds.get("evicted", 0) >= 1
    assert kinds.get("restored", 0) >= 1
    assert got[-1]["conservation"] == []


# ----------------------------------------------------------- perfetto


def _perfetto_run(pkg):
    exp = export if pkg is volcano_tpu_torch else volcano_tpu.obs.export
    store = _churn_store(pkg, n_nodes=8, n_pods=32)
    sched = _sched(pkg, store)
    for _ in range(4):
        sched.run_once()
    store.flush_binds()
    trace = json.loads(json.dumps(exp.perfetto_trace(
        store.flight.recent(), journey=store.journey.trace_rows())))
    evs = trace["traceEvents"]
    jevs = [e for e in evs if e.get("cat") == "journey"]
    by_id = collections.defaultdict(list)
    for e in jevs:
        by_id[e["id"]].append(e["ph"])
    jtid = {e["tid"] for e in jevs}.pop()
    names = {m["args"]["name"] for m in evs
             if m.get("ph") == "M" and m["name"] == "thread_name"}
    store.close()
    return {
        "phases": sorted({e["ph"] for e in jevs}),
        "bracketed": all(p[0] == "b" and p[-1] == "e"
                         for p in by_id.values()),
        "tracks": len(by_id),
        "named": "journey" in names,
        "flow_on_track": any(e.get("cat") == "flow" and e["tid"] == jtid
                             for e in evs),
        "flow_ids": sorted({e["id"] for e in evs if e.get("cat") == "flow"}),
    }


def test_perfetto_export_emits_async_journey_tracks():
    want, got = _both(_perfetto_run)
    assert got == want
    assert got["phases"] == ["b", "e", "n"]
    assert got["bracketed"] and got["named"] and got["flow_on_track"]


# ------------------------------------------------- bounded ring + kill


def test_ring_is_bounded_and_overwrites_oldest():
    jr = JourneyLog(capacity=8)
    for k in range(20):
        jr.pod_event(f"u{k}", "enqueued", status=ST_PENDING)
    rows = jr.trace_rows()
    assert [r["uid"] for r in rows] == [f"u{k}" for k in range(12, 20)]
    st = jr.stats()
    assert (st["events"], st["events_dropped"], st["pods"]) == (20, 12, 20)
    assert jr.timeline("u0")["events"] == []


def _kill_run(pkg, monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_JOURNEY", "0")
    metrics = jax_metrics if pkg is volcano_tpu else port_metrics
    store = _churn_store(pkg, n_nodes=4, n_pods=16)
    detached = (store.journey, store.mirror.journey)
    before = dict(metrics.journey_events.data)
    sched = _sched(pkg, store)
    for _ in range(3):
        sched.run_once()
    store.flush_binds()
    out = (detached, dict(metrics.journey_events.data) == before,
           len(_bound_uids(store)), dict(store.binder.binds))
    store.close()
    return out


def test_kill_switch_detaches_journey(monkeypatch):
    want, got = _both(lambda pkg: _kill_run(pkg, monkeypatch))
    assert got == want
    assert got[0] == (None, None) and got[1] and got[2] > 0


def test_default_store_wires_auditor_slo_and_journey():
    store = volcano_tpu_torch.cache.ClusterStore()
    assert store.auditor is not None and store.auditor.slo is not None
    assert store.journey is not None
    assert store.mirror.audit is store.auditor
    assert store.mirror.journey is store.journey
    assert store.journey.slo is store.auditor.slo


# ------------------------------------------------ columnar bulk capture


class _Clock:
    """A stand-in for the ``time`` module: ``time_ns`` steps by a seeded
    amount (sometimes backward, for the monotone flag), ``perf_counter_ns``
    is 0, so the two logs see the same timestamps."""

    def __init__(self, seed):
        import random

        self.rng = random.Random(seed * 7 + 1)
        self.t = 10 ** 6

    def time_ns(self):
        self.t += self.rng.choice([5, 9, 13, -3]) * 1000
        return self.t

    def perf_counter_ns(self):
        return 0


def _random_drive(pkg, seed, monkeypatch):
    import random

    from importlib import import_module

    jmod = import_module(f"{pkg.__name__}.obs.journey")
    smod = import_module(f"{pkg.__name__}.obs.slo")
    monkeypatch.setattr(jmod, "time", _Clock(seed))
    rnd = random.Random(seed)
    slo = smod.SLOTracker()
    if seed % 2:
        slo.declare("ttb", 5.0, allowed_frac=0.05)
    jr = jmod.JourneyLog(capacity=64, slo=slo)
    uids = [f"u{i}" for i in range(40)]
    for step in range(300):
        op = rnd.random()
        sel = rnd.sample(uids, rnd.randrange(1, 12))
        if op < 0.2:
            for u in sel:
                jr.pod_event(u, "enqueued", status=1,
                             queue=rnd.choice(["a", "b", ""]),
                             gang=rnd.choice(["g1", "g2", "", "g3"]))
        elif op < 0.4:
            jr.pod_rows(sel, "dispatched", solve_id=rnd.randrange(4))
        elif op < 0.6:
            jr.pod_rows(sel, "bound", solve_id=rnd.randrange(4))
        elif op < 0.7:
            jr.pod_rows(sel, "dropped", detail=rnd.choice(["x", "y"]))
        elif op < 0.75:
            jr.pod_event(sel[0], "removed")
        elif op < 0.8:
            jr.pod_resync([(u, rnd.choice([1, 16, 64])) for u in sel])
        elif op < 0.85:
            jr.pod_event(sel[0], "evicted")
        elif op < 0.9:
            jr.pod_restored(sel[0], f"new{step}")
        elif op < 0.95:
            jr.pod_rows(sel + sel[:1], "bound")  # a uid twice
        else:
            jr.pod_event(sel[0], "status-sync", status=rnd.choice([1, 16]))
    st = jr.stats()
    st.pop("capture_ms")
    timelines = {}
    for u in uids + ["new5"]:
        tl = jr.timeline(u)
        timelines[u] = tl and {k: v for k, v in tl.items()
                               if k != "enqueued_us"}
    return {
        "stats": st,
        "rows": jr.trace_rows(),
        "verdicts": {u: jr.why_pending(u) for u in uids},
        "timelines": timelines,
        "rollup": jr.queue_rollup(),
        "conservation": [(a.reason, a.detail)
                         for a in jr.conservation_check(uids)],
        "windows": (list(jr._ttb_ms), list(jr._ttfc_ms),
                    list(jr._gang_ttfb_ms)),
        "slo": (dict(slo.observations), dict(slo.violations)),
    }


@pytest.mark.parametrize("seed", range(8))
def test_columnar_capture_equals_jax(seed, monkeypatch):
    """The port keeps per-pod summaries in columns and applies a batch's
    first dispatches and binds as array operations; on seeded random
    event streams (re-enqueues, drops, removals, resyncs, restores, a uid
    twice in a batch, a clock that steps back, an SLO budget that
    breaches) every read equals the JAX package's event-by-event log:
    stats, ring rows, verdicts, timelines, the queue rollup, the
    conservation check, the latency windows in order and the SLO lane."""
    want, got = _both(lambda pkg: _random_drive(pkg, seed, monkeypatch))
    for key in want:
        assert got[key] == want[key], key


# ----------------------------------------------------- debug endpoint


def _debug_run(pkg):
    """tests/test_journey.py's /debug/pods case: four churn cycles, then
    a bound pod's timeline with the store lock held, a missing pod, and
    the health rollup."""
    from test_torch_fixtures import debug_scrape

    store = _churn_store(pkg, n_nodes=8, n_pods=32)
    sched = _sched(pkg, store)
    for _ in range(4):
        sched.run_once()
    store.flush_binds()
    uid = _bound_uids(store)[0]
    got = debug_scrape(pkg, store, [f"/debug/pods/{uid}",
                                    "/debug/pods/does-not-exist",
                                    "/debug/health"],
                       locked=(f"/debug/pods/{uid}",))
    store.close()
    body = got[f"/debug/pods/{uid}"][1]
    roll = got["/debug/health"][1]["journey"]
    return {
        "uid": body["uid"],
        "kinds": [e["kind"] for e in body["events"]],
        "why": body["why_pending"],
        "fields": {k: body[k] for k in ("queue", "gang", "status",
                                        "last_kind", "monotone")},
        "missing": (got["/debug/pods/does-not-exist"][0],
                    sorted(got["/debug/pods/does-not-exist"][1])),
        "tracked": roll["pods_tracked"],
        "bound": {q: v["bound_total"] for q, v in roll["queues"].items()},
    }


def test_debug_pods_endpoint_equal_jax():
    want, got = _both(_debug_run)
    assert got == want
    assert got["why"] == "bound"
    assert got["kinds"][0] == "enqueued"
    assert got["missing"][0] == 404 and "error" in got["missing"][1]
    assert got["tracked"] > 0 and any(v > 0 for v in got["bound"].values())

