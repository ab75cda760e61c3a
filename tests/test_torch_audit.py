"""The port's conservation auditor and SLO layer against the JAX package's.

Twins of ``tests/test_audit.py``: the same synthetic cluster and cycle
feed, made from one seed, go through the JAX ``Scheduler`` and the port's
``Scheduler(device="cpu")`` with the auditor sampling every cycle; the
counts must be equal -- the ledger's per-reason flow totals, the
``audit_cycles`` modes, the reconciles, census skips and sampled cycles,
the anomaly reasons of each seeded fault.  Wall-clock latencies are never
compared.  The three wire-mirror cases run each package's store against
its own solver child on loopback TCP (the port's child on the CPU): a
generation that went backward, mirror bytes changed under a held
generation, and a replaced client that re-anchors.  The ``/debug``
endpoint case belongs to the service (ROADMAP.md, queue 1, item 6): not
twinned here.

Also here: every one of the port's six status writers of the fast cycle
(commit-bind, unbind, backfill-bind, backfill-revert, evict,
evict-revert) driven on both packages, the ledgers' per-reason counts
equal.
"""

import itertools
import json

import numpy as np
import pytest

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.cache
import volcano_tpu.obs.export
import volcano_tpu.sim
import volcano_tpu.synth
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.cache
import volcano_tpu_torch.sim
import volcano_tpu_torch.synth
from volcano_tpu_torch.metrics import metrics as port_metrics
from volcano_tpu_torch.obs import export
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

PKGS = (volcano_tpu, volcano_tpu_torch)
ST_BOUND = 16  # TaskStatus.Bound
ST_PENDING = 1  # TaskStatus.Pending


@pytest.fixture(autouse=True)
def _dense_sampling(monkeypatch):
    """Audit every cycle: the seeded faults must be found within two
    cycles."""
    monkeypatch.setenv("VOLCANO_TPU_AUDIT_SAMPLE", "1")
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    for k in ("VOLCANO_TPU_AUDIT", "VOLCANO_TPU_JOURNEY",
              "VOLCANO_TPU_PIPELINE", "VOLCANO_TPU_EVICT_CAP"):
        monkeypatch.delenv(k, raising=False)


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _sched(pkg, store, conf=None):
    if pkg is volcano_tpu:
        return JaxScheduler(store, conf_str=conf)
    return PortScheduler(store, conf_str=conf, device="cpu")


def _metrics(pkg):
    return jax_metrics if pkg is volcano_tpu else port_metrics


def _churn_store(pkg, n_nodes=16, n_pods=64, frac=3, pipeline=True):
    """tests/test_audit.py's store: every cycle re-pends a third of the
    bound pods."""
    _reset_uid_counters()
    store = pkg.synth.synthetic_cluster(n_nodes=n_nodes, n_pods=n_pods,
                                        gang_size=4, seed=3)
    store.pipeline = pipeline

    def feed(fc):
        m = fc.m
        rows = np.flatnonzero(
            (m.p_status[:fc.Pn] == ST_BOUND) & m.p_alive[:fc.Pn])
        if len(rows):
            fc._unbind_rows(rows[:max(1, len(rows) // frac)])

    store.cycle_feed = feed
    return store


def _audit_modes(pkg, before):
    return {k: v - before.get(k, 0.0)
            for k, v in _metrics(pkg).audit_cycles.data.items()
            if v - before.get(k, 0.0)}


def _summary(store, pkg, modes0):
    a = store.auditor
    st = a.audit_stats()
    return {
        "flows": dict(a.ledger.totals),
        "anomalies": dict(a.anomaly_counts),
        "stats": {k: st[k] for k in ("cycles", "sampled_cycles",
                                      "reconciles", "census_skips",
                                      "anomalies")},
        "modes": _audit_modes(pkg, modes0),
    }


def _both(run):
    """``run(pkg)`` on both packages; the two results."""
    return run(volcano_tpu), run(volcano_tpu_torch)


# --------------------------------------------------------- clean runs


def _clean_run(pkg):
    modes0 = dict(_metrics(pkg).audit_cycles.data)
    store = _churn_store(pkg)
    sched = _sched(pkg, store)
    sched.run_once()
    sched.run_once()  # pipeline fill: the first commit lands
    store.flush_binds()
    api = pkg.api
    victim = sorted((p for p in store.pods.values() if p.node_name),
                    key=lambda p: p.name)[0]
    store.delete_pod(victim)
    store.add_pod_group(api.PodGroup(name="fresh", min_member=1))
    store.add_pod(api.Pod(name="fresh-0",
                          annotations={api.GROUP_NAME_ANNOTATION: "fresh"},
                          containers=[{"cpu": "1", "memory": "1Gi"}]))
    for _ in range(6):
        sched.run_once()
    store.flush_binds()
    out = _summary(store, pkg, modes0)
    health = store.auditor.health()
    out["health"] = (health["status"], health["verifiers"]["audit"],
                     sorted(health["slo"]))
    store.close()
    return out


def test_clean_churn_run_equal_and_zero_anomalies():
    """Bind / unbind churn and store-edge add / delete, audited every
    cycle: no anomaly on either package, and the flows, modes and counts
    are equal."""
    want, got = _both(_clean_run)
    assert got == want
    assert got["anomalies"] == {}
    assert got["stats"]["reconciles"] >= 6
    assert got["stats"]["sampled_cycles"] >= 6
    for reason, least in (("commit-bind", 1), ("unbind", 1),
                          ("pod-deleted", 1), ("pod-added", 1)):
        assert got["flows"].get(reason, 0) >= least, got["flows"]
    assert got["health"][:2] == ("ok", True)


def _idle_run(pkg, monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_AUDIT_SAMPLE", "64")
    modes0 = dict(_metrics(pkg).audit_cycles.data)
    _reset_uid_counters()
    store = pkg.synth.synthetic_cluster(n_nodes=4, n_pods=8, gang_size=2,
                                        seed=5)
    store.pipeline = False
    assert store.auditor.sample == 64
    sched = _sched(pkg, store)
    for _ in range(5):
        sched.run_once()
    store.flush_binds()
    out = _summary(store, pkg, modes0)
    store.close()
    return out


def test_idle_cycles_skip_census(monkeypatch):
    want, got = _both(lambda pkg: _idle_run(pkg, monkeypatch))
    assert got == want
    assert got["stats"]["census_skips"] >= 1
    assert got["modes"].get((("mode", "skipped"),), 0) >= 1
    assert got["anomalies"] == {}


# ----------------------------------------------- seeded anomaly classes


def _bound_rows(store):
    m = store.mirror
    n = len(m.p_uid)
    return np.flatnonzero(m.p_alive[:n] & (m.p_status[:n] == ST_BOUND))


def _conservation_run(pkg):
    store = _churn_store(pkg)
    sched = _sched(pkg, store)
    for _ in range(3):
        sched.run_once()
    assert store.auditor.total_anomalies() == 0
    before = _metrics(pkg).audit_anomalies.data.get(
        (("reason", "conservation-mismatch"),), 0.0)
    store.mirror.p_status[_bound_rows(store)[0]] = ST_PENDING  # silent
    sched.run_once()
    sched.run_once()
    anom = next(a for a in store.auditor.anomalies()
                if a.reason == "conservation-mismatch")
    flagged = [d["reason"] for rec in store.flight.recent()
               for d in rec.anomalies]
    out = {
        "counts": dict(store.auditor.anomaly_counts),
        "classes": anom.detail["classes"],
        "metric": _metrics(pkg).audit_anomalies.data.get(
            (("reason", "conservation-mismatch"),), 0.0) - before,
        "in_record": "conservation-mismatch" in flagged,
    }
    store.close()
    return out


def test_seeded_conservation_mismatch():
    """A silent status flip (no flow, no mutation stamp) is found within
    two cycles with the same per-class diff on both packages, counted and
    carried by the detecting cycle's flight record."""
    want, got = _both(_conservation_run)
    assert got == want
    assert got["counts"].get("conservation-mismatch", 0) >= 1
    assert got["classes"] and got["metric"] >= 1 and got["in_record"]


def _aggregate_run(pkg):
    store = _churn_store(pkg)
    sched = _sched(pkg, store)
    for _ in range(3):
        sched.run_once()
    assert store.auditor.total_anomalies() == 0
    store.mirror._cycle_aggr.n_used[0, 0] += 5.0
    sched.run_once()
    sched.run_once()
    anom = next(a for a in store.auditor.anomalies()
                if a.reason == "aggregate-divergence")
    out = (dict(store.auditor.anomaly_counts), anom.detail["message"])
    store.close()
    return out


def test_seeded_aggregate_plane_corruption():
    want, got = _both(_aggregate_run)
    assert got == want
    assert got[0].get("aggregate-divergence", 0) >= 1
    assert "n_used" in got[1]


def _ledger_run(pkg):
    store = _churn_store(pkg)
    sched = _sched(pkg, store)
    sched.run_once()
    sched.run_once()
    store.flush_binds()
    victim = sorted((p for p in store.pods.values() if p.node_name),
                    key=lambda p: p.name)[0]
    gang = victim.annotations[pkg.api.GROUP_NAME_ANNOTATION]
    ledger = store.migrations = pkg.actions.rebalance.MigrationLedger()
    ledger.register(victim.uid, f"default/{gang}", "", action="preempt")
    ledger.pod_deleted = lambda *a, **kw: None  # the restore hook dies
    victim.deleting = True
    store.delete_pod(victim)
    sched.run_once()
    anom = next(a for a in store.auditor.anomalies()
                if a.reason == "ledger-restore-lost")
    out = (dict(store.auditor.anomaly_counts), anom.detail["victim"],
           victim.uid, anom.detail["action"])
    store.close()
    return out


def test_seeded_ledger_restore_drop():
    import volcano_tpu.actions.rebalance  # noqa: F401
    import volcano_tpu_torch.actions.rebalance  # noqa: F401

    want, got = _both(_ledger_run)
    assert got == want
    assert got[0].get("ledger-restore-lost", 0) >= 1
    assert got[1] == got[2]


def _slo_run(pkg):
    from importlib import import_module

    min_samples = import_module(f"{pkg.__name__}.obs.slo").MIN_SAMPLES
    store = _churn_store(pkg)
    store.auditor.slo.declare("cycle", 0.0001, allowed_frac=0.001)
    sched = _sched(pkg, store)
    for _ in range(min_samples + 2):
        sched.run_once()
    anom = next(a for a in store.auditor.anomalies()
                if a.reason == "slo-budget-exceeded")
    lane = store.auditor.health()["slo"]["cycle"]
    out = {
        "counts": dict(store.auditor.anomaly_counts),
        "lane": anom.detail["lane"],
        "burning": anom.detail["burn_rate"] >= 1.0,
        "breached": lane["breached"],
        "remaining": lane["budget_remaining"],
        "gauge": _metrics(pkg).slo_burn_rate.data[
            (("lane", "cycle"),)] >= 1.0,
    }
    store.close()
    return out


def test_seeded_slo_budget_breach():
    """An impossible budget breaches once, at the edge, when the window
    holds MIN_SAMPLES observations: the same on both packages."""
    want, got = _both(_slo_run)
    assert got == want
    assert got["counts"].get("slo-budget-exceeded") == 1
    assert got["lane"] == "cycle" and got["burning"] and got["breached"]
    assert got["remaining"] == 0.0 and got["gauge"]


def _encode_run(pkg):
    _reset_uid_counters()
    api = pkg.api
    store = pkg.synth.synthetic_cluster(n_nodes=4, n_pods=8, gang_size=2,
                                        seed=5)
    store.pipeline = True
    sched = _sched(pkg, store)
    sched.run_once()
    # An unschedulable pending pod keeps the encode cache under a stable
    # key across idle cycles.
    store.add_pod_group(api.PodGroup(name="probe", min_member=1))
    store.add_pod(api.Pod(
        name="probe-0", annotations={api.GROUP_NAME_ANNOTATION: "probe"},
        containers=[{"cpu": "900000", "memory": "900000Gi"}]))
    for _ in range(3):
        sched.run_once()
    cached = store._encode_cache
    assert cached is not None
    assert store.auditor.total_anomalies() == 0
    cached["pid"][0] += 1  # the corruption
    sched.run_once()
    sched.run_once()
    anom = next(a for a in store.auditor.anomalies()
                if a.reason == "cache-content-mutated")
    out = (dict(store.auditor.anomaly_counts), anom.detail["slot"],
           anom.detail["kind"])
    store.close()
    return out


def test_seeded_encode_cache_mutation():
    want, got = _both(_encode_run)
    assert got == want
    assert got[0].get("cache-content-mutated", 0) >= 1
    assert got[1] == "encode"


def _reenable_run(pkg):
    modes0 = dict(_metrics(pkg).audit_cycles.data)
    store = _churn_store(pkg)
    sched = _sched(pkg, store)
    sched.run_once()
    store.auditor.set_enabled(False)
    sched.run_once()  # churn with no flow bookkeeping
    store.auditor.set_enabled(True)
    sched.run_once()
    sched.run_once()
    out = _summary(store, pkg, modes0)
    store.close()
    return out


def test_audit_disable_and_reenable_reanchors():
    """VOLCANO_TPU_AUDIT's A/B seam: disabled, nothing is recorded; the
    re-enable re-anchors, so the unrecorded churn reads as no mismatch."""
    want, got = _both(_reenable_run)
    assert got == want
    assert got["anomalies"] == {}
    assert got["stats"]["cycles"] == 3


class _CycStub:
    """The end_cycle surface of a FastCycle, for audit passes driven
    between real cycles (a real cycle would re-dispatch and move the wire
    generation the seed corrupts)."""

    def __init__(self, store):
        self.store = store
        self.m = store.mirror
        self.stats = {"dispatched_solve_id": None}
        self.lanes = {}


def _wire_store(pkg):
    """A store whose solves ship over loopback TCP to its own package's
    solver child, so the wire mirror the audit guards is the production
    one."""
    import threading

    if pkg is volcano_tpu:
        from volcano_tpu.solver_service import RemoteSolver, SolverServer

        server = SolverServer(port=0)
    else:
        from volcano_tpu_torch.solver_service import (RemoteSolver,
                                                      SolverServer)

        server = SolverServer(port=0, device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    store = _churn_store(pkg, n_nodes=8, n_pods=16)
    client = RemoteSolver(f"127.0.0.1:{server.port}", timeout=60.0)
    store.remote_solver = client
    sched = _sched(pkg, store)
    for _ in range(3):
        sched.run_once()  # real frames ship; the sentinel anchors
    store.flush_binds()
    assert client._wire.arrays is not None, "no wire mirror to audit"
    assert store.auditor.total_anomalies() == 0
    return store, server, client, RemoteSolver


def _wire_close(store, server, *clients):
    for c in clients:
        c.close()
    server.shutdown()
    store.close()


def _wire_skew_run(pkg):
    store, server, client, _cls = _wire_store(pkg)
    before = _metrics(pkg).audit_anomalies.data.get(
        (("reason", "wire-mirror-divergence"),), 0)
    client._gen -= 1  # the corruption: the generation went backward
    anoms = store.auditor.end_cycle(_CycStub(store), 0.01)
    after = _metrics(pkg).audit_anomalies.data.get(
        (("reason", "wire-mirror-divergence"),), 0)
    out = ([a.reason for a in anoms], anoms[0].detail["kind"],
           after - before,
           [a.reason for a in store.auditor.anomalies()])
    _wire_close(store, server, client)
    return out


def test_seeded_wire_generation_skew():
    want, got = _both(_wire_skew_run)
    assert got == want
    assert got[0] == ["wire-mirror-divergence"]
    assert got[1] == "key-regressed" and got[2] == 1


def _wire_mutation_run(pkg):
    store, server, client, _cls = _wire_store(pkg)
    first = store.auditor.end_cycle(_CycStub(store), 0.01)
    arr = client._wire.arrays[0]
    arr.reshape(-1)[0] += 1  # in-place mutation under the same gen
    anoms = store.auditor.end_cycle(_CycStub(store), 0.01)
    out = (first, [a.reason for a in anoms], anoms[0].detail["kind"])
    _wire_close(store, server, client)
    return out


def test_seeded_wire_mirror_mutation():
    want, got = _both(_wire_mutation_run)
    assert got == want
    assert got[0] == [] and got[1] == ["wire-mirror-divergence"]
    assert got[2] == "content-changed-under-key"


def _wire_replace_run(pkg):
    store, server, client, cls = _wire_store(pkg)
    assert client._gen > 0
    fresh = cls(f"127.0.0.1:{server.port}", timeout=60.0)
    store.remote_solver = fresh  # failover: a brand-new client, gen 0
    out = (store.auditor.end_cycle(_CycStub(store), 0.01),
           store.auditor.end_cycle(_CycStub(store), 0.01),
           store.auditor.total_anomalies())
    _wire_close(store, server, fresh, client)
    return out


def test_replaced_wire_client_reanchors_not_regresses():
    want, got = _both(_wire_replace_run)
    assert got == want == ([], [], 0)


def test_kill_switch_leaves_the_auditor_off(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_AUDIT", "0")
    store = _churn_store(volcano_tpu_torch, n_nodes=4, n_pods=16)
    sched = _sched(volcano_tpu_torch, store)
    for _ in range(3):
        sched.run_once()
    store.flush_binds()
    assert store.auditor is not None and not store.auditor.enabled
    assert store.auditor.audit_stats()["cycles"] == 0
    assert store.auditor.ledger.totals == {}
    assert store.binder.binds
    store.close()


def _export_run(pkg):
    exp = export if pkg is volcano_tpu_torch else volcano_tpu.obs.export
    store = _churn_store(pkg)
    sched = _sched(pkg, store)
    for _ in range(3):
        sched.run_once()
    store.mirror.p_status[_bound_rows(store)[0]] = ST_PENDING
    sched.run_once()
    trace = json.loads(json.dumps(exp.perfetto_trace(store.flight.recent())))
    instants = sorted(e["name"] for e in trace["traceEvents"]
                      if e.get("cat") == "audit" and e.get("ph") == "i")
    store.close()
    return instants


def test_perfetto_export_emits_anomaly_instants():
    want, got = _both(_export_run)
    assert got == want
    assert "anomaly:conservation-mismatch" in got


def test_device_tensors_are_never_hashed():
    """A tensor in a sentinel slot is signed by its type and shape: its
    values may change under a held key without a read (a device tensor
    is never copied to the host), while a numpy array's may not."""
    import torch

    from volcano_tpu_torch.obs.audit import _content_sig

    t = torch.zeros(4, 3)
    sig = _content_sig([t])
    t += 1
    assert _content_sig([t]) == sig
    assert _content_sig([torch.zeros(5, 3)]) != sig
    a = np.zeros(12)
    sig = _content_sig([a])
    a[3] = 1
    assert _content_sig([a]) != sig


# ------------------------------------------- the six status writers


CONF_BACKFILL = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
"""

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


def _backfill_store(pkg, fail):
    """One real pod and four BestEffort pods of one gang on two nodes;
    with ``fail`` the binder fails every other backfill bind once."""
    api, cache = pkg.api, pkg.cache
    failure = cache.interface.BindFailure

    class Binder(cache.FakeBinder):
        def __init__(self):
            super().__init__()
            self.failed = set()

        def bind_batch(self, pairs):
            keys = [f"{p.namespace}/{p.name}" for p, _ in pairs]
            bad = [k for i, k in enumerate(keys)
                   if fail and i % 2 and k not in self.failed]
            self.failed.update(bad)
            for (pod, host), key in zip(pairs, keys):
                if key not in bad:
                    self.bind(pod, host)
            if bad:
                raise failure(bad)

    store = cache.ClusterStore(binder=Binder())
    store.pipeline = False
    for i in range(2):
        store.add_node(api.Node(name=f"n{i}", allocatable={
            "cpu": "4", "memory": "8Gi", "pods": 20}))
    store.add_pod_group(api.PodGroup(name="g", min_member=1))
    store.add_pod(api.Pod(name="real",
                          annotations={api.GROUP_NAME_ANNOTATION: "g"},
                          containers=[{"cpu": "1", "memory": "1Gi"}]))
    for k in range(4):
        store.add_pod(api.Pod(name=f"be{k}",
                              annotations={api.GROUP_NAME_ANNOTATION: "g"},
                              containers=[{}]))
    return store


class _FlakyEvictor:
    """Fails every other key of each eviction batch once."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.evicts = []
        self.failed = set()

    def evict_keys(self, keys):
        bad = [k for i, k in enumerate(keys)
               if i % 2 and k not in self.failed]
        self.failed.update(bad)
        self.evicts.extend(k for k in keys if k not in bad)
        if bad:
            raise self.pkg.cache.interface.EvictFailure(bad)

    def evict(self, pod):
        self.evicts.append(f"{pod.namespace}/{pod.name}")


def _tier_store(pkg, fail):
    cache = pkg.cache
    store = cache.ClusterStore(
        binder=cache.FakeBinder(),
        evictor=_FlakyEvictor(pkg) if fail else cache.FakeEvictor())
    store.pipeline = False
    pkg.sim.ClusterSimulator.priority_tier_workload(
        store, workers=8, serving_tasks=4)
    return store


def _writer_run(pkg, scenario):
    _reset_uid_counters()
    if scenario in ("churn", "churn-pipelined"):
        store = _churn_store(pkg, pipeline=scenario == "churn-pipelined")
        conf, cycles, sim = None, 5, None
    elif scenario.startswith("backfill"):
        store = _backfill_store(pkg, fail=scenario == "backfill-failing")
        conf, cycles, sim = CONF_BACKFILL, 3, None
    else:
        store = _tier_store(pkg, fail=scenario == "preempt-failing")
        conf, cycles = CONF_PREEMPT, 8
        sim = pkg.sim.ClusterSimulator(store, grace_steps=2)
    sched = _sched(pkg, store, conf)
    for _ in range(cycles):
        sched.run_once()
        if sim is not None:
            sim.step()
    store.flush_binds()
    out = (dict(store.auditor.ledger.totals),
           dict(store.auditor.anomaly_counts))
    store.close()
    return out


# writer -> the scenario that drives it
WRITERS = {
    "commit-bind": "churn",
    "unbind": "churn-pipelined",
    "backfill-bind": "backfill",
    "backfill-revert": "backfill-failing",
    "evict": "preempt",
    "evict-revert": "preempt-failing",
}
_WRITER_CACHE = {}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_status_writer_flows_equal_jax(writer):
    """Each writer's scenario on both packages: the ledgers' per-reason
    flow counts are equal, the writer's own count is positive, and no
    anomaly is raised."""
    import volcano_tpu.actions.rebalance  # noqa: F401
    import volcano_tpu_torch.actions.rebalance  # noqa: F401

    scenario = WRITERS[writer]
    if scenario not in _WRITER_CACHE:
        _WRITER_CACHE[scenario] = _both(
            lambda pkg: _writer_run(pkg, scenario))
    want, got = _WRITER_CACHE[scenario]
    assert got == want
    flows, anomalies = got
    assert flows.get(writer, 0) > 0, flows
    assert anomalies == {}
