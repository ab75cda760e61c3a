"""The host victim walk (``VOLCANO_TPU_EVICT_DEVICE=0``) against the JAX
package's, cycle by cycle.

Twin runs (``test_torch_fixtures.walk_run``): the JAX ``Scheduler`` and the
port's ``Scheduler(device="cpu")`` on the same store, built after the uid
counters restart, ``ClusterSimulator`` stepped after every cycle.  Every
cycle the uids the walk evicted and pipelined (in order), the evictor's
keys, the binds, the PodGroup phases and the mirror state (uid, status,
node) must be equal, exactly.  The inputs and seeds are those of the JAX
package's legacy eviction suites: ``tests/test_fastpath_evict.py``
(preempt seeds 0-2, the multi-queue case, resync across an interleaved
allocate), ``tests/test_evict_oracle.py`` (the fuzz seeds, gang protection,
conformance, statement rollback, scalar resources) and
``tests/test_whatif_preempt.py``'s host-walk parity and kill switch.  The
port's fast path is also held to the port's object session on the fuzz
seeds; a pipelined twin, the auditor and the journey, and a lockdep-armed
walk cycle complete it.  ``VOLCANO_TPU_FALLBACK=never`` stays set: a walk
failure fails the test instead of falling back.
"""

import collections

import numpy as np
import pytest

import volcano_tpu
import volcano_tpu.api
import volcano_tpu.cache
import volcano_tpu.fastpath_evict
import volcano_tpu.sim
import volcano_tpu.synth

import volcano_tpu_torch
import volcano_tpu_torch.fastpath_evict as port_fe
import volcano_tpu_torch.sim
import volcano_tpu_torch.synth
from volcano_tpu_torch.metrics import metrics as port_metrics
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

from test_torch_fixtures import (
    EVICT_CONF,
    EVICT_CONF_INTERLEAVED,
    oversubscribed_store,
    reset_uid_counters,
    rollback_store,
    scalar_store,
    tier_store,
    tiny_priority_store,
    two_queue_store,
    walk_run,
)

FUZZ_SEEDS = range(8)

# tests/test_whatif_preempt.py's preempt-only conf.
PREEMPT_CONF = """
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


@pytest.fixture(autouse=True)
def _walk(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "0")
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "never")
    for k in ("VOLCANO_TPU_NO_NATIVE", "VOLCANO_TPU_FASTPATH",
              "VOLCANO_TPU_PIPELINE", "VOLCANO_TPU_EVICT_CAP",
              "VOLCANO_TPU_LOCKDEP"):
        monkeypatch.delenv(k, raising=False)


def _twin(build, **kw):
    """Both packages' walk records; equal field by field, every cycle."""
    want = walk_run(volcano_tpu, build, **kw)
    got = walk_run(volcano_tpu_torch, build, **kw)
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert g[k] == w[k], f"cycle {c}: {k} differs"
    return got


def _preempt_cluster(seed):
    return lambda pkg: pkg.synth.preempt_cluster(n_nodes=8, n_pending=12,
                                                 seed=seed)


# ------------------------------------------ tests/test_fastpath_evict.py


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preempt_cluster_walk_equals_jax(seed):
    got = _twin(_preempt_cluster(seed), cycles=4)
    assert got[0]["evicted"] and got[0]["pipelined"]
    assert got[-1]["binds"], "the pipelined gangs never bound"


@pytest.mark.parametrize("seed", [0, 1])
def test_multiqueue_walk_equals_jax(seed):
    _twin(lambda pkg: pkg.synth.synthetic_cluster(
        n_nodes=10, n_pods=40, gang_size=4, n_queues=3,
        queue_weights=(1, 2, 4), seed=seed), cycles=2)


@pytest.mark.parametrize("seed", [0, 1])
def test_resync_across_interleaved_allocate_equals_jax(seed, monkeypatch):
    """preempt before allocate, reclaim after it: the evictor built by
    preempt must resync its future idle, slot mask, share memos and
    resident lists before reclaim reads them."""
    calls = {"n": 0}
    orig = port_fe.FastEvictor.resync

    def spy(self):
        calls["n"] += 1
        return orig(self)

    monkeypatch.setattr(port_fe.FastEvictor, "resync", spy)
    _twin(_preempt_cluster(seed), conf=EVICT_CONF_INTERLEAVED, cycles=2)
    assert calls["n"] >= 1


def test_preempt_runs_the_walk_not_the_device_lane(monkeypatch):
    """The walk's preempt runs, the what-if engine does not, and each walk
    action stamps the mirror's mutation counter."""
    called = {"preempt": 0, "whatif": 0}
    orig = port_fe.FastEvictor.preempt

    def spy(self):
        called["preempt"] += 1
        return orig(self)

    from volcano_tpu_torch import whatif

    def no_device_lane(cyc, name):
        called["whatif"] += 1

    monkeypatch.setattr(port_fe.FastEvictor, "preempt", spy)
    monkeypatch.setattr(whatif, "run_evict_action", no_device_lane)
    store = volcano_tpu_torch.synth.preempt_cluster(n_nodes=4, n_pending=6,
                                                    seed=0)
    seqs = []
    orig_reclaim = port_fe.FastEvictor.reclaim

    def reclaim_spy(self):
        seqs.append(self.cyc.m.mutation_seq)
        return orig_reclaim(self)

    monkeypatch.setattr(port_fe.FastEvictor, "reclaim", reclaim_spy)
    before = store.mirror.mutation_seq
    PortScheduler(store, conf_str=EVICT_CONF, device="cpu").run_once()
    assert called == {"preempt": 1, "whatif": 0}
    # preempt's stamp lands before reclaim runs, reclaim's after it.
    assert seqs and seqs[0] > before
    assert store.mirror.mutation_seq > seqs[0]
    assert store.evictor.evicts


# ------------------------------------------- tests/test_evict_oracle.py


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_walk_equals_jax(seed):
    _twin(lambda pkg: oversubscribed_store(pkg, seed), cycles=3)


def _port_cycle(build, fastpath, monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_FASTPATH", "1" if fastpath else "0")
    reset_uid_counters()
    store = build(volcano_tpu_torch)
    PortScheduler(store, conf_str=EVICT_CONF, device="cpu").run_once()
    return store


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_fast_equals_port_object_session(seed, monkeypatch):
    """The port's fast walk and the port's object session (two independent
    implementations of preempt.go / reclaim.go) evict the same pods."""
    build = lambda pkg: oversubscribed_store(pkg, seed)  # noqa: E731
    fast = _port_cycle(build, True, monkeypatch)
    obj = _port_cycle(build, False, monkeypatch)
    assert fast.flight.last().path != "object"
    assert obj.flight.last().path == "object"
    assert set(fast.evictor.evicts) == set(obj.evictor.evicts)


def _groups_and_running(store):
    api = volcano_tpu_torch.api
    before = {}
    for pg in store.pod_groups.values():
        before[pg.name] = sum(
            1 for p in store.pods.values()
            if p.annotations.get(api.GROUP_NAME_ANNOTATION) == pg.name
            and p.phase == api.PodPhase.Running)
    return before


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_gang_protection_property(seed, monkeypatch):
    """gang.go:74-98: a walk eviction never takes a running job below its
    MinAvailable (unless MinAvailable is 1)."""
    api = volcano_tpu_torch.api
    reset_uid_counters()
    store = oversubscribed_store(volcano_tpu_torch, seed)
    before = _groups_and_running(store)
    PortScheduler(store, conf_str=EVICT_CONF, device="cpu").run_once()
    by_key = {f"{p.namespace}/{p.name}": p for p in store.pods.values()}
    evicted = collections.Counter(
        by_key[k].annotations[api.GROUP_NAME_ANNOTATION]
        for k in store.evictor.evicts)
    for grp, n in evicted.items():
        pg = store.pod_groups[f"default/{grp}"]
        if pg.min_member != 1:
            assert before[grp] - n >= pg.min_member, (seed, grp)


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_conformance_property(seed):
    """conformance.go:44-66: critical pods are never victims."""
    reset_uid_counters()
    store = oversubscribed_store(volcano_tpu_torch, seed)
    critical = {
        f"{p.namespace}/{p.name}" for p in store.pods.values()
        if p.priority_class in ("system-cluster-critical",
                                "system-node-critical")
    }
    PortScheduler(store, conf_str=EVICT_CONF, device="cpu").run_once()
    assert not set(store.evictor.evicts) & critical


def test_statement_rollback_equals_jax():
    """statement.go:324-367: a preemptor that can never reach Pipelined
    commits nothing -- no eviction dispatched, no pod deleting, node
    accounting unchanged -- on both packages."""
    got = _twin(rollback_store, cycles=2)
    assert not got[-1]["evicts"] and not got[-1]["pipelined"]
    reset_uid_counters()
    store = rollback_store(volcano_tpu_torch)
    used = store.nodes["n0"].used.clone()
    PortScheduler(store, conf_str=EVICT_CONF, device="cpu").run_once()
    assert not any(p.deleting for p in store.pods.values())
    node = store.nodes["n0"]
    assert abs(node.used.milli_cpu - used.milli_cpu) < 1e-6
    assert abs(node.used.memory - used.memory) < 1e-6
    m = store.mirror
    assert sorted(int(s) for s in m.p_status[:m.n_pods]) == \
        sorted([1, 32, 32])  # Pending, Running, Running


def test_undo_log_restores_every_counter():
    """A statement's evictions and pipelines rolled back through the undo
    log leave the mirror status and every cycle counter as they were."""
    reset_uid_counters()
    store = volcano_tpu_torch.synth.preempt_cluster(n_nodes=4, n_pending=8,
                                                    seed=0)
    seen = {}
    orig = port_fe.FastEvictor.preempt

    def probe(self):
        c, st = self.cyc, self.st
        names = ("j_cnt_alloc", "j_cnt_run", "j_cnt_releasing",
                 "j_ready_base", "j_cnt_pending", "j_alloc_res", "q_alloc",
                 "n_releasing", "n_ntasks")
        before = {k: np.array(getattr(c, k), copy=True) for k in names}
        fi0, pipe0 = st.fi.copy(), st.n_pipelined.copy()
        status0 = c.m.p_status.copy()
        running = np.flatnonzero(c.m.p_status[:c.Pn] == 32)
        pending = np.flatnonzero(c.m.p_status[:c.Pn] == 1)
        log_ = []
        for r in running[:3].tolist():
            st.evict(r, log_)
        st.pipeline(int(pending[0]), int(c.m.p_node[running[0]]), log_)
        assert len(log_) == 4 and st.pipelined_rows
        st.rollback(log_)
        for k in names:
            assert np.array_equal(getattr(c, k), before[k]), k
        assert np.array_equal(st.fi, fi0)
        assert np.array_equal(st.n_pipelined, pipe0)
        assert np.array_equal(c.m.p_status, status0)
        assert not st.pipelined_rows and not st.evicted_rows
        seen["ok"] = True
        return orig(self)

    port_fe.FastEvictor.preempt = probe
    try:
        PortScheduler(store, conf_str=EVICT_CONF, device="cpu").run_once()
    finally:
        port_fe.FastEvictor.preempt = orig
    assert seen.get("ok")


@pytest.mark.parametrize("seed", range(4))
def test_scalar_resources_walk_equals_jax(seed):
    got = _twin(lambda pkg: scalar_store(pkg, seed), cycles=2)
    assert got[0]["evicted"]


# ---------------------------------------- tests/test_whatif_preempt.py


def test_host_walk_parity_with_object_session(monkeypatch):
    """test_whatif_preempt.py:319: the walk evicts what the object session
    evicts and leaves the same placements, on both packages; it never
    touches the what-if machinery."""
    got = _twin(tiny_priority_store, conf=PREEMPT_CONF, cycles=1)
    reset_uid_counters()
    fast = tiny_priority_store(volcano_tpu_torch)
    PortScheduler(fast, conf_str=PREEMPT_CONF, device="cpu").run_once()
    monkeypatch.setenv("VOLCANO_TPU_FASTPATH", "0")
    reset_uid_counters()
    obj = tiny_priority_store(volcano_tpu_torch)
    PortScheduler(obj, conf_str=PREEMPT_CONF, device="cpu").run_once()
    assert sorted(fast.evictor.evicts) == sorted(obj.evictor.evicts) \
        == got[0]["evicts"]
    state = lambda s: sorted((p.name, p.node_name, str(p.phase))  # noqa
                             for p in s.pods.values())
    assert state(fast) == state(obj)
    assert fast.migrations is None
    fast.close()
    obj.close()


def test_kill_switch_walk_equals_jax():
    """test_whatif_preempt.py:492: with the switch at 0 the walk evicts
    without the what-if engine (no ledger, no what-if plan counted), and
    the serving gang binds as on the JAX package."""
    before = dict(port_metrics.whatif_plans.data)
    got = _twin(lambda pkg: tier_store(pkg, workers=4, serving=2),
                conf=PREEMPT_CONF, cycles=5, grace=2,
                on_cycle=lambda s: {"ledger": s.migrations is None})
    assert got[0]["evicts"], "host walk did not evict"
    assert all(r["ledger"] for r in got)
    assert sum(1 for k in got[-1]["binds"] if "serving" in k) == 2
    assert dict(port_metrics.whatif_plans.data) == before


# ------------------------------------------------ pipelined sessions


@pytest.mark.parametrize("make,conf,grace", [
    (_preempt_cluster(0), EVICT_CONF, 1),
    (lambda pkg: tier_store(pkg, workers=6, serving=3), PREEMPT_CONF, 2),
    (two_queue_store, EVICT_CONF, 1),
], ids=["preempt-cluster", "tier", "two-queue"])
def test_pipelined_walk_equals_jax(make, conf, grace):
    """A pipelined store with the walk selected: the walk runs after the
    allocate dispatch, and the in-flight commit meets the staleness
    guard's re-validation, as on the JAX package."""
    got = _twin(make, conf=conf, cycles=5, grace=grace, pipeline=True)
    assert got[0]["evicted"]
    assert got[-1]["binds"]


# ---------------------------------------- observability and lockdep


def _obs(store):
    jr = store.journey
    return {
        "anomalies": store.auditor.total_anomalies(),
        "audited": store.auditor.audit_stats()["cycles"],
        "evicted_rows": sorted(r["uid"] for r in jr.trace_rows()
                               if r["kind"] == "evicted"),
        "reverted_rows": sorted(r["uid"] for r in jr.trace_rows()
                                if r["kind"] == "evict-reverted"),
    }


@pytest.mark.parametrize("make,conf", [
    (lambda pkg: tier_store(pkg, workers=6, serving=3), PREEMPT_CONF),
    (lambda pkg: oversubscribed_store(pkg, 2), EVICT_CONF),
    (two_queue_store, EVICT_CONF),
], ids=["preempt", "fuzz-2", "reclaim"])
def test_walk_audit_and_journey_equal_jax(make, conf):
    """No auditor anomaly on either package, and the journey's
    ``evicted`` / ``evict-reverted`` rows equal the JAX package's."""
    got = _twin(make, conf=conf, cycles=4, grace=2, on_cycle=_obs)
    assert all(r["anomalies"] == 0 for r in got)
    assert got[-1]["audited"] >= 1
    assert got[-1]["evicts"]


def test_walk_cycle_under_lockdep_reports_nothing(monkeypatch):
    """A lockdep-armed walk (preempt statements, the reclaim drive, the
    cycle-end flush) reports no violation and no order cycle."""
    from volcano_tpu_torch.obs import lockdep

    monkeypatch.setenv("VOLCANO_TPU_LOCKDEP", "1")
    stores = []
    try:
        for make in (_preempt_cluster(0), two_queue_store):
            reset_uid_counters()
            store = make(volcano_tpu_torch)
            stores.append(store)
            sched = PortScheduler(store, conf_str=EVICT_CONF, device="cpu")
            for _ in range(2):
                sched.run_once()
            assert store.evictor.evicts
            with store.auditor._lock:
                bad = [a.reason for a in store.auditor._ring
                       if a.reason in ("lockdep-violation",
                                       "lock-order-cycle")]
            assert bad == []
        st = lockdep.stats()
        assert st["active"]
        assert st["violations"] == 0 and st["order_cycles"] == 0
    finally:
        for s in stores:
            s.close()
        lockdep.reset()


def test_walk_never_reads_a_device_plane(monkeypatch):
    """The allocate solves of walk cycles keep ``host_reads`` at 0."""
    from volcano_tpu_torch.ops import wave

    reads = []
    orig = wave.solve_wave

    def spy(*a, **kw):
        out = orig(*a, **kw)
        reads.append(wave.LAST_TWOPHASE.get("host_reads"))
        return out

    monkeypatch.setattr(wave, "solve_wave", spy)
    reset_uid_counters()
    store = volcano_tpu_torch.synth.preempt_cluster(n_nodes=8,
                                                    n_pending=12, seed=0)
    sched = PortScheduler(store, conf_str=EVICT_CONF, device="cpu")
    sim = volcano_tpu_torch.sim.ClusterSimulator(store, grace_steps=1)
    for _ in range(4):
        sched.run_once()
        sim.step()
    assert reads and all(r == 0 for r in reads)
    assert np.any(store.mirror.p_node[:store.mirror.n_pods] >= 0)


# ------------------------------------ exact counts and the lean state


@pytest.mark.parametrize("n", [20, 50])
def test_walk_eviction_counts_config4(n):
    """BASELINE config 4's shape at ``n`` nodes: the first wave evicts one
    filler for each pending pod, the second as many again, no later cycle
    evicts, and every pending pod binds -- on both packages.  chip_smoke's
    phase 35 holds the card's run at 10,000 nodes to these proportions."""
    got = _twin(lambda pkg: pkg.synth.preempt_cluster(
        n_nodes=n, fill_per_node=4, n_pending=2 * n, gang_size=4, seed=0),
        cycles=6, grace=2)
    assert [len(r["evicts"]) for r in got] == [2 * n] + [4 * n] * 5
    hi = [k for k in got[-1]["binds"] if k.split("/")[-1].startswith("hi-")]
    assert len(hi) == 2 * n


@pytest.mark.parametrize("workers,serving", [(40, 20), (100, 50)])
def test_walk_eviction_counts_priority_tier(workers, serving):
    """``priority_tier_workload`` with half the workers' capacity asked
    for: one batch pod evicted for each serving task, as many again in
    the next cycle, none after, and the gang bound -- on both packages.
    chip_smoke's phase 36 holds the card's run at 10,000 workers to
    these proportions."""
    got = _twin(lambda pkg: tier_store(pkg, workers=workers,
                                       serving=serving),
                conf=PREEMPT_CONF, cycles=5, grace=2)
    assert [len(r["evicts"]) for r in got] == \
        [serving] + [2 * serving] * 4
    assert sum(1 for k in got[-1]["binds"] if "serving" in k) == serving


def test_device_lane_commits_through_the_lean_state(monkeypatch):
    """The device-native lane evicts through ``EvictState`` alone: no
    ``FastEvictor`` is built and the walk's state never is."""
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    built = []
    orig = port_fe.EvictState.for_walk

    def spy(st):
        built.append(st)
        return orig(st)

    monkeypatch.setattr(port_fe.EvictState, "for_walk", spy)
    reset_uid_counters()
    store = volcano_tpu_torch.synth.preempt_cluster(n_nodes=8,
                                                    n_pending=12, seed=0)
    PortScheduler(store, conf_str=EVICT_CONF, device="cpu").run_once()
    assert store.evictor.evicts, "the device lane did not evict"
    assert built == []


# The rebalance lane evicts through the lean state first; the walk's
# preempt then wraps that state (before and after an allocate).
REBALANCE_THEN_WALK = [
    "enqueue, allocate, backfill, rebalance, preempt, reclaim",
    "enqueue, rebalance, allocate, preempt, reclaim, backfill",
]


@pytest.mark.parametrize("actions", REBALANCE_THEN_WALK)
def test_walk_wraps_the_rebalance_lanes_state_equals_jax(actions,
                                                         monkeypatch):
    from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF

    monkeypatch.setenv("VOLCANO_TPU_REBALANCE_DRAIN_CAP", "64")
    conf = REBALANCE_SCHEDULER_CONF.replace(
        '"enqueue, allocate, backfill, rebalance"', f'"{actions}"')
    assert conf != REBALANCE_SCHEDULER_CONF
    wrapped = []
    orig = port_fe.FastEvictor.__init__

    def spy(self, cyc, st):
        wrapped.append(len(st.evicted_rows))
        return orig(self, cyc, st)

    monkeypatch.setattr(port_fe.FastEvictor, "__init__", spy)
    got = _twin(lambda pkg: pkg.synth.fabric_cluster(
        binder=pkg.cache.FakeBinder()), conf=conf, cycles=3)
    assert got[0]["evicted"] and any(got[-1]["binds"])
    assert wrapped and wrapped[0] == len(got[0]["evicted"])
