"""The port's rebalance lane against the JAX package's.

1. ``frag_scores``: the plain version of the port's kernel against the JAX
   jit on 30 seeds of random planes (``test_torch_fixtures.frag_case``:
   not-ready rows, zero-allocatable slots, all-zero padding profiles, a
   one-slot profile, R = 3..6, and on every third seed rows whose fit count
   passes the int32 range).  ``fit_now`` / ``fit_freed`` must be identical,
   the saturated rows included (XLA's convert saturates at INT32_MAX, as
   ``__float2int_rz`` does on the card; a plain torch cast would not).
   ``frag`` must be bit-equal: both sides compute each slot's fraction
   with the same f32 operations and sum the R fractions from 0, left to
   right (XLA's CPU order for this short axis), then divide once -- no
   tolerance is needed, and none is given.  Also on
   ``test_torch_fixtures.frag_edge_case`` (R = 1..16, all-zero profile
   rows first, between and last, U past the kernel's 64-row staging
   chunk), the inputs going through ``kernels.stage_frag`` (one staged
   buffer, unpacked byte for byte) and the outputs being the rows of one
   [3, N] buffer (``FragScores.packed``).
2. ``select_drain_set`` against the JAX function on 30 seeded inputs,
   half of them with budgets too small for the need (budget-blocked).
3. Twin ``Scheduler.run_once()`` runs, port vs JAX, with
   ``ClusterSimulator.step()`` between cycles, of bench.py's
   ``config_rebalance`` shape at 32 workers: binds, evictions, restored
   uids, the ledger, plan outcomes (the what-if and rebalance counter
   series, the flight recorder's rebalance record), eviction counters,
   PodGroup phases, mirror state and the devincr / devsnap counters, after
   every cycle.  Also with every filler's budget at 0 (rejected-budget,
   then the backoff), with the lane switched off, under
   ``VOLCANO_TPU_EVICT_DEVICE=0``, and preempt + rebalance sharing one
   ledger under churn.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from test_torch_fixtures import frag_case, frag_edge_case, mirror_state

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.cache
import volcano_tpu.sim
import volcano_tpu.synth
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu.ops import rebalance as jreb
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.cache
import volcano_tpu_torch.sim
import volcano_tpu_torch.synth
from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF
from volcano_tpu_torch.metrics import metrics as port_metrics
from volcano_tpu_torch.ops import kernels
from volcano_tpu_torch.ops import rebalance as treb
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler


# ----------------------------------------------------------- frag_scores


@pytest.mark.parametrize("seed", range(30))
def test_frag_scores_plain_matches_jax(seed):
    c = frag_case(seed, N=200 + seed, R=3 + seed % 4,
                  overflow=seed % 3 == 0)
    args = (c["idle"], c["alloc"], c["ready"], c["evictable"],
            c["prof_req"], c["eps"])
    want = [np.asarray(a) for a in jax.device_get(jreb.frag_scores(*args))]
    got = [t.numpy() for t in treb.frag_scores(*args, device="cpu")]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()
    if seed % 3 == 0:
        assert int(got[1].max()) == 2 ** 31 - 1
    else:
        assert int(got[1].max()) < 2 ** 30


def test_frag_scores_cases_are_not_vacuous():
    """Fragmented, gaining and saturated rows all occur."""
    frag = gain = 0
    for seed in range(30):
        c = frag_case(seed, N=200 + seed, R=3 + seed % 4)
        f, now, freed = (t.numpy() for t in treb.frag_scores(
            c["idle"], c["alloc"], c["ready"], c["evictable"],
            c["prof_req"], c["eps"], device="cpu"))
        frag += int((f > 0).sum())
        gain += int((freed > now).sum())
    assert frag > 100 and gain > 100


FRAG_EDGES = [(R, zero_rows, U, R % 2 == 1)
              for R, U in ((1, 4), (2, 8), (3, 70), (5, 4), (16, 130))
              for zero_rows in ("first", "between", "last")]


@pytest.mark.parametrize("R,zero_rows,U,overflow", FRAG_EDGES)
def test_frag_scores_edges_plain_match_jax(R, zero_rows, U, overflow):
    """The kernel's edges (``frag_edge_case``) through the port's entry
    point (staged inputs, packed outputs): bytes equal to the JAX jit's,
    and the same counts wherever the all-zero rows sit."""
    c = frag_edge_case(R, N=257, U=U, R=R, zero_rows=zero_rows,
                       overflow=overflow)
    args = (c["idle"], c["alloc"], c["ready"], c["evictable"],
            c["prof_req"], c["eps"])
    want = [np.asarray(a) for a in jax.device_get(jreb.frag_scores(*args))]
    got = [t.numpy() for t in treb.frag_scores(*args, device="cpu")]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()
    assert (int(got[1].max()) == 2 ** 31 - 1) == overflow
    first = [t.numpy() for t in treb.frag_scores(
        *args[:4], frag_edge_case(R, N=257, U=U, R=R, zero_rows="first",
                                  overflow=overflow)["prof_req"],
        args[5], device="cpu")]
    for a, b in zip(got, first):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("N,U,R", [(1, 1, 1), (7, 4, 3), (300, 8, 5),
                                   (129, 70, 16), (5, 0, 2)])
def test_stage_frag_unpacks_to_the_inputs(N, U, R):
    """``kernels.stage_frag``: six views of one buffer, each starting at a
    multiple of 16 bytes from its start (R odd included), holding the
    inputs byte for byte, in the kernel's dtypes and shapes."""
    c = frag_edge_case(N + U + R, N=N, U=max(U, 1), R=R)
    c["prof_req"] = c["prof_req"][:U]
    names = ("idle", "alloc", "ready", "evictable", "prof_req", "eps")
    views = kernels.stage_frag(*(c[k] for k in names), "cpu")
    base = views[0].untyped_storage().data_ptr()
    assert views[0].data_ptr() == base
    dtypes = (torch.float32, torch.float32, torch.bool, torch.float32,
              torch.float32, torch.float32)
    ends = []
    for k, v, dt in zip(names, views, dtypes):
        want = np.ascontiguousarray(c[k], v.numpy().dtype)
        assert v.dtype == dt and tuple(v.shape) == want.shape, k
        assert v.is_contiguous(), k
        assert v.untyped_storage().data_ptr() == base, k
        off = v.data_ptr() - base
        assert off % 16 == 0, (k, off)
        assert v.numpy().tobytes() == want.tobytes(), k
        ends.append((off, off + want.nbytes))
    ends.sort()
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))


def test_frag_scores_outputs_are_rows_of_one_buffer():
    """``FragScores.packed``: the [3, N] int32 buffer whose rows the three
    planes are (frag as its f32 bits), what the planner fetches in one
    copy; planes from separate tensors are refused."""
    c = frag_case(3, N=211, R=4)
    fs = treb.frag_scores(c["idle"], c["alloc"], c["ready"],
                          c["evictable"], c["prof_req"], c["eps"],
                          device="cpu")
    packed = fs.packed
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (3, 211)
    assert packed.is_contiguous()
    assert packed[0].view(torch.float32).data_ptr() == fs.frag.data_ptr()
    assert torch.equal(packed[0], fs.frag.view(torch.int32))
    assert torch.equal(packed[1], fs.fit_now)
    assert torch.equal(packed[2], fs.fit_freed)
    with pytest.raises(ValueError):
        treb.FragScores(fs.frag.clone(), fs.fit_now.clone(),
                        fs.fit_freed.clone()).packed


# ------------------------------------------------------ select_drain_set


def _drain_case(seed):
    rng = np.random.RandomState(seed)
    N = int(rng.randint(4, 40))
    frag = np.where(rng.rand(N) < 0.7, rng.rand(N), 0.0).astype(np.float32)
    fit_now = rng.randint(0, 3, N).astype(np.int32)
    fit_freed = (fit_now + rng.randint(0, 4, N)).astype(np.int32)
    victims_by_node, victim_group = [], {}
    row = 0
    for _n in range(N):
        rows = []
        for _ in range(int(rng.randint(0, 4))):
            rows.append(row)
            victim_group[row] = f"g{rng.randint(0, 6)}"
            row += 1
        victims_by_node.append(rows)
    tight = seed % 2 == 1
    budget_left = {f"g{i}": int(rng.randint(0, 2 if tight else 20))
                   for i in range(6)}
    return (frag, fit_now, fit_freed, int(rng.randint(1, 30)),
            victims_by_node, victim_group, budget_left,
            int(rng.randint(1, N + 1)))


@pytest.mark.parametrize("seed", range(30))
def test_select_drain_set_matches_jax(seed):
    case = _drain_case(seed)
    assert treb.select_drain_set(*case) == jreb.select_drain_set(*case)


def test_select_drain_set_cases_cover_outcomes():
    outcomes = {(bool(nodes), blocked) for nodes, blocked in (
        treb.select_drain_set(*_drain_case(s)) for s in range(30))}
    assert outcomes == {(True, False), (False, False), (False, True)}


# ------------------------------------------------------------ twin cycles


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _counts(series):
    return dict(series.data)


def _delta(now, before):
    return {k: v - before.get(k, 0.0) for k, v in now.items()
            if v != before.get(k, 0.0)}


def _ledger(store):
    led = store.migrations
    if led is None:
        return None
    return (led.committed_plans, led.restored_pods, tuple(sorted(
        (uid, e.group_uid, e.planned_node, e.restored_uid, e.action,
         e.for_gang) for uid, e in led.entries.items())))


SERIES = ("whatif_plans", "rebalance_plans", "rebalance_evictions",
          "preempt_evictions", "topology_placements", "pipeline_stale_drops")


def rebalance_twin(pkg, make, conf, grace, cycles, setup=None, churn=None):
    """Run ``cycles`` cycles of ``Scheduler(make(pkg), conf)`` with
    ``ClusterSimulator(grace).step()`` after each; ``setup(pkg, store,
    sched, sim)`` runs first, ``churn(pkg, store, rng)`` after each step.
    Returns the per-cycle trace."""
    _reset_uid_counters()
    store = make(pkg)
    metrics = jax_metrics if pkg is volcano_tpu else port_metrics
    if pkg is volcano_tpu:
        store.pipeline = False
        sched = JaxScheduler(store, conf_str=conf)
    else:
        sched = PortScheduler(store, conf_str=conf, device="cpu")
    sim = pkg.sim.ClusterSimulator(store, grace_steps=grace)
    if setup is not None:
        setup(pkg, store, sched, sim)
    before = {s: _counts(getattr(metrics, s)) for s in SERIES}
    rng = np.random.RandomState(7)
    trace = []
    for _ in range(cycles):
        sched.run_once()
        rec = store.flight.last()
        dv = getattr(store, "_devincr_cache", None)
        snap = getattr(store, "device_snapshot", None)
        trace.append({
            "binds": dict(store.binder.binds),
            "evictions": list(store.evictor.evicts),
            "restored": sorted(uid for uid in store.pods if "-mig" in uid),
            "ledger": _ledger(store),
            "series": {s: _delta(_counts(getattr(metrics, s)), before[s])
                       for s in SERIES},
            "rebalance": rec.rebalance, "whatif": rec.whatif,
            "drops": (rec.pods_dropped, rec.drop_reasons),
            "considered": rec.pods_considered,
            "gated": sorted(getattr(store, "_topo_gated", set())),
            "phases": {uid: pg.status.phase
                       for uid, pg in sorted(store.pod_groups.items())},
            "mirror": mirror_state(store),
            "releasing": sum(1 for p in store.pods.values() if p.deleting),
            "n_pods": len(store.pods),
            "devincr": (None if dv is None else
                        (dict(dv.counts), dv.static_hits,
                         dv.static_builds)),
            "devsnap": (None if snap is None else
                        (snap.full_uploads, snap.delta_uploads, snap.hits)),
        })
        sim.step()
        if churn is not None:
            churn(pkg, store, rng)
    store.close()
    return trace


def assert_twins(want, got):
    assert len(want) == len(got)
    for step, (a, b) in enumerate(zip(want, got)):
        for f in a:
            assert a[f] == b[f], (f, step, a[f], b[f])


def bench_store(workers, budget=None):
    """bench.py config_rebalance's cluster (``workers`` 4-cpu workers, as
    many 3-cpu spill nodes, a pending 3-cpu filler per worker), store with
    a FakeBinder only, as bench.py builds it."""
    def make(pkg):
        api = pkg.api
        store = pkg.cache.ClusterStore(binder=pkg.cache.FakeBinder())
        store.add_priority_class(api.PriorityClass(name="bench-high",
                                                   value=100))
        for i in range(workers):
            store.add_node(api.Node(name=f"w{i}", allocatable={
                "cpu": "4", "memory": "16Gi", "pods": 110}))
            store.add_node(api.Node(name=f"s{i}", allocatable={
                "cpu": "3", "memory": "16Gi", "pods": 110}))
        for i in range(workers):
            store.add_pod_group(api.PodGroup(name=f"bf{i}", min_member=1,
                                             max_unavailable=budget))
            store.add_pod(api.Pod(
                name=f"bfill{i}",
                annotations={api.GROUP_NAME_ANNOTATION: f"bf{i}"},
                containers=[{"cpu": "3", "memory": "1Gi"}]))
        return store
    return make


def bench_setup(gang):
    """config_rebalance's set-up: the fillers are placed and start
    Running, then the whole-node gang arrives."""
    def setup(pkg, store, sched, sim):
        api = pkg.api
        sched.run_once()
        sim.step()
        store.add_pod_group(api.PodGroup(name="benchgang", min_member=gang,
                                         priority_class="bench-high"))
        for i in range(gang):
            store.add_pod(api.Pod(
                name=f"bg{i}",
                annotations={api.GROUP_NAME_ANNOTATION: "benchgang"},
                containers=[{"cpu": "4", "memory": "1Gi"}]))
    return setup


@pytest.fixture
def lane_env(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    for k in ("VOLCANO_TPU_REBALANCE", "VOLCANO_TPU_REBALANCE_MIN_GAIN",
              "VOLCANO_TPU_REBALANCE_MAX_UNAVAIL", "VOLCANO_TPU_TOPOLOGY",
              "VOLCANO_TPU_TOPO_WEIGHT", "VOLCANO_TPU_DEVINCR",
              "VOLCANO_TPU_DEVSNAP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("VOLCANO_TPU_REBALANCE_DRAIN_CAP", "32")
    return monkeypatch


def _gang_bound(trace, prefix="default/bg"):
    return sum(k.startswith(prefix) for k in trace["binds"])


def test_twin_rebalance_bench_shape(lane_env):
    """config_rebalance at 32 workers, grace 2, 6 cycles: one plan drains
    16 fillers at cycle 0, the ledger restores them after the grace window
    and the 16-task gang binds, every filler bound again."""
    args = (bench_store(32), REBALANCE_SCHEDULER_CONF, 2, 6, bench_setup(16))
    want = rebalance_twin(volcano_tpu, *args)
    got = rebalance_twin(volcano_tpu_torch, *args)
    assert_twins(want, got)
    assert got[0]["rebalance"]["outcome"] == "committed"
    assert got[0]["ledger"][0] == 1 and len(got[0]["evictions"]) == 16
    assert _gang_bound(got[-1]) == 16
    assert len(got[-1]["restored"]) == 16
    assert got[-1]["series"]["rebalance_evictions"] == {(): 16.0}
    assert any(t["releasing"] for t in got)


def test_twin_rebalance_budget_zero_rejects(lane_env):
    """Every filler's budget is 0: the lane plans nothing, evicts nothing,
    counts one rejected-budget outcome, then backs off."""
    args = (bench_store(8, budget=0), REBALANCE_SCHEDULER_CONF, 2, 4,
            bench_setup(4))
    want = rebalance_twin(volcano_tpu, *args)
    got = rebalance_twin(volcano_tpu_torch, *args)
    assert_twins(want, got)
    assert got[0]["rebalance"]["outcome"] == "rejected-budget"
    assert all(t["evictions"] == [] and t["ledger"] is None for t in got)
    assert all(t["rebalance"] is None for t in got[1:])
    assert got[-1]["series"]["rebalance_plans"] == {
        (("outcome", "rejected-budget"),): 1.0}


def test_twin_rebalance_switched_off(lane_env):
    """VOLCANO_TPU_REBALANCE=0 turns the configured action into a no-op."""
    lane_env.setenv("VOLCANO_TPU_REBALANCE", "0")
    args = (bench_store(8), REBALANCE_SCHEDULER_CONF, 2, 3, bench_setup(4))
    want = rebalance_twin(volcano_tpu, *args)
    got = rebalance_twin(volcano_tpu_torch, *args)
    assert_twins(want, got)
    assert all(t["ledger"] is None and not t["evictions"] for t in got)


def test_rebalance_runs_with_host_victim_walk_selected(lane_env):
    """The rebalance lane ignores VOLCANO_TPU_EVICT_DEVICE (the switch of
    the preempt / reclaim host walk, which the port does not run): with it
    at 0 the lane plans and commits exactly as the JAX package does."""
    lane_env.setenv("VOLCANO_TPU_EVICT_DEVICE", "0")
    args = (bench_store(8), REBALANCE_SCHEDULER_CONF, 2, 5, bench_setup(4))
    want = rebalance_twin(volcano_tpu, *args)
    got = rebalance_twin(volcano_tpu_torch, *args)
    assert_twins(want, got)
    assert got[0]["rebalance"]["outcome"] == "committed"
    assert _gang_bound(got[-1]) == 4


MIXED_CONF = """
actions: "enqueue, allocate, backfill, preempt, rebalance"
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


def _shared_store(pkg):
    """tests/test_whatif_preempt.py's cross-action case: fillers of one
    group (budget 2) on 6 workers, spill nodes, a high-priority serving
    gang (preempt) and a default-priority whole-node gang (rebalance)."""
    api = pkg.api
    store = pkg.cache.ClusterStore(binder=pkg.cache.FakeBinder(),
                                   evictor=pkg.cache.FakeEvictor())
    store.add_priority_class(api.PriorityClass(name="serve", value=1000))
    store.add_priority_class(api.PriorityClass(name="batch", value=10))
    for i in range(6):
        store.add_node(api.Node(name=f"w{i}", allocatable={
            "cpu": "4", "memory": "16Gi", "pods": 110}))
        store.add_node(api.Node(name=f"s{i}", allocatable={
            "cpu": "3", "memory": "16Gi", "pods": 110}))
    store.add_pod_group(api.PodGroup(name="fill", min_member=1,
                                     max_unavailable=2,
                                     priority_class="batch"))
    for i in range(6):
        store.add_pod(api.Pod(
            name=f"fill{i}", annotations={api.GROUP_NAME_ANNOTATION: "fill"},
            containers=[{"cpu": "3", "memory": "1Gi"}],
            phase=api.PodPhase.Running, node_name=f"w{i}", priority=10))
    store.add_pod_group(api.PodGroup(name="serving", min_member=2,
                                     priority_class="serve"))
    for i in range(2):
        store.add_pod(api.Pod(
            name=f"serving-{i}",
            annotations={api.GROUP_NAME_ANNOTATION: "serving"},
            containers=[{"cpu": "4", "memory": "1Gi"}], priority=1000))
    store.add_pod_group(api.PodGroup(name="big", min_member=2))
    for i in range(2):
        store.add_pod(api.Pod(
            name=f"big-{i}", annotations={api.GROUP_NAME_ANNOTATION: "big"},
            containers=[{"cpu": "4", "memory": "1Gi"}]))
    return store


def _churn(pkg, store, rng):
    api = pkg.api
    n = len([p for p in store.pods.values() if p.name.startswith("churn-")])
    if rng.rand() < 0.4:
        name = f"c{rng.randint(1 << 30)}"
        store.add_pod_group(api.PodGroup(name=name, min_member=1))
        store.add_pod(api.Pod(
            name=f"churn-{name}",
            annotations={api.GROUP_NAME_ANNOTATION: name},
            containers=[{"cpu": "1", "memory": "1Gi"}]))
    elif n and rng.rand() < 0.5:
        gone = sorted((p for p in store.pods.values()
                       if p.name.startswith("churn-")), key=lambda p: p.name)
        store.delete_pod(gone[0])


def test_twin_preempt_and_rebalance_share_one_ledger(lane_env):
    """The cross-action case of tests/test_whatif_preempt.py under churn,
    24 cycles: preempt and rebalance waves charge one budget pool and one
    ledger; equal per cycle, the shared group's budget never exceeded, no
    filler lost."""
    lane_env.setenv("VOLCANO_TPU_REBALANCE_DRAIN_CAP", "8")
    want = rebalance_twin(volcano_tpu, _shared_store, MIXED_CONF, 1, 24,
                          churn=_churn)
    got = rebalance_twin(volcano_tpu_torch, _shared_store, MIXED_CONF, 1,
                         24, churn=_churn)
    assert_twins(want, got)
    actions = {e[4] for t in got if t["ledger"] for e in t["ledger"][2]}
    assert "preempt" in actions
    assert sum(k.startswith("default/serving-")
               for k in got[-1]["binds"]) == 2
