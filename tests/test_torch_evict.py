"""The port's preempt / reclaim lanes against the JAX package's.

1. ``victim_scores``: the plain version of the port's kernel against the
   JAX jit on 20 seeds per mode of randomized victim planes (the
   ``_random_wave`` shapes of tests/test_whatif_preempt.py, V not a power
   of two, memory requests in multiples of 10^6 bytes plus random float
   CPU requests).  The JAX caller pads V to a power of two with ineligible
   rows of crank 0 and tie >= V; those rows sort after every real row
   (ineligible first key, then -crank = 0 is the largest, then tie), so the
   port, which does not pad, must equal the JAX ``order[:V]``.
   ``eligible``, ``order`` and ``q_share`` must be equal; ``evictable``
   bit-equal, because both sides add a node's rows in victim-index order in
   float32 starting from 0 (XLA's CPU scatter-add order).  ``select_victims``
   on the fetched planes must choose the same victims.
2. Twin ``Scheduler.run_once()`` runs, port vs JAX, with
   ``ClusterSimulator.step()`` between cycles: binds, evictions, restored
   uids, ledger entries, what-if outcomes (counter series and the flight
   recorder's plan accounting), eviction counters, PodGroup phases, mirror
   state and the devincr / devsnap counters, after every cycle.
3. An evictor that fails some keys: both packages revert, cancel and count
   the same way.
"""

import itertools

import numpy as np
import pytest

from test_torch_fixtures import mirror_state

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.cache.interface
import volcano_tpu.sim
import volcano_tpu.synth
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu.ops import victim as jvk
from volcano_tpu.scheduler import Scheduler as JaxScheduler
from volcano_tpu.sim import ClusterSimulator as JaxSim

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.cache.interface
import volcano_tpu_torch.sim
import volcano_tpu_torch.synth
from volcano_tpu_torch.metrics import metrics as port_metrics
from volcano_tpu_torch.ops import victim as tvk
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler
from volcano_tpu_torch.sim import ClusterSimulator as PortSim


# --------------------------------------------------------- victim_scores


def _victim_case(seed, mode):
    rng = np.random.RandomState(seed)
    V = int(rng.randint(5, 60))
    N, Q, R = int(rng.randint(2, 12)), int(rng.randint(1, 5)), 3
    v_ok = rng.rand(V) > 0.2
    v_jprio = rng.randint(0, 4, V).astype(np.int32)
    v_crank = np.argsort(np.argsort(rng.rand(V))).astype(np.int32)
    v_queue = rng.randint(0, Q, V).astype(np.int32)
    v_node = rng.randint(0, N, V).astype(np.int32)
    v_req = np.zeros((V, R), np.float32)
    v_req[:, 0] = rng.uniform(0.0, 3.0, V).astype(np.float32)
    v_req[:, 1] = rng.randint(1, 5000, V) * 1.0e6  # not powers of two
    v_req[:, 2] = rng.randint(0, 3, V)
    v_req[rng.rand(V, R) < 0.2] = 0.0
    q_alloc = rng.uniform(0.0, 8.0, (Q, R)).astype(np.float32)
    q_alloc[:, 1] *= 1.0e9
    q_des = rng.uniform(1.0, 6.0, (Q, R)).astype(np.float32)
    q_des[:, 1] *= 1.0e9
    q_des[rng.rand(Q, R) < 0.3] = 3.0e38
    q_rec = rng.rand(Q) > 0.3
    return dict(v_ok=v_ok, v_jprio=v_jprio, v_crank=v_crank,
                v_tie=np.arange(V, dtype=np.int32), v_queue=v_queue,
                v_node=v_node, v_req=v_req,
                p_prio=int(rng.randint(1, 5)), p_queue=int(rng.randint(Q)),
                q_alloc=q_alloc, q_des=q_des, q_rec=q_rec, mode=mode, N=N)


def _jax_planes(c):
    """The JAX kernel on the inputs padded the way whatif.py pads them."""
    import jax

    V = len(c["v_ok"])
    Vp = 8
    while Vp < V:
        Vp *= 2

    def pad(a, fill=0):
        out = np.full((Vp, *a.shape[1:]), fill, a.dtype)
        out[:V] = a
        return out

    tie = np.concatenate([c["v_tie"], np.arange(V, Vp)]).astype(np.int32)
    planes = jvk.victim_scores(
        pad(c["v_ok"], False), pad(c["v_jprio"]), pad(c["v_crank"]),
        tie, pad(c["v_queue"]), pad(c["v_node"]),
        pad(c["v_req"]), np.int32(c["p_prio"]), np.int32(c["p_queue"]),
        c["q_alloc"], c["q_des"], c["q_rec"], np.int32(c["mode"]),
        np.zeros((c["N"], 3), np.float32))
    el, order, ev, qs = jax.device_get(
        (planes.eligible, planes.order, planes.evictable, planes.q_share))
    return np.asarray(el), np.asarray(order), np.asarray(ev), np.asarray(qs)


def _port_planes(c):
    p = tvk.victim_scores(
        c["v_ok"], c["v_jprio"], c["v_crank"], c["v_tie"], c["v_queue"],
        c["v_node"], c["v_req"], c["p_prio"], c["p_queue"], c["q_alloc"],
        c["q_des"], c["q_rec"], c["mode"], c["N"], device="cpu")
    return tuple(x.numpy() for x in p)


@pytest.mark.parametrize("mode", [tvk.PREEMPT, tvk.RECLAIM])
@pytest.mark.parametrize("seed", range(20))
def test_victim_scores_plain_matches_jax(seed, mode):
    c = _victim_case(1000 * mode + seed, mode)
    V = len(c["v_ok"])
    jel, jorder, jev, jqs = _jax_planes(c)
    el, order, ev, qs = _port_planes(c)
    assert np.array_equal(el, jel[:V])
    assert not jel[V:].any()
    assert np.array_equal(order, jorder[:V])
    assert np.array_equal(qs, jqs)
    assert ev.dtype == jev.dtype and ev.tobytes() == jev.tobytes()

    # select_victims on the fetched planes: the JAX call on the padded
    # planes, the port's on its unpadded ones.
    rng = np.random.RandomState(seed)
    J, U = 6, 2
    v_job = rng.randint(0, J, V).astype(np.int64)
    v_group = [f"g{j % 4}" for j in v_job]
    idle = rng.uniform(0.0, 4.0, (c["N"], 3)).astype(np.float32)
    idle[:, 1] *= 1.0e9
    prof_req = rng.uniform(0.5, 4.0, (U, 3)).astype(np.float32)
    prof_req[:, 1] *= 1.0e9
    eps = np.array([1e-3, 1.0, 1e-3], np.float32)
    kw = dict(need=int(rng.randint(1, 5)), j_ready=rng.randint(0, 4, J),
              j_minav=rng.randint(1, 3, J),
              budget_left={f"g{i}": int(rng.randint(0, 5))
                           for i in range(4)},
              cap=int(rng.randint(1, V + 1)))
    if mode == tvk.RECLAIM:
        kw.update(q_alloc=c["q_alloc"], q_deserved=c["q_des"])
    Vp = len(jorder)
    jsel = jvk.select_victims(
        jorder, jel, np.concatenate([c["v_node"], np.zeros(Vp - V, np.int32)]),
        np.concatenate([c["v_req"], np.zeros((Vp - V, 3), np.float32)]),
        np.concatenate([v_job, np.full(Vp - V, -1)]),
        v_group + [""] * (Vp - V),
        np.concatenate([c["v_queue"], np.zeros(Vp - V, np.int32)]),
        kw["need"], idle, jev, prof_req, eps, kw["j_ready"], kw["j_minav"],
        dict(kw["budget_left"]), kw["cap"], q_alloc=kw.get("q_alloc"),
        q_deserved=kw.get("q_deserved"))
    tsel = tvk.select_victims(
        order, el, c["v_node"], c["v_req"], v_job, v_group, c["v_queue"],
        kw["need"], idle, ev, prof_req, eps, kw["j_ready"], kw["j_minav"],
        dict(kw["budget_left"]), kw["cap"], q_alloc=kw.get("q_alloc"),
        q_deserved=kw.get("q_deserved"))
    assert tuple(tsel) == tuple(jsel)


def dup_crank_case(seed, mode):
    """``_victim_case`` with duplicate creation ranks (a quarter of V
    values) and a tie that is a permutation of 0..V-1, not arange: the
    order's last two keys decide."""
    c = _victim_case(seed, mode)
    V = len(c["v_ok"])
    rng = np.random.RandomState(seed + 7)
    c["v_crank"] = rng.randint(0, max(1, V // 4), V).astype(np.int32)
    c["v_tie"] = rng.permutation(V).astype(np.int32)
    return c


@pytest.mark.parametrize("mode", [tvk.PREEMPT, tvk.RECLAIM])
@pytest.mark.parametrize("seed", range(10))
def test_victim_scores_duplicate_cranks_match_jax(seed, mode):
    c = dup_crank_case(2000 * (mode + 1) + seed, mode)
    V = len(c["v_ok"])
    jel, jorder, jev, jqs = _jax_planes(c)
    el, order, ev, qs = _port_planes(c)
    assert np.array_equal(el, jel[:V])
    assert np.array_equal(order, jorder[:V])
    assert np.array_equal(qs, jqs)
    assert ev.tobytes() == jev.tobytes()
    # The tie decided somewhere: two eligible rows of one priority and
    # rank, taken in tie order, not row order.
    key = list(zip(~el, c["v_jprio"], -c["v_crank"]))
    pairs = [(a, b) for a, b in zip(order[:-1], order[1:])
             if key[a] == key[b]]
    assert pairs and all(c["v_tie"][a] < c["v_tie"][b] for a, b in pairs)


def test_victim_scores_exercise_both_outcomes():
    """The seeds are not vacuous: some rows eligible and some not, in both
    modes, and several victims share a node."""
    for mode in (tvk.PREEMPT, tvk.RECLAIM):
        n_el = n_in = 0
        for seed in range(20):
            c = _victim_case(1000 * mode + seed, mode)
            el = _port_planes(c)[0]
            n_el += int(el.sum())
            n_in += int((~el).sum())
        assert n_el > 20 and n_in > 20


# ------------------------------------------------------------ twin cycles

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

# BASELINE config 4's conf (bench.py CONF_PREEMPT).
CONF_PREEMPT = """
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
"""

# The shared-ledger case of tests/test_whatif_preempt.py with preempt and
# reclaim sharing one ledger and one disruption-budget pool (preempt and
# rebalance sharing it: tests/test_torch_rebalance.py).
SHARED_CONF = """
actions: "enqueue, allocate, backfill, preempt, reclaim"
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


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _store(pkg, evictor=None):
    cache = pkg.cache
    store = cache.ClusterStore(binder=cache.FakeBinder(),
                               evictor=evictor or cache.FakeEvictor())
    if pkg is volcano_tpu:
        store.pipeline = False
    return store


def _tier_store(pkg, evictor=None):
    store = _store(pkg, evictor)
    pkg.sim.ClusterSimulator.priority_tier_workload(
        store, workers=8, serving_tasks=4)
    return store


def _shared_store(pkg, evictor=None):
    """tests/test_whatif_preempt.py:365-446's cluster: fillers of one
    shared group (budget 2) on 6 workers, spill nodes, a high-priority
    serving gang and a default-priority whole-node gang."""
    api = pkg.api
    store = _store(pkg, evictor)
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


def _shared_churn(pkg, store, rng, state):
    """The shared-ledger case's randomized churn, built from ``pkg.api``."""
    api = pkg.api
    if rng.rand() < 0.4:
        state["seq"] += 1
        n = state["seq"]
        store.add_pod_group(api.PodGroup(name=f"c{n}", min_member=1))
        store.add_pod(api.Pod(
            name=f"churn-{n}",
            annotations={api.GROUP_NAME_ANNOTATION: f"c{n}"},
            containers=[{"cpu": "1", "memory": "1Gi"}]))
    elif state["seq"] and rng.rand() < 0.5:
        gone = [p for p in store.pods.values()
                if p.name.startswith("churn-")]
        if gone:
            store.delete_pod(gone[0])


def _ledger(store):
    led = store.migrations
    if led is None:
        return None
    return (led.committed_plans, led.restored_pods, tuple(sorted(
        (uid, e.group_uid, e.planned_node, e.restored_uid, e.action,
         e.for_gang) for uid, e in led.entries.items())))


def _twin(pkg, make, conf, grace, cycles, churn=False, evictor=None):
    _reset_uid_counters()
    store = make(pkg, evictor)
    metrics = jax_metrics if pkg is volcano_tpu else port_metrics
    plans0 = dict(metrics.whatif_plans.data)
    evict0 = dict(metrics.preempt_evictions.data)
    if pkg is volcano_tpu:
        sched = JaxScheduler(store, conf_str=conf)
        sim = JaxSim(store, grace_steps=grace)
    else:
        sched = PortScheduler(store, conf_str=conf, device="cpu")
        sim = PortSim(store, grace_steps=grace)
    rng = np.random.RandomState(7)
    churn_state = {"seq": 0}
    trace = []
    for _ in range(cycles):
        sched.run_once()
        dv = store._devincr_cache
        snap = store.device_snapshot
        trace.append({
            "binds": dict(store.binder.binds),
            "evictions": list(store.evictor.evicts),
            "restored": sorted(uid for uid in store.pods if "-mig" in uid),
            "ledger": _ledger(store),
            "whatif": {k: v - plans0.get(k, 0.0) for k, v in
                       metrics.whatif_plans.data.items()
                       if v != plans0.get(k, 0.0)},
            "evict_counts": {k: v - evict0.get(k, 0.0) for k, v in
                             metrics.preempt_evictions.data.items()
                             if v != evict0.get(k, 0.0)},
            "phases": {uid: pg.status.phase
                       for uid, pg in sorted(store.pod_groups.items())},
            "mirror": mirror_state(store),
            "releasing": sum(1 for p in store.pods.values() if p.deleting),
            "n_pods": len(store.pods),
            "flight": store.flight.last().whatif,
            "fill": sum(1 for p in store.pods.values()
                        if p.name.startswith("fill")),
            "devincr": (None if dv is None else
                        (dict(dv.counts), dv.static_hits,
                         dv.static_builds)),
            "devsnap": (None if snap is None else
                        (snap.full_uploads, snap.delta_uploads, snap.hits)),
        })
        sim.step()
        if churn:
            _shared_churn(pkg, store, rng, churn_state)
    store.close()
    return trace


TWIN_FIELDS = ("binds", "evictions", "restored", "ledger", "whatif",
               "flight", "evict_counts", "phases", "mirror", "releasing",
               "n_pods", "fill", "devincr", "devsnap")


def _assert_twins(want, got):
    assert len(want) == len(got)
    for step, (a, b) in enumerate(zip(want, got)):
        for f in TWIN_FIELDS:
            assert a[f] == b[f], (f, step, a[f], b[f])


@pytest.fixture
def device_lane(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    monkeypatch.delenv("VOLCANO_TPU_EVICT_CAP", raising=False)
    monkeypatch.delenv("VOLCANO_TPU_DEVINCR", raising=False)
    monkeypatch.delenv("VOLCANO_TPU_DEVSNAP", raising=False)


def test_twin_preempt_priority_tiers(device_lane):
    """priority_tier_workload(workers=8, serving_tasks=4) under the preempt
    conf, grace 2, 10 cycles: one wave of 4 victims, the serving gang
    pipelined on their releasing capacity, then bound."""
    args = (_tier_store, PREEMPT_CONF, 2, 10)
    want = _twin(volcano_tpu, *args)
    got = _twin(volcano_tpu_torch, *args)
    _assert_twins(want, got)
    last = got[-1]
    assert sum(k.startswith("default/serving-") for k in last["binds"]) == 4
    assert len(last["restored"]) == 4
    assert any(t["releasing"] for t in got)
    assert got[0]["flight"]["outcome"] == "committed"


@pytest.mark.parametrize("seed,gang", [(0, 4), (1, 2), (2, 8)])
def test_twin_reclaim_preempt_cluster(device_lane, seed, gang):
    """preempt_cluster(n_nodes=16, n_pending=32) under CONF_PREEMPT, grace
    1, 8 cycles.  The generator draws nothing from its seed, so the three
    runs also differ in gang size."""
    def make(pkg, evictor):
        store = pkg.synth.preempt_cluster(n_nodes=16, n_pending=32,
                                          gang_size=gang, seed=seed)
        store.evictor = evictor or pkg.cache.FakeEvictor()
        if pkg is volcano_tpu:
            store.pipeline = False
        return store

    args = (make, CONF_PREEMPT, 1, 8)
    want = _twin(volcano_tpu, *args)
    got = _twin(volcano_tpu_torch, *args)
    _assert_twins(want, got)
    assert got[-1]["ledger"][0] >= 1 and got[-1]["restored"]
    assert any(t["releasing"] for t in got)
    outcomes = {k for t in got for k in t["whatif"]}
    assert (("action", "reclaim"), ("outcome", "committed")) in outcomes


def test_twin_budget_zero_rejects(device_lane):
    """tests/test_whatif_preempt.py:240-258: every batch group's budget
    is 0, so the lane plans nothing, evicts nothing and counts one
    rejected-budget outcome."""
    def make(pkg, evictor):
        store = _store(pkg, evictor)
        pkg.sim.ClusterSimulator.priority_tier_workload(
            store, workers=2, serving_tasks=1)
        for i in range(2):
            store.pod_groups[f"default/batch{i}"].max_unavailable = 0
        return store

    want = _twin(volcano_tpu, make, PREEMPT_CONF, 0, 1)
    got = _twin(volcano_tpu_torch, make, PREEMPT_CONF, 0, 1)
    _assert_twins(want, got)
    assert got[0]["evictions"] == [] and got[0]["ledger"] is None
    assert got[0]["whatif"] == {
        (("action", "preempt"), ("outcome", "rejected-budget")): 1.0}


def test_twin_shared_ledger(device_lane):
    """The shared-ledger case under churn, 24 cycles: preempt and reclaim
    waves charge one budget pool; equal per cycle, budgets never exceeded,
    no filler lost."""
    args = (_shared_store, SHARED_CONF, 1, 24)
    want = _twin(volcano_tpu, *args, churn=True)
    got = _twin(volcano_tpu_torch, *args, churn=True)
    _assert_twins(want, got)
    assert any(t["evictions"] for t in got)
    assert all(t["fill"] == 6 for t in got)
    assert sum(k.startswith("default/serving-")
               for k in got[-1]["binds"]) == 2


class _FlakyEvictor:
    """Fails every other key of each batch (an EvictFailure naming them)."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.evicts = []

    def evict_keys(self, keys):
        failed = [k for i, k in enumerate(keys) if i % 2]
        self.evicts.extend(k for k in keys if k not in failed)
        if failed:
            raise self.pkg.cache.interface.EvictFailure(failed)

    def evict(self, pod):
        self.evicts.append(f"{pod.namespace}/{pod.name}")


def test_twin_evictor_failures(device_lane):
    """An evictor that fails half of each batch: both packages revert the
    failed pods to Running, cancel their ledger entries, count only the
    dispatched evictions, and re-plan."""
    def run(pkg):
        return _twin(pkg, _tier_store, PREEMPT_CONF, 2, 10,
                     evictor=_FlakyEvictor(pkg))

    want = run(volcano_tpu)
    got = run(volcano_tpu_torch)
    _assert_twins(want, got)
    first = next(t for t in got if t["evictions"])
    assert first["ledger"][2] and len(first["ledger"][2]) == len(
        first["evictions"])


def _affinity_shared_store(pkg, evictor=None):
    """The shared-ledger cluster with host ports and inter-pod terms: the
    fillers and the serving gang ask for host port 9000, the serving gang
    is hostname anti-affine to itself and the big gang spreads over
    zones; the what-if solves of the preempt waves carry both."""
    api = pkg.api
    store = _store(pkg, evictor)
    store.add_priority_class(api.PriorityClass(name="serve", value=1000))
    store.add_priority_class(api.PriorityClass(name="batch", value=10))
    for i in range(6):
        store.add_node(api.Node(name=f"w{i}", allocatable={
            "cpu": "4", "memory": "16Gi", "pods": 110},
            labels={"zone": f"z{i % 2}"}))
        store.add_node(api.Node(name=f"s{i}", allocatable={
            "cpu": "3", "memory": "16Gi", "pods": 110},
            labels={"zone": f"z{i % 2}"}))
    store.add_pod_group(api.PodGroup(name="fill", min_member=1,
                                     max_unavailable=2,
                                     priority_class="batch"))
    for i in range(6):
        store.add_pod(api.Pod(
            name=f"fill{i}", annotations={api.GROUP_NAME_ANNOTATION: "fill"},
            containers=[{"cpu": "3", "memory": "1Gi"}], host_ports=[9000],
            phase=api.PodPhase.Running, node_name=f"w{i}", priority=10))
    store.add_pod_group(api.PodGroup(name="serving", min_member=2,
                                     priority_class="serve"))
    for i in range(2):
        store.add_pod(api.Pod(
            name=f"serving-{i}", labels={"app": "serving"},
            annotations={api.GROUP_NAME_ANNOTATION: "serving"},
            containers=[{"cpu": "4", "memory": "1Gi"}], priority=1000,
            host_ports=[9000], anti_affinity=[api.AffinityTerm(
                match_labels={"app": "serving"})]))
    store.add_pod_group(api.PodGroup(name="big", min_member=2))
    for i in range(2):
        store.add_pod(api.Pod(
            name=f"big-{i}", annotations={api.GROUP_NAME_ANNOTATION: "big"},
            containers=[{"cpu": "4", "memory": "1Gi"}],
            topology_spread=[("zone", 10)]))
    return store


def test_twin_preempt_with_ports_and_affinity(device_lane):
    """The what-if engine with host ports and inter-pod terms: the plan
    solve frees the victims' ports and counts (the resident set is
    patched before the encode), equal to the JAX package per cycle; the
    serving gang binds on two nodes."""
    args = (_affinity_shared_store, SHARED_CONF, 1, 12)
    want = _twin(volcano_tpu, *args)
    got = _twin(volcano_tpu_torch, *args)
    _assert_twins(want, got)
    assert any(t["evictions"] for t in got)
    serving = {v for k, v in got[-1]["binds"].items()
               if k.startswith("default/serving-")}
    assert len(serving) == 2
