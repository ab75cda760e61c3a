"""Host ports, inter-pod affinity and topology spread: the port against the
JAX package on the CPU.

``solve_wave``: the same JAX solve args (``synth.solve_args_from_store``
on the same store, converted to numpy) go through the JAX ``solve_wave``
and the port's ``solve_wave(device="cpu")``.  Every result field must be
equal, the counters included (``iters``, ``fb_exhausted``,
``fb_affinity``): exact, because every request is whole CPUs and GiB and
every soft weight an integer, so every float sum is exact in any order.
Fixtures (``test_torch_fixtures.affinity_store``): zone affinity with the
self-match rule, hostname anti-affinity that exhausts the shortlist, soft
spread with preferred affinity (weights 5 and 10), host ports within a
wave and against resident pods, ports with releasing capacity, more than
256 givers in one sub-round (W = 512), wave-disjoint and shared term
sets, both sparse-shipping thresholds forced in both packages, the JAX
count reads through the domain one-hot and through the gather, and the
JAX 2-D key form; one contention group on three hot nodes with host
ports and self anti-affinity (the paths the walk kernel reorders).

Twin ``Scheduler`` runs: BASELINE config 5's mix at 256 nodes x 2,048
pods under CONF_BASE, 6 cycles with a feed re-pending the pods of nodes
0-7, the JAX and the port's cycle equal per cycle (mirror state, binds,
PodGroup phases, device-incremental counters); again with
``VOLCANO_TPU_AFF_BUDGET_MB`` low enough to split the cold solve into
job-aligned chunks.
"""

import itertools

import jax
import numpy as np
import pytest

from test_torch_fixtures import (affinity_store, mirror_state, repend_feed,
                                 tonp)

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.ops.wave as jw
from volcano_tpu.ops.wave import solve_wave as jax_solve_wave
from volcano_tpu.scheduler import Scheduler as JaxScheduler
from volcano_tpu.synth import solve_args_from_store as jax_args

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.ops.wave as tw
from volcano_tpu_torch import interop
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

FIELDS = ("assigned", "pipelined", "never_ready", "fit_failed", "idle",
          "q_alloc", "iters", "fb_exhausted", "fb_affinity")

CONF_BASE = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""


def _both(args, wave):
    jr = tonp(jax_solve_wave(*args, wave=wave))
    tr = interop.result_to_numpy(tw.solve_wave(
        *interop.solve_args_from_numpy(tonp(args)), wave=wave,
        device="cpu"))
    for f in FIELDS:
        a, b = np.asarray(getattr(jr, f)), np.asarray(getattr(tr, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), (f, a, b)
    return jr, tr


def _args(**kw):
    return jax_args(affinity_store(volcano_tpu, **kw), binpack=True,
                    nodeorder=True)


def test_zone_affinity_self_match():
    """Self zone-affine gangs: the first task places against total == 0,
    its siblings follow it into one zone."""
    args, _ = _args(mix=("aff",), residents=0, n_gangs=12, gang_size=6)
    jr, tr = _both(args, 64)
    assert tw.LAST_TWOPHASE["affinity"]
    assigned = np.asarray(tr.assigned).astype(np.int64)
    job = np.asarray(args[1].job)
    real = np.asarray(args[1].real)
    placed = real & (assigned >= 0)
    assert placed.sum() >= 24
    for j in np.unique(job[placed]):
        nodes = assigned[placed & (job == j)]
        # affinity_store: node i is in zone i % 4, every seventh node has
        # no zone label.
        zones = {n % 4 for n in nodes.tolist() if n % 7 != 6}
        assert len(zones) <= 1, (j, nodes)


def test_hostname_anti_affinity_exhausts_shortlist(monkeypatch):
    """Self anti-affine gangs on a shortlist of 4 nodes run it dry: the
    full-N fallback rescore fires for required-term profiles
    (fb_affinity) on both sides, the same number of times."""
    monkeypatch.setenv("VOLCANO_TPU_TOPK", "4")
    args, _ = _args(mix=("anti", "res_anti"), n_nodes=20, n_gangs=10,
                    gang_size=6)
    jr, tr = _both(args, 32)
    assert int(tr.fb_affinity) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_soft_spread_and_preferred_affinity(seed):
    """Zone spread (weight 10) and preferred zone affinity to resident
    apps (weight 5): soft scores on nonzero counts."""
    args, _ = _args(mix=("prefer", "spread", "plain"), seed=seed,
                    residents=3)
    _both(args, 32)
    assert tw.LAST_TWOPHASE["cnt0_any"]


def test_host_ports_in_wave_and_against_residents():
    """Gangs asking for 8080 (and 9000, which residents hold): tasks of
    one sub-round clash pairwise on a node, and against resident ports."""
    args, _ = _args(mix=("plain",), n_nodes=12, n_gangs=12, gang_size=4)
    jr, tr = _both(args, 16)
    assert tw.LAST_TWOPHASE["ports"]
    assigned = np.asarray(tr.assigned)
    ports = np.asarray(args[1].ports)
    for bit in range(32):
        has = ((ports[:, 0] >> bit) & 1).astype(bool) & (assigned >= 0)
        nodes = assigned[has]
        assert len(nodes) == len(np.unique(nodes)), bit


def test_ports_with_releasing_capacity():
    """Half the nodes' idle turned releasing: tasks pipeline onto the
    future idle and charge the pipelined port plane."""
    args, _ = _args(n_nodes=16, n_gangs=30, seed=5)
    nodes = tonp(args[0])
    idle = np.array(nodes.idle, np.float32)
    rel = np.zeros_like(idle)
    rel[::2] = idle[::2]
    idle[::2] = 0.0
    args = (nodes._replace(idle=idle, releasing=rel),) + tuple(args[1:])
    jr, tr = _both(args, 32)
    assert tw.LAST_TWOPHASE["future"] and tw.LAST_TWOPHASE["ports"]
    assert int((np.asarray(tr.pipelined) >= 0).sum()) > 0


def test_more_than_256_givers_in_one_subround():
    """One 512-task wave of self zone-affine gangs: more than GCAP = 256
    live givers per sub-round (the JAX full scatter form)."""
    args, _ = _args(mix=("aff",), n_nodes=64, n_gangs=8, gang_size=64,
                    node_cpu="32", residents=0)
    jr, tr = _both(args, 512)
    assert int((np.asarray(tr.assigned) >= 0).sum()) > 256


@pytest.mark.parametrize("wave,disjoint", [(16, False), (512, True)])
def test_terms_disjoint_both_ways(wave, disjoint):
    """Terms selecting resident apps recur across gangs: with small waves
    two waves share a term (window write-back), with one wave none do."""
    args, _ = _args(n_gangs=20, gang_size=4)
    _both(args, wave)
    assert tw.LAST_TWOPHASE["terms_disjoint"] == disjoint


def test_sparse_thresholds_forced(monkeypatch):
    """Both packages ship the count table and the profile tables as
    sparse entries (thresholds 0): the port rebuilds them with
    scatter_cnt0 / scatter_profile_tables, JAX with its jits."""
    for mod in (jw, tw):
        monkeypatch.setattr(mod, "CNT0_SPARSE_MIN", 0)
        monkeypatch.setattr(mod, "PROF_SPARSE_MIN", 0)
    args, _ = _args(seed=2)
    _both(args, 32)
    assert tw.LAST_TWOPHASE["sparse"] == (True, True)
    assert tw.LAST_TWOPHASE["cnt0_any"]


@pytest.mark.parametrize("dom_mb", [0, None])
def test_jax_domain_one_hot_and_gather(monkeypatch, dom_mb):
    """JAX reads the count windows through its [N, D] domain one-hot
    (default) or the gather (DOM_MM_MAX_MB = 0); the port gathers."""
    if dom_mb is not None:
        monkeypatch.setattr(jw, "DOM_MM_MAX_MB", dom_mb)
    jax.clear_caches()
    try:
        args, _ = _args(seed=3, n_gangs=30)
        _both(args, 64)
    finally:
        jax.clear_caches()


def test_jax_two_d_keys(monkeypatch):
    """JAX past its int32 key-space gate (VOLCANO_TPU_KEYSPACE_MAX small)
    uses 2-D (term, domain) keys; the port's keys are 2-D or int64
    always."""
    monkeypatch.setenv("VOLCANO_TPU_KEYSPACE_MAX", "8")
    args, _ = _args(seed=4, n_gangs=30)
    _both(args, 64)


def _hot_store(n_gangs=16, gang_size=6):
    """Every gang's tasks fit only three hot nodes (100 GiB of memory a
    task; nine small nodes hold 16 GiB): one contention group, tens of
    tasks a node in one sub-round.  Every fourth gang asks for host port
    8080 (min_member 1: one task a node binds), every fourth from the
    second is anti-affine to its own app by hostname (min_member 2: one
    copy a node), the rest are plain gangs of whole CPUs (min_member 6)."""
    api = volcano_tpu.api
    store = volcano_tpu.cache.ClusterStore()
    for i in range(3):
        store.add_node(api.Node(name=f"hot{i}", allocatable={
            "cpu": "64", "memory": "2Ti", "pods": 110},
            labels={"zone": "z0"}))
    for i in range(9):
        store.add_node(api.Node(name=f"small{i}", allocatable={
            "cpu": "8", "memory": "16Gi", "pods": 110},
            labels={"zone": f"z{1 + i % 2}"}))
    host = "kubernetes.io/hostname"
    for g in range(n_gangs):
        name = f"g{g:03d}"
        extra, min_member = {}, gang_size
        if g % 4 == 0:
            extra["host_ports"] = [8080]
            min_member = 1
        elif g % 4 == 1:
            extra["anti_affinity"] = [api.AffinityTerm(
                match_labels={"app": name}, topology_key=host)]
            min_member = 2
        store.add_pod_group(api.PodGroup(name=name, min_member=min_member,
                                         queue="default"))
        for k in range(gang_size):
            store.add_pod(api.Pod(
                name=f"{name}-{k}", labels={"app": name},
                annotations={api.GROUP_NAME_ANNOTATION: name},
                containers=[{"cpu": str(1 + g % 2), "memory": "100Gi"}],
                **extra))
    return store


@pytest.mark.parametrize("wave", [64, 256])
def test_hot_nodes_one_contention_group_with_ports_and_self_anti(wave):
    """The paths the walk_accept kernel reorders, held here on the plain
    reference: the JAX solve and the port's equal field for field (the
    assignment vectors bit for bit) on one contention group packed onto
    three hot nodes -- long same-node prefixes of byte-scale requests,
    host-port clashes inside a sub-round, and self anti-affine profiles
    capped at one copy a node."""
    args, _ = jax_args(_hot_store(), binpack=True, nodeorder=True)
    jr, tr = _both(args, wave)
    assert tw.LAST_TWOPHASE["ports"] and tw.LAST_TWOPHASE["affinity"]
    assigned = np.asarray(tr.assigned)
    job = np.asarray(args[1].job)
    placed = assigned >= 0
    # 2 TiB / 100 GiB: 20 tasks a hot node, the small nodes hold none.
    assert set(assigned[placed].tolist()) <= {0, 1, 2}
    assert 40 <= int(placed.sum()) <= 60
    ports = np.asarray(args[1].ports)[:, 0] != 0
    for n in range(3):
        assert int((ports & (assigned == n)).sum()) <= 1
    for j in np.unique(job[placed]):
        nodes = assigned[placed & (job == j)]
        if j % 4 == 1:
            assert len(nodes) == len(set(nodes.tolist())), (j, nodes)


# ------------------------------------------------------- twin cycles

def _reset_uids():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _twin(pkg, cycles=6):
    _reset_uids()
    store = pkg.synth.synthetic_cluster(
        n_nodes=256, n_pods=2048, gang_size=8, zones=16,
        affinity_fraction=0.05, anti_affinity_fraction=0.05,
        spread_fraction=0.1, seed=0)
    if pkg is volcano_tpu:
        store.pipeline = False
        sched = JaxScheduler(store, conf_str=CONF_BASE)
    else:
        sched = PortScheduler(store, conf_str=CONF_BASE, device="cpu")
    store.cycle_feed = repend_feed(list(range(8)))
    trace = []
    for _ in range(cycles):
        sched.run_once()
        dv = store._devincr_cache
        trace.append({
            "mirror": mirror_state(store),
            "binds": dict(store.binder.binds),
            "phases": {uid: pg.status.phase
                       for uid, pg in sorted(store.pod_groups.items())},
            "devincr": (None if dv is None else
                        (dict(dv.counts), dv.static_hits,
                         dv.static_builds)),
        })
    store.close()
    return trace


import volcano_tpu.synth  # noqa: E402
import volcano_tpu_torch.synth  # noqa: E402

_CACHE = {}


def _jax_trace(budget):
    if budget not in _CACHE:
        _CACHE[budget] = _twin(volcano_tpu)
    return _CACHE[budget]


@pytest.mark.parametrize("budget", [None, "0.05"])
@pytest.mark.parametrize("field", ["mirror", "binds", "phases", "devincr"])
def test_config5_twin_cycles_equal_jax(field, budget, monkeypatch):
    monkeypatch.delenv("VOLCANO_TPU_DEVINCR", raising=False)
    monkeypatch.delenv("VOLCANO_TPU_DEVSNAP", raising=False)
    if budget is None:
        monkeypatch.delenv("VOLCANO_TPU_AFF_BUDGET_MB", raising=False)
    else:
        monkeypatch.setenv("VOLCANO_TPU_AFF_BUDGET_MB", budget)
    calls = []
    real = tw.solve_wave

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tw, "solve_wave", counted)
    want = _jax_trace(budget)
    got = _twin(volcano_tpu_torch)
    assert len(got) == len(want) == 6
    for step, (a, b) in enumerate(zip(want, got)):
        assert a[field] == b[field], (field, step)
    assert len(got[0]["binds"]) == 2048
    if budget is None:
        # The warm key (with the count table's hash) held: warm
        # shortlists on nonzero counts.
        assert got[-1]["devincr"][0]["warm"] > 0
    else:
        # The cold cycle ran in several job-aligned chunks.
        assert len(calls) >= 6 + 3


def test_cnt0_hash_cap_switches_warm_shortlists_off(monkeypatch):
    """Past VOLCANO_TPU_DEVINCR_CNT0_HASH_MAX bytes the count table is not
    hashed and the warm key is absent: no warm shortlist on either side,
    the cycles still equal."""
    monkeypatch.delenv("VOLCANO_TPU_DEVINCR", raising=False)
    monkeypatch.delenv("VOLCANO_TPU_AFF_BUDGET_MB", raising=False)
    monkeypatch.setenv("VOLCANO_TPU_DEVINCR_CNT0_HASH_MAX", "0")
    want = _twin(volcano_tpu, cycles=4)
    got = _twin(volcano_tpu_torch, cycles=4)
    for a, b in zip(want, got):
        for field in ("mirror", "binds", "phases", "devincr"):
            assert a[field] == b[field], field
    assert got[-1]["devincr"][0]["warm"] == 0
