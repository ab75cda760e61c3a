"""The port's CUDA kernels on the card against the plain versions.

Marked ``cuda``: each test asks its fixture for a card and skips without
one (the CPU tests cover the plain versions against the JAX package).  On a
machine with a card (``--noconftest``: tests/conftest.py imports JAX,
which such a machine need not have):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from test_torch_fixtures import feature_store, one_node_gang

import volcano_tpu_torch
from volcano_tpu_torch import interop
from volcano_tpu_torch.ops import kernels
from volcano_tpu_torch.ops.wave import solve_wave
from volcano_tpu_torch.synth import solve_args_from_store, synthetic_cluster

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _solve_three_ways(store, wave):
    """(kernels on the card, plain versions on the card, CPU) results."""
    a_gpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True)
    a_cpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True,
                                     device="cpu")
    kernels.reset_launches()
    k = interop.result_to_numpy(solve_wave(*a_gpu, wave=wave))
    launched = dict(kernels.LAUNCHES)
    p = interop.result_to_numpy(solve_wave(*a_gpu, wave=wave, plain=True))
    c = interop.result_to_numpy(solve_wave(*a_cpu, wave=wave, device="cpu"))
    return k, p, c, launched


def _same(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("make,wave", [
    (lambda: synthetic_cluster(n_nodes=64, n_pods=512, gang_size=4,
                               n_queues=2, zones=4, seed=1), 128),
    (lambda: feature_store(volcano_tpu_torch, 96, 700, seed=2), 128),
    (lambda: one_node_gang(volcano_tpu_torch, cpu="4"), 8),
])
def test_card_solve_equals_plain_and_cpu(cuda, make, wave):
    k, p, c, launched = _solve_three_ways(make(), wave)
    _same(k, p)
    _same(k, c)
    solve_kernels = ("coarse_shortlist", "rank_candidates", "walk_accept",
                     "apply_commit")
    assert all(launched[k] > 0 for k in solve_kernels), launched


def test_rank_candidates_without_rows_launches_nothing(cuda):
    """An empty row list returns empty outputs and counts no launch."""
    N, R, UM, C, K = 16, 3, 4, 2, 4

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=cuda)

    i32 = torch.int32
    kernels.reset_launches()
    ranked, feas_k, p_any = kernels.rank_candidates(
        z(0, dtype=i32), None, z(UM, C, dtype=torch.bool), z(UM, C),
        z(N, dtype=i32), z(UM, R), z(UM, R), z(N, R), z(N, R),
        z(N, dtype=i32), z(N, dtype=i32), z(R), z(R, dtype=torch.bool),
        None, K)
    assert ranked.shape == (0, K) and ranked.dtype == i32
    assert feas_k.shape == (0, K) and feas_k.dtype == torch.bool
    assert p_any.shape == (0,)
    assert kernels.LAUNCHES["rank_candidates"] == 0


def _equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


@pytest.mark.parametrize("kind", ["mixed", "ties", "neg"])
@pytest.mark.parametrize("N,B,S", [(1024, 16, 51), (16384, 16, 819),
                                   (4096, 4, 737)])
def test_devincr_kernels_equal_plain(cuda, kind, N, B, S):
    """static_planes, coarse_shortlist (static_ext, with_cand) and
    warm_shortlist on the card equal their plain versions on the card."""
    from test_torch_fixtures import shortlist_case, shortlist_tensors

    case = shortlist_case(7, U=64, N=N, kind=kind)
    prof, cls, nd, w, eps, slot = shortlist_tensors(case, cuda)
    args = (nd["idle"], nd["alloc"], nd["ntasks"], nd["max_tasks"], eps,
            slot, w)
    kernels.reset_launches()
    stat = kernels.static_planes(prof, cls, 1.0, True)
    stat_p = kernels.static_planes(prof, cls, 1.0, True, plain=True)
    _equal(stat[0], stat_p[0], "stat_ok")
    _equal(stat[1], stat_p[1], "stat_score")
    cold = kernels.coarse_shortlist(prof, cls, *args, S, True, stat=stat,
                                    n_blocks=B)
    cold_p = kernels.coarse_shortlist(prof, cls, *args, S, True, stat=stat,
                                      n_blocks=B, plain=True)
    for a, b, what in zip(cold, cold_p, ("sl", "ok", "sc", "cs", "ci")):
        _equal(a, b, what)
    direct = kernels.coarse_shortlist(prof, cls, *args, S, True, stat=stat)
    _equal(direct[0], cold[0], "with_cand shortlist != direct shortlist")
    # Dirty two blocks: their nodes lose capacity; warm == full re-rank.
    nlb = N // B
    db = torch.tensor([1, B - 1], dtype=torch.int32, device=cuda)
    idle2 = nd["idle"].clone()
    idle2[nlb:nlb + nlb // 2] = 0.0
    idle2[N - 3:] *= 0.5
    args2 = (idle2,) + args[1:]
    warm = kernels.warm_shortlist(prof, cls.class_id, *stat, *args2[:6], w,
                                  db, cold[3], cold[4], S)
    warm_p = kernels.warm_shortlist(prof, cls.class_id, *stat, *args2[:6],
                                    w, db, cold[3], cold[4], S, plain=True)
    for a, b, what in zip(warm, warm_p, ("sl", "cs", "ci")):
        _equal(a, b, what)
    full = kernels.coarse_shortlist(prof, cls, *args2, S, True, stat=stat,
                                    n_blocks=B)
    for a, b, what in zip(warm, (full[0], full[3], full[4]),
                          ("sl", "cs", "ci")):
        _equal(a, b, f"warm != full re-rank: {what}")
    assert kernels.LAUNCHES["static_planes"] == 1
    assert kernels.LAUNCHES["warm_shortlist"] == 1
    assert kernels.LAUNCHES["coarse_shortlist"] == 3


@pytest.mark.parametrize("dtype,width", [
    (torch.float32, 3), (torch.int32, 0), (torch.bool, 0), (torch.int32, 2),
])
def test_scatter_rows_equals_plain(cuda, dtype, width):
    """In-place row patch of a resident plane equals index assignment;
    rows outside the delta keep their bytes."""
    g = torch.Generator().manual_seed(3)
    shape = (16384,) + ((width,) if width else ())
    base = torch.randint(-1000, 1000, shape, generator=g).to(dtype)
    rows = torch.randperm(16384, generator=g)[:100].to(torch.int32)
    vals = torch.randint(-1000, 1000, (100,) + shape[1:],
                         generator=g).to(dtype)
    got = base.to(cuda)
    want = base.to(cuda)
    kernels.reset_launches()
    kernels.scatter_rows(got, rows.to(cuda), vals.to(cuda))
    kernels.scatter_rows(want, rows.to(cuda), vals.to(cuda), plain=True)
    _equal(got, want, "scatter_rows")
    assert kernels.LAUNCHES["scatter_rows"] == 1


def _cycle_run(device, cycles=6):
    """Port cycles (re-pend feed + churn) on ``device``: per-cycle binds,
    phases and mirror states."""
    import itertools
    import random

    import volcano_tpu_torch.api.spec as spec
    from test_torch_fixtures import churn, mirror_state, repend_feed
    from volcano_tpu_torch.scheduler import Scheduler

    spec._uid_counter = itertools.count(1)
    spec._ts_counter = itertools.count(1)
    store = synthetic_cluster(n_nodes=24, n_pods=72, gang_size=4, seed=13)
    sched = Scheduler(store, device=device)
    store.cycle_feed = repend_feed([0, 1])
    rng = random.Random(7)
    out = []
    for step in range(cycles):
        sched.run_once()
        out.append((dict(store.binder.binds),
                    {u: pg.status.phase
                     for u, pg in sorted(store.pod_groups.items())},
                    mirror_state(store)))
        if step % 2 == 1:
            churn(volcano_tpu_torch.api, store, rng, step)
    return out, store


def test_cycle_on_card_equals_cpu(cuda):
    """Scheduler.run_once() on the card equals the CPU run cycle by
    cycle, and every kernel of the cycle launched."""
    kernels.reset_launches()
    card, store = _cycle_run(None)
    launched = dict(kernels.LAUNCHES)
    cpu, _ = _cycle_run("cpu")
    assert card == cpu
    assert store.device_snapshot.device.type == "cuda"
    for k in ("coarse_shortlist", "rank_candidates", "walk_accept",
              "apply_commit", "static_planes", "warm_shortlist",
              "scatter_rows"):
        assert launched[k] > 0, (k, launched)


def test_resident_planes_byte_equal_across_a_solve(cuda):
    """A cycle that solves but leaves the node table alone writes no
    resident plane; the solve counts no host reads."""
    from test_torch_fixtures import repend_feed
    from volcano_tpu_torch.ops.wave import LAST_TWOPHASE
    from volcano_tpu_torch.scheduler import Scheduler

    store = synthetic_cluster(n_nodes=24, n_pods=72, gang_size=4, seed=13)
    sched = Scheduler(store)
    store.cycle_feed = repend_feed([0, 1])
    sched.run_once()
    snap = store.device_snapshot
    before = {k: v.clone() for k, v in snap._planes.items()}
    cls_before = {k: v.clone() for k, v in snap._cls_planes.items()}
    sched.run_once()
    torch.cuda.synchronize()
    assert LAST_TWOPHASE["host_reads"] == 0
    assert snap.hits >= 1
    for k, v in before.items():
        assert torch.equal(v, snap._planes[k]), k
    for k, v in cls_before.items():
        assert torch.equal(v, snap._cls_planes[k]), k


def _victim_case(seed, V, N=64, Q=4, R=3):
    rng = np.random.RandomState(seed)
    crank = np.argsort(np.argsort(rng.rand(V))).astype(np.int32)
    v_req = np.zeros((V, R), np.float32)
    v_req[:, 0] = rng.uniform(0.0, 3.0, V)
    v_req[:, 1] = rng.randint(1, 5000, V) * 1.0e6  # not powers of two
    v_req[rng.rand(V, R) < 0.2] = 0.0
    q_des = rng.uniform(1.0, 6.0, (Q, R)).astype(np.float32)
    q_des[rng.rand(Q, R) < 0.3] = 3.0e38
    return dict(
        v_ok=rng.rand(V) > 0.2, v_jprio=rng.randint(0, 4, V).astype(np.int32),
        v_crank=crank, v_tie=np.arange(V, dtype=np.int32),
        v_queue=rng.randint(-1, Q, V).astype(np.int32),
        v_node=rng.randint(0, N, V).astype(np.int32), v_req=v_req,
        q_alloc=rng.uniform(0.0, 8.0, (Q, R)).astype(np.float32),
        q_deserved=q_des, q_reclaimable=rng.rand(Q) > 0.3)


@pytest.mark.parametrize("V", [50, 1024, 3000])
@pytest.mark.parametrize("mode", [0, 1])
def test_victim_scores_kernel_equals_plain(cuda, mode, V):
    """One tile, exactly one tile, and a sort with global passes; both
    modes; every output identical to the plain version (evictable bit for
    bit: both add a node's rows in victim-index order in float32)."""
    c = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
         for k, v in _victim_case(V + mode, V).items()}
    args = (c["v_ok"], c["v_jprio"], c["v_crank"], c["v_tie"], c["v_queue"],
            c["v_node"], c["v_req"], 2, 1, c["q_alloc"], c["q_deserved"],
            c["q_reclaimable"], mode, 64)
    before = kernels.LAUNCHES["victim_scores"]
    got = kernels.victim_scores(*args)
    want = kernels.victim_scores(*args, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["victim_scores"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[0].any() and not got[0].all()


def test_future_solve_on_card_equals_plain_and_cpu(cuda):
    """A solve with releasing capacity: the kernels' future branch on the
    card equals the plain versions and the CPU."""
    store = synthetic_cluster(n_nodes=48, n_pods=320, gang_size=4, n_queues=2,
                              seed=3)
    results = []
    for dev in (None, "cpu"):
        args, _ = solve_args_from_store(store, device=dev)
        nodes = args[0]
        rel = torch.floor(nodes.idle / 2000.0) * 1000.0
        rel[:, 1:] = 0.0
        nodes = nodes._replace(idle=nodes.idle - rel, releasing=rel,
                               pipelined=torch.zeros_like(rel))
        args = (nodes,) + args[1:]
        kw = {} if dev is None else {"device": "cpu"}
        results.append(interop.result_to_numpy(solve_wave(*args, wave=64,
                                                          **kw)))
        if dev is None:
            results.append(interop.result_to_numpy(
                solve_wave(*args, wave=64, plain=True)))
    k, p, c = results
    _same(k, p)
    _same(k, c)
    assert (k.pipelined >= 0).any()


def test_preempt_cycles_on_card_equal_cpu(cuda, monkeypatch):
    """The preempt lane on the card (victim_scores, the what-if solve, the
    future-branch solves while the victims terminate) equals the CPU run
    cycle by cycle."""
    from test_torch_fixtures import mirror_state

    from volcano_tpu_torch.cache import ClusterStore, FakeBinder, FakeEvictor
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.sim import ClusterSimulator

    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    conf = ('actions: "enqueue, allocate, preempt"\ntiers:\n- plugins:\n'
            '  - name: priority\n  - name: gang\n  - name: conformance\n'
            '- plugins:\n  - name: drf\n  - name: predicates\n'
            '  - name: proportion\n  - name: nodeorder\n')

    def run(device):
        import itertools

        import volcano_tpu_torch.api.spec as spec

        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)
        store = ClusterStore(binder=FakeBinder(), evictor=FakeEvictor())
        ClusterSimulator.priority_tier_workload(store, workers=8,
                                                serving_tasks=4)
        sched = Scheduler(store, conf_str=conf, device=device)
        sim = ClusterSimulator(store, grace_steps=2)
        out = []
        for _ in range(8):
            sched.run_once()
            out.append((sorted(store.binder.binds.items()),
                        list(store.evictor.evicts), mirror_state(store)))
            sim.step()
        return out

    kernels.reset_launches()
    card = run(None)
    launched = dict(kernels.LAUNCHES)
    assert card == run("cpu")
    assert launched["victim_scores"] > 0 and launched["walk_accept"] > 0


def _tensors(case, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v for k, v in case.items()}


@pytest.mark.parametrize("seed", range(6))
def test_frag_scores_kernel_equals_plain(cuda, seed):
    """frag_scores on 3,000-odd nodes, R = 3..5, half the seeds with rows
    past the int32 range: every output identical to the plain version
    (frag bit for bit: the same operations in the same order)."""
    from test_torch_fixtures import frag_case

    overflow = seed % 2 == 0
    c = _tensors(frag_case(seed, N=3000 + seed, R=3 + seed % 3,
                           overflow=overflow), cuda)
    args = (c["idle"], c["alloc"], c["ready"], c["evictable"],
            c["prof_req"], c["eps"])
    before = kernels.LAUNCHES["frag_scores"]
    got = kernels.frag_scores(*args)
    want = kernels.frag_scores(*args, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["frag_scores"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool((got[0] > 0).any())
    assert (int(got[1].max()) == 2 ** 31 - 1) == overflow


@pytest.mark.parametrize("seed", range(6))
def test_gang_block_fit_and_fabric_frag_equal_plain(cuda, seed):
    """gang_block_fit (blockless rows, pod-slot caps, padded profiles) and
    fabric_frag on its output: identical to the plain versions (integer
    sums are exact in any order)."""
    from test_torch_fixtures import block_fit_case

    c = _tensors(block_fit_case(seed, N=5000 + seed, R=3 + seed % 3,
                                n_blocks=64), cuda)
    args = (c["idle"], c["ready"], c["ntasks"], c["max_tasks"],
            c["block_id"], c["prof_req"], c["prof_cnt"], c["eps"],
            c["n_blocks"])
    before = dict(kernels.LAUNCHES)
    got = kernels.gang_block_fit(*args)
    want = kernels.gang_block_fit(*args, plain=True)
    frag = kernels.fabric_frag(got[0], got[1], c["prof_cnt"])
    frag_p = kernels.fabric_frag(got[0], got[1], c["prof_cnt"], plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gang_block_fit"] == before["gang_block_fit"] + 1
    assert kernels.LAUNCHES["fabric_frag"] == before["fabric_frag"] + 1
    for g, w in zip(list(got) + [frag], list(want) + [frag_p]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(got[1].any()) and not bool(got[1].all())


@pytest.mark.parametrize("make,wave", [
    (lambda: synthetic_cluster(n_nodes=64, n_pods=512, gang_size=4,
                               n_queues=2, zones=4, seed=1), 128),
    (lambda: one_node_gang(volcano_tpu_torch, cpu="4"), 8),
])
def test_card_solve_with_node_bias_equals_plain_and_cpu(cuda, make, wave):
    """A solve with a node-order bias (both rank_candidates modes: the
    shortlist ranking and the full-N fallback of the one-node gang) equals
    the plain versions and the CPU, and differs from the biasless solve."""
    store = make()
    a_gpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True)
    a_cpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True,
                                     device="cpu")
    N = int(a_cpu[0].idle.shape[0])
    bias = np.zeros(N, np.float32)
    bias[np.random.RandomState(5).rand(N) < 0.3] = 7.5
    kernels.CAPTURE = {}
    try:
        k = interop.result_to_numpy(solve_wave(*a_gpu, bias, wave=wave))
        assert "rank_candidates:bias" in kernels.CAPTURE
    finally:
        kernels.CAPTURE = None
    p = interop.result_to_numpy(solve_wave(*a_gpu, bias, wave=wave,
                                           plain=True))
    c = interop.result_to_numpy(solve_wave(*a_cpu, bias, wave=wave,
                                           device="cpu"))
    _same(k, p)
    _same(k, c)


def test_rebalance_and_topology_cycles_on_card_equal_cpu(cuda, monkeypatch):
    """The rebalance lane and the fabric hooks on the card (frag_scores,
    gang_block_fit, fabric_frag, the biased what-if and live solves) equal
    the CPU run cycle by cycle on the require-contiguous fabric."""
    import itertools

    from test_torch_fixtures import mirror_state

    import volcano_tpu_torch.api.spec as spec
    from volcano_tpu_torch.cache import FakeBinder
    from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.sim import ClusterSimulator
    from volcano_tpu_torch.synth import fabric_cluster

    monkeypatch.setenv("VOLCANO_TPU_REBALANCE_DRAIN_CAP", "64")

    def run(device):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)
        store = fabric_cluster(binder=FakeBinder())
        sched = Scheduler(store, conf_str=REBALANCE_SCHEDULER_CONF,
                          device=device)
        sim = ClusterSimulator(store, grace_steps=2)
        out = []
        for _ in range(6):
            sched.run_once()
            out.append((sorted(store.binder.binds.items()),
                        list(store.evictor.evicts), mirror_state(store),
                        store.flight.last().rebalance))
            sim.step()
        return out

    kernels.reset_launches()
    card = run(None)
    launched = dict(kernels.LAUNCHES)
    assert card == run("cpu")
    for k in ("frag_scores", "gang_block_fit", "fabric_frag",
              "rank_candidates"):
        assert launched[k] > 0, launched
    assert sum(k.startswith("default/fabgang-")
               for k, _node in card[-1][0]) == 32
