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


def _victim_kind(kind, V, seed):
    """``_victim_case`` made harder: "dup" duplicate cranks with a
    permuted tie; "inelig" every row ineligible; "wide" cranks, ties and
    priorities over all of int32 (negative ones too), ties repeating."""
    c = _victim_case(seed, V)
    rng = np.random.RandomState(seed + 11)
    if kind == "dup":
        c["v_crank"] = rng.randint(0, max(1, V // 8), V).astype(np.int32)
        c["v_tie"] = rng.permutation(V).astype(np.int32)
    elif kind == "inelig":
        c["v_ok"] = np.zeros(V, bool)
    elif kind == "wide":
        lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        c["v_crank"] = rng.randint(lo, hi, V, dtype=np.int64).astype(
            np.int32)
        c["v_tie"] = rng.randint(-3, 3, V).astype(np.int32)
        c["v_jprio"] = rng.choice([lo, -5, 0, 1, hi], V).astype(np.int32)
    return c


def _victim_both(c, mode, cuda, p_prio=2, N=64):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
         for k, v in c.items()}
    args = (t["v_ok"], t["v_jprio"], t["v_crank"], t["v_tie"], t["v_queue"],
            t["v_node"], t["v_req"], p_prio, 1, t["q_alloc"],
            t["q_deserved"], t["q_reclaimable"], mode, N)
    before = kernels.LAUNCHES["victim_scores"]
    got = kernels.victim_scores(*args)
    want = kernels.victim_scores(*args, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["victim_scores"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return got


@pytest.mark.parametrize("kind,V", [
    ("plain", 70000), ("plain", 131072), ("dup", 3000), ("dup", 70000),
    ("inelig", 5000), ("wide", 4000), ("plain", 1), ("wide", 1)])
@pytest.mark.parametrize("mode", [0, 1])
def test_victim_scores_general_keys_equal_plain(cuda, mode, kind, V):
    """Past 65,536 rows, duplicate cranks ordered by a permuted tie, no
    eligible row, keys over all of int32, one row: every output equal to
    the plain version in both modes."""
    c = _victim_kind(kind, V, 100 * V + mode)
    got = _victim_both(c, mode, cuda, p_prio=(2 if kind != "wide" else 1))
    if kind == "inelig":
        assert not got[0].any() and not got[2].any()


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


def _bits_equal(a, b, what):
    """Equal dtype, shape and bytes: +0.0 and -0.0 told apart."""
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), what


def _device_ops(fn, tries=3):
    """Names of the device operations (kernels, memsets, copies) one call
    of ``fn`` put on the card, from a ``torch.profiler`` trace.  A short
    trace has come back without its first device events, so the trace
    opens with a ~1 ms spin kernel, left out of the names, and a
    repeatable ``fn`` is traced ``tries`` times: the longest list wins (a
    trace loses events, it never adds one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and "spin_kernel" not in e.name),
                        key=lambda e: e.time_range.start)
        names = [e.name.replace("(anonymous namespace)::", "")
                 for e in events]
        # "void f<4, 1024>(float const*, ...)" -> "f"
        names = [n.removeprefix("void ").split("(")[0].split("<")[0]
                 for n in names]
        if len(names) > len(best):
            best = names
    return best


# cuGraphNodeGetType's kinds (cuda.h CUgraphNodeType).
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


def _graph_ops(fn, warm=True):
    """The device operations one call of ``fn`` puts on the card, counted
    by kind ("kernel", "memcpy", "memset") from a CUDA graph captured
    around the call.  Unlike a profiler trace it drops nothing (short
    ``torch.profiler`` traces late in a long run came back empty).
    ``warm``: call ``fn`` once outside the capture first."""
    import ctypes

    if warm:
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds = {}
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(t)) == 0
        kind = _NODE_KINDS.get(t.value, f"type {t.value}")
        kinds[kind] = kinds.get(kind, 0) + 1
    g.reset()
    return kinds


@pytest.mark.parametrize("seed,N,U,n_blocks,cluster", [
    (0, 700, 4, 16, 0), (1, 700, 4, 16, 8), (2, 1025, 5, 64, 1),
    (3, 1025, 5, 64, 8), (4, 8192, 4, 128, 1), (5, 8192, 4, 128, 8),
    (6, 20000, 3, 256, 0), (7, 20000, 3, 256, 1), (8, 3000, 4, 16383, 0),
    (9, 3000, 4, 16383, 8), (10, 300, 60000, 64, 0), (11, 1, 4, 4, 0)])
def test_gang_block_fit_edges_equal_plain(cuda, seed, N, U, n_blocks,
                                          cluster):
    """The one-launch cluster kernel at its edges (``block_fit_edge_case``:
    block ids -1, -7, n_blocks and past it, nodes not ready, ntasks past a
    positive max_tasks, an all-zero profile row with and without a count),
    N below one CTA's 1,024 threads and not a multiple of them, cluster
    sizes forced to 1 and 8 and chosen by N, and tables past one CTA's
    shared memory: 16,383 x 4 int32 (the tile of rows) and 64 x 60,000
    (the tile of profiles).  cfit, whole and score identical to the plain
    version; one kernel and no other device operation a call."""
    from test_torch_fixtures import block_fit_edge_case

    c = _tensors(block_fit_edge_case(seed, N=N, U=U, R=3 + seed % 3,
                                     n_blocks=n_blocks), cuda)
    args = (c["idle"], c["ready"], c["ntasks"], c["max_tasks"],
            c["block_id"], c["prof_req"], c["prof_cnt"], c["eps"],
            c["n_blocks"])
    before = kernels.LAUNCHES["gang_block_fit"]
    got = kernels.gang_block_fit(*args, cluster=cluster)
    want = kernels.gang_block_fit(*args, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gang_block_fit"] == before + 1
    for g, w, what in zip(got, want, ("cfit", "whole", "score")):
        _bits_equal(g, w, what)
    if seed % 2:
        assert not bool(got[1].any())
    if N > 1:
        assert bool((got[0] > 0).any())
    ops = _device_ops(lambda: kernels.gang_block_fit(*args, cluster=cluster))
    assert ops == ["block_fit_kernel"], ops


@pytest.mark.parametrize("seed,N,U,n_blocks,cluster", [
    (3, 8192, 4, 128, c) for c in range(1, 17)] + [
    (8, 3000, 4, 16383, 0), (9, 3000, 4, 16383, 8),
    (10, 300, 60000, 64, 0), (11, 1, 4, 4, 0), (12, 700, 4, 16, 0),
    (13, 1025, 5, 64, 8)])
def test_fused_frag_equals_plain_and_standalone(cuda, seed, N, U, n_blocks,
                                                cluster):
    """The ``frag`` plane the block-fit launch writes: bytes equal to
    ``_fabric_frag_plain`` on the launch's own cfit / whole, to the
    standalone ``fabric_frag`` kernel on them and to the plain block fit's
    ``frag``, at every cluster size at the [topology] shape (8,192 nodes
    in 128 blocks), with row tiles (16,383 blocks) and two profile tiles
    (60,000 profiles: written after the last), one node; on odd seeds no
    block is whole and some block's frag is positive.  One kernel a call;
    it counts as a fused ``fabric_frag`` launch, not as one of its
    own."""
    from test_torch_fixtures import block_fit_edge_case

    c = _tensors(block_fit_edge_case(seed, N=N, U=U, R=3 + seed % 3,
                                     n_blocks=n_blocks), cuda)
    if N == 8192:
        c["block_id"] = torch.arange(N, dtype=torch.int32,
                                     device=cuda) // 64
    args = (c["idle"], c["ready"], c["ntasks"], c["max_tasks"],
            c["block_id"], c["prof_req"], c["prof_cnt"], c["eps"],
            c["n_blocks"])
    before = dict(kernels.LAUNCHES)
    fused = kernels.FUSED["fabric_frag"]
    got = kernels.gang_block_fit(*args, cluster=cluster)
    assert kernels.LAUNCHES["fabric_frag"] == before["fabric_frag"]
    assert kernels.FUSED["fabric_frag"] == fused + 1
    want = kernels.gang_block_fit(*args, plain=True)
    alone = kernels.fabric_frag(got[0], got[1], c["prof_cnt"])
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("cfit", "whole", "score", "frag")):
        _bits_equal(g, w, what)
    _bits_equal(got[3], kernels._fabric_frag_plain(got[0], got[1],
                                                   c["prof_cnt"]),
                "frag vs fabric_frag plain")
    _bits_equal(got[3], alone, "frag vs the standalone kernel")
    if N > 1 and seed % 2:
        assert not bool(got[1].any()) and bool((got[3] > 0).any())
    ops = _device_ops(lambda: kernels.gang_block_fit(*args, cluster=cluster))
    assert ops == ["block_fit_kernel"], ops


@pytest.mark.parametrize("N", [1, 127, 3001, 16384])
@pytest.mark.parametrize("R,U", [(1, 4), (2, 4), (3, 64), (5, 65),
                                 (16, 130)])
@pytest.mark.parametrize("zero_rows", ["first", "between", "last"])
def test_frag_scores_edges_equal_plain(cuda, N, R, U, zero_rows):
    """frag_scores at the kernel's edges (``frag_edge_case``): all-zero
    profile rows first, between the live rows and last (skipped by the
    kernel: the outputs equal those with the rows first), U up to and past
    the 64-row staging chunk, R 1-16, 2N not a multiple of the 256-thread
    CTA, overflow rows on odd R; inputs through ``stage_frag`` (one staged
    buffer), outputs the rows of one [3, N] buffer, every byte equal to
    the plain version."""
    from test_torch_fixtures import frag_edge_case

    from volcano_tpu_torch.ops import rebalance as treb

    overflow = R % 2 == 1
    names = ("idle", "alloc", "ready", "evictable", "prof_req", "eps")
    c = frag_edge_case(R + N, N=N, U=U, R=R, zero_rows=zero_rows,
                       overflow=overflow)
    before = kernels.LAUNCHES["frag_scores"]
    got = treb.frag_scores(*(c[k] for k in names), device=cuda)
    assert kernels.LAUNCHES["frag_scores"] == before + 1
    t = _tensors(c, cuda)
    want = kernels.frag_scores(*(t[k] for k in names), plain=True)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("frag", "fit_now", "fit_freed")):
        _bits_equal(g, w, what)
    first = frag_edge_case(R + N, N=N, U=U, R=R, zero_rows="first",
                           overflow=overflow)
    tf = _tensors(first, cuda)
    ref = kernels.frag_scores(*(tf[k] for k in names))
    for g, w, what in zip(got, ref, ("frag", "fit_now", "fit_freed")):
        _bits_equal(g, w, f"{what}: zero rows {zero_rows} vs first")
    if N > 1000:
        assert (int(got[1].max()) == 2 ** 31 - 1) == overflow


def test_frag_scores_one_copy_each_way(cuda):
    """One ``ops.rebalance.frag_scores`` call and its fetch at the
    [rebalance] shape (16,384 padded nodes, R 2, a 4-row table with one
    live row): one host-to-device copy, the kernel, one device-to-host
    copy, and nothing else."""
    from test_torch_fixtures import frag_edge_case

    from volcano_tpu_torch.ops import rebalance as treb

    c = frag_edge_case(0, N=16384, U=4, R=2, zero_rows="last")
    c["prof_req"][1:] = 0.0
    names = ("idle", "alloc", "ready", "evictable", "prof_req", "eps")

    def call():
        return treb.frag_scores(*(c[k] for k in names),
                                device=cuda).packed.cpu()

    ops = _device_ops(call)
    kinds = [("HtoD" if "HtoD" in o else "DtoH" if "DtoH" in o else o)
             for o in ops]
    assert kinds == ["HtoD", "frag_scores_kernel", "DtoH"], ops


def test_gang_block_fit_every_cluster_size_equals_plain(cuda):
    """The [topology] shape (8,192 nodes in 128 blocks of 64) at every
    cluster size the kernel takes, 1 to 16: all identical."""
    from test_torch_fixtures import block_fit_edge_case

    c = _tensors(block_fit_edge_case(2, N=8192, U=4, n_blocks=128), cuda)
    c["block_id"] = torch.arange(8192, dtype=torch.int32,
                                 device=cuda) // 64
    args = (c["idle"], c["ready"], c["ntasks"], c["max_tasks"],
            c["block_id"], c["prof_req"], c["prof_cnt"], c["eps"], 128)
    want = kernels.gang_block_fit(*args, plain=True)
    for cluster in range(1, 17):
        got = kernels.gang_block_fit(*args, cluster=cluster)
        for g, w, what in zip(got, want, ("cfit", "whole", "score")):
            _bits_equal(g, w, f"{what} (cluster {cluster})")


@pytest.mark.parametrize("kind,k,u,e", [
    ("pad", 16, 6, 5), ("pad", 16, 1, 1), ("origin", 16, 1, 1),
    ("origin", 64, 7, 5), ("negzero", 256, 33, 17), ("full", 64, 3, 5),
    ("full", 1024, 31, 33), ("origin", 4096, 4096, 4097),
    ("negzero", 4096, 4096, 4097)])
def test_scatter_profile_tables_edges_equal_plain(cuda, kind, k, u, e):
    """The two-launch fill and scatter at its edges
    (``profile_entry_case``): padding only, a real entry at (0, 0) among
    the padded ones, real soft values of -0.0 (+0.0 in the tables), every
    cell real; u x e not a multiple of 16, a single cell, and the
    captured config-5 shape (4,096 x 4,097).  Every plane identical to the
    plain version byte for byte; two kernels and no memset a call."""
    from test_torch_fixtures import profile_entry_case

    from volcano_tpu_torch.ops import affkernels

    r, c, f, s = (torch.from_numpy(a).to(cuda)
                  for a in profile_entry_case(kind, k, u, e, seed=k + u))
    before = kernels.LAUNCHES["scatter_profile_tables"]
    got = affkernels.scatter_profile_tables(r, c, f, s, u, e)
    want = affkernels.scatter_profile_tables(r, c, f, s, u, e, plain=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scatter_profile_tables"] == before + 1
    for a, b, what in zip(got, want, ("aff", "anti", "match", "soft")):
        _bits_equal(a, b, what)
        assert a.data_ptr() % 16 == 0, what
    ops = _device_ops(
        lambda: affkernels.scatter_profile_tables(r, c, f, s, u, e))
    assert sorted(ops) == ["scatter_profile_kernel",
                           "zero_planes_kernel"], ops


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
    gang_block_fit with the fabric_frag plane its launch writes, the biased
    what-if and live solves) equal the CPU run cycle by cycle on the
    require-contiguous fabric, the two frag gauges included; the
    standalone fabric_frag kernel is not launched on this path."""
    import itertools

    from test_torch_fixtures import mirror_state

    import volcano_tpu_torch.api.spec as spec
    from volcano_tpu_torch.cache import FakeBinder
    from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF
    from volcano_tpu_torch.metrics import metrics
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.sim import ClusterSimulator
    from volcano_tpu_torch.synth import fabric_cluster

    monkeypatch.setenv("VOLCANO_TPU_REBALANCE_DRAIN_CAP", "64")
    gauges = (metrics.topology_frag_score, metrics.rebalance_frag_score)

    def run(device):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)
        for g in gauges:
            g.data.clear()
        store = fabric_cluster(binder=FakeBinder())
        sched = Scheduler(store, conf_str=REBALANCE_SCHEDULER_CONF,
                          device=device)
        sim = ClusterSimulator(store, grace_steps=2)
        out = []
        for _ in range(6):
            sched.run_once()
            out.append((sorted(store.binder.binds.items()),
                        list(store.evictor.evicts), mirror_state(store),
                        store.flight.last().rebalance,
                        [dict(g.data) for g in gauges]))
            sim.step()
        return out

    kernels.reset_launches()
    card = run(None)
    launched = dict(kernels.LAUNCHES)
    fused = dict(kernels.FUSED)
    assert card == run("cpu")
    for k in ("frag_scores", "gang_block_fit", "rank_candidates"):
        assert launched[k] > 0, launched
    assert launched["fabric_frag"] == 0, launched
    assert fused["fabric_frag"] == launched["gang_block_fit"], fused
    assert card[0][4][0], card[0][4]
    assert sum(k.startswith("default/fabgang-")
               for k, _node in card[-1][0]) == 32


# ------------------------------------------------- inter-pod affinity

def _aff_case(seed, dev, U=24, E=12, D=40, N=200, K=2, cnt_density=0.2,
              with_pip=True):
    """Random affinity tables: counts with real entries (some terms with
    none, so the self-match rule has both outcomes), domain-less nodes,
    and integer soft weights 5 and 10 of both signs."""
    from volcano_tpu_torch.ops.affkernels import AffTerms

    rng = np.random.RandomState(seed)
    nd = rng.randint(-1, D, (N, K)).astype(np.int32)
    tk = rng.randint(0, K, E).astype(np.int32)
    cnt = np.where(rng.rand(E, D) < cnt_density,
                   rng.randint(1, 4, (E, D)), 0).astype(np.int32)
    cnt[rng.rand(E) < 0.3] = 0
    pip = (np.where(rng.rand(E, D) < 0.05, 1, 0).astype(np.int32)
           if with_pip else None)
    soft = (rng.choice([0.0, 5.0, -5.0, 10.0, -10.0], (U, E))
            * (rng.rand(U, E) < 0.3)).astype(np.float32)

    def t(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    return AffTerms(t(nd), t(tk), t(cnt), t(pip),
                    t(rng.rand(U, E) < 0.15), t(rng.rand(U, E) < 0.15),
                    t(rng.rand(U, E) < 0.3), t(soft))


@pytest.mark.parametrize("k,shape", [(16, (8, 9)), (1024, (513, 300)),
                                     (4096, (4097, 2000))])
def test_aff_tables_equal_plain(cuda, k, shape):
    """scatter_cnt0 (against its plain version and one index_put_) and
    scatter_profile_tables, with padded entries adding 0 at (0, 0)."""
    from volcano_tpu_torch.ops import affkernels

    e, d = shape
    rng = np.random.RandomState(k)
    real = k // 2
    cells = rng.choice(e * d, real, replace=False)
    rows = np.concatenate([cells // d, np.zeros(k - real, np.int64)])
    cols = np.concatenate([cells % d, np.zeros(k - real, np.int64)])
    vals = np.concatenate([rng.randint(1, 50, real),
                           np.zeros(k - real, np.int64)]).astype(np.int32)
    flags = np.concatenate([rng.randint(0, 8, real),
                            np.zeros(k - real, np.int64)]).astype(np.int8)
    soft = np.concatenate([rng.choice([5.0, -5.0, 10.0, -10.0, 0.0], real),
                           np.zeros(k - real)]).astype(np.float32)
    r = torch.from_numpy(rows.astype(np.int32)).to(cuda)
    c = torch.from_numpy(cols.astype(np.int32)).to(cuda)
    v = torch.from_numpy(vals).to(cuda)
    before = dict(kernels.LAUNCHES)
    got = affkernels.scatter_cnt0(r, c, v, e, d)
    want = affkernels.scatter_cnt0(r, c, v, e, d, plain=True)
    _equal(got, want, "cnt0")
    lib = torch.zeros((e, d), dtype=torch.int32, device=cuda)
    lib.index_put_((r.long(), c.long()), v, accumulate=True)
    _equal(got, lib, "cnt0 vs index_put_")
    f = torch.from_numpy(flags).to(cuda)
    s = torch.from_numpy(soft).to(cuda)
    got = affkernels.scatter_profile_tables(r, c, f, s, e, d)
    want = affkernels.scatter_profile_tables(r, c, f, s, e, d, plain=True)
    for a, b, what in zip(got, want, ("aff", "anti", "match", "soft")):
        _equal(a, b, what)
    assert kernels.LAUNCHES["scatter_cnt0"] == before["scatter_cnt0"] + 1
    assert (kernels.LAUNCHES["scatter_profile_tables"]
            == before["scatter_profile_tables"] + 1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["all", "shared", "rows"])
def test_aff_live_equals_plain(cuda, seed, mode):
    from volcano_tpu_torch.ops import affkernels

    at = _aff_case(seed, cuda)
    U, E = at.t_req_aff.shape
    N = at.node_dom.shape[0]
    g = torch.Generator().manual_seed(seed)
    rows = torch.randperm(U, generator=g)[:U - 3].to(torch.int32).to(cuda)
    cand = {"all": None,
            "shared": torch.randperm(N, generator=g)[:77],
            "rows": torch.randint(0, N, (U, 33), generator=g)}[mode]
    if cand is not None:
        cand = cand.to(torch.int32).to(cuda)
    terms_all = torch.arange(E, dtype=torch.int32, device=cuda)[None]
    # Per-row lists: each row's nonzero columns, -1 padded.
    iom = (at.t_req_aff | at.t_req_anti | at.t_matches
           | (at.t_soft != 0))[rows.long()].cpu().numpy()
    lists = np.full((len(iom), E), -1, np.int32)
    for i, row in enumerate(iom):
        nz = np.flatnonzero(row)
        lists[i, :len(nz)] = nz
    for terms in (terms_all, torch.from_numpy(lists).to(cuda)):
        got = affkernels.aff_live(rows, cand, terms, at)
        want = affkernels.aff_live(rows, cand, terms, at, plain=True)
        _equal(got[0], want[0], "ok")
        _equal(got[1], want[1], "soft")
    a = affkernels.aff_live(rows, cand, terms_all, at)
    b = affkernels.aff_live(rows, cand, torch.from_numpy(lists).to(cuda), at)
    _equal(a[0], b[0], "ok: own terms vs all")
    _equal(a[1], b[1], "soft: own terms vs all")


@pytest.mark.parametrize("D", [10016, 9001])
@pytest.mark.parametrize("mode", ["rows", "all"])
def test_aff_live_gate_equals_plain(cuda, D, mode):
    """aff_live with the attempt cache's gate, over a window whose rows
    span several totals blocks (D > 4,096; 9,001 takes the unaligned,
    scalar loads), with pipelined counts: a clear gate leaves the buffers
    and the computing tally untouched (the launch still counts); a set
    gate writes what the plain version writes; without a gate the planes
    are the same.  Some terms have no match anywhere (the self-match
    rule)."""
    from volcano_tpu_torch.ops import affkernels

    at = _aff_case(5, cuda, U=24, E=12, D=D, N=300, cnt_density=0.002)
    at = at._replace(cnt_p=at.cnt_p * (at.cnt_a.sum(dim=1, keepdim=True)
                                       > 0))
    U, E = at.t_req_aff.shape
    N = at.node_dom.shape[0]
    assert bool(((at.cnt_a + at.cnt_p).sum(dim=1) == 0).any())
    g = torch.Generator().manual_seed(D)
    rows = torch.arange(U, dtype=torch.int32, device=cuda)
    cand = None if mode == "all" else torch.randint(
        0, N, (U, 500), generator=g).to(torch.int32).to(cuda)
    L = N if cand is None else 500
    terms = torch.arange(E, dtype=torch.int32, device=cuda)[None]
    prior = (torch.rand((U, L), generator=g) < 0.5,
             torch.randint(-3, 4, (U, L), generator=g).to(torch.float32))
    want = affkernels.aff_live(rows, cand, terms, at, plain=True)
    kernels.reset_launches()
    for gate in (False, True):
        buf = tuple(x.clone().to(cuda) for x in prior)
        ref = tuple(x.clone().to(cuda) for x in prior)
        gt = torch.tensor([gate], device=cuda)
        got = affkernels.aff_live(rows, cand, terms, at, gate=gt, out=buf)
        affkernels.aff_live(rows, cand, terms, at, gate=gt, out=ref,
                            plain=True)
        assert got[0] is buf[0] and got[1] is buf[1]
        _equal(buf[0], ref[0], "ok")
        _equal(buf[1], ref[1], "soft")
        if gate:
            _equal(buf[0], want[0], "ok vs fresh")
            _equal(buf[1], want[1], "soft vs fresh")
        else:
            _equal(buf[0], prior[0].to(cuda), "ok untouched")
            _equal(buf[1], prior[1].to(cuda), "soft untouched")
    assert kernels.LAUNCHES["aff_live"] == 2
    # The plain version's computing call counts too.
    assert kernels.read_tally("aff_live") == 2
    plain = affkernels.aff_live(rows, cand, terms, at)
    _equal(plain[0], want[0], "ok without a gate")
    _equal(plain[1], want[1], "soft without a gate")
    assert bool(~want[0].all()) and bool((want[1] != 0).any())


AFF_FILTER_CASES = [(64, 200, 12, "mixed"), (512, 48, 12, "mixed"),
                     (2048, 300, 12, "mixed"), (2048, 300, 12, "sparse"),
                     (2048, 300, 12, "dense"), (2048, 300, 12, "domainless"),
                     (2048, 300, 12, "selfmatch"), (2048, 300, 37, "mixed"),
                     (1999, 300, 12, "mixed")]


@pytest.mark.parametrize("W,nodes,E,kind", AFF_FILTER_CASES)
def test_aff_filter_equals_plain(cuda, W, nodes, E, kind):
    """The filter on random choices against its plain version: W = 512 on
    48 nodes gives more than 256 live givers in one sub-round (the JAX
    GCAP overflow form); sparse (a few accepted tasks) and dense (every
    live task accepted or pipelined) involved sets; domain-less choices
    (node_dom -1 on half the nodes); self-match rows (all-zero count
    rows: totals 0); E = 37 (not a multiple of 32); W = 1,999 (not a power
    of two).  gm must be left at W."""
    from volcano_tpu_torch.ops import affkernels

    seed = W if (E, kind) == (12, "mixed") else W + E + len(kind)
    at = _aff_case(seed, cuda, U=16, E=E, N=nodes)
    U = at.t_req_aff.shape[0]
    if kind == "domainless":
        nd = at.node_dom.clone()
        nd[::2] = -1
        at = at._replace(node_dom=nd)
    if kind == "selfmatch":
        at = at._replace(cnt_a=torch.zeros_like(at.cnt_a),
                         cnt_p=torch.zeros_like(at.cnt_p))
    g = torch.Generator().manual_seed(seed)
    choice = torch.randint(0, nodes, (W,), generator=g).to(torch.int32)
    live = torch.rand(W, generator=g) < 0.8
    pid_l = torch.randint(0, U, (W,), generator=g).to(torch.int32)
    p_acc = {"sparse": 0.02, "dense": 1.0}.get(kind, 0.7)
    acc = live & (torch.rand(W, generator=g) < p_acc)
    pipe = live & ~acc & (torch.rand(W, generator=g) < 0.5)
    choice, live, pid_l, acc, pipe = (x.to(cuda) for x in (
        choice, live, pid_l, acc, pipe))
    givers = (at.t_matches[pid_l.long()].any(dim=1) & live).sum()
    if W == 512:
        assert int(givers) > 256
    term_req = (at.t_req_aff | at.t_req_anti).any(dim=0)
    prof_req = (at.t_req_aff | at.t_req_anti).any(dim=1)
    gm = torch.full(tuple(at.cnt_a.shape), W, dtype=torch.int32,
                    device=cuda)
    before = kernels.LAUNCHES["aff_filter"]
    a_k, p_k = acc.clone(), pipe.clone()
    affkernels.aff_filter(choice, live, pid_l, at, a_k, p_k, gm=gm,
                          term_req=term_req, prof_req=prof_req)
    assert kernels.LAUNCHES["aff_filter"] == before + 1
    a_p, p_p = acc.clone(), pipe.clone()
    affkernels.aff_filter(choice, live, pid_l, at, a_p, p_p, gm=gm,
                          plain=True)
    _equal(a_k, a_p, "acc")
    _equal(p_k, p_p, "pipe")
    assert bool((gm == W).all()), "the kernel must leave gm at W"
    if kind != "sparse":
        assert bool((a_k != acc).any()), "the case filters nothing"
    # Without pipe, acc alone.
    a_k, a_p = acc.clone(), acc.clone()
    affkernels.aff_filter(choice, live, pid_l, at, a_k, gm=gm,
                          term_req=term_req, prof_req=prof_req)
    affkernels.aff_filter(choice, live, pid_l, at, a_p, gm=gm, plain=True)
    _equal(a_k, a_p, "acc without pipe")
    assert bool((gm == W).all())


# ------------------------------------------------------------ walk_accept

WALK_KINDS = ("one_group", "hot_nodes", "ties", "bytes", "ports",
              "self_anti", "future", "sparse", "odd_w")


def _walk_case(kind, UM, dev, W=2048, K=256, N=4096, R=4, seed=0):
    """walk_accept's inputs at the north-star wave shape: base capacities
    whole CPUs (milli) and GiB, a GPU-like scalar slot, pod slots with
    some nodes over their max (a row that is not sorted), contention
    groups at random; ``kind`` adds one hard case."""
    rng = np.random.RandomState(seed + UM)
    if kind == "odd_w":
        W = 1999
    gib = float(2 ** 30)
    idle = np.stack([rng.randint(0, 64, N) * 1000.0,
                     rng.randint(0, 256, N) * gib,
                     rng.randint(0, 4, N).astype(np.float64),
                     rng.randint(0, 100, N) * gib], 1)
    ntasks = rng.randint(0, 30, N)
    max_tasks = np.where(rng.rand(N) < 0.2, 0, rng.randint(20, 110, N))
    max_tasks[:16] = 5  # ntasks > max_tasks: negative pod capacities
    ranked = np.stack([rng.choice(N, K, replace=False) for _ in range(UM)])
    feas = rng.rand(UM, K) < 0.9
    req = np.stack([rng.randint(1, 4, UM) * 1000.0,
                    rng.randint(1, 8, UM) * gib,
                    (rng.rand(UM) < 0.3).astype(np.float64),
                    np.zeros(UM)], 1)
    init = req.copy()
    init[::3, 0] += 1000.0
    pid = rng.randint(0, UM, W)
    cand = rng.rand(W) < 0.9
    anyf = rng.rand(W) < 0.97
    grp = (rng.rand(UM, UM) < 0.5) | np.eye(UM, dtype=bool)
    eps = np.array([1.0, 1.0, 0.5, 1.0])
    slot = np.array([False, False, True, False])
    ports = fut = self_anti = None
    if kind == "one_group":
        grp[:] = True
    elif kind == "hot_nodes":
        hot = rng.choice(N, 3, replace=False)
        cold = np.setdiff1d(np.arange(N), hot)
        ranked = np.stack([np.concatenate(
            [hot, rng.choice(cold, K - 3, replace=False)])
            for _ in range(UM)])
        feas[:, :3] = True
        idle[hot] = [1.0e6, 1.0e4 * gib, 1.0e3, 1.0e4 * gib]
        max_tasks[hot] = 0
        grp[:] = True
    elif kind == "ties":
        # One or two copies a node: cumcap takes every integer, and each
        # group rank m meets it.
        max_tasks[:] = ntasks + rng.randint(1, 3, N)
        idle[:, :2] *= 8
    elif kind == "bytes":
        req[:, 1] = rng.randint(100, 1000, UM) * 1.0e9
        init[:, 1] = req[:, 1]
        idle[:, 1] = rng.randint(1000, 4000, N) * 1.0e9
    elif kind == "ports":
        pw = 2
        pp = np.zeros((UM, pw), np.int64)
        for u in range(UM):
            for b in rng.choice(40, rng.randint(1, 3), replace=False):
                pp[u, b // 32] |= 1 << (b % 32)
        used = np.where(rng.rand(N, pw) < 0.05,
                        1 << rng.randint(0, 32, (N, pw)), 0)
        ports = (pp, used, None)
        grp[:] = True
    elif kind == "self_anti":
        self_anti = rng.rand(UM) < 0.5
    elif kind == "future":
        rel = np.stack([rng.randint(0, 16, N) * 1000.0,
                        rng.randint(0, 64, N) * gib,
                        rng.randint(0, 2, N).astype(np.float64),
                        np.zeros(N)], 1)
        pip = rel * (rng.rand(N, 1) < 0.3) * 0.5
        pxe = np.where(rng.rand(N, 1) < 0.1, req[0] , 0.0)
        idle[::2] = 0.0
        fut = (rel, pip, pxe, rng.randint(0, 3, N))
        pw = 1
        pp = np.where(rng.rand(UM, pw) < 0.3, 1 << 3, 0)
        ports = (pp, np.zeros((N, pw), np.int64),
                 np.where(rng.rand(N, pw) < 0.1, 1 << 3, 0))
    elif kind == "sparse":
        cand = rng.rand(W) < 0.03

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    args = (t(ranked, i32), t(feas, b8), t(req, f32), t(init, f32),
            t(pid, i32), t(cand, b8), t(anyf, b8), t(grp, b8), t(idle, f32),
            t(ntasks, i32), t(max_tasks, i32), t(eps, f32), t(slot, b8))
    kw = {}
    if fut is not None:
        kw["future"] = kernels.Future(t(fut[0], f32), t(fut[1], f32),
                                      t(fut[2], f32), t(fut[3], i32))
    if ports is not None:
        kw["ports"] = kernels.Ports(
            t(ports[0].astype(np.uint32).view(np.int32), i32),
            t(ports[1].astype(np.uint32).view(np.int32), i32),
            None if ports[2] is None else
            t(ports[2].astype(np.uint32).view(np.int32), i32))
    if self_anti is not None:
        kw["self_anti"] = t(self_anti, b8)
    return args, kw


def _walk_both(args, kw):
    W = args[4].shape[0]
    dev = args[0].device
    outs = []
    for plain in (False, True):
        live = torch.empty(W, dtype=torch.bool, device=dev)
        out = kernels.walk_accept(*args, **kw, live_out=live, plain=plain)
        outs.append([x for x in out if x is not None] + [live])
    for a, b, what in zip(*outs, ("choice", "acc", "pipe", "live")):
        _equal(a, b, what)
    return outs[0]


@pytest.mark.parametrize("kind", WALK_KINDS)
@pytest.mark.parametrize("UM", [1, 16, 64])
def test_walk_accept_equals_plain(cuda, UM, kind):
    """walk_accept at W = 2,048 (1,999 for odd_w) and K = 256 against its
    plain version: choice, acc_alloc, acc_pipe and the live flags
    identical.  Cases: every profile in one contention group; every task
    ranked onto the same 3 hot nodes (segments of hundreds); capacity ties
    cumcap == m; byte-scale requests (1e11-1e12, the double sums);
    clashing host ports; self anti-affine profiles; the releasing planes
    (rel / pip / pxe, pipelined ports); a sparse cand_s; W not a power of
    two."""
    args, kw = _walk_case(kind, UM, cuda)
    before = kernels.LAUNCHES["walk_accept"]
    choice, acc, *rest = _walk_both(args, kw)
    assert kernels.LAUNCHES["walk_accept"] == before + 1
    live = rest[-1]
    assert bool(live.any()) and bool(acc.any())
    if kind in ("hot_nodes", "ports") and UM > 1:
        assert bool((live & ~acc).any()), "nothing rejected"
    if kind == "future":
        assert bool(rest[0].any()), "nothing pipelined"


@pytest.mark.parametrize("K,W,N", [(12289, 512, 16384), (256, 20000, 4096)])
def test_walk_accept_global_scratch_equals_plain(cuda, K, W, N):
    """Past the kernels' shared-memory limits -- a [UM, K] capacity row
    over 48 KB, sort keys over 200 KB -- the same kernels run on global
    scratch."""
    args, kw = _walk_case("ties", 16, cuda, W=W, K=K, N=N)
    _walk_both(args, kw)


# ------------------------------------------------------ rank_candidates

RANK_KINDS = ("mixed", "ties", "neg", "planes", "future")


def _rank_case(kind, L, K, dev, N=None, M=12, UM=16, seed=0):
    """rank_candidates' inputs: UM profile rows of ``shortlist_case``
    profiles, M of them ranked (the first all-infeasible: static verdicts
    all false), on [UM, L] ascending candidate lists or, with ``L`` None,
    all N nodes.  ``kind``: "mixed"; "ties" (identical nodes, one class,
    integer static scores: long runs of equal scores); "neg" (nine nodes
    in ten without room); "planes" (a node bias, host ports, affinity
    planes and custom-plugin planes, all with integer values); "future"
    (releasing capacity with pipelined charges)."""
    from test_torch_fixtures import shortlist_case

    base = "mixed" if kind in ("planes", "future") else kind
    N = N or max(2 * (L or 0), 4096)
    c = shortlist_case(seed + L if L else seed, U=UM, N=N, kind=base)
    rng = np.random.RandomState(seed + N)
    C = c["cls_ready"].shape[0]
    ok_w = rng.rand(UM, C) < 0.8
    score_w = rng.randint(0, 3, (UM, C)).astype(np.float32)
    rows = rng.permutation(UM)[:M].astype(np.int32)
    ok_w[rows[0]] = False
    cand = None
    if L is not None:
        cand = np.stack([np.sort(rng.choice(N, L, replace=False))
                         for _ in range(UM)]).astype(np.int32)
    Lr = N if L is None else L
    gib = float(2 ** 30)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    bw, lw, mw, balw, naff = c["weights"]
    from volcano_tpu_torch.ops.scoring import ScoreWeights
    w = ScoreWeights(binpack_weight=bw, binpack_res=t(c["binpack_res"], f32),
                     least_req_weight=lw, most_req_weight=mw,
                     balanced_weight=balw, node_affinity_weight=naff)
    args = (t(rows, i32), None if cand is None else t(cand, i32),
            t(ok_w, b8), t(score_w, f32), t(c["cls_id"], i32),
            t(c["req"][:UM], f32), t(c["init_req"][:UM], f32),
            t(c["idle"], f32), t(c["alloc"], f32), t(c["ntasks"], i32),
            t(c["max_tasks"], i32), t(c["eps"], f32),
            t(c["scalar_slot"], b8), w, K)
    kw = {}
    if kind == "planes":
        kw["bias"] = t(rng.randint(-1, 2, N), f32)
        pp = np.where(rng.rand(UM, 1) < 0.5, 1 << 3, 0)
        kw["ports"] = kernels.Ports(
            t(pp, i32), t(np.where(rng.rand(N, 1) < 0.2, 1 << 3, 0), i32),
            t(np.where(rng.rand(N, 1) < 0.1, 1 << 3, 0), i32))
        kw["aff"] = (t(rng.rand(M, Lr) < 0.9, b8),
                     t(rng.choice([0.0, 5.0, -10.0], (M, Lr)), f32))
        U_all = 2 * UM
        kw["extra"] = kernels.Extra(t(rng.rand(U_all, N) < 0.8, b8),
                                    t(rng.randint(-2, 3, (U_all, N)), f32))
        kw["pids"] = t(rng.permutation(U_all)[:UM], i32)
    elif kind == "future":
        rel = np.stack([rng.randint(0, 16, N) * 1000.0,
                        rng.randint(0, 64, N) * gib,
                        rng.randint(0, 2, N).astype(np.float64)], 1)
        pip = rel * (rng.rand(N, 1) < 0.3) * 0.5
        pxe = np.where(rng.rand(N, 1) < 0.1, c["req"][0], 0.0)
        kw["future"] = kernels.Future(t(rel, f32), t(pip, f32), t(pxe, f32),
                                      t(rng.randint(0, 3, N), i32))
    return args, kw


def _rank_both(args, kw):
    got = kernels.rank_candidates(*args, **kw)
    want = kernels.rank_candidates(*args, **kw, plain=True)
    for a, b, what in zip(got, want, ("ranked", "feas_k", "p_any")):
        _equal(a, b, what)
    return got


RANK_SHAPES = [(300, 300), (500, 256), (2048, 256), (2049, 256),
               (3073, 256), (5000, 1500), (None, 256)]


@pytest.mark.parametrize("kind", RANK_KINDS)
@pytest.mark.parametrize("L,K", RANK_SHAPES)
def test_rank_candidates_equals_plain(cuda, kind, L, K):
    """rank_candidates against its plain version: K = L (300); the
    shortlist width (500); the one-block sort's limit (2,048) and one past
    it (tiles and a merge); a last tile of one candidate (3,073); K over
    the tile width (1,500 of 5,000: each tile keeps all of its keys); all N
    nodes (10,016).  Row 0 is all-infeasible: p_any false, its K outputs
    in position order."""
    N = 10016 if L is None else None
    args, kw = _rank_case(kind, L, K, cuda, N=N)
    before = kernels.LAUNCHES["rank_candidates"]
    ranked, feas_k, p_any = _rank_both(args, kw)
    assert kernels.LAUNCHES["rank_candidates"] == before + 1
    assert not bool(p_any[0]) and not bool(feas_k[0].any())
    assert bool(p_any.any())
    pos = ranked[0].long() if L is None else torch.searchsorted(
        args[1][args[0][0].long()], ranked[0].contiguous()).long()
    assert torch.equal(pos, torch.arange(K, device=cuda))


@pytest.mark.parametrize("N", [100000, 120000])
def test_rank_candidates_merge_past_shared_memory(cuda, N):
    """All N nodes against the merge's shared memory (224 KB): at 100,000
    nodes the 98 tiles' top keys (196 KB) fit it; at 120,000 the 118
    tiles' (236 KB) do not, and the merge reads them from the global
    scratch."""
    for kind in ("mixed", "ties", "planes"):
        args, kw = _rank_case(kind, None, 256, cuda, N=N, M=4)
        _rank_both(args, kw)


def _aff_store_case(name):
    from test_torch_fixtures import affinity_store

    if name == "small":
        return affinity_store(volcano_tpu_torch, seed=1), 16
    if name == "dense":
        return affinity_store(volcano_tpu_torch, n_nodes=16, n_gangs=40,
                              gang_size=6, seed=2), 64
    if name == "givers":
        # One 512-task wave of self zone-affine gangs: > 256 givers.
        return affinity_store(volcano_tpu_torch, n_nodes=64, n_gangs=8,
                              gang_size=64, mix=("aff",), seed=3,
                              node_cpu="32"), 512
    return synthetic_cluster(n_nodes=256, n_pods=2048, gang_size=8,
                             zones=16, affinity_fraction=0.05,
                             anti_affinity_fraction=0.05,
                             spread_fraction=0.1, seed=0), 256


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("name", ["small", "dense", "givers", "config5"])
def test_affinity_solve_equals_plain_and_cpu(cuda, monkeypatch, name,
                                             sparse):
    """Host ports and inter-pod terms through the whole solve: the kernels
    (extended rank / walk / apply, aff_live, aff_filter, and with both
    sparse thresholds at 0 the two table scatters) equal the plain
    versions on the card and the CPU run."""
    import volcano_tpu_torch.ops.wave as tw

    if sparse:
        monkeypatch.setattr(tw, "CNT0_SPARSE_MIN", 0)
        monkeypatch.setattr(tw, "PROF_SPARSE_MIN", 0)
    store, wave = _aff_store_case(name)
    k, p, c, launched = _solve_three_ways(store, wave)
    _same(k, p)
    _same(k, c)
    for kn in ("aff_live", "aff_filter", "rank_candidates", "walk_accept",
               "apply_commit"):
        assert launched[kn] > 0, (kn, launched)
    if sparse:
        assert launched["scatter_cnt0"] == 1
        assert launched["scatter_profile_tables"] == 1
    assert int((k.assigned >= 0).sum()) > 0


def test_affinity_future_ports_equal_plain_and_cpu(cuda):
    """Releasing capacity with host ports and terms: pipelined tasks
    charge pip_nport and cw_p; the card equals the plain versions and the
    CPU."""
    from test_torch_fixtures import affinity_store

    store = affinity_store(volcano_tpu_torch, n_nodes=16, n_gangs=30,
                           gang_size=4, seed=5)
    from volcano_tpu_torch.device import tree_to

    args, _ = solve_args_from_store(store, binpack=True, nodeorder=True,
                                    device="cpu")
    n = args[0]
    idle = n.idle.clone()
    rel = torch.zeros_like(idle)
    rel[::2] = idle[::2]
    idle[::2] = 0.0
    args = (n._replace(idle=idle, releasing=rel),) + tuple(args[1:])
    out = []
    for dev, plain in (("cuda", False), ("cuda", True), ("cpu", False)):
        a = tuple(tree_to(x, torch.device(dev)) for x in args)
        out.append(interop.result_to_numpy(
            solve_wave(*a, wave=32, device=dev, plain=plain)))
    _same(out[0], out[1])
    _same(out[0], out[2])
    assert int((out[0].pipelined >= 0).sum()) > 0


# ------------------------------------------------------------- seq_solve

def _seq_cases():
    from test_torch_fixtures import SEQ_CASES

    return ([(n, 0) for n in SEQ_CASES] + [("affinity", s) for s in range(3)]
            + [("random", s) for s in range(4)])


def _seq_three_ways(store, extra_seed=None):
    """``ops.allocate.solve`` as the kernel, as the plain version on the
    card and on the CPU; the kernel's launch count."""
    from test_torch_fixtures import seq_extra
    from volcano_tpu_torch.ops.allocate import LAST_SEQ, solve

    a_gpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True)
    a_cpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True,
                                     device="cpu")
    kw = {}
    if extra_seed is not None:
        ok, score = seq_extra(a_cpu, extra_seed)
        kw = dict(extra_ok=ok, extra_score=score)
    kernels.reset_launches()
    k = interop.result_to_numpy(solve(*a_gpu, **kw))
    launched = kernels.LAUNCHES["seq_solve"]
    k_cnt = LAST_SEQ["alloc_cnt"].cpu()
    p = interop.result_to_numpy(solve(*a_gpu, plain=True, **kw))
    # The per-job allocation counts (a work count's input) agree too.
    assert torch.equal(k_cnt, LAST_SEQ["alloc_cnt"].cpu())
    c = interop.result_to_numpy(solve(*a_cpu, device="cpu", **kw))
    return k, p, c, launched


def _same_bits(a, b):
    for f in ("assigned", "pipelined", "never_ready", "fit_failed", "idle",
              "q_alloc"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        if x.dtype == np.float32:
            x, y = x.view(np.uint32), y.view(np.uint32)
        assert np.array_equal(x, y), f


@pytest.mark.parametrize("name,seed", _seq_cases())
def test_seq_solve_kernel_equals_plain_and_cpu(cuda, name, seed):
    """seq_solve on the card equals its plain version on the card and on
    the CPU bit for bit: one launch per solve."""
    from test_torch_fixtures import seq_store

    k, p, c, launched = _seq_three_ways(seq_store(volcano_tpu_torch, name,
                                                  seed))
    _same_bits(k, p)
    _same_bits(k, c)
    assert launched == 1


@pytest.mark.parametrize("seed", range(3))
def test_seq_solve_with_extra_planes_equals_plain(cuda, seed):
    from test_torch_fixtures import seq_store

    k, p, c, launched = _seq_three_ways(
        seq_store(volcano_tpu_torch, "random", seed), extra_seed=seed)
    _same_bits(k, p)
    _same_bits(k, c)
    assert launched == 1


def test_seq_solve_synthetic_cluster_equals_plain(cuda):
    """A gang cluster at a few thousand tasks (many nodes a thread)."""
    k, p, c, launched = _seq_three_ways(synthetic_cluster(
        n_nodes=1500, n_pods=3000, gang_size=4, n_queues=2, zones=4,
        seed=3))
    _same_bits(k, p)
    _same_bits(k, c)
    assert int((k.assigned >= 0).sum()) > 0


def _kernel_profiles():
    """The last card solve's row profiles, followers resolved."""
    from volcano_tpu_torch.ops.allocate import LAST_SEQ

    pidh = LAST_SEQ["pidh"].cpu().numpy()
    out = pidh.copy()
    for t in range(len(out)):
        if pidh[t] == -2:
            out[t] = out[t - 1]
    return out


def _seq_cpu_inputs(store):
    from volcano_tpu_torch.ops.allocate import seq_inputs

    a_cpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True,
                                     device="cpu")
    return seq_inputs(*a_cpu[:8], None, None, torch.device("cpu"))


@pytest.mark.parametrize("name", ["profile runs", "alternating profiles",
                                  "terms between runs", "many profiles",
                                  "scalar resources",
                                  "many scalar resources"])
def test_seq_solve_equal_row_runs_equal_plain_and_cpu(cuda, name):
    """Runs of equal rows across jobs (a gang rolled back mid-run and its
    nodes taken by the next equal job), alternating profiles, term rows
    between two runs of one profile, more distinct profiles than the cap,
    3 and 6 resource slots (the kernel's register path and its general
    one): the kernel equals the plain version and the CPU bit for bit, one
    launch, and its profiles equal ``kernels.seq_profiles``."""
    from test_torch_fixtures import seq_store

    store = seq_store(volcano_tpu_torch, name)
    k, p, c, launched = _seq_three_ways(store)
    _same_bits(k, p)
    _same_bits(k, c)
    assert launched == 1
    x = _seq_cpu_inputs(store)
    want = kernels.seq_profiles(x).numpy()
    assert np.array_equal(_kernel_profiles(), want)
    if name == "many profiles":
        assert want.max() == kernels.SEQ_MAX_PROFILES - 1 and (
            want[x.real.numpy()] < 0).any()


@pytest.mark.parametrize("plane", ["req", "init_req", "sel_bits",
                                   "aff_bits", "aff_terms", "tol_bits",
                                   "pref_bits", "pref_w", "ports",
                                   "extra_ok", "extra_score"])
def test_seq_solve_one_plane_variant_equals_plain(cuda, plane):
    """Equal custom-plugin rows and a row of a run changed in one plane the
    node loop reads: the kernel gives it a profile of its own (its row pass
    reads that plane), as the numpy reference of the test fixtures does,
    and equals the plain version and the CPU bit for bit."""
    from test_torch_fixtures import (seq_plane_variant,
                                     seq_profile_reference, seq_store)

    store = seq_store(volcano_tpu_torch, "profile runs")
    a_cpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True,
                                     device="cpu")
    x, t = seq_plane_variant(_seq_cpu_inputs(store), plane)
    xg = type(x)(*[v.cuda() if torch.is_tensor(v) else v for v in x])
    w = a_cpu[4]
    kernels.reset_launches()
    k = interop.result_to_numpy(kernels.seq_solve(xg, w))
    assert kernels.LAUNCHES["seq_solve"] == 1
    got = _kernel_profiles()
    p = interop.result_to_numpy(kernels.seq_solve(xg, w, plain=True))
    c = interop.result_to_numpy(kernels.seq_solve(x, w))
    _same_bits(k, p)
    _same_bits(k, c)
    assert np.array_equal(
        got, seq_profile_reference(x, kernels.SEQ_MAX_PROFILES))
    assert got[t] >= 0 and got[t] != got[t - 1]


@pytest.mark.parametrize("n_nodes,n_pods,cpu", [(4500, 8000, "4"),
                                                (9000, 3000, "64")])
def test_seq_solve_past_4096_nodes_equals_plain(cuda, n_nodes, n_pods, cpu):
    """Several super-chunks of 1,024 nodes: a cluster filled past its
    capacity (gangs rolled back and failing) and a roomy one."""
    store = synthetic_cluster(n_nodes=n_nodes, n_pods=n_pods, gang_size=8,
                              n_queues=2, node_cpu=cpu, zones=4, seed=5)
    k, p, c, launched = _seq_three_ways(store)
    _same_bits(k, p)
    _same_bits(k, c)
    assert launched == 1
    assert np.array_equal(_kernel_profiles(),
                          kernels.seq_profiles(_seq_cpu_inputs(store))
                          .numpy())
    if cpu == "4":
        assert k.never_ready.any() or k.fit_failed.any()


# ----------------------------------------- extra planes in the rankings

def _extra_planes(U, N, dev, seed, veto=0.3):
    g = torch.Generator().manual_seed(seed)
    ok = torch.rand((U, N), generator=g) >= veto
    score = torch.randint(-2, 3, (U, N), generator=g).to(torch.float32)
    return kernels.Extra(ok.to(dev), score.to(dev))


@pytest.mark.parametrize("kind", ["mixed", "ties"])
def test_coarse_and_rank_with_extra_planes_equal_plain(cuda, kind):
    """coarse_shortlist and rank_candidates with custom-plugin planes (ties
    from integer scores, vetoes) equal their plain versions; all-feasible
    verdicts without scores give the results without planes."""
    from test_torch_fixtures import shortlist_case, shortlist_tensors

    U, N, S = 64, 4096, 205
    case = shortlist_case(11, U=U, N=N, kind=kind)
    prof, cls, nd, w, eps, slot = shortlist_tensors(case, cuda)
    args = (nd["idle"], nd["alloc"], nd["ntasks"], nd["max_tasks"], eps,
            slot, w)
    ex = _extra_planes(U, N, cuda, 3)
    kernels.reset_launches()
    out = kernels.coarse_shortlist(prof, cls, *args, S, True, extra=ex)
    ref = kernels.coarse_shortlist(prof, cls, *args, S, True, extra=ex,
                                   plain=True)
    for a, b, what in zip(out, ref, ("sl", "ok", "sc")):
        _equal(a, b, what)
    base = kernels.coarse_shortlist(prof, cls, *args, S, True)
    same = kernels.coarse_shortlist(
        prof, cls, *args, S, True,
        extra=kernels.Extra(torch.ones_like(ex.ok), None))
    _equal(base[0], same[0], "all-feasible planes changed the shortlist")
    assert not torch.equal(out[0], base[0])
    # A wave of UM rows of profiles pids, on the shortlists and on all N.
    UM, K = 16, 32
    pids = torch.arange(0, 2 * UM, 2, dtype=torch.int32, device=cuda)
    pl = pids.long()
    ok_w, sc_w = out[1][pl].contiguous(), out[2][pl].contiguous()
    rows = torch.arange(UM, dtype=torch.int32, device=cuda)
    bias = torch.linspace(-1.0, 1.0, N, device=cuda)
    for cand in (out[0][pl].contiguous(), None):
        for b in (None, bias):
            r = kernels.rank_candidates(
                rows, cand, ok_w, sc_w, cls.class_id,
                prof.req[pl].contiguous(), prof.init_req[pl].contiguous(),
                *args[:6], w, K, bias=b, extra=ex, pids=pids)
            rp = kernels.rank_candidates(
                rows, cand, ok_w, sc_w, cls.class_id,
                prof.req[pl].contiguous(), prof.init_req[pl].contiguous(),
                *args[:6], w, K, bias=b, extra=ex, pids=pids, plain=True)
            for a, bb, what in zip(r, rp, ("ranked", "feas", "any")):
                _equal(a, bb, what)
    assert kernels.LAUNCHES["rank_candidates"] == 4


def test_card_solve_with_extra_planes_equals_plain_and_cpu(cuda):
    from test_torch_fixtures import seq_extra

    store = synthetic_cluster(n_nodes=96, n_pods=700, gang_size=4,
                              n_queues=2, zones=4, seed=5)
    a_gpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True)
    a_cpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True,
                                     device="cpu")
    ok, score = seq_extra(a_cpu, 4)
    kw = dict(extra_ok=ok, extra_score=score, wave=128)
    kernels.reset_launches()
    k = interop.result_to_numpy(solve_wave(*a_gpu, **kw))
    launched = dict(kernels.LAUNCHES)
    p = interop.result_to_numpy(solve_wave(*a_gpu, plain=True, **kw))
    c = interop.result_to_numpy(solve_wave(*a_cpu, device="cpu", **kw))
    _same(k, p)
    _same(k, c)
    assert launched["coarse_shortlist"] and launched["rank_candidates"]


# ------------------------------------- shortlist selection, apply_commit

def _shortlist_inputs(kind, U, N, dev, seed=5):
    """``shortlist_case`` on ``dev`` with ``kind`` "allneg" too (no node
    has room: every score NEG, the selection by node id alone)."""
    from test_torch_fixtures import shortlist_case, shortlist_tensors

    case = shortlist_case(seed, U=U, N=N,
                          kind="mixed" if kind == "allneg" else kind)
    if kind == "allneg":
        case["idle"][:] = 0.0
    prof, cls, nd, w, eps, slot = shortlist_tensors(case, dev)
    args = (nd["idle"], nd["alloc"], nd["ntasks"], nd["max_tasks"], eps,
            slot, w)
    return prof, cls, args


@pytest.mark.parametrize("kind", ["mixed", "ties", "allneg"])
@pytest.mark.parametrize("S", ["one", "mid", "all"])
@pytest.mark.parametrize("N", [10016, 60000])
def test_coarse_shortlist_full_row_equals_plain(cuda, N, S, kind):
    """The full-row coarse_shortlist (no blocks) against its plain version:
    a row's keys in shared memory (10,016 nodes) and past it (60,000
    nodes, over kernels.COARSE_SMEM: the global scratch); S = 1, a middle
    S and S = N; tie-heavy and all-NEG rows, where the select runs into
    the node-id bytes."""
    U = 8
    assert (4 * N > kernels.COARSE_SMEM) == (N == 60000)
    prof, cls, args = _shortlist_inputs(kind, U, N, cuda)
    k = {"one": 1, "mid": 837, "all": N}[S]
    kernels.reset_launches()
    got = kernels.coarse_shortlist(prof, cls, *args, k, True)
    want = kernels.coarse_shortlist(prof, cls, *args, k, True, plain=True)
    for a, b, what in zip(got, want, ("sl", "ok", "sc")):
        _equal(a, b, what)
    assert kernels.LAUNCHES["coarse_shortlist"] == 1
    if S == "all":
        full = torch.arange(N, dtype=torch.int32, device=cuda)
        assert torch.equal(got[0], full.expand(U, N))


@pytest.mark.parametrize("kind", ["mixed", "ties", "neg", "allneg"])
def test_block_shortlist_config5_rows_equal_plain(cuda, kind):
    """The block form at a config-5-like width (2,050 profile rows -- the
    last group of the ranking's four rows a block holds two -- 16,384
    nodes in B = 16 blocks, S = 819: the cold cycle's launch) and a warm
    pass with one dirty block, each against its plain version; the warm
    pass equals a full re-rank.  "ties" and "allneg" give blocks whose
    keys share one score (no sort)."""
    U, N, B, S = 2050, 16384, 16, 819
    prof, cls, args = _shortlist_inputs(kind, U, N, cuda, seed=9)
    stat = kernels.static_planes(prof, cls, 1.0, True)
    kernels.reset_launches()
    cold = kernels.coarse_shortlist(prof, cls, *args, S, True, stat=stat,
                                    n_blocks=B)
    cold_p = kernels.coarse_shortlist(prof, cls, *args, S, True, stat=stat,
                                      n_blocks=B, plain=True)
    for a, b, what in zip(cold, cold_p, ("sl", "ok", "sc", "cs", "ci")):
        _equal(a, b, what)
    nlb = N // B
    idle2 = args[0].clone()
    idle2[5 * nlb:5 * nlb + nlb // 3] *= 0.25
    args2 = (idle2,) + args[1:]
    db = torch.tensor([5], dtype=torch.int32, device=cuda)
    warm = kernels.warm_shortlist(prof, cls.class_id, *stat, *args2[:6],
                                  args[6], db, cold[3], cold[4], S)
    warm_p = kernels.warm_shortlist(prof, cls.class_id, *stat, *args2[:6],
                                    args[6], db, cold[3], cold[4], S,
                                    plain=True)
    for a, b, what in zip(warm, warm_p, ("sl", "cs", "ci")):
        _equal(a, b, what)
    full = kernels.coarse_shortlist(prof, cls, *args2, S, True, stat=stat,
                                    n_blocks=B, plain=True)
    for a, b, what in zip(warm, (full[0], full[3], full[4]),
                          ("sl", "cs", "ci")):
        _equal(a, b, f"warm != full re-rank: {what}")
    assert kernels.LAUNCHES["coarse_shortlist"] == 1
    assert kernels.LAUNCHES["warm_shortlist"] == 1


COMMIT_KINDS = ("mixed", "hot", "zone", "pipe", "discard", "empty",
                "many_queues", "blocks")


def _commit_case(kind, dev, N=4096, R=3, UM=16, T=2048, W=64, E=24, D=40,
                 seed=0):
    """apply_commit's inputs: T tasks of UM profile rows with integer
    requests (milli-CPU, bytes, devices) on N nodes and Q queues.
    ``kind``: "mixed" (random nodes, queues, jobs, 70% committed);
    "hot" (every task on node 7 and queue 0); "zone" (window counts with
    every node in one zone domain and every task on node 3, host ports);
    "pipe" (pipelined tasks beside the commits, with ports and counts on
    both planes); "discard" (mode 1: 40% of 20,000 tasks given back);
    "empty" (T = 0); "many_queues" (1,000 queues: 3,000 queue slots to
    write back); "blocks" (12,000 tasks on 50 nodes, pipelined ones, ports
    and counts too: dozens of blocks adding to and claiming the same
    rows)."""
    from volcano_tpu_torch.ops.affkernels import AffTerms

    rng = np.random.RandomState(seed + COMMIT_KINDS.index(kind))
    T = {"empty": 0, "discard": 20000, "blocks": 12000}.get(kind, T)
    Q = 1000 if kind == "many_queues" else 4
    gib = float(2 ** 30)
    rows = np.stack([rng.randint(1, 9, UM) * 250.0,
                     rng.randint(1, 17, UM) * gib / 4,
                     rng.randint(0, 2, UM).astype(np.float64)], 1)
    node = rng.randint(0, N, T)
    qidx = rng.randint(0, Q, T)
    if kind == "hot":
        node[:] = 7
        qidx[:] = 0
    if kind == "zone":
        node[:] = 3
    if kind == "blocks":
        node = rng.randint(0, 50, T)
    mask = rng.rand(T) < (0.4 if kind == "discard" else 0.7)
    idle = np.stack([rng.randint(0, 65, N) * 1000.0,
                     rng.randint(0, 257, N) * gib,
                     rng.randint(0, 3, N).astype(np.float64)], 1)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    args = (t(node, i32), t(mask, b8), t(rows, f32),
            t(rng.randint(0, UM, T), i32), t(qidx, i32), t(idle, f32),
            t(rng.randint(0, 50, (Q, R)) * 1000.0, f32))
    kw = {"mode": 0, "idle_sign": -1.0,
          "assigned": t(np.full(T, -1), i32)}
    if kind == "discard":
        kw.update(mode=1, idle_sign=1.0, assigned=t(
            np.where(mask, node, -1), i32))
        return args, kw
    kw.update(jw=t(rng.randint(0, W, T), i32),
              ntasks=t(rng.randint(0, 8, N), i32),
              alloc_l=t(rng.randint(0, 4, W), i32))
    if kind in ("zone", "pipe", "blocks"):
        PW = 2
        pp = rng.randint(0, 1 << 16, (UM, PW))
        kw["ports"] = kernels.Ports(t(pp, i32), t(np.zeros((N, PW)), i32),
                                    t(np.zeros((N, PW)), i32))
        dom = rng.randint(-1, D, (N, 2))
        if kind == "zone":
            dom[:, 0] = 0
        z = np.zeros((UM, E), bool)
        kw["counts"] = AffTerms(
            t(dom, i32), t(rng.randint(0, 2, E), i32),
            t(rng.randint(0, 3, (E, D)), i32),
            t(rng.randint(0, 3, (E, D)), i32), t(z, b8), t(z, b8),
            t(rng.rand(UM, E) < 0.4, b8), t(z, f32))
        kw["match_terms"] = kernels.window_match_terms(kw["counts"].t_matches)
    if kind in ("pipe", "blocks"):
        kw["pipe"] = t(~mask & (rng.rand(T) < 0.5), b8)
        kw["pip"] = {"pip_extra": t(np.zeros((N, R)), f32),
                     "pip_ntasks": t(np.zeros(N), i32),
                     "q_pip": t(np.zeros((Q, R)), f32),
                     "pipelined": t(np.full(T, -1), i32)}
    return args, kw


def _commit_state(args, kw):
    """The tensors apply_commit updates, for comparing the two runs."""
    out = list(args[5:7])
    for k in ("ntasks", "alloc_l", "assigned"):
        if kw.get(k) is not None:
            out.append(kw[k])
    if kw.get("pip") is not None:
        out.extend(v for k, v in kw["pip"].items() if k != "scratch")
    if kw.get("ports") is not None:
        out.extend(x for x in kw["ports"] if x is not None)
    if kw.get("counts") is not None:
        out.extend(x for x in kw["counts"][2:4] if x is not None)
    return out


def _clone_commit(args, kw):
    def c(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, dict):
            return {k: c(x) for k, x in v.items()}
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*[c(x) for x in v])
        return v
    return tuple(c(a) for a in args), {k: c(v) for k, v in kw.items()}


@pytest.mark.parametrize("kind", COMMIT_KINDS)
def test_apply_commit_equals_plain(cuda, kind):
    """apply_commit (one launch) against its plain version on one state,
    called twice in a row: every plane equal after each call, and the
    float64 accumulators zeroed again."""
    args, kw = _commit_case(kind, cuda)
    N, R = args[5].shape
    Q = args[6].shape[0]
    k_args, k_kw = _clone_commit(args, kw)
    p_args, p_kw = _clone_commit(args, kw)
    scratch = kernels.commit_scratch(N, R, Q, cuda)
    p_scratch = kernels.commit_scratch(N, R, Q, cuda)
    for a in (k_kw, p_kw):
        if a.get("pip") is not None:
            a["pip"]["scratch"] = kernels.commit_scratch(N, R, Q, cuda)
    kernels.reset_launches()
    for call in range(2):
        kernels.apply_commit(*k_args, scratch=scratch, **k_kw)
        kernels.apply_commit(*p_args, scratch=p_scratch, plain=True, **p_kw)
        for i, (a, b) in enumerate(zip(_commit_state(k_args, k_kw),
                                       _commit_state(p_args, p_kw))):
            _equal(a, b, f"call {call}: state {i}")
        left = list(scratch)
        if k_kw.get("pip") is not None:
            left += list(k_kw["pip"]["scratch"])
        assert all(not bool(x.any()) for x in left), f"call {call}: scratch"
    assert kernels.LAUNCHES["apply_commit"] == 2
    if kind != "empty":
        assert not torch.equal(k_args[5], args[5])


def _identity_case(cls, dev):
    """The same nodes with one class a node (the identity classes)."""
    from volcano_tpu_torch.ops.nodeclass import NodeClasses

    cid = cls.class_id.long()
    N = cid.shape[0]
    return NodeClasses(
        class_id=torch.arange(N, dtype=torch.int32, device=dev),
        label_bits=cls.label_bits[cid].contiguous(),
        taint_bits=cls.taint_bits[cid].contiguous(),
        ready=cls.ready[cid].contiguous())


@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("taints", [True, False])
@pytest.mark.parametrize("kind", ["mixed", "neg"])
@pytest.mark.parametrize("N,S", [(1024, 51), (16384, 819), (60000, 100)])
def test_in_launch_static_planes_equal_plain(cuda, identity, taints, kind,
                                             N, S):
    """The row-form coarse_shortlist computing the static planes in its
    own launch (each block writes its row's pairs and reads them back
    after a barrier; 60,000 nodes put the row's keys in the global
    scratch): the planes equal ``class_static_plain`` on the card, and the
    shortlist equals the two-launch form, ``static_planes`` then the
    launch reading them, and the plain version.  The call is one kernel
    launch and nothing else: one device operation fewer than the pair."""
    from test_torch_fixtures import shortlist_case, shortlist_tensors

    case = shortlist_case(11, U=64, N=N, C=40, kind=kind)
    prof, cls, nd, w, eps, slot = shortlist_tensors(case, cuda)
    if identity:
        cls = _identity_case(cls, cuda)
    args = (nd["idle"], nd["alloc"], nd["ntasks"], nd["max_tasks"], eps,
            slot, w, S, taints)
    kernels.reset_launches()
    fused = kernels.coarse_shortlist(prof, cls, *args)
    assert kernels.FUSED["static_planes"] == 1
    assert kernels.LAUNCHES["static_planes"] == 0
    want = kernels.static_planes(prof, cls, w.node_affinity_weight, taints,
                                 plain=True)
    stat = kernels.static_planes(prof, cls, w.node_affinity_weight, taints)
    _equal(stat[0], want[0], "static_planes ok")
    _equal(stat[1], want[1], "static_planes score")
    two = kernels.coarse_shortlist(prof, cls, *args, stat=stat)
    plain = kernels.coarse_shortlist(prof, cls, *args, plain=True)
    names = ("sl", "ok", "sc")
    _equal(fused[1], want[0], "in-launch ok")
    _equal(fused[2], want[1], "in-launch score")
    for a, b, c, what in zip(fused, two, plain, names):
        _equal(a, b, f"in-launch != two launches: {what}")
        _equal(a, c, f"in-launch != plain: {what}")
    ops_fused = _graph_ops(lambda: kernels.coarse_shortlist(prof, cls,
                                                            *args))
    ops_pair = _graph_ops(lambda: kernels.coarse_shortlist(
        prof, cls, *args, stat=kernels.static_planes(
            prof, cls, w.node_affinity_weight, taints)))
    assert ops_fused == {"kernel": 1}, ops_fused
    assert ops_pair == {"kernel": 2}, ops_pair


def _delta_planes(g, N, k):
    """Six resident planes of mixed widths (f32 [N, 3], int32 [N], bool
    [N], int32 bits [N, 2] and [N, 1], int32 [N]) and k rows' values."""
    def planes(n):
        return [torch.rand((n, 3), generator=g) * 64,
                torch.randint(0, 110, (n,), generator=g).to(torch.int32),
                torch.rand(n, generator=g) < 0.9,
                torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 2), generator=g,
                              dtype=torch.int64).to(torch.int32),
                torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 1), generator=g,
                              dtype=torch.int64).to(torch.int32),
                torch.randint(0, 9, (n,), generator=g).to(torch.int32)]
    return planes(N), planes(k)


@pytest.mark.parametrize("N,k", [(16384, 100), (16384, 1), (100352, 4096),
                                 (64, 64)])
def test_scatter_planes_equals_plain(cuda, N, k):
    """One node-table delta into six planes of mixed widths (words, and
    bytes for the bool plane) in one launch: equal to the plain version's
    plane-by-plane index writes and to ``scatter_rows`` per plane; rows
    outside the delta keep their bytes.  The staged call is one copy and
    one kernel."""
    g = torch.Generator().manual_seed(N + k)
    base, fresh = _delta_planes(g, N, k)
    rows = torch.randperm(N, generator=g)[:k].to(torch.int32)
    staged = kernels.stage_delta(rows.numpy(), [v.numpy() for v in fresh],
                                 cuda)
    got = [b.to(cuda) for b in base]
    want = [b.to(cuda) for b in base]
    one = [b.to(cuda) for b in base]
    kernels.reset_launches()
    kernels.scatter_planes(got, staged, k)
    assert kernels.LAUNCHES["scatter_rows"] == 1
    kernels.scatter_planes(want, staged, k, plain=True)
    for b, v in zip(one, fresh):
        kernels.scatter_rows(b, rows.to(cuda), v.to(cuda))
    for a, b, c in zip(got, want, one):
        _equal(a, b, "scatter_planes != plain")
        _equal(a, c, "scatter_planes != scatter_rows per plane")
    ops = _graph_ops(lambda: kernels.scatter_planes(
        got, kernels.stage_delta(rows.numpy(), [v.numpy() for v in fresh],
                                 cuda), k))
    assert ops == {"memcpy": 1, "kernel": 1}, ops


@pytest.mark.parametrize("budget_mb", ["256", "0.01"])
def test_device_snapshot_delta_one_launch_a_chunk(cuda, monkeypatch,
                                                  budget_mb):
    """DeviceSnapshot on the card: a delta of 1,000 rows across six planes
    is one copy and one ``scatter_planes`` launch a combined chunk (rows
    past the first chunk under a 0.01 MB budget; counted on a second card
    snapshot whose delta is captured into a CUDA graph, not run), and the
    resident planes equal the CPU snapshot's."""
    import numpy as np

    from volcano_tpu_torch.ops import devsnap

    monkeypatch.setenv("VOLCANO_TPU_DEVSNAP_BUDGET_MB", budget_mb)
    g = torch.Generator().manual_seed(5)
    N = 8192
    base, _ = _delta_planes(g, N, 1)
    truth = {f"p{i}": b.numpy().copy() for i, b in enumerate(base)}

    class Mirror:
        rows = np.zeros(0, np.int64)

        def node_delta_rows(self, since):
            return self.rows

        def reset_node_delta(self):
            self.rows = np.zeros(0, np.int64)

    snaps = {"card": devsnap.DeviceSnapshot(cuda),
             "cpu": devsnap.DeviceSnapshot(torch.device("cpu")),
             "counted": devsnap.DeviceSnapshot(cuda)}
    mirrors = {k: Mirror() for k in snaps}

    def build():
        return {n: (lambda r, a=a: a if r is None else a[r])
                for n, a in truth.items()}

    for k in snaps:
        snaps[k].node_planes(mirrors[k], (1, N), build())
    rows = np.sort(np.random.default_rng(3).permutation(N)[:1000])
    _, fresh = _delta_planes(g, N, 1000)
    for (n, a), v in zip(truth.items(), fresh):
        a[rows] = v.numpy()
    for k in snaps:
        mirrors[k].rows = rows
    kernels.reset_launches()
    snaps["card"].node_planes(mirrors["card"], (2, N), build())
    snaps["cpu"].node_planes(mirrors["cpu"], (2, N), build())
    chunks = snaps["card"].delta_launches
    assert chunks == (1 if budget_mb == "256" else -(-1000 // 256))
    assert kernels.LAUNCHES["scatter_rows"] == chunks
    ops = _graph_ops(lambda: snaps["counted"].node_planes(
        mirrors["counted"], (2, N), build()), warm=False)
    assert snaps["counted"].delta_launches == chunks
    assert ops == {"memcpy": chunks, "kernel": chunks}, ops
    for n in truth:
        assert torch.equal(snaps["card"]._planes[n].cpu(),
                           snaps["cpu"]._planes[n]), n


def test_cycle_static_planes_one_launch_a_miss(cuda):
    """On the card the device-incremental lane launches ``static_planes``
    once a static miss and never on a hit, through a cold cycle, steady
    cycles and a node update, and a node-table delta is one
    ``scatter_planes`` launch a chunk."""
    import dataclasses

    from test_torch_fixtures import repend_feed
    from volcano_tpu_torch.scheduler import Scheduler

    store = synthetic_cluster(n_nodes=256, n_pods=1024, gang_size=4,
                              seed=17)
    sched = Scheduler(store)
    kernels.reset_launches()
    sched.run_once()
    store.cycle_feed = repend_feed([0, 1])
    for _ in range(3):
        sched.run_once()
    m = store.mirror
    for row in range(0, 40, 4):
        old = m.node_objs[row]
        cpu = str(int(float(old.allocatable["cpu"]) * 1.5))
        store.update_node(dataclasses.replace(
            old, allocatable={**old.allocatable, "cpu": cpu},
            capacity={**old.capacity, "cpu": cpu}))
    sched.run_once()
    dv = store._devincr_cache
    assert dv.static_builds >= 1 and dv.static_hits >= 1
    assert dv.counts["full"] >= 2 and dv.counts["warm"] >= 1
    assert kernels.LAUNCHES["static_planes"] == dv.static_builds
    assert store.device_snapshot.delta_uploads >= 1
    assert kernels.LAUNCHES["scatter_rows"] == \
        store.device_snapshot.delta_launches


# ------------------------------------- single-phase solve and steering


def _steer_case(kind, cuda, UM, K, E, D):
    """aff_steer inputs: a random window (domain-less nodes, terms no pod
    matches yet, pipelined counts) with about as many required and anti
    entries a row at every E (a row of 300 terms at _aff_case's density
    fails everywhere), then, by ``kind``:
    - "exempt": every required entry self-matched, on a term with no count
      anywhere: the rule exempts it at every node;
    - "last": every required entry self-matched, and each such term's only
      count in the window's last domain, which the zero test must reach;
    - "pipelined": the self-matched terms' counts only in ``cnt_p``
      (``cnt_a`` zero there), some of them none at all."""
    at = _aff_case(7 + E, cuda, U=UM, E=E, D=D, N=500, cnt_density=0.05)
    g = torch.Generator().manual_seed(K)
    keep = (torch.rand((UM, E), generator=g) < min(1.0, 12.0 / E)).to(cuda)
    at = at._replace(t_req_aff=at.t_req_aff & keep,
                     t_req_anti=at.t_req_anti & keep)
    if kind != "random":
        aff = at.t_req_aff
        req = aff.any(dim=0)
        cnt_a, cnt_p = at.cnt_a.clone(), at.cnt_p.clone()
        cnt_a[req] = 0
        cnt_p[req] = 0
        at = at._replace(t_matches=at.t_matches | aff)
        if kind == "last":
            cnt_a[req, D - 1] = 1
            # Some ranked nodes in that domain: the count holds there.
            nd = at.node_dom.clone()
            nd[:50] = D - 1
            at = at._replace(node_dom=nd)
        elif kind == "pipelined":
            some = req & (torch.rand(E, generator=g) < 0.5).to(cuda)
            cols = torch.randint(0, D, (E,), generator=g).to(cuda)
            rows = torch.nonzero(some).flatten()
            cnt_p[rows, cols[rows]] = 1
        at = at._replace(cnt_a=cnt_a, cnt_p=cnt_p)
    ranked = torch.randint(0, 500, (UM, K), generator=g).to(torch.int32)
    feas = torch.rand((UM, K), generator=g) < 0.8
    return at, ranked.to(cuda), feas.to(cuda), g


@pytest.mark.parametrize("kind,UM,K,E,D", [
    ("random", 6, 9, 12, 40), ("random", 64, 256, 12, 9001),
    ("random", 16, 300, 300, 8192), ("exempt", 64, 256, 12, 10016),
    ("last", 64, 256, 12, 10016), ("last", 32, 64, 12, 9001),
    ("last", 16, 300, 300, 8192), ("pipelined", 64, 256, 12, 10016)])
def test_aff_steer_gate_equals_plain(cuda, kind, UM, K, E, D):
    """aff_steer over the windows of ``_steer_case``: K = 300 spans two
    tiles, E = 300 two staging rounds, D = 9,001 the unaligned zero tests.
    A clear gate leaves the working plane and the computing tally
    untouched; a set gate writes what the plain version writes; without a
    gate the plane is the same."""
    from volcano_tpu_torch.ops import affkernels

    at, ranked, feas, g = _steer_case(kind, cuda, UM, K, E, D)
    want = affkernels.aff_steer(ranked, feas, at, plain=True)
    prior = torch.rand((UM, K), generator=g).to(cuda) < 0.5
    kernels.reset_launches()
    for gate in (False, True):
        out = prior.clone()
        ref = prior.clone()
        gt = torch.tensor([gate], device=cuda)
        got = affkernels.aff_steer(ranked, feas, at, gate=gt, out=out)
        affkernels.aff_steer(ranked, feas, at, gate=gt, out=ref, plain=True)
        assert got is out
        _equal(out, ref, "plane")
        _equal(out, want if gate else prior, "plane vs expected")
    assert kernels.LAUNCHES["aff_steer"] == 2
    # The plain version's computing call counts too.
    assert kernels.read_tally("aff_steer") == 2
    _equal(affkernels.aff_steer(ranked, feas, at), want, "without a gate")
    assert bool(want.any())
    if kind != "exempt":
        assert bool((feas & ~want).any())
    if kind in ("exempt", "last"):
        # The rule decides: exempt, nothing fails a required term; with
        # the last domain's count, the nodes outside it do.
        free = affkernels.aff_steer(
            ranked, feas, at._replace(t_req_aff=torch.zeros_like(
                at.t_req_aff)), plain=True)
        assert torch.equal(want, free) is (kind == "exempt")


@pytest.mark.parametrize("gate", [True, False])
def test_aff_steer_is_one_kernel_a_call(cuda, gate):
    """One aff_steer call, computing or gated, puts one kernel on the card
    and nothing else, read from a torch.profiler trace (opened by a spin
    kernel, left out: a short trace has lost its first events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from volcano_tpu_torch.ops import affkernels

    at, ranked, feas, _g = _steer_case("last", cuda, 64, 256, 12, 10016)
    out = torch.zeros_like(feas)
    gt = torch.tensor([gate], device=cuda)
    affkernels.aff_steer(ranked, feas, at, gate=gt, out=out)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
        affkernels.aff_steer(ranked, feas, at, gate=gt, out=out)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "spin_kernel" not in e.name]
    assert len(names) == 1 and "aff_steer_row_kernel" in names[0], names


@pytest.mark.parametrize("steer", [0, 1])
@pytest.mark.parametrize("twophase", ["0", "1"])
def test_single_phase_and_steered_solves_equal_plain_and_cpu(
        cuda, monkeypatch, twophase, steer):
    """The contended affinity store (steering changes its binds) in both
    phase modes, steering on and off: the kernels equal the plain versions
    on the card and the CPU run, and the single-phase solve launches the
    static planes per wave and no shortlist."""
    import volcano_tpu_torch.ops.wave as tw
    from test_torch_fixtures import affinity_store

    monkeypatch.setenv("VOLCANO_TPU_TWOPHASE", twophase)
    monkeypatch.setattr(tw, "AFF_STEER", steer)
    store = affinity_store(volcano_tpu_torch, n_nodes=64, n_gangs=48,
                           gang_size=8, zones=4, node_cpu="8",
                           mix=("aff", "anti", "res_aff", "res_anti"))
    k, p, c, launched = _solve_three_ways(store, 32)
    _same(k, p)
    _same(k, c)
    assert tw.LAST_TWOPHASE["enabled"] is (twophase == "1")
    for kn in ("aff_live", "aff_filter", "rank_candidates", "walk_accept",
               "apply_commit"):
        assert launched[kn] > 0, (kn, launched)
    assert (launched["aff_steer"] > 0) is bool(steer)
    if twophase == "0":
        assert launched["coarse_shortlist"] == 0
        assert launched["static_planes"] == tw.LAST_TWOPHASE["waves"]


@pytest.mark.parametrize("case", ["preempt-cluster", "two-queue", "tier"])
def test_host_walk_cycles_on_card_equal_cpu(cuda, monkeypatch, case):
    """The host victim walk (``VOLCANO_TPU_EVICT_DEVICE=0``) with the
    allocate solves on the card: evicted and pipelined uids, binds,
    PodGroup phases and mirror states equal the CPU run every cycle."""
    from test_torch_fixtures import (EVICT_CONF, tier_store,
                                     two_queue_store, walk_run)

    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "0")
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "never")
    monkeypatch.delenv("VOLCANO_TPU_NO_NATIVE", raising=False)
    build = {
        "preempt-cluster": lambda pkg: pkg.synth.preempt_cluster(
            n_nodes=64, n_pending=128, seed=0),
        "two-queue": lambda pkg: two_queue_store(pkg, n_nodes=32, hi_a=16,
                                                 hi_b=16),
        "tier": lambda pkg: tier_store(pkg, workers=32, serving=16),
    }[case]
    kernels.reset_launches()
    card = walk_run(volcano_tpu_torch, build, conf=EVICT_CONF, cycles=5,
                    grace=1, device=None)
    assert kernels.LAUNCHES["rank_candidates"] > 0
    cpu = walk_run(volcano_tpu_torch, build, conf=EVICT_CONF, cycles=5,
                   grace=1, device="cpu")
    assert card == cpu
    assert any(r["evicted"] for r in card)


def _spawn_port_child(*extra):
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.solver_service",
         "--port", "0", "--announce", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        cwd=str(root), text=True)
    line = proc.stdout.readline().strip()
    if not line.startswith("SOLVER "):
        proc.kill()
        raise RuntimeError(f"solver child did not announce: {line!r}")
    return proc, int(line.split()[1])


def test_solver_child_on_card_answers_like_the_cpu_child(cuda):
    """A port solver child on the card (the default device) answers
    ``ping`` with the card's name, and a 64-node solve frame gets the
    reply the CPU child gives, array for array."""
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.solver_service import RemoteSolver

    card, card_port = _spawn_port_child()
    cpu, cpu_port = _spawn_port_child("--device", "cpu")
    try:
        on_card = RemoteSolver(f"127.0.0.1:{card_port}", timeout=300)
        on_cpu = RemoteSolver(f"127.0.0.1:{cpu_port}", timeout=300)
        pong = on_card.ping()
        assert pong["backend"] == "cuda" and pong["wire"] == 2
        assert pong["device"] == torch.cuda.get_device_name(0)
        assert on_cpu.ping()["backend"] == "cpu"

        calls = []

        class Capture:
            def __getattr__(self, name):
                return getattr(on_cpu, name)

            def solve(self, inputs, pid, profiles, wave=None, devincr=None):
                calls.append((inputs, pid, profiles))
                return on_cpu.solve(inputs, pid, profiles, wave=wave,
                                    devincr=devincr)

        store = synthetic_cluster(n_nodes=64, n_pods=512, gang_size=4,
                                  n_queues=2, zones=4, seed=3)
        store.remote_solver = Capture()
        Scheduler(store, device="cpu").run_once()
        assert calls
        fields = ("assigned", "pipelined", "never_ready", "fit_failed",
                  "iters", "fb_exhausted", "fb_affinity")
        a = on_card.solve(*calls[0])
        b = on_cpu.solve(*calls[0])
        for f in fields:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert np.array_equal(x, y), f
        assert int((np.asarray(a.assigned) >= 0).sum()) > 0
        assert on_card.ping()["solves"] == 1
        store.close()
        on_card.close()
        on_cpu.close()
    finally:
        for proc in (card, cpu):
            proc.terminate()
            proc.wait(timeout=30)


def test_service_on_card_takes_config1_job_to_running(cuda):
    """BASELINE config 1 through the daemon on the card (the default
    device): two nodes, a 3-replica gang, periods 0.01 / 0.005 s; the
    gang Running within a bounded wait, the wave solve's kernels launched
    by the scheduler's thread, every thread joined by ``stop()``."""
    import threading
    import time

    from volcano_tpu_torch.api import Node
    from volcano_tpu_torch.controllers import Job, TaskSpec
    from volcano_tpu_torch.service import Service

    before = set(threading.enumerate())
    svc = Service(simulate=True, schedule_period=0.01,
                  controller_period=0.005)
    assert svc.scheduler.device.type == "cuda"
    for i in range(2):
        svc.store.add_node(Node(name=f"node-{i}", allocatable={
            "cpu": "8", "memory": "16Gi", "pods": 64}))
    job = Job(name="test-job", min_available=3, tasks=[TaskSpec(
        name="worker", replicas=3,
        containers=[{"cpu": "1", "memory": "1Gi"}])])
    kernels.reset_launches()
    svc.start(http_port=0)
    started = [t for t in threading.enumerate() if t not in before]
    try:
        svc.admitted.add_batch_job(job)
        deadline = time.monotonic() + 120.0
        running = []
        while time.monotonic() < deadline:
            running = [p for p in list(svc.store.pods.values())
                       if p.owner_job == job.key and p.phase == "Running"]
            if len(running) >= 3:
                break
            time.sleep(0.002)
        assert len(running) == 3
    finally:
        svc.stop()
    assert not [t.name for t in started if t.is_alive()]
    for name in ("coarse_shortlist", "rank_candidates", "walk_accept",
                 "apply_commit"):
        assert kernels.LAUNCHES[name] > 0, name
