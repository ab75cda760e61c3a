"""Shared fixtures of the port's parity tests: cluster builders that run
against either package's API, and the JAX-args -> numpy conversion.

Both packages expose the same ``api`` / ``cache`` / ``synth`` surface, so a
builder given the package module builds the same cluster in each.  The
tests here check that the builders and the numpy conversion agree.  The
JAX package is imported only inside those tests, so the builders also serve
the card-only tests on machines without JAX.
"""

import numpy as np

import volcano_tpu_torch
import volcano_tpu_torch.api
import volcano_tpu_torch.cache
import volcano_tpu_torch.synth


def tonp(a):
    """Every leaf of a (nested) NamedTuple as numpy; floats stay floats."""
    if hasattr(a, "_fields"):
        return type(a)(*[tonp(x) for x in a])
    if isinstance(a, tuple):
        return tuple(tonp(x) for x in a)
    if isinstance(a, (float, int)) and not isinstance(a, bool):
        return a
    return np.asarray(a)


def one_node_gang(pkg, cpu="4", replicas=8, min_member=8):
    """One node and one gang (test_wave.py's _one_node_store/_add_gang)."""
    api = pkg.api
    store = pkg.cache.ClusterStore()
    store.add_node(api.Node(name="n0",
                            allocatable={"cpu": cpu, "memory": "16Gi"}))
    pg = api.PodGroup(name="g", min_member=min_member, queue="default")
    store.add_pod_group(pg)
    for k in range(replicas):
        store.add_pod(api.Pod(
            name=f"g-{k}",
            annotations={api.GROUP_NAME_ANNOTATION: "g"},
            containers=[{"cpu": "1", "memory": "1Gi"}],
        ))
    return store


def selector_store(pkg):
    """test_wave.py's node-selector fixture: only "good" carries zone=a."""
    api = pkg.api
    store = pkg.cache.ClusterStore()
    store.add_node(api.Node(name="bad",
                            allocatable={"cpu": "64", "memory": "64Gi"}))
    store.add_node(api.Node(name="good",
                            allocatable={"cpu": "64", "memory": "64Gi"},
                            labels={"zone": "a"}))
    pg = api.PodGroup(name="pinned", min_member=2, queue="default")
    store.add_pod_group(pg)
    for k in range(2):
        store.add_pod(api.Pod(
            name=f"pinned-{k}",
            annotations={api.GROUP_NAME_ANNOTATION: "pinned"},
            containers=[{"cpu": "1", "memory": "1Gi"}],
            node_selector={"zone": "a"},
        ))
    return store


def feature_store(pkg, n_nodes=64, n_pods=512, seed=0, n_queues=2):
    """Taints/tolerations, node selectors, required and preferred node
    affinity, mixed gang sizes and queues.  A quarter of the nodes carry a
    NoSchedule taint; a third of the gangs tolerate it, a quarter pin a
    zone by selector, some require one of two zones, some prefer one."""
    api = pkg.api
    rng = np.random.default_rng(seed)
    store = pkg.cache.ClusterStore()
    zones = 4
    for i in range(n_nodes):
        taints = []
        if i % 4 == 3:
            taints = [api.Taint(key="dedicated", value="batch",
                                effect="NoSchedule")]
        store.add_node(api.Node(
            name=f"node-{i:05d}",
            allocatable={"cpu": "32", "memory": "128Gi", "pods": 110},
            labels={"zone": f"zone-{i % zones}",
                    "disk": "ssd" if i % 3 else "hdd"},
            taints=taints,
        ))
    for q in range(1, n_queues):
        store.add_queue(api.Queue(name=f"queue-{q}", weight=q + 1))
    queues = ["default"] + [f"queue-{q}" for q in range(1, n_queues)]
    made = 0
    g = 0
    while made < n_pods:
        size = min(int(rng.integers(1, 9)), n_pods - made)
        name = f"pg-{g:05d}"
        store.add_pod_group(api.PodGroup(
            name=name, min_member=max(1, size - int(rng.integers(0, 2))),
            queue=queues[g % len(queues)],
        ))
        cpu = str(rng.choice(["1", "2", "4"]))
        mem = str(rng.choice(["2Gi", "4Gi", "8Gi"]))
        kind = int(rng.integers(0, 6))
        extra = {}
        if kind == 0:
            extra["node_selector"] = {"zone": f"zone-{g % zones}"}
        elif kind == 1:
            extra["tolerations"] = [api.Toleration(
                key="dedicated", operator="Equal", value="batch",
                effect="NoSchedule")]
        elif kind == 2:
            extra["required_node_affinity"] = [
                {"zone": "zone-0"}, {"zone": "zone-2", "disk": "ssd"}]
        elif kind == 3:
            extra["preferred_node_affinity"] = [({"disk": "hdd"}, 3),
                                                ({"zone": "zone-1"}, 1)]
            extra["tolerations"] = [api.Toleration(operator="Exists")]
        for k in range(size):
            store.add_pod(api.Pod(
                name=f"{name}-{k}",
                annotations={api.GROUP_NAME_ANNOTATION: name},
                containers=[{"cpu": cpu, "memory": mem}],
                **extra,
            ))
            made += 1
        g += 1
    return store


def _jax_package():
    import volcano_tpu
    import volcano_tpu.api
    import volcano_tpu.cache
    import volcano_tpu.synth

    return volcano_tpu


def test_builders_agree_across_packages():
    """Every builder gives byte-equal solve args in both packages."""
    volcano_tpu = _jax_package()
    for build in (one_node_gang, selector_store, feature_store):
        ja, _ = volcano_tpu.synth.solve_args_from_store(build(volcano_tpu))
        ta, _ = volcano_tpu_torch.synth.solve_args_from_store(
            build(volcano_tpu_torch), device="cpu")
        for jx, tx in zip(tonp(ja)[:4] + (tonp(ja)[7],),
                          ta[:4] + (ta[7],)):
            for f in jx._fields:
                a = np.asarray(getattr(jx, f))
                b = getattr(tx, f).numpy()
                if a.dtype == np.uint32:
                    b = b.view(np.uint32)
                assert a.dtype == b.dtype and np.array_equal(a, b), (
                    build.__name__, f)


def test_tonp_keeps_weights_scalars():
    volcano_tpu = _jax_package()
    args, _ = volcano_tpu.synth.solve_args_from_store(
        volcano_tpu.synth.synthetic_cluster(n_nodes=8, n_pods=16))
    w = tonp(args)[4]
    assert isinstance(w.binpack_weight, float)
    assert isinstance(w.binpack_res, np.ndarray)


def shortlist_case(seed, U=16, N=1024, C=6, R=3, LW=2, TW=1, A=2, AP=2,
                   kind="mixed"):
    """Random inputs of the shortlist kernels as numpy arrays: node planes
    (idle, allocatable, pod slots, class ids), class tables, profile rows
    and scorer weights.  ``kind``: "mixed" (varied capacity and classes),
    "ties" (identical nodes, one class: every score ties) or "neg" (nine
    nodes in ten without room: blocks mostly NEG)."""
    rng = np.random.default_rng(seed)
    gib = float(2 ** 30)
    cpu = rng.integers(0, 65, size=N) * 1000.0
    mem = rng.integers(0, 257, size=N) * gib
    gpu = rng.integers(0, 3, size=N).astype(np.float64)
    alloc = np.stack([np.full(N, 64000.0), np.full(N, 256 * gib),
                      np.full(N, 2.0)], 1)[:, :R].astype(np.float32)
    idle = np.stack([cpu, mem, gpu], 1)[:, :R].astype(np.float32)
    idle = np.minimum(idle, alloc)
    cls_id = rng.integers(0, C, size=N).astype(np.int32)
    ntasks = rng.integers(0, 8, size=N).astype(np.int32)
    max_tasks = rng.choice([0, 4, 110], size=N).astype(np.int32)
    if kind == "ties":
        idle[:] = alloc[0]
        cls_id[:] = 0
        ntasks[:] = 0
        max_tasks[:] = 110
    elif kind == "neg":
        idle[rng.random(N) < 0.9] = 0.0
    bits = lambda *s: (rng.integers(0, 1 << 32, size=s, dtype=np.uint64)
                       & rng.integers(0, 1 << 32, size=s, dtype=np.uint64)
                       & rng.integers(0, 1 << 32, size=s, dtype=np.uint64)
                       ).astype(np.uint32)
    cls_label = (bits(C, LW) | bits(C, LW) | bits(C, LW)).astype(np.uint32)
    cls_taint = bits(C, TW) * (rng.random((C, 1)) < 0.3)
    cls_ready = rng.random(C) < 0.9
    if kind == "ties":
        cls_ready[0] = True
        cls_taint[0] = 0
    req = np.stack([rng.integers(1, 5, size=U) * 1000.0,
                    rng.integers(1, 9, size=U) * gib,
                    rng.integers(0, 2, size=U).astype(np.float64)],
                   1)[:, :R].astype(np.float32)
    # Selector / affinity words drawn as subsets of some class's labels,
    # so a share of the (profile, class) pairs is feasible.
    pick = rng.integers(0, C, size=(U, 1 + A + AP))
    sub = lambda c: cls_label[c] & bits(*cls_label[c].shape)
    sel_bits = sub(pick[:, 0]) * (rng.random((U, 1)) < 0.5)
    aff_bits = np.stack([sub(pick[:, 1 + a]) for a in range(A)], 1)
    aff_terms = rng.integers(0, A + 1, size=U).astype(np.int32)
    tol_bits = bits(U, TW) | (rng.random((U, 1)) < 0.5) * np.uint32(
        0xFFFFFFFF)
    pref_bits = np.stack([sub(pick[:, 1 + A + a]) for a in range(AP)], 1)
    pref_w = (rng.integers(0, 11, size=(U, AP)) / 10.0).astype(np.float32)
    return dict(
        idle=idle, alloc=alloc, cls_id=cls_id, ntasks=ntasks,
        max_tasks=max_tasks, cls_label=cls_label,
        cls_taint=cls_taint.astype(np.uint32), cls_ready=cls_ready,
        req=req, init_req=req.copy(), sel_bits=sel_bits.astype(np.uint32),
        aff_bits=aff_bits.astype(np.uint32), aff_terms=aff_terms,
        tol_bits=tol_bits.astype(np.uint32),
        pref_bits=pref_bits.astype(np.uint32), pref_w=pref_w,
        eps=np.array([10.0, 1.0, 10.0], np.float32)[:R],
        scalar_slot=np.array([False, False, True])[:R],
        binpack_res=np.ones(R, np.float32),
        weights=(1.0, 1.0, 0.0, 1.0, 1.0),
    )


def shortlist_tensors(case, device):
    """``shortlist_case`` as the port's containers on ``device``:
    (SolveProfiles, NodeClasses, node planes dict, ScoreWeights, eps,
    scalar_slot)."""
    import torch

    from volcano_tpu_torch.device import to_tensor
    from volcano_tpu_torch.ops.nodeclass import NodeClasses
    from volcano_tpu_torch.ops.scoring import ScoreWeights
    from volcano_tpu_torch.ops.wave import SolveProfiles

    t = {k: to_tensor(v, device) for k, v in case.items()
         if isinstance(v, np.ndarray)}
    z = torch.zeros((case["req"].shape[0], 1), device=device)
    prof = SolveProfiles(
        req=t["req"], init_req=t["init_req"], ports=z,
        sel_bits=t["sel_bits"], aff_bits=t["aff_bits"],
        aff_terms=t["aff_terms"], tol_bits=t["tol_bits"],
        pref_bits=t["pref_bits"], pref_w=t["pref_w"], t_req_aff=z,
        t_req_anti=z, t_matches=z, t_soft=z)
    cls = NodeClasses(class_id=t["cls_id"], label_bits=t["cls_label"],
                      taint_bits=t["cls_taint"], ready=t["cls_ready"])
    bw, lw, mw, balw, naff = case["weights"]
    weights = ScoreWeights(binpack_weight=bw, binpack_res=t["binpack_res"],
                           least_req_weight=lw, most_req_weight=mw,
                           balanced_weight=balw, node_affinity_weight=naff)
    nodes = {k: t[k] for k in ("idle", "alloc", "ntasks", "max_tasks")}
    return prof, cls, nodes, weights, t["eps"], t["scalar_slot"]


ST_BOUND = 16  # TaskStatus.Bound


def repend_feed(node_rows):
    """A cycle feed re-pending the pods bound to ``node_rows`` every
    cycle (test_devincr.py's ``_partial_feed``)."""

    def feed(fc):
        m = fc.m
        rows = np.flatnonzero(
            (m.p_status[:fc.Pn] == ST_BOUND) & m.p_alive[:fc.Pn])
        if len(rows):
            sel = rows[np.isin(m.p_node[rows], node_rows)]
            if len(sel):
                fc._unbind_rows(sel)

    return feed


def mirror_state(store):
    m = store.mirror
    return tuple(
        (m.p_uid[r], int(m.p_status[r]), m.p_node_name[r])
        for r in range(m.n_pods) if m.p_uid[r] is not None
    )


def churn(api, store, rng, step):
    """test_devincr.py's randomized mutation batch, built from ``api``."""
    op = rng.choice(["add_gang", "delete_pod", "node_flap", "add_pods",
                     "nothing"])
    if op == "add_gang":
        name = f"churn-{step}"
        store.add_pod_group(api.PodGroup(name=name, min_member=2))
        for i in range(2):
            store.add_pod(api.Pod(
                name=f"{name}-{i}",
                annotations={api.GROUP_NAME_ANNOTATION: name},
                containers=[{"cpu": "1", "memory": "1Gi"}],
            ))
    elif op == "delete_pod":
        pods = sorted(store.pods.values(), key=lambda p: p.name)
        if pods:
            store.delete_pod(pods[rng.randrange(len(pods))])
    elif op == "node_flap":
        names = sorted(store.mirror.n_row)
        if names:
            name = names[rng.randrange(len(names))]
            if rng.random() < 0.5:
                store.delete_node(name)
            else:
                store.add_node(api.Node(
                    name=name,
                    allocatable={"cpu": "64", "memory": "256Gi",
                                 "pods": 256},
                ))
    elif op == "add_pods":
        name = f"solo-{step}"
        store.add_pod_group(api.PodGroup(name=name, min_member=1))
        store.add_pod(api.Pod(
            name=f"{name}-0",
            annotations={api.GROUP_NAME_ANNOTATION: name},
            containers=[{"cpu": "2", "memory": "2Gi"}],
        ))


def frag_case(seed, N=300, U=8, R=3, overflow=False):
    """Random planes for ``frag_scores``: memory in multiples of 10^6 bytes
    (not powers of two), not-ready rows, rows with zero-allocatable slots,
    all-zero (padding) profile rows, a profile that requests only one slot,
    and, with ``overflow``, rows whose idle over a tiny request overflows
    int32 (2^31 and more gang tasks; XLA's convert saturates)."""
    rng = np.random.RandomState(seed)
    alloc = np.zeros((N, R), np.float32)
    alloc[:, 0] = rng.choice([0.0, 4000.0, 8000.0, 64000.0], N)
    alloc[:, 1] = rng.randint(0, 64, N) * 1.0e9
    alloc[:, 2:] = rng.randint(0, 8, (N, R - 2))
    idle = (alloc * rng.uniform(0.0, 1.0, (N, R))).astype(np.float32)
    idle[:, 0] = np.floor(idle[:, 0] / 500.0) * 500.0
    idle[:, 1] = np.floor(idle[:, 1] / 1.0e6) * 1.0e6
    idle[rng.rand(N) < 0.1] = 0.0
    ev = np.zeros((N, R), np.float32)
    ev[:, 0] = rng.choice([0.0, 1000.0, 3000.0], N)
    ev[:, 1] = rng.randint(0, 4, N) * 1.0e9
    ready = rng.rand(N) > 0.15
    req = np.zeros((U, R), np.float32)
    k = max(1, U // 2)
    req[:k, 0] = rng.choice([500.0, 1000.0, 2000.0, 4000.0], k)
    req[:k, 1] = rng.randint(1, 8, k) * 1.0e9
    if U > 2:
        req[k - 1, 0] = 0.0  # requests memory only
    eps = np.array([10.0, 1.0] + [0.01] * (R - 2), np.float32)
    if overflow:
        # A profile requesting every slot just above eps, and rows of tens
        # of GiB (and as many CPUs and scalars) over it: 2^31 and more
        # tasks per slot, so the min over slots overflows int32 too.
        eps[:] = [0.01, 1.0] + [0.001] * (R - 2)
        req[0] = [0.02, 2.0] + [0.002] * (R - 2)
        big = rng.choice(N, 5, replace=False)
        idle[big] = [1.0e8, 6.4e10] + [1.0e7] * (R - 2)
        alloc[big] = idle[big]
    return dict(idle=idle, alloc=alloc, ready=ready, evictable=ev,
                prof_req=req, eps=eps)


def frag_edge_case(seed, N=300, U=8, R=3, zero_rows="between",
                   overflow=False):
    """``frag_scores``' inputs at the card kernel's edges, for any R from 1
    to 16: all-zero profile rows placed ``first``, ``between`` the live
    rows (every other row) or ``last``; live rows that leave some slots
    unrequested (and one that requests only the last slot); U past the
    kernel's 64-row staging chunk when asked; not-ready rows, empty idle
    rows and zero-allocatable slots; with ``overflow``, a row of the table
    requesting every slot just above eps and nodes whose counts over it
    pass the int32 range."""
    rng = np.random.RandomState(seed)
    unit = np.array([1000.0, 1.0e9] + [1.0] * 14, np.float32)[:R]
    alloc = (rng.randint(0, 65, (N, R)) * unit).astype(np.float32)
    alloc[rng.rand(N, R) < 0.1] = 0.0
    idle = np.floor(alloc * rng.uniform(0.0, 1.0, (N, R)) / unit * 4) \
        * unit / 4
    idle = idle.astype(np.float32)
    idle[rng.rand(N) < 0.1] = 0.0
    ev = (rng.randint(0, 9, (N, R)) * unit).astype(np.float32)
    ready = rng.rand(N) > 0.15
    eps = (unit * 0.01).astype(np.float32)
    rows = np.arange(U)
    n_live = max(1, U // 2)
    live = {"first": rows[U - n_live:], "last": rows[:n_live],
            "between": rows[1::2][:n_live] if U > 1 else rows}[zero_rows]
    req = np.zeros((U, R), np.float32)
    for u in live:
        want = rng.rand(R) < 0.7
        want[rng.randint(R)] = True
        req[u] = np.where(want, rng.randint(1, 9, R) * unit, 0.0)
    if len(live) > 1:
        req[live[-1]] = 0.0
        req[live[-1], R - 1] = 2.0 * unit[R - 1]
    if overflow:
        req[live[0]] = 2.0 * eps
        big = rng.choice(N, min(N, 5), replace=False)
        idle[big] = req[live[0]] * np.float32(2.0 ** 33)
        alloc[big] = idle[big]
    return dict(idle=idle, alloc=alloc, ready=ready, evictable=ev,
                prof_req=req, eps=eps)


def block_fit_case(seed, N=400, U=4, R=3, n_blocks=16):
    """Random planes for ``gang_block_fit``: block ids with -1 (blockless)
    rows, max_tasks > 0 on some nodes, not-ready nodes and all-zero
    (padding) profile rows with count 0."""
    rng = np.random.RandomState(seed)
    c = frag_case(seed, N=N, U=U, R=R)
    c["prof_req"][0] = [1000.0, 1.0e9] + [0.0] * (R - 2)
    real = max(1, U // 2)
    cnt = np.zeros(U, np.int32)
    cnt[:real] = rng.randint(1, 40, real)
    max_tasks = np.where(rng.rand(N) < 0.5, rng.randint(1, 6, N),
                         0).astype(np.int32)
    ntasks = rng.randint(0, 6, N).astype(np.int32)
    block = rng.randint(-1, n_blocks - 2, N).astype(np.int32)
    return dict(idle=c["idle"], ready=c["ready"], ntasks=ntasks,
                max_tasks=max_tasks, block_id=block, prof_req=c["prof_req"],
                prof_cnt=cnt, eps=c["eps"], n_blocks=n_blocks)


def block_fit_edge_case(seed, N=300, U=4, R=3, n_blocks=16):
    """``block_fit_case`` with the edges a scatter into block rows has to
    get right: block ids -1 and below (blockless: JAX's trash row),
    ``n_blocks`` (the trash row itself) and past it (dropped as out of
    range); nodes not ready; ``max_tasks`` 0 (unlimited) and ``max_tasks``
    > 0 with ``ntasks`` past it (no slot left); and an all-zero profile
    row, with a pending count on odd seeds (no block is then whole)."""
    c = block_fit_case(seed, N=N, U=U, R=R, n_blocks=n_blocks)
    rng = np.random.RandomState(seed + 1000)
    pick = rng.rand(N)
    block = c["block_id"].copy()
    block[pick < 0.08] = -1
    block[(pick >= 0.08) & (pick < 0.12)] = -7
    block[(pick >= 0.12) & (pick < 0.16)] = n_blocks
    block[(pick >= 0.16) & (pick < 0.2)] = n_blocks + 5
    past = (pick >= 0.2) & (pick < 0.3)
    c["max_tasks"] = c["max_tasks"].copy()
    c["ntasks"] = c["ntasks"].copy()
    c["max_tasks"][past] = 3
    c["ntasks"][past] = 5
    c["prof_req"] = c["prof_req"].copy()
    c["prof_cnt"] = c["prof_cnt"].copy()
    c["prof_req"][U - 1] = 0.0
    c["prof_cnt"][U - 1] = 3 if seed % 2 else 0
    c["block_id"] = block
    return c


def profile_entry_case(kind, k, u, e, seed=0):
    """Sparse entries for ``scatter_profile_tables`` at its edges: ``pad``
    k padded entries only (flags 0 and +0.0 at (0, 0)); ``origin`` a real
    entry at (0, 0) among the padded ones (and a few elsewhere); ``negzero``
    real entries whose soft value is -0.0, with flag bits and without;
    ``full`` every cell real, no padding.  Real (row, col) pairs are unique,
    as the encode's ``np.nonzero`` gives them.  Returns (rows, cols, flags,
    soft) as numpy arrays."""
    rng = np.random.RandomState(seed)
    cells = u * e
    if kind == "pad":
        real = np.zeros(0, np.int64)
    elif kind == "origin":
        rest = rng.choice(np.arange(1, cells), min(cells - 1, k // 4),
                          replace=False) if cells > 1 else np.zeros(0, int)
        real = np.concatenate([[0], rest]).astype(np.int64)
    elif kind == "negzero":
        real = rng.choice(cells, min(cells, k // 2), replace=False)
    elif kind == "full":
        real = np.arange(cells, dtype=np.int64)
    else:
        raise ValueError(kind)
    n = len(real)
    if n > k:
        raise ValueError("more real entries than k")
    flags = rng.randint(0, 8, n).astype(np.int8)
    soft = rng.choice([5.0, -5.0, 10.0, -10.0, 0.0], n).astype(np.float32)
    if kind == "origin":
        flags[0], soft[0] = 7, -5.0
    if kind == "negzero":
        soft[:] = -0.0
        flags[: n // 2] = 0
    pad = k - n
    rows = np.concatenate([real // e, np.zeros(pad, np.int64)])
    cols = np.concatenate([real % e, np.zeros(pad, np.int64)])
    return (rows.astype(np.int32), cols.astype(np.int32),
            np.concatenate([flags, np.zeros(pad, np.int8)]),
            np.concatenate([soft, np.zeros(pad, np.float32)]))


def affinity_store(pkg, n_nodes=32, n_gangs=24, gang_size=4, zones=4,
                   seed=0, ports=True, residents=2, pod_cpu=("1", "2"),
                   node_cpu="16", mix=("aff", "anti", "res_aff", "res_anti",
                                       "prefer", "spread", "plain")):
    """BASELINE config 5's inter-pod mix at a small size, with the cases
    the count machinery has to get right: ``residents`` running pods per
    app ``res-k`` (k < 3) on fixed nodes (real count-table entries, a
    host port 9000 on every other one), every seventh node without a zone
    label (domain -1), and pending gangs cycling through ``mix``: required
    zone affinity to their own app (the self-match rule), required
    hostname anti-affinity to their own app, required zone affinity /
    hostname anti-affinity to a resident app, preferred zone affinity to a
    resident app (weight 5), zone spread (weight 10), none.  With
    ``ports`` every third gang asks for host port 8080 (and every sixth
    also 9000)."""
    api = pkg.api
    rng = np.random.default_rng(seed)
    store = pkg.cache.ClusterStore()
    for i in range(n_nodes):
        labels = {} if i % 7 == 6 else {"zone": f"z{i % zones}"}
        store.add_node(api.Node(name=f"n{i:03d}",
                                allocatable={"cpu": node_cpu,
                                             "memory": "64Gi",
                                             "pods": 110},
                                labels=labels))
    for k in range(3):
        pg = api.PodGroup(name=f"res-{k}", min_member=1, queue="default")
        store.add_pod_group(pg)
        for r in range(residents):
            node = (5 * k + 3 * r) % n_nodes
            store.add_pod(api.Pod(
                name=f"res-{k}-{r}", labels={"app": f"res-{k}"},
                annotations={api.GROUP_NAME_ANNOTATION: f"res-{k}"},
                containers=[{"cpu": "1", "memory": "1Gi"}],
                node_name=f"n{node:03d}", phase="Running",
                host_ports=[9000] if ports and r % 2 == 0 else [],
            ))
    zone = "zone"
    host = "kubernetes.io/hostname"
    for g in range(n_gangs):
        name = f"g{g:03d}"
        kind = mix[g % len(mix)]
        res = f"res-{g % 3}"
        extra = {}
        if kind == "aff":
            extra["affinity"] = [api.AffinityTerm(
                match_labels={"app": name}, topology_key=zone)]
        elif kind == "anti":
            extra["anti_affinity"] = [api.AffinityTerm(
                match_labels={"app": name}, topology_key=host)]
        elif kind == "res_aff":
            extra["affinity"] = [api.AffinityTerm(
                match_labels={"app": res}, topology_key=zone)]
        elif kind == "res_anti":
            extra["anti_affinity"] = [api.AffinityTerm(
                match_labels={"app": res}, topology_key=host)]
        elif kind == "prefer":
            extra["preferred_affinity"] = [(api.AffinityTerm(
                match_labels={"app": res}, topology_key=zone), 5)]
        elif kind == "spread":
            extra["topology_spread"] = [(zone, 10)]
        if ports and g % 3 == 0:
            extra["host_ports"] = [8080] + ([9000] if g % 6 == 0 else [])
        pg = api.PodGroup(name=name, min_member=gang_size, queue="default")
        store.add_pod_group(pg)
        cpu = str(rng.choice(list(pod_cpu)))
        for k in range(gang_size):
            store.add_pod(api.Pod(
                name=f"{name}-{k}", labels={"app": name},
                annotations={api.GROUP_NAME_ANNOTATION: name},
                containers=[{"cpu": cpu, "memory": "2Gi"}], **extra,
            ))
    return store


# ------------------------------------------------ sequential-solve stores

SEQ_CASES = ("plain fit", "gang discard", "fit failure", "releasing",
             "host ports", "taints selectors node affinity")
# Runs of equal task rows (the card kernel keeps one key table per run
# profile): equal rows across jobs with a gang discarded mid-run whose
# nodes the next equal job takes, alternating profiles, term-reading rows
# between two runs of one profile, more distinct profiles than the card
# kernel's cap of 64; extended scalar resources: 3 resource slots, and 6
# (past the 4 the card kernel keeps in registers).
SEQ_RUN_CASES = ("profile runs", "alternating profiles",
                 "terms between runs", "many profiles", "scalar resources",
                 "many scalar resources")
SEQ_ZONES = ("zone-a", "zone-b", "zone-c")


def seq_store(pkg, name, seed=0):
    """The sequential-solve stores (test_ops.py / test_affinity.py /
    test_oracle_parity.py shapes), built from either package's api.
    ``name`` is one of SEQ_CASES, SEQ_RUN_CASES, "affinity" or "random"
    (both seeded)."""
    api = pkg.api
    store = pkg.cache.ClusterStore()

    def node(nm, cpu="8", mem="16Gi", pods=32, labels=None, taints=()):
        store.add_node(api.Node(name=nm, allocatable={
            "cpu": cpu, "memory": mem, "pods": pods},
            labels=dict(labels or {}), taints=list(taints)))

    def pod(nm, cpu="1", mem="1Gi", **kw):
        return api.Pod(name=nm, containers=[{"cpu": cpu, "memory": mem}],
                       **kw)

    def gang(g, pods, min_member=None, queue="default"):
        if queue != "default" and queue not in store.queues:
            store.add_queue(api.Queue(name=queue, weight=1))
        store.add_pod_group(api.PodGroup(
            name=g, min_member=min_member or len(pods), queue=queue))
        for p in pods:
            p.annotations = {**(p.annotations or {}),
                             api.GROUP_NAME_ANNOTATION: g}
            store.add_pod(p)

    def resident(nm, node_name, cpu="1", **kw):
        store.add_pod(api.Pod(name=nm, node_name=node_name,
                              phase=api.PodPhase.Running,
                              containers=[{"cpu": cpu, "memory": "1Gi"}],
                              **kw))

    if name == "plain fit":
        for i in range(4):
            node(f"n{i}", cpu=str(4 + 2 * i))
        for g in range(5):
            gang(f"g{g}", [pod(f"g{g}-{k}", cpu=str(1 + k % 3))
                           for k in range(3)])
    elif name == "gang discard":
        # The middle gang cannot reach min_member: its allocations roll
        # back and the capacity goes to the gang after it.
        node("n0", cpu="4")
        node("n1", cpu="4")
        gang("a", [pod("a0", cpu="2")])
        gang("b", [pod(f"b{k}", cpu="3") for k in range(3)])
        gang("c", [pod(f"c{k}", cpu="3") for k in range(2)])
    elif name == "fit failure":
        # b1 fits nowhere: the rest of gang b is aborted.
        node("n0", cpu="4")
        node("n1", cpu="2")
        gang("b", [pod("b0", cpu="2"), pod("b1", cpu="16"),
                   pod("b2", cpu="1")], min_member=1)
        gang("c", [pod("c0", cpu="2")])
    elif name == "releasing":
        # Full nodes with releasing pods: the newcomers pipeline onto the
        # future capacity, and pipelines survive a gang's rollback.
        for i in range(3):
            node(f"n{i}", cpu="4")
        store.add_pod_group(api.PodGroup(name="old", min_member=1))
        for i in range(3):
            resident(f"v{i}", f"n{i}", cpu="3",
                     annotations={api.GROUP_NAME_ANNOTATION: "old"})
        for t in list(store.jobs["default/old"].tasks.values())[:2]:
            store.evict(t, "test")
        gang("new", [pod(f"p{k}", cpu="2") for k in range(3)],
             min_member=2)
        gang("tail", [pod("t0", cpu="1")])
    elif name == "host ports":
        for i in range(3):
            node(f"n{i}")
        resident("res", "n0", host_ports=[8080])
        gang("web", [pod(f"w{k}", host_ports=[8080]) for k in range(4)],
             min_member=1)
        gang("db", [pod(f"d{k}", host_ports=[9090, 8080])
                    for k in range(2)])
    elif name == "taints selectors node affinity":
        for i in range(6):
            taints = ([api.Taint(key="dedicated", value="batch",
                                 effect="NoSchedule")] if i % 3 == 1 else [])
            node(f"n{i}", labels={"zone": SEQ_ZONES[i % 3],
                                  "disk": "ssd" if i % 2 else "hdd"},
                 taints=taints)
        tol = [api.Toleration(key="dedicated", operator="Equal",
                              value="batch", effect="NoSchedule")]
        gang("sel", [pod(f"s{k}", node_selector={"disk": "ssd"})
                     for k in range(3)])
        gang("tol", [pod(f"t{k}", tolerations=tol) for k in range(3)])
        gang("req", [pod(f"r{k}", required_node_affinity=[
            {"zone": "zone-c"}, {"disk": "ssd", "zone": "zone-a"}])
            for k in range(3)])
        # Fractional preferred term scores (w / total * 10).
        gang("pref", [pod(f"p{k}", preferred_node_affinity=[
            ({"zone": "zone-b"}, 3), ({"disk": "ssd"}, 7),
            ({"zone": "zone-a"}, 1)]) for k in range(4)])
    elif name == "affinity":
        # test_affinity.py's random mix (required affinity, anti-affinity,
        # spread, preferred affinity, self-matching gangs), plus a node
        # without the zone label (domain -1) and a resident match.
        rng = np.random.default_rng(1000 + seed)
        for z in SEQ_ZONES:
            for i in range(int(rng.integers(1, 4))):
                node(f"{z}-n{i}", cpu="16", mem="64Gi",
                     labels={"zone": z})
        node("bare", cpu="16", mem="64Gi")
        resident("resident", f"{SEQ_ZONES[1]}-n0", labels={"app": "app-0"})
        for g in range(int(rng.integers(3, 7))):
            size = int(rng.integers(1, 5))
            kind = int(rng.integers(0, 5))
            pods = []
            for k in range(size):
                p = pod(f"g{g}-p{k}", cpu=str(int(rng.integers(1, 5))),
                        mem=f"{int(rng.integers(1, 9))}Gi",
                        labels={"app": f"app-{g}"})
                term = api.AffinityTerm(
                    match_labels={"app": f"app-{g}"},
                    topology_key=("zone" if rng.random() < 0.5
                                  else "kubernetes.io/hostname"))
                if kind == 0:
                    p.affinity = [term]
                elif kind == 1:
                    p.anti_affinity = [term]
                elif kind == 2:
                    p.topology_spread = [("zone", 100)]
                elif kind == 3:
                    p.preferred_affinity = [(term, 50)]
                pods.append(p)
            gang(f"g{g}", pods, min_member=int(rng.integers(1, size + 1)))
    elif name == "profile runs":
        # Every pod asks 2 CPUs: one profile across the jobs.  g2 (min 8)
        # places four and fails; its rollback frees the nodes g3 takes.
        for i in range(4):
            node(f"n{i}", cpu="8", mem=f"{16 + 4 * i}Gi")
        for g, (size, mm) in enumerate([(6, 6), (5, 5), (9, 8), (4, 4),
                                        (3, 3), (2, 1)]):
            gang(f"g{g}", [pod(f"g{g}-{k}", cpu="2") for k in range(size)],
                 min_member=mm)
    elif name == "alternating profiles":
        # Two requests in alternating gangs, a selector gang between them.
        for i in range(5):
            node(f"n{i}", cpu=str(6 + i), mem="32Gi",
                 labels={"disk": "ssd" if i % 2 else "hdd"})
        for g in range(10):
            cpu = "1" if g % 2 else "3"
            sel = {"disk": "ssd"} if g == 4 else {}
            gang(f"g{g}", [pod(f"g{g}-{k}", cpu=cpu, node_selector=sel)
                           for k in range(3)], min_member=2)
    elif name == "terms between runs":
        # One profile before and after a gang that reads terms; the last
        # gang matches the anti-affinity term without reading one.
        for i in range(6):
            node(f"n{i}", cpu="16", mem="64Gi",
                 labels={"zone": SEQ_ZONES[i % 3]})
        gang("a", [pod(f"a{k}", cpu="2", labels={"app": "a"})
                   for k in range(4)])
        gang("b", [pod(f"b{k}", cpu="2", labels={"app": "b"},
                       anti_affinity=[api.AffinityTerm(
                           match_labels={"app": "b"},
                           topology_key="kubernetes.io/hostname")])
                   for k in range(3)])
        gang("c", [pod(f"c{k}", cpu="2", labels={"app": "a"})
                   for k in range(4)])
        gang("d", [pod(f"d{k}", cpu="2", labels={"app": "b"})
                   for k in range(3)])
        gang("e", [pod(f"e{k}", cpu="2", labels={"app": "b"},
                       affinity=[api.AffinityTerm(
                           match_labels={"app": "b"}, topology_key="zone")])
                   for k in range(2)])
    elif name == "many profiles":
        # 70 distinct requests (past the cap), then the first ten again.
        for i in range(8):
            node(f"n{i}", cpu="64", mem="256Gi", pods=64)
        for g in range(80):
            milli = 100 + 10 * (g % 70)
            gang(f"g{g}", [pod(f"g{g}-{k}", cpu=f"{milli}m")
                           for k in range(2)])
    elif name in ("scalar resources", "many scalar resources"):
        extra = (["nvidia.com/gpu"] if name == "scalar resources" else
                 ["nvidia.com/gpu", "example.com/fpga", "example.com/nic",
                  "example.com/ssd"])
        for i in range(5):
            alloc = {"cpu": "16", "memory": "64Gi", "pods": 32}
            for k, r in enumerate(extra):
                alloc[r] = str(2 + (i + k) % 3)
            store.add_node(api.Node(name=f"n{i}", allocatable=alloc))
        for g in range(8):
            want = {"cpu": str(1 + g % 3), "memory": "2Gi",
                    extra[g % len(extra)]: "1"}
            gang(f"g{g}", [api.Pod(name=f"g{g}-{k}", containers=[want])
                           for k in range(3)], min_member=2)
    elif name == "random":
        # test_oracle_parity.py's _random_store: heterogeneous nodes,
        # labels, taints, host ports, selectors, gangs, several queues.
        rng = np.random.default_rng(seed)
        n_nodes = int(rng.integers(4, 24))
        for i in range(n_nodes):
            labels = {"zone": SEQ_ZONES[i % 3]}
            if rng.random() < 0.3:
                labels["disk"] = "ssd"
            taints = []
            if rng.random() < 0.25:
                taints.append(api.Taint(key="dedicated", value="batch",
                                        effect="NoSchedule"))
            node(f"node-{i:03d}", cpu=str(int(rng.integers(4, 33))),
                 mem=f"{int(rng.integers(8, 65))}Gi",
                 pods=int(rng.integers(4, 64)), labels=labels,
                 taints=taints)
        for q in range(1, int(rng.integers(1, 4))):
            store.add_queue(api.Queue(name=f"queue-{q}",
                                      weight=int(rng.integers(1, 5))))
        queues = ["default"] + [q for q in store.snapshot().queues
                                if q != "default"]
        for g in range(int(rng.integers(2, 14))):
            size = int(rng.integers(1, 6))
            min_member = int(rng.integers(1, size + 1))
            q = str(rng.choice(queues))
            pods = []
            for k in range(size):
                selector = {}
                if rng.random() < 0.3:
                    selector["zone"] = str(rng.choice(SEQ_ZONES))
                tolerations = []
                if rng.random() < 0.4:
                    tolerations.append(api.Toleration(
                        key="dedicated", operator="Equal", value="batch",
                        effect="NoSchedule"))
                ports = []
                if rng.random() < 0.25:
                    ports.append(int(rng.choice([8080, 9090, 9100])))
                pods.append(pod(
                    f"pg-{g:03d}-{k}", cpu=str(int(rng.integers(1, 9))),
                    mem=f"{int(rng.integers(1, 17))}Gi",
                    node_selector=selector, tolerations=tolerations,
                    host_ports=ports, priority=int(rng.integers(0, 3))))
            gang(f"pg-{g:03d}", pods, min_member=min_member, queue=q)
    else:
        raise KeyError(name)
    return store


def seq_extra(args, seed):
    """[P, N] custom-plugin planes for a solve: verdicts (30% vetoes) and
    scores with three decimals, from a numpy seed."""
    P = np.asarray(args[1].req).shape[0]
    N = np.asarray(args[0].idle).shape[0]
    rng = np.random.default_rng(seed)
    ok = rng.random((P, N)) < 0.7
    score = np.round(rng.normal(0.0, 4.0, (P, N)), 3).astype(np.float32)
    return ok, score


# Every row plane the sequential solve's node loop reads (fields of
# ops.allocate.SeqInputs), listed here apart from the port's own list.
SEQ_PROFILE_PLANES = ("req", "init_req", "sel_bits", "aff_bits", "aff_terms",
                      "tol_bits", "pref_bits", "pref_w", "ports", "extra_ok",
                      "extra_score")


def seq_profile_reference(x, cap):
    """The profile of each row of ``x`` (a ``SeqInputs``) from numpy row
    equality alone: a real row that reads no inter-pod term has one; it
    takes the profile of the row before when their bytes over
    SEQ_PROFILE_PLANES are equal and that row has one, else it opens a run
    and takes the id its bytes first got (ids in order of first
    appearance, at most ``cap``; -1 past it).  [P] int64."""
    P = x.req.shape[0]
    planes = [np.ascontiguousarray(getattr(x, f).cpu().numpy())
              for f in SEQ_PROFILE_PLANES if getattr(x, f) is not None]
    rows = [b"".join(p[t].tobytes() for p in planes) for t in range(P)]
    reads = (x.t_req_aff.cpu().numpy() | x.t_req_anti.cpu().numpy()
             | (x.t_soft.cpu().numpy() != 0)).any(axis=1)
    prof = x.real.cpu().numpy() & ~reads
    ids, out = {}, np.full(P, -1, np.int64)
    for t in range(P):
        if not prof[t]:
            continue
        if t > 0 and prof[t - 1] and rows[t - 1] == rows[t]:
            out[t] = out[t - 1]
            continue
        if rows[t] not in ids and len(ids) < cap:
            ids[rows[t]] = len(ids)
        out[t] = ids.get(rows[t], -1)
    return out


def seq_plane_variant(x, plane, seed=0):
    """``x`` with equal custom-plugin rows (every row the same verdicts and
    scores, from a numpy seed) and one row t changed in ``plane`` alone
    (its first element: a float + 1, a bit flipped, a verdict negated),
    where rows t - 1 and t were equal profiled rows.  Returns (x', t)."""
    import torch

    P, N = x.req.shape[0], x.idle.shape[0]
    rng = np.random.default_rng(seed)
    ok = torch.from_numpy(np.tile(rng.random(N) < 0.9, (P, 1)))
    score = torch.from_numpy(np.tile(
        np.round(rng.normal(0.0, 1.0, N), 3).astype(np.float32), (P, 1)))
    x = x._replace(extra_ok=ok.to(x.req.device),
                   extra_score=score.to(x.req.device))
    ref = seq_profile_reference(x, cap=P)
    t = next(t for t in range(1, P) if ref[t] >= 0 and ref[t] == ref[t - 1])
    a = getattr(x, plane).clone()
    idx = (t,) + (0,) * (a.dim() - 1)
    if a.dtype == torch.bool:
        a[idx] = ~a[idx]
    elif a.is_floating_point():
        a[idx] = a[idx] + 1.0
    else:
        a[idx] = a[idx] ^ 1
    return x._replace(**{plane: a}), t


# ------------------------------------------------ the host victim walk

# The preempt + reclaim conf of the JAX package's legacy eviction suites
# (tests/test_fastpath_evict.py, test_evict_oracle.py,
# test_reclaim_multiqueue.py).
EVICT_CONF = """
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
  - name: binpack
"""

# tests/test_fastpath_evict.py's conf with preempt before allocate.
EVICT_CONF_INTERLEAVED = EVICT_CONF.replace(
    '"enqueue, allocate, preempt, reclaim, backfill"',
    '"enqueue, preempt, allocate, reclaim, backfill"',
)


def reset_uid_counters():
    """Restart both packages' uid and timestamp counters, so twin stores
    built one after the other carry the same uids (the walk's tie-breaks
    read them)."""
    import itertools
    import sys

    # A package not imported yet starts its counters at 1 when it is.
    for name in ("volcano_tpu.api.spec", "volcano_tpu_torch.api.spec"):
        spec = sys.modules.get(name)
        if spec is not None:
            spec._uid_counter = itertools.count(1)
            spec._ts_counter = itertools.count(1)


def oversubscribed_store(pkg, seed: int):
    """tests/test_evict_oracle.py's seed-deterministic oversubscribed
    cluster: running filler gangs (mixed sizes and min_member, some
    critical pods, some holding a claim) in a weight-1 victim queue
    (reclaimable for 80% of the seeds), pending high-priority gangs in a
    weight-9 queue, and for about half the seeds a second pending queue."""
    api = pkg.api
    rng = np.random.default_rng(seed)
    store = pkg.cache.ClusterStore()
    store.add_priority_class(api.PriorityClass(name="low", value=100))
    store.add_priority_class(api.PriorityClass(name="mid", value=1000))
    store.add_priority_class(api.PriorityClass(name="high", value=10000))
    store.add_queue(api.Queue(name="victim", weight=1,
                              reclaimable=bool(rng.random() < 0.8)))
    store.add_queue(api.Queue(name="premium", weight=9))
    second_queue = bool(rng.random() < 0.5)
    if second_queue:
        store.add_queue(api.Queue(name="premium2", weight=5))
    n_nodes = int(rng.integers(3, 9))
    node_cpu = int(rng.integers(16, 33))
    for i in range(n_nodes):
        store.add_node(api.Node(
            name=f"node-{i:03d}",
            allocatable={"cpu": str(node_cpu),
                         "memory": f"{node_cpu * 4}Gi", "pods": 64},
            topology={"topology.kubernetes.io/zone": f"zone-{i % 3}"},
        ))
    g = 0
    for i in range(n_nodes):
        budget = node_cpu
        while budget >= 4:
            size = int(rng.integers(1, 4))
            min_member = int(rng.integers(1, size + 1))
            cpu = int(rng.choice([4, 8]))
            if cpu > budget:
                cpu = 4
            if cpu * size > budget:
                size = budget // cpu
                min_member = min(min_member, size)
            prio_name, prio = ("mid", 1000) if rng.random() < 0.3 else (
                "low", 100)
            critical = rng.random() < 0.1
            pg = api.PodGroup(name=f"fill-{g:04d}", min_member=min_member,
                              queue="victim")
            store.add_pod_group(pg)
            for k in range(size):
                volumes = []
                if rng.random() < 0.1:
                    claim = f"claim-fill-{g:04d}-{k}"
                    store.put_pvc("default", claim, {"storage": "1Gi"})
                    volumes = [(claim, "/data")]
                store.add_pod(api.Pod(
                    name=f"fill-{g:04d}-{k}",
                    annotations={api.GROUP_NAME_ANNOTATION: pg.name},
                    containers=[{"cpu": str(cpu),
                                 "memory": f"{cpu * 2}Gi"}],
                    phase=api.PodPhase.Running,
                    node_name=f"node-{i:03d}",
                    volumes=volumes,
                    priority_class=(
                        "system-node-critical" if critical else prio_name
                    ),
                    priority=prio,
                ))
                budget -= cpu
                if budget < 0:
                    break
            g += 1
    for j in range(int(rng.integers(2, 6))):
        size = int(rng.integers(1, 4))
        qname = (
            "premium2" if second_queue and rng.random() < 0.5
            else "premium"
        )
        pg = api.PodGroup(name=f"hi-{j:03d}", min_member=size, queue=qname)
        store.add_pod_group(pg)
        for k in range(size):
            volumes = []
            if rng.random() < 0.2:
                claim = f"claim-hi-{j:03d}-{k}"
                store.put_pvc("default", claim, {"storage": "1Gi"})
                volumes = [(claim, "/data")]
            store.add_pod(api.Pod(
                name=f"hi-{j:03d}-{k}",
                annotations={api.GROUP_NAME_ANNOTATION: pg.name},
                containers=[{"cpu": str(int(rng.choice([8, 12]))),
                             "memory": "8Gi"}],
                volumes=volumes,
                priority_class="high",
                priority=10000,
            ))
    return store


def _fill(api, store, name, queue, node, cpu="8", memory="16Gi"):
    """One Running low-priority single-pod filler gang on ``node``."""
    pg = api.PodGroup(name=name, min_member=1, queue=queue)
    store.add_pod_group(pg)
    store.add_pod(api.Pod(
        name=f"{name}-0",
        annotations={api.GROUP_NAME_ANNOTATION: pg.name},
        containers=[{"cpu": cpu, "memory": memory}],
        phase=api.PodPhase.Running, node_name=node,
        priority_class="low", priority=100,
    ))


def _reclaimer(api, store, name, queue, cpu="8", memory="16Gi",
               ports=()):
    """One pending high-priority single-pod gang."""
    pg = api.PodGroup(name=name, min_member=1, queue=queue)
    store.add_pod_group(pg)
    store.add_pod(api.Pod(
        name=f"{name}-0",
        annotations={api.GROUP_NAME_ANNOTATION: pg.name},
        containers=[{"cpu": cpu, "memory": memory}],
        host_ports=list(ports),
        priority_class="high", priority=10000,
    ))


def _two_class_store(pkg, queues):
    api = pkg.api
    s = pkg.cache.ClusterStore()
    s.add_priority_class(api.PriorityClass(name="low", value=100))
    s.add_priority_class(api.PriorityClass(name="high", value=10000))
    for name, weight, reclaimable in queues:
        s.add_queue(api.Queue(name=name, weight=weight,
                              reclaimable=reclaimable))
    return s


def two_queue_store(pkg, n_nodes=6, hi_a=3, hi_b=3):
    """tests/test_reclaim_multiqueue.py's shape: a victim queue filling
    ``n_nodes`` 16-cpu nodes with 8-cpu pods; two pending premium queues
    (weights 6 and 3) of single-pod 8-cpu reclaimers."""
    api = pkg.api
    s = _two_class_store(pkg, [("victim", 1, True), ("prem-a", 6, True),
                               ("prem-b", 3, True)])
    for i in range(n_nodes):
        s.add_node(api.Node(name=f"n{i}",
                            allocatable={"cpu": "16", "memory": "64Gi",
                                         "pods": 64}))
        for k in range(2):
            _fill(api, s, f"fill-{i}-{k}", "victim", f"n{i}")
    for q, count in (("prem-a", hi_a), ("prem-b", hi_b)):
        for j in range(count):
            _reclaimer(api, s, f"{q}-hi-{j}", q)
    return s


def three_queue_store(pkg):
    """test_reclaim_multiqueue.py's three pending premium queues."""
    s = two_queue_store(pkg, n_nodes=8, hi_a=2, hi_b=2)
    s.add_queue(pkg.api.Queue(name="prem-c", weight=2))
    for j in range(2):
        _reclaimer(pkg.api, s, f"prem-c-hi-{j}", "prem-c")
    return s


def unreclaimable_store(pkg):
    """Victims in a reclaimable=False queue; two premium queues."""
    api = pkg.api
    s = _two_class_store(pkg, [("victim", 1, False), ("prem-a", 6, True),
                               ("prem-b", 3, True)])
    s.add_node(api.Node(name="n0", allocatable={"cpu": "16",
                                                "memory": "64Gi"}))
    for k in range(2):
        _fill(api, s, f"fill-{k}", "victim", "n0")
    for q in ("prem-a", "prem-b"):
        _reclaimer(api, s, f"{q}-hi", q)
    return s


def yield_bail_store(pkg):
    """Most reclaimers carry host ports: the native drive yields each to
    a Python turn and bails to the Python loop mid-stream."""
    api = pkg.api
    s = _two_class_store(pkg, [("victim", 1, True), ("prem-a", 6, True),
                               ("prem-b", 3, True)])
    for i in range(4):
        s.add_node(api.Node(name=f"n{i}",
                            allocatable={"cpu": "16", "memory": "64Gi",
                                         "pods": 64}))
        for k in range(2):
            _fill(api, s, f"fill-{i}-{k}", "victim", f"n{i}")
    idx = 0
    for q, count in (("prem-a", 3), ("prem-b", 3)):
        for j in range(count):
            ports = [9100 + idx] if idx % 4 != 3 else []
            idx += 1
            _reclaimer(api, s, f"{q}-hi-{j}", q, ports=ports)
    return s


def yield_path_store(pkg, seed):
    """test_evict_oracle.py's drive-yield store: half the reclaimers carry
    host ports."""
    api = pkg.api
    rng = np.random.default_rng(3000 + seed)
    s = _two_class_store(pkg, [("victim", 1, True), ("premium", 9, True)])
    for i in range(4):
        s.add_node(api.Node(
            name=f"node-{i:03d}",
            allocatable={"cpu": "16", "memory": "64Gi", "pods": 64}))
    g = 0
    for i in range(4):
        for _ in range(2):
            _fill(api, s, f"fill-{g:03d}", "victim", f"node-{i:03d}",
                  cpu=str(int(rng.choice([4, 8]))), memory="8Gi")
            g += 1
    for j in range(4):
        _reclaimer(api, s, f"hi-{j:03d}", "premium", memory="8Gi",
                   ports=[9000 + j] if j % 2 == 0 else [])
    return s


def scalar_store(pkg, seed):
    """test_evict_oracle.py's extended-scalar store: fillers and
    reclaimers with 0-2 ``tpu.dev/chips`` on 8-chip nodes."""
    api = pkg.api
    rng = np.random.default_rng(1000 + seed)
    s = _two_class_store(pkg, [("victim", 1, True), ("premium", 9, True)])
    for i in range(4):
        s.add_node(api.Node(
            name=f"node-{i:03d}",
            allocatable={"cpu": "16", "memory": "64Gi",
                         "tpu.dev/chips": 8}))
    g = 0
    for i in range(4):
        for _ in range(3):
            chips = int(rng.choice([0, 1, 2]))
            res = {"cpu": "4", "memory": "8Gi"}
            if chips:
                res["tpu.dev/chips"] = chips
            pg = api.PodGroup(name=f"fill-{g:03d}", min_member=1,
                              queue="victim")
            s.add_pod_group(pg)
            s.add_pod(api.Pod(
                name=f"fill-{g:03d}-0",
                annotations={api.GROUP_NAME_ANNOTATION: pg.name},
                containers=[res], phase=api.PodPhase.Running,
                node_name=f"node-{i:03d}",
                priority_class="low", priority=100,
            ))
            g += 1
    for j in range(3):
        chips = int(rng.choice([0, 2]))
        res = {"cpu": "8", "memory": "8Gi"}
        if chips:
            res["tpu.dev/chips"] = chips
        pg = api.PodGroup(name=f"hi-{j:03d}", min_member=1, queue="premium")
        s.add_pod_group(pg)
        s.add_pod(api.Pod(
            name=f"hi-{j:03d}-0",
            annotations={api.GROUP_NAME_ANNOTATION: pg.name},
            containers=[res], priority_class="high", priority=10000,
        ))
    return s


def rollback_store(pkg):
    """test_evict_oracle.py's statement-rollback store: a preemptor larger
    than its node even empty, two victims."""
    api = pkg.api
    s = _two_class_store(pkg, [("victim", 1, True), ("premium", 9, True)])
    s.add_node(api.Node(name="n0", allocatable={"cpu": "16",
                                                "memory": "32Gi"}))
    s.add_pod_group(api.PodGroup(name="fill", min_member=1, queue="victim"))
    for k in range(2):
        s.add_pod(api.Pod(
            name=f"fill-{k}",
            annotations={api.GROUP_NAME_ANNOTATION: "fill"},
            containers=[{"cpu": "8", "memory": "16Gi"}],
            phase=api.PodPhase.Running, node_name="n0",
            priority_class="low", priority=100,
        ))
    s.add_pod_group(api.PodGroup(name="huge", min_member=1,
                                 queue="premium"))
    s.add_pod(api.Pod(
        name="huge-0",
        annotations={api.GROUP_NAME_ANNOTATION: "huge"},
        containers=[{"cpu": "32", "memory": "64Gi"}],
        priority_class="high", priority=10000,
    ))
    return s


def tiny_priority_store(pkg):
    """tests/test_whatif_preempt.py:319's host-walk store: two low-priority
    pods filling a 4-cpu node, one pending high-priority pod."""
    api = pkg.api
    cache = pkg.cache
    store = cache.ClusterStore(evictor=cache.FakeEvictor(),
                               binder=cache.FakeBinder())
    store.add_node(api.Node(name="n1", allocatable={
        "cpu": "4", "memory": "8Gi", "pods": 110}))
    store.add_priority_class(api.PriorityClass(name="high", value=100))
    store.add_priority_class(api.PriorityClass(name="low", value=1))
    store.add_pod_group(api.PodGroup(name="lo", min_member=1,
                                     priority_class="low"))
    store.pod_groups["default/lo"].status.phase = \
        api.PodGroupPhase.Running.value
    for i in range(2):
        store.add_pod(api.Pod(
            name=f"lo-{i}", annotations={api.GROUP_NAME_ANNOTATION: "lo"},
            containers=[{"cpu": "2", "memory": "1Gi"}],
            phase=api.PodPhase.Running, node_name="n1", priority=1))
    store.add_pod_group(api.PodGroup(name="hi", min_member=1,
                                     priority_class="high"))
    store.add_pod(api.Pod(
        name="hi-0", annotations={api.GROUP_NAME_ANNOTATION: "hi"},
        containers=[{"cpu": "2", "memory": "1Gi"}], priority=100))
    return store


def tier_store(pkg, workers=4, serving=2):
    """``priority_tier_workload``: whole-node batch pods and a pending
    high-priority serving gang (tests/test_whatif_preempt.py:492)."""
    cache = pkg.cache
    store = cache.ClusterStore(evictor=cache.FakeEvictor(),
                               binder=cache.FakeBinder())
    pkg.sim.ClusterSimulator.priority_tier_workload(
        store, workers=workers, serving_tasks=serving)
    return store


def walk_run(pkg, build, conf=EVICT_CONF, cycles=1, grace=1,
             pipeline=False, async_bind=False, on_cycle=None, native=None,
             device="cpu"):
    """Twin run of the host victim walk: ``build(pkg)`` after the uid
    counters restart, then ``cycles`` x (``run_once()``, the simulator's
    step with ``grace`` Terminating ticks).  Per cycle: the uids the walk
    evicted and pipelined (read at the cycle-end flush, in order), the
    evictor's keys so far, the binds, the PodGroup phases and the mirror
    state (uid, status code, node).  ``on_cycle(store)`` adds a field.

    ``native`` picks the reclaim walk: the C++ engine (True) or the Python
    walk (False).  By default the port runs its engine and the JAX package
    its Python walk: the JAX package's native replay leaves the evicted
    rows out of the mirror's dirty set, so from the second cycle on its
    incremental aggregates still count them Running, and its own Python
    walk and the port's engine agree with each other and not with it.
    ``device`` is the port's (None: the card)."""
    import importlib
    import os

    fe = importlib.import_module(f"{pkg.__name__}.fastpath_evict")
    is_jax = pkg.__name__ == "volcano_tpu"
    if native is None:
        native = not is_jax
    sim_mod = importlib.import_module(f"{pkg.__name__}.sim")
    sched_mod = importlib.import_module(f"{pkg.__name__}.scheduler")
    reset_uid_counters()
    store = build(pkg)
    store.pipeline = pipeline
    store.async_bind = async_bind
    kw = {} if is_jax else {"device": device}
    sched = sched_mod.Scheduler(store, conf_str=conf, **kw)
    sim = sim_mod.ClusterSimulator(store, grace_steps=grace)
    seen = []
    orig = fe.EvictState.flush
    setup = fe.FastEvictor._native_reclaim_setup
    no_native = os.environ.get("VOLCANO_TPU_NO_NATIVE")

    def spy(st):
        m = st.cyc.m
        seen.append(([m.p_uid[r] for r in st.evicted_rows],
                     [m.p_uid[r]
                      for r in getattr(st, "pipelined_rows", ())]))
        return orig(st)

    out = []
    try:
        fe.EvictState.flush = spy
        if native:
            os.environ.pop("VOLCANO_TPU_NO_NATIVE", None)
        elif is_jax:
            fe.FastEvictor._native_reclaim_setup = lambda self: None
        else:
            os.environ["VOLCANO_TPU_NO_NATIVE"] = "1"
        for _ in range(cycles):
            seen.clear()
            sched.run_once()
            if async_bind:
                assert store.flush_binds(timeout=30)
            ev, pipe = seen[0] if seen else ([], [])
            rec = {
                "evicted": ev,
                "pipelined": pipe,
                "evicts": sorted(getattr(store.evictor, "evicts", [])),
                "binds": dict(store.binder.binds),
                "phases": {uid: pg.status.phase
                           for uid, pg in sorted(store.pod_groups.items())},
                "mirror": mirror_state(store),
            }
            if on_cycle is not None:
                rec.update(on_cycle(store))
            out.append(rec)
            sim.step()
    finally:
        fe.EvictState.flush = orig
        fe.FastEvictor._native_reclaim_setup = setup
        if no_native is None:
            os.environ.pop("VOLCANO_TPU_NO_NATIVE", None)
        else:
            os.environ["VOLCANO_TPU_NO_NATIVE"] = no_native
        store.close()
    return out
