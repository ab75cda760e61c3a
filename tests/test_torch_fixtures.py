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
