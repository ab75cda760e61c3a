"""The 100k-node x 1M-pod scale tier's builder on the port.

The twins of ``tests/test_scale_tier.py``'s generator and proxy-cycle
tests on ``volcano_tpu_torch.synth.tier_cluster`` (the port's cycle on the
CPU), and the same arguments through both packages' builders giving equal
stores: nodes, queues, PodGroups and pods field by field, in insertion
order.  The full shape stays ``slow``, as in the JAX file.
"""

import pytest

from test_torch_fixtures import plain, reset_uid_counters
from volcano_tpu_torch.synth import tier_cluster


def test_tier_generator_memory_frugal_sharing():
    """The chunked pod-table fill shares sub-objects: one annotations
    dict per gang, one containers list per pod shape."""
    store = tier_cluster(n_nodes=32, n_pods=256, gang_size=8, zones=4,
                         chunk_pods=64)
    pods = sorted(store.pods.values(), key=lambda p: p.name)
    assert len(pods) == 256
    by_gang = {}
    for p in pods:
        by_gang.setdefault(p.job_id(), []).append(p)
    assert len(by_gang) == 32
    for members in by_gang.values():
        first = members[0]
        for p in members[1:]:
            assert p.annotations is first.annotations
            assert p.containers is first.containers
    # Containers lists dedupe across gangs too (one per shape).
    distinct = {id(p.containers) for p in pods}
    assert len(distinct) <= 9  # |cpu choices| x |mem choices|
    store.close()


def test_tier_proxy_cycle_binds():
    """Scaled-down tier proxy: one full cycle on the port completes, every
    pod binds, no node over its allocatable, and the device snapshot's
    footprint stays within the modeled envelope."""
    from volcano_tpu_torch.scheduler import Scheduler

    store = tier_cluster(n_nodes=256, n_pods=2048, gang_size=8,
                         zones=8, chunk_pods=1024)
    Scheduler(store, device="cpu").run_once()
    bound = sum(1 for p in store.pods.values() if p.node_name)
    assert bound == 2048  # 256 x 64cpu swallows 2048 small pods
    for node in store.snapshot().nodes.values():
        assert node.idle.milli_cpu >= 0 and node.idle.memory >= 0
    snap = getattr(store, "device_snapshot", None)
    if snap is not None:
        assert 0 < snap.resident_bytes() < 32 * 1024 * 1024
    store.close()


def _digest(store):
    return {
        "nodes": [plain(n.node) for n in store.nodes.values()],
        "queues": [plain(q.queue) for q in store.queues.values()],
        "pod_groups": [plain(g) for g in store.pod_groups.values()],
        "pods": [plain(p) for p in store.pods.values()],
    }


@pytest.mark.parametrize("kw", [
    dict(n_nodes=40, n_pods=300, gang_size=8, zones=4, n_queues=4,
         chunk_pods=64, seed=0),
    dict(n_nodes=17, n_pods=101, gang_size=3, zones=0, n_queues=2,
         chunk_pods=25, seed=5),
    dict(n_nodes=64, n_pods=512, gang_size=16, zones=32, n_queues=1,
         pod_cpu_choices=("500m", "2"), pod_mem_choices=("1Gi",),
         chunk_pods=1000, seed=2),
])
def test_tier_cluster_equals_jax(kw):
    """Both packages' builders give equal stores for the same arguments."""
    import volcano_tpu.synth

    # The default queue's timestamp comes from a per-package counter.
    reset_uid_counters()
    jax_store = volcano_tpu.synth.tier_cluster(**kw)
    port_store = tier_cluster(**kw)
    want, got = _digest(jax_store), _digest(port_store)
    for key in want:
        assert len(want[key]) == len(got[key]), key
        assert want[key] == got[key], key
    assert len(got["pods"]) == kw["n_pods"]
    assert len(got["nodes"]) == kw["n_nodes"]
    jax_store.close()
    port_store.close()


@pytest.mark.slow
def test_tier_100k_x_1m_full_cycle_under_budget():
    """The full 100k x 1M shape on the port (CPU): the chunked build
    completes, one cycle binds a nonzero wave, and peak RSS stays under
    the modeled envelope."""
    import resource

    from volcano_tpu_torch.scheduler import Scheduler

    store = tier_cluster()  # 100_000 x 1_000_000
    assert len(store.pods) == 1_000_000
    Scheduler(store, device="cpu").run_once()
    bound = sum(1 for p in store.pods.values() if p.node_name)
    assert bound > 0
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    assert peak_gb < 64, f"peak RSS {peak_gb:.1f} GB exceeds the budget"
    store.close()
