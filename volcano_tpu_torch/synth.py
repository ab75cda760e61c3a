"""Synthetic cluster generator + solver-arg builder.

The counterpart of the JAX package's ``synth.py``: ``synthetic_cluster``
draws the same cluster from the same seed (identical
``np.random.default_rng(seed)`` draws), ``tier_cluster`` builds the
100,000-node x 1,000,000-pod scale tier memory-frugally (the JAX package's
store for the same arguments), ``preempt_cluster`` builds the
oversubscribed-queue cluster of BASELINE config 4, ``fabric_cluster`` a
fragmented fabric of labeled blocks (``fabric_labels``) with a pending
topology-constrained gang, and ``solve_args_from_store``
encodes a store snapshot into the positional args of ``ops.wave.solve_wave``
as tensors on the chosen device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .api import (
    FABRIC_HOST,
    FABRIC_RACK,
    FABRIC_SLICE,
    GROUP_NAME_ANNOTATION,
    Node,
    Pod,
    PodGroup,
    Queue,
    TaskStatus,
)
from .arrays import encode_cluster
from .cache import ClusterStore


def fabric_labels(
    i: int,
    *,
    nodes_per_host: int = 2,
    hosts_per_slice: int = 8,
    slices_per_rack: int = 4,
) -> dict:
    """Deterministic fabric-coordinate labels for node index ``i``: the
    flat index mapped onto a rack / slice / host hierarchy (nodes_per_host
    per host board, hosts_per_slice hosts per slice, slices_per_rack slices
    per rack).  Slice and host ids are global, so every (rack, slice) pair
    the mirror interns is one physical slice."""
    host = i // max(nodes_per_host, 1)
    slc = host // max(hosts_per_slice, 1)
    rack = slc // max(slices_per_rack, 1)
    return {
        FABRIC_RACK: f"rack-{rack}",
        FABRIC_SLICE: f"slice-{slc}",
        FABRIC_HOST: f"host-{host}",
    }


def synthetic_cluster(
    n_nodes: int = 1000,
    n_pods: int = 10000,
    gang_size: int = 4,
    n_queues: int = 1,
    node_cpu: str = "64",
    node_mem: str = "256Gi",
    pod_cpu_choices: Sequence[str] = ("1", "2", "4"),
    pod_mem_choices: Sequence[str] = ("2Gi", "4Gi", "8Gi"),
    seed: int = 0,
    zones: int = 0,
    affinity_fraction: float = 0.0,
    anti_affinity_fraction: float = 0.0,
    spread_fraction: float = 0.0,
    queue_weights: Optional[Sequence[int]] = None,
    gang_sizes: Optional[Sequence[int]] = None,
    host_port_fraction: float = 0.0,
) -> ClusterStore:
    """A cluster of identical nodes and gang jobs with mixed pod sizes.

    ``zones`` > 0 labels nodes round-robin with zone labels;
    ``affinity_fraction``/``anti_affinity_fraction``/``spread_fraction``
    give that share of gangs required zone affinity to their own app label,
    required hostname anti-affinity, or soft zone topology spread
    (BASELINE config 5's inter-pod affinity / topology-spread mix).
    ``gang_sizes`` draws each gang's size from the sequence (config 3's
    mixed TF/MPI shapes) instead of the fixed ``gang_size``.
    ``host_port_fraction`` gives that share of gangs a host port, 8000 +
    (gang index mod 16), a quarter of them also 9090, drawn from a second
    generator so the cluster is otherwise the one the same seed builds
    without ports.
    """
    from .api import AffinityTerm

    rng = np.random.default_rng(seed)
    port_rng = np.random.default_rng([seed, 1])
    store = ClusterStore()
    for i in range(n_nodes):
        labels = {}
        if zones > 0:
            labels["zone"] = f"zone-{i % zones}"
        store.add_node(
            Node(
                name=f"node-{i:06d}",
                allocatable={"cpu": node_cpu, "memory": node_mem, "pods": 256},
                labels=labels,
            )
        )
    for q in range(1, n_queues):
        weight = (
            queue_weights[q % len(queue_weights)]
            if queue_weights else int(rng.integers(1, 9))
        )
        store.add_queue(Queue(name=f"queue-{q}", weight=weight))
    queues = ["default"] + [f"queue-{q}" for q in range(1, n_queues)]

    g = 0
    pods_made = 0
    while pods_made < n_pods:
        size = (
            int(rng.choice(gang_sizes)) if gang_sizes else gang_size
        )
        size = min(size, n_pods - pods_made) or 1
        queue = queues[g % len(queues)]
        pg = PodGroup(name=f"pg-{g:06d}", min_member=size, queue=queue)
        store.add_pod_group(pg)
        cpu = str(rng.choice(pod_cpu_choices))
        mem = str(rng.choice(pod_mem_choices))
        app = f"app-{g:06d}"
        r = rng.random()
        affinity = anti_affinity = None
        spread = None
        if zones > 0 and r < affinity_fraction:
            affinity = [AffinityTerm(match_labels={"app": app},
                                     topology_key="zone")]
        elif r < affinity_fraction + anti_affinity_fraction:
            anti_affinity = [AffinityTerm(
                match_labels={"app": app},
                topology_key="kubernetes.io/hostname",
            )]
        elif zones > 0 and r < (affinity_fraction + anti_affinity_fraction
                                + spread_fraction):
            spread = [("zone", 10)]
        ports = []
        if host_port_fraction > 0 and port_rng.random() < host_port_fraction:
            ports = ([8000 + g % 16]
                     + ([9090] if port_rng.random() < 0.25 else []))
        for k in range(size):
            store.add_pod(
                Pod(
                    name=f"pg-{g:06d}-{k}",
                    labels={"app": app},
                    annotations={GROUP_NAME_ANNOTATION: pg.name},
                    containers=[{"cpu": cpu, "memory": mem}],
                    affinity=affinity or [],
                    anti_affinity=anti_affinity or [],
                    topology_spread=spread or [],
                    host_ports=ports,
                )
            )
            pods_made += 1
        g += 1
    return store


def tier_cluster(
    n_nodes: int = 100_000,
    n_pods: int = 1_000_000,
    gang_size: int = 8,
    zones: int = 32,
    n_queues: int = 4,
    node_cpu: str = "64",
    node_mem: str = "256Gi",
    pod_cpu_choices: Sequence[str] = ("1", "2", "4"),
    pod_mem_choices: Sequence[str] = ("2Gi", "4Gi", "8Gi"),
    seed: int = 0,
    chunk_pods: int = 50_000,
) -> ClusterStore:
    """The 100k-node x 1M-pod scale tier, built memory-frugally.

    ``synthetic_cluster`` allocates one containers list, one labels
    dict, and one annotations dict PER POD — ~5 host objects per row,
    which at 1M pods costs gigabytes of Python-object overhead before
    the first solve runs.  This builder fills the pod table in chunks
    with shared sub-objects so the big shape is buildable on CI-class
    hosts:

    - one containers list per distinct (cpu, mem) shape, shared by
      reference across every pod of that shape (the store treats pod
      specs as immutable — nothing mutates a containers list);
    - one annotations dict per GANG (the group-name annotation is the
      only entry and it is per-gang, not per-pod);
    - explicit uids/creation timestamps (skips the per-pod uuid and
      clock reads, and keeps task order deterministic);
    - ``chunk_pods``-sized fill chunks with a GC pass between chunks,
      bounding the transient allocation spike of the builder itself.

    Pods carry no labels/affinity — the tier measures the solve's
    scale envelope (fit/score/ranking over 100k nodes x 1M rows); the
    affinity mix rides the existing hyperscale config.  Nodes spread
    over ``zones`` zone labels so node classes stay > 1, and carry
    deterministic ``fabric.volcano-tpu/*`` coordinates so
    the tier and the endurance harness exercise the topology planes.
    Fabric labels are never *queried* by any pod, so they add no label
    bits to the fast path's mirror and leave node classes untouched.

    The same arguments build the same store as the JAX package's
    ``tier_cluster``: the same names, uids, timestamps and draws.
    """
    import gc

    rng = np.random.default_rng(seed)
    store = ClusterStore()
    zone_labels = [{"zone": f"zone-{z}"} for z in range(max(zones, 1))]
    for i in range(n_nodes):
        labels = dict(fabric_labels(i))
        if zones:
            labels.update(zone_labels[i % len(zone_labels)])
        store.add_node(
            Node(
                name=f"node-{i:06d}",
                allocatable={"cpu": node_cpu, "memory": node_mem,
                             "pods": 256},
                labels=labels,
            )
        )
    for q in range(1, n_queues):
        store.add_queue(Queue(name=f"queue-{q}",
                              weight=int(rng.integers(1, 9))))
    queues = ["default"] + [f"queue-{q}" for q in range(1, n_queues)]

    # Shared containers lists: one per distinct pod shape.
    shapes = [
        [{"cpu": cpu, "memory": mem}]
        for cpu in pod_cpu_choices for mem in pod_mem_choices
    ]
    shape_ids = rng.integers(0, len(shapes),
                             size=(n_pods // gang_size) + 1)
    g = 0
    pods_made = 0
    ts = 1.0
    while pods_made < n_pods:
        chunk_end = min(pods_made + chunk_pods, n_pods)
        while pods_made < chunk_end:
            size = min(gang_size, n_pods - pods_made) or 1
            pg = PodGroup(name=f"pg-{g:07d}", min_member=size,
                          queue=queues[g % len(queues)])
            store.add_pod_group(pg)
            anno = {GROUP_NAME_ANNOTATION: pg.name}  # shared per gang
            containers = shapes[int(shape_ids[g])]
            for k in range(size):
                ts += 1.0
                store.add_pod(
                    Pod(
                        name=f"pg-{g:07d}-{k}",
                        uid=f"tier-{g:07d}-{k}",
                        annotations=anno,
                        containers=containers,
                        creation_timestamp=ts,
                    )
                )
            pods_made += size
            g += 1
        gc.collect()
    return store


def fabric_cluster(
    racks: int = 2,
    slices_per_rack: int = 2,
    nodes_per_slice: int = 16,
    hosts_per_slice: int = 8,
    node_cpu: str = "4",
    node_mem: str = "16Gi",
    filler_cpu: str = "3",
    filler_mem: str = "1Gi",
    fillers_per_slice: int = 2,
    gang_tasks: int = 32,
    gang_cpu: str = "2",
    gang_mem: str = "1Gi",
    topology: str = "require-contiguous",
    binder=None,
) -> ClusterStore:
    """A fragmented fabric no single block can host the gang on.

    ``racks x slices_per_rack`` slices of ``nodes_per_slice`` nodes, labeled
    by ``fabric_labels``.  The first ``fillers_per_slice`` nodes of every
    slice run a single-member filler (its own PodGroup, so disruption
    budgets bite per filler) sized to strand its node for the gang's
    profile; the pending gang carries the ``topology`` constraint.

    At the defaults each slice has 14 free 4-cpu nodes, 28 two-cpu task
    slots < 32, so a require-contiguous 32-task gang fits no block while
    the free capacity (4 x 28 = 112) would place it scattered; draining
    one slice's two fillers frees the whole 16-node block, and the fillers
    re-place on any other slice.
    """
    from .api import PodPhase, PriorityClass

    store = ClusterStore(binder=binder)
    store.add_priority_class(PriorityClass(name="fabric-high", value=100))
    nodes_per_host = max(nodes_per_slice // max(hosts_per_slice, 1), 1)
    n_nodes = racks * slices_per_rack * nodes_per_slice
    for i in range(n_nodes):
        store.add_node(
            Node(
                name=f"fab-{i:04d}",
                allocatable={"cpu": node_cpu, "memory": node_mem,
                             "pods": 110},
                labels=fabric_labels(
                    i,
                    nodes_per_host=nodes_per_host,
                    hosts_per_slice=hosts_per_slice,
                    slices_per_rack=slices_per_rack,
                ),
            )
        )
    # Running fillers on the first fillers_per_slice nodes of every slice,
    # pre-bound so the fragmentation is deterministic.
    f = 0
    for s in range(racks * slices_per_rack):
        for k in range(fillers_per_slice):
            ni = s * nodes_per_slice + k
            store.add_pod_group(PodGroup(name=f"filler-{f:04d}",
                                         min_member=1))
            store.add_pod(
                Pod(
                    name=f"filler-{f:04d}-0",
                    annotations={GROUP_NAME_ANNOTATION: f"filler-{f:04d}"},
                    containers=[{"cpu": filler_cpu, "memory": filler_mem}],
                    phase=PodPhase.Running,
                    node_name=f"fab-{ni:04d}",
                )
            )
            f += 1
    pg = PodGroup(name="fabgang", min_member=gang_tasks,
                  topology=topology, priority_class="fabric-high")
    store.add_pod_group(pg)
    for k in range(gang_tasks):
        store.add_pod(
            Pod(
                name=f"fabgang-{k:03d}",
                annotations={GROUP_NAME_ANNOTATION: pg.name},
                containers=[{"cpu": gang_cpu, "memory": gang_mem}],
                priority_class="fabric-high",
                priority=100,
            )
        )
    return store


def preempt_cluster(
    n_nodes: int = 10000,
    fill_per_node: int = 4,
    n_pending: int = 20000,
    gang_size: int = 4,
    node_cpu: str = "64",
    node_mem: str = "256Gi",
    seed: int = 0,
) -> ClusterStore:
    """BASELINE config 4: oversubscribed queues with PriorityClass.

    A weight-1 "victim" queue holds running low-priority gangs filling
    ``fill_per_node`` x 16-cpu slots per node (all of a 64-cpu node); a
    weight-9 "premium" queue holds pending high-priority gangs that only fit
    by reclaiming from the victim queue (cross-queue) or preempting
    low-priority jobs (in-queue).
    """
    from .api import PodPhase, PriorityClass

    store = ClusterStore()
    store.add_priority_class(PriorityClass(name="low", value=100))
    store.add_priority_class(PriorityClass(name="high", value=10000))
    store.add_queue(Queue(name="victim", weight=1))
    store.add_queue(Queue(name="premium", weight=9))
    for i in range(n_nodes):
        store.add_node(
            Node(
                name=f"node-{i:06d}",
                allocatable={"cpu": node_cpu, "memory": node_mem, "pods": 256},
            )
        )
    # Running low-priority filler gangs, one per node slot.
    g = 0
    for i in range(n_nodes):
        for s in range(fill_per_node):
            pg = PodGroup(name=f"filler-{g:07d}", min_member=1,
                          queue="victim")
            store.add_pod_group(pg)
            store.add_pod(
                Pod(
                    name=f"filler-{g:07d}-0",
                    annotations={GROUP_NAME_ANNOTATION: pg.name},
                    containers=[{"cpu": "16", "memory": "48Gi"}],
                    phase=PodPhase.Running,
                    node_name=f"node-{i:06d}",
                    priority_class="low",
                    priority=100,
                )
            )
            g += 1
    # Pending high-priority gangs in the premium queue.
    for j in range(n_pending // gang_size):
        pg = PodGroup(name=f"hi-{j:06d}", min_member=gang_size,
                      queue="premium")
        store.add_pod_group(pg)
        for k in range(gang_size):
            store.add_pod(
                Pod(
                    name=f"hi-{j:06d}-{k}",
                    annotations={GROUP_NAME_ANNOTATION: pg.name},
                    containers=[{"cpu": "8", "memory": "16Gi"}],
                    priority_class="high",
                    priority=10000,
                )
            )
    return store


def solve_args_from_store(
    store: ClusterStore,
    binpack: bool = True,
    nodeorder: bool = False,
    device=None,
) -> Tuple[tuple, object]:
    """Encode a store snapshot into the positional args of
    ``ops.wave.solve_wave``, as tensors on ``device`` (the card unless the
    caller passes ``device="cpu"``; without a card the default raises).

    Returns (args, maps).  Orders jobs by id and tasks by creation; applies
    infinite deserved shares (no proportion gating).
    """
    from .arrays.affinity import encode_affinity
    from .device import resolve_device, tree_to
    from .ops.allocate import solve_inputs
    from .ops.scoring import default_weights

    dev = resolve_device(device)

    snap = store.snapshot()
    job_ids = sorted(snap.jobs.keys())
    pending = []
    kept_job_ids = []
    for jid in job_ids:
        job = snap.jobs[jid]
        tasks = sorted(
            job.task_status_index.get(TaskStatus.Pending, {}).values(),
            key=lambda t: (-t.priority, t.pod.creation_timestamp),
        )
        tasks = [t for t in tasks if not t.resreq.is_empty()]
        if not tasks:
            continue
        kept_job_ids.append(jid)
        pending.extend(tasks)
    arrays, maps = encode_cluster(snap, pending, kept_job_ids)
    aff = encode_affinity(
        snap, pending, maps.node_names,
        arrays.nodes.idle.shape[0], arrays.tasks.req.shape[0],
    )
    nodes, tasks, jobs, queues = solve_inputs(arrays)
    args = (
        nodes, tasks, jobs, queues,
        default_weights(maps.slots.width, binpack_enabled=binpack,
                        nodeorder_enabled=nodeorder),
        arrays.eps,
        arrays.scalar_slot,
        aff,
    )
    return tuple(tree_to(a, dev) for a in args), maps
