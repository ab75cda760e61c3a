"""Framework-native spec records: Pod, Node, PodGroup, Queue.

These replace the Kubernetes objects the reference schedules
(v1.Pod / v1.Node, PodGroup and Queue CRDs from
``pkg/apis/scheduling/v1beta1/types.go:142-281``).  They are plain records in
the framework's own store (``volcano_tpu_torch.cache``); the scheduler and
controllers communicate only through that store, mirroring how the
reference's planes communicate only through the API server.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .resource import Resource
from .types import PodGroupPhase, QueueState, TaskStatus

# Annotation key binding a pod to its PodGroup, mirroring
# scheduling.k8s.io/group-name (v1beta1/types.go KubeGroupNameAnnotationKey).
GROUP_NAME_ANNOTATION = "scheduling.volcano-tpu/group-name"

# Per-gang fabric-topology constraint (PodGroup.topology equivalent for
# annotation-driven workloads): "prefer-contiguous" folds the selected
# fabric block into node ordering; "require-contiguous" refuses to bind
# the gang scattered across blocks (drop reason ``topology-infeasible``).
TOPOLOGY_ANNOTATION = "scheduling.volcano-tpu/topology"

# Fabric coordinate label keys, coarse -> fine.  ``rack`` and ``slice``
# define a contiguous placement block (an ICI slice / NVLink island
# within a rack); ``host`` rides along for forensics.  Canonical here so
# the wire schema (arrays.NodeArrays.fabric), the mirror planes
# (ops/topology), and synth all agree on the order.
FABRIC_RACK = "fabric.volcano-tpu/rack"
FABRIC_SLICE = "fabric.volcano-tpu/slice"
FABRIC_HOST = "fabric.volcano-tpu/host"
FABRIC_LEVELS: Tuple[str, ...] = (FABRIC_RACK, FABRIC_SLICE, FABRIC_HOST)
FABRIC_L = len(FABRIC_LEVELS)
TOPOLOGY_NONE = 0
TOPOLOGY_PREFER = 1
TOPOLOGY_REQUIRE = 2
_TOPOLOGY_CODES = {
    "": TOPOLOGY_NONE,
    "prefer-contiguous": TOPOLOGY_PREFER,
    "require-contiguous": TOPOLOGY_REQUIRE,
}


def topology_code(pg: "PodGroup") -> int:
    """Resolve a PodGroup's fabric constraint to its int code.  The
    explicit field wins; the annotation is the CRD-compatible fallback.
    Unknown values degrade to no-constraint (never block a bind on a
    typo)."""
    raw = pg.topology or pg.annotations.get(TOPOLOGY_ANNOTATION, "")
    return _TOPOLOGY_CODES.get(raw or "", TOPOLOGY_NONE)

# Critical-pod exemption set (conformance.go:44-66): system priority
# classes and the system namespace.  Canonical here — the conformance
# plugin, the evict machinery, and the mirror's p_critical column all
# consume these.
SYSTEM_CLUSTER_CRITICAL = "system-cluster-critical"
SYSTEM_NODE_CRITICAL = "system-node-critical"
SYSTEM_NAMESPACE = "kube-system"

_uid_counter = itertools.count(1)
_ts_counter = itertools.count(1)


def new_uid(prefix: str = "obj") -> str:
    return f"{prefix}-{next(_uid_counter)}"


def new_timestamp() -> float:
    """Monotonic logical creation timestamp for orderings."""
    return float(next(_ts_counter))


class PodPhase(str):
    Pending = "Pending"
    Running = "Running"
    Succeeded = "Succeeded"
    Failed = "Failed"
    Unknown = "Unknown"


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class AffinityTerm:
    """One pod-(anti)affinity term: select pods by labels within a topology
    domain (predicates.go:272-291 wraps the upstream equivalent)."""

    match_labels: Dict[str, str] = field(default_factory=dict)
    topology_key: str = "kubernetes.io/hostname"
    namespaces: List[str] = field(default_factory=list)  # empty = pod's own


@dataclass
class Pod:
    """The schedulable unit (equivalent of v1.Pod for the scheduler)."""

    name: str
    namespace: str = "default"
    uid: str = ""
    # Resource lists: name -> quantity (see Resource.from_resource_list).
    containers: List[Dict[str, object]] = field(default_factory=list)
    init_containers: List[Dict[str, object]] = field(default_factory=list)
    node_name: Optional[str] = None
    phase: str = PodPhase.Pending
    deleting: bool = False
    priority: Optional[int] = None
    priority_class: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    host_ports: List[int] = field(default_factory=list)
    affinity: List[AffinityTerm] = field(default_factory=list)
    anti_affinity: List[AffinityTerm] = field(default_factory=list)
    preferred_node_affinity: List[Tuple[Dict[str, str], int]] = field(
        default_factory=list
    )  # (required labels, weight) soft terms
    required_node_affinity: List[Dict[str, str]] = field(default_factory=list)
    # Soft inter-pod terms (upstream preferredDuringScheduling...): scored,
    # not gating (nodeorder.go:217-235 InterPodAffinity analog).
    preferred_affinity: List[Tuple["AffinityTerm", int]] = field(
        default_factory=list
    )
    preferred_anti_affinity: List[Tuple["AffinityTerm", int]] = field(
        default_factory=list
    )
    # Topology spread: (topology_key, weight) — softly prefer domains with
    # fewer pods of this pod's own job/PodGroup.
    topology_spread: List[Tuple[str, int]] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    # (claim_name, mount_path) pairs wired by the job controller from the
    # Job's VolumeSpecs (job_controller_util.go:56-78); the volume binder
    # gates the pod's bind on these claims.
    volumes: List[Tuple[str, str]] = field(default_factory=list)
    exit_code: int = 0
    creation_timestamp: float = 0.0
    # Batch-job bookkeeping (set by the job controller):
    owner_job: str = ""
    task_name: str = ""

    def __post_init__(self):
        if not self.uid:
            self.uid = new_uid("pod")
        if not self.creation_timestamp:
            self.creation_timestamp = new_timestamp()

    # ---------------------------------------------------------------- joins

    def job_id(self) -> str:
        """Job (PodGroup) this pod belongs to (job_info.go:56-64)."""
        gn = self.annotations.get(GROUP_NAME_ANNOTATION, "")
        if gn:
            return f"{self.namespace}/{gn}"
        return ""

    # ------------------------------------------------------------- resources

    def resource_request(self) -> Resource:
        """Sum of container requests (GetPodResourceWithoutInitContainers).

        Cached per Pod object: container lists are treated as immutable
        (updates replace the Pod), and callers clone() before mutating."""
        cached = getattr(self, "_req_cache", None)
        if cached is None:
            cached = Resource.empty()
            for c in self.containers:
                cached.add(Resource.from_resource_list(c))
            self._req_cache = cached
        return cached

    def init_resource_request(self) -> Resource:
        """max(max(init containers), sum(containers))
        (GetPodResourceRequest in pod_info.go).  Cached like
        resource_request."""
        cached = getattr(self, "_init_req_cache", None)
        if cached is None:
            cached = self.resource_request().clone()
            for ic in self.init_containers:
                cached.set_max_resource(Resource.from_resource_list(ic))
            self._init_req_cache = cached
        return cached

    def task_status(self) -> TaskStatus:
        """Map pod phase to TaskStatus (pod_info.go getTaskStatus)."""
        if self.phase == PodPhase.Running:
            return TaskStatus.Releasing if self.deleting else TaskStatus.Running
        if self.phase == PodPhase.Pending:
            if self.deleting:
                return TaskStatus.Releasing
            if self.node_name:
                return TaskStatus.Bound
            return TaskStatus.Pending
        if self.phase == PodPhase.Unknown:
            return TaskStatus.Unknown
        if self.phase == PodPhase.Succeeded:
            return TaskStatus.Succeeded
        if self.phase == PodPhase.Failed:
            return TaskStatus.Failed
        return TaskStatus.Unknown


@dataclass
class Node:
    """A worker node (equivalent of v1.Node)."""

    name: str
    allocatable: Dict[str, object] = field(default_factory=dict)
    capacity: Dict[str, object] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    ready: bool = True
    unschedulable: bool = False
    # TPU-native: slice topology coordinates used by placement scoring.
    topology: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        if not self.capacity:
            self.capacity = dict(self.allocatable)
        if self.topology:
            # Topology coordinates are labels (as on Kubernetes nodes), so
            # selectors, (anti)affinity, and spread resolve them through
            # the same machinery; explicit labels win on key collision.
            self.labels = {**self.topology, **self.labels}

    def allocatable_resource(self) -> Resource:
        return Resource.from_resource_list(self.allocatable)

    def capacity_resource(self) -> Resource:
        return Resource.from_resource_list(self.capacity)


@dataclass
class PodGroupCondition:
    type: str
    status: str
    transition_id: str = ""
    reason: str = ""
    message: str = ""


@dataclass
class PodGroupStatus:
    phase: str = PodGroupPhase.Pending.value
    conditions: List[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class PodGroup:
    """Gang unit (v1beta1/types.go:142-207)."""

    name: str
    namespace: str = "default"
    min_member: int = 0
    queue: str = "default"
    priority_class: str = ""
    min_resources: Optional[Dict[str, object]] = None
    status: PodGroupStatus = field(default_factory=PodGroupStatus)
    creation_timestamp: float = 0.0
    owner_job: str = ""
    # Disruption budget for the rebalance lane (PDB max_unavailable
    # equivalent): max members a migration wave may evict at once.
    # None -> the VOLCANO_TPU_REBALANCE_MAX_UNAVAIL default.
    max_unavailable: Optional[int] = None
    # Fabric-topology constraint: "" (none), "prefer-contiguous", or
    # "require-contiguous"; the TOPOLOGY_ANNOTATION key is the
    # annotation-driven equivalent (see topology_code()).
    topology: str = ""
    annotations: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        if not self.creation_timestamp:
            self.creation_timestamp = new_timestamp()

    @property
    def uid(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Queue:
    """Fair-share queue (v1beta1/types.go:228-281)."""

    name: str
    weight: int = 1
    capability: Dict[str, object] = field(default_factory=dict)
    reclaimable: bool = True
    state: str = QueueState.Open.value
    creation_timestamp: float = 0.0

    def __post_init__(self):
        if not self.creation_timestamp:
            self.creation_timestamp = new_timestamp()


@dataclass
class PriorityClass:
    name: str
    value: int = 0
    preemptable: bool = True


@dataclass
class ResourceQuota:
    """Namespace quota; carries the namespace weight annotation
    (api/namespace_info.go:33-37)."""

    name: str
    namespace: str = "default"
    annotations: Dict[str, str] = field(default_factory=dict)


NAMESPACE_WEIGHT_KEY = "volcano-tpu/namespace.weight"
