"""Host-side scheduling data model: Task/Job/Node/Queue/Namespace infos.

Mirrors the semantics of the reference's ``pkg/scheduler/api`` (job_info.go,
node_info.go, queue_info.go, namespace_info.go, cluster_info.go) on top of the
framework's own spec records (``volcano_tpu_torch.api.spec``), with no Kubernetes
dependency.  These objects are the authoritative system of record; the dense
device arrays (``volcano_tpu_torch.arrays``) are derived views.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .resource import Resource
from .spec import Pod, PodGroup, Queue
from .types import (
    FitErrors,
    NodePhase,
    PodGroupPhase,
    QueueState,
    TaskStatus,
    allocated_status,
)

DEFAULT_NAMESPACE_WEIGHT = 1  # api/namespace_info.go:28-31


def pod_key(pod: Pod) -> str:
    return f"{pod.namespace}/{pod.name}"


class TaskInfo:
    """All scheduler-facing info about one task (job_info.go:36-114)."""

    __slots__ = (
        "uid",
        "job",
        "name",
        "namespace",
        "resreq",
        "init_resreq",
        "node_name",
        "status",
        "priority",
        "volume_ready",
        "pod",
    )

    def __init__(self, pod: Pod):
        self.uid: str = pod.uid
        self.job: str = pod.job_id()
        self.name: str = pod.name
        self.namespace: str = pod.namespace
        # Resreq: run-time request; InitResreq: launch-time request (includes
        # init containers).  job_info.go:67-84.
        self.resreq: Resource = pod.resource_request().clone()
        self.init_resreq: Resource = pod.init_resource_request().clone()
        self.node_name: str = pod.node_name or ""
        self.status: TaskStatus = pod.task_status()
        self.priority: int = pod.priority if pod.priority is not None else 1
        self.volume_ready: bool = False
        self.pod: Pod = pod

    def clone(self) -> "TaskInfo":
        t = TaskInfo.__new__(TaskInfo)
        t.uid = self.uid
        t.job = self.job
        t.name = self.name
        t.namespace = self.namespace
        t.resreq = self.resreq.clone()
        t.init_resreq = self.init_resreq.clone()
        t.node_name = self.node_name
        t.status = self.status
        t.priority = self.priority
        t.volume_ready = self.volume_ready
        t.pod = self.pod
        return t

    def __repr__(self) -> str:
        return (
            f"Task ({self.uid}:{self.namespace}/{self.name}): job {self.job}, "
            f"status {self.status.name}, pri {self.priority}, resreq {self.resreq}"
        )


class JobInfo:
    """All scheduler-facing info about one job/PodGroup (job_info.go:125-389)."""

    def __init__(self, uid: str, *tasks: TaskInfo):
        self.uid: str = uid
        self.name: str = ""
        self.namespace: str = ""
        self.queue: str = ""
        self.priority: int = 0
        self.min_available: int = 0
        self.nodes_fit_delta: Dict[str, Resource] = {}
        self.job_fit_errors: str = ""
        self.nodes_fit_errors: Dict[str, FitErrors] = {}
        # status -> {task uid -> TaskInfo}
        self.task_status_index: Dict[TaskStatus, Dict[str, TaskInfo]] = {}
        # Incremental count of Pending tasks with empty InitResreq (they
        # count as "ready" in job_info.go:329-348); keeping it live makes
        # ready_task_num O(statuses) instead of O(tasks) — it sits inside
        # every job-order heap comparison.
        self._empty_pending: int = 0
        self.tasks: Dict[str, TaskInfo] = {}
        self.allocated: Resource = Resource.empty()
        self.total_request: Resource = Resource.empty()
        self.creation_timestamp: float = 0.0
        self.pod_group: Optional[PodGroup] = None
        for task in tasks:
            self.add_task_info(task)

    # ------------------------------------------------------------- pod group

    def set_pod_group(self, pg: PodGroup) -> None:
        self.name = pg.name
        self.namespace = pg.namespace
        self.min_available = pg.min_member
        self.queue = pg.queue
        self.creation_timestamp = pg.creation_timestamp
        self.pod_group = pg

    def unset_pod_group(self) -> None:
        self.pod_group = None

    # ----------------------------------------------------------------- tasks

    def _add_task_index(self, ti: TaskInfo) -> None:
        self.task_status_index.setdefault(ti.status, {})[ti.uid] = ti
        if ti.status == TaskStatus.Pending and ti.init_resreq.is_empty():
            self._empty_pending += 1

    def _delete_task_index(self, ti: TaskInfo) -> None:
        tasks = self.task_status_index.get(ti.status)
        if tasks is not None:
            removed = tasks.pop(ti.uid, None)
            if not tasks:
                del self.task_status_index[ti.status]
            if (
                removed is not None
                and ti.status == TaskStatus.Pending
                and removed.init_resreq.is_empty()
            ):
                self._empty_pending -= 1

    def add_task_info(self, ti: TaskInfo) -> None:
        self.tasks[ti.uid] = ti
        self._add_task_index(ti)
        self.total_request.add(ti.resreq)
        if allocated_status(ti.status):
            self.allocated.add(ti.resreq)

    def delete_task_info(self, ti: TaskInfo) -> None:
        task = self.tasks.get(ti.uid)
        if task is None:
            raise KeyError(
                f"failed to find task <{ti.namespace}/{ti.name}> "
                f"in job <{self.namespace}/{self.name}>"
            )
        self.total_request.sub(task.resreq)
        if allocated_status(task.status):
            self.allocated.sub(task.resreq)
        del self.tasks[task.uid]
        self._delete_task_index(task)

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        """Move a task to a new status (job_info.go:214-231)."""
        if task.uid in self.tasks:
            self.delete_task_info(task)
        task.status = status
        self.add_task_info(task)

    def clone(self) -> "JobInfo":
        info = JobInfo(self.uid)
        info.name = self.name
        info.namespace = self.namespace
        info.queue = self.queue
        info.priority = self.priority
        info.min_available = self.min_available
        info.pod_group = self.pod_group
        info.creation_timestamp = self.creation_timestamp
        for task in self.tasks.values():
            info.add_task_info(task.clone())
        return info

    # ------------------------------------------------------------- readiness

    def ready_task_num(self) -> int:
        """Tasks holding resources, succeeded, or zero-request pending
        (job_info.go:329-348)."""
        occupied = self._empty_pending
        for status, tasks in self.task_status_index.items():
            if allocated_status(status) or status == TaskStatus.Succeeded:
                occupied += len(tasks)
        return occupied

    def waiting_task_num(self) -> int:
        return len(self.task_status_index.get(TaskStatus.Pipelined, {}))

    def valid_task_num(self) -> int:
        occupied = 0
        for status, tasks in self.task_status_index.items():
            if (
                allocated_status(status)
                or status == TaskStatus.Succeeded
                or status == TaskStatus.Pipelined
                or status == TaskStatus.Pending
            ):
                occupied += len(tasks)
        return occupied

    def ready(self) -> bool:
        return self.ready_task_num() >= self.min_available

    def pipelined(self) -> bool:
        return self.waiting_task_num() + self.ready_task_num() >= self.min_available

    def fit_error(self) -> str:
        """Histogram message of task statuses (job_info.go:309-326)."""
        reasons: Dict[str, int] = {}
        for status, tasks in self.task_status_index.items():
            reasons[status.name] = reasons.get(status.name, 0) + len(tasks)
        reasons["minAvailable"] = self.min_available
        parts = sorted(f"{v} {k}" for k, v in reasons.items())
        return f"pod group is not ready, {', '.join(parts)}."

    def __repr__(self) -> str:
        return (
            f"Job ({self.uid}): namespace {self.namespace} ({self.queue}), "
            f"name {self.name}, minAvailable {self.min_available}"
        )


@dataclass
class NodeState:
    phase: NodePhase = NodePhase.NotReady
    reason: str = ""


class NodeInfo:
    """Node-level aggregated information (node_info.go:27-316)."""

    def __init__(self, node=None):
        from .spec import Node  # local import to avoid cycle in typing

        self.name: str = ""
        self.node: Optional[Node] = None
        self.state: NodeState = NodeState()
        self.releasing: Resource = Resource.empty()
        self.pipelined: Resource = Resource.empty()
        self.idle: Resource = Resource.empty()
        self.used: Resource = Resource.empty()
        self.allocatable: Resource = Resource.empty()
        self.capability: Resource = Resource.empty()
        self.tasks: Dict[str, TaskInfo] = {}
        self.others: Dict[str, object] = {}
        if node is not None:
            self.name = node.name
            self.node = node
            self.idle = node.allocatable_resource().clone()
            self.allocatable = node.allocatable_resource().clone()
            self.capability = node.capacity_resource().clone()
        self._set_node_state(node)

    def future_idle(self) -> Resource:
        """Idle + releasing - pipelined (node_info.go:53-58)."""
        return self.idle.clone().add(self.releasing).sub(self.pipelined)

    def ready(self) -> bool:
        return self.state.phase == NodePhase.Ready

    def _set_node_state(self, node) -> None:
        if node is None:
            self.state = NodeState(NodePhase.NotReady, "UnInitialized")
            return
        if not self.used.less_equal(node.allocatable_resource()):
            self.state = NodeState(NodePhase.NotReady, "OutOfSync")
            return
        if not node.ready:
            self.state = NodeState(NodePhase.NotReady, "NotReady")
            return
        self.state = NodeState(NodePhase.Ready, "")

    def set_node(self, node) -> None:
        """Re-point at a (possibly updated) node spec and re-derive resource
        accounting from resident tasks (node_info.go:158-190)."""
        self._set_node_state(node)
        if not self.ready():
            return
        self.name = node.name
        self.node = node
        self.allocatable = node.allocatable_resource().clone()
        self.capability = node.capacity_resource().clone()
        self.releasing = Resource.empty()
        self.pipelined = Resource.empty()
        self.idle = node.allocatable_resource().clone()
        self.used = Resource.empty()
        for ti in self.tasks.values():
            if ti.status == TaskStatus.Releasing:
                self.idle.sub(ti.resreq)
                self.releasing.add(ti.resreq)
                self.used.add(ti.resreq)
            elif ti.status == TaskStatus.Pipelined:
                self.pipelined.add(ti.resreq)
            else:
                self.idle.sub(ti.resreq)
                self.used.add(ti.resreq)

    def _allocate_idle(self, ti: TaskInfo) -> None:
        if not ti.resreq.less_equal(self.idle):
            raise ValueError("selected node NotReady")
        self.idle.sub(ti.resreq)

    def add_task(self, task: TaskInfo) -> None:
        """Add a task (a defensive copy) to this node (node_info.go:201-244)."""
        if task.node_name and self.name and task.node_name != self.name:
            raise ValueError(
                f"task <{task.namespace}/{task.name}> already on different "
                f"node <{task.node_name}>"
            )
        key = pod_key(task.pod)
        if key in self.tasks:
            raise ValueError(
                f"task <{task.namespace}/{task.name}> already on node <{self.name}>"
            )
        ti = task.clone()
        if self.node is not None:
            if ti.status == TaskStatus.Releasing:
                self._allocate_idle(ti)
                self.releasing.add(ti.resreq)
                self.used.add(ti.resreq)
            elif ti.status == TaskStatus.Pipelined:
                self.pipelined.add(ti.resreq)
            else:
                self._allocate_idle(ti)
                self.used.add(ti.resreq)
        task.node_name = self.name
        ti.node_name = self.name
        self.tasks[key] = ti

    def remove_task(self, ti: TaskInfo) -> None:
        key = pod_key(ti.pod)
        task = self.tasks.get(key)
        if task is None:
            raise KeyError(
                f"failed to find task <{ti.namespace}/{ti.name}> "
                f"on host <{self.name}>"
            )
        if self.node is not None:
            if task.status == TaskStatus.Releasing:
                self.releasing.sub(task.resreq)
                self.idle.add(task.resreq)
                self.used.sub(task.resreq)
            elif task.status == TaskStatus.Pipelined:
                self.pipelined.sub(task.resreq)
            else:
                self.idle.add(task.resreq)
                self.used.sub(task.resreq)
        del self.tasks[key]

    def update_task(self, ti: TaskInfo) -> None:
        self.remove_task(ti)
        self.add_task(ti)

    def clone(self) -> "NodeInfo":
        res = NodeInfo(self.node)
        res.name = self.name  # placeholder nodes (node is None) keep the name
        for task in self.tasks.values():
            t = task.clone()
            t.node_name = ""  # allow re-add to the clone
            res.add_task(t)
        res.others = self.others
        return res

    def pods(self) -> List[Pod]:
        return [t.pod for t in self.tasks.values()]

    def __repr__(self) -> str:
        return (
            f"Node ({self.name}): idle <{self.idle}>, used <{self.used}>, "
            f"releasing <{self.releasing}>, state <{self.state.phase.name}>"
        )


class QueueInfo:
    """Queue info (queue_info.go)."""

    def __init__(self, queue: Queue):
        self.uid: str = queue.name
        self.name: str = queue.name
        self.weight: int = queue.weight
        self.queue: Queue = queue

    def reclaimable(self) -> bool:
        return self.queue.reclaimable

    def clone(self) -> "QueueInfo":
        return QueueInfo(self.queue)


class NamespaceInfo:
    """Namespace weight info (api/namespace_info.go)."""

    def __init__(self, name: str, weight: int = DEFAULT_NAMESPACE_WEIGHT):
        self.name = name
        self.weight = weight

    def get_weight(self) -> int:
        if self.weight < 1:
            return DEFAULT_NAMESPACE_WEIGHT
        return self.weight


@dataclass
class ClusterInfo:
    """A deep-copied snapshot of cluster state (cluster_info.go)."""

    jobs: Dict[str, JobInfo] = field(default_factory=dict)
    nodes: Dict[str, NodeInfo] = field(default_factory=dict)
    queues: Dict[str, QueueInfo] = field(default_factory=dict)
    namespace_info: Dict[str, NamespaceInfo] = field(default_factory=dict)
