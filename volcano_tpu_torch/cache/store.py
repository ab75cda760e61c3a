"""In-memory cluster store: the scheduler cache (slim).

The event API (``add_node``, ``add_queue``, ``add_pod_group``, ``add_pod``,
``add_priority_class``) and the deep-copied ``snapshot()`` of the JAX
package's ``cache/store.py``, which mirrors ``pkg/scheduler/cache/cache.go``
(event handlers ``cache/event_handlers.go:178-731``, snapshot
``cache.go:652-730``).  The struct-of-arrays mirror, observability, journeys,
audit, bind queue, pipeline, lockdep and PVC records belong to the cycle
drivers and arrive with them.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..api import (
    ClusterInfo,
    JobInfo,
    NamespaceInfo,
    Node,
    NodeInfo,
    Pod,
    PodGroup,
    PriorityClass,
    Queue,
    QueueInfo,
    TaskInfo,
    TaskStatus,
)
from .interface import Binder, FakeBinder

DEFAULT_QUEUE = "default"


class ClusterStore:
    """Mutex-guarded cluster state + snapshotter."""

    def __init__(
        self,
        binder: Optional[Binder] = None,
        default_queue: str = DEFAULT_QUEUE,
    ):
        self._lock = threading.RLock()
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.priority_classes: Dict[str, PriorityClass] = {}
        self.namespace_weights: Dict[str, int] = {}
        self.pods: Dict[str, Pod] = {}
        self.pod_groups: Dict[str, PodGroup] = {}
        self.raw_queues: Dict[str, Queue] = {}
        self.binder: Binder = binder or FakeBinder()
        # The default queue exists from startup, weight 1
        # (cache.go:244-254).
        self.add_queue(Queue(name=default_queue, weight=1))

    # ------------------------------------------------------- job bookkeeping

    def _get_or_create_job(self, job_id: str) -> JobInfo:
        job = self.jobs.get(job_id)
        if job is None:
            job = JobInfo(job_id)
            self.jobs[job_id] = job
        return job

    def _add_task(self, pod: Pod) -> None:
        ti = TaskInfo(pod)
        if ti.job:
            self._get_or_create_job(ti.job).add_task_info(ti)
        # Terminated pods hold no node resources (event_handlers.go
        # isTerminated).
        if ti.status in (TaskStatus.Succeeded, TaskStatus.Failed):
            return
        if ti.node_name:
            node = self.nodes.get(ti.node_name)
            if node is None:
                # Task on an unknown node: hold a placeholder so accounting
                # catches up when the node arrives (event_handlers.go addTask).
                node = NodeInfo(None)
                node.name = ti.node_name
                self.nodes[ti.node_name] = node
            fresh = ti.clone()
            fresh.node_name = ""
            node.add_task(fresh)

    # ------------------------------------------------------------- handlers

    def add_pod(self, pod: Pod) -> None:
        """Track a pod.  Ungrouped pods still occupy node resources when
        bound (cache.go:320-332); they lack a schedulable job until a
        PodGroup wraps them."""
        with self._lock:
            self.pods[pod.uid] = pod
            self._add_task(pod)

    def add_node(self, node: Node) -> None:
        with self._lock:
            existing = self.nodes.get(node.name)
            if existing is not None:
                existing.set_node(node)
            else:
                self.nodes[node.name] = NodeInfo(node)

    def add_pod_group(self, pg: PodGroup) -> None:
        with self._lock:
            self.pod_groups[pg.uid] = pg
            job = self._get_or_create_job(pg.uid)
            job.set_pod_group(pg)
            if pg.priority_class and pg.priority_class in self.priority_classes:
                job.priority = self.priority_classes[pg.priority_class].value

    def add_queue(self, queue: Queue) -> None:
        with self._lock:
            self.raw_queues[queue.name] = queue
            self.queues[queue.name] = QueueInfo(queue)

    def add_priority_class(self, pc: PriorityClass) -> None:
        with self._lock:
            self.priority_classes[pc.name] = pc

    # -------------------------------------------------------------- snapshot

    def snapshot(self) -> ClusterInfo:
        """Deep-copied point-in-time view (cache.go:652-730)."""
        with self._lock:
            info = ClusterInfo()
            for name, node in self.nodes.items():
                info.nodes[name] = node.clone()
            for name, queue in self.queues.items():
                info.queues[name] = queue.clone()
            namespaces = set()
            for job_id, job in self.jobs.items():
                # Jobs without a PodGroup are not schedulable yet.
                if job.pod_group is None:
                    continue
                info.jobs[job_id] = job.clone()
                namespaces.add(job.namespace)
            for ns in namespaces:
                info.namespace_info[ns] = NamespaceInfo(
                    ns, self.namespace_weights.get(ns, 1)
                )
            return info
