"""Statement: the gang-transactional operation buffer.

Mirrors ``pkg/scheduler/framework/statement.go``: Evict/Pipeline/Allocate
apply immediately to session state and are recorded; ``commit`` flushes the
side effects to the cache (evictions + binds), ``discard`` undoes the session
state in reverse order (unevict/unpipeline/unallocate).  Used by allocate
(commit iff JobReady, allocate.go:241-245) and preempt (commit iff
JobPipelined, preempt.go:131-137).
"""

from __future__ import annotations

import logging
from typing import List, Tuple

from ..api import TaskInfo, TaskStatus

log = logging.getLogger(__name__)


class Statement:
    def __init__(self, ssn):
        self.ssn = ssn
        self.operations: List[Tuple[str, tuple]] = []

    # ------------------------------------------------------------ recording

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Tentative evict: session state only (statement.go:40-77)."""
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.Releasing)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self.ssn._dispatch_events(reclaimee, allocate=False)
        self.operations.append(("evict", (reclaimee, reason)))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """Tentative pipeline (statement.go:126-166)."""
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.Pipelined)
        task.node_name = hostname
        node = self.ssn.nodes.get(hostname)
        if node is not None:
            node.add_task(task)
        self.ssn._dispatch_events(task, allocate=True)
        self.operations.append(("pipeline", (task, hostname)))

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        """Tentative allocate (statement.go:210-262)."""
        self.ssn.cache.allocate_volumes(task, hostname)
        job = self.ssn.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        job.update_task_status(task, TaskStatus.Allocated)
        task.node_name = hostname
        node = self.ssn.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        self.ssn._dispatch_events(task, allocate=True)
        self.operations.append(("allocate", (task, hostname)))

    # -------------------------------------------------------------- undo ops

    def _unevict(self, reclaimee: TaskInfo) -> None:
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.Running)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self.ssn._dispatch_events(reclaimee, allocate=True)

    def _unpipeline(self, task: TaskInfo) -> None:
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.Pending)
        hostname = task.node_name
        task.node_name = ""
        node = self.ssn.nodes.get(hostname)
        if node is not None:
            node.remove_task(task)
        self.ssn._dispatch_events(task, allocate=False)

    def _unallocate(self, task: TaskInfo) -> None:
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.Pending)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            node.remove_task(task)
        task.node_name = ""
        self.ssn._dispatch_events(task, allocate=False)

    # ------------------------------------------------------- commit/discard

    def discard(self) -> None:
        """Undo in reverse order (statement.go:324-346)."""
        for name, args in reversed(self.operations):
            try:
                if name == "evict":
                    self._unevict(args[0])
                elif name == "pipeline":
                    self._unpipeline(args[0])
                elif name == "allocate":
                    self._unallocate(args[0])
            except Exception:  # mirror Go: log and continue
                log.exception("Failed to undo %s", name)
        self.operations.clear()

    def commit(self) -> None:
        """Flush side effects (statement.go:349-367): evict -> cache.evict,
        allocate -> bind volumes + cache.bind (task becomes Binding)."""
        for name, args in self.operations:
            try:
                if name == "evict":
                    self.ssn.cache.evict(args[0], args[1])
                elif name == "pipeline":
                    pass  # no cache side effect
                elif name == "allocate":
                    task = args[0]
                    self.ssn.cache.bind_volumes(task)
                    self.ssn.cache.bind(task, task.node_name)
                    job = self.ssn.jobs.get(task.job)
                    if job is not None:
                        job.update_task_status(task, TaskStatus.Binding)
            except Exception:
                log.exception("Failed to commit %s", name)
        self.operations.clear()
