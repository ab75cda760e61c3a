"""Cache side-effect interfaces and test fakes.

Mirrors ``pkg/scheduler/cache/interface.go:27-78`` (Cache, Binder, Evictor,
StatusUpdater, VolumeBinder) and the fakes in
``pkg/scheduler/util/test_utils.go:94-170`` that the reference's action tests
are built on.  Real deployments plug in binders that talk to the cluster
control plane; tests assert on the fake channels.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Protocol

from ..api import JobInfo, PodGroup, TaskInfo


class Binder(Protocol):
    """``bind`` must be idempotent for a (task, hostname) pair: the
    dispatcher re-drives individual binds after an indeterminate batch
    failure, so a key that already landed may be bound again to the
    same host (bindqueue.py worker)."""

    def bind(self, task: TaskInfo, hostname: str) -> None: ...


class Evictor(Protocol):
    def evict(self, pod) -> None: ...


class StatusUpdater(Protocol):
    def update_pod_condition(self, pod, condition) -> None: ...

    def update_pod_group(self, pg: PodGroup) -> None: ...


class VolumeBinder(Protocol):
    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None: ...

    def bind_volumes(self, task: TaskInfo) -> None: ...


class VolumeBindFailure(Exception):
    """Raised by a volume binder when a task's claims cannot be
    allocated/bound (missing claim, conflicting node).  The commit path
    treats the task like a failed bind: it reverts to Pending and
    retries next cycle."""


class EvictFailure(Exception):
    """Raised by an evictor when some evictions could not be dispatched.

    ``failed`` holds the "ns/name" keys that did NOT evict.  Both evict
    paths revert exactly those pods to Running (deleting flag cleared,
    mirror status restored) so the next preempt/reclaim cycle re-selects
    them — the reference's Evict-RPC error path resyncs the task from
    the API server the same way (cache.go:439-491 resyncTask)."""

    def __init__(self, failed):
        super().__init__(f"{len(failed)} evictions failed")
        self.failed = list(failed)


class BindFailure(Exception):
    """Raised by a binder when some binds could not be dispatched.

    ``failed`` holds the "ns/name" keys that did NOT bind.  The fast
    path reverts exactly those tasks to Pending so the next cycle
    retries them — the errTasks resync semantics of cache.go:627-649
    (there: failed bind RPCs push the task onto a rate-limited queue
    that re-syncs it from the API server)."""

    def __init__(self, failed):
        super().__init__(f"{len(failed)} binds failed")
        self.failed = list(failed)


class FakeBinder:
    """Records binds into a map + ordered channel (test_utils.go:94-117)."""

    def __init__(self):
        self.binds: Dict[str, str] = {}
        self.channel: List[str] = []
        self._lock = threading.Lock()

    def bind(self, task: TaskInfo, hostname: str) -> None:
        with self._lock:
            key = f"{task.namespace}/{task.name}"
            self.binds[key] = hostname
            self.channel.append(key)

    def bind_batch(self, pairs) -> None:
        """Batched dispatch used by the fast path (the async-goroutine
        bind fan-out of cache.go:536-552, collapsed into one call)."""
        with self._lock:
            for task, hostname in pairs:
                key = f"{task.namespace}/{task.name}"
                self.binds[key] = hostname
                self.channel.append(key)

    def bind_keys(self, keys, hostnames) -> None:
        """Key-level batched dispatch: the caller supplies precomputed
        "ns/name" keys, so the whole batch lands via C-level dict/list
        operations."""
        with self._lock:
            self.binds.update(zip(keys, hostnames))
            self.channel.extend(keys)


class FakeEvictor:
    """Records evictions (test_utils.go:119-143)."""

    def __init__(self):
        self.evicts: List[str] = []
        self.channel: List[str] = []
        self._lock = threading.Lock()

    def evict(self, pod) -> None:
        with self._lock:
            key = f"{pod.namespace}/{pod.name}"
            self.evicts.append(key)
            self.channel.append(key)


class FakeStatusUpdater:
    """No-op status updater (test_utils.go:145-157)."""

    def __init__(self):
        self.pod_conditions: List[object] = []
        self.pod_groups: List[PodGroup] = []

    def update_pod_condition(self, pod, condition) -> None:
        self.pod_conditions.append((pod, condition))

    def update_pod_group(self, pg: PodGroup) -> None:
        self.pod_groups.append(pg)

    def update_pod_groups(self, pgs) -> None:
        """Batched write-back (one call per session close).  Delegates
        per group so instance-level overrides of ``update_pod_group``
        (a common test seam) still observe every write; true batch
        transports (HttpStatusUpdater) override this wholesale."""
        for pg in pgs:
            self.update_pod_group(pg)


class FakeVolumeBinder:
    """No-op volume binder (test_utils.go:159-170)."""

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        return None

    def bind_volumes(self, task: TaskInfo) -> None:
        return None
