"""TTL garbage collector for finished Jobs (pkg/controllers/garbagecollector).

Jobs with ``ttl_seconds_after_finished`` set are deleted (with cascading
pod/PodGroup cleanup) once the TTL elapses after they finish
(garbagecollector.go:166-287, with the requeue-at-expiry loop collapsed to
a sweep over the store).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from ..cache import ClusterStore
from .apis import JobPhase

log = logging.getLogger(__name__)

FINISHED = (
    JobPhase.Completed.value,
    JobPhase.Failed.value,
    JobPhase.Terminated.value,
)


class GarbageCollector:
    def __init__(self, store: ClusterStore,
                 clock: Optional[Callable[[], float]] = None):
        self.store = store
        self.clock = clock or time.time
        # job key -> finish time observed
        self._finish_times = {}

    def sweep(self) -> int:
        """Delete expired finished jobs; returns number collected."""
        now = self.clock()
        collected = 0
        for key, job in list(self.store.batch_jobs.items()):
            if job.ttl_seconds_after_finished is None:
                continue
            if job.status.state.phase not in FINISHED:
                self._finish_times.pop(key, None)
                continue
            finish = self._finish_times.setdefault(
                key, job.status.state.last_transition or now
            )
            if now - finish >= job.ttl_seconds_after_finished:
                log.info("TTL expired for job %s; deleting", key)
                self.store.delete_batch_job(key)
                self._finish_times.pop(key, None)
                collected += 1
        return collected
