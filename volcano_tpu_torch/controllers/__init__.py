"""Controller plane: job lifecycle, podgroup wrapping, queues, GC.

``ControllerManager`` aggregates the controllers the reference's
vc-controller-manager starts (cmd/controller-manager/app/server.go).  The
controllers are host code over the store's records: they hold no tensor,
so the service runs them on a thread that never touches the card.
"""

from __future__ import annotations

from ..cache import ClusterStore
from .apis import (
    Action,
    Command,
    DEFAULT_MAX_RETRY,
    Event,
    Job,
    JobPhase,
    JobState,
    JobStatus,
    LifecyclePolicy,
    Request,
    TaskSpec,
    VolumeSpec,
)
from .gc import GarbageCollector
from .job_controller import JobController, apply_policies
from .pg_controller import PodGroupController
from .queue_controller import QueueController


class ControllerManager:
    """All controllers wired to one store; process() runs each to
    quiescence (one reconcile pump)."""

    def __init__(self, store: ClusterStore):
        self.store = store
        self.job_controller = JobController(store)
        self.pg_controller = PodGroupController(store)
        self.queue_controller = QueueController(store)
        self.gc = GarbageCollector(store)

    def process(self) -> None:
        self.pg_controller.process_all()
        self.job_controller.process_all()
        self.queue_controller.process_all()
        self.gc.sweep()


__all__ = [
    "Action",
    "Command",
    "ControllerManager",
    "DEFAULT_MAX_RETRY",
    "Event",
    "GarbageCollector",
    "Job",
    "JobController",
    "JobPhase",
    "JobState",
    "JobStatus",
    "LifecyclePolicy",
    "PodGroupController",
    "QueueController",
    "Request",
    "TaskSpec",
    "VolumeSpec",
    "apply_policies",
]
