"""Controller-plane API types: the batch Job spec, lifecycle policies, the
command bus, and reconcile requests.

Mirrors ``pkg/apis/batch/v1alpha1/job.go`` (Job/TaskSpec/LifecyclePolicy/
JobStatus, 10 JobPhases), ``pkg/apis/bus/v1alpha1`` (Action/Event enums +
Command), and ``pkg/controllers/apis`` (Request).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import new_timestamp, new_uid

DEFAULT_MAX_RETRY = 3  # state/util.go:24


class Action(str, enum.Enum):
    """bus/v1alpha1/actions.go:22-60."""

    AbortJob = "AbortJob"
    RestartJob = "RestartJob"
    RestartTask = "RestartTask"
    TerminateJob = "TerminateJob"
    CompleteJob = "CompleteJob"
    ResumeJob = "ResumeJob"
    SyncJob = "SyncJob"
    Enqueue = "EnqueueJob"
    SyncQueue = "SyncQueue"
    OpenQueue = "OpenQueue"
    CloseQueue = "CloseQueue"


class Event(str, enum.Enum):
    """bus/v1alpha1/events.go:22-50."""

    Any = "*"
    PodFailed = "PodFailed"
    PodEvicted = "PodEvicted"
    Unknown = "Unknown"
    TaskCompleted = "TaskCompleted"
    OutOfSync = "OutOfSync"
    CommandIssued = "CommandIssued"
    JobUpdated = "JobUpdated"
    # Accelerator-native addition: device health is a first-class
    # failure event so lifecycle policies can react to chip/ICI degradation.
    DeviceUnhealthy = "DeviceUnhealthy"


class JobPhase(str, enum.Enum):
    """batch/v1alpha1/job.go:181-202."""

    Pending = "Pending"
    Aborting = "Aborting"
    Aborted = "Aborted"
    Running = "Running"
    Restarting = "Restarting"
    Completing = "Completing"
    Completed = "Completed"
    Terminating = "Terminating"
    Terminated = "Terminated"
    Failed = "Failed"


@dataclass
class LifecyclePolicy:
    """Event/ExitCode -> Action mapping (job.go:129-156)."""

    action: str = ""
    event: str = ""
    events: List[str] = field(default_factory=list)
    exit_code: Optional[int] = None
    timeout_seconds: Optional[float] = None

    def event_list(self) -> List[str]:
        events = list(self.events)
        if self.event:
            events.append(self.event)
        return events


@dataclass
class VolumeSpec:
    """A volume the job's pods mount (job.go:95-108 VolumeSpec).

    Exactly one of ``volume_claim_name`` (use an existing claim) or
    ``volume_claim`` (a claim spec the controller creates, e.g.
    ``{"storage": "10Gi"}``) should be set — the admission validator
    enforces the exclusivity (admit_job.go validateIO)."""

    mount_path: str
    volume_claim_name: str = ""
    volume_claim: Optional[Dict[str, object]] = None


@dataclass
class TaskSpec:
    """One task group of a Job (job.go:163-178)."""

    name: str
    replicas: int = 1
    # Pod template fields (subset of the framework Pod spec):
    containers: List[Dict[str, object]] = field(default_factory=list)
    init_containers: List[Dict[str, object]] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: list = field(default_factory=list)
    host_ports: List[int] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    policies: List[LifecyclePolicy] = field(default_factory=list)


@dataclass
class JobState:
    phase: str = JobPhase.Pending.value
    reason: str = ""
    message: str = ""
    last_transition: float = 0.0


@dataclass
class JobStatus:
    """job.go:224-268."""

    state: JobState = field(default_factory=JobState)
    min_available: int = 0
    pending: int = 0
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    terminating: int = 0
    unknown: int = 0
    version: int = 0
    retry_count: int = 0
    controlled_resources: Dict[str, str] = field(default_factory=dict)


@dataclass
class Job:
    """The batch Job record (job.go:46-93)."""

    name: str
    namespace: str = "default"
    uid: str = ""
    min_available: int = 0
    tasks: List[TaskSpec] = field(default_factory=list)
    volumes: List[VolumeSpec] = field(default_factory=list)
    policies: List[LifecyclePolicy] = field(default_factory=list)
    plugins: Dict[str, List[str]] = field(default_factory=dict)
    queue: str = "default"
    max_retry: int = DEFAULT_MAX_RETRY
    ttl_seconds_after_finished: Optional[float] = None
    priority_class: str = ""
    scheduler_name: str = "volcano-tpu"
    status: JobStatus = field(default_factory=JobStatus)
    creation_timestamp: float = 0.0
    deleting: bool = False
    finalizers: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.uid:
            self.uid = new_uid("job")
        if not self.creation_timestamp:
            self.creation_timestamp = new_timestamp()

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def total_tasks(self) -> int:
        return sum(t.replicas for t in self.tasks)


@dataclass
class Command:
    """Command bus record (bus/v1alpha1): user-issued action on a job/queue,
    owned by the target object."""

    action: str
    target_kind: str  # "Job" | "Queue"
    target_name: str
    target_namespace: str = "default"
    name: str = ""
    reason: str = ""
    message: str = ""

    def __post_init__(self):
        if not self.name:
            self.name = new_uid("cmd")


@dataclass
class Request:
    """Reconcile request (pkg/controllers/apis/request.go:25-35)."""

    namespace: str = ""
    job_name: str = ""
    task_name: str = ""
    queue_name: str = ""
    event: str = ""
    exit_code: int = 0
    action: str = ""
    job_version: int = 0
