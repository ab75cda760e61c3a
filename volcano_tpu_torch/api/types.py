"""Core enums and callback type conventions.

Mirrors the reference's ``pkg/scheduler/api/types.go`` (TaskStatus bit values,
NodePhase) and ``pkg/apis/scheduling/v1beta1/types.go`` (PodGroup/Queue
phases).  Status values are kept identical to the Go iota bit-shifts so that
snapshots/int8 encodings are stable and comparable in tests.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional


class TaskStatus(enum.IntEnum):
    """Status of a task/pod (types.go:26-58)."""

    Pending = 1 << 0
    Allocated = 1 << 1
    Pipelined = 1 << 2
    Binding = 1 << 3
    Bound = 1 << 4
    Running = 1 << 5
    Releasing = 1 << 6
    Succeeded = 1 << 7
    Failed = 1 << 8
    Unknown = 1 << 9


def allocated_status(status: TaskStatus) -> bool:
    """True for statuses that hold node resources (api/helpers.go:64-71)."""
    return status in (
        TaskStatus.Bound,
        TaskStatus.Binding,
        TaskStatus.Running,
        TaskStatus.Allocated,
    )


class NodePhase(enum.IntEnum):
    """Phase of a node (types.go:86-93)."""

    Ready = 1 << 0
    NotReady = 1 << 1


class PodGroupPhase(str, enum.Enum):
    """Phase of a PodGroup (apis/scheduling/v1beta1/types.go:42-57)."""

    Pending = "Pending"
    Running = "Running"
    Unknown = "Unknown"
    Inqueue = "Inqueue"


class QueueState(str, enum.Enum):
    """State of a Queue (apis/scheduling/v1beta1/types.go:30-39)."""

    Open = "Open"
    Closed = "Closed"
    Closing = "Closing"
    Unknown = "Unknown"


@dataclass
class ValidateResult:
    """Result of an extended validation (types.go:121-125)."""

    pass_: bool
    reason: str = ""
    message: str = ""


# Reasons mirrored from apis/scheduling/v1beta1 constants.
NOT_ENOUGH_PODS_REASON = "NotEnoughPods"
NOT_ENOUGH_RESOURCES_REASON = "NotEnoughResources"
POD_GROUP_NOT_READY = "pod group is not ready"

# Fit error messages (api/unschedule_info.go).
NODE_RESOURCE_FIT_FAILED = "node(s) resource fit failed"
ALL_NODES_UNAVAILABLE = "all nodes are unavailable"


class FitError(Exception):
    """A task failed to fit on a node."""

    def __init__(self, task_name: str, node_name: str, reason: str):
        self.task_name = task_name
        self.node_name = node_name
        self.reason = reason
        super().__init__(f"task {task_name} on node {node_name}: {reason}")


@dataclass
class FitErrors:
    """Aggregation of per-node fit errors (api/unschedule_info.go:22-110)."""

    nodes: Dict[str, str] = field(default_factory=dict)
    error: Optional[str] = None

    def set_node_error(self, node_name: str, err: object) -> None:
        self.nodes[node_name] = str(err)

    def set_error(self, msg: str) -> None:
        self.error = msg

    def __str__(self) -> str:
        if self.error:
            return self.error
        # Histogram of reasons, like FitErrors.Error().
        reasons: Dict[str, int] = {}
        for msg in self.nodes.values():
            reasons[msg] = reasons.get(msg, 0) + 1
        sorted_reasons = sorted(reasons.items(), key=lambda kv: -kv[1])
        return ", ".join(f"{cnt} {msg}" for msg, cnt in sorted_reasons)
