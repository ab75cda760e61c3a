"""Binpack (best-fit) plugin (pkg/scheduler/plugins/binpack/binpack.go).

Score = sum over requested resources of weight_r * (used_r + request_r) /
capacity_r, normalized by the weight sum to [0, 10] and scaled by the global
binpack weight (binpack.go:200-260).  Per-resource weights (including
extended resources) come from plugin arguments (binpack.go:94-151).
"""

from __future__ import annotations

from typing import Dict

from ..api import CPU, MEMORY, NodeInfo, TaskInfo
from ..ops.scoring import MAX_PRIORITY

PLUGIN_NAME = "binpack"

BINPACK_WEIGHT = "binpack.weight"
BINPACK_CPU = "binpack.cpu"
BINPACK_MEMORY = "binpack.memory"
BINPACK_RESOURCES = "binpack.resources"  # comma-separated extended names
# per-resource: binpack.resources.<name>


class BinpackPlugin:
    def __init__(self, arguments):
        self.arguments = arguments
        self.weight = max(arguments.get_int(BINPACK_WEIGHT, 1), 1)
        self.cpu_weight = max(arguments.get_int(BINPACK_CPU, 1), 0)
        self.memory_weight = max(arguments.get_int(BINPACK_MEMORY, 1), 0)
        self.resource_weights: Dict[str, int] = {}
        for name in (arguments.get(BINPACK_RESOURCES) or "").split(","):
            name = name.strip()
            if not name:
                continue
            self.resource_weights[name] = max(
                arguments.get_int(f"{BINPACK_RESOURCES}.{name}", 1), 0
            )

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    def _resource_weight(self, resource: str):
        if resource == CPU:
            return self.cpu_weight, True
        if resource == MEMORY:
            return self.memory_weight, True
        if resource in self.resource_weights:
            return self.resource_weights[resource], True
        return 0, False

    def binpack_score(self, task: TaskInfo, node: NodeInfo) -> float:
        score = 0.0
        weight_sum = 0
        requested = task.resreq
        allocatable = node.allocatable
        used = node.used
        for resource in requested.resource_names():
            request = requested.get(resource)
            if request == 0:
                continue
            weight, found = self._resource_weight(resource)
            if not found:
                continue
            capacity = allocatable.get(resource)
            node_used = used.get(resource)
            if capacity > 0 and weight > 0:
                used_finally = request + node_used
                if used_finally <= capacity:
                    score += used_finally * weight / capacity
            weight_sum += weight
        if weight_sum > 0:
            score /= weight_sum
        return score * MAX_PRIORITY * self.weight

    def on_session_open(self, ssn) -> None:
        if self.weight == 0:
            return
        ssn.add_node_order_fn(
            self.name, lambda task, node: self.binpack_score(task, node)
        )

        def weights_fn():
            # Dense per-slot weights are resolved by the action against the
            # session's resource-slot layout.
            return {
                "binpack_weight": float(self.weight),
                "binpack_res": {
                    CPU: float(self.cpu_weight),
                    MEMORY: float(self.memory_weight),
                    **{k: float(v) for k, v in self.resource_weights.items()},
                },
            }

        ssn.add_score_weight_fn(self.name, weights_fn)

    def on_session_close(self, ssn) -> None:
        pass
