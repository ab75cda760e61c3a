"""Conformance plugin (pkg/scheduler/plugins/conformance/conformance.go).

Exempts critical pods (system priority classes / kube-system namespace) from
preempt and reclaim victim lists (conformance.go:44-66).
"""

from __future__ import annotations

from typing import List

from ..api import (
    SYSTEM_CLUSTER_CRITICAL,
    SYSTEM_NAMESPACE,
    SYSTEM_NODE_CRITICAL,
    TaskInfo,
)

PLUGIN_NAME = "conformance"


class ConformancePlugin:
    def __init__(self, arguments):
        self.arguments = arguments

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        def evictable_fn(evictor: TaskInfo,
                         evictees: List[TaskInfo]) -> List[TaskInfo]:
            victims = []
            for evictee in evictees:
                pc = evictee.pod.priority_class
                if (
                    pc in (SYSTEM_CLUSTER_CRITICAL, SYSTEM_NODE_CRITICAL)
                    or evictee.namespace == SYSTEM_NAMESPACE
                ):
                    continue
                victims.append(evictee)
            return victims

        ssn.add_preemptable_fn(self.name, evictable_fn)
        ssn.add_reclaimable_fn(self.name, evictable_fn)

    def on_session_close(self, ssn) -> None:
        pass
