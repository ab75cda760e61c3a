"""PodGroup controller (pkg/controllers/podgroup).

Auto-creates a gang-of-1 PodGroup for plain pods lacking one and
back-annotates the pod (pg_controller_handler.go:50,72-105), so bare pods
still flow through gang scheduling.
"""

from __future__ import annotations

import copy
import logging
from collections import deque

from ..api import GROUP_NAME_ANNOTATION, Pod, PodGroup
from ..cache import ClusterStore

log = logging.getLogger(__name__)


class PodGroupController:
    def __init__(self, store: ClusterStore):
        self.store = store
        self.queue = deque()
        store.watch(self._on_store_event)

    def _on_store_event(self, kind: str, event: str, obj) -> None:
        if kind == "Pod" and event == "add":
            if not obj.annotations.get(GROUP_NAME_ANNOTATION):
                self.queue.append(obj.uid)

    def process_all(self) -> None:
        while self.queue:
            uid = self.queue.popleft()
            pod = self.store.pods.get(uid)
            if pod is None or pod.annotations.get(GROUP_NAME_ANNOTATION):
                continue
            pg_name = f"podgroup-{pod.uid}"
            if f"{pod.namespace}/{pg_name}" not in self.store.pod_groups:
                self.store.add_pod_group(
                    PodGroup(
                        name=pg_name,
                        namespace=pod.namespace,
                        min_member=1,
                        priority_class=pod.priority_class,
                    )
                )
            updated = copy.copy(pod)
            updated.annotations = dict(pod.annotations)
            updated.annotations[GROUP_NAME_ANNOTATION] = pg_name
            self.store.update_pod(updated)
