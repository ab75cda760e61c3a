"""Cluster simulator: the framework's "kind".

The counterpart of the JAX package's ``sim.py``: it plays the kubelet's
role against the in-memory store (bound pods start running, deleting pods
terminate through an optional grace window, optional completions), so job
lifecycles and eviction waves run hermetically at any scale.  Fault
injection (``fail_pod`` / ``fail_node``) is not ported yet.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

from .api import Pod, PodPhase
from .cache import ClusterStore


class ClusterSimulator:
    """Steps pod lifecycles: bound pods start running; deleting pods
    terminate (through an optional Terminating grace window); optional
    completion/failure injection.

    ``grace_steps``: eviction grace period in kubelet ticks.  A deleting
    pod passes through Terminating for that many steps before the delete
    lands and its capacity frees — the real capacity-not-yet-free window
    migration e2e must exercise (a rebalance eviction's node stays
    charged until termination completes, exactly as a kubelet honors
    terminationGracePeriodSeconds).  0 (the default) keeps the historic
    instant-delete behavior.
    """

    def __init__(self, store: ClusterStore, grace_steps: int = 0):
        self.store = store
        self.grace_steps = max(int(grace_steps), 0)
        # uid -> remaining Terminating ticks for deleting pods.
        self._terminating: Dict[str, int] = {}

    def step(
        self,
        complete: Optional[Callable[[Pod], Optional[int]]] = None,
    ) -> Dict[str, int]:
        """One kubelet tick.

        ``complete(pod)`` may return an exit code for running pods: 0 ->
        Succeeded, nonzero -> Failed, None -> keep running.
        Returns counts of transitions applied (``terminating`` counts
        deleting pods still inside their grace window this tick).
        """
        started = finished = deleted = terminating = 0
        # Snapshot under the store lock (`pods` is a guarded attribute
        # — the async bind dispatcher mutates it concurrently), then
        # step unlocked: the per-pod transitions below go through the
        # store's public API, which takes the lock itself.
        with self.store._lock:
            pods = list(self.store.pods.values())
        if self._terminating:  # skip the O(pods) set on the common path
            live = {p.uid for p in pods}
            for uid in list(self._terminating):
                if uid not in live:  # deleted out-of-band
                    del self._terminating[uid]
        for pod in pods:
            if pod.deleting:
                left = self._terminating.get(pod.uid)
                if left is None:
                    left = self.grace_steps
                if left > 0:
                    # Still Terminating: capacity stays charged.
                    self._terminating[pod.uid] = left - 1
                    terminating += 1
                    continue
                # Termination completes: the pod object goes away.
                self._terminating.pop(pod.uid, None)
                self.store.delete_pod(pod)
                deleted += 1
                continue
            if pod.phase == PodPhase.Pending and pod.node_name:
                updated = copy.copy(pod)
                updated.phase = PodPhase.Running
                self.store.update_pod(updated)
                started += 1
                continue
            if pod.phase == PodPhase.Running and complete is not None:
                code = complete(pod)
                if code is None:
                    continue
                updated = copy.copy(pod)
                updated.exit_code = int(code)
                updated.phase = (
                    PodPhase.Succeeded if code == 0 else PodPhase.Failed
                )
                self.store.update_pod(updated)
                finished += 1
        return {
            "started": started,
            "finished": finished,
            "deleted": deleted,
            "terminating": terminating,
        }

    @staticmethod
    def priority_tier_workload(store: ClusterStore, workers: int = 4,
                               node_cpu: str = "4", batch_cpu: str = "4",
                               serving_tasks: int = 2,
                               serving_cpu: str = "4",
                               serving_priority: int = 1000,
                               batch_priority: int = 10,
                               namespace: str = "default"
                               ) -> Dict[str, object]:
        """Populate ``store`` with the priority-tiered production mix
        the preempt lane is driven with (docs/preempt_reclaim.md):
        ``workers`` nodes each fully occupied
        by a Running low-priority batch pod (one single-member PodGroup
        per node, so per-group disruption budgets bite), plus a Pending
        high-priority serving gang of ``serving_tasks`` whole-node
        tasks that cannot bind until batch capacity is preempted.
        Driven with ``ClusterSimulator(store, grace_steps=N)`` the
        evicted batch pods pass through Terminating, so the serving
        gang exercises the real capacity-not-yet-free preemption
        window before it binds.

        Returns ``{"serving_group", "batch_groups", "nodes"}`` name
        lists for assertions."""
        from .api import (
            GROUP_NAME_ANNOTATION,
            Node,
            Pod,
            PodGroup,
            PodGroupPhase,
            PriorityClass,
        )

        store.add_priority_class(
            PriorityClass(name="tier-serving", value=serving_priority))
        store.add_priority_class(
            PriorityClass(name="tier-batch", value=batch_priority))
        nodes = []
        for i in range(workers):
            name = f"tier-n{i}"
            store.add_node(Node(name=name, allocatable={
                "cpu": node_cpu, "memory": "16Gi", "pods": 110}))
            nodes.append(name)
        batch_groups = []
        for i in range(workers):
            gname = f"batch{i}"
            store.add_pod_group(PodGroup(
                name=gname, namespace=namespace, min_member=1,
                priority_class="tier-batch"))
            store.pod_groups[
                f"{namespace}/{gname}"
            ].status.phase = PodGroupPhase.Running.value
            store.add_pod(Pod(
                name=f"batch-{i}", namespace=namespace,
                annotations={GROUP_NAME_ANNOTATION: gname},
                containers=[{"cpu": batch_cpu, "memory": "1Gi"}],
                phase=PodPhase.Running, node_name=f"tier-n{i}",
                priority=batch_priority,
            ))
            batch_groups.append(f"{namespace}/{gname}")
        store.add_pod_group(PodGroup(
            name="serving", namespace=namespace,
            min_member=serving_tasks, priority_class="tier-serving"))
        for i in range(serving_tasks):
            store.add_pod(Pod(
                name=f"serving-{i}", namespace=namespace,
                annotations={GROUP_NAME_ANNOTATION: "serving"},
                containers=[{"cpu": serving_cpu, "memory": "1Gi"}],
                priority=serving_priority,
            ))
        return {
            "serving_group": f"{namespace}/serving",
            "batch_groups": batch_groups,
            "nodes": nodes,
        }
