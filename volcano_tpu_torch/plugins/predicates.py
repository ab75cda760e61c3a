"""Predicates plugin (pkg/scheduler/plugins/predicates/predicates.go).

Host-side per-(task, node) checks mirroring the wrapped upstream predicates:
pod-count, node unschedulable/ready, node selector + required node affinity,
taints/tolerations, host ports, and inter-pod (anti)affinity by topology
domain (predicates.go:144-293).  The device path evaluates the same checks
as [P, N] bitset tests in the solve kernels; this plugin flags
the session so the allocate action includes the static mask, and provides the
host fallback used by preempt/reclaim/backfill.
"""

from __future__ import annotations

from typing import Dict, List

from ..api import AffinityTerm, FitError, NodeInfo, TaskInfo

PLUGIN_NAME = "predicates"


def _labels_match(selector: Dict[str, str], labels: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def _tolerates(task: TaskInfo, taint) -> bool:
    for tol in task.pod.tolerations:
        if tol.operator == "Exists":
            key_ok = tol.key == "" or tol.key == taint.key
        else:
            key_ok = tol.key == taint.key and tol.value == taint.value
        eff_ok = tol.effect == "" or tol.effect == taint.effect
        if key_ok and eff_ok:
            return True
    return False


def _term_matches_anywhere(term: AffinityTerm, task: TaskInfo,
                           all_nodes) -> bool:
    """True when any resident pod in the term's namespaces matches its
    selector (used by the upstream self-match rule: a required affinity term
    with no match anywhere passes iff the incoming pod matches itself)."""
    namespaces = term.namespaces or [task.namespace]
    for other in all_nodes.values():
        for resident in other.tasks.values():
            if resident.namespace not in namespaces:
                continue
            if resident.uid == task.uid:
                continue
            if _labels_match(term.match_labels, resident.pod.labels):
                return True
    return False


def _affinity_domain_match(term: AffinityTerm, task: TaskInfo,
                           node: NodeInfo, all_nodes) -> bool:
    """True when some pod matching ``term`` runs in the same topology domain
    as ``node``."""
    if node.node is None:
        return False
    domain_value = node.node.labels.get(term.topology_key)
    namespaces = term.namespaces or [task.namespace]
    for other in all_nodes.values():
        if other.node is None:
            continue
        if term.topology_key == "kubernetes.io/hostname":
            same_domain = other.name == node.name
        else:
            same_domain = (
                domain_value is not None
                and other.node.labels.get(term.topology_key) == domain_value
            )
        if not same_domain:
            continue
        for resident in other.tasks.values():
            if resident.namespace not in namespaces:
                continue
            if resident.uid == task.uid:
                continue
            if _labels_match(term.match_labels, resident.pod.labels):
                return True
    return False


class PredicatesPlugin:
    def __init__(self, arguments):
        self.arguments = arguments

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        all_nodes = ssn.nodes

        def predicate_fn(task: TaskInfo, node: NodeInfo) -> None:
            if not node.ready():
                raise FitError(task.name, node.name,
                               f"node not ready: {node.state.reason}")
            spec = node.node
            if spec is not None and spec.unschedulable:
                raise FitError(task.name, node.name, "node unschedulable")
            # Pod count (CheckNodePodNumber).
            if node.allocatable.max_task_num > 0 and (
                len(node.tasks) >= node.allocatable.max_task_num
            ):
                raise FitError(task.name, node.name, "node pod number exceeded")
            # Node selector (PodMatchNodeSelector).
            if task.pod.node_selector and (
                spec is None
                or not _labels_match(task.pod.node_selector, spec.labels)
            ):
                raise FitError(task.name, node.name, "node selector mismatch")
            # Required node affinity: OR over alternative terms.
            terms = task.pod.required_node_affinity
            if terms:
                if spec is None or not any(
                    _labels_match(t, spec.labels) for t in terms
                ):
                    raise FitError(task.name, node.name,
                                   "node affinity mismatch")
            # Taints (PodToleratesNodeTaints): NoSchedule/NoExecute gate.
            if spec is not None:
                for taint in spec.taints:
                    if taint.effect not in ("NoSchedule", "NoExecute"):
                        continue
                    if not _tolerates(task, taint):
                        raise FitError(task.name, node.name,
                                       f"untolerated taint {taint.key}")
            # Host ports (PodFitsHostPorts).
            if task.pod.host_ports:
                used = {
                    p
                    for resident in node.tasks.values()
                    for p in resident.pod.host_ports
                }
                if any(p in used for p in task.pod.host_ports):
                    raise FitError(task.name, node.name, "host port conflict")
            # Inter-pod affinity / anti-affinity (topology-domain matching).
            for term in task.pod.affinity:
                if _affinity_domain_match(term, task, node, all_nodes):
                    continue
                # Self-match rule (upstream InterPodAffinityMatches): a term
                # with no matching pod anywhere passes iff the incoming pod
                # matches its own selector.
                self_ns = term.namespaces or [task.namespace]
                if not _term_matches_anywhere(term, task, all_nodes) and (
                    task.namespace in self_ns
                    and _labels_match(term.match_labels, task.pod.labels)
                ):
                    continue
                raise FitError(task.name, node.name,
                               "pod affinity not satisfied")
            for term in task.pod.anti_affinity:
                if _affinity_domain_match(term, task, node, all_nodes):
                    raise FitError(task.name, node.name,
                                   "pod anti-affinity violated")

        ssn.add_predicate_fn(self.name, predicate_fn)

        # Device contribution: the allocate action builds the [P,N] static
        # mask (ops.predicates.static_predicate_mask) when this plugin is
        # enabled — encoded directly from the snapshot arrays, so no
        # device-mask factory is registered here (that registry carries
        # OUT-OF-TREE mask contributions, session.add_device_mask_fn).

    def on_session_close(self, ssn) -> None:
        pass
