"""Predicate/prioritize helpers (pkg/scheduler/util/scheduler_helper.go).

The reference fans these out over 16 goroutines with adaptive node sampling
(scheduler_helper.go:43-183); the device allocate path replaces
them with one kernel, so these host versions serve the preempt/reclaim/backfill
paths where victim selection is per-node anyway.  Selection is deterministic
(first max) instead of random-among-max (scheduler_helper.go:201-212).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import FitErrors, NodeInfo, TaskInfo


def predicate_nodes(task: TaskInfo, nodes: List[NodeInfo],
                    predicate_fn) -> Tuple[List[NodeInfo], FitErrors]:
    """All nodes passing the predicate + aggregated fit errors."""
    feasible: List[NodeInfo] = []
    errors = FitErrors()
    for node in nodes:
        try:
            predicate_fn(task, node)
        except Exception as err:
            errors.set_node_error(node.name, err)
            continue
        feasible.append(node)
    return feasible, errors


def prioritize_nodes(task: TaskInfo, nodes: List[NodeInfo],
                     batch_fn, map_fn) -> Dict[float, List[NodeInfo]]:
    """score -> nodes map (PrioritizeNodes: map scores + batch scores)."""
    scores: Dict[str, float] = {n.name: 0.0 for n in nodes}
    for node in nodes:
        scores[node.name] += map_fn(task, node)
    for name, s in (batch_fn(task, nodes) or {}).items():
        if name in scores:
            scores[name] += s
    by_score: Dict[float, List[NodeInfo]] = {}
    for node in nodes:
        by_score.setdefault(scores[node.name], []).append(node)
    return by_score


def sort_nodes(node_scores: Dict[float, List[NodeInfo]]) -> List[NodeInfo]:
    out: List[NodeInfo] = []
    for score in sorted(node_scores.keys(), reverse=True):
        out.extend(node_scores[score])
    return out


def validate_victims(preemptor: TaskInfo, node: NodeInfo,
                     victims: List[TaskInfo]) -> None:
    """Raise unless the victims' resources satisfy the preemptor
    (scheduler_helper.go:224-239)."""
    if not victims:
        raise ValueError("no victims")
    future_idle = node.future_idle()
    for victim in victims:
        future_idle.add(victim.resreq)
    if not preemptor.init_resreq.less_equal(future_idle):
        raise ValueError(
            f"not enough resources: requested <{preemptor.init_resreq}>, "
            f"but future idle <{future_idle}>"
        )
