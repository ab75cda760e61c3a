"""Session: the per-cycle scheduling context and plugin host.

Mirrors ``pkg/scheduler/framework/session.go`` + ``session_plugins.go``, as
the JAX package's ``framework/session.py``: a Session is built from a
deep-copied store snapshot, plugins register callbacks into tiered
registries, and actions dispatch through the tier semantics (victim-set
intersection for Preemptable/Reclaimable, veto chains for
JobReady/JobPipelined/JobValid/JobEnqueueable, first-nonzero comparator
chains for orderings, additive node scores).

Device-level additions: plugins also contribute the state the solve
kernels consume -- additive ``ScoreWeights``, per-queue ``deserved``
shares, and extra [P, N] mask factories -- so one solver call replaces the
per-(task, node) callback fan-out.  Host callbacks remain the semantic
reference and serve the preempt/reclaim victim logic.  The session carries
the device its solves run on (``device``, the store's ``device``: the card
unless the scheduler was built with ``device="cpu"``).

The process-wide counter numbers both the object sessions and the fast
path's cycles (``ssn-1``, ``ssn-2``, ...), so the two paths never reuse a
session uid.
"""

from __future__ import annotations

import itertools
import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..api import (
    ClusterInfo,
    JobInfo,
    NamespaceInfo,
    NodeInfo,
    PodGroupCondition,
    PodGroupPhase,
    QueueInfo,
    Resource,
    TaskInfo,
    TaskStatus,
    ValidateResult,
)
from .conf import Configuration, Tier

log = logging.getLogger(__name__)

_session_counter = itertools.count(1)


@dataclass
class Event:
    task: TaskInfo


@dataclass
class EventHandler:
    allocate_func: Optional[Callable[[Event], None]] = None
    deallocate_func: Optional[Callable[[Event], None]] = None


class Session:
    """One scheduling cycle's world view + plugin registries."""

    def __init__(self, cache, tiers: Sequence[Tier],
                 configurations: Sequence[Configuration] = ()):
        self.uid = f"ssn-{next(_session_counter)}"
        self.cache = cache
        self.device = getattr(cache, "device", None)
        self.tiers: List[Tier] = list(tiers)
        self.configurations: List[Configuration] = list(configurations)

        # Observability (obs/): the store's span tracer, so the
        # object path's snapshot / action / plugin boundaries land in
        # the same per-cycle trace the fast path records (a cache object
        # without one — bare test doubles — gets the shared no-op).
        from ..obs.trace import tracer_of

        self.tracer = tracer_of(cache)
        with self.tracer.span("snapshot", cat="object",
                              args={"session": self.uid}):
            snapshot: ClusterInfo = cache.snapshot()
        self.jobs: Dict[str, JobInfo] = snapshot.jobs
        self.nodes: Dict[str, NodeInfo] = snapshot.nodes
        self.queues: Dict[str, QueueInfo] = snapshot.queues
        self.namespace_info: Dict[str, NamespaceInfo] = snapshot.namespace_info

        self.plugins: Dict[str, object] = {}
        self.event_handlers: List[EventHandler] = []

        # Tiered callback registries (17 families, session.go:36-71).
        self.job_order_fns: Dict[str, Callable] = {}
        self.queue_order_fns: Dict[str, Callable] = {}
        self.task_order_fns: Dict[str, Callable] = {}
        self.namespace_order_fns: Dict[str, Callable] = {}
        self.preemptable_fns: Dict[str, Callable] = {}
        self.reclaimable_fns: Dict[str, Callable] = {}
        self.job_ready_fns: Dict[str, Callable] = {}
        self.job_pipelined_fns: Dict[str, Callable] = {}
        self.predicate_fns: Dict[str, Callable] = {}
        self.best_node_fns: Dict[str, Callable] = {}
        self.node_order_fns: Dict[str, Callable] = {}
        self.batch_node_order_fns: Dict[str, Callable] = {}
        self.node_map_fns: Dict[str, Callable] = {}
        self.node_reduce_fns: Dict[str, Callable] = {}
        self.overused_fns: Dict[str, Callable] = {}
        self.job_valid_fns: Dict[str, Callable] = {}
        self.job_enqueueable_fns: Dict[str, Callable] = {}

        # Device-level contributions.
        self.score_weight_fns: Dict[str, Callable[[], Dict[str, float]]] = {}
        self.device_mask_fns: Dict[str, Callable] = {}
        self.queue_deserved: Dict[str, Resource] = {}
        self.queue_allocated_open: Dict[str, Resource] = {}

        # PodGroup statuses at open, for change detection at close.
        self.pod_group_status: Dict[str, object] = {}

    # ------------------------------------------------------------ add_* API

    def add_job_order_fn(self, name, fn):
        self.job_order_fns[name] = fn

    def add_queue_order_fn(self, name, fn):
        self.queue_order_fns[name] = fn

    def add_task_order_fn(self, name, fn):
        self.task_order_fns[name] = fn

    def add_namespace_order_fn(self, name, fn):
        self.namespace_order_fns[name] = fn

    def add_preemptable_fn(self, name, fn):
        self.preemptable_fns[name] = fn

    def add_reclaimable_fn(self, name, fn):
        self.reclaimable_fns[name] = fn

    def add_job_ready_fn(self, name, fn):
        self.job_ready_fns[name] = fn

    def add_job_pipelined_fn(self, name, fn):
        self.job_pipelined_fns[name] = fn

    def add_predicate_fn(self, name, fn):
        self.predicate_fns[name] = fn

    def add_best_node_fn(self, name, fn):
        self.best_node_fns[name] = fn

    def add_node_order_fn(self, name, fn):
        self.node_order_fns[name] = fn

    def add_batch_node_order_fn(self, name, fn):
        self.batch_node_order_fns[name] = fn

    def add_node_map_fn(self, name, fn):
        self.node_map_fns[name] = fn

    def add_node_reduce_fn(self, name, fn):
        self.node_reduce_fns[name] = fn

    def add_overused_fn(self, name, fn):
        self.overused_fns[name] = fn

    def add_job_valid_fn(self, name, fn):
        self.job_valid_fns[name] = fn

    def add_job_enqueueable_fn(self, name, fn):
        self.job_enqueueable_fns[name] = fn

    def add_event_handler(self, handler: EventHandler):
        self.event_handlers.append(handler)

    def add_score_weight_fn(self, name, fn):
        """Contribute additive device score weights."""
        self.score_weight_fns[name] = fn

    def add_device_mask_fn(self, name, fn):
        """Contribute an extra [P, N] predicate mask factory (the
        custom-plugin extension; cheaper than per-(task, node) host
        callbacks).  Contract: ``fn(cluster, pending_tasks, node_names)
        -> [len(pending), len(node_names)] bool or None``; the allocate
        action ANDs the result into the solver's feasibility."""
        self.device_mask_fns[name] = fn

    # ------------------------------------------------------ tier iteration

    def _tier_plugins(self, flag_attr: str):
        """(tier_index, PluginOption) list for plugins with a flag on.
        Memoized: this sits inside every heap comparison of the job/task
        orderings (tiers never change within a session)."""
        cache = getattr(self, "_tier_plugin_cache", None)
        if cache is None:
            cache = self._tier_plugin_cache = {}
        hit = cache.get(flag_attr)
        if hit is None:
            hit = cache[flag_attr] = [
                (ti, opt)
                for ti, tier in enumerate(self.tiers)
                for opt in tier.plugins
                if getattr(opt, flag_attr, None)
            ]
        return hit

    # ------------------------------------------------------------ dispatch

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        """First non-zero comparator across tiers wins
        (session_plugins.go:292-316)."""
        for _, opt in self._tier_plugins("enabled_job_order"):
            fn = self.job_order_fns.get(opt.name)
            if fn is None:
                continue
            j = fn(l, r)
            if j != 0:
                return j < 0
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    def namespace_order_fn(self, l: str, r: str) -> bool:
        for _, opt in self._tier_plugins("enabled_namespace_order"):
            fn = self.namespace_order_fns.get(opt.name)
            if fn is None:
                continue
            j = fn(l, r)
            if j != 0:
                return j < 0
        return l < r

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        for _, opt in self._tier_plugins("enabled_queue_order"):
            fn = self.queue_order_fns.get(opt.name)
            if fn is None:
                continue
            j = fn(l, r)
            if j != 0:
                return j < 0
        if l.queue.creation_timestamp == r.queue.creation_timestamp:
            return l.uid < r.uid
        return l.queue.creation_timestamp < r.queue.creation_timestamp

    def task_compare_fns(self, l: TaskInfo, r: TaskInfo) -> int:
        for _, opt in self._tier_plugins("enabled_task_order"):
            fn = self.task_order_fns.get(opt.name)
            if fn is None:
                continue
            j = fn(l, r)
            if j != 0:
                return j
        return 0

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        res = self.task_compare_fns(l, r)
        if res != 0:
            return res < 0
        if l.pod.creation_timestamp == r.pod.creation_timestamp:
            return l.uid < r.uid
        return l.pod.creation_timestamp < r.pod.creation_timestamp

    def job_valid(self, obj) -> Optional[ValidateResult]:
        """First failing validator wins (session_plugins.go:255-271);
        JobValid has no enable flag."""
        for tier in self.tiers:
            for opt in tier.plugins:
                fn = self.job_valid_fns.get(opt.name)
                if fn is None:
                    continue
                vr = fn(obj)
                if vr is not None and not vr.pass_:
                    return vr
        return None

    def job_ready(self, obj) -> bool:
        for _, opt in self._tier_plugins("enabled_job_ready"):
            fn = self.job_ready_fns.get(opt.name)
            if fn is None:
                continue
            if not fn(obj):
                return False
        return True

    def job_pipelined(self, obj) -> bool:
        for _, opt in self._tier_plugins("enabled_job_pipelined"):
            fn = self.job_pipelined_fns.get(opt.name)
            if fn is None:
                continue
            if not fn(obj):
                return False
        return True

    def job_enqueueable(self, obj) -> bool:
        """Veto chain; no enable flag (session_plugins.go:274-289)."""
        for tier in self.tiers:
            for opt in tier.plugins:
                fn = self.job_enqueueable_fns.get(opt.name)
                if fn is None:
                    continue
                if not fn(obj):
                    return False
        return True

    def overused(self, queue: QueueInfo) -> bool:
        """Any overused verdict wins; no enable flag
        (session_plugins.go:196-210)."""
        for tier in self.tiers:
            for opt in tier.plugins:
                fn = self.overused_fns.get(opt.name)
                if fn is None:
                    continue
                if fn(queue):
                    return True
        return False

    def _victims(self, registry, flag_attr, arg, candidates) -> List[TaskInfo]:
        """Tier semantics for victim selection (session_plugins.go:110-193):
        the victim set and its initialized flag persist ACROSS tiers — every
        enabled plugin intersects the carried set — and the walk stops at the
        first tier boundary where the set is non-empty.  (Go's empty slices
        are nil, so `victims != nil` only fires on a populated set, and an
        earlier tier's empty result keeps poisoning later intersections.)"""
        victims: List[TaskInfo] = []
        init = False
        for tier in self.tiers:
            for opt in tier.plugins:
                if not getattr(opt, flag_attr, None):
                    continue
                fn = registry.get(opt.name)
                if fn is None:
                    continue
                cand = fn(arg, candidates) or []
                if not init:
                    victims = list(cand)
                    init = True
                else:
                    cand_uids = {c.uid for c in cand}
                    victims = [v for v in victims if v.uid in cand_uids]
            if victims:
                return victims
            if init:
                # The carried set is empty and can only shrink under further
                # intersection — short-circuit the remaining tiers.
                return victims
        return victims

    def preemptable(self, preemptor: TaskInfo, preemptees) -> List[TaskInfo]:
        return self._victims(
            self.preemptable_fns, "enabled_preemptable", preemptor, preemptees
        )

    def reclaimable(self, reclaimer: TaskInfo, reclaimees) -> List[TaskInfo]:
        return self._victims(
            self.reclaimable_fns, "enabled_reclaimable", reclaimer, reclaimees
        )

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """Raise FitError on the first failing predicate
        (session_plugins.go:408-425)."""
        for _, opt in self._tier_plugins("enabled_predicate"):
            fn = self.predicate_fns.get(opt.name)
            if fn is None:
                continue
            fn(task, node)  # raises on failure

    def node_order_fn(self, task: TaskInfo, node: NodeInfo) -> float:
        score = 0.0
        for _, opt in self._tier_plugins("enabled_node_order"):
            fn = self.node_order_fns.get(opt.name)
            if fn is None:
                continue
            score += fn(task, node)
        return score

    def batch_node_order_fn(self, task: TaskInfo, nodes) -> Dict[str, float]:
        scores: Dict[str, float] = {}
        for _, opt in self._tier_plugins("enabled_node_order"):
            fn = self.batch_node_order_fns.get(opt.name)
            if fn is None:
                continue
            for node_name, s in fn(task, nodes).items():
                scores[node_name] = scores.get(node_name, 0.0) + s
        return scores

    def best_node_fn(self, task: TaskInfo, node_scores) -> Optional[NodeInfo]:
        for _, opt in self._tier_plugins("enabled_best_node"):
            fn = self.best_node_fns.get(opt.name)
            if fn is None:
                continue
            best = fn(task, node_scores)
            if best is not None:
                return best
        return None

    def score_weights(self, slots):
        """Assemble the additive device ScoreWeights from enabled plugins.

        ``slots`` is the session's ResourceSlots layout; binpack's named
        per-resource weights are resolved to dense slot vectors here.
        """
        from ..ops.scoring import ScoreWeights

        width = slots.width
        merged = {
            "binpack_weight": 0.0,
            "binpack_res": [1.0] * width,
            "least_req_weight": 0.0,
            "most_req_weight": 0.0,
            "balanced_weight": 0.0,
            "node_affinity_weight": 0.0,
        }
        for _, opt in self._tier_plugins("enabled_node_order"):
            fn = self.score_weight_fns.get(opt.name)
            if fn is None:
                continue
            for k, v in fn().items():
                if k == "binpack_res":
                    dense = [0.0] * width
                    for name, w in v.items():
                        idx = slots.index.get(name)
                        if idx is not None:
                            dense[idx] = float(w)
                    merged[k] = dense
                else:
                    merged[k] = merged[k] + v
        return ScoreWeights(
            binpack_weight=float(merged["binpack_weight"]),
            binpack_res=np.asarray(merged["binpack_res"], np.float32),
            least_req_weight=float(merged["least_req_weight"]),
            most_req_weight=float(merged["most_req_weight"]),
            balanced_weight=float(merged["balanced_weight"]),
            node_affinity_weight=float(merged["node_affinity_weight"]),
        )

    # --------------------------------------------------- mutation operations

    def _dispatch_events(self, task: TaskInfo, allocate: bool):
        for eh in self.event_handlers:
            fn = eh.allocate_func if allocate else eh.deallocate_func
            if fn is not None:
                fn(Event(task=task))

    def allocate_task(self, task: TaskInfo, hostname: str) -> None:
        """Session-level Allocate (session.go:250-305): update status, add to
        node, fire events; once the job is ready, every Allocated task is
        dispatched (bound) immediately."""
        self.cache.allocate_volumes(task, hostname)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"job {task.job} not in session")
        job.update_task_status(task, TaskStatus.Allocated)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"node {hostname} not in session")
        node.add_task(task)
        self._dispatch_events(task, allocate=True)
        if self.job_ready(job):
            for t in list(
                job.task_status_index.get(TaskStatus.Allocated, {}).values()
            ):
                self.dispatch_bind(t)

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """Session-level Pipeline (session.go:207-249): NOT transactional —
        survives Statement.discard."""
        job = self.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.Pipelined)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is not None:
            node.add_task(task)
        self._dispatch_events(task, allocate=True)

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Session-level Evict (session.go:334-380): immediate cache evict."""
        self.cache.evict(reclaimee, reason)
        job = self.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.Releasing)
        node = self.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self._dispatch_events(reclaimee, allocate=False)

    def dispatch_bind(self, task: TaskInfo) -> None:
        """Send the bind to the cache (session.go:307-330 dispatch:
        BindVolumes then Bind)."""
        self.cache.bind_volumes(task)
        self.cache.bind(task, task.node_name)
        job = self.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.Binding)

    def update_job_condition(self, job: JobInfo, condition: PodGroupCondition):
        self.cache.record_job_condition(job, condition)

    def statement(self) -> "Statement":
        from .statement import Statement

        return Statement(self)
