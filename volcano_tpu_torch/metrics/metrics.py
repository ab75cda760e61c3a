"""In-process metrics registry with Prometheus text exposition.

Implements the reference's metric set under the same ``volcano`` namespace
(``pkg/scheduler/metrics/metrics.go:38-110``, ``queue.go:25-124``,
``job.go:25-36``, ``namespace.go:25-44``) plus device-native series for device
solve latency and snapshot transfer volume.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from contextlib import contextmanager
from typing import Dict, List, Tuple

# Buckets follow prometheus.DefBuckets spirit; values recorded in the unit
# named by the metric (ms / us).
_DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100,
    250, 500, 1000, 2500, 5000, 10000,
)
_N_BUCKETS = len(_DEFAULT_BUCKETS)

LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted(labels.items()))


# Writers and the scrape synchronize on one registry lock (the series
# of a Metrics instance all share it): unguarded dict inserts from a
# cycle thread raced expose_text's iteration ("dictionary changed size
# during iteration" on a scrape mid-cycle).  Series constructed outside
# a registry (tests) get their own lock.


class _Histogram:
    """Bounded histogram: per label set, fixed bucket counts + sum +
    count — NOT the raw observation list (a long-running scheduler
    observes forever; the list grew without bound)."""

    def __init__(self, name: str, help_: str,
                 lock: "threading.Lock" = None):
        self.name = name
        self.help = help_
        self._lock = lock or threading.Lock()
        # LabelKey -> [per-bucket counts (+1 overflow slot), sum, count]
        self.data: Dict[LabelKey, list] = {}

    def observe(self, value: float, **labels):
        key = _labels_key(labels)
        with self._lock:
            state = self.data.get(key)
            if state is None:
                state = self.data[key] = [[0] * (_N_BUCKETS + 1), 0.0, 0]
            state[0][bisect_left(_DEFAULT_BUCKETS, value)] += 1
            state[1] += value
            state[2] += 1

    def observe_many(self, values, **labels):
        """``observe`` of every value of the float array ``values`` in
        order under one label set, with one lock acquisition (the
        journey's bulk capture): the same bucket counts, and the sum
        added value by value from the running one."""
        import numpy as np

        values = np.asarray(values, np.float64)
        if not len(values):
            return
        key = _labels_key(labels)
        buckets = np.bincount(
            np.searchsorted(_DEFAULT_BUCKETS, values, side="left"),
            minlength=_N_BUCKETS + 1).tolist()
        with self._lock:
            state = self.data.get(key)
            if state is None:
                state = self.data[key] = [[0] * (_N_BUCKETS + 1), 0.0, 0]
            counts = state[0]
            for i, c in enumerate(buckets):
                counts[i] += c
            state[1] = float(np.cumsum(
                np.concatenate([[state[1]], values]))[-1])
            state[2] += len(values)


class _Gauge:
    def __init__(self, name: str, help_: str,
                 lock: "threading.Lock" = None):
        self.name = name
        self.help = help_
        self._lock = lock or threading.Lock()
        self.data: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels):
        key = _labels_key(labels)
        with self._lock:
            self.data[key] = value

    def set_many(self, pairs):
        """Bulk update from prebuilt (label-key-tuple, value) pairs — the
        per-job gauges (25k+ unschedulable jobs at scale) skip the
        per-call kwargs/sort overhead, and take the lock once."""
        with self._lock:
            self.data.update(pairs)


class _Counter:
    def __init__(self, name: str, help_: str,
                 lock: "threading.Lock" = None):
        self.name = name
        self.help = help_
        self._lock = lock or threading.Lock()
        self.data: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels):
        key = _labels_key(labels)
        with self._lock:
            self.data[key] = self.data.get(key, 0.0) + value

    def inc_many(self, keys, value: float = 1.0):
        """Bulk increment from prebuilt label-key tuples (one lock
        acquisition for the batch)."""
        with self._lock:
            data = self.data
            get = data.get
            for key in keys:
                data[key] = get(key, 0.0) + value


class Metrics:
    """The volcano metric family (thread-safe)."""

    def __init__(self):
        # Shared by every series of this registry AND by expose_text:
        # one lock means a scrape sees a consistent point-in-time view
        # and writers can never resize a dict mid-iteration.
        self._lock = threading.Lock()
        ns = "volcano"
        self.e2e_scheduling_latency = _Histogram(
            f"{ns}_e2e_scheduling_latency_milliseconds",
            "E2e scheduling latency in milliseconds",
        )
        self.plugin_scheduling_latency = _Histogram(
            f"{ns}_plugin_scheduling_latency_microseconds",
            "Plugin scheduling latency in microseconds",
        )
        self.action_scheduling_latency = _Histogram(
            f"{ns}_action_scheduling_latency_microseconds",
            "Action scheduling latency in microseconds",
        )
        self.task_scheduling_latency = _Histogram(
            f"{ns}_task_scheduling_latency_microseconds",
            "Task scheduling latency in microseconds",
        )
        self.schedule_attempts = _Counter(
            f"{ns}_schedule_attempts_total",
            "Number of attempts to schedule pods, by the result",
        )
        self.pod_preemption_victims = _Gauge(
            f"{ns}_pod_preemption_victims", "Number of selected preemption victims"
        )
        self.total_preemption_attempts = _Counter(
            f"{ns}_total_preemption_attempts",
            "Total preemption attempts in the cluster till now",
        )
        self.unschedule_task_count = _Gauge(
            f"{ns}_unschedule_task_count", "Number of tasks could not be scheduled"
        )
        self.unschedule_job_count = _Gauge(
            f"{ns}_unschedule_job_count", "Number of jobs could not be scheduled"
        )
        self.job_retry_counts = _Counter(
            f"{ns}_job_retry_counts", "Number of retry counts for one job"
        )
        self.job_share = _Gauge(f"{ns}_job_share", "Share for one job")
        self.queue_allocated_milli_cpu = _Gauge(
            f"{ns}_queue_allocated_milli_cpu",
            "Allocated CPU count for one queue",
        )
        self.queue_allocated_memory_bytes = _Gauge(
            f"{ns}_queue_allocated_memory_bytes",
            "Allocated memory for one queue",
        )
        self.queue_request_milli_cpu = _Gauge(
            f"{ns}_queue_request_milli_cpu", "Request CPU count for one queue"
        )
        self.queue_request_memory_bytes = _Gauge(
            f"{ns}_queue_request_memory_bytes", "Request memory for one queue"
        )
        self.queue_deserved_milli_cpu = _Gauge(
            f"{ns}_queue_deserved_milli_cpu", "Deserved CPU count for one queue"
        )
        self.queue_deserved_memory_bytes = _Gauge(
            f"{ns}_queue_deserved_memory_bytes", "Deserved memory for one queue"
        )
        self.queue_share = _Gauge(f"{ns}_queue_share", "Share for one queue")
        self.queue_weight = _Gauge(f"{ns}_queue_weight", "Weight for one queue")
        self.queue_overused = _Gauge(
            f"{ns}_queue_overused", "If one queue is overused"
        )
        self.queue_pod_group_inqueue_count = _Gauge(
            f"{ns}_queue_pod_group_inqueue_count",
            "Number of Inqueue PodGroup in this queue",
        )
        self.queue_pod_group_pending_count = _Gauge(
            f"{ns}_queue_pod_group_pending_count",
            "Number of pending PodGroup in this queue",
        )
        self.queue_pod_group_running_count = _Gauge(
            f"{ns}_queue_pod_group_running_count",
            "Number of running PodGroup in this queue",
        )
        self.queue_pod_group_unknown_count = _Gauge(
            f"{ns}_queue_pod_group_unknown_count",
            "Number of unknown PodGroup in this queue",
        )
        self.namespace_share = _Gauge(
            f"{ns}_namespace_share", "Share for one namespace"
        )
        self.namespace_weight = _Gauge(
            f"{ns}_namespace_weight", "Weight for one namespace"
        )
        self.namespace_weighted_share = _Gauge(
            f"{ns}_namespace_weighted_share", "Weighted share for one namespace"
        )
        # TPU-native additions.
        self.device_solve_latency = _Histogram(
            f"{ns}_device_solve_latency_milliseconds",
            "Device allocate-solver latency in milliseconds",
        )
        self.inflight_fetch_wait = _Histogram(
            f"{ns}_inflight_fetch_wait_milliseconds",
            "Residual wait fetching the pipelined in-flight solve at "
            "cycle top; approaches zero when the overlap hides the "
            "device round trip",
        )
        self.device_crash_recoveries = _Counter(
            f"{ns}_device_crash_recoveries_total",
            "Mid-solve TPU runtime crashes recovered by degrading the "
            "affinity chunk budget",
        )
        self.snapshot_transfer_bytes = _Gauge(
            f"{ns}_snapshot_transfer_bytes",
            "Bytes transferred host->device for the session snapshot",
        )
        self.solve_shortlist_fallback = _Counter(
            f"{ns}_solve_shortlist_fallback_total",
            "Two-phase solve full-N rescores after a profile's "
            "candidate shortlist ran dry, by reason: exhausted (every "
            "candidate claimed by earlier waves) or affinity-required "
            "(required inter-pod terms drifted from the solve-start "
            "counts the shortlist was built on)",
        )
        self.device_incremental_solves = _Counter(
            f"{ns}_device_incremental_solves_total",
            "Device-lane incremental solve decisions by mode: warm "
            "(shortlists warm-started from the previous solve's "
            "per-block candidates over the dirty node set), full (the "
            "proven full re-rank: cache key drift — class-set, "
            "profile-set, node churn, compaction, affinity-count "
            "content — dirty overflow, or first solve), or skip (a "
            "null-delta cycle proved the dispatch would reproduce the "
            "previous empty outcome and skipped it wholesale; "
            "VOLCANO_TPU_DEVINCR=0 disables the lane and counts "
            "nothing)",
        )
        self.host_incremental_derives = _Counter(
            f"{ns}_host_incremental_derives_total",
            "Derive-lane aggregate refreshes by mode: delta "
            "(subtract-old/add-new scatters over the mirror's dirty "
            "row set) or full (the proven rebuild fallback: first "
            "derive, node-membership churn, compaction, dirty-set overflow "
            "past VOLCANO_TPU_DIRTY_CAP, or VOLCANO_TPU_INCREMENTAL=0)",
        )
        self.remote_frame_bytes = _Counter(
            f"{ns}_remote_frame_bytes_total",
            "Remote-solver wire bytes shipped scheduler->solver "
            "(length prefix included), by frame kind: full (the whole "
            "materialized solve-args frame — first frame of a "
            "connection, kill switch off, or any fallback) or delta "
            "(only changed row ranges and changed planes against the "
            "child's per-connection mirror, protocol v2)",
        )
        self.remote_frame_fallback = _Counter(
            f"{ns}_remote_frame_fallback_total",
            "Delta-lane frames forced back to a full frame, by "
            "reason: reconnect (socket re-established, child mirror "
            "gone), abandon (pipelined reply dropped, framing reset), "
            "spec-change (the solve-args pytree shape drifted, slots "
            "no longer align), gen-mismatch (child replied resync: "
            "its mirror does not hold the delta's base), ack-mismatch "
            "(reply acknowledged a different generation than "
            "dispatched), child-error (the solve errored in the child "
            "and poisoned its mirror), v1-child (the solver speaks "
            "protocol v1 — no ack_gen in replies; the delta lane "
            "self-disabled), shm (shared-memory segment unattachable; "
            "lane disabled), forced (VOLCANO_TPU_WIRE=fallback A/B "
            "lever)",
        )
        self.pipeline_stale_drops = _Counter(
            f"{ns}_pipeline_stale_drop_rows_total",
            "In-flight solve rows that did not commit, by reason: the "
            "staleness guard's per-row drops (deleted, competing-bind, "
            "capacity-taken, constraint-sensitive, node-epoch-churn, "
            "cross-shard-conflict, topology-infeasible) plus "
            "whole-result voids (compaction, lost-reply, "
            "device-crash)",
        )
        self.shard_conflicts = _Counter(
            f"{ns}_shard_conflicts_total",
            "Optimistic cross-shard commit conflicts (shard.py): "
            "in-flight rows voided because another shard's binds "
            "landed during the overlap, by losing check — "
            "competing-bind (the row itself was taken: steal race) or "
            "capacity-taken (the target node's capacity was).  These "
            "rows also count as the cross-shard-conflict reason of "
            "volcano_pipeline_stale_drop_rows_total; they re-place "
            "next cycle, never lost",
        )
        self.shard_steals = _Counter(
            f"{ns}_shard_steals_total",
            "Work-stealing queue ownership handoffs: an idle shard "
            "claimed the most-starved foreign queue via the ownership "
            "table's epoch-bumped handoff token (shard.py)",
        )
        self.rebalance_plans = _Counter(
            f"{ns}_rebalance_plans_total",
            "Rebalance migration plans by outcome: committed (what-if "
            "solve proved the starved gang places AND every victim "
            "re-places; evictions dispatched), rejected-no-gain (plan "
            "solve failed the strict-improvement bar), rejected-budget "
            "(per-PodGroup disruption budgets blocked an otherwise "
            "sufficient drain set), stale-voided (store mutated "
            "between the pipelined plan dispatch and its commit)",
        )
        self.whatif_plans = _Counter(
            f"{ns}_whatif_plans_total",
            "What-if engine plans by action (preempt | reclaim | "
            "rebalance) and outcome: committed (the hypothetical solve "
            "proved the wave's goal; evictions dispatched), "
            "rejected-no-gain (the solve failed the action's bar), "
            "rejected-budget (per-PodGroup disruption budgets blocked "
            "an otherwise sufficient wave), stale-voided (store "
            "mutated between the pipelined plan dispatch and its "
            "commit), lost-reply (an offloaded plan solve's reply "
            "died with its pool replica; the plan mutated nothing "
            "and re-forms).  Rebalance outcomes also count in the "
            "historical volcano_rebalance_plans_total series",
        )
        self.preempt_evictions = _Counter(
            f"{ns}_preempt_evictions_total",
            "Pods evicted by committed device-native preempt/reclaim "
            "plans, by action; counted at the cycle-end evictor "
            "dispatch.  Each victim is restored as Pending by the "
            "migration ledger when its termination completes — zero "
            "lost pods unconditionally",
        )
        self.rebalance_evictions = _Counter(
            f"{ns}_rebalance_evictions_total",
            "Pods evicted by committed rebalance plans (each is "
            "restored as Pending when its termination completes and "
            "re-places through the allocate lane)",
        )
        self.rebalance_frag_score = _Gauge(
            f"{ns}_rebalance_frag_score",
            "Mean per-node fragmentation score at the last rebalance "
            "planning pass: fraction of idle stranded on nodes unable "
            "to host any task of the starved gang's profiles (0 = no "
            "stranded idle, 1 = fully idle yet useless)",
        )
        self.topology_placements = _Counter(
            f"{ns}_topology_placements_total",
            "Gang placements through the topology gate (ops/topology) "
            "by outcome: contiguous (every bound task landed "
            "in one fabric block), scattered (a prefer-contiguous gang "
            "bound across blocks; bias lost to capacity), infeasible "
            "(a require-contiguous gang was held back — no block can "
            "host the whole gang right now, or a post-solve check "
            "caught a scattered assignment and vetoed it; the gang "
            "re-places after defragmentation)",
        )
        self.topology_frag_score = _Gauge(
            f"{ns}_topology_frag_score",
            "Mean per-block fabric fragmentation at the last rebalance "
            "planning pass for a topology-constrained gang: fraction "
            "of the gang placeable on partial blocks that cannot host "
            "it whole (0 = some block fits the entire gang, higher = "
            "capacity stranded across partial slices)",
        )
        self.solver_pool_dispatch = _Counter(
            f"{ns}_solver_pool_dispatch_total",
            "Solver-pool frame dispatches by replica and kind: "
            "primary (the health-scored allocate-lane target), hedge "
            "(the identical frame re-dispatched to a second replica "
            "after the primary's reply exceeded its rolling-p99 "
            "deadline), or whatif (a plan-proving solve offloaded to "
            "an idle non-primary replica)",
        )
        self.solver_pool_failover = _Counter(
            f"{ns}_solver_pool_failover_total",
            "Solver-pool primary changes away from a failed replica: "
            "the previous primary's dispatch or fetch failed and the "
            "next dispatch routed to a healthy replica (whose first "
            "frame ships full by construction — deltas re-engage "
            "after it)",
        )
        self.solver_pool_hedge_wins = _Counter(
            f"{ns}_solver_pool_hedge_wins_total",
            "Hedged solver-pool dispatches whose hedge reply landed "
            "(and committed) before the straggling primary's; the "
            "loser's reply is drained later, keeping its mirror "
            "coherent via ack_gen",
        )
        self.solver_pool_replica_health = _Gauge(
            f"{ns}_solver_pool_replica_health",
            "Per-replica solver-pool health score: 1 / (1 + "
            "consecutive failures) — 1.0 is healthy, decaying toward "
            "0 as dispatch/fetch failures accumulate; failed replicas "
            "are re-probed on a doubling cooldown and snap back to "
            "1.0 when the probe succeeds",
        )
        self.audit_anomalies = _Counter(
            f"{ns}_audit_anomalies_total",
            "Runtime-auditor anomalies by catalogued reason "
            "(obs/audit.py; docs/observability.md anomaly catalog).  "
            "Nonzero means an invariant the scheduler relies on was "
            "observed violated at runtime — a page, not a trend",
        )
        self.audit_cycles = _Counter(
            f"{ns}_audit_cycles_total",
            "Auditor cycle-end passes by mode: reconciled (census "
            "compared against the declared flows), skipped (no flows, "
            "unmoved mutation counter), or sampled (coherence audits "
            "of the registered cache slots also ran)",
        )
        self.slo_burn_rate = _Gauge(
            f"{ns}_slo_budget_burn_rate",
            "Error-budget burn rate per SLO lane (obs/slo.py): "
            "(fraction of window cycles over the declared target) / "
            "allowed fraction.  >= 1.0 means the lane is consuming "
            "its error budget faster than the SLO allows",
        )
        self.pod_time_to_first_consider = _Histogram(
            f"{ns}_pod_time_to_first_consider_milliseconds",
            "Pod-journey latency (obs/journey.py) from mirror enqueue "
            "to the pod's FIRST entry into a device solve, per queue "
            "— the queue-backlog component of scheduling latency",
        )
        self.pod_time_to_bind = _Histogram(
            f"{ns}_pod_time_to_bind_milliseconds",
            "Pod-journey latency from mirror enqueue to the pod's "
            "FIRST committed bind, per queue — the end-to-end wait "
            "signal the ttb SLO lane budgets "
            "(VOLCANO_TPU_SLO_TTB_P99_MS)",
        )
        self.gang_time_to_full_bind = _Histogram(
            f"{ns}_gang_time_to_full_bind_milliseconds",
            "Gang-journey latency from the gang's first member "
            "enqueue to its LAST member's first bind — the gang-level "
            "time-to-full-bind the per-pod series can't show",
        )
        self.journey_events = _Counter(
            f"{ns}_journey_events_total",
            "Pod-journey events captured by kind (enqueued / "
            "dispatched / dropped / bound / evicted / ...); bulk "
            "steady-state repeats are counted by the journey's "
            "internal counters, not here",
        )
        # Registry-wide lock sharing: rebind every series to THIS
        # registry's lock (done before any concurrent use) so writers
        # serialize with expose_text's iteration.
        for attr in vars(self).values():
            if isinstance(attr, (_Histogram, _Gauge, _Counter)):
                attr._lock = self._lock

    # ------------------------------------------------------------- helpers

    @contextmanager
    def plugin_timer(self, plugin: str, on_session: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.plugin_scheduling_latency.observe(
                (time.perf_counter() - t0) * 1e6,
                plugin=plugin, OnSession=on_session,
            )

    @contextmanager
    def action_timer(self, action: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.action_scheduling_latency.observe(
                (time.perf_counter() - t0) * 1e6, action=action
            )

    @contextmanager
    def e2e_timer(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.e2e_scheduling_latency.observe(
                (time.perf_counter() - t0) * 1e3
            )

    def register_preemption_attempt(self):
        self.total_preemption_attempts.inc()

    def update_preemption_victim_count(self, count: int):
        self.pod_preemption_victims.set(count)

    # ----------------------------------------------------------- exposition

    def expose_text(self) -> str:
        """Prometheus text format 0.0.4.

        Snapshot-then-format: only the cheap data copies happen under
        the registry lock (the lock the hot-path writers share); the
        string formatting of a large scrape — 25k+ per-job series at
        config-4 scale — runs outside it, so a scrape never stalls the
        scheduling cycle for the formatting's duration."""
        snap: List[tuple] = []
        with self._lock:
            for attr in vars(self).values():
                if isinstance(attr, _Gauge):
                    snap.append(("gauge", attr.name, attr.help,
                                 dict(attr.data)))
                elif isinstance(attr, _Counter):
                    snap.append(("counter", attr.name, attr.help,
                                 dict(attr.data)))
                elif isinstance(attr, _Histogram):
                    # Bucket-count lists mutate in place under observe;
                    # copy them so the formatting below reads a
                    # consistent point-in-time state.
                    snap.append(("histogram", attr.name, attr.help, {
                        key: (list(counts), total, n)
                        for key, (counts, total, n) in attr.data.items()
                    }))
        out: List[str] = []
        for kind, name, help_, data in snap:
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {kind}")
            if kind in ("gauge", "counter"):
                for key, v in data.items():
                    lbl = ",".join(f'{k}="{val}"' for k, val in key)
                    out.append(f"{name}{{{lbl}}} {v}")
                continue
            for key, (counts, total, n) in data.items():
                lbl_items = [f'{k}="{val}"' for k, val in key]
                cnt = 0
                for i, b in enumerate(_DEFAULT_BUCKETS):
                    cnt += counts[i]
                    items = lbl_items + [f'le="{b}"']
                    out.append(
                        f"{name}_bucket{{{','.join(items)}}} {cnt}"
                    )
                items = lbl_items + ['le="+Inf"']
                out.append(f"{name}_bucket{{{','.join(items)}}} {n}")
                lbl = ",".join(lbl_items)
                out.append(f"{name}_sum{{{lbl}}} {total}")
                out.append(f"{name}_count{{{lbl}}} {n}")
        return "\n".join(out) + "\n"


metrics = Metrics()
