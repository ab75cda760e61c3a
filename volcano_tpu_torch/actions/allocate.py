"""Allocate action of the object session: the device-backed hot path.

Replaces ``pkg/scheduler/actions/allocate/allocate.go:40-250``, as the JAX
package's ``actions/allocate.py``.  The namespace -> queue -> job hierarchy
is flattened host-side into a static processing order (round-robin across
namespaces, queues by share, jobs by tier order, tasks by task order -- the
same orderings the reference applies via its PriorityQueues), the snapshot
is encoded into ``ClusterArrays``, and one solver call performs the
predicate/score/select/capacity loop with gang commit/discard on the
session's device: the wave solve (``ops.wave.solve_wave``, default) or the
exact sequential solve (``ops.allocate.solve``, ``solver: seq``; the
``seq_solve`` kernel on the card).  Custom plugins' predicate and node-order
callbacks are evaluated host-side into [P, N] planes the solvers take as
``extra_ok`` / ``extra_score``.  The returned assignment is replayed through
the Session so host state, event handlers (DRF/proportion shares), and bind
dispatch stay consistent; a fit re-check guards against host/device
divergence.

Because the fused order is fixed at encode time while the reference
re-sorts by live shares after every job, the action supports multiple
solver rounds (action argument ``rounds``, default 1): each round re-sorts
by the updated shares and solves the remaining pending tasks.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np

from ..api import (FitError, FitErrors, JobInfo, PodGroupPhase,
                   TaskInfo, TaskStatus)
from ..arrays import ResourceSlots, encode_affinity, encode_cluster
from ..cache.interface import VolumeBindFailure
from ..device import to_numpy
from ..framework.arguments import get_action_args
from ..metrics import metrics
from ..utils.priority_queue import PriorityQueue

log = logging.getLogger(__name__)

ROUNDS_ARG = "rounds"
SOLVER_ARG = "solver"  # "wave" (default) or "seq" (exact sequential)


class AllocateAction:
    name = "allocate"

    def initialize(self):
        pass

    def un_initialize(self):
        pass

    # ------------------------------------------------------------- ordering

    def _schedulable_jobs(self, ssn) -> List[JobInfo]:
        jobs = []
        for job in ssn.jobs.values():
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == PodGroupPhase.Pending.value
            ):
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.pass_:
                continue
            if job.queue not in ssn.queues:
                log.warning(
                    "Skip job %s/%s: queue %s not found",
                    job.namespace, job.name, job.queue,
                )
                continue
            jobs.append(job)
        return jobs

    def _job_order(self, ssn, jobs: List[JobInfo]) -> List[JobInfo]:
        """Flatten namespace round-robin x queue share x job order into a
        static sequence (allocate.go:107-153 with shares frozen at sort
        time)."""
        by_namespace: Dict[str, Dict[str, PriorityQueue]] = {}
        for job in jobs:
            by_namespace.setdefault(job.namespace, {}).setdefault(
                job.queue, PriorityQueue(ssn.job_order_fn)
            ).push(job)

        # Order namespaces with the tiered comparator.
        ns_pq = PriorityQueue(ssn.namespace_order_fn)
        for ns in by_namespace:
            ns_pq.push(ns)
        namespaces = []
        while not ns_pq.empty():
            namespaces.append(ns_pq.pop())

        ordered: List[JobInfo] = []
        # Round-robin namespaces; within a namespace pick the best queue by
        # queue_order_fn among queues that still have jobs, pop one job.
        active = {ns: by_namespace[ns] for ns in namespaces}
        while active:
            for ns in list(namespaces):
                queues = active.get(ns)
                if not queues:
                    active.pop(ns, None)
                    continue
                best_q = None
                for qid in list(queues.keys()):
                    if queues[qid].empty():
                        del queues[qid]
                        continue
                    q = ssn.queues[qid]
                    if ssn.overused(q):
                        # Skip overused queues at sort time; the kernel
                        # re-checks with live allocation.
                        del queues[qid]
                        continue
                    if best_q is None or ssn.queue_order_fn(q, ssn.queues[best_q]):
                        best_q = qid
                if best_q is None:
                    active.pop(ns, None)
                    continue
                ordered.append(queues[best_q].pop())
            if not any(active.values()):
                break
        return ordered

    def _pending_tasks(self, ssn, job: JobInfo) -> List[TaskInfo]:
        tasks = PriorityQueue(ssn.task_order_fn)
        for task in job.task_status_index.get(TaskStatus.Pending, {}).values():
            # Skip BestEffort tasks in allocate (backfill handles them).
            if task.resreq.is_empty():
                continue
            tasks.push(task)
        out = []
        while not tasks.empty():
            out.append(tasks.pop())
        return out

    # ------------------------------------------------------------- execute

    def execute(self, ssn) -> None:
        from ..ops.allocate import solve, solve_inputs
        from ..ops.wave import solve_wave

        args = get_action_args(ssn.configurations, self.name)
        rounds = args.get_int(ROUNDS_ARG, 1) if args else 1
        solver = args.get_str(SOLVER_ARG, "wave") if args else "wave"
        # Wave-mode gang discards release capacity only after the solve
        # (wave.py module docs); extra rounds give discard survivors the
        # freed capacity — the sequential solver releases in-scan and
        # needs none.
        max_rounds = max(rounds, 1) + (3 if solver == "wave" else 0)

        slots = None
        retry_discards = False
        for rnd in range(max_rounds):
            if rnd >= max(rounds, 1) and not retry_discards:
                break
            jobs = self._schedulable_jobs(ssn)
            ordered_jobs = self._job_order(ssn, jobs)
            pending: List[TaskInfo] = []
            job_ids: List[str] = []
            job_tasks: Dict[str, List[TaskInfo]] = {}
            for job in ordered_jobs:
                tasks = self._pending_tasks(ssn, job)
                if not tasks:
                    continue
                job_ids.append(job.uid)
                job_tasks[job.uid] = tasks
                pending.extend(tasks)
            if not pending:
                return

            cluster = _SessionView(ssn)
            if slots is None:
                slots = ResourceSlots.for_cluster(cluster)
            arrays, maps = encode_cluster(cluster, pending, job_ids, slots)

            # Inter-pod (anti)affinity + spread: per-(term, domain) count
            # tensors, checked and updated live inside the solver.
            aff = encode_affinity(
                cluster, pending, maps.node_names,
                arrays.nodes.idle.shape[0], arrays.tasks.req.shape[0],
            )

            weights = ssn.score_weights(slots)

            Q, R = arrays.queues.capability.shape
            deserved = np.full((Q, R), 3.0e38, np.float32)
            q_alloc0 = np.zeros((Q, R), np.float32)
            for qid, res in ssn.queue_deserved.items():
                qi = maps.queue_index.get(qid)
                if qi is not None:
                    deserved[qi] = slots.vec(res)
            for qid, res in ssn.queue_allocated_open.items():
                qi = maps.queue_index.get(qid)
                if qi is not None:
                    q_alloc0[qi] = slots.vec(res)

            s_nodes, s_tasks, s_jobs, s_queues = solve_inputs(
                arrays, deserved, q_alloc0
            )
            pp = arrays.tasks.req.shape[0]
            nn = arrays.nodes.idle.shape[0]
            extra_ok = self._custom_mask(ssn, cluster, pending, maps)
            if extra_ok is not None:
                # Align to the encoder's padded task/node axes (padded
                # tasks are inert; padded nodes are not-ready): all-ones.
                full = np.ones((pp, nn), bool)
                full[:extra_ok.shape[0], :extra_ok.shape[1]] = extra_ok
                extra_ok = full
            extra_score = self._custom_score(ssn, cluster, pending, maps)
            if extra_score is not None:
                fulls = np.zeros((pp, nn), np.float32)
                fulls[:extra_score.shape[0], :extra_score.shape[1]] = \
                    extra_score
                extra_score = fulls

            t0 = time.perf_counter()
            solve_fn = solve_wave if solver == "wave" else solve
            result = solve_fn(
                s_nodes, s_tasks, s_jobs, s_queues,
                weights, arrays.eps, arrays.scalar_slot, aff,
                extra_ok=extra_ok, extra_score=extra_score,
                device=ssn.device,
            )
            assigned = to_numpy(result.assigned)
            pipelined = to_numpy(result.pipelined)
            never_ready = to_numpy(result.never_ready)
            fit_failed = to_numpy(result.fit_failed)
            metrics.device_solve_latency.observe(
                (time.perf_counter() - t0) * 1e3
            )
            metrics.snapshot_transfer_bytes.set(
                sum(a.nbytes for grp in (arrays.nodes, arrays.tasks,
                                         arrays.jobs, arrays.queues)
                    for a in grp)
            )

            made_progress = self._replay(
                ssn, maps, pending, assigned, pipelined, never_ready,
                fit_failed,
            )
            # Jobs discarded by the wave solver left their capacity on the
            # table this round; retry while the round also made progress
            # (so a retry can actually see different state).
            retry_discards = bool(never_ready.any()) and made_progress
            if not made_progress:
                return

    # Built-in predicate plugins whose checks are already encoded as
    # device masks; anything else registering a predicate is an
    # out-of-tree plugin evaluated host-side into the extra mask.
    BUILTIN_PREDICATE_PLUGINS = frozenset({"predicates"})

    def _custom_mask(self, ssn, cluster, pending, maps):
        """[P, N] verdicts from custom-plugin predicate callbacks and
        device-mask factories (ssn.add_predicate_fn from out-of-tree
        plugins + ssn.add_device_mask_fn).  None when only built-ins are
        registered — the overwhelmingly common case, which costs nothing.
        The host-predicate sweep is O(P x N) Python, the price the
        reference pays for EVERY predicate (scheduler_helper.go:65)."""
        custom = [
            (opt.name, ssn.predicate_fns[opt.name])
            for _, opt in ssn._tier_plugins("enabled_predicate")
            if opt.name in ssn.predicate_fns
            and opt.name not in self.BUILTIN_PREDICATE_PLUGINS
        ]
        mask_fns = [
            (nm, fn) for nm, fn in ssn.device_mask_fns.items()
            if nm not in self.BUILTIN_PREDICATE_PLUGINS
        ]
        if not custom and not mask_fns:
            return None
        n_nodes = len(maps.node_names)
        extra = np.ones((len(pending), n_nodes), bool)
        node_infos = [cluster.nodes[nm] for nm in maps.node_names]
        for _name, fn in custom:
            unexpected_logged = False
            for i, task in enumerate(pending):
                row = extra[i]
                for j, node in enumerate(node_infos):
                    if not row[j]:
                        continue
                    try:
                        fn(task, node)
                    except FitError:
                        row[j] = False
                    except Exception as err:
                        # A buggy plugin (wrong signature, attribute
                        # errors) would otherwise silently veto every
                        # node; surface the first instance.
                        if not unexpected_logged:
                            unexpected_logged = True
                            log.warning(
                                "custom predicate plugin %s raised %r "
                                "(treated as infeasible)", _name, err,
                            )
                        row[j] = False
        for _name, fn in mask_fns:
            contributed = fn(cluster, pending, maps.node_names)
            if contributed is not None:
                extra &= np.asarray(contributed, bool)
        return extra

    def _custom_score(self, ssn, cluster, pending, maps):
        """[P, N] additive scores from custom-plugin node-order callbacks
        (ssn.add_node_order_fn / add_batch_node_order_fn from out-of-tree
        plugins).  None when only built-ins are registered.  A plugin
        that registered add_score_weight_fn already scores through the
        device ScoreWeights — excluding on that signal (rather than a
        hardcoded name list) avoids double-counting and covers custom
        plugins that choose the weights route."""
        custom_map = [
            (opt.name, ssn.node_order_fns[opt.name])
            for _, opt in ssn._tier_plugins("enabled_node_order")
            if opt.name in ssn.node_order_fns
            and opt.name not in ssn.score_weight_fns
        ]
        custom_batch = [
            (opt.name, ssn.batch_node_order_fns[opt.name])
            for _, opt in ssn._tier_plugins("enabled_node_order")
            if opt.name in ssn.batch_node_order_fns
            and opt.name not in ssn.score_weight_fns
        ]
        if not custom_map and not custom_batch:
            return None
        n_nodes = len(maps.node_names)
        extra = np.zeros((len(pending), n_nodes), np.float32)
        node_infos = [cluster.nodes[nm] for nm in maps.node_names]
        col = {nm: j for j, nm in enumerate(maps.node_names)}
        for _name, fn in custom_map:
            logged = False
            for i, task in enumerate(pending):
                for j, node in enumerate(node_infos):
                    try:
                        extra[i, j] += float(fn(task, node))
                    except Exception as err:
                        if not logged:
                            logged = True
                            log.warning(
                                "custom node-order plugin %s raised %r",
                                _name, err,
                            )
        for _name, fn in custom_batch:
            logged = False
            for i, task in enumerate(pending):
                try:
                    for nm, sc in (fn(task, node_infos) or {}).items():
                        j = col.get(nm)
                        if j is not None:
                            extra[i, j] += float(sc)
                except Exception as err:
                    if not logged:
                        logged = True
                        log.warning(
                            "custom batch node-order plugin %s raised %r",
                            _name, err,
                        )
        # Defend the solver against buggy plugins: NaN poisons argmax
        # ordering and magnitudes near the infeasibility sentinel
        # (-3e38) break the progress guarantee.
        return np.clip(np.nan_to_num(extra, nan=0.0), -1e18, 1e18)

    # --------------------------------------------------------------- replay

    def _replay(self, ssn, maps, pending, assigned, pipelined, never_ready,
                fit_failed) -> bool:
        """Apply the solver's decisions to host session state in task order.

        Committed-job allocations go through session Allocate (status,
        node accounting, share events, bind dispatch once ready); pipelines
        apply unconditionally (session-level Pipeline semantics); discarded
        jobs get fit-error conditions.
        """
        progress = False
        for i, task in enumerate(pending):
            job = ssn.jobs.get(task.job)
            if job is None:
                continue
            ji = maps.job_index[task.job]
            node_idx = int(assigned[i])
            pipe_idx = int(pipelined[i])
            if node_idx >= 0 and not never_ready[ji]:
                node_name = maps.node_names[node_idx]
                node = ssn.nodes[node_name]
                # Divergence guard: host re-check of the fit decision.
                if not task.init_resreq.less_equal(node.idle):
                    log.error(
                        "Device/host divergence: task %s does not fit %s; "
                        "skipping", task.name, node_name,
                    )
                    continue
                try:
                    ssn.allocate_task(task, node_name)
                except VolumeBindFailure as e:
                    # Claim can't be allocated on the picked node: skip
                    # the task this cycle (allocate.go:226 logs the
                    # failed stmt.Allocate and moves on).
                    log.error("volume allocation failed for %s: %s",
                              task.name, e)
                    continue
                progress = True
            elif pipe_idx >= 0:
                node_name = maps.node_names[pipe_idx]
                ssn.pipeline(task, node_name)
                progress = True

        # Record fit errors for jobs that failed (gang.OnSessionClose reads
        # these to build Unschedulable conditions).
        for jid, ji in maps.job_index.items():
            job = ssn.jobs.get(jid)
            if job is None:
                continue
            if fit_failed[ji]:
                fe = FitErrors()
                fe.set_error("no feasible node for task")
                for task in job.task_status_index.get(
                    TaskStatus.Pending, {}
                ).values():
                    job.nodes_fit_errors[task.uid] = fe
        return progress


class _SessionView:
    """Adapter presenting a Session as a ClusterInfo for the encoder."""

    def __init__(self, ssn):
        self.jobs = ssn.jobs
        self.nodes = ssn.nodes
        self.queues = ssn.queues
        self.namespace_info = ssn.namespace_info
