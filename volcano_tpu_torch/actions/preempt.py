"""Preempt action (pkg/scheduler/actions/preempt/preempt.go).

Two phases: inter-job preemption within each queue (statement-wrapped;
commit iff the preemptor job reaches Pipelined, preempt.go:81-142), then
intra-job task preemption (preempt.go:144-177).  Victim selection walks
nodes in score order, filters candidate preemptees, intersects plugin
victim sets (ssn.Preemptable), validates sufficiency, and evicts
lowest-order victims until FutureIdle covers the preemptor, then pipelines
it (preempt.go:183-262).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List

from ..api import JobInfo, PodGroupPhase, TaskInfo, TaskStatus
from ..metrics import metrics
from ..utils.priority_queue import PriorityQueue
from ..utils.scheduler_helper import (
    predicate_nodes,
    prioritize_nodes,
    sort_nodes,
    validate_victims,
)

log = logging.getLogger(__name__)


class PreemptAction:
    name = "preempt"

    def initialize(self):
        pass

    def un_initialize(self):
        pass

    def execute(self, ssn) -> None:
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, PriorityQueue] = {}
        under_request: List[JobInfo] = []
        queues: Dict[str, object] = {}

        for job in ssn.jobs.values():
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == PodGroupPhase.Pending.value
            ):
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.pass_:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            queues.setdefault(queue.uid, queue)
            pending = job.task_status_index.get(TaskStatus.Pending, {})
            if pending and not ssn.job_pipelined(job):
                preemptors_map.setdefault(
                    job.queue, PriorityQueue(ssn.job_order_fn)
                ).push(job)
                under_request.append(job)
                tq = PriorityQueue(ssn.task_order_fn)
                for task in pending.values():
                    tq.push(task)
                preemptor_tasks[job.uid] = tq

        for queue in queues.values():
            # Phase 1: inter-job preemption within the queue.
            while True:
                preemptors = preemptors_map.get(queue.uid)
                if preemptors is None or preemptors.empty():
                    break
                preemptor_job = preemptors.pop()

                stmt = ssn.statement()
                assigned = False
                while True:
                    if ssn.job_pipelined(preemptor_job):
                        break
                    tasks = preemptor_tasks.get(preemptor_job.uid)
                    if tasks is None or tasks.empty():
                        break
                    preemptor = tasks.pop()

                    def job_filter(task: TaskInfo) -> bool:
                        if task.status != TaskStatus.Running:
                            return False
                        if task.resreq.is_empty():
                            return False
                        job = ssn.jobs.get(task.job)
                        if job is None:
                            return False
                        return (
                            job.queue == preemptor_job.queue
                            and preemptor.job != task.job
                        )

                    if self._preempt(ssn, stmt, preemptor, job_filter):
                        assigned = True

                if ssn.job_pipelined(preemptor_job):
                    stmt.commit()
                else:
                    stmt.discard()
                    continue
                if assigned:
                    preemptors.push(preemptor_job)

            # Phase 2: intra-job task preemption.
            for job in under_request:
                while True:
                    tasks = preemptor_tasks.get(job.uid)
                    if tasks is None or tasks.empty():
                        break
                    preemptor = tasks.pop()
                    stmt = ssn.statement()

                    def task_filter(task: TaskInfo) -> bool:
                        if task.status != TaskStatus.Running:
                            return False
                        if task.resreq.is_empty():
                            return False
                        return preemptor.job == task.job

                    assigned = self._preempt(ssn, stmt, preemptor, task_filter)
                    stmt.commit()
                    if not assigned:
                        break

    # ------------------------------------------------------------ internals

    def _preempt(self, ssn, stmt, preemptor: TaskInfo,
                 task_filter: Callable[[TaskInfo], bool]) -> bool:
        assigned = False
        all_nodes = list(ssn.nodes.values())
        feasible, _ = predicate_nodes(preemptor, all_nodes, ssn.predicate_fn)
        node_scores = prioritize_nodes(
            preemptor, feasible, ssn.batch_node_order_fn, ssn.node_order_fn
        )
        for node in sort_nodes(node_scores):
            preemptees = [
                task.clone()
                for task in node.tasks.values()
                if task_filter(task)
            ]
            victims = ssn.preemptable(preemptor, preemptees)
            metrics.update_preemption_victim_count(len(victims))
            try:
                validate_victims(preemptor, node, victims)
            except ValueError as err:
                log.debug("No validated victims on %s: %s", node.name, err)
                continue

            # Lowest task order last -> pop lowest-priority victims first
            # (preempt.go:219-224 inverts TaskOrderFn).
            victims_queue = PriorityQueue(
                lambda l, r: not ssn.task_order_fn(l, r)
            )
            for victim in victims:
                victims_queue.push(victim)

            while not victims_queue.empty():
                if preemptor.init_resreq.less_equal(node.future_idle()):
                    break
                preemptee = victims_queue.pop()
                try:
                    stmt.evict(preemptee, "preempt")
                except Exception:
                    log.exception("Failed to preempt %s", preemptee.name)
                    continue
            metrics.register_preemption_attempt()

            if preemptor.init_resreq.less_equal(node.future_idle()):
                try:
                    stmt.pipeline(preemptor, node.name)
                except Exception:
                    log.exception("Failed to pipeline %s", preemptor.name)
                assigned = True
                break
        return assigned
