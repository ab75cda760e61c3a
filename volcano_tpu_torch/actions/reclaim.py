"""Reclaim action (pkg/scheduler/actions/reclaim/reclaim.go).

Cross-queue resource reclaim: for a starved (non-overused) queue's
highest-order pending task, evict Running tasks belonging to *other* queues
(only when the victim's queue is Reclaimable), chosen by the tiered
ssn.Reclaimable intersection, until the reclaimed resources cover the task;
then pipeline it (reclaim.go:40-189).  Evictions are immediate
(session-level Evict), not statement-wrapped.
"""

from __future__ import annotations

import logging
from typing import Dict

from ..api import PodGroupPhase, Resource, TaskStatus
from ..utils.priority_queue import PriorityQueue
from ..utils.scheduler_helper import validate_victims

log = logging.getLogger(__name__)


class ReclaimAction:
    name = "reclaim"

    def initialize(self):
        pass

    def un_initialize(self):
        pass

    def execute(self, ssn) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        queue_set = set()
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, PriorityQueue] = {}

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
                log.error("Failed to find queue %s for job %s/%s",
                          job.queue, job.namespace, job.name)
                continue
            if queue.uid not in queue_set:
                queue_set.add(queue.uid)
                queues.push(queue)
            pending = job.task_status_index.get(TaskStatus.Pending, {})
            if pending:
                preemptors_map.setdefault(
                    job.queue, PriorityQueue(ssn.job_order_fn)
                ).push(job)
                tq = PriorityQueue(ssn.task_order_fn)
                for task in pending.values():
                    tq.push(task)
                preemptor_tasks[job.uid] = tq

        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                log.debug("Queue %s is overused, ignore it", queue.name)
                continue
            jobs = preemptors_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()
            tasks = preemptor_tasks.get(job.uid)
            if tasks is None or tasks.empty():
                continue
            task = tasks.pop()

            assigned = False
            for node in ssn.nodes.values():
                try:
                    ssn.predicate_fn(task, node)
                except Exception:
                    continue
                resreq = task.init_resreq.clone()
                reclaimed = Resource.empty()

                reclaimees = []
                for resident in node.tasks.values():
                    if resident.status != TaskStatus.Running:
                        continue
                    rjob = ssn.jobs.get(resident.job)
                    if rjob is None:
                        continue
                    if rjob.queue != job.queue:
                        victim_queue = ssn.queues.get(rjob.queue)
                        if victim_queue is None or not victim_queue.reclaimable():
                            continue
                        reclaimees.append(resident.clone())
                victims = ssn.reclaimable(task, reclaimees)
                try:
                    validate_victims(task, node, victims)
                except ValueError as err:
                    log.debug("No validated victims on %s: %s",
                              node.name, err)
                    continue

                for reclaimee in victims:
                    try:
                        ssn.evict(reclaimee, "reclaim")
                    except Exception:
                        log.exception("Failed to reclaim %s", reclaimee.name)
                        continue
                    reclaimed.add(reclaimee.resreq)
                    if resreq.less_equal(reclaimed):
                        break

                if task.init_resreq.less_equal(reclaimed):
                    try:
                        ssn.pipeline(task, node.name)
                    except Exception:
                        log.exception("Failed to pipeline %s", task.name)
                    assigned = True
                    break

            if assigned:
                jobs.push(job)
            queues.push(queue)
