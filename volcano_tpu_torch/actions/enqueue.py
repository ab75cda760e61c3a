"""Enqueue action (pkg/scheduler/actions/enqueue/enqueue.go).

Gates Pending PodGroups into the Inqueue phase when cluster
``total * overcommit - used`` covers the job's MinResources, consuming the
budget as jobs are admitted (enqueue.go:52-132).  The job controller only
creates pods once the PodGroup leaves Pending, so this is the cluster's
admission throttle.
"""

from __future__ import annotations

import heapq
import logging
from typing import Dict, List

from ..api import PodGroupPhase, Resource
from ..framework.arguments import get_action_args
from ..utils.priority_queue import PriorityQueue

log = logging.getLogger(__name__)

OVERCOMMIT_FACTOR_ARG = "overcommit-factor"
DEFAULT_OVERCOMMIT_FACTOR = 1.2


class EnqueueAction:
    name = "enqueue"

    def initialize(self):
        pass

    def un_initialize(self):
        pass

    def _overcommit_factor(self, ssn) -> float:
        args = get_action_args(ssn.configurations, self.name)
        if args is not None:
            return args.get_float(OVERCOMMIT_FACTOR_ARG, DEFAULT_OVERCOMMIT_FACTOR)
        return DEFAULT_OVERCOMMIT_FACTOR

    def execute(self, ssn) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        queue_set = set()
        jobs_map: Dict[str, PriorityQueue] = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                log.error("Failed to find queue %s for job %s/%s",
                          job.queue, job.namespace, job.name)
                continue
            if queue.uid not in queue_set:
                queue_set.add(queue.uid)
                queues.push(queue)
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == PodGroupPhase.Pending.value
            ):
                jobs_map.setdefault(
                    job.queue, PriorityQueue(ssn.job_order_fn)
                ).push(job)

        total = Resource.empty()
        used = Resource.empty()
        for node in ssn.nodes.values():
            total.add(node.allocatable)
            used.add(node.used)
        idle = total.clone().multi(self._overcommit_factor(ssn)).sub(used)

        while not queues.empty():
            if idle.is_empty():
                log.debug("Node idle resource is overused, stopping enqueue")
                break
            queue = queues.pop()
            jobs = jobs_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()

            inqueue = False
            if job.pod_group.min_resources is None:
                inqueue = True
            else:
                min_req = Resource.from_resource_list(
                    job.pod_group.min_resources
                )
                if ssn.job_enqueueable(job) and min_req.less_equal(idle):
                    idle.sub(min_req)
                    inqueue = True
            if inqueue:
                job.pod_group.status.phase = PodGroupPhase.Inqueue.value
            queues.push(queue)
