"""Proportion (weighted fair-share queue) plugin
(pkg/scheduler/plugins/proportion/proportion.go).

Computes each queue's ``deserved`` resources by iterative water-filling over
queue weights (proportion.go:117-173), orders queues by share, marks queues
Overused when allocated exceeds deserved, gates JobEnqueueable on queue
capability, and admits reclaim victims only while the victim queue stays at
or above its deserved share (proportion.go:190-215).

Device export: the final deserved matrix is exported to the session
(``ssn.queue_deserved``) so the allocate kernel's overuse gate consumes it
as a dense [Q, R] array.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..api import (
    JobInfo,
    QueueInfo,
    Resource,
    TaskInfo,
    TaskStatus,
    allocated_status,
    res_min,
    share,
)
from ..metrics import metrics

PLUGIN_NAME = "proportion"


@dataclass
class _QueueAttr:
    queue_id: str
    name: str
    weight: int
    share: float = 0.0
    deserved: Resource = field(default_factory=Resource.empty)
    allocated: Resource = field(default_factory=Resource.empty)
    request: Resource = field(default_factory=Resource.empty)


class ProportionPlugin:
    def __init__(self, arguments):
        self.arguments = arguments
        self.total_resource = Resource.empty()
        self.queue_opts: Dict[str, _QueueAttr] = {}

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    def _update_share(self, attr: _QueueAttr):
        res = 0.0
        for rn in attr.deserved.resource_names():
            s = share(attr.allocated.get(rn), attr.deserved.get(rn))
            if s > res:
                res = s
        attr.share = res
        metrics.queue_share.set(attr.share, queue_name=attr.name)

    def on_session_open(self, ssn) -> None:
        for node in ssn.nodes.values():
            self.total_resource.add(node.allocatable)

        # Build per-queue attributes from jobs (proportion.go:71-103).
        for job in ssn.jobs.values():
            if job.queue not in self.queue_opts:
                queue = ssn.queues.get(job.queue)
                if queue is None:
                    continue
                self.queue_opts[job.queue] = _QueueAttr(
                    queue_id=queue.uid, name=queue.name, weight=queue.weight
                )
            attr = self.queue_opts[job.queue]
            for status, tasks in job.task_status_index.items():
                if allocated_status(status):
                    for t in tasks.values():
                        attr.allocated.add(t.resreq)
                        attr.request.add(t.resreq)
                elif status == TaskStatus.Pending:
                    for t in tasks.values():
                        attr.request.add(t.resreq)

        for attr in self.queue_opts.values():
            metrics.queue_allocated_milli_cpu.set(
                attr.allocated.milli_cpu, queue_name=attr.name
            )
            metrics.queue_allocated_memory_bytes.set(
                attr.allocated.memory, queue_name=attr.name
            )
            metrics.queue_request_milli_cpu.set(
                attr.request.milli_cpu, queue_name=attr.name
            )
            metrics.queue_request_memory_bytes.set(
                attr.request.memory, queue_name=attr.name
            )
            metrics.queue_weight.set(attr.weight, queue_name=attr.name)

        # Iterative water-filling (proportion.go:117-173).
        remaining = self.total_resource.clone()
        meet: Dict[str, bool] = {}
        while True:
            total_weight = sum(
                attr.weight
                for attr in self.queue_opts.values()
                if attr.queue_id not in meet
            )
            if total_weight == 0:
                break
            increased = Resource.empty()
            decreased = Resource.empty()
            for attr in self.queue_opts.values():
                if attr.queue_id in meet:
                    continue
                old_deserved = attr.deserved.clone()
                attr.deserved.add(
                    remaining.clone().multi(attr.weight / float(total_weight))
                )
                if attr.request.less(attr.deserved):
                    attr.deserved = res_min(attr.deserved, attr.request)
                    meet[attr.queue_id] = True
                self._update_share(attr)
                inc, dec = attr.deserved.diff(old_deserved)
                increased.add(inc)
                decreased.add(dec)
                metrics.queue_deserved_milli_cpu.set(
                    attr.deserved.milli_cpu, queue_name=attr.name
                )
                metrics.queue_deserved_memory_bytes.set(
                    attr.deserved.memory, queue_name=attr.name
                )
            remaining.sub(increased).add(decreased)
            if remaining.is_empty():
                break

        # Device export: the allocate kernel's overuse gate compares
        # queue allocation (at open + in-kernel updates) against deserved.
        ssn.queue_deserved = {
            qid: attr.deserved.clone() for qid, attr in self.queue_opts.items()
        }
        ssn.queue_allocated_open = {
            qid: attr.allocated.clone() for qid, attr in self.queue_opts.items()
        }

        def queue_order_fn(l: QueueInfo, r: QueueInfo) -> int:
            la = self.queue_opts.get(l.uid)
            ra = self.queue_opts.get(r.uid)
            ls = la.share if la else 0.0
            rs = ra.share if ra else 0.0
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_queue_order_fn(self.name, queue_order_fn)

        def reclaimable_fn(reclaimer: TaskInfo,
                           reclaimees: List[TaskInfo]) -> List[TaskInfo]:
            victims = []
            allocations: Dict[str, Resource] = {}
            for reclaimee in reclaimees:
                job = ssn.jobs.get(reclaimee.job)
                if job is None:
                    continue
                attr = self.queue_opts.get(job.queue)
                if attr is None:
                    continue
                if job.queue not in allocations:
                    allocations[job.queue] = attr.allocated.clone()
                allocated = allocations[job.queue]
                if allocated.less(reclaimee.resreq):
                    continue
                allocated.sub(reclaimee.resreq)
                # Victim only while the queue stays at/above deserved
                # (proportion.go:209-211).
                if attr.deserved.less_equal_strict(allocated):
                    victims.append(reclaimee)
            return victims

        ssn.add_reclaimable_fn(self.name, reclaimable_fn)

        def overused_fn(queue: QueueInfo) -> bool:
            attr = self.queue_opts.get(queue.uid)
            if attr is None:
                return False
            over = not attr.allocated.less_equal(attr.deserved)
            metrics.queue_overused.set(1.0 if over else 0.0,
                                       queue_name=attr.name)
            return over

        ssn.add_overused_fn(self.name, overused_fn)

        def job_enqueueable_fn(job: JobInfo) -> bool:
            queue = ssn.queues.get(job.queue)
            attr = self.queue_opts.get(job.queue)
            if queue is None:
                return True
            # No capability set -> always enqueue (proportion.go:237-241).
            if not queue.queue.capability:
                return True
            if job.pod_group is None or job.pod_group.min_resources is None:
                return True
            min_req = Resource.from_resource_list(job.pod_group.min_resources)
            allocated = attr.allocated if attr else Resource.empty()
            return min_req.add(allocated).less_equal(
                Resource.from_resource_list(queue.queue.capability)
            )

        ssn.add_job_enqueueable_fn(self.name, job_enqueueable_fn)

        from ..framework.session import EventHandler

        def on_allocate(event):
            job = ssn.jobs.get(event.task.job)
            if job is None:
                return
            attr = self.queue_opts.get(job.queue)
            if attr is None:
                return
            attr.allocated.add(event.task.resreq)
            metrics.queue_allocated_milli_cpu.set(
                attr.allocated.milli_cpu, queue_name=attr.name
            )
            self._update_share(attr)

        def on_deallocate(event):
            job = ssn.jobs.get(event.task.job)
            if job is None:
                return
            attr = self.queue_opts.get(job.queue)
            if attr is None:
                return
            attr.allocated.sub(event.task.resreq)
            metrics.queue_allocated_milli_cpu.set(
                attr.allocated.milli_cpu, queue_name=attr.name
            )
            self._update_share(attr)

        ssn.add_event_handler(
            EventHandler(allocate_func=on_allocate,
                         deallocate_func=on_deallocate)
        )

    def on_session_close(self, ssn) -> None:
        self.total_resource = Resource.empty()
        self.queue_opts = {}
