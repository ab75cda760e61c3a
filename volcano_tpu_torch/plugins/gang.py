"""Gang scheduling plugin (pkg/scheduler/plugins/gang/gang.go).

JobValid vetoes jobs with fewer valid tasks than MinAvailable (gang.go:51-72);
victims are protected so a job never drops below MinAvailable (gang.go:74-98);
job order boosts non-ready jobs (gang.go:104-129); JobReady/JobPipelined come
from the job counters (gang.go:130-137); session close writes Unschedulable
conditions and metrics (gang.go:140-183).
"""

from __future__ import annotations

from typing import Dict, List

from ..api import (
    JobInfo,
    PodGroupCondition,
    TaskInfo,
    TaskStatus,
    ValidateResult,
)
from ..framework.framework import POD_GROUP_UNSCHEDULABLE
from ..metrics import metrics

PLUGIN_NAME = "gang"
NOT_ENOUGH_PODS = "NotEnoughPods"
NOT_ENOUGH_RESOURCES = "NotEnoughResources"


class GangPlugin:
    def __init__(self, arguments):
        self.arguments = arguments

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        def valid_job_fn(obj) -> ValidateResult:
            job: JobInfo = obj
            vtn = job.valid_task_num()
            if vtn < job.min_available:
                return ValidateResult(
                    pass_=False,
                    reason=NOT_ENOUGH_PODS,
                    message=(
                        "Not enough valid tasks for gang-scheduling, "
                        f"valid: {vtn}, min: {job.min_available}"
                    ),
                )
            return None

        ssn.add_job_valid_fn(self.name, valid_job_fn)

        def preemptable_fn(preemptor: TaskInfo,
                           preemptees: List[TaskInfo]) -> List[TaskInfo]:
            victims: List[TaskInfo] = []
            occupied: Dict[str, int] = {}
            for preemptee in preemptees:
                job = ssn.jobs.get(preemptee.job)
                if job is None:
                    continue
                if job.uid not in occupied:
                    occupied[job.uid] = job.ready_task_num()
                cnt = occupied[job.uid]
                preemptable = job.min_available <= cnt - 1 or job.min_available == 1
                if preemptable:
                    occupied[job.uid] = cnt - 1
                    victims.append(preemptee)
            return victims

        ssn.add_reclaimable_fn(self.name, preemptable_fn)
        ssn.add_preemptable_fn(self.name, preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            l_ready, r_ready = l.ready(), r.ready()
            if l_ready and r_ready:
                return 0
            if l_ready:
                return 1
            if r_ready:
                return -1
            return 0

        ssn.add_job_order_fn(self.name, job_order_fn)
        ssn.add_job_ready_fn(self.name, lambda job: job.ready())
        ssn.add_job_pipelined_fn(self.name, lambda job: job.pipelined())

    def on_session_close(self, ssn) -> None:
        unready_task_count = 0
        unschedulable_jobs = 0
        for job in ssn.jobs.values():
            if job.ready():
                continue
            unready_task_count = job.min_available - job.ready_task_num()
            msg = (
                f"{job.min_available - job.ready_task_num()}/{len(job.tasks)} "
                f"tasks in gang unschedulable: {job.fit_error()}"
            )
            job.job_fit_errors = msg
            unschedulable_jobs += 1
            metrics.unschedule_task_count.set(
                unready_task_count, job_name=job.name
            )
            metrics.job_retry_counts.inc(job_name=job.name)
            ssn.update_job_condition(
                job,
                PodGroupCondition(
                    type=POD_GROUP_UNSCHEDULABLE,
                    status="True",
                    transition_id=ssn.uid,
                    reason=NOT_ENOUGH_RESOURCES,
                    message=msg,
                ),
            )
        metrics.unschedule_job_count.set(unschedulable_jobs)
