"""Priority plugin (pkg/scheduler/plugins/priority/priority.go).

Task/job order by priority value; victims only from lower-priority jobs
(priority.go:44-104).
"""

from __future__ import annotations

from typing import List

from ..api import JobInfo, TaskInfo

PLUGIN_NAME = "priority"


class PriorityPlugin:
    def __init__(self, arguments):
        self.arguments = arguments

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        def task_order_fn(l: TaskInfo, r: TaskInfo) -> int:
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_task_order_fn(self.name, task_order_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            if l.priority > r.priority:
                return -1
            if l.priority < r.priority:
                return 1
            return 0

        ssn.add_job_order_fn(self.name, job_order_fn)

        def preemptable_fn(preemptor: TaskInfo,
                           preemptees: List[TaskInfo]) -> List[TaskInfo]:
            preemptor_job = ssn.jobs.get(preemptor.job)
            if preemptor_job is None:
                return []
            victims = []
            for preemptee in preemptees:
                preemptee_job = ssn.jobs.get(preemptee.job)
                if preemptee_job is None:
                    continue
                if preemptee_job.priority < preemptor_job.priority:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name, preemptable_fn)

    def on_session_close(self, ssn) -> None:
        pass
