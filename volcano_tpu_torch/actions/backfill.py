"""Backfill action (pkg/scheduler/actions/backfill/backfill.go).

Places zero-request (BestEffort) pending tasks on any node passing
predicates, recording fit errors otherwise (backfill.go:39-88).
"""

from __future__ import annotations

import logging

from ..api import FitErrors, PodGroupPhase, TaskStatus

log = logging.getLogger(__name__)


class BackfillAction:
    name = "backfill"

    def initialize(self):
        pass

    def un_initialize(self):
        pass

    def execute(self, ssn) -> None:
        for job in list(ssn.jobs.values()):
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == PodGroupPhase.Pending.value
            ):
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.pass_:
                continue
            pending = list(
                job.task_status_index.get(TaskStatus.Pending, {}).values()
            )
            for task in pending:
                if not task.init_resreq.is_empty():
                    continue
                allocated = False
                fe = FitErrors()
                for node in ssn.nodes.values():
                    try:
                        ssn.predicate_fn(task, node)
                    except Exception as err:
                        fe.set_node_error(node.name, err)
                        continue
                    try:
                        ssn.allocate_task(task, node.name)
                    except Exception as err:
                        fe.set_node_error(node.name, err)
                        continue
                    allocated = True
                    break
                if not allocated:
                    job.nodes_fit_errors[task.uid] = fe
