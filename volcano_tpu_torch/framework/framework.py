"""OpenSession / CloseSession (pkg/scheduler/framework/framework.go).

``POD_GROUP_UNSCHEDULABLE`` is the PodGroup condition type both the object
session and the fast path write when a gang cannot be scheduled.

Open: snapshot -> Session, instantiate plugins from the config tiers, run
OnSessionOpen, and evict invalid jobs (writing Unschedulable conditions,
session.go:104-131).  Close: run OnSessionClose, then write job statuses
back to the store (jobUpdater semantics, job_updater.go + session.go
jobStatus).
"""

from __future__ import annotations

import logging
from typing import List, Sequence

from ..api import (
    JobInfo,
    PodGroupCondition,
    PodGroupPhase,
    TaskStatus,
    allocated_status,
)
from ..metrics import metrics
from .arguments import Arguments
from .conf import Configuration, Tier
from .plugins import get_plugin_builder
from .session import Session

log = logging.getLogger(__name__)

POD_GROUP_UNSCHEDULABLE = "Unschedulable"


def open_session(cache, tiers: Sequence[Tier],
                 configurations: Sequence[Configuration] = ()) -> Session:
    ssn = Session(cache, tiers, configurations)

    # Session-open job validation sweep (session.go:107-131).  NOTE: this
    # runs BEFORE plugins register their validators — exactly like the
    # reference, where openSession() precedes plugin.OnSessionOpen — so
    # plugin JobValid checks only gate actions (allocate/preempt/...), not
    # session membership.  Enqueue deliberately sees pod-less Pending
    # PodGroups (delay-pod-creation design).
    for job in list(ssn.jobs.values()):
        if job.pod_group is not None and job.pod_group.status.conditions:
            ssn.pod_group_status[job.uid] = job.pod_group.status
        vr = ssn.job_valid(job)
        if vr is not None:
            if not vr.pass_:
                ssn.update_job_condition(
                    job,
                    PodGroupCondition(
                        type=POD_GROUP_UNSCHEDULABLE,
                        status="True",
                        transition_id=ssn.uid,
                        reason=vr.reason,
                        message=vr.message,
                    ),
                )
            del ssn.jobs[job.uid]

    # Instantiate + open plugins (framework.go:36-50).
    for tier in ssn.tiers:
        for opt in tier.plugins:
            builder = get_plugin_builder(opt.name)
            if builder is None:
                log.warning("Failed to get plugin %s", opt.name)
                continue
            if opt.name not in ssn.plugins:
                plugin = builder(Arguments(opt.arguments))
                ssn.plugins[opt.name] = plugin
    for name, plugin in ssn.plugins.items():
        with metrics.plugin_timer(name, "OnSessionOpen"), \
                ssn.tracer.span(f"plugin:{name}", cat="plugin",
                                args={"phase": "OnSessionOpen"}):
            plugin.on_session_open(ssn)

    log.debug(
        "Open session %s with %d jobs and %d queues",
        ssn.uid, len(ssn.jobs), len(ssn.queues),
    )
    return ssn


def _job_status(ssn: Session, job: JobInfo):
    """Derive the PodGroup status to write back (session.go jobStatus)."""
    status = job.pod_group.status
    unschedulable = any(
        c.type == POD_GROUP_UNSCHEDULABLE
        and c.status == "True"
        and c.transition_id == ssn.uid
        for c in status.conditions
    )
    running_tasks = len(job.task_status_index.get(TaskStatus.Running, {}))
    if running_tasks != 0 and unschedulable:
        status.phase = PodGroupPhase.Unknown.value
    else:
        allocated = 0
        for st, tasks in job.task_status_index.items():
            if allocated_status(st) or st == TaskStatus.Succeeded:
                allocated += len(tasks)
        if allocated >= job.min_available:
            status.phase = PodGroupPhase.Running.value
        elif job.pod_group.status.phase != PodGroupPhase.Inqueue.value:
            status.phase = PodGroupPhase.Pending.value
    status.running = running_tasks
    status.failed = len(job.task_status_index.get(TaskStatus.Failed, {}))
    status.succeeded = len(job.task_status_index.get(TaskStatus.Succeeded, {}))
    return status


def close_session(ssn: Session) -> None:
    for name, plugin in ssn.plugins.items():
        with metrics.plugin_timer(name, "OnSessionClose"), \
                ssn.tracer.span(f"plugin:{name}", cat="plugin",
                                args={"phase": "OnSessionClose"}):
            plugin.on_session_close(ssn)

    # jobUpdater.UpdateAll: push PodGroup statuses back to the store.
    for job in ssn.jobs.values():
        if job.pod_group is None:
            continue
        job.pod_group.status = _job_status(ssn, job)
        ssn.cache.update_job_status(job)

    ssn.jobs = {}
    ssn.nodes = {}
    ssn.plugins = {}
    ssn.event_handlers = []
    log.debug("Close session %s", ssn.uid)
