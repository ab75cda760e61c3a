"""Admission validators and mutators.

Rules ported from the reference's admission webhooks:
- job create: ``admit_job.go:106-196`` (minAvailable > 0, maxRetry >= 0,
  ttl >= 0, tasks non-empty, DNS-label task names, no duplicate task names,
  replicas >= 0, total replicas >= minAvailable, policy validation, known
  plugins, queue exists and is Open)
- job update: ``admit_job.go:198-240`` (only minAvailable and
  tasks[*].replicas may change; no task add/remove)
- policies: ``admission/jobs/validate/util.go`` (event xor exitCode, no
  exit code 0, no duplicate events, externally-usable events/actions only)
- queue: ``validate_queue.go:64-128`` (state Open/Closed; default queue
  undeletable)
- pod: ``admission/pods/admit_pod.go:67-130`` (gate pod creation until its
  PodGroup is non-pending)
"""

from __future__ import annotations

import re
from typing import List

from ..api import GROUP_NAME_ANNOTATION, Pod, PodGroupPhase, QueueState
from ..controllers.apis import Action, Event, Job, LifecyclePolicy

_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")

# Which events/actions users may reference in policies (util.go:33-53).
EXTERNAL_EVENTS = {
    Event.Any.value,
    Event.PodFailed.value,
    Event.PodEvicted.value,
    Event.Unknown.value,
    Event.TaskCompleted.value,
    Event.DeviceUnhealthy.value,
}
EXTERNAL_ACTIONS = {
    Action.AbortJob.value,
    Action.RestartJob.value,
    Action.RestartTask.value,
    Action.TerminateJob.value,
    Action.CompleteJob.value,
    Action.ResumeJob.value,
}


class AdmissionError(ValueError):
    """Request rejected by admission."""


def _validate_policies(policies: List[LifecyclePolicy], where: str) -> List[str]:
    msgs: List[str] = []
    seen_events = set()
    seen_exit_codes = set()
    for policy in policies:
        has_event = bool(policy.event or policy.events)
        if has_event and policy.exit_code is not None:
            msgs.append(
                f"{where}: must not specify event and exitCode simultaneously"
            )
            break
        if not has_event and policy.exit_code is None:
            msgs.append(f"{where}: either event or exitCode should be specified")
            break
        if policy.action not in EXTERNAL_ACTIONS:
            msgs.append(f"{where}: invalid policy action {policy.action}")
            break
        if has_event:
            ok = True
            for event in policy.event_list():
                if event not in EXTERNAL_EVENTS:
                    msgs.append(f"{where}: invalid policy event {event}")
                    ok = False
                    break
                if event in seen_events:
                    msgs.append(
                        f"{where}: duplicate event {event} across policies"
                    )
                    ok = False
                    break
                seen_events.add(event)
            if not ok:
                break
        else:
            if policy.exit_code == 0:
                msgs.append(f"{where}: 0 is not a valid error code")
                break
            if policy.exit_code in seen_exit_codes:
                msgs.append(
                    f"{where}: duplicate exitCode {policy.exit_code}"
                )
                break
            seen_exit_codes.add(policy.exit_code)
    # "if there's * here, no other policy should be here" (util.go).
    if "*" in seen_events and len(seen_events) > 1:
        msgs.append(
            f"{where}: if there's * here, no other policy should be here"
        )
    return msgs


def _validate_io(volumes) -> List[str]:
    """VolumeSpec rules (admit_job.go validateIO, util.go:161-183)."""
    msgs: List[str] = []
    paths = set()
    for vol in volumes:
        if not vol.mount_path:
            msgs.append("mountPath is required")
            continue
        if vol.mount_path in paths:
            msgs.append(f"duplicated mountPath: {vol.mount_path}")
        paths.add(vol.mount_path)
        if vol.volume_claim is None and not vol.volume_claim_name:
            msgs.append(
                "either volumeClaim or volumeClaimName must be specified"
            )
        elif vol.volume_claim_name:
            if vol.volume_claim is not None:
                msgs.append(
                    "conflict: if you want to use an existing PVC, just "
                    "specify volumeClaimName; to create a new PVC, do "
                    "not specify volumeClaimName"
                )
            elif not _DNS1123.match(vol.volume_claim_name):
                msgs.append(
                    f"invalid volumeClaimName {vol.volume_claim_name!r} "
                    "(must be DNS-1123)"
                )
    return msgs


def validate_job_create(job: Job, store) -> None:
    msgs: List[str] = []
    if job.min_available <= 0:
        raise AdmissionError("'minAvailable' must be > 0.")
    if job.max_retry < 0:
        raise AdmissionError("'maxRetry' cannot be less than zero.")
    if (
        job.ttl_seconds_after_finished is not None
        and job.ttl_seconds_after_finished < 0
    ):
        raise AdmissionError("'ttlSecondsAfterFinished' cannot be less than zero.")
    if not job.tasks:
        raise AdmissionError("No task specified in job spec")

    task_names = set()
    total_replicas = 0
    for task in job.tasks:
        if task.replicas < 0:
            msgs.append(f"'replicas' < 0 in task: {task.name}")
        total_replicas += task.replicas
        if not _DNS1123.match(task.name or ""):
            msgs.append(f"invalid task name {task.name!r} (must be DNS-1123)")
        if task.name in task_names:
            msgs.append(f"duplicated task name {task.name}")
            break
        task_names.add(task.name)
        msgs.extend(_validate_policies(task.policies, f"task {task.name}"))
        if not task.containers:
            msgs.append(f"task {task.name} has no containers")

    if total_replicas < job.min_available:
        msgs.append(
            "'minAvailable' should not be greater than total replicas in tasks"
        )
    msgs.extend(_validate_policies(job.policies, "job"))
    msgs.extend(_validate_io(job.volumes))

    from ..controllers.job_plugins import PLUGIN_BUILDERS

    for name in job.plugins:
        if name not in PLUGIN_BUILDERS:
            msgs.append(f"unable to find job plugin: {name}")

    queue = store.raw_queues.get(job.queue)
    if queue is None:
        msgs.append(f"unable to find job queue: {job.queue}")
    elif queue.state != QueueState.Open.value:
        msgs.append(
            "can only submit job to queue with state `Open`, "
            f"queue `{queue.name}` status is `{queue.state}`"
        )
    if msgs:
        raise AdmissionError("; ".join(msgs))


def validate_job_update(old: Job, new: Job) -> None:
    total_replicas = 0
    for task in new.tasks:
        if task.replicas < 0:
            raise AdmissionError(
                f"'replicas' must be >= 0 in task: {task.name}"
            )
        total_replicas += task.replicas
    if new.min_available > total_replicas:
        raise AdmissionError(
            "'minAvailable' must not be greater than total replicas"
        )
    if new.min_available <= 0:
        raise AdmissionError("'minAvailable' must be > 0")
    if len(old.tasks) != len(new.tasks):
        raise AdmissionError("job updates may not add or remove tasks")
    # Only minAvailable and tasks[*].replicas may mutate.
    for old_task, new_task in zip(old.tasks, new.tasks):
        if (
            old_task.name != new_task.name
            or old_task.containers != new_task.containers
            or old_task.policies != new_task.policies
        ):
            raise AdmissionError(
                "job updates may not change fields other than "
                "`minAvailable`, `tasks[*].replicas` under spec"
            )
    # Volumes may not change; controller-generated claim names are
    # normalized away before comparing (admit_job.go:224-236).
    def _norm_vols(vols):
        return [
            (v.mount_path,
             "" if v.volume_claim is not None else v.volume_claim_name,
             v.volume_claim)
            for v in vols
        ]

    if (
        old.queue != new.queue
        or old.policies != new.policies
        or old.plugins != new.plugins
        or old.priority_class != new.priority_class
        or _norm_vols(old.volumes) != _norm_vols(new.volumes)
    ):
        raise AdmissionError(
            "job updates may not change fields other than "
            "`minAvailable`, `tasks[*].replicas` under spec"
        )


def mutate_job(job: Job) -> Job:
    """Defaulting (mutate_job.go:74-111): default queue + scheduler name."""
    if not job.queue:
        job.queue = "default"
    if not job.scheduler_name:
        job.scheduler_name = "volcano-tpu"
    if job.max_retry == 0:
        job.max_retry = 3
    return job


def validate_queue(queue) -> None:
    if queue.state and queue.state not in (
        QueueState.Open.value, QueueState.Closed.value
    ):
        raise AdmissionError(
            f"queue state must be in ['Open', 'Closed'], got {queue.state}"
        )
    if queue.weight < 0:
        raise AdmissionError("queue weight must be >= 0")


def validate_queue_delete(name: str) -> None:
    if name == "default":
        raise AdmissionError("`default` queue can not be deleted")


def validate_pod_create(pod: Pod, store) -> None:
    """Gate pod creation until its PodGroup is schedulable
    (admit_pod.go:67-130)."""
    group = pod.annotations.get(GROUP_NAME_ANNOTATION)
    if not group:
        return
    pg = store.pod_groups.get(f"{pod.namespace}/{group}")
    if pg is None:
        raise AdmissionError(
            f"failed to get PodGroup for pod <{pod.namespace}/{pod.name}>"
        )
    if pg.status.phase in ("", PodGroupPhase.Pending.value):
        raise AdmissionError(
            f"failed to create pod <{pod.namespace}/{pod.name}>, "
            f"because the podgroup phase is {pg.status.phase or 'Pending'}"
        )


class AdmittedStore:
    """A ClusterStore facade applying admission rules on mutations — the
    framework's submission API surface."""

    def __init__(self, store):
        self.store = store

    def __getattr__(self, name):
        return getattr(self.store, name)

    def add_batch_job(self, job: Job) -> None:
        job = mutate_job(job)
        validate_job_create(job, self.store)
        self.store.add_batch_job(job)

    def update_batch_job(self, job: Job) -> None:
        old = self.store.batch_jobs.get(job.key)
        if old is not None and old is not job:
            validate_job_update(old, job)
        self.store.update_batch_job(job)

    def add_queue(self, queue) -> None:
        validate_queue(queue)
        self.store.add_queue(queue)

    def update_queue(self, queue) -> None:
        validate_queue(queue)
        self.store.update_queue(queue)

    def delete_queue(self, name: str) -> None:
        validate_queue_delete(name)
        self.store.delete_queue(name)

    def add_pod(self, pod: Pod) -> None:
        validate_pod_create(pod, self.store)
        self.store.add_pod(pod)
