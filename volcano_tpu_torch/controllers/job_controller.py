"""Job controller: reconciles batch Jobs into PodGroups + Pods.

Mirrors ``pkg/controllers/job``: store events become Requests
(job_controller_handler.go), ``applyPolicies`` maps request events through
task- then job-level lifecycle policies (job_controller_util.go:110-184),
and the state machine (``state.py``) drives ``sync_job``/``kill_job``
(job_controller_actions.go):

- initiate: create the PodGroup (with MinResources aggregated from the
  highest-priority MinAvailable tasks, job_controller_actions.go:545) and
  run job plugins (svc/ssh/env rendezvous wiring)
- GATE: pods are only created once the PodGroup leaves Pending
  (job_controller_actions.go:227-231) — i.e. after the scheduler's enqueue
  action admits the job
- sync: diff desired vs actual pods per task (create/delete for scale
  up/down), classify pod phases into status counters
- kill: delete non-retained pods, bump job version, delete the PodGroup

The controller is synchronous against the store: ``process_all()`` drains
the request queue (the reference's sharded worker loop collapses to this in
a single-process store-of-record design).

A job's pods come from an index kept off the store's pod events (uids per
owner job, in the order the store holds them), not from a scan of every
pod per request: the same pods in the same order, at a cost that does not
grow with the cluster's other jobs.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Set

from ..api import (
    GROUP_NAME_ANNOTATION,
    Pod,
    PodGroup,
    PodGroupPhase,
    PodPhase,
    Resource,
)
from ..cache import ClusterStore
from .apis import Action, Event, Job, JobPhase, JobStatus, Request
from .job_plugins import get_job_plugin
from .state import new_state

log = logging.getLogger(__name__)

FINISHED_PHASES = (
    JobPhase.Completed.value,
    JobPhase.Failed.value,
    JobPhase.Terminated.value,
)


def apply_policies(job: Job, req: Request) -> str:
    """job_controller_util.go:110-184."""
    if req.action:
        return req.action
    if req.event == Event.OutOfSync.value:
        return Action.SyncJob.value
    if req.job_version < job.status.version:
        return Action.SyncJob.value

    def match(policies) -> Optional[str]:
        for policy in policies:
            events = policy.event_list()
            if events and req.event:
                if req.event in events or Event.Any.value in events:
                    return policy.action
            if policy.exit_code is not None and policy.exit_code == req.exit_code:
                return policy.action
        return None

    if req.task_name:
        for task in job.tasks:
            if task.name == req.task_name:
                action = match(task.policies)
                if action:
                    return action
                break
    action = match(job.policies)
    if action:
        return action
    return Action.SyncJob.value


class JobController:
    def __init__(self, store: ClusterStore):
        self.store = store
        self.queue: Deque[Request] = deque()
        # Jobs whose sync failed on missing IO (named PVC not yet
        # created): retried at the next reconcile pump — the analog of
        # the reference's rate-limited workqueue requeue on syncJob error.
        self._retry_keys: set = set()
        # owner job key -> {pod uid: None}, in store order; rebuilt from
        # one scan when a pod changes owner (``_pods_dirty``).
        self._pods_by_job: Dict[str, Dict[str, None]] = {}
        self._pod_owner: Dict[str, str] = {}
        self._pods_dirty = True
        store.watch(self._on_store_event)

    # ------------------------------------------------------------- watchers

    def _on_store_event(self, kind: str, event: str, obj) -> None:
        if kind == "Job":
            if event in ("add", "update"):
                self.queue.append(
                    Request(namespace=obj.namespace, job_name=obj.name,
                            event=Event.OutOfSync.value)
                )
            elif event == "delete":
                self._cleanup_job(obj)
        elif kind == "Pod":
            pod = obj
            self._index_pod(event, pod)
            if not pod.owner_job:
                return
            ns, name = pod.owner_job.split("/", 1)
            # The pod carries the job version it was created under
            # (job_controller_handler.go:154-178), so stale-generation pod
            # events degrade to sync instead of firing policies.
            version = int(pod.annotations.get("volcano-tpu/job-version", "0"))
            if event == "update":
                if pod.phase == PodPhase.Failed:
                    self.queue.append(
                        Request(namespace=ns, job_name=name,
                                task_name=pod.task_name,
                                event=Event.PodFailed.value,
                                exit_code=pod.exit_code,
                                job_version=version)
                    )
                elif pod.phase == PodPhase.Succeeded:
                    self.queue.append(
                        Request(namespace=ns, job_name=name,
                                task_name=pod.task_name,
                                event=Event.TaskCompleted.value,
                                job_version=version)
                    )
                else:
                    self.queue.append(
                        Request(namespace=ns, job_name=name,
                                event=Event.OutOfSync.value)
                    )
            elif event == "evict":
                self.queue.append(
                    Request(namespace=ns, job_name=name,
                            task_name=pod.task_name,
                            event=Event.PodEvicted.value,
                            job_version=version)
                )
            elif event == "delete":
                self.queue.append(
                    Request(namespace=ns, job_name=name,
                            event=Event.OutOfSync.value)
                )
        elif kind == "Node" and event == "update":
            # Device/node health: a node going NotReady raises
            # DeviceUnhealthy for every job with pods on it (the
            # accelerator-native failure event).
            node_info = self.store.nodes.get(obj.name)
            if obj.ready or node_info is None:
                return
            for resident in node_info.tasks.values():
                pod = resident.pod
                if not pod.owner_job:
                    continue
                ns, name = pod.owner_job.split("/", 1)
                self.queue.append(
                    Request(
                        namespace=ns, job_name=name,
                        task_name=pod.task_name,
                        event=Event.DeviceUnhealthy.value,
                        job_version=int(
                            pod.annotations.get("volcano-tpu/job-version", "0")
                        ),
                    )
                )
        elif kind == "PodGroup" and event == "status":
            if obj.owner_job:
                ns, name = obj.owner_job.split("/", 1)
                self.queue.append(
                    Request(namespace=ns, job_name=name,
                            event=Event.OutOfSync.value)
                )
        elif kind == "Command" and event == "add":
            if obj.target_kind == "Job":
                self.store.delete_command(obj.name)
                self.queue.append(
                    Request(
                        namespace=obj.target_namespace,
                        job_name=obj.target_name,
                        event=Event.CommandIssued.value,
                        action=obj.action,
                    )
                )

    # ------------------------------------------------------------- requests

    def process_all(self, max_iters: int = 10000) -> None:
        if self._retry_keys:
            retry, self._retry_keys = self._retry_keys, set()
            for key in retry:
                ns, name = key.split("/", 1)
                self.queue.append(
                    Request(namespace=ns, job_name=name,
                            event=Event.OutOfSync.value)
                )
        iters = 0
        while self.queue and iters < max_iters:
            req = self.queue.popleft()
            iters += 1
            try:
                self._process(req)
            except Exception:
                log.exception("Failed to process request %s", req)

    def _process(self, req: Request) -> None:
        key = f"{req.namespace}/{req.job_name}"
        job = self.store.batch_jobs.get(key)
        if job is None:
            return
        action = apply_policies(job, req)
        phase_before = job.status.state.phase
        state = new_state(self, job)
        state.execute(action)
        if job.status.state.phase != phase_before:
            # A phase transition re-queues the job (the reference's status
            # update round-trips through the informer into a new request).
            self.queue.append(
                Request(namespace=req.namespace, job_name=req.job_name,
                        event=Event.OutOfSync.value)
            )

    # --------------------------------------------------------------- helpers

    def _index_pod(self, event: str, pod: Pod) -> None:
        """Keep ``_pods_by_job`` in the store's order (called under the
        store lock, with each pod event)."""
        if self._pods_dirty:
            return
        uid = pod.uid
        old = self._pod_owner.get(uid)
        if event == "delete":
            if old is not None:
                self._pods_by_job[old].pop(uid, None)
                del self._pod_owner[uid]
            return
        owner = pod.owner_job or ""
        if old is None:
            if uid in self.store.pods:
                # A new key: the store appended it.
                self._pods_by_job.setdefault(owner, {})[uid] = None
                self._pod_owner[uid] = owner
        elif old != owner:
            # An owner change keeps the store's position, which the
            # index cannot place: rebuild from the store on next read.
            self._pods_dirty = True

    def _job_pods(self, job: Job) -> List[Pod]:
        store = self.store
        with store._lock:
            if self._pods_dirty:
                self._pods_by_job = {}
                self._pod_owner = {}
                for uid, p in store.pods.items():
                    owner = p.owner_job or ""
                    self._pods_by_job.setdefault(owner, {})[uid] = None
                    self._pod_owner[uid] = owner
                self._pods_dirty = False
            uids = self._pods_by_job.get(job.key, ())
            return [store.pods[u] for u in uids if u in store.pods]

    def _classify(self, pods: List[Pod]) -> Dict[str, int]:
        counts = {"pending": 0, "running": 0, "succeeded": 0, "failed": 0,
                  "terminating": 0, "unknown": 0}
        for pod in pods:
            if pod.deleting:
                counts["terminating"] += 1
            elif pod.phase == PodPhase.Pending:
                counts["pending"] += 1
            elif pod.phase == PodPhase.Running:
                counts["running"] += 1
            elif pod.phase == PodPhase.Succeeded:
                counts["succeeded"] += 1
            elif pod.phase == PodPhase.Failed:
                counts["failed"] += 1
            else:
                counts["unknown"] += 1
        return counts

    def _plugins(self, job: Job):
        out = []
        for name, args in job.plugins.items():
            plugin = get_job_plugin(name, args)
            if plugin is not None:
                out.append(plugin)
        return out

    def _calc_pg_min_resources(self, job: Job) -> Dict[str, object]:
        """Sum requests of the MinAvailable highest-priority task replicas
        (job_controller_actions.go calcPGMinResources, simplified: spec
        order stands in for priority-class ordering)."""
        total = Resource.empty()
        remaining = job.min_available
        for task in job.tasks:
            per_replica = Resource.empty()
            for c in task.containers:
                per_replica.add(Resource.from_resource_list(c))
            n = min(task.replicas, max(remaining, 0))
            for _ in range(n):
                total.add(per_replica)
            remaining -= n
            if remaining <= 0:
                break
        out = {
            "cpu": f"{int(total.milli_cpu)}m",
            "memory": total.memory,
        }
        # Extended/scalar resources (accelerators) must survive into
        # MinResources or the enqueue gate can't see the demand.
        if total.scalars:
            for name, quant in total.scalars.items():
                out[name] = f"{int(quant)}m"
        return out

    def _create_job_io(self, job: Job) -> bool:
        """PVC creation for the job's volumes (createJobIOIfNotExist,
        job_controller_actions.go:394-460).  Returns False when a named
        claim is missing — the job stays Pending (no PodGroup, no pods)
        until the claim appears, exactly the reference's behavior."""
        for vol in job.volumes:
            name = vol.volume_claim_name
            if not name and vol.volume_claim is None:
                # Unvalidated submission path (raw store.add_batch_job
                # bypasses admission): flag instead of generating a name
                # for a claim that can never exist.
                self.store.record_event(
                    f"Job/{job.key}", "InvalidVolume",
                    "either volumeClaim or volumeClaimName must be "
                    "specified",
                )
                return False
            if not name:
                # Generate a unique claim name and persist it on the
                # spec (GenPVCName + spec update, :404-420).
                from ..api import new_uid

                while True:
                    name = f"{job.name}-volume-{new_uid('pvc')[-12:]}"
                    if f"{job.namespace}/{name}" not in self.store.pvcs:
                        break
                vol.volume_claim_name = name
            if f"{job.namespace}/{name}" not in self.store.pvcs:
                if vol.volume_claim is not None:
                    # Controller-owned claim: create it — including
                    # recreating one that vanished after a restart or
                    # out-of-band delete (we still hold the spec).
                    self.store.put_pvc(job.namespace, name,
                                       vol.volume_claim,
                                       owner_job=job.key)
                else:
                    self.store.record_event(
                        f"Job/{job.key}", "PVCNotFound",
                        f"pvc {name} is not found, the job will be in "
                        "the Pending state until the PVC is created",
                    )
                    return False
            job.status.controlled_resources[f"volume-pvc-{name}"] = name
        return True

    def _initiate_job(self, job: Job) -> bool:
        """+finalizer, phase Pending, PVCs, PodGroup, plugins
        (job_controller_actions.go:144-176,394-531).  Returns False when
        job IO isn't ready yet (missing claim): the sync is retried."""
        if "volcano-tpu/job-cleanup" not in job.finalizers:
            job.finalizers.append("volcano-tpu/job-cleanup")
        if not job.status.state.phase:
            job.status.state.phase = JobPhase.Pending.value
        job.status.min_available = job.min_available

        if not self._create_job_io(job):
            return False

        pg_uid = f"{job.namespace}/{job.name}"
        if pg_uid not in self.store.pod_groups:
            pg = PodGroup(
                name=job.name,
                namespace=job.namespace,
                min_member=job.min_available,
                queue=job.queue,
                priority_class=job.priority_class,
                min_resources=self._calc_pg_min_resources(job),
                owner_job=job.key,
            )
            self.store.add_pod_group(pg)
        for plugin in self._plugins(job):
            # Run each plugin's job-add hook once per job generation
            # (the reference guards via Status.ControlledResources,
            # svc/svc.go:128) — re-running would e.g. rotate ssh keys.
            marker = f"plugin-{plugin.name}"
            if marker in job.status.controlled_resources:
                continue
            plugin.on_job_add(job, self.store)
            job.status.controlled_resources[marker] = plugin.name
        return True

    def _pod_name(self, job: Job, task, index: int) -> str:
        return f"{job.name}-{task.name}-{index}"

    def _create_pod(self, job: Job, task, index: int, global_index: int) -> Pod:
        pod = Pod(
            name=self._pod_name(job, task, index),
            namespace=job.namespace,
            containers=[dict(c) for c in task.containers],
            init_containers=[dict(c) for c in task.init_containers],
            labels={
                **task.labels,
                "volcano-tpu/job-name": job.name,
                "volcano-tpu/job-namespace": job.namespace,
                "volcano-tpu/task-spec": task.name,
            },
            annotations={
                GROUP_NAME_ANNOTATION: job.name,
                "volcano-tpu/task-index": str(index),
                "volcano-tpu/global-index": str(global_index),
                "volcano-tpu/job-version": str(job.status.version),
            },
            node_selector=dict(task.node_selector),
            tolerations=list(task.tolerations),
            host_ports=list(task.host_ports),
            env=dict(task.env),
            priority_class=job.priority_class,
            owner_job=job.key,
            task_name=task.name,
        )
        # Mount the job's volumes, one entry per claim (duplicate claim
        # names collapse to the first mount, job_controller_util.go:56-78).
        seen_claims = set()
        for vol in job.volumes:
            cn = vol.volume_claim_name
            if not cn or cn in seen_claims:
                continue
            seen_claims.add(cn)
            pod.volumes.append((cn, vol.mount_path))
        for plugin in self._plugins(job):
            plugin.on_pod_create(pod, job)
        return pod

    # ---------------------------------------------------------- sync / kill

    def sync_job(self, job: Job, update_status) -> None:
        if job.deleting:
            return
        if not self._initiate_job(job):
            # Missing claim: job stays Pending, re-synced next reconcile
            # (initiateJob error return, job_controller_actions.go:144).
            self._retry_keys.add(job.key)
            self.store.batch_jobs[job.key] = job
            return

        pods = self._job_pods(job)
        pg = self.store.pod_groups.get(f"{job.namespace}/{job.name}")
        # Pod creation gate (job_controller_actions.go:227-231).
        gate_open = pg is not None and pg.status.phase not in (
            "", PodGroupPhase.Pending.value
        )
        if gate_open:
            existing: Dict[str, Pod] = {p.name: p for p in pods}
            desired: Set[str] = set()
            global_index = 0
            for task in job.tasks:
                for i in range(task.replicas):
                    name = self._pod_name(job, task, i)
                    desired.add(name)
                    if name not in existing:
                        self.store.add_pod(
                            self._create_pod(job, task, i, global_index)
                        )
                    global_index += 1
            # Scale down: delete pods beyond desired replicas.
            for pod in pods:
                if pod.name not in desired and not pod.deleting:
                    self._delete_pod(pod)
            pods = self._job_pods(job)

        counts = self._classify(pods)
        job.status.pending = counts["pending"]
        job.status.running = counts["running"]
        job.status.succeeded = counts["succeeded"]
        job.status.failed = counts["failed"]
        job.status.terminating = counts["terminating"]
        job.status.unknown = counts["unknown"]
        job.status.min_available = job.min_available
        if update_status is not None and update_status(job.status):
            job.status.state.last_transition = time.time()
        self.store.batch_jobs[job.key] = job

    def kill_job(self, job: Job, retain_phases: Set[str], update_status) -> None:
        if job.deleting:
            return
        pods = self._job_pods(job)
        for pod in pods:
            if pod.deleting:
                continue
            if pod.phase in retain_phases:
                continue
            self._delete_pod(pod)
        counts = self._classify(self._job_pods(job))
        job.status = JobStatus(
            state=job.status.state,
            pending=counts["pending"],
            running=counts["running"],
            succeeded=counts["succeeded"],
            failed=counts["failed"],
            terminating=counts["terminating"],
            unknown=counts["unknown"],
            version=job.status.version + 1,
            min_available=job.min_available,
            retry_count=job.status.retry_count,
            controlled_resources=job.status.controlled_resources,
        )
        if update_status is not None and update_status(job.status):
            job.status.state.last_transition = time.time()
        # Delete the PodGroup (kill path).
        self.store.delete_pod_group(f"{job.namespace}/{job.name}")
        for plugin in self._plugins(job):
            plugin.on_job_delete(job, self.store)
        self.store.batch_jobs[job.key] = job

    def _delete_pod(self, pod: Pod) -> None:
        """Mark the pod terminating (the simulated kubelet finishes the
        deletion), mirroring the async pod Delete."""
        import copy as _copy

        updated = _copy.copy(pod)
        updated.deleting = True
        self.store.update_pod(updated)

    def _cleanup_job(self, job: Job) -> None:
        for pod in self._job_pods(job):
            self._delete_pod(pod)
        self.store.delete_pod_group(f"{job.namespace}/{job.name}")
        # Controller-created claims carry the job as owner and die with
        # it (owner refs on createPVC, job_controller_actions.go:512-531).
        self.store.delete_pvcs_owned_by(job.key)
        for plugin in self._plugins(job):
            plugin.on_job_delete(job, self.store)
