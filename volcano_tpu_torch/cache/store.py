"""In-memory cluster store: the scheduler cache.

The counterpart of the JAX package's ``cache/store.py``, which mirrors
``pkg/scheduler/cache/cache.go``: a mutex-guarded mirror of cluster state
mutated through an event API (the analog of the reference's informer event
handlers, ``cache/event_handlers.go:178-731``), producing a deep-copied
``ClusterInfo`` snapshot per cycle (cache.go:652-730) and carrying the
struct-of-arrays mirror (``cache/mirror.py``) the fast cycle schedules
from.

What the port's fast cycle needs is here: the mirror, pod / node /
PodGroup / queue handlers, the bind path onto the binder (inline, or with
``async_bind`` queued on the dispatcher thread of ``cache/bindqueue.py``;
failures re-enter Pending with backoff through ``drain_bind_failures``),
the deferred bind-record walk (``defer_bind_records``: the asynchronous
commit leaves ``pod.node_name`` to the dispatcher, and any path that reads
pod records as scheduling truth forces it first through
``apply_pending_bind_records``), the pipelined session's slots
(``_inflight_solve``, ``_inflight_plan``, ``_solve_seq``, the solve worker
of ``pipeline.py``),
the evictor the preempt / reclaim lanes flush to, the migration ledger
(``migrations``: ``delete_pod`` restores a terminating eviction victim as a
fresh Pending pod), the event trails the cycle writes, PodGroup status
write-back, the claim registry the volume gate reads, and the cycle's cache
slots (``cycle_feed``, ``_devincr_cache``, ``device_snapshot``, the what-if
streak and backoff maps).

The object session's eviction (``evict``, cache.go:439-489) is here too:
the object session's preempt and reclaim evict through it, while the fast
lanes flush through ``evictor``.

The always-on observability of the JAX store is wired in every store: the
conservation auditor with its SLO tracker (``auditor``, ``auditor.slo``,
``mirror.audit``; kill switch ``VOLCANO_TPU_AUDIT=0``) and the pod-journey
log (``journey``, ``mirror.journey``; ``VOLCANO_TPU_JOURNEY=0`` leaves it
None).  The controller-plane records (batch jobs, commands, config maps,
secrets, services, network policies) are kept as the JAX store keeps them;
``persistence.py`` checkpoints them with the specs.

Not ported yet (ROADMAP.md, queue 1): lockdep, the JAX store's runtime
enforcement of ``# guarded-by:`` comments ("lockdep"); the remote solver
(``remote_solver``, "the solver service"); the device mesh
(``solve_mesh``, "multi-GPU").  Setting one of the two slots raises
``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import collections
import copy
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from ..api import (
    NAMESPACE_WEIGHT_KEY,
    ClusterInfo,
    JobInfo,
    NamespaceInfo,
    Node,
    NodeInfo,
    Pod,
    PodGroup,
    PodGroupCondition,
    PodPhase,
    PriorityClass,
    Queue,
    QueueInfo,
    ResourceQuota,
    TaskInfo,
    TaskStatus,
    pod_key,
)
from .interface import (
    Binder,
    BindFailure,
    Evictor,
    FakeBinder,
    FakeEvictor,
    FakeStatusUpdater,
    StatusUpdater,
    VolumeBinder,
)

log = logging.getLogger(__name__)

DEFAULT_QUEUE = "default"

def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a part of the JAX package the port does not run yet,
    naming its ROADMAP.md item."""
    return NotImplementedError(
        f"volcano_tpu_torch: {what} is not ported yet (ROADMAP.md, "
        f"queue 1: {item})")


class ClusterStore:
    """Mutex-guarded cluster state mirror + snapshotter."""

    def __init__(
        self,
        binder: Optional[Binder] = None,
        evictor: Optional[Evictor] = None,
        status_updater: Optional[StatusUpdater] = None,
        volume_binder: Optional[VolumeBinder] = None,
        default_queue: str = DEFAULT_QUEUE,
    ):
        self._lock = threading.RLock()
        self._jobs: Dict[str, JobInfo] = {}
        self._nodes: Dict[str, NodeInfo] = {}
        # The fast path commits directly to the pod records + array mirror
        # and marks the derived JobInfo/NodeInfo object model stale; it is
        # lazily rebuilt from pods on next access.
        self._objects_stale = False
        self.queues: Dict[str, QueueInfo] = {}
        self.priority_classes: Dict[str, PriorityClass] = {}
        self.namespace_weights: Dict[str, int] = {}
        self.pods: Dict[str, Pod] = {}
        self.pod_groups: Dict[str, PodGroup] = {}
        self.raw_queues: Dict[str, Queue] = {}
        # Count of live pods carrying volume claims: the commit's volume
        # gate skips on this O(1) check.
        self.n_volume_pods = 0
        # ns/name -> claim record {"spec", "phase", "node", "owner_job"}.
        self.pvcs: Dict[str, Dict[str, object]] = {}
        # Controller-plane records, as the JAX store keeps them: batch
        # jobs by key, commands by name, and ns/name -> data or spec.
        self.batch_jobs: Dict[str, object] = {}
        self.commands: Dict[str, object] = {}
        self.config_maps: Dict[str, Dict[str, str]] = {}
        self.secrets: Dict[str, Dict[str, bytes]] = {}
        self.services: Dict[str, Dict[str, object]] = {}
        self.network_policies: Dict[str, Dict[str, object]] = {}

        self.binder: Binder = binder or FakeBinder()
        self.evictor: Evictor = evictor or FakeEvictor()
        self.status_updater: StatusUpdater = (
            status_updater or FakeStatusUpdater())
        self.volume_binder: VolumeBinder = (
            volume_binder or StoreVolumeBinder(self))

        self._watchers: List[Callable[[str, str, object], None]] = []

        from .mirror import StoreMirror

        self.mirror = StoreMirror()
        self.mirror.attach(self.pods)

        # Asynchronous bind dispatch (cache.go:536-552 goroutine binds):
        # off by default, so a cycle's binds land before run_once returns.
        self.async_bind = False
        self._bind_dispatcher = None
        self._bind_fail_lock = threading.Lock()
        self._succeeded_bind_keys: List[str] = []
        self._failed_bind_keys: List[tuple] = []
        # "ns/name" -> (consecutive fails, retry-not-before ts, pod uid).
        self.bind_backoff: Dict[str, tuple] = {}

        # Per-object event trail, "Kind/ns/name" -> [reason, message,
        # count, first_ts, last_ts] entries deduplicated on (reason,
        # message); OrderedDict for O(1) FIFO eviction at the cap.
        self._events: "collections.OrderedDict[str, List[list]]" = (
            collections.OrderedDict())
        self._events_lock = threading.Lock()
        self._deferred_events: List[tuple] = []

        # The cycle's content-validated host-lane caches (fastpath.py,
        # fastpath_incr.py) and the device-incremental context
        # (ops/devincr.py), all written and read by the cycle thread under
        # _lock and dropped on close().
        self._job_rank_cache = None
        self._pending_order_cache = None
        self._encode_cache = None
        self._objarr_cache = None
        self._unbind_gather_cache = None
        self._close_gang_cache = None
        self._devincr_cache = None
        # Device-resident node snapshot (ops/devsnap.py), created by the
        # fast path on first use.
        self.device_snapshot = None
        # Workload-injection seam: called as feed(cycle) after the cycle's
        # derive and before its actions.
        self.cycle_feed = None
        # Pipelined sessions (pipeline.py): None reads
        # VOLCANO_TPU_PIPELINE, as in the JAX package.
        self.pipeline = None
        # The dispatched-but-uncommitted solve and what-if plan of a
        # pipelined session, written by the cycle thread at dispatch and
        # popped at the next cycle's top -- or by close() / Scheduler.stop()
        # on other threads, so both slots are taken under _lock.
        self._inflight_solve = None
        self._inflight_plan = None
        # The pipelined session's solve worker (pipeline.SolveWorker),
        # created at the first dispatch.
        self._solve_worker = None
        # Monotonic pipelined solve id: the flow link between a dispatch
        # span in cycle N and its fetch and commit spans in cycle N+1.
        self._solve_seq = 0
        # Deferred bind-record walks not yet materialized
        # (defer_bind_records).
        self._record_walk_lock = threading.Lock()
        self._pending_record_walks: List[list] = []
        # Migration ledger (actions/rebalance.py MigrationLedger), attached
        # by the first committed eviction wave; delete_pod restores
        # terminating victims through it.
        self.migrations = None
        # Per-(action, gang uid) starvation streaks and rejection backoffs
        # of the evict lanes (whatif.update_streaks / set_backoff).
        self._whatif_streaks: Dict[tuple, int] = {}
        self._whatif_backoff: Dict[tuple, int] = {}
        # The rebalance lane's own per-gang-uid streaks and rejection
        # backoffs (FastCycle._find_starved_gang), and the require-
        # contiguous gangs the topology pregate holds out of the solve
        # (counted on the gating transition only).
        self._rebalance_streaks: Dict[str, int] = {}
        self._rebalance_backoff: Dict[str, int] = {}
        self._topo_gated: set = set()
        # Where the cycle's solve runs: the card unless set to "cpu"
        # (Scheduler(store, device=...) sets it).
        self.device = None

        from ..obs import (Auditor, FlightRecorder, JourneyLog,
                           SLOTracker, Tracer, journey_on)

        self.tracer = Tracer()
        self.flight = FlightRecorder()
        # Conservation auditor + SLO layer (obs/audit.py, obs/slo.py),
        # internally synchronized (the auditor's lock nests inside _lock
        # and is never taken around store state).  The mirror's writers
        # declare pod-count flows through mirror.audit; the fast cycle
        # declares its own and reconciles at cycle end.
        self.auditor = Auditor()
        self.auditor.slo = SLOTracker()
        self.mirror.audit = self.auditor
        # Pod-journey log (obs/journey.py), synchronized the same way;
        # VOLCANO_TPU_JOURNEY=0 leaves the slot None.
        self.journey = (JourneyLog(slo=self.auditor.slo,
                                   auditor=self.auditor)
                        if journey_on() else None)
        self.mirror.journey = self.journey
        # The fast cycle's first-seen row masks for the journey's bulk
        # accounting (FastCycle._journey_masks), keyed on compact_gen.
        self._journey_masks = None
        self.last_cycle_lanes = None

        self.add_queue(Queue(name=default_queue, weight=1))

    # ------------------------------------------------- not-ported slots

    @property
    def remote_solver(self):
        return None

    @remote_solver.setter
    def remote_solver(self, value) -> None:
        if value is not None:
            raise not_ported("the remote solver (remote_solver)",
                              "the solver service")

    @property
    def solve_mesh(self):
        return None

    @solve_mesh.setter
    def solve_mesh(self, value) -> None:
        if value is not None:
            raise not_ported("a device mesh (solve_mesh)", "multi-GPU")

    # ------------------------------------------------------------- events

    EVENTS_PER_OBJECT = 16
    MAX_EVENT_OBJECTS = 100_000

    def record_event(self, key: str, reason: str, message: str) -> None:
        """Append a user-visible event to an object's trail
        (``key`` = "Kind/ns/name")."""
        now = time.time()
        with self._events_lock:
            self._drain_deferred_events_locked()
            self._record_event_locked(key, reason, message, now)

    def _record_event_locked(self, key, reason, message, now) -> None:
        if (key not in self._events
                and len(self._events) >= self.MAX_EVENT_OBJECTS):
            self._events.popitem(last=False)
        trail = self._events.setdefault(key, [])
        for ev in trail:
            if ev[0] == reason and ev[1] == message:
                ev[2] += 1
                ev[4] = now
                return
        trail.append([reason, message, 1, now, now])
        if len(trail) > self.EVENTS_PER_OBJECT:
            del trail[0]

    def record_events(self, items) -> None:
        """Batched ``record_event``: one lock acquisition and one clock
        read for a whole commit's worth of (key, reason, message)."""
        now = time.time()
        items = items if isinstance(items, list) else list(items)
        if len(items) >= self.MAX_EVENT_OBJECTS:
            # A batch that alone overflows the cap with distinct keys
            # leaves exactly its tail: clear and keep it.
            tail: Dict[str, List[list]] = {}
            for key, reason, message in reversed(items):
                if key not in tail:
                    tail[key] = [[reason, message, 1, now, now]]
                    if len(tail) >= self.MAX_EVENT_OBJECTS:
                        break
            if len(tail) >= self.MAX_EVENT_OBJECTS:
                with self._events_lock:
                    self._deferred_events.clear()
                    self._events.clear()
                    self._events.update(reversed(tail.items()))
                return
        with self._events_lock:
            self._drain_deferred_events_locked()
            for key, reason, message in items:
                self._record_event_locked(key, reason, message, now)

    def record_events_deferred(self, items) -> None:
        """O(1) enqueue of an event batch, folded into the trails at the
        next read/record instead of inside the scheduling cycle."""
        with self._events_lock:
            self._deferred_events.append((time.time(), items))

    def _drain_deferred_events_locked(self) -> None:
        if not self._deferred_events:
            return
        batches, self._deferred_events = self._deferred_events, []
        for now, items in batches:
            for key, reason, message in items:
                self._record_event_locked(key, reason, message, now)

    def events_for(self, key: str) -> List[dict]:
        with self._events_lock:
            self._drain_deferred_events_locked()
            return [
                {"reason": r, "message": m, "count": c,
                 "first_seen": f, "last_seen": l}
                for r, m, c, f, l in self._events.get(key, [])
            ]

    # ------------------------------------------------------ bind machinery

    def defer_bind_records(self, keys_a, hosts_a, pods_a) -> list:
        """Register a deferred bind batch (numpy object arrays).  The
        tolist + pod.node_name record walk runs when the batch is
        materialized -- normally on the bind dispatcher's thread, after
        the cycle (the reference's API-server-side NodeName write,
        cache.go:536-552) -- but any path about to read pod RECORDS as
        scheduling truth forces it first with
        ``apply_pending_bind_records`` (committed-but-unnamed pods would
        read as unbound and double-schedule)."""
        entry = [keys_a, hosts_a, pods_a, False]
        with self._record_walk_lock:
            self._pending_record_walks.append(entry)
        return entry

    def _materialize_bind_entry(self, entry: list):
        """Idempotent: lists + node_name walk applied exactly once, from
        whichever thread gets here first."""
        with self._record_walk_lock:
            if not entry[3]:
                keys = entry[0].tolist()
                hosts = entry[1].tolist()
                pods = entry[2].tolist()
                for pod, hostname in zip(pods, hosts):
                    pod.node_name = hostname
                entry[0], entry[1], entry[2] = keys, hosts, pods
                entry[3] = True
                # Removed by IDENTITY, never with list.remove: remove scans
                # with ==, and comparing this entry with another pending
                # one compares numpy object arrays elementwise (an
                # ambiguous-truth ValueError), which would strand the
                # entry and make apply_pending_bind_records loop forever.
                self._pending_record_walks = [
                    e for e in self._pending_record_walks if e is not entry]
            return entry[0], entry[1], entry[2]

    def apply_pending_bind_records(self) -> None:
        """Apply every registered deferred record walk now -- before any
        path that treats pod records as scheduling truth (the mirror
        resync of a failed cycle, the object session)."""
        while True:
            with self._record_walk_lock:
                if not self._pending_record_walks:
                    return
                entry = self._pending_record_walks[0]
            self._materialize_bind_entry(entry)

    def dispatch_binds(self, keys, hosts, pods,
                       entry: Optional[list] = None) -> None:
        """Dispatch a batch of binds to the binder: queued on the
        background dispatcher when ``async_bind`` is set (failures surface
        at the next cycle's ``drain_bind_failures``), else drained inline
        the same way.  ``entry`` marks a deferred batch from
        ``defer_bind_records`` (keys / hosts / pods then None)."""
        if self.async_bind:
            if self._bind_dispatcher is None:
                from .bindqueue import BindDispatcher

                self._bind_dispatcher = BindDispatcher(
                    self.binder, self._on_bind_failures,
                    on_success=self._on_bind_success,
                    materialize=self._materialize_bind_entry,
                )
            self._bind_dispatcher.dispatch(keys, hosts, pods, entry=entry)
            return
        if entry is not None:
            keys, hosts, pods = self._materialize_bind_entry(entry)
        keys, hosts, pods = list(keys), list(hosts), list(pods)
        failed: set = set()
        bind_keys = getattr(self.binder, "bind_keys", None)
        try:
            if bind_keys is not None:
                bind_keys(keys, hosts)
            else:
                for pod, hostname, key in zip(pods, hosts, keys):
                    try:
                        self.binder.bind(pod, hostname)
                    except BindFailure:
                        failed.add(key)
        except BindFailure as bf:
            failed = set(bf.failed)
        if failed:
            self._on_bind_failures(
                [(k, p) for k, p in zip(keys, pods) if k in failed])
        ok = [(k, h) for k, h in zip(keys, hosts) if k not in failed]
        if ok:
            self._on_bind_success([k for k, _ in ok], [h for _, h in ok])

    def flush_binds(self, timeout: Optional[float] = None) -> bool:
        """Wait until every queued bind batch has been processed (True
        at once when nothing was queued); False past ``timeout``."""
        if self._bind_dispatcher is None:
            return True
        return self._bind_dispatcher.flush(timeout)

    def close(self) -> None:
        """Stop the background machinery and drop the cycle's caches and
        the device-resident state.  A parked pipelined solve or what-if
        plan is abandoned (it mutated nothing), the solve worker and the
        bind dispatcher stop."""
        from ..pipeline import abandon_inflight, abandon_inflight_plan

        abandon_inflight(self)
        abandon_inflight_plan(self)
        with self._lock:
            self._job_rank_cache = None
            self._pending_order_cache = None
            self._encode_cache = None
            self._objarr_cache = None
            self._unbind_gather_cache = None
            self._close_gang_cache = None
            self._devincr_cache = None
            self._journey_masks = None
            self.device_snapshot = None
            worker, self._solve_worker = self._solve_worker, None
        if worker is not None:
            worker.stop()
        if self._bind_dispatcher is not None:
            self._bind_dispatcher.stop()
            self._bind_dispatcher = None

    def _on_bind_failures(self, failed_pairs) -> None:
        with self._bind_fail_lock:
            self._failed_bind_keys.extend(failed_pairs)

    def _on_bind_success(self, keys: List[str], hosts: List[str]) -> None:
        if self.bind_backoff:
            with self._bind_fail_lock:
                self._succeeded_bind_keys.extend(keys)
        self.record_events(
            (f"Pod/{key}", "Scheduled", f"bound to {host}")
            for key, host in zip(keys, hosts)
        )

    def drain_bind_failures(self) -> int:
        """Apply queued bind failures: the task re-enters Pending with an
        exponential backoff window during which the solver skips it (the
        rate-limited errTasks retry, cache.go:627-649).  Runs on the
        scheduling-cycle thread so all mirror mutation stays there."""
        with self._bind_fail_lock:
            failed = self._failed_bind_keys
            self._failed_bind_keys = []
            succeeded = self._succeeded_bind_keys
            self._succeeded_bind_keys = []
        if succeeded:
            with self._lock:
                for key in succeeded:
                    self.bind_backoff.pop(key, None)
        if not failed:
            return 0
        from .bindqueue import BACKOFF_BASE, BACKOFF_MAX

        now = time.time()
        n = 0
        with self._lock:
            for key, pod in failed:
                if (pod is None or self.pods.get(pod.uid) is not pod
                        or pod.node_name is None):
                    continue
                fails, _, _ = self.bind_backoff.get(key, (0, 0.0, ""))
                fails += 1
                delay = min(BACKOFF_BASE * (2 ** (fails - 1)), BACKOFF_MAX)
                self.bind_backoff[key] = (fails, now + delay, pod.uid)
                pod.node_name = None
                if pod.volumes:
                    self.release_claims_for(pod)
                self.mirror.set_pod_state(
                    pod.uid, int(TaskStatus.Pending), -1
                )
                self.mark_objects_stale()
                self.record_event(
                    f"Pod/{key}", "FailedScheduling",
                    f"bind failed; retry in {delay:.0f}s "
                    f"(attempt {fails})",
                )
                self._notify("Pod", "update", pod)
                n += 1
        return n

    # ----------------------------------------------- lazy object model

    @property
    def jobs(self) -> Dict[str, JobInfo]:
        if self._objects_stale:
            self._rebuild_objects()
        return self._jobs

    @property
    def nodes(self) -> Dict[str, NodeInfo]:
        if self._objects_stale:
            self._rebuild_objects()
        return self._nodes

    def mark_objects_stale(self) -> None:
        """Called by the fast path after a bulk commit: JobInfo/NodeInfo
        accounting is rebuilt from the pod records on next read."""
        self._objects_stale = True

    def _rebuild_objects(self) -> None:
        """Recompute the JobInfo/NodeInfo object model from pods + pod
        groups (cache.go:376-417), jobs in mirror row order."""
        with self._lock:
            if not self._objects_stale:
                return
            self._objects_stale = False
            self._nodes = {}
            for row, name in enumerate(self.mirror.n_name):
                if name is not None and self.mirror.n_alive[row]:
                    self._nodes[name] = NodeInfo(self.mirror.node_objs[row])
            self._jobs = {}
            for uid in self.mirror.j_uid:
                pg = self.pod_groups.get(uid) if uid else None
                if pg is None:
                    continue
                job = JobInfo(uid)
                job.set_pod_group(pg)
                if (pg.priority_class
                        and pg.priority_class in self.priority_classes):
                    job.priority = self.priority_classes[
                        pg.priority_class].value
                self._jobs[uid] = job
            for pod in self.pods.values():
                try:
                    self._add_task(pod)
                except (ValueError, KeyError) as err:
                    log.error("rebuild: failed to re-add task %s: %s",
                              pod.uid, err)

    # ------------------------------------------------------------- watchers

    def watch(self, fn: Callable[[str, str, object], None]) -> None:
        """Register fn(kind, event, obj) called after each mutation."""
        self._watchers.append(fn)

    def _notify(self, kind: str, event: str, obj: object) -> None:
        for fn in self._watchers:
            fn(kind, event, obj)

    # ------------------------------------------------------- job bookkeeping

    def _get_or_create_job(self, job_id: str) -> JobInfo:
        job = self.jobs.get(job_id)
        if job is None:
            job = JobInfo(job_id)
            self.jobs[job_id] = job
        return job

    def _add_task(self, pod: Pod) -> None:
        ti = TaskInfo(pod)
        if ti.job:
            self._get_or_create_job(ti.job).add_task_info(ti)
        # Terminated pods hold no node resources (event_handlers.go
        # isTerminated).
        if ti.status in (TaskStatus.Succeeded, TaskStatus.Failed):
            return
        if ti.node_name:
            node = self.nodes.get(ti.node_name)
            if node is None:
                # Task on an unknown node: hold a placeholder so accounting
                # catches up when the node arrives (event_handlers.go addTask).
                node = NodeInfo(None)
                node.name = ti.node_name
                self.nodes[ti.node_name] = node
            fresh = ti.clone()
            fresh.node_name = ""
            node.add_task(fresh)

    def _remove_task(self, pod: Pod) -> None:
        job_id = pod.job_id()
        job = self.jobs.get(job_id) if job_id else None
        if job is not None:
            ti = job.tasks.get(pod.uid)
            if ti is not None:
                job.delete_task_info(ti)
        if pod.node_name:
            node = self.nodes.get(pod.node_name)
            if node is not None and pod_key(pod) in node.tasks:
                node.remove_task(TaskInfo(pod))

    # --------------------------------------------------------- pod handlers

    def add_pod(self, pod: Pod) -> None:
        """Track a pod.  Ungrouped pods still occupy node resources when
        bound (cache.go:320-332); they lack a schedulable job until a
        PodGroup wraps them."""
        with self._lock:
            self.pods[pod.uid] = pod
            if pod.volumes:
                self.n_volume_pods += 1
            self._add_task(pod)
            self.mirror.upsert_pod(pod, self.mirror.job_row)
            self._notify("Pod", "add", pod)

    def update_pod(self, pod: Pod) -> None:
        with self._lock:
            old = self.pods.get(pod.uid)
            if old is not None:
                self._remove_task(old)
                if old.volumes:
                    self.n_volume_pods -= 1
            self.pods[pod.uid] = pod
            if pod.volumes:
                self.n_volume_pods += 1
            self._add_task(pod)
            self.mirror.upsert_pod(pod, self.mirror.job_row)
            self._notify("Pod", "update", pod)

    def delete_pod(self, pod: Pod) -> None:
        with self._lock:
            old = self.pods.pop(pod.uid, None)
            if old is not None:
                self._remove_task(old)
                if old.volumes:
                    self.n_volume_pods -= 1
            if self.bind_backoff:
                self.bind_backoff.pop(f"{pod.namespace}/{pod.name}", None)
            self.mirror.remove_pod(pod.uid)
            self.mirror.maybe_compact()
            self._notify("Pod", "delete", pod)
            if self.migrations is not None and old is not None:
                # A terminating eviction victim restores as a fresh
                # Pending pod (add_pod re-enters the re-entrant lock).
                self.migrations.pod_deleted(self, old)

    # -------------------------------------------------------- node handlers

    def add_node(self, node: Node) -> None:
        with self._lock:
            existing = self.nodes.get(node.name)
            if existing is not None:
                existing.set_node(node)
            else:
                self.nodes[node.name] = NodeInfo(node)
            self.mirror.upsert_node(node)
            self._notify("Node", "add", node)

    def update_node(self, node: Node) -> None:
        with self._lock:
            existing = self.nodes.get(node.name)
            if existing is None:
                self.nodes[node.name] = NodeInfo(node)
            else:
                existing.set_node(node)
            self.mirror.upsert_node(node)
            self._notify("Node", "update", node)

    def delete_node(self, name: str) -> None:
        with self._lock:
            self.nodes.pop(name, None)
            self.mirror.remove_node(name)
            self._notify("Node", "delete", name)

    # --------------------------------------------------- pod group handlers

    def add_pod_group(self, pg: PodGroup) -> None:
        with self._lock:
            self.pod_groups[pg.uid] = pg
            job = self._get_or_create_job(pg.uid)
            job.set_pod_group(pg)
            if pg.priority_class and pg.priority_class in self.priority_classes:
                job.priority = self.priority_classes[pg.priority_class].value
            self.mirror.upsert_pod_group(pg, job.priority)
            self._notify("PodGroup", "add", pg)

    def update_pod_group(self, pg: PodGroup) -> None:
        with self._lock:
            self.pod_groups[pg.uid] = pg
            job = self._get_or_create_job(pg.uid)
            job.set_pod_group(pg)
            if pg.priority_class and pg.priority_class in self.priority_classes:
                job.priority = self.priority_classes[pg.priority_class].value
            self.mirror.upsert_pod_group(pg, job.priority)
            self._notify("PodGroup", "update", pg)

    def delete_pod_group(self, uid: str) -> None:
        with self._lock:
            self.pod_groups.pop(uid, None)
            job = self.jobs.get(uid)
            if job is not None:
                job.unset_pod_group()
                if not job.tasks:
                    del self.jobs[uid]
            self.mirror.remove_pod_group(uid)
            self._notify("PodGroup", "delete", uid)

    # ------------------------------------------------------- queue handlers

    def add_queue(self, queue: Queue) -> None:
        with self._lock:
            self.raw_queues[queue.name] = queue
            self.queues[queue.name] = QueueInfo(queue)
            self._notify("Queue", "add", queue)

    def update_queue(self, queue: Queue) -> None:
        with self._lock:
            self.raw_queues[queue.name] = queue
            self.queues[queue.name] = QueueInfo(queue)
            self._notify("Queue", "update", queue)

    def delete_queue(self, name: str) -> None:
        with self._lock:
            self.raw_queues.pop(name, None)
            self.queues.pop(name, None)
            self._notify("Queue", "delete", name)

    # ------------------------------------------- priority class / quota

    def add_priority_class(self, pc: PriorityClass) -> None:
        with self._lock:
            self.priority_classes[pc.name] = pc
            self._notify("PriorityClass", "add", pc)

    def delete_priority_class(self, name: str) -> None:
        with self._lock:
            self.priority_classes.pop(name, None)
            self._notify("PriorityClass", "delete", name)

    def add_resource_quota(self, quota: ResourceQuota) -> None:
        """Track namespace weight from the quota annotation
        (event_handlers.go quota path + namespace_info.go:33-37)."""
        with self._lock:
            raw = quota.annotations.get(NAMESPACE_WEIGHT_KEY)
            if raw is not None:
                try:
                    self.namespace_weights[quota.namespace] = max(
                        self.namespace_weights.get(quota.namespace, 0),
                        int(raw))
                except ValueError:
                    pass
            self._notify("ResourceQuota", "add", quota)

    # ---------------------------------------------------- controller plane

    def add_batch_job(self, job) -> None:
        with self._lock:
            self.batch_jobs[job.key] = job
            self._notify("Job", "add", job)

    def update_batch_job(self, job) -> None:
        with self._lock:
            self.batch_jobs[job.key] = job
            self._notify("Job", "update", job)

    def delete_batch_job(self, key: str) -> None:
        with self._lock:
            job = self.batch_jobs.pop(key, None)
            if job is not None:
                self._notify("Job", "delete", job)

    def add_command(self, command) -> None:
        with self._lock:
            self.commands[command.name] = command
            self._notify("Command", "add", command)

    def delete_command(self, name: str) -> None:
        with self._lock:
            self.commands.pop(name, None)

    def put_config_map(self, ns: str, name: str,
                       data: Dict[str, str]) -> None:
        with self._lock:
            self.config_maps[f"{ns}/{name}"] = dict(data)

    def delete_config_map(self, ns: str, name: str) -> None:
        with self._lock:
            self.config_maps.pop(f"{ns}/{name}", None)

    def put_secret(self, ns: str, name: str, data) -> None:
        with self._lock:
            self.secrets[f"{ns}/{name}"] = dict(data)

    def delete_secret(self, ns: str, name: str) -> None:
        with self._lock:
            self.secrets.pop(f"{ns}/{name}", None)

    def put_service(self, ns: str, name: str, spec) -> None:
        with self._lock:
            self.services[f"{ns}/{name}"] = spec

    def delete_service(self, ns: str, name: str) -> None:
        with self._lock:
            self.services.pop(f"{ns}/{name}", None)

    def put_network_policy(self, ns: str, name: str, spec) -> None:
        """Job-scoped ingress isolation record (the NetworkPolicy the
        reference svc plugin creates, svc.go:252-299)."""
        with self._lock:
            self.network_policies[f"{ns}/{name}"] = spec

    def delete_network_policy(self, ns: str, name: str) -> None:
        with self._lock:
            self.network_policies.pop(f"{ns}/{name}", None)

    # ------------------------------------------------------- claim registry

    def put_pvc(self, ns: str, name: str, spec,
                owner_job: str = "") -> None:
        """Create/replace a claim record (phase Pending until the volume
        binder binds it)."""
        with self._lock:
            self.pvcs[f"{ns}/{name}"] = {
                "spec": dict(spec) if spec else {},
                "phase": "Pending",
                "node": None,
                "owner_job": owner_job,
            }

    def delete_pvc(self, ns: str, name: str) -> None:
        with self._lock:
            self.pvcs.pop(f"{ns}/{name}", None)

    def release_claims_for(self, pod) -> None:
        """Roll back a failed bind's claim state: claims this pod pinned
        return to Pending unless another placed pod still references
        them."""
        if not pod.volumes:
            return
        with self._lock:
            claims = {f"{pod.namespace}/{c}" for c, _ in pod.volumes}
            still_held = set()
            for other in self.pods.values():
                if (other.uid == pod.uid or not other.volumes
                        or other.node_name is None):
                    continue
                for c, _ in other.volumes:
                    k = f"{other.namespace}/{c}"
                    if k in claims:
                        still_held.add(k)
            for k in claims - still_held:
                rec = self.pvcs.get(k)
                if rec is not None:
                    rec["phase"] = "Pending"
                    rec["node"] = None

    def delete_pvcs_owned_by(self, job_key: str) -> int:
        """Owner-reference cleanup: claims created by the controller for
        a job die with the Job object (job_controller_actions.go:512-531);
        returns how many went."""
        with self._lock:
            doomed = [k for k, rec in self.pvcs.items()
                      if rec.get("owner_job") == job_key]
            for k in doomed:
                del self.pvcs[k]
        return len(doomed)

    # -------------------------------------------------------------- snapshot

    def snapshot(self) -> ClusterInfo:
        """Deep-copied point-in-time view (cache.go:652-730)."""
        with self._lock:
            info = ClusterInfo()
            for name, node in self.nodes.items():
                info.nodes[name] = node.clone()
            for name, queue in self.queues.items():
                info.queues[name] = queue.clone()
            namespaces = set()
            for job_id, job in self.jobs.items():
                # Jobs without a PodGroup are not schedulable yet.
                if job.pod_group is None:
                    continue
                info.jobs[job_id] = job.clone()
                namespaces.add(job.namespace)
            for ns in namespaces:
                info.namespace_info[ns] = NamespaceInfo(
                    ns, self.namespace_weights.get(ns, 1)
                )
            return info

    # ------------------------------------------------------------ side effects

    def _replace_pod(self, pod, **mutations):
        """Copy-on-write pod replacement: snapshot TaskInfos holding the
        old Pod keep their point-in-time view.  Caller holds the lock."""
        self._remove_task(pod)
        pod = copy.copy(pod)
        for name, value in mutations.items():
            setattr(pod, name, value)
        self.pods[pod.uid] = pod
        self._add_task(pod)
        self.mirror.upsert_pod(pod, self.mirror.job_row)
        return pod

    def bind(self, task: TaskInfo, hostname: str) -> None:
        """Bind task's pod to a host (cache.go:492-554, synchronous)."""
        with self._lock:
            pod = self.pods.get(task.uid)
            if pod is None:
                raise KeyError(f"unknown pod {task.uid}")
            self.binder.bind(task, hostname)
            pod = self._replace_pod(pod, node_name=hostname)
            self.record_event(
                f"Pod/{pod.namespace}/{pod.name}", "Scheduled",
                f"bound to {hostname}",
            )
            self._notify("Pod", "bind", pod)

    def evict(self, task: TaskInfo, reason: str) -> None:
        """Evict task's pod (cache.go:439-489, synchronous): the object
        session's preempt and reclaim evict through it."""
        with self._lock:
            pod = self.pods.get(task.uid)
            if pod is None:
                raise KeyError(f"unknown pod {task.uid}")
            # Mark the cached pod as terminating: resources become
            # Releasing.
            pod = self._replace_pod(pod, deleting=True)
            try:
                self.evictor.evict(pod)
            except Exception:
                # Evict dispatch failed: the pod is NOT terminating.
                # Revert the record (cache.go:461-466 resyncTask) and let
                # the next cycle re-select victims.
                pod = self._replace_pod(pod, deleting=False)
                self.record_event(
                    f"Pod/{pod.namespace}/{pod.name}", "EvictFailed",
                    "evict dispatch failed; will retry",
                )
                self._notify("Pod", "update", pod)
                return
            self.record_event(
                f"Pod/{pod.namespace}/{pod.name}", "Evict",
                reason or "evicted by scheduler",
            )
            self._notify("Pod", "evict", pod)

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        self.volume_binder.allocate_volumes(task, hostname)

    def bind_volumes(self, task: TaskInfo) -> None:
        self.volume_binder.bind_volumes(task)

    def update_job_status(self, job: JobInfo) -> JobInfo:
        """Write PodGroup status back (interface.go UpdateJobStatus +
        job_updater.go semantics)."""
        with self._lock:
            pg = job.pod_group
            if pg is None:
                return job
            stored = self.pod_groups.get(pg.uid)
            if stored is not None:
                stored.status = pg.status
                # The mirror's status-snapshot columns are the fast path's
                # "last written" state.
                self.mirror.refresh_pod_group_status(stored)
                self.status_updater.update_pod_group(stored)
                self._notify("PodGroup", "status", stored)
            return job

    def record_job_condition(self, job: JobInfo,
                             condition: PodGroupCondition) -> None:
        if job.pod_group is None:
            return
        with self._lock:
            pg = self.pod_groups.get(job.pod_group.uid, job.pod_group)
            conditions = [c for c in pg.status.conditions
                          if c.type != condition.type]
            conditions.append(condition)
            pg.status.conditions = conditions
            self.mirror.refresh_pod_group_status(pg)

    # --------------------------------------------------------------- helpers

    def pending_pods(self) -> List[Pod]:
        with self._lock:
            return [p for p in self.pods.values()
                    if p.phase == PodPhase.Pending and not p.node_name]

    def task_in_store(self, uid: str) -> Optional[Pod]:
        with self._lock:
            return self.pods.get(uid)


class StoreVolumeBinder:
    """Volume binder against the store's claim registry (the
    defaultVolumeBinder of cache.go:211-222, backed by ``store.pvcs``).
    Accepts a TaskInfo or a bare Pod (the fast path hands pods)."""

    def __init__(self, store: "ClusterStore"):
        self._store = store

    @staticmethod
    def _pod(task):
        return getattr(task, "pod", task)

    def allocate_volumes(self, task, hostname: str) -> None:
        from .interface import VolumeBindFailure

        pod = self._pod(task)
        with self._store._lock:
            for claim, _mount in pod.volumes:
                rec = self._store.pvcs.get(f"{pod.namespace}/{claim}")
                if rec is None:
                    raise VolumeBindFailure(
                        f"claim {pod.namespace}/{claim} not found for "
                        f"{pod.name}"
                    )
                if rec["phase"] == "Pending":
                    # WaitForFirstConsumer: the claim provisions on the
                    # node the scheduler picked.
                    rec["node"] = hostname
                elif rec["node"] not in (None, hostname):
                    raise VolumeBindFailure(
                        f"claim {pod.namespace}/{claim} is bound to "
                        f"{rec['node']}, pod placed on {hostname}"
                    )

    def bind_volumes(self, task) -> None:
        pod = self._pod(task)
        with self._store._lock:
            for claim, _mount in pod.volumes:
                rec = self._store.pvcs.get(f"{pod.namespace}/{claim}")
                if rec is not None:
                    rec["phase"] = "Bound"
        if hasattr(task, "volume_ready"):
            task.volume_ready = True
