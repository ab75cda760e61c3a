"""The framework daemon: store + scheduler + controllers + HTTP API.

Bundles what the reference deploys as three binaries (vc-scheduler,
vc-controller-manager, vc-webhook-manager) into one service for
single-process deployments: the admission-wrapped store is the API surface,
the scheduler loop and controller pump run on threads, and a small HTTP
server exposes the job/queue API (consumed by the vtpuctl CLI), the
Prometheus metrics endpoint (:8080/metrics in the reference), and healthz
(:11251).

The scheduler runs on the card (``device=None``, the default) unless the
caller passes ``device="cpu"``; without CUDA the default raises at
construction and never drops to the CPU.  Only the scheduler's thread
launches kernels: the controller, checkpoint, lease, bind-dispatch and HTTP
threads work on host records and never hold a CUDA tensor.  ``stop()``
stops and joins every thread ``start()`` started.

    python -m volcano_tpu_torch.service --simulate            # the card
    python -m volcano_tpu_torch.service --simulate --device cpu
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .api import GROUP_NAME_ANNOTATION, Node, Queue
from .cache import ClusterStore
from .cache.store import not_ported
from .controllers import (Command, ControllerManager, Job, LifecyclePolicy,
                          TaskSpec)
from .device import resolve_device
from .metrics import metrics
from .scheduler import Scheduler
from .sim import ClusterSimulator
from .webhooks import AdmissionError, AdmittedStore

log = logging.getLogger(__name__)


def job_from_dict(data: dict) -> Job:
    from .api import Toleration

    tasks = [
        TaskSpec(
            name=t["name"],
            replicas=int(t.get("replicas", 1)),
            containers=t.get("containers", []),
            init_containers=t.get("initContainers", []),
            labels=t.get("labels", {}),
            node_selector=t.get("nodeSelector", {}),
            tolerations=[
                Toleration(
                    key=tol.get("key", ""),
                    operator=tol.get("operator", "Equal"),
                    value=tol.get("value", ""),
                    effect=tol.get("effect", ""),
                )
                for tol in t.get("tolerations", [])
            ],
            host_ports=t.get("hostPorts", []),
            env=t.get("env", {}),
            policies=[_policy_from_dict(p) for p in t.get("policies", [])],
        )
        for t in data.get("tasks", [])
    ]
    from .controllers import VolumeSpec

    volumes = [
        VolumeSpec(
            mount_path=v.get("mountPath", ""),
            volume_claim_name=v.get("volumeClaimName", ""),
            volume_claim=v.get("volumeClaim"),
        )
        for v in data.get("volumes", [])
    ]
    return Job(
        name=data["name"],
        namespace=data.get("namespace", "default"),
        min_available=int(data.get("minAvailable", 0)),
        tasks=tasks,
        volumes=volumes,
        policies=[_policy_from_dict(p) for p in data.get("policies", [])],
        plugins=data.get("plugins", {}),
        queue=data.get("queue", "default"),
        max_retry=int(data.get("maxRetry", 3)),
        ttl_seconds_after_finished=data.get("ttlSecondsAfterFinished"),
        priority_class=data.get("priorityClassName", ""),
    )


def _policy_from_dict(p: dict) -> LifecyclePolicy:
    return LifecyclePolicy(
        action=p.get("action", ""),
        event=p.get("event", ""),
        events=p.get("events", []),
        exit_code=p.get("exitCode"),
        timeout_seconds=p.get("timeout"),
    )


def job_to_dict(job: Job) -> dict:
    return {
        "name": job.name,
        "namespace": job.namespace,
        "minAvailable": job.min_available,
        "queue": job.queue,
        "tasks": [
            {"name": t.name, "replicas": t.replicas} for t in job.tasks
        ],
        "status": {
            "phase": job.status.state.phase,
            "pending": job.status.pending,
            "running": job.status.running,
            "succeeded": job.status.succeeded,
            "failed": job.status.failed,
            "terminating": job.status.terminating,
            "version": job.status.version,
            "retryCount": job.status.retry_count,
            "minAvailable": job.status.min_available,
        },
    }


class Service:
    def __init__(
        self,
        store: Optional[ClusterStore] = None,
        conf_path: Optional[str] = None,
        schedule_period: float = 1.0,
        controller_period: float = 0.2,
        simulate: bool = False,
        state_path: Optional[str] = None,
        checkpoint_period: float = 30.0,
        lease_path: Optional[str] = None,
        remote_binder: Optional[str] = None,
        remote_evictor: Optional[str] = None,
        remote_status_updater: Optional[str] = None,
        remote_solver: Optional[str] = None,
        pipeline: Optional[bool] = None,
        device=None,
    ):
        # The sharded control plane (N queue-partitioned cycle threads)
        # is not ported: refused before anything starts.
        if int(os.environ.get("VOLCANO_TPU_SHARDS", "1") or 1) > 1:
            raise not_ported(
                "the sharded control plane (VOLCANO_TPU_SHARDS > 1)",
                "item 7, multi-GPU")
        # On the card unless asked for the CPU: a host without CUDA
        # raises here, before any thread or client starts.
        resolve_device(device)
        # Remote side-effect boundaries (cache/remote.py): binds
        # (cache.go:492-554), evictions (:439-491), and status writes
        # (:556-599) as RPCs to a second process.  Each probes /healthz
        # so a permanently wrong URL fails at startup (transient outages
        # still ride the per-interface retry paths: errTasks backoff for
        # binds, EvictFailure -> Running revert for evictions,
        # fire-and-forget rewrite-next-cycle for status).
        def _remote_client(url: str, cls_name: str):
            import urllib.request

            from .cache import remote as remote_mod

            with urllib.request.urlopen(
                f"{url.rstrip('/')}/healthz", timeout=10
            ):
                pass
            return getattr(remote_mod, cls_name)(url)

        if remote_binder:
            binder = _remote_client(remote_binder, "HttpBinder")
            if store is None:
                store = ClusterStore(binder=binder)
            else:
                store.binder = binder
                # An existing BindDispatcher captured the old binder at
                # first dispatch; stop it so the next dispatch rebuilds
                # against the remote one.
                store.close()
        if remote_evictor:
            store = store or ClusterStore()
            store.evictor = _remote_client(remote_evictor, "HttpEvictor")
        if remote_status_updater:
            store = store or ClusterStore()
            store.status_updater = _remote_client(
                remote_status_updater, "HttpStatusUpdater"
            )
        self.store = store or ClusterStore()
        if remote_solver:
            # Remote-solver split (the north-star bridge): this process
            # keeps the store/controllers/encode/commit; the wave solver
            # runs in the device-owning process(es) at this address
            # spec, fed one C++-packed snapshot frame per solve
            # (solver_service.py).  A comma-separated address list, or
            # VOLCANO_TPU_SOLVER_POOL=<n> over one address, builds a
            # replica POOL (solver_pool.py): health-scored
            # routing, hedged dispatch, one-cycle failover, what-if
            # offload.  The default (one address, pool knob 1) is the
            # plain single-connection RemoteSolver, byte-identical to
            # the pre-pool wire.
            from .solver_pool import make_solver_client

            client = make_solver_client(remote_solver)
            client.ping()  # fail fast on a permanently wrong address
            client.tracer = self.store.tracer
            self.store.remote_solver = client
        # Side-effect RPC clients record into the store's cycle trace.
        for client in (self.store.binder, self.store.evictor,
                       self.store.status_updater):
            if hasattr(client, "tracer"):
                client.tracer = self.store.tracer
        if pipeline is not None:
            # Pipelined sessions (double-buffered cycles): the
            # device solve dispatches asynchronously and commits at the
            # top of the next cycle.  None defers to VOLCANO_TPU_PIPELINE.
            self.store.pipeline = bool(pipeline)
        # Production binds dispatch on the background worker with
        # errTasks-style failure backoff (cache.go:536-552, 627-649);
        # opt out with VOLCANO_TPU_ASYNC_BIND=0 (tests that assert binds
        # synchronously construct their own ClusterStore instead).
        if os.environ.get("VOLCANO_TPU_ASYNC_BIND", "1") != "0":
            self.store.async_bind = True
        self.state_path = state_path
        self.checkpoint_period = checkpoint_period
        if state_path:
            if os.path.exists(state_path):
                from .persistence import load_store

                load_store(state_path, self.store)
        self.admitted = AdmittedStore(self.store)
        self.controllers = ControllerManager(self.store)
        # The one Scheduler: its loop thread is the only one that
        # launches kernels.
        self.scheduler = Scheduler(
            self.store, conf_path=conf_path, schedule_period=schedule_period,
            gate=self.is_leader, device=device,
        )
        self.simulator = ClusterSimulator(self.store) if simulate else None
        self.controller_period = controller_period
        self._stop = threading.Event()
        self._threads = []
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        # Active/passive HA: with a lease path, the control loops only run
        # while this replica holds the lease (cmd/scheduler/app/server.go
        # leaderelection semantics); the HTTP endpoint always serves.
        self.elector = None
        if lease_path:
            from .ha import LeaderElector

            self.elector = LeaderElector(lease_path)
        self._leading = threading.Event()
        if self.elector is None:
            self._leading.set()

    # ----------------------------------------------------------------- loops

    def start(self, http_port: int = 11250,
              bind_address: str = "127.0.0.1") -> int:
        self.scheduler.run()
        t = threading.Thread(target=self._controller_loop, daemon=True,
                             name="vc-controllers")
        t.start()
        self._threads.append(t)
        if self.state_path:
            ct = threading.Thread(target=self._checkpoint_loop, daemon=True,
                                  name="vc-checkpoint")
            ct.start()
            self._threads.append(ct)
        if self.elector is not None:
            et = threading.Thread(
                target=lambda: self.elector.run(
                    self._leading.set, self._leading.clear
                ),
                daemon=True, name="vc-lease",
            )
            et.start()
            self._threads.append(et)
        port = self._start_http(http_port, bind_address)
        return port

    def is_leader(self) -> bool:
        return self._leading.is_set()

    def _controller_loop(self):
        while not self._stop.is_set():
            try:
                if self._leading.is_set():
                    self.controllers.process()
                    if self.simulator is not None:
                        self.simulator.step()
            except Exception:
                log.exception("controller pump failed")
            self._stop.wait(self.controller_period)

    def _checkpoint_loop(self):
        from .persistence import save_store

        while not self._stop.wait(self.checkpoint_period):
            # Only the active replica checkpoints: a standby's store is
            # stale and must never clobber the leader's snapshot.
            if not self._leading.is_set():
                continue
            try:
                save_store(self.store, self.state_path)
            except Exception:
                log.exception("checkpoint failed")

    # Seconds stop() waits for each thread it joins.
    JOIN_TIMEOUT = 30.0

    def stop(self):
        """Stop every loop and join every thread start() started: the
        scheduler's (the one that launches kernels) first, then the
        controller, checkpoint and lease threads, the bind dispatcher
        (``store.close()``) and the HTTP server's."""
        self._stop.set()
        self.scheduler.stop()
        if self.elector is not None:
            self.elector.stop()
        for t in self._threads:
            if t is not self._http_thread:
                t.join(self.JOIN_TIMEOUT)
        self.store.flush_binds(timeout=5)
        self.store.close()
        if self.state_path and self._leading.is_set():
            from .persistence import save_store

            try:
                save_store(self.store, self.state_path)
            except Exception:
                log.exception("final checkpoint failed")
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._http_thread.join(self.JOIN_TIMEOUT)
            self._httpd = None
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            log.error("threads still alive after stop(): %s", alive)
        self._threads = []

    # ------------------------------------------------------------------ http

    def _start_http(self, port: int,
                    bind_address: str = "127.0.0.1") -> int:
        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

            def _send(self, code: int, body: str,
                      content_type: str = "application/json"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _json(self, code: int, obj):
                self._send(code, json.dumps(obj))

            def do_GET(self):
                url = urlparse(self.path)
                parts = [p for p in url.path.split("/") if p]
                try:
                    if url.path == "/healthz":
                        sched = getattr(service, "scheduler", None)
                        if sched is not None and not sched.healthy():
                            # Repeated cycle failures (e.g. a crashed CUDA
                            # context, unrecoverable in-process): report
                            # unhealthy so the supervisor/HA standby
                            # takes over.
                            self._send(503, "unhealthy: scheduler cycles "
                                       "failing", "text/plain")
                        else:
                            self._send(200, "ok", "text/plain")
                    elif url.path == "/metrics":
                        self._send(200, metrics.expose_text(), "text/plain")
                    elif parts[:2] == ["debug", "cycles"] and len(parts) == 2:
                        # Recent flight-recorder ring as JSON (newest
                        # last); ?n=K limits the count.
                        n_raw = parse_qs(url.query).get("n", [None])[0]
                        n = int(n_raw) if n_raw is not None else None
                        self._json(200, [
                            rec.to_dict()
                            for rec in service.store.flight.recent(n)
                        ])
                    elif parts[:2] == ["debug", "cycles"] and len(parts) == 3:
                        rec = service.store.flight.get(int(parts[2]))
                        if rec is None:
                            self._json(404, {"error": "no such cycle"})
                        else:
                            self._json(200, rec.to_dict(include_spans=True))
                    elif parts[:2] == ["debug", "health"]:
                        # Runtime-auditor verdict + armed verifiers +
                        # SLO state.  Reads only the auditor's own
                        # lock-guarded snapshots — NEVER the store
                        # lock — so a scrape cannot block the cycle
                        # thread.
                        auditor = getattr(service.store, "auditor",
                                          None)
                        if auditor is None:
                            body = {"status": "no-auditor"}
                        else:
                            body = auditor.health()
                        # Solver-pool replica health: the
                        # pool snapshot reads only the pool's own
                        # lock, so — like the auditor — this can
                        # never block the cycle thread on store work.
                        snap = getattr(
                            getattr(service.store, "remote_solver",
                                    None),
                            "health_snapshot", None)
                        if snap is not None:
                            body["solver_pool"] = snap()
                        # Pod-journey queue rollup: per-
                        # queue time-to-bind percentiles; reads only
                        # the journey's own lock.
                        journey = getattr(service.store, "journey",
                                          None)
                        if journey is not None:
                            body["journey"] = journey.queue_rollup()
                        self._json(200, body)
                    elif parts[:2] == ["debug", "anomalies"]:
                        # The anomaly ring, oldest first; ?n=K limits.
                        auditor = getattr(service.store, "auditor",
                                          None)
                        n_raw = parse_qs(url.query).get("n", [None])[0]
                        n = int(n_raw) if n_raw is not None else None
                        self._json(200, [
                            a.to_dict()
                            for a in (auditor.anomalies(n)
                                      if auditor is not None else [])
                        ])
                    elif parts[:2] == ["debug", "shards"]:
                        # The sharded control plane is not ported:
                        # one scheduler, one shard.
                        self._json(200, {"shards": 1})
                    elif parts[:2] == ["debug", "pods"] and len(parts) == 3:
                        # Pod-journey timeline + why-pending verdict
                        # (obs/journey.py).  The journey is internally
                        # locked and uid-keyed: never the store lock.
                        journey = getattr(service.store, "journey",
                                          None)
                        if journey is None:
                            self._json(404, {
                                "error": "journey disabled "
                                         "(VOLCANO_TPU_JOURNEY=0)"})
                        else:
                            body = journey.timeline(parts[2])
                            if body is None:
                                self._json(404, {
                                    "error": "no journey for pod",
                                    "uid": parts[2]})
                            else:
                                self._json(200, body)
                    elif parts[:2] == ["debug", "trace"]:
                        # Perfetto/chrome://tracing trace of the last K
                        # cycles (?cycles=K, default the whole ring),
                        # with pod journeys as async tracks.
                        from .obs import export as obs_export

                        k_raw = parse_qs(url.query).get(
                            "cycles", [None])[0]
                        k = int(k_raw) if k_raw is not None else None
                        journey = getattr(service.store, "journey",
                                          None)
                        self._json(200, obs_export.perfetto_trace(
                            service.store.flight.recent(k),
                            journey=(journey.trace_rows()
                                     if journey is not None else None),
                        ))
                    elif parts[:2] == ["apis", "jobs"] and len(parts) == 2:
                        ns = parse_qs(url.query).get("namespace", [None])[0]
                        jobs = [
                            job_to_dict(j)
                            for j in service.store.batch_jobs.values()
                            if ns is None or j.namespace == ns
                        ]
                        self._json(200, jobs)
                    elif parts[:2] == ["apis", "jobs"] and len(parts) == 4:
                        jk = f"{parts[2]}/{parts[3]}"
                        job = service.store.batch_jobs.get(jk)
                        if job is None:
                            self._json(404, {"error": "not found"})
                        else:
                            d = job_to_dict(job)
                            # Per-object event trails (Scheduled / Evict /
                            # FailedScheduling / Unschedulable — the
                            # reference's kubectl-visible Events,
                            # cache.go:487,540,584,790).
                            evs = {}
                            st = service.store
                            pgnames = set()
                            # Snapshot under the store lock: scheduler
                            # threads mutate st.pods concurrently.
                            with st._lock:
                                job_pods = [
                                    p for p in st.pods.values()
                                    if getattr(p, "owner_job", None) == jk
                                ]
                            for p in job_pods:
                                trail = st.events_for(
                                    f"Pod/{p.namespace}/{p.name}"
                                )
                                if trail:
                                    evs[f"Pod/{p.name}"] = trail
                                g = (p.annotations or {}).get(
                                    GROUP_NAME_ANNOTATION
                                )
                                if g:
                                    pgnames.add(g)
                            for g in pgnames:
                                trail = st.events_for(
                                    f"PodGroup/{parts[2]}/{g}"
                                )
                                if trail:
                                    evs[f"PodGroup/{g}"] = trail
                            if evs:
                                d["events"] = evs
                            self._json(200, d)
                    elif parts[:2] == ["apis", "placements"]:
                        # Bound placements straight from the mirror's
                        # batched p_node_name column (one vectorized
                        # mask + gather) — the scheduler's authoritative
                        # view, current even while the async bind
                        # dispatcher's 100k pod-record walks are still
                        # deferred (records lag the commit by design).
                        import numpy as _np

                        from .api import TaskStatus

                        limit = int(parse_qs(url.query).get(
                            "limit", [1000])[0])
                        st = service.store
                        m = st.mirror
                        with st._lock:
                            n = len(m.p_uid)
                            rows = _np.flatnonzero(
                                m.p_alive[:n]
                                & (m.p_status[:n]
                                   == int(TaskStatus.Bound))
                            )
                            total = int(len(rows))
                            rows = rows[:max(limit, 0)]
                            hosts = m.p_node_name[rows].tolist()
                            keys = [m.p_key[r] for r in rows.tolist()]
                        self._json(200, {
                            "bound": total,
                            "placements": dict(zip(keys, hosts)),
                        })
                    elif parts[:2] == ["apis", "queues"]:
                        self._json(
                            200,
                            [
                                {"name": q.name, "weight": q.weight,
                                 "state": q.state,
                                 "reclaimable": q.reclaimable}
                                for q in service.store.raw_queues.values()
                            ],
                        )
                    else:
                        self._json(404, {"error": "unknown path"})
                except Exception as err:  # pragma: no cover
                    self._json(500, {"error": str(err)})

            def do_POST(self):
                url = urlparse(self.path)
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                parts = [p for p in url.path.split("/") if p]
                try:
                    if parts[:2] == ["apis", "jobs"]:
                        job = job_from_dict(body)
                        service.admitted.add_batch_job(job)
                        self._json(201, job_to_dict(job))
                    elif parts[:2] == ["apis", "commands"]:
                        service.store.add_command(
                            Command(
                                action=body["action"],
                                target_kind=body.get("targetKind", "Job"),
                                target_name=body["targetName"],
                                target_namespace=body.get(
                                    "targetNamespace", "default"
                                ),
                            )
                        )
                        self._json(201, {"ok": True})
                    elif parts[:2] == ["apis", "queues"]:
                        service.admitted.add_queue(
                            Queue(
                                name=body["name"],
                                weight=int(body.get("weight", 1)),
                                capability=body.get("capability", {}),
                                reclaimable=body.get("reclaimable", True),
                            )
                        )
                        self._json(201, {"ok": True})
                    elif parts[:2] == ["apis", "nodes"]:
                        service.store.add_node(
                            Node(
                                name=body["name"],
                                allocatable=body.get("allocatable", {}),
                                labels=body.get("labels", {}),
                                topology=body.get("topology", {}),
                            )
                        )
                        self._json(201, {"ok": True})
                    else:
                        self._json(404, {"error": "unknown path"})
                except AdmissionError as err:
                    self._json(400, {"error": str(err)})
                except Exception as err:  # pragma: no cover
                    self._json(500, {"error": str(err)})

            def do_DELETE(self):
                url = urlparse(self.path)
                parts = [p for p in url.path.split("/") if p]
                try:
                    if parts[:2] == ["apis", "jobs"] and len(parts) == 4:
                        service.store.delete_batch_job(
                            f"{parts[2]}/{parts[3]}"
                        )
                        self._json(200, {"ok": True})
                    elif parts[:2] == ["apis", "queues"] and len(parts) == 3:
                        service.admitted.delete_queue(parts[2])
                        self._json(200, {"ok": True})
                    else:
                        self._json(404, {"error": "unknown path"})
                except AdmissionError as err:
                    self._json(400, {"error": str(err)})
                except Exception as err:  # pragma: no cover
                    self._json(500, {"error": str(err)})

        self._httpd = ThreadingHTTPServer((bind_address, port), Handler)
        actual_port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                             name="vc-http")
        t.start()
        self._http_thread = t
        self._threads.append(t)
        return actual_port


def main(argv=None) -> int:
    """Daemon entry point (the vc-scheduler + vc-controller-manager pair in
    one process; flags mirror cmd/scheduler/app/options/options.go)."""
    import argparse
    import signal

    p = argparse.ArgumentParser(prog="vtpu-service")
    p.add_argument("--device", default="cuda",
                   help="where the scheduler's kernels run: cuda (the "
                        "default; raises without a card) or cpu (their "
                        "plain versions)")
    p.add_argument("--scheduler-conf", default=None,
                   help="scheduler YAML config path (hot-reloaded per cycle)")
    p.add_argument("--schedule-period", type=float, default=1.0)
    p.add_argument("--listen-port", type=int, default=11250)
    p.add_argument("--bind-address", default="127.0.0.1",
                   help="HTTP bind address (0.0.0.0 for containers)")
    p.add_argument("--state-path", default=None,
                   help="checkpoint file; loaded on start, saved periodically")
    p.add_argument("--checkpoint-period", type=float, default=30.0)
    p.add_argument("--lease-path", default=None,
                   help="leader-election lease file for active/passive HA")
    p.add_argument("--simulate", action="store_true",
                   help="run the built-in cluster simulator (dev mode)")
    p.add_argument("--remote-binder", default=None,
                   help="URL of a remote bind service (cache/remote.py); "
                        "binds then cross a process boundary like the "
                        "reference's API-server bind RPCs")
    p.add_argument("--remote-evictor", default=None,
                   help="URL of a remote evict service (cache/remote.py); "
                        "evictions cross a process boundary like the "
                        "reference's delete-pod RPCs (cache.go:439-491)")
    p.add_argument("--remote-status-updater", default=None,
                   help="URL of a remote status service (cache/remote.py); "
                        "PodGroup status writes cross a process boundary "
                        "like the reference's API writes (cache.go:556-599)")
    p.add_argument("--remote-solver", default=None,
                   help="host:port of a vtpu-solver process "
                        "(solver_service.py), or a comma-separated list "
                        "for a replica pool (solver_pool.py: hedged "
                        "dispatch, one-cycle failover, what-if offload; "
                        "VOLCANO_TPU_SOLVER_POOL=<n> pools n "
                        "connections to a single address).  The "
                        "scheduler then never touches an accelerator: "
                        "each cycle's solver inputs ship as one "
                        "C++-packed snapshot frame and the assignment "
                        "vectors return — the north-star store<->solver "
                        "bridge (cache.go:492-554 analog)")
    p.add_argument("--pipeline", action="store_true",
                   help="pipelined scheduler cycles: dispatch the device "
                        "solve asynchronously and commit it at the top of "
                        "the next cycle, hiding the device round trip "
                        "behind the host lanes (a staleness guard drops "
                        "rows invalidated during the overlap).  Also "
                        "reachable via VOLCANO_TPU_PIPELINE=1")
    args = p.parse_args(argv)

    svc = Service(
        conf_path=args.scheduler_conf,
        schedule_period=args.schedule_period,
        simulate=args.simulate,
        state_path=args.state_path,
        checkpoint_period=args.checkpoint_period,
        lease_path=args.lease_path,
        remote_binder=args.remote_binder,
        remote_evictor=args.remote_evictor,
        remote_status_updater=args.remote_status_updater,
        remote_solver=args.remote_solver,
        pipeline=args.pipeline or None,
        device=args.device,
    )
    port = svc.start(http_port=args.listen_port,
                     bind_address=args.bind_address)
    log.info("vtpu-service listening on %s:%d", args.bind_address, port)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    try:
        done.wait()
    finally:
        svc.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
