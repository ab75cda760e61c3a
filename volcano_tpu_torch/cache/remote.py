"""Remote binder: binds crossing a real process boundary.

The reference's bind side effect is an RPC to the API server from an
async goroutine (``pkg/scheduler/cache/cache.go:492-554``); the
scheduler process never shares memory with the system of record.  This
module keeps that boundary pluggable in the single-process design:
``HttpBinder``
implements the ``Binder`` protocol over HTTP/JSON against a second
process running ``RemoteBindService``, and drops into ``ClusterStore``
unchanged — the ``BindDispatcher`` drives it exactly like the in-process
fake, including the errTasks backoff path on failures.

Server:  ``python -m volcano_tpu_torch.cache.remote --port 18476``
(``--port 0`` takes a free port; the readiness line names it)
Client:  ``ClusterStore(binder=HttpBinder("http://127.0.0.1:18476"))``

The evict and status-update side effects cross the same boundary
(``cache.go:439-491`` Evict, ``:556-599`` UpdateJobStatus /
taskUnschedulable): ``HttpEvictor`` and ``HttpStatusUpdater`` are
drop-ins for the ``Evictor`` / ``StatusUpdater`` protocols against the
same second process, with failure injection driving the
EvictFailure -> revert-to-Running -> retry path.

Host code only: nothing here imports torch.

Protocol (JSON over HTTP, stdlib only — no new dependencies):
  POST /bind   {"binds": [{"key": "ns/name", "host": "n0"}, ...]}
               -> 200 {"failed": ["ns/name", ...]}   (per-key outcomes)
  GET  /binds  -> 200 {"ns/name": "n0", ...}         (test observability)
  POST /evict  {"evicts": [{"key": "ns/name", "reason": "..."}]}
               -> 200 {"failed": ["ns/name", ...]}
  GET  /evicts -> 200 ["ns/name", ...]               (eviction channel)
  POST /podgroups      {"groups": [{"uid": ..., "phase": ...,
                        "running": N, "failed": N, "succeeded": N}]}
  GET  /podgroups      -> 200 {"uid": {...last written status...}}
  POST /podconditions  {"conditions": [{"key": "ns/name", ...}]}
  POST /chaos  {"fail_next": N, "fail_next_evicts": M}
               (exercises BindFailure/EvictFailure -> backoff/revert ->
               retry end to end)
  GET  /healthz -> 200 "ok"
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Sequence

from .interface import BindFailure, EvictFailure

log = logging.getLogger(__name__)


class _HttpTransport:
    """Shared POST/GET plumbing for the remote side-effect clients."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # Span sink (obs/trace.py Tracer): the service wires the store's
        # tracer in (default: the shared no-op), and every side-effect
        # RPC lands in the cycle trace as an "rpc" track span.  These
        # POSTs run on the bind dispatcher / cycle threads, so they go
        # through the tracer's thread-safe timed_event() — never the
        # cycle span stack.
        from ..obs.trace import null_tracer

        self.tracer = null_tracer()

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.base_url}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with self.tracer.timed_event(f"rpc:{path.lstrip('/')}",
                                     args={"url": self.base_url}):
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"{}")

    def _get(self, path: str):
        with urllib.request.urlopen(f"{self.base_url}{path}",
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read())


class HttpBinder(_HttpTransport):
    """``Binder`` over HTTP/JSON (drop-in for the in-process binder).

    ``bind_keys`` posts the whole batch in one request and raises
    ``BindFailure`` with the per-key failures the server reports;
    transport errors raise plain exceptions, which the dispatcher treats
    as indeterminate and re-drives per key via ``bind`` (idempotent:
    re-binding a landed key to the same host is a no-op server-side).
    """

    # --------------------------------------------------------------- Binder

    def bind_keys(self, keys: Sequence[str],
                  hostnames: Sequence[str]) -> None:
        out = self._post("/bind", {
            "binds": [{"key": k, "host": h}
                      for k, h in zip(keys, hostnames)],
        })
        failed = out.get("failed", [])
        if failed:
            raise BindFailure(failed)

    def bind(self, task, hostname: str) -> None:
        key = f"{task.namespace}/{task.name}"
        out = self._post("/bind", {"binds": [{"key": key,
                                              "host": hostname}]})
        if out.get("failed"):
            raise BindFailure([key])

    # ---------------------------------------------------------------- extras

    def binds(self) -> Dict[str, str]:
        """Fetch the server-side bind table (test observability)."""
        with urllib.request.urlopen(f"{self.base_url}/binds",
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def chaos_fail_next(self, n: int) -> None:
        self._post("/chaos", {"fail_next": n})


class HttpEvictor(_HttpTransport):
    """``Evictor`` over HTTP/JSON: the delete-pod API call of
    ``cache.go:439-491`` as a real RPC.  ``evict_keys`` posts a whole
    eviction batch (the fast path's flush) and raises ``EvictFailure``
    with the keys the server rejected; per-pod ``evict`` serves the
    object path's statement flush."""

    def evict_keys(self, keys: Sequence[str],
                   reason: str = "preempted") -> None:
        out = self._post("/evict", {
            "evicts": [{"key": k, "reason": reason} for k in keys],
        })
        failed = out.get("failed", [])
        if failed:
            raise EvictFailure(failed)

    def evict(self, pod) -> None:
        self.evict_keys([f"{pod.namespace}/{pod.name}"])

    def evicts(self) -> List[str]:
        """Server-side eviction channel (test observability)."""
        return self._get("/evicts")

    def chaos_fail_next(self, n: int) -> None:
        self._post("/chaos", {"fail_next_evicts": n})


class HttpStatusUpdater(_HttpTransport):
    """``StatusUpdater`` over HTTP/JSON: the PodGroup status /
    pod-condition API writes of ``cache.go:556-599`` as real RPCs.
    Updates are fire-and-forget per the reference (job_updater.go logs
    and drops failed status writes; the next cycle rewrites them)."""

    @staticmethod
    def _group_payload(pg) -> dict:
        st = pg.status
        return {
            "uid": pg.uid,
            "phase": st.phase,
            "running": int(st.running),
            "failed": int(st.failed),
            "succeeded": int(st.succeeded),
        }

    def update_pod_group(self, pg) -> None:
        try:
            self._post("/podgroups",
                       {"groups": [self._group_payload(pg)]})
        except (urllib.error.URLError, OSError) as e:
            log.warning("remote podgroup status write failed: %s", e)

    def update_pod_groups(self, pgs) -> None:
        """Batched write-back: one POST for a whole session close.  The
        fast path's _close prefers this when present — per-group round
        trips at 12k changed groups would dwarf the cycle budget.

        Raises on transport failure, unlike the per-group method: the
        fast path's close has a retry mechanism (it re-marks the batch
        dirty so the NEXT cycle rewrites it), whereas a swallowed error
        here would leave the remote permanently stale — close's change
        detection compares against the already-advanced local status."""
        self._post("/podgroups", {
            "groups": [self._group_payload(pg) for pg in pgs],
        })

    def update_pod_condition(self, pod, condition) -> None:
        try:
            self._post("/podconditions", {"conditions": [{
                "key": f"{pod.namespace}/{pod.name}",
                "type": getattr(condition, "type", str(condition)),
                "status": getattr(condition, "status", ""),
            }]})
        except (urllib.error.URLError, OSError) as e:
            log.warning("remote pod condition write failed: %s", e)

    def pod_groups(self) -> Dict[str, dict]:
        return self._get("/podgroups")

    def pod_conditions(self) -> List[dict]:
        return self._get("/podconditions")


class RemoteBindService:
    """The second process: receives binds, records them, and can inject
    failures on request (the cluster control plane of the demo)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 18476):
        self.binds: Dict[str, str] = {}
        self.evicts: List[str] = []
        self.pod_groups: Dict[str, dict] = {}
        self.pod_conditions: List[dict] = []
        self.fail_next = 0
        self.fail_next_evicts = 0
        self._lock = threading.Lock()
        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                log.debug("remote-binder: " + fmt, *args)

            def _reply(self, code: int, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, b'"ok"')
                elif self.path == "/binds":
                    with service._lock:
                        body = json.dumps(service.binds).encode()
                    self._reply(200, body)
                elif self.path == "/evicts":
                    with service._lock:
                        body = json.dumps(service.evicts).encode()
                    self._reply(200, body)
                elif self.path == "/podgroups":
                    with service._lock:
                        body = json.dumps(service.pod_groups).encode()
                    self._reply(200, body)
                elif self.path == "/podconditions":
                    with service._lock:
                        body = json.dumps(service.pod_conditions).encode()
                    self._reply(200, body)
                else:
                    self._reply(404, b"{}")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/bind":
                    failed: List[str] = []
                    with service._lock:
                        if service.fail_next > 0:
                            service.fail_next -= 1
                            failed = [b["key"]
                                      for b in payload.get("binds", [])]
                        else:
                            for b in payload.get("binds", []):
                                service.binds[b["key"]] = b["host"]
                    self._reply(200, json.dumps(
                        {"failed": failed}).encode())
                elif self.path == "/evict":
                    failed = []
                    with service._lock:
                        if service.fail_next_evicts > 0:
                            service.fail_next_evicts -= 1
                            failed = [e["key"]
                                      for e in payload.get("evicts", [])]
                        else:
                            for e in payload.get("evicts", []):
                                service.evicts.append(e["key"])
                    self._reply(200, json.dumps(
                        {"failed": failed}).encode())
                elif self.path == "/podgroups":
                    with service._lock:
                        for g in payload.get("groups", []):
                            service.pod_groups[g["uid"]] = g
                    self._reply(200, b"{}")
                elif self.path == "/podconditions":
                    with service._lock:
                        service.pod_conditions.extend(
                            payload.get("conditions", []))
                    self._reply(200, b"{}")
                elif self.path == "/chaos":
                    with service._lock:
                        if "fail_next" in payload:
                            service.fail_next = int(payload["fail_next"])
                        if "fail_next_evicts" in payload:
                            service.fail_next_evicts = int(
                                payload["fail_next_evicts"])
                    self._reply(200, b"{}")
                else:
                    self._reply(404, b"{}")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="volcano_tpu_torch remote binder")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=18476)
    args = ap.parse_args(argv)
    svc = RemoteBindService(args.host, args.port)
    # Readiness line for process supervisors / tests.
    print(f"remote-binder listening on {args.host}:{svc.port}",
          flush=True)
    try:
        svc.serve_forever()
    except KeyboardInterrupt:
        svc.shutdown()


if __name__ == "__main__":
    main()
