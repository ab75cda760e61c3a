"""Thin Python client for the vtpu-service HTTP API.

The reference ships generated clientsets/informers/listers per CRD group
(pkg/client/); since this framework owns its own
store and API, the equivalent is this small typed client plus
``FakeClient``, an in-process double that drives a ``ClusterStore``
directly (the analog of the generated fake clientsets used throughout the
reference's unit tests).

Usage::

    from volcano_tpu_torch.client import Client
    c = Client("http://127.0.0.1:11250")
    c.create_job({"name": "train", "minAvailable": 2, "tasks": [...]})
    for j in c.jobs():
        print(j["name"], j["status"]["state"])
    c.suspend_job("train")
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Dict, List, Optional


class ApiError(Exception):
    """Non-2xx response from the service (carries the HTTP status)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class Client:
    """HTTP client mirroring vcctl's verbs (cmd/cli/job.go:11-67)."""

    def __init__(self, server: str = "http://127.0.0.1:11250",
                 timeout: float = 10.0):
        self.server = server.rstrip("/")
        self.timeout = timeout

    # ------------------------------------------------------------ plumbing

    def _request(self, method: str, path: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.server + path, data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as err:
            try:
                msg = json.loads(err.read() or b"{}").get("error", str(err))
            except Exception:
                msg = str(err)
            raise ApiError(err.code, msg) from None
        if not payload:
            return None
        if payload.startswith(b"[") or payload.startswith(b"{"):
            return json.loads(payload)
        return payload.decode()

    # ---------------------------------------------------------------- jobs

    def jobs(self, namespace: Optional[str] = None) -> List[dict]:
        q = f"?namespace={namespace}" if namespace else ""
        return self._request("GET", f"/apis/jobs{q}")

    def get_job(self, name: str, namespace: str = "default") -> dict:
        return self._request("GET", f"/apis/jobs/{namespace}/{name}")

    def create_job(self, job: dict) -> dict:
        return self._request("POST", "/apis/jobs", job)

    def delete_job(self, name: str, namespace: str = "default") -> None:
        self._request("DELETE", f"/apis/jobs/{namespace}/{name}")

    def _command(self, action: str, name: str, namespace: str,
                 kind: str = "Job") -> None:
        self._request("POST", "/apis/commands", {
            "action": action, "targetKind": kind, "targetName": name,
            "targetNamespace": namespace,
        })

    def suspend_job(self, name: str, namespace: str = "default") -> None:
        self._command("AbortJob", name, namespace)

    def resume_job(self, name: str, namespace: str = "default") -> None:
        self._command("ResumeJob", name, namespace)

    # -------------------------------------------------------------- queues

    def queues(self) -> List[dict]:
        return self._request("GET", "/apis/queues")

    def create_queue(self, name: str, weight: int = 1,
                     capability: Optional[Dict[str, object]] = None,
                     reclaimable: bool = True) -> None:
        self._request("POST", "/apis/queues", {
            "name": name, "weight": weight,
            "capability": capability or {}, "reclaimable": reclaimable,
        })

    def delete_queue(self, name: str) -> None:
        self._request("DELETE", f"/apis/queues/{name}")

    def operate_queue(self, name: str, action: str) -> None:
        """action: OpenQueue | CloseQueue (bus/v1alpha1 actions)."""
        self._command(action, name, "default", kind="Queue")

    # --------------------------------------------------------------- nodes

    def add_node(self, name: str, allocatable: Dict[str, object],
                 labels: Optional[Dict[str, str]] = None,
                 topology: Optional[Dict[str, str]] = None) -> None:
        self._request("POST", "/apis/nodes", {
            "name": name, "allocatable": allocatable,
            "labels": labels or {}, "topology": topology or {},
        })

    # --------------------------------------------------------------- misc

    def healthz(self) -> bool:
        try:
            return self._request("GET", "/healthz") == "ok"
        except (ApiError, OSError):
            return False

    def metrics_text(self) -> str:
        return self._request("GET", "/metrics")


class FakeClient:
    """In-process Client double over a ClusterStore (the analog of the
    reference's generated fake clientsets, pkg/client/.../fake).  Accepts
    the same dict payloads as Client; command routing requires controllers
    (ControllerManager.process) to run, exactly as with the real service."""

    def __init__(self, store=None):
        from .cache import ClusterStore
        from .service import job_from_dict, job_to_dict
        from .webhooks.admission import AdmittedStore

        self.store = store if store is not None else ClusterStore()
        self.admitted = AdmittedStore(self.store)
        self._from_dict = job_from_dict
        self._to_dict = job_to_dict

    def jobs(self, namespace: Optional[str] = None) -> List[dict]:
        return [
            self._to_dict(j) for j in self.store.batch_jobs.values()
            if namespace is None or j.namespace == namespace
        ]

    def get_job(self, name: str, namespace: str = "default") -> dict:
        job = self.store.batch_jobs.get(f"{namespace}/{name}")
        if job is None:
            raise ApiError(404, "not found")
        return self._to_dict(job)

    def create_job(self, job: dict) -> dict:
        obj = self._from_dict(job)
        self.admitted.add_batch_job(obj)
        return self._to_dict(obj)

    def delete_job(self, name: str, namespace: str = "default") -> None:
        self.store.delete_batch_job(f"{namespace}/{name}")

    def _command(self, action: str, name: str, namespace: str,
                 kind: str = "Job") -> None:
        from .controllers import Command

        self.store.add_command(Command(
            action=action, target_kind=kind, target_name=name,
            target_namespace=namespace,
        ))

    def suspend_job(self, name: str, namespace: str = "default") -> None:
        self._command("AbortJob", name, namespace)

    def resume_job(self, name: str, namespace: str = "default") -> None:
        self._command("ResumeJob", name, namespace)

    def queues(self) -> List[dict]:
        return [
            {"name": q.name, "weight": q.weight, "state": q.state,
             "reclaimable": q.reclaimable}
            for q in self.store.raw_queues.values()
        ]

    def create_queue(self, name: str, weight: int = 1,
                     capability: Optional[Dict[str, object]] = None,
                     reclaimable: bool = True) -> None:
        from .api import Queue

        self.admitted.add_queue(Queue(
            name=name, weight=weight, capability=capability or {},
            reclaimable=reclaimable,
        ))

    def delete_queue(self, name: str) -> None:
        self.admitted.delete_queue(name)

    def operate_queue(self, name: str, action: str) -> None:
        self._command(action, name, "default", kind="Queue")

    def add_node(self, name: str, allocatable: Dict[str, object],
                 labels: Optional[Dict[str, str]] = None,
                 topology: Optional[Dict[str, str]] = None) -> None:
        from .api import Node

        self.store.add_node(Node(
            name=name, allocatable=allocatable, labels=labels or {},
            topology=topology or {},
        ))

    def healthz(self) -> bool:
        return True

    def metrics_text(self) -> str:
        from .metrics import metrics

        return metrics.expose_text()
