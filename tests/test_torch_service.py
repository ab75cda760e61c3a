"""The port's service daemon against the JAX package's.

Each package's ``Service`` serves its HTTP API on a free loopback port
with its loops not started (``test_torch_fixtures.PumpedService``): the
test runs each controller pump, scheduler cycle and kubelet tick itself,
so the two daemons see the same requests in the same order and their
answers are compared -- ``/apis/jobs`` (list, view, submit, delete),
``/apis/commands``, ``/apis/queues``, ``/apis/nodes``,
``/apis/placements``, the admission's 400s and the unknown paths' 404s,
equal; ``/healthz`` 200 (503 once the scheduler's cycles keep failing);
``/metrics`` carrying the ``volcano_`` families the JAX daemon serves;
``/debug/cycles`` (the list, ``?n=``, one record, a missing one's 404),
``/debug/health``, ``/debug/anomalies``, ``/debug/shards``,
``/debug/pods/<uid>`` and ``/debug/trace`` equal on every field that is
not a wall-clock time (sequence numbers, paths, pods considered and
bound, drop reasons, audit counts, journey event kinds and verdicts,
trace event names).

Also: BASELINE config 1 (``bench.py:630-681``: two nodes, a 3-replica
gang, periods 0.01 / 0.005 s) on the CPU, pumped (its pods' names, env
and annotations equal to the JAX daemon's) and with the daemon's own
threads (a bounded wait for Running, every thread joined by ``stop()``);
a restart from a checkpoint holding the port's real ``Job`` and
``Command`` records; ``VOLCANO_TPU_SHARDS=2`` refused naming queue 1
item 7; and, on a host without CUDA, ``Service()`` and ``python -m
volcano_tpu_torch.service`` raising unless asked for the CPU.
"""

import json
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

import volcano_tpu
import volcano_tpu_torch
from test_torch_fixtures import PumpedService, reset_uid_counters

REPO = Path(__file__).resolve().parent.parent
NODES = [(f"n{i}", {"cpu": "8", "memory": "16Gi", "pods": 110})
         for i in range(4)]


def _call(url, method="GET", body=None):
    """(status, parsed body or text)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as err:
        status, raw = err.code, err.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


_TIMES = ("t_wall", "duration_ms", "lanes_ms", "inflight_fetch_wait_ms",
          "overhead_ms", "first_seen", "last_seen", "enqueued_us",
          "time_to_first_consider_ms", "time_to_bind_ms", "t_us", "ts",
          "dur", "slo", "session", "transition_id", "p50_ms", "p99_ms",
          "max_ms", "mean_ms", "tid", "pid", "ttb_p50_ms", "ttb_p99_ms",
          "ts_us")


def _untimed(obj):
    """``obj`` without wall-clock fields (and without the session uid,
    which counts every uid a scheduler drew)."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in _TIMES}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_untimed(v) for v in obj)
    return obj


JOB = {"name": "train", "minAvailable": 3, "queue": "q2",
       "plugins": {"svc": [], "env": []},
       "tasks": [{"name": "worker", "replicas": 3,
                  "containers": [{"cpu": "2", "memory": "2Gi"}]}]}


def _api_session(pkg):
    """The API's verbs in one order against the package's daemon."""
    reset_uid_counters()
    ps = PumpedService(pkg, nodes=NODES)
    u = ps.url
    out = []
    try:
        def call(path, method="GET", body=None):
            out.append((method, path, _untimed(_call(u + path, method,
                                                     body))))
            return out[-1][2]

        call("/apis/queues", "POST", {"name": "q2", "weight": 2})
        call("/apis/nodes", "POST", {
            "name": "n9", "allocatable": {"cpu": "4", "memory": "8Gi"},
            "labels": {"tier": "b"}, "topology": {"volcano-tpu/slice": "s1"}})
        call("/apis/jobs", "POST", JOB)
        call("/apis/jobs", "POST", {"name": "bad", "minAvailable": 0,
                                    "tasks": []})
        call("/apis/jobs", "POST", {**JOB, "name": "lost",
                                    "queue": "nowhere"})
        ps.pump(3)
        call("/apis/jobs")
        call("/apis/jobs?namespace=default")
        call("/apis/jobs?namespace=other")
        call("/apis/jobs/default/train")
        call("/apis/jobs/default/none")
        call("/apis/placements")
        call("/apis/placements?limit=1")
        call("/apis/queues")
        call("/apis/commands", "POST", {"action": "AbortJob",
                                        "targetName": "train"})
        ps.pump(2)
        call("/apis/jobs/default/train")
        call("/apis/commands", "POST", {"action": "ResumeJob",
                                        "targetName": "train"})
        ps.pump(3)
        call("/apis/jobs/default/train")
        call("/apis/commands", "POST", {"action": "CloseQueue",
                                        "targetKind": "Queue",
                                        "targetName": "q2"})
        ps.pump(1)
        call("/apis/queues")
        call("/apis/queues/default", "DELETE")
        call("/apis/jobs/default/train", "DELETE")
        ps.pump(2)
        call("/apis/jobs")
        call("/apis/placements")
        call("/apis/nowhere")
        call("/apis/nowhere", "POST", {})
        call("/apis/nowhere", "DELETE")
    finally:
        ps.stop()
    return out


def test_http_api_answers_like_jax():
    want = _api_session(volcano_tpu)
    got = _api_session(volcano_tpu_torch)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for w, g in zip(want, got):
        assert g == w, w[:2]
    codes = [g[2][0] for g in got]
    assert codes[:5] == [201, 201, 201, 400, 400]
    assert 404 in codes
    train = [g[2][1] for g in got
             if g[:2] == ("GET", "/apis/jobs/default/train")]
    assert [t["status"]["phase"] for t in train] == [
        "Running", "Aborted", "Running"]
    assert train[0]["status"]["running"] == 3
    assert train[0]["events"]


def _debug_session(pkg):
    """Five cycles of a small churned store, then every /debug endpoint."""
    reset_uid_counters()
    ps = PumpedService(pkg, nodes=NODES)
    u = ps.url
    try:
        _call(u + "/apis/jobs", "POST", JOB | {"queue": "default"})
        _call(u + "/apis/jobs", "POST",
              JOB | {"name": "big", "queue": "default", "minAvailable": 8,
                     "tasks": [{"name": "w", "replicas": 8,
                                "containers": [{"cpu": "3",
                                                "memory": "2Gi"}]}]})
        ps.pump(5)
        uid = next(p.uid for p in ps.store.pods.values()
                   if p.owner_job == "default/train")
        out = {}
        for path in ("/debug/cycles", "/debug/cycles?n=2",
                     "/debug/health", "/debug/anomalies",
                     "/debug/anomalies?n=1", "/debug/shards",
                     f"/debug/pods/{uid}", "/debug/pods/nope",
                     "/debug/cycles/999999"):
            out[path] = _call(u + path)
        seq = out["/debug/cycles"][1][-1]["seq"]
        out["one"] = _call(f"{u}/debug/cycles/{seq}")
        out["trace"] = _call(u + "/debug/trace?cycles=3")
        out["healthz"] = _call(u + "/healthz")
        out["metrics"] = _call(u + "/metrics")
        # Three failed cycles in a row: /healthz reports the scheduler
        # unhealthy (a supervisor or the HA standby takes over).
        ps.svc.scheduler._consecutive_failures = 3
        out["unhealthy"] = _call(u + "/healthz")
        ps.svc.scheduler._consecutive_failures = 0
    finally:
        ps.stop()
    return out


def _families(text):
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+)", text, re.M)}


def test_debug_endpoints_answer_like_jax():
    want = _debug_session(volcano_tpu)
    got = _debug_session(volcano_tpu_torch)
    assert got["healthz"] == want["healthz"] == (200, "ok")
    assert got["unhealthy"][0] == want["unhealthy"][0] == 503
    assert got["metrics"][0] == 200
    # The families the JAX daemon serves are served by the port's.
    assert _families(want["metrics"][1]) <= _families(got["metrics"][1])
    assert "volcano_e2e_scheduling_latency_milliseconds" in \
        got["metrics"][1]
    for path in ("/debug/cycles", "/debug/cycles?n=2", "/debug/anomalies",
                 "/debug/anomalies?n=1", "/debug/shards",
                 "/debug/pods/nope", "/debug/cycles/999999"):
        assert _untimed(got[path]) == _untimed(want[path]), path
    assert got["/debug/shards"] == (200, {"shards": 1})
    assert got["/debug/pods/nope"][0] == 404
    assert got["/debug/cycles/999999"][0] == 404
    cycles = got["/debug/cycles"][1]
    assert len(cycles) == 5
    # The train gang binds; the big one waits (gang-blocked), on both.
    assert sum(c["pods_bound"] for c in cycles) == 3
    one_w, one_g = want["one"][1], got["one"][1]
    assert _untimed({k: v for k, v in one_g.items() if k != "spans"}) == \
        _untimed({k: v for k, v in one_w.items() if k != "spans"})
    assert one_g["spans"]
    h_w, h_g = want["/debug/health"][1], got["/debug/health"][1]
    assert h_g["status"] == h_w["status"] == "ok"
    for key in ("anomalies_total", "anomalies_by_reason", "flow_totals"):
        assert h_g[key] == h_w[key], key
    assert _untimed(h_g["audit"]) == _untimed(h_w["audit"])
    assert _untimed(h_g["journey"]) == _untimed(h_w["journey"])
    p_w, p_g = want[next(k for k in want if k.startswith(
        "/debug/pods/") and k != "/debug/pods/nope")], \
        got[next(k for k in got if k.startswith("/debug/pods/")
                 and k != "/debug/pods/nope")]
    assert p_g[0] == 200 and p_g[1]["why_pending"] == "bound"
    assert [e["kind"] for e in p_g[1]["events"]] == \
        [e["kind"] for e in p_w[1]["events"]]
    assert _untimed(p_g[1]) == _untimed(p_w[1])
    t_w, t_g = want["trace"][1], got["trace"][1]
    assert t_g["traceEvents"]
    assert sorted({e["name"] for e in t_g["traceEvents"]}) == \
        sorted({e["name"] for e in t_w["traceEvents"]})


# ----------------------------------------------------------------- config 1

def _config1_pods(pkg):
    reset_uid_counters()
    ps = PumpedService(pkg, schedule_period=0.01, controller_period=0.005,
                       nodes=[(f"node-{i}", {"cpu": "8", "memory": "16Gi",
                                             "pods": 64})
                              for i in range(2)])
    ctrl = __import__(f"{pkg.__name__}.controllers",
                      fromlist=["Job", "TaskSpec"])
    try:
        job = ctrl.Job(name="test-job", min_available=3,
                       tasks=[ctrl.TaskSpec(
                           name="worker", replicas=3,
                           containers=[{"cpu": "1", "memory": "1Gi"}])])
        ps.svc.admitted.add_batch_job(job)
        steps = 0
        while steps < 10:
            ps.pump(1)
            steps += 1
            running = [p for p in ps.store.pods.values()
                       if p.owner_job == job.key and p.phase == "Running"]
            if len(running) >= 3:
                break
        pods = sorted((p.name, p.node_name, p.phase, sorted(p.env.items()),
                       sorted(p.annotations.items()))
                      for p in ps.store.pods.values())
    finally:
        ps.stop()
    return steps, pods


def test_config1_pumped_equals_jax():
    want = _config1_pods(volcano_tpu)
    got = _config1_pods(volcano_tpu_torch)
    assert got == want
    steps, pods = got
    assert len(pods) == 3 and all(p[2] == "Running" for p in pods)


def test_config1_with_the_daemons_threads():
    """The daemon as ``bench.py`` config 1 runs it: its own scheduler,
    controller and HTTP threads; the gang Running within a bounded wait,
    and every thread ``start()`` started joined by ``stop()``."""
    from volcano_tpu_torch.api import Node
    from volcano_tpu_torch.controllers import Job, TaskSpec
    from volcano_tpu_torch.service import Service

    before = set(threading.enumerate())
    svc = Service(simulate=True, schedule_period=0.01,
                  controller_period=0.005, device="cpu")
    for i in range(2):
        svc.store.add_node(Node(name=f"node-{i}", allocatable={
            "cpu": "8", "memory": "16Gi", "pods": 64}))
    job = Job(name="test-job", min_available=3, tasks=[TaskSpec(
        name="worker", replicas=3,
        containers=[{"cpu": "1", "memory": "1Gi"}])])
    port = svc.start(http_port=0)
    started = [t for t in threading.enumerate() if t not in before]
    try:
        assert _call(f"http://127.0.0.1:{port}/healthz") == (200, "ok")
        svc.admitted.add_batch_job(job)
        deadline = time.monotonic() + 60.0
        running, phase = [], None
        while time.monotonic() < deadline:
            running = [p for p in list(svc.store.pods.values())
                       if p.owner_job == job.key and p.phase == "Running"]
            phase = svc.store.batch_jobs[job.key].status.state.phase
            if len(running) >= 3 and phase == "Running":
                break
            time.sleep(0.002)
        assert len(running) == 3 and phase == "Running"
    finally:
        svc.stop()
    assert started and not [t.name for t in started if t.is_alive()]
    assert svc.store.batch_jobs["default/test-job"].status.state.phase \
        == "Running"


# ---------------------------------------------------------- checkpoints

def test_restart_from_checkpoint_keeps_jobs_and_commands(tmp_path):
    """The daemon's final checkpoint holds the port's own ``Job`` and
    ``Command`` records (a queue command whose controller never ran stays
    pending); a daemon started on it picks the job up where it was, and
    the job answers commands sent over the API after the restart."""
    from volcano_tpu_torch.cache import ClusterStore
    from volcano_tpu_torch.controllers import Command, Job
    from volcano_tpu_torch.persistence import load_store, save_store

    path = str(tmp_path / "state.ckpt")
    reset_uid_counters()
    ps = PumpedService(volcano_tpu_torch, nodes=NODES, state_path=path)
    _call(ps.url + "/apis/jobs", "POST", JOB | {"queue": "default"})
    ps.pump(3)
    version = ps.store.batch_jobs["default/train"].status.version
    ps.stop()  # writes the final checkpoint (this replica leads)
    # A command no controller saw (written by another process).
    store = load_store(path, ClusterStore())
    store.add_command(Command(action="CloseQueue", target_kind="Queue",
                              target_name="q-none", name="cmd-held"))
    save_store(store, path)
    store.close()

    ps2 = PumpedService(volcano_tpu_torch, state_path=path)
    try:
        job = ps2.store.batch_jobs["default/train"]
        assert type(job) is Job
        assert job.status.state.phase == "Running"
        assert job.status.version == version
        assert type(ps2.store.commands["cmd-held"]) is Command
        assert len(ps2.store.nodes) == len(NODES)
        ps2.pump(1)
        assert ps2.store.batch_jobs["default/train"].status.state.phase \
            == "Running"
        _call(ps2.url + "/apis/commands", "POST",
              {"action": "AbortJob", "targetName": "train"})
        ps2.pump(2)
        assert ps2.store.batch_jobs["default/train"].status.state.phase \
            == "Aborted"
        _call(ps2.url + "/apis/commands", "POST",
              {"action": "ResumeJob", "targetName": "train"})
        ps2.pump(4)
        job = ps2.store.batch_jobs["default/train"]
        assert job.status.state.phase == "Running"
        assert job.status.retry_count == 1
    finally:
        ps2.stop()


def test_checkpoint_round_trips_real_job_and_command(tmp_path):
    from volcano_tpu_torch.cache import ClusterStore
    from volcano_tpu_torch.controllers import (Command, Job,
                                               LifecyclePolicy, TaskSpec,
                                               VolumeSpec)
    from volcano_tpu_torch.persistence import load_store, save_store

    store = ClusterStore()
    job = Job(name="j", min_available=2, queue="default",
              tasks=[TaskSpec(name="w", replicas=2,
                              containers=[{"cpu": "1"}],
                              policies=[LifecyclePolicy(
                                  action="RestartJob", event="PodFailed")])],
              volumes=[VolumeSpec(mount_path="/d",
                                  volume_claim={"storage": "1Gi"})],
              plugins={"ssh": [], "svc": []},
              ttl_seconds_after_finished=30.0)
    job.status.retry_count = 2
    store.add_batch_job(job)
    store.add_command(Command(action="CloseQueue", target_kind="Queue",
                              target_name="q"))
    path = str(tmp_path / "c.ckpt")
    save_store(store, path)
    back = load_store(path)
    assert back.batch_jobs["default/j"] == job
    assert type(back.batch_jobs["default/j"]) is Job
    cmd = next(iter(back.commands.values()))
    assert type(cmd) is Command and cmd.action == "CloseQueue"


# ------------------------------------------------------- refusals

def test_sharded_control_plane_is_refused(monkeypatch):
    from volcano_tpu_torch.service import Service

    monkeypatch.setenv("VOLCANO_TPU_SHARDS", "2")
    with pytest.raises(NotImplementedError, match="item 7, multi-GPU"):
        Service(device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_service_raises_without_cuda_unless_asked_for_cpu():
    from volcano_tpu_torch.service import Service

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Service()
    with pytest.raises(RuntimeError, match="CUDA"):
        Service(device="cuda")
    svc = Service(device="cpu")
    assert svc.scheduler.device.type == "cpu"
    svc.stop()
    out = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.service", "--simulate",
         "--listen-port", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "listening" not in out.stdout
