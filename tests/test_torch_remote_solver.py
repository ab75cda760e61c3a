"""The solver service (``volcano_tpu_torch/solver_service.py``) against the
JAX package's remote deployment.

- Twin deployments: the JAX scheduler driving a JAX solver child, and the
  port's scheduler (``device="cpu"``) driving a port child, over the churn
  sequence of ``tests/test_torch_cycle.py`` with the re-pend feed, give
  per cycle the same binds, mirror states, frame kinds, frame byte counts
  and frame bytes (every frame's blake2b), synchronous and pipelined; and
  the port's remote binds equal its local cycle's.
- Across packages: a JAX client drives a port child and a port client a
  JAX child on one cycle's captured solve frame; the four replies are
  equal array for array (dtype, shape, values).
- The protocol's own paths, as ``tests/test_remote_solver.py`` tests them
  on the JAX package: the child's mirror records and resync, the client's
  resync / acknowledgement-mismatch / child-error handling, the v1 child
  self-disable, the shm lane (roundtrip, ``ShmUnavailable``, the v1
  handshake, parity with TCP), a child restart healing (a child process
  started with ``jax`` and ``volcano_tpu`` unimportable), and the
  what-if lane's gate.
- The child's boundary: a delta applied after a solve changes none of that
  solve's cached planes, two connections solving at once get the replies
  each gets alone, and a child without ``--device cpu`` on a host without
  CUDA raises at start.

Every server binds port 0 and every socket carries a timeout.
"""

import hashlib
import itertools
import os
import random
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import volcano_tpu
import volcano_tpu.api
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.synth
from volcano_tpu import solver_service as jss
from volcano_tpu.cache import snapwire as jsw
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.synth
from volcano_tpu_torch import solver_service as pss
from volcano_tpu_torch.cache import snapwire as sw
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

from test_torch_fixtures import churn as _churn
from test_torch_fixtures import mirror_state as _mirror_state
from test_torch_fixtures import repend_feed as _partial_feed

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 60.0

# Run before the child's own code: jax, jaxlib and volcano_tpu unimportable.
_BLOCKED_CHILD = r'''
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "volcano_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
from volcano_tpu_torch.solver_service import main
main(["--port", "0", "--announce", "--device", "cpu"])
'''


def spawn_child():
    """A port solver child process on the CPU with the JAX package
    unimportable; returns (process, port)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-c", _BLOCKED_CHILD], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, env=env, cwd=str(ROOT), text=True)
    line = proc.stdout.readline().strip()
    if not line.startswith("SOLVER "):
        proc.kill()
        raise RuntimeError(f"solver child did not announce: {line!r}")
    return proc, int(line.split()[1])


def stop_child(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def port_server(**kw):
    return serve(pss.SolverServer(port=0, device="cpu", **kw))


def jax_server():
    return serve(jss.SolverServer(port=0))


def reset_uids():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _scheduler(pkg, store, conf=None):
    kw = {} if conf is None else {"conf_str": conf}
    if pkg is volcano_tpu:
        return JaxScheduler(store, **kw)
    return PortScheduler(store, device="cpu", **kw)


class _FrameLog:
    """Records the blake2b of every solve frame a client module sends."""

    def __init__(self, monkeypatch, module):
        self.frames = []
        real = module.send_frame_views

        def spy(sock, total, parts):
            data = b"".join(bytes(p) for p in parts)
            assert len(data) == total
            self.frames.append(hashlib.blake2b(data).hexdigest())
            return real(sock, total, parts)

        monkeypatch.setattr(module, "send_frame_views", spy)

    def take(self):
        out, self.frames = self.frames, []
        return out


def remote_run(pkg, monkeypatch, *, client=None, pipeline=False, cycles=6,
               n_nodes=24, n_pods=72, seed=13, churn=True, frames=True):
    """A remote deployment of ``pkg`` (its own scheduler, its own child in
    a thread unless ``client`` is given): per cycle the binds, mirror
    state, frame kind, frame bytes by kind and frame hashes."""
    mod = jss if pkg is volcano_tpu else pss
    log = _FrameLog(monkeypatch, mod) if frames else None
    server = None
    if client is None:
        server = jax_server() if pkg is volcano_tpu else port_server()
        client = mod.RemoteSolver(f"127.0.0.1:{server.port}",
                                  timeout=TIMEOUT)
    reset_uids()
    store = pkg.synth.synthetic_cluster(n_nodes=n_nodes, n_pods=n_pods,
                                        gang_size=4, seed=seed)
    store.pipeline = pipeline
    store.remote_solver = client
    store.cycle_feed = _partial_feed([0, 1])
    sched = _scheduler(pkg, store)
    rng = random.Random(7)
    out = []
    try:
        for step in range(cycles):
            before = dict(client.frame_bytes)
            sched.run_once()
            out.append({
                "binds": dict(store.binder.binds),
                "mirror": _mirror_state(store),
                "kind": client.last_frame_kind,
                "bytes": {k: client.frame_bytes[k] - before.get(k, 0)
                          for k in ("full", "delta")},
                "frames": log.take() if log else None,
            })
            if churn and step % 2 == 1:
                _churn(pkg.api, store, rng, step)
    finally:
        store.close()
        client.close()
        if server is not None:
            server.shutdown()
    return out


def local_run(*, pipeline=False, cycles=6, n_nodes=24, n_pods=72, seed=13,
              churn=True):
    reset_uids()
    pkg = volcano_tpu_torch
    store = pkg.synth.synthetic_cluster(n_nodes=n_nodes, n_pods=n_pods,
                                        gang_size=4, seed=seed)
    store.pipeline = pipeline
    store.cycle_feed = _partial_feed([0, 1])
    sched = _scheduler(pkg, store)
    rng = random.Random(7)
    out = []
    for step in range(cycles):
        sched.run_once()
        out.append({"binds": dict(store.binder.binds),
                    "mirror": _mirror_state(store)})
        if churn and step % 2 == 1:
            _churn(pkg.api, store, rng, step)
    store.close()
    return out


# ------------------------------------------------ the twin deployments


@pytest.mark.parametrize("pipeline", [False, True])
def test_remote_deployment_equals_jax_remote_deployment(monkeypatch,
                                                        pipeline):
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "1")
    jax_run = remote_run(volcano_tpu, monkeypatch, pipeline=pipeline)
    port_run = remote_run(volcano_tpu_torch, monkeypatch,
                          pipeline=pipeline)
    kinds = [c["kind"] for c in port_run]
    assert kinds[0] == "full" and "delta" in kinds, kinds
    for i, (j, p) in enumerate(zip(jax_run, port_run)):
        assert p["binds"] == j["binds"], i
        assert p["mirror"] == j["mirror"], i
        assert p["kind"] == j["kind"], i
        assert p["bytes"] == j["bytes"], i
        assert p["frames"] == j["frames"], i
    assert port_run[-1]["binds"]
    # The remote cycle makes the local card cycle's decisions.
    local = local_run(pipeline=pipeline)
    for p, q in zip(port_run, local):
        assert p["binds"] == q["binds"]
        assert p["mirror"] == q["mirror"]


def test_remote_wire_off_ships_full_frames_like_jax(monkeypatch):
    """The kill switch (``VOLCANO_TPU_WIRE=0``): classic v1 full frames,
    byte for byte the JAX package's."""
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "0")
    jax_run = remote_run(volcano_tpu, monkeypatch, cycles=3)
    port_run = remote_run(volcano_tpu_torch, monkeypatch, cycles=3)
    assert [c["kind"] for c in port_run] == ["full"] * 3
    assert [c["frames"] for c in port_run] == [c["frames"] for c in jax_run]
    assert [c["binds"] for c in port_run] == [c["binds"] for c in jax_run]


class _Capture:
    """A client that records the solve it is asked for, then forwards it."""

    def __init__(self, client):
        self.client = client
        self.calls = []

    def solve(self, inputs, pid, profiles, wave=None, devincr=None):
        self.calls.append((inputs, pid, profiles, devincr))
        return self.client.solve(inputs, pid, profiles, wave=wave,
                                 devincr=devincr)

    def __getattr__(self, name):
        return getattr(self.client, name)


def _reply_arrays(res):
    return [np.asarray(getattr(res, f)) for f in (
        "assigned", "pipelined", "never_ready", "fit_failed", "iters",
        "fb_exhausted", "fb_affinity")]


def test_cross_package_clients_and_children():
    """One cycle's solve frame through every client / child pair: the JAX
    client to the port child and the port client to the JAX child reply
    what each package's own pair replies, array for array."""
    jsrv, psrv = jax_server(), port_server()
    try:
        reset_uids()
        store = volcano_tpu_torch.synth.synthetic_cluster(
            n_nodes=24, n_pods=72, gang_size=4, seed=13)
        cap = _Capture(pss.RemoteSolver(f"127.0.0.1:{psrv.port}",
                                        timeout=TIMEOUT))
        store.remote_solver = cap
        PortScheduler(store, device="cpu").run_once()
        assert store.binder.binds
        inputs, pid, profiles, devincr = cap.calls[0]
        replies = {}
        for cname, cmod in (("jax", jss), ("port", pss)):
            for sname, srv in (("jax", jsrv), ("port", psrv)):
                c = cmod.RemoteSolver(f"127.0.0.1:{srv.port}",
                                      timeout=TIMEOUT)
                replies[cname, sname] = _reply_arrays(
                    c.solve(inputs, pid, profiles))
                assert c.ping()["wire"] == 2
                c.close()
        ref = replies["jax", "jax"]
        for key, arrs in replies.items():
            for a, b in zip(ref, arrs):
                assert a.dtype == b.dtype and a.shape == b.shape, key
                assert np.array_equal(a, b), key
        assert int((ref[0] >= 0).sum()) > 0
        store.close()
        cap.client.close()
    finally:
        jsrv.shutdown()
        psrv.shutdown()


def test_jax_scheduler_drives_port_child_and_reverse(monkeypatch):
    """Whole remote deployments across packages: a JAX scheduler on a
    port child and a port scheduler on a JAX child bind what the JAX
    package's own deployment binds, frame for frame."""
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "1")
    ref = remote_run(volcano_tpu, monkeypatch, cycles=4)
    psrv, jsrv = port_server(), jax_server()
    try:
        a = remote_run(volcano_tpu, monkeypatch, cycles=4,
                       client=jss.RemoteSolver(f"127.0.0.1:{psrv.port}",
                                               timeout=TIMEOUT))
        b = remote_run(volcano_tpu_torch, monkeypatch, cycles=4,
                       client=pss.RemoteSolver(f"127.0.0.1:{jsrv.port}",
                                               timeout=TIMEOUT))
    finally:
        psrv.shutdown()
        jsrv.shutdown()
    for r, x, y in zip(ref, a, b):
        assert x["binds"] == r["binds"] and y["binds"] == r["binds"]
        assert x["kind"] == r["kind"] == y["kind"]
        assert x["frames"] == r["frames"] == y["frames"]


# ------------------------------------------------ protocol v2's own paths


def test_wire_mirror_records_and_resync():
    mirror = pss._WireMirror()
    a0 = np.arange(40, dtype=np.int64).reshape(10, 4)
    a1 = np.zeros(6, np.float32)
    out = mirror.apply(sw, {"gen": 1}, [a0, a1], payload_shared=False)
    assert mirror.gen == 1 and len(out) == 2
    with pytest.raises(pss._ResyncNeeded) as ei:
        mirror.apply(sw, {"gen": 2, "base": 99, "recs": [[1], [1]]},
                     [], payload_shared=False)
    assert ei.value.have_gen == 1
    new0 = a0.copy()
    new0[2:4] = -7
    ranges = sw.diff_rows(new0, a0)
    desc = sw.ranges_to_desc(ranges)
    rowpay = sw.gather_rows(new0, ranges)
    new1 = np.ones(6, np.float32)
    out = mirror.apply(
        sw, {"gen": 2, "base": 1,
             "recs": [[sw.REC_DELTA, 0, 1], [sw.REC_FULL, 2]]},
        [desc, rowpay, new1], payload_shared=False)
    assert mirror.gen == 2
    assert np.array_equal(out[0], new0) and np.array_equal(out[1], new1)
    out2 = mirror.apply(
        sw, {"gen": 3, "base": 2, "recs": [[sw.REC_SAME], [sw.REC_SAME]]},
        [], payload_shared=False)
    assert np.array_equal(out2[0], new0) and np.array_equal(out2[1], new1)
    bad_desc = np.array([1, 5, 99], np.int64)
    with pytest.raises(ValueError):
        mirror.apply(
            sw, {"gen": 4, "base": 3,
                 "recs": [[sw.REC_DELTA, 0, 1], [sw.REC_SAME]]},
            [bad_desc, np.zeros(0, np.uint8)], payload_shared=False)
    assert mirror.gen == -1
    with pytest.raises(pss._ResyncNeeded):
        mirror.apply(
            sw, {"gen": 5, "base": 4,
                 "recs": [[sw.REC_SAME], [sw.REC_SAME]]},
            [], payload_shared=False)


def _result_frame(**extra):
    arrays_out: list = []
    vals = tuple(np.int32(i) for i in range(7))
    tree = sw.flatten_tree(vals, arrays_out)
    return sw.encode_frame(arrays_out, {"op": "result", "tree": tree,
                                        **extra})


def test_wire_resync_and_ack_mismatch_drop_reply():
    client = pss.RemoteSolver("127.0.0.1:1")  # never connects
    client._wire.arrays = [np.zeros(4)]
    client._wire.spec = "spec"
    resync = sw.encode_frame([], {"op": "resync", "have_gen": 3})
    with pytest.raises(ValueError, match="resync"):
        client._decode_result(resync)
    assert client.wire_fallbacks.get("gen-mismatch") == 1
    assert client._wire.arrays is None
    client._wire.arrays = [np.zeros(4)]
    with pytest.raises(ValueError, match="acked gen"):
        client._decode_result(_result_frame(ack_gen=2), expect_gen=3)
    assert client.wire_fallbacks.get("ack-mismatch") == 1
    assert client._wire.arrays is None
    res = client._decode_result(_result_frame(ack_gen=3), expect_gen=3)
    assert int(res.iters) == 4
    client._wire.arrays = [np.zeros(4)]
    err = sw.encode_frame([], {"op": "error", "message": "boom"})
    with pytest.raises(RuntimeError, match="boom"):
        client._decode_result(err)
    assert client.wire_fallbacks.get("child-error") == 1
    assert client._wire.arrays is None
    with pytest.raises(RuntimeError, match="boom"):
        client._decode_result(err)
    assert client.wire_fallbacks.get("child-error") == 1


def test_child_answers_resync_without_solving_and_invalidates():
    """A delta whose base the child's mirror does not hold gets a resync
    reply, no solve runs, and the connection's device-incremental planes
    are dropped; a malformed delta poisons the mirror."""
    from volcano_tpu_torch.ops.devincr import DeviceIncremental

    server = pss.SolverServer(port=0, device="cpu")
    try:
        dv = DeviceIncremental()
        dv._static = ("planes",)
        mirror = pss._WireMirror()
        req = sw.encode_frame([], {"op": "solve", "tree": {"t": "none"},
                                   "wire": {"gen": 2, "base": 1,
                                            "recs": []}})
        with pytest.raises(pss._ResyncNeeded):
            server._handle(req, pss._registry(), sw, dv, mirror,
                           pss._ShmReader())
        assert server.solves == 0
    finally:
        server.shutdown()


def test_wire_v1_child_self_disables(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "1")
    client = pss.RemoteSolver("127.0.0.1:1")
    v1_reply = _result_frame()
    client._wire.arrays = [np.zeros(4)]
    client.last_frame_kind = "full"
    res = client._decode_result(v1_reply, expect_gen=1)
    assert int(res.iters) == 4
    assert client._wire_v1_child
    assert client.wire_fallbacks.get("v1-child") == 1
    assert client._wire.arrays is None
    total, parts, kind, gen = client._build_frame(
        (np.arange(4, dtype=np.int32),), np.int32(0), None, None, None)
    assert kind == "full" and gen is None
    man, _ = sw.decode_frame(b"".join(bytes(p) for p in parts))
    assert "wire" not in man
    client2 = pss.RemoteSolver("127.0.0.1:1")
    client2.last_frame_kind = "delta"
    with pytest.raises(ValueError, match="protocol-v1"):
        client2._decode_result(v1_reply, expect_gen=1)
    assert client2._wire_v1_child


def test_wire_shm_v1_child_handshake(monkeypatch):
    import socket as socketlib

    srv = socketlib.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(TIMEOUT)
    port = srv.getsockname()[1]
    result = _result_frame()
    seen = {}

    def serve_once():
        conn, _ = srv.accept()
        conn.settimeout(TIMEOUT)
        ping, _ = sw.decode_frame(pss.recv_frame(conn))
        seen["ping"] = ping.get("op")
        pss.send_frame(conn, sw.encode_frame(
            [], {"op": "pong", "solves": 0, "backend": "cpu"}))
        solve, _ = sw.decode_frame(pss.recv_frame(conn))
        seen["solve"] = solve
        pss.send_frame(conn, result)
        conn.close()

    t = threading.Thread(target=serve_once, daemon=True)
    t.start()
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "1")
    monkeypatch.setenv("VOLCANO_TPU_SHM", "1")
    client = pss.RemoteSolver(f"127.0.0.1:{port}", timeout=TIMEOUT)
    res = client.solve((np.arange(4, dtype=np.int32),), np.int32(0), None)
    t.join(timeout=TIMEOUT)
    assert int(res.iters) == 4
    assert client._wire_v1_child and client._shm is None
    assert client.wire_fallbacks.get("shm") == 1
    assert seen["ping"] == "ping"
    assert "wire" not in seen["solve"] and "shm" not in seen["solve"]
    client.close()
    srv.close()


def test_shm_lane_roundtrip_and_unavailable(monkeypatch):
    lane = pss._ShmLane()
    reader = pss._ShmReader()
    try:
        arrays = [np.arange(100, dtype=np.float32).reshape(10, 10),
                  np.array([3, -1], np.int64), np.zeros(0, np.uint8)]
        section = lane.write(arrays)
        out = reader.arrays(section)
        for a, b in zip(arrays, out):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
        big = [np.full(1 << 18, 7, np.float64)]
        sec2 = lane.write(big)
        assert sec2["name"] != section["name"]
        out2 = reader.arrays(sec2)
        assert np.array_equal(out2[0], big[0])
        bad = dict(sec2)
        bad["slots"] = [[0, [1 << 24], 0]]
        with pytest.raises(pss.ShmUnavailable):
            reader.arrays(bad)
        bad["slots"] = [[0, [1 << 32, 1 << 32], 0]]
        with pytest.raises(pss.ShmUnavailable):
            reader.arrays(bad)
        bad["slots"] = [[99, [1], 0]]
        with pytest.raises(pss.ShmUnavailable):
            reader.arrays(bad)
    finally:
        del out, out2, a, b
        reader.close()
        lane.close()
    with pytest.raises(pss.ShmUnavailable):
        pss._ShmReader().arrays({"name": "vtpu_bogus_nonexistent",
                                 "slots": []})
    monkeypatch.setenv("VOLCANO_TPU_SHM", "1")
    client = pss.RemoteSolver("127.0.0.1:1")
    assert client._shm is not None
    err = sw.encode_frame(
        [], {"op": "error",
             "message": "ShmUnavailable: cannot attach segment"})
    with pytest.raises(ValueError, match="dropped frame"):
        client._decode_result(err)
    assert client._shm is None
    assert client.wire_fallbacks.get("shm") == 1
    client.close()


def test_shm_lane_equals_tcp_lane(monkeypatch):
    """The shm lane's deployment binds what the TCP lane's binds, its
    socket frames shrink to manifests, and it never falls back."""
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "1")
    monkeypatch.setenv("VOLCANO_TPU_SHM", "1")
    srv = port_server()
    try:
        shm_client = pss.RemoteSolver(f"127.0.0.1:{srv.port}",
                                      timeout=TIMEOUT)
        assert shm_client._shm is not None
        shm = remote_run(volcano_tpu_torch, monkeypatch, client=shm_client,
                         pipeline=True, cycles=5, frames=False)
        fallbacks = dict(shm_client.wire_fallbacks)
        shm_bytes = dict(shm_client.frame_bytes)
        monkeypatch.delenv("VOLCANO_TPU_SHM")
        tcp_client = pss.RemoteSolver(f"127.0.0.1:{srv.port}",
                                      timeout=TIMEOUT)
        tcp = remote_run(volcano_tpu_torch, monkeypatch, client=tcp_client,
                         pipeline=True, cycles=5, frames=False)
        tcp_bytes = dict(tcp_client.frame_bytes)
    finally:
        srv.shutdown()
    assert "shm" not in fallbacks, fallbacks
    assert [c["binds"] for c in shm] == [c["binds"] for c in tcp]
    assert [c["mirror"] for c in shm] == [c["mirror"] for c in tcp]
    assert "delta" in [c["kind"] for c in shm]
    assert shm_bytes["full"] < tcp_bytes["full"] / 2, (shm_bytes, tcp_bytes)


def test_shm_unattachable_segment_falls_back_to_tcp(monkeypatch):
    """A child that cannot attach the client's segment answers
    ``ShmUnavailable``: that cycle's reply is lost (its rows re-place), the
    client drops the lane, and the next frame ships full over TCP."""
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "1")
    monkeypatch.setenv("VOLCANO_TPU_SHM", "1")
    from volcano_tpu_torch.metrics import metrics

    def refuse(self, section):
        raise pss.ShmUnavailable("cannot attach segment (test)")

    monkeypatch.setattr(pss._ShmReader, "arrays", refuse)
    before = metrics.remote_frame_fallback.data.get(
        (("reason", "shm"),), 0)
    srv = port_server()
    try:
        client = pss.RemoteSolver(f"127.0.0.1:{srv.port}", timeout=TIMEOUT)
        run = remote_run(volcano_tpu_torch, monkeypatch, client=client,
                         pipeline=True, cycles=4, churn=False, frames=False)
        fallbacks = dict(client.wire_fallbacks)
    finally:
        srv.shutdown()
    assert fallbacks.get("shm") == 1
    assert client._shm is None
    after = metrics.remote_frame_fallback.data.get((("reason", "shm"),), 0)
    assert after == before + 1
    assert run[-1]["binds"]


def test_child_restart_heals(monkeypatch):
    """A child process killed with a pipelined solve in flight: the reply
    is lost and its rows re-place, the restarted child's first frame is
    full, deltas resume, and every pod binds.  The children run with
    ``jax`` and ``volcano_tpu`` unimportable."""
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "1")
    proc, port = spawn_child()
    reset_uids()
    store = volcano_tpu_torch.synth.synthetic_cluster(
        n_nodes=16, n_pods=48, gang_size=4, seed=37)
    store.pipeline = True
    client = pss.RemoteSolver(f"127.0.0.1:{port}", timeout=TIMEOUT)
    store.remote_solver = client
    store.cycle_feed = _partial_feed([0, 1])
    sched = PortScheduler(store, device="cpu")
    kinds = []
    try:
        for _ in range(3):
            sched.run_once()
            kinds.append(client.last_frame_kind)
        assert "delta" in kinds
        stop_child(proc)
        proc, port = spawn_child()
        client.host, client.port = "127.0.0.1", port
        pre = client.frame_counts["delta"]
        for _ in range(3):
            sched.run_once()
            kinds.append(client.last_frame_kind)
        rec = [r for r in store.flight.recent()
               if r.drop_reasons.get("lost-reply", 0)]
        assert rec, "the in-flight reply was not lost"
        assert client.wire_fallbacks.get("reconnect", 0) >= 1
        post = kinds[3:]
        assert post[0] == "full" and "delta" in post, kinds
        assert client.frame_counts["delta"] > pre
        store.cycle_feed = None
        for _ in range(2):
            sched.run_once()
        store.flush_binds()
        from volcano_tpu_torch.api import TaskStatus

        m = store.mirror
        not_bound = [
            m.p_uid[r] for r in range(m.n_pods)
            if m.p_uid[r] is not None
            and int(m.p_status[r]) != int(TaskStatus.Bound)
        ]
        assert not_bound == []
    finally:
        stop_child(proc)
        store.close()
        client.close()


PREEMPT_CONF = """
actions: "enqueue, allocate, preempt, reclaim, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""


def test_remote_preempt_reclaim_take_the_host_walk_like_jax(monkeypatch):
    """A single-connection remote store runs preempt / reclaim on the host
    victim walk (the what-if solve would contend for the connection), in
    both packages alike: the same evictions and binds."""
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    monkeypatch.setenv("VOLCANO_TPU_NO_NATIVE", "1")
    out = {}
    for pkg in (volcano_tpu, volcano_tpu_torch):
        mod = jss if pkg is volcano_tpu else pss
        srv = jax_server() if pkg is volcano_tpu else port_server()
        reset_uids()
        store = pkg.synth.preempt_cluster(n_nodes=8, n_pending=16, seed=4)
        store.remote_solver = mod.RemoteSolver(f"127.0.0.1:{srv.port}",
                                               timeout=TIMEOUT)
        _scheduler(pkg, store, PREEMPT_CONF).run_once()
        store.flush_binds()
        out[pkg.__name__] = (sorted(store.evictor.evicts),
                             dict(store.binder.binds),
                             store.migrations is None)
        store.close()
        store.remote_solver.close()
        srv.shutdown()
    assert out["volcano_tpu"] == out["volcano_tpu_torch"]
    assert out["volcano_tpu_torch"][0]


# ------------------------------------------------------ the child's boundary


def _captured_solve():
    reset_uids()
    store = volcano_tpu_torch.synth.synthetic_cluster(
        n_nodes=24, n_pods=72, gang_size=4, seed=13)
    srv = port_server()
    cap = _Capture(pss.RemoteSolver(f"127.0.0.1:{srv.port}",
                                    timeout=TIMEOUT))
    store.remote_solver = cap
    PortScheduler(store, device="cpu").run_once()
    store.close()
    cap.client.close()
    srv.shutdown()
    return cap.calls[0]


def _solve_frame(call, gen, base=None, recs=None, arrays=None):
    inputs, pid, profiles, devincr = call
    flat: list = []
    tree = sw.flatten_tree((tuple(inputs), np.asarray(pid), profiles), flat)
    wire = {"gen": gen}
    if recs is not None:
        wire.update(base=base, recs=recs)
    man = {"op": "solve", "tree": tree, "wave": None, "devincr": devincr,
           "wire": wire}
    return bytearray(sw.encode_frame(flat if arrays is None else arrays,
                                     man)), flat


def _leaves(tree, out):
    if isinstance(tree, np.ndarray):
        out.append(tree)
    elif isinstance(tree, torch.Tensor):
        out.append(tree.numpy())
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _leaves(x, out)
    return out


def test_delta_after_a_solve_leaves_its_cached_planes_alone(monkeypatch):
    """The child copies each frame array once at its boundary: no array
    the solve is handed shares memory with the wire mirror's slots, and a
    delta that rewrites every slot after the solve leaves the solve's
    inputs and the device-incremental planes it cached bit for bit as they
    were (and its reply as it was)."""
    from volcano_tpu_torch.ops import wave
    from volcano_tpu_torch.ops.devincr import DeviceIncremental

    seen = []
    real_solve = wave.solve_wave

    def recording(*args, **kw):
        leaves = _leaves((args, kw.get("pid"), kw.get("profiles"),
                          kw.get("node_classes")), [])
        seen.append([(a, a.copy()) for a in leaves])
        return real_solve(*args, **kw)

    monkeypatch.setattr(wave, "solve_wave", recording)
    call = _captured_solve()
    seen.clear()
    assert call[3] is not None  # the frame carries devincr tokens
    server = pss.SolverServer(port=0, device="cpu")
    try:
        dv = DeviceIncremental()
        mirror = pss._WireMirror()
        req, flat = _solve_frame(call, gen=1)
        reply1 = server._handle(req, pss._registry(), sw, dv, mirror, None)
        assert len(seen) == 1 and seen[0]
        for leaf, _copy in seen[0]:
            for slot in mirror.arrays:
                assert not np.shares_memory(leaf, slot)
        assert dv._static is not None and dv.last_mode == "full"
        cached = [t.clone() for t in dv._static]
        cand = [t.clone() for t in dv._cand if isinstance(t, torch.Tensor)]
        # A delta flipping every byte of every multi-row slot in place.
        recs, payload = [], []
        for a in mirror.arrays:
            new = np.ascontiguousarray(a).copy()
            if new.ndim == 0 or not new.shape[0] or not new.nbytes:
                recs.append([sw.REC_SAME])
                continue
            new.reshape(-1).view(np.uint8)[:] ^= 0xFF
            r = sw.diff_rows(new, a)
            recs.append([sw.REC_DELTA, len(payload), len(payload) + 1])
            payload += [sw.ranges_to_desc(r), sw.gather_rows(new, r)]
        patched_before = [np.array(a, copy=True) for a in mirror.arrays]
        mirror.apply(sw, {"gen": 2, "base": 1, "recs": recs}, payload,
                     payload_shared=False)
        assert any(not np.array_equal(x, y)
                   for x, y in zip(patched_before, mirror.arrays))
        for leaf, copy in seen[0]:
            assert np.array_equal(leaf.view(np.uint8), copy.view(np.uint8))
        for before, now in zip(cached, dv._static):
            assert torch.equal(before, now)
        for before, now in zip(cand, [t for t in dv._cand
                                      if isinstance(t, torch.Tensor)]):
            assert torch.equal(before, now)
        # The reply of the first solve decodes unchanged.
        m1, a1 = sw.decode_frame(reply1)
        assert m1["op"] == "result" and m1["ack_gen"] == 1
    finally:
        server.shutdown()


def test_two_connections_solve_at_once():
    """Two connections of one child solving at the same time: each reply
    equals the one its frame gets alone; the solves ran one at a time."""
    call = _captured_solve()
    srv = port_server()
    try:
        solo = pss.RemoteSolver(f"127.0.0.1:{srv.port}", timeout=TIMEOUT)
        want = _reply_arrays(solo.solve(*call[:3]))
        solo.close()
        active = []
        peak = []
        real = pss.SolverServer._solve

        def tracked(self, *a, **k):
            active.append(1)
            peak.append(len(active))
            try:
                return real(self, *a, **k)
            finally:
                active.pop()

        start = threading.Barrier(2, timeout=TIMEOUT)
        got = [None, None]

        def run(i):
            c = pss.RemoteSolver(f"127.0.0.1:{srv.port}", timeout=TIMEOUT)
            start.wait()
            for _ in range(3):
                got[i] = _reply_arrays(c.solve(*call[:3]))
            c.close()

        pss.SolverServer._solve = tracked
        try:
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
        finally:
            pss.SolverServer._solve = real
        assert max(peak) == 1 and len(peak) == 6
        for arrs in got:
            for a, b in zip(want, arrs):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    finally:
        srv.shutdown()


def test_child_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pss.SolverServer(port=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pss.main(["--port", "0"])
    srv = pss.SolverServer(port=0, device="cpu")
    assert srv.device.type == "cpu"
    srv.shutdown()


def test_ping_names_the_device():
    srv = port_server()
    try:
        c = pss.RemoteSolver(f"127.0.0.1:{srv.port}", timeout=TIMEOUT)
        pong = c.ping()
        assert pong == {"op": "pong", "solves": 0, "backend": "cpu",
                        "device": "cpu", "wire": 2}
        # The JAX client reads the same pong.
        j = jss.RemoteSolver(f"127.0.0.1:{srv.port}", timeout=TIMEOUT)
        assert j.ping()["wire"] == 2
        c.close()
        j.close()
    finally:
        srv.shutdown()
