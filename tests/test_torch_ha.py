"""The port's checkpoints, leader election, scheduler loop and
controller-plane records against the JAX package's.

Twins of ``tests/test_ha_persistence.py``, ``tests/test_persistence_
roundtrip.py`` and ``tests/test_scheduler_loop.py`` for what the port runs:

- a checkpoint round trip schedules as the original store does, and as the
  JAX package's store does after its own round trip; bound state, claims,
  network policies, commands and batch jobs survive; a version mismatch
  and a corrupt file raise; saves are atomic under churn and leave no
  temporary file;
- a checkpoint names no ``torch`` module, and one written by the JAX
  package is refused in a process that never imports ``volcano_tpu``;
- the lease: a single holder, failover, and two worker processes (this
  module run as a script, on the CPU) contending while the leader is
  killed mid-cycle -- single-writer history, no double bind;
- the loop: the gate skips cycles and clears failures, a gated standby
  launches nothing and binds after it takes the lease, repeated failures
  turn ``healthy()`` False;
- the controller-plane record methods leave the dicts the JAX store's
  leave after the same calls.

Batch jobs and commands round-trip both as plain namespaces carrying the
fields the store keys them by and as the port's own ``controllers.apis``
records (``Job`` with its tasks, policies, volumes and status;
``Command``), equal to the JAX package's after its own round trip.

Run as ``python tests/test_torch_ha.py <lease> <log> <identity> <n_pods>``
the module is the two-process test's worker.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent


def _worker(lease_path, log_path, identity, n_pods):
    """While leading, "bind" pods by appending ``<identity> <epoch>
    <pod-id>`` lines to a shared O_APPEND log, fenced by the lease's
    ``acquired`` stamp re-read from the FILE just before each append; each
    cycle first resyncs the bound set from the log (a fresh leader goes on
    from what is bound, as a restarted scheduler rebuilds from the API
    server).  The JAX package's ``tests/ha_worker.py`` on the port's
    elector."""
    import json

    sys.path.insert(0, str(ROOT))
    from volcano_tpu_torch.ha import LeaderElector

    n_pods = int(n_pods)
    el = LeaderElector(lease_path, identity=identity, lease_duration=2.0,
                       renew_deadline=1.5, retry_period=0.1)
    threading.Thread(target=el.run, args=(lambda: None, lambda: None),
                     daemon=True).start()

    def lease_epoch():
        try:
            with open(lease_path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None
        if rec.get("holder") != identity \
                or time.time() >= float(rec.get("expiry", 0)):
            return None
        return rec.get("acquired")

    fd = os.open(log_path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    while True:
        if not el.is_leader:
            time.sleep(0.02)
            continue
        try:
            with open(log_path) as f:
                bound = {ln.split()[2] for ln in f if len(ln.split()) == 3}
        except OSError:
            bound = set()
        nxt = next((i for i in range(n_pods) if f"pod-{i}" not in bound),
                   None)
        if nxt is None:
            time.sleep(0.05)
            continue
        time.sleep(0.03)  # mid-cycle work: where the kill lands
        epoch = lease_epoch()
        if epoch is not None:
            os.write(fd, f"{identity} {epoch!r} pod-{nxt}\n".encode())


if __name__ == "__main__":
    _worker(*sys.argv[1:5])
    sys.exit(0)


import itertools  # noqa: E402
import pickle  # noqa: E402
import pickletools  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import volcano_tpu_torch  # noqa: E402
import volcano_tpu_torch.api.spec as port_spec  # noqa: E402
from volcano_tpu_torch import api  # noqa: E402
from volcano_tpu_torch.cache import ClusterStore  # noqa: E402
from volcano_tpu_torch.ha import LeaderElector  # noqa: E402
from volcano_tpu_torch.persistence import (  # noqa: E402
    FORMAT_VERSION, load_store, save_store)
from volcano_tpu_torch.scheduler import Scheduler  # noqa: E402


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("VOLCANO_TPU_PIPELINE", "VOLCANO_TPU_FASTPATH",
              "VOLCANO_TPU_AUDIT", "VOLCANO_TPU_JOURNEY"):
        monkeypatch.delenv(k, raising=False)


def _jax():
    import volcano_tpu
    import volcano_tpu.api.spec
    import volcano_tpu.cache
    import volcano_tpu.persistence
    import volcano_tpu.scheduler

    return volcano_tpu


def _reset_uid_counters():
    import volcano_tpu.api.spec as jax_spec

    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _sched(pkg, store, **kw):
    if pkg is volcano_tpu_torch:
        return Scheduler(store, device="cpu", **kw)
    store.pipeline = False
    return pkg.scheduler.Scheduler(store, **kw)


def _populated(pkg):
    a = pkg.api
    store = pkg.cache.ClusterStore()
    store.add_node(a.Node(name="n0", allocatable={"cpu": "8",
                                                  "memory": "16Gi"}))
    store.add_node(a.Node(name="n1", allocatable={"cpu": "8",
                                                  "memory": "16Gi"},
                          labels={"zone": "z1"}))
    store.add_queue(a.Queue(name="gold", weight=4))
    store.add_priority_class(a.PriorityClass(name="high", value=100))
    store.add_pod_group(a.PodGroup(name="pg", min_member=2, queue="gold",
                                   priority_class="high"))
    for i in range(2):
        store.add_pod(a.Pod(
            name=f"p{i}", containers=[{"cpu": "1", "memory": "1Gi"}],
            annotations={a.GROUP_NAME_ANNOTATION: "pg"}))
    return store


def _roundtrip(pkg, make, tmp_path, before=0, cycles=1):
    """``make(pkg)``, ``before`` cycles, a checkpoint, then ``cycles``
    cycles on the original and the restored store: both stores' binds."""
    _reset_uid_counters()
    a = make(pkg)
    for _ in range(before):
        _sched(pkg, a).run_once()
    path = str(tmp_path / f"{pkg.__name__}.ckpt")
    pkg.persistence.save_store(a, path)
    b = pkg.persistence.load_store(path)
    assert set(b.pods) == set(a.pods)
    assert set(b.pod_groups) == set(a.pod_groups)
    assert set(b.raw_queues) == set(a.raw_queues)
    for store in (a, b):
        sched = _sched(pkg, store)
        for _ in range(cycles):
            sched.run_once()
        store.flush_binds()
    out = (dict(a.binder.binds), dict(b.binder.binds),
           {p.name: p.node_name for p in b.pods.values()})
    a.close()
    b.close()
    return out


def _both(run):
    jax = _jax()
    return run(jax), run(volcano_tpu_torch)


# ---------------------------------------------------------- round trips


def test_checkpoint_roundtrip_schedules_identically(tmp_path):
    want, got = _both(lambda pkg: _roundtrip(pkg, _populated, tmp_path))
    assert got == want
    assert got[0] == got[1] and len(got[1]) == 2


def test_restored_priority_and_bound_state_survive(tmp_path):
    """Bound pods keep their node through the round trip; the restored
    store finds nothing pending (a fresh binder binds nothing)."""
    want, got = _both(lambda pkg: _roundtrip(pkg, _populated, tmp_path,
                                             before=1))
    assert got == want
    assert got[1] == {}
    assert all(got[2].values())
    store = _populated(volcano_tpu_torch)
    save_store(store, str(tmp_path / "p.ckpt"))
    assert load_store(str(tmp_path / "p.ckpt")).jobs[
        "default/pg"].priority == 100


def _topology_store(pkg):
    a = pkg.api
    store = pkg.cache.ClusterStore()
    for i in range(4):
        store.add_node(a.Node(
            name=f"n{i}", allocatable={"cpu": "4", "memory": "8Gi",
                                       "pods": 16},
            topology={"volcano-tpu/slice": f"s{i // 2}"}))
    term = a.AffinityTerm(match_labels={"app": "x"},
                          topology_key="volcano-tpu/slice")
    store.add_pod_group(a.PodGroup(name="g", min_member=4))
    for k in range(4):
        store.add_pod(a.Pod(
            name=f"p{k}", labels={"app": "x"},
            containers=[{"cpu": "1", "memory": "1Gi"}],
            annotations={a.GROUP_NAME_ANNOTATION: "g"}, affinity=[term]))
    return store


def test_checkpoint_restore_preserves_topology_and_affinity(tmp_path):
    want, got = _both(lambda pkg: _roundtrip(pkg, _topology_store,
                                             tmp_path))
    assert got == want
    assert got[0] == got[1] and len(got[1]) == 4
    assert len({int(n[1]) // 2 for n in got[1].values()}) == 1


def _churned_roundtrip(pkg, tmp_path):
    """A synthetic cluster after a few churned cycles, then a checkpoint
    and three more cycles on both stores."""
    _reset_uid_counters()
    store = pkg.synth.synthetic_cluster(n_nodes=16, n_pods=96, gang_size=4,
                                        seed=21)
    sched = _sched(pkg, store)
    sched.run_once()
    a = pkg.api
    store.add_pod_group(a.PodGroup(name="late", min_member=2))
    for k in range(2):
        store.add_pod(a.Pod(name=f"late-{k}",
                            annotations={a.GROUP_NAME_ANNOTATION: "late"},
                            containers=[{"cpu": "2", "memory": "2Gi"}]))
    path = str(tmp_path / f"{pkg.__name__}-churn.ckpt")
    pkg.persistence.save_store(store, path)
    restored = pkg.persistence.load_store(path)
    out = []
    for s in (store, restored):
        sc = _sched(pkg, s)
        for _ in range(3):
            sc.run_once()
        s.flush_binds()
        out.append({p.name: p.node_name for p in s.pods.values()})
    store.close()
    restored.close()
    return out


def test_churned_roundtrip_equal_jax(tmp_path):
    import volcano_tpu.synth  # noqa: F401
    import volcano_tpu_torch.synth  # noqa: F401

    want, got = _both(lambda pkg: _churned_roundtrip(pkg, tmp_path))
    assert got == want
    assert got[0] == got[1]
    assert got[1]["late-0"] is not None


def test_checkpoint_roundtrips_claims_policies_and_commands(tmp_path):
    store = ClusterStore()
    store.add_node(api.Node(name="n0", allocatable={"cpu": "8",
                                                    "memory": "16Gi"}))
    store.put_pvc("default", "user-data", {"storage": "5Gi"})
    store.put_network_policy("default", "job-a", {
        "pod_selector": {"k": "v"}, "ingress_from": [{"k": "v"}],
        "policy_types": ["Ingress"]})
    store.add_command(SimpleNamespace(name="pending-cmd", action="AbortJob",
                                      target_kind="Job", target_name="j9"))
    store.add_batch_job(SimpleNamespace(key="default/j1", name="j1",
                                        min_available=2))
    store.put_config_map("default", "cm", {"a": "1"})
    store.put_secret("default", "s", {"token": b"x"})
    store.put_service("default", "svc", {"ports": [80]})
    store.add_pod_group(api.PodGroup(name="g", min_member=1))
    store.add_pod(api.Pod(name="p0",
                          containers=[{"cpu": "1", "memory": "1Gi"}],
                          annotations={api.GROUP_NAME_ANNOTATION: "g"},
                          volumes=[("user-data", "/data")]))
    Scheduler(store, device="cpu").run_once()
    assert store.pvcs["default/user-data"]["phase"] == "Bound"
    path = str(tmp_path / "state.ckpt")
    save_store(store, path)
    restored = load_store(path)
    assert restored.pvcs["default/user-data"]["phase"] == "Bound"
    assert restored.pvcs["default/user-data"]["node"] == "n0"
    assert restored.network_policies["default/job-a"][
        "policy_types"] == ["Ingress"]
    assert restored.n_volume_pods == 1
    assert restored.commands["pending-cmd"].action == "AbortJob"
    assert restored.batch_jobs["default/j1"].min_available == 2
    assert restored.config_maps == {"default/cm": {"a": "1"}}
    assert restored.secrets == {"default/s": {"token": b"x"}}
    assert restored.services == {"default/svc": {"ports": [80]}}


def _controller_records_roundtrip(pkg, tmp_path):
    """A store holding a real batch ``Job`` (tasks, policies, a volume,
    plugins, a status mid-restart) and a pending ``Command``, saved and
    loaded by the package's own persistence."""
    import importlib

    ctrl = importlib.import_module(f"{pkg.__name__}.controllers")
    persist = importlib.import_module(f"{pkg.__name__}.persistence")
    from test_torch_fixtures import plain, reset_uid_counters

    reset_uid_counters()
    store = pkg.cache.ClusterStore()
    job = ctrl.Job(
        name="j1", min_available=2, max_retry=4,
        tasks=[ctrl.TaskSpec(
            name="w", replicas=2, containers=[{"cpu": "1"}],
            env={"A": "1"}, policies=[ctrl.LifecyclePolicy(
                action="RestartJob", event="PodFailed")])],
        volumes=[ctrl.VolumeSpec(mount_path="/d",
                                 volume_claim={"storage": "1Gi"})],
        plugins={"svc": [], "env": []}, ttl_seconds_after_finished=60.0)
    job.status.state.phase = "Restarting"
    job.status.retry_count = 1
    job.status.version = 3
    store.add_batch_job(job)
    store.add_command(ctrl.Command(action="ResumeJob", target_kind="Job",
                                   target_name="j1"))
    path = str(tmp_path / f"{pkg.__name__}.ckpt")
    persist.save_store(store, path)
    back = persist.load_store(path)
    out = (type(back.batch_jobs["default/j1"]).__name__,
           plain(back.batch_jobs["default/j1"]),
           [(type(c).__name__, plain(c)) for c in back.commands.values()])
    assert back.batch_jobs["default/j1"] == job
    store.close()
    back.close()
    return out


def test_checkpoint_roundtrips_real_job_and_command(tmp_path):
    import volcano_tpu

    want = _controller_records_roundtrip(volcano_tpu, tmp_path)
    got = _controller_records_roundtrip(volcano_tpu_torch, tmp_path)
    assert got == want
    assert got[0] == "Job" and got[2][0][0] == "Command"
    assert got[1]["status"]["retry_count"] == 1


def test_version_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt.bin")
    save_store(ClusterStore(), path)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    blob["version"] = FORMAT_VERSION + 999
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    with pytest.raises(ValueError, match="unsupported checkpoint"):
        load_store(path)


def test_corrupt_checkpoint_raises_loudly(tmp_path):
    path = str(tmp_path / "ckpt.bin")
    with open(path, "wb") as f:
        f.write(b"\x80\x04 garbage that is not a pickle")
    with pytest.raises(Exception):
        load_store(path)


def test_save_is_atomic_under_concurrent_churn(tmp_path):
    store = ClusterStore()
    store.add_node(api.Node(name="n0", allocatable={
        "cpu": "64", "memory": "128Gi", "pods": 256}))
    store.add_pod_group(api.PodGroup(name="g", min_member=1))
    stop = threading.Event()
    errors = []

    def churn():
        i = 0
        try:
            while not stop.is_set() and i < 500:
                i += 1
                pod = api.Pod(name=f"p-{i}",
                              annotations={api.GROUP_NAME_ANNOTATION: "g"},
                              containers=[{"cpu": "1", "memory": "1Gi"}])
                store.add_pod(pod)
                if i % 2 == 0:
                    store.delete_pod(pod)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    t = threading.Thread(target=churn)
    t.start()
    try:
        for k in range(10):
            path = str(tmp_path / f"ckpt-{k}.bin")
            save_store(store, path)
            restored = load_store(path)
            for pod in restored.pods.values():
                row = restored.mirror.p_row[pod.uid]
                assert restored.mirror.p_pod[row] is pod
    finally:
        stop.set()
        t.join(timeout=10)
    assert not errors
    leftovers = [p.name for p in tmp_path.iterdir()
                 if p.name.startswith(".vctpu-ckpt-")]
    assert leftovers == []


def test_no_temp_files_left_behind(tmp_path):
    store = ClusterStore()
    store.add_node(api.Node(name="n0", allocatable={"cpu": "1",
                                                    "memory": "1Gi"}))
    for _ in range(5):
        save_store(store, str(tmp_path / "ckpt.bin"))
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt.bin"]


# ------------------------------------------------ what a checkpoint names


def _pickled_modules(blob):
    from volcano_tpu_torch.persistence import _globals

    return {m for m, _n in _globals(blob)}


def test_checkpoint_names_no_torch_module(tmp_path):
    """After cycles that attach the mirror's and the resources' caches to
    the specs, the checkpoint still names no torch module (and every
    global it names is the port's or the stdlib's)."""
    import volcano_tpu_torch.synth as synth

    store = synth.synthetic_cluster(n_nodes=8, n_pods=32, gang_size=4,
                                    zones=4, seed=2)
    sched = Scheduler(store, device="cpu")
    sched.run_once()
    sched.run_once()
    assert any(getattr(p, "_mirror_feat", None) is not None
               for p in store.pods.values())
    path = tmp_path / "state.ckpt"
    save_store(store, str(path))
    blob = path.read_bytes()
    assert b"torch." not in blob.replace(b"volcano_tpu_torch", b"")
    mods = _pickled_modules(blob)
    assert mods and not any(m.split(".")[0] == "torch" for m in mods)
    assert all(m.startswith("volcano_tpu_torch") or m in (
        "builtins", "collections", "copyreg", "datetime", "types")
        for m in mods), mods
    # Every opcode parses: the stream is whole.
    assert sum(1 for _ in pickletools.genops(blob)) > 0


def test_save_refuses_a_tensor(tmp_path):
    import torch

    store = _populated(volcano_tpu_torch)
    store.put_service("default", "bad", {"plane": torch.zeros(2)})
    with pytest.raises(TypeError, match="torch"):
        save_store(store, str(tmp_path / "bad.ckpt"))
    assert list(tmp_path.iterdir()) == []


_LOAD_JAX_CKPT = r'''
import sys
from volcano_tpu_torch.persistence import load_store
try:
    load_store(sys.argv[1])
except ValueError as e:
    assert "JAX package" in str(e), e
else:
    raise SystemExit("a JAX checkpoint loaded")
assert not any(k.split(".")[0] in ("volcano_tpu", "jax", "jaxlib")
               for k in sys.modules), sorted(sys.modules)
print("refused")
'''


def test_jax_checkpoint_refused_without_importing_jax(tmp_path):
    jax = _jax()
    path = str(tmp_path / "jax.ckpt")
    jax.persistence.save_store(_populated(jax), path)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _LOAD_JAX_CKPT, path],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "refused"


# ------------------------------------------------------------ the lease


def test_leader_election_single_holder(tmp_path):
    lease = str(tmp_path / "lease")
    kw = dict(lease_duration=0.5, renew_deadline=0.3, retry_period=0.05)
    a = LeaderElector(lease, identity="a", **kw)
    b = LeaderElector(lease, identity="b", **kw)
    assert a.try_acquire()
    assert not b.try_acquire()
    assert a.renew()
    time.sleep(0.6)
    assert b.try_acquire()
    assert not a.renew()


def test_leader_election_failover(tmp_path):
    lease = str(tmp_path / "lease")
    events = []
    kw = dict(lease_duration=0.4, renew_deadline=0.2, retry_period=0.05)
    a = LeaderElector(lease, identity="a", **kw)
    b = LeaderElector(lease, identity="b", **kw)
    tb = threading.Thread(target=lambda: b.run(
        lambda: events.append("b-lead"), lambda: events.append("b-stop"),
        once=True), daemon=True)
    assert a.try_acquire()
    tb.start()
    time.sleep(0.3)
    assert not b.is_leader
    a.stop()  # releases the lease
    time.sleep(0.5)
    assert "b-lead" in events
    b.stop()
    tb.join(timeout=2)


def test_leader_demotes_on_foreign_holder(tmp_path):
    """A leader that finds another identity in the record stops leading
    at once, without waiting out its renew deadline."""
    import json

    lease = str(tmp_path / "lease")
    events = []
    a = LeaderElector(lease, identity="a", lease_duration=30.0,
                      renew_deadline=0.2, retry_period=0.05)
    ta = threading.Thread(target=lambda: a.run(
        lambda: events.append("lead"), lambda: events.append("stop"),
        once=True), daemon=True)
    ta.start()
    deadline = time.time() + 5
    while not a.is_leader and time.time() < deadline:
        time.sleep(0.01)
    assert a.is_leader
    with open(lease, "w") as f:
        json.dump({"holder": "z", "acquired": time.time(),
                   "expiry": time.time() + 30}, f)
    ta.join(timeout=5)
    assert events == ["lead", "stop"] and not a.is_leader


def test_leader_election_two_processes_kill_mid_cycle(tmp_path):
    """Two worker processes contend for the lease; the leader is
    SIGKILLed mid-cycle (no release: the lease must expire).  The
    survivor takes over and makes progress; every leadership change
    carries a larger lease epoch, no epoch has two holders, the killed
    identity writes nothing after the survivor's first bind, and no pod
    is bound twice."""
    lease = str(tmp_path / "lease")
    log = str(tmp_path / "binds.log")
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def spawn(ident):
        return subprocess.Popen(
            [sys.executable, __file__, lease, log, ident, "200"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env)

    def read_log():
        try:
            with open(log) as f:
                return [tuple(ln.split()) for ln in f
                        if len(ln.split()) == 3]
        except OSError:
            return []

    pa, pb = spawn("A"), spawn("B")
    try:
        deadline = time.time() + 30
        while time.time() < deadline and len(read_log()) < 5:
            time.sleep(0.05)
        recs = read_log()
        assert len(recs) >= 5, "no leader emerged within 30 s"
        leader = recs[-1][0]
        kill_marker = len(recs)
        victim = pa if leader == "A" else pb
        victim.kill()
        victim.wait()
        survivor = "B" if leader == "A" else "A"
        deadline = time.time() + 30
        while time.time() < deadline:
            if sum(1 for r in read_log() if r[0] == survivor) >= 5:
                break
            time.sleep(0.05)
        recs = read_log()
        assert sum(1 for r in recs if r[0] == survivor) >= 5
    finally:
        for p in (pa, pb):
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
                p.wait()
    epochs = [float(r[1]) for r in recs]
    for i in range(1, len(recs)):
        if recs[i][0] != recs[i - 1][0]:
            assert epochs[i] > epochs[i - 1], recs
    by_epoch = {}
    for ident, ep, _pod in recs:
        assert by_epoch.setdefault(ep, ident) == ident, recs
    post = [r[0] for r in recs[kill_marker:]]
    if survivor in post:
        first = kill_marker + post.index(survivor)
        assert not [r for r in recs[first:] if r[0] == leader], recs
    pods = [r[2] for r in recs]
    assert len(pods) == len(set(pods)), "a pod was bound twice"


# -------------------------------------------------------- the loop


def _small(pkg):
    _reset_uid_counters()
    return pkg.synth.synthetic_cluster(n_nodes=4, n_pods=8, gang_size=2)


def _gate_run(pkg):
    import volcano_tpu.synth  # noqa: F401
    import volcano_tpu_torch.synth  # noqa: F401

    store = _small(pkg)
    leading = threading.Event()
    sched = _sched(pkg, store, schedule_period=0.01, gate=leading.is_set)
    sched._consecutive_failures = sched.UNHEALTHY_AFTER
    red = sched.healthy()
    sched.run()
    try:
        time.sleep(0.1)
        standby = (len(store.binder.binds), len(store.flight.recent()),
                   sched.healthy())
        leading.set()
        deadline = time.time() + 10.0
        while len(store.binder.binds) < 8 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        sched.stop()
    out = (red, standby, dict(store.binder.binds))
    store.close()
    return out


def test_leadership_gate_skips_cycles_and_clears_failures():
    want, got = _both(_gate_run)
    assert got == want
    assert got[0] is False
    assert got[1] == (0, 0, True)  # no cycle while standing by; healthy
    assert len(got[2]) == 8


def _failing_run(pkg):
    store = _small(pkg)
    sched = _sched(pkg, store, schedule_period=0.01)

    def boom():
        raise RuntimeError("cycle exploded")

    sched.run_once = boom
    before = sched.healthy()
    sched.run()
    try:
        deadline = time.time() + 5.0
        while sched.healthy() and time.time() < deadline:
            time.sleep(0.02)
    finally:
        sched.stop()
    out = (before, sched.healthy(),
           sched._consecutive_failures >= sched.UNHEALTHY_AFTER)
    store.close()
    return out


def test_repeated_failures_turn_healthy_false():
    import volcano_tpu.synth  # noqa: F401
    import volcano_tpu_torch.synth  # noqa: F401

    want, got = _both(_failing_run)
    assert got == want == (True, False, True)


def test_gated_standby_launches_nothing_then_leads(tmp_path):
    """A scheduler gated on a ``LeaderElector`` whose lease another
    identity holds runs no cycle over several periods (no bind, no flight
    record, no kernel launch); when the holder releases, the elector takes
    the lease and the next cycle binds; after ``stop()`` it is healthy."""
    import volcano_tpu_torch.synth as synth
    from volcano_tpu_torch.ops import kernels

    lease = str(tmp_path / "lease")
    kw = dict(lease_duration=0.5, renew_deadline=0.3, retry_period=0.05)
    holder = LeaderElector(lease, identity="holder", **kw)
    assert holder.try_acquire()
    me = LeaderElector(lease, identity="me", **kw)
    elect = threading.Thread(target=lambda: me.run(lambda: None,
                                                   lambda: None),
                             daemon=True)
    elect.start()
    store = synth.synthetic_cluster(n_nodes=4, n_pods=8, gang_size=2)
    sched = Scheduler(store, device="cpu", schedule_period=0.02,
                      gate=lambda: me.is_leader)
    kernels.reset_launches()
    sched.run()
    try:
        for _ in range(10):
            time.sleep(0.02)
            assert holder.renew()
        assert not me.is_leader
        assert store.binder.binds == {} and store.flight.recent() == []
        assert sum(kernels.LAUNCHES.values()) == 0
        holder.stop()  # releases the lease
        deadline = time.time() + 10.0
        while len(store.binder.binds) < 8 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        sched.stop()
        me.stop()
        elect.join(timeout=5)
    assert len(store.binder.binds) == 8
    assert sched.healthy()
    store.close()


# ------------------------------------------------ controller-plane records


def _records_run(pkg):
    a = pkg.api
    store = pkg.cache.ClusterStore()
    seen = []
    store.watch(lambda kind, event, obj: seen.append((kind, event)))
    job = SimpleNamespace(key="default/j1", name="j1")
    job2 = SimpleNamespace(key="default/j1", name="j1", version=2)
    store.add_batch_job(job)
    store.update_batch_job(job2)
    store.add_batch_job(SimpleNamespace(key="default/j2", name="j2"))
    store.delete_batch_job("default/j2")
    store.delete_batch_job("default/missing")
    store.add_command(SimpleNamespace(name="c1", action="AbortJob"))
    store.add_command(SimpleNamespace(name="c2", action="RestartJob"))
    store.delete_command("c2")
    store.put_config_map("default", "cm", {"a": "1"})
    store.put_config_map("default", "gone", {"b": "2"})
    store.delete_config_map("default", "gone")
    store.put_secret("default", "s", {"k": b"v"})
    store.put_secret("default", "s2", {"k": b"w"})
    store.delete_secret("default", "s2")
    store.put_service("default", "svc", {"ports": [80]})
    store.put_service("default", "svc2", {"ports": [81]})
    store.delete_service("default", "svc2")
    store.put_network_policy("default", "np", {"policy_types": ["Ingress"]})
    store.put_network_policy("default", "np2", {})
    store.delete_network_policy("default", "np2")
    store.put_pvc("default", "c1", {"storage": "1Gi"}, owner_job="default/j1")
    store.put_pvc("default", "c2", {"storage": "1Gi"}, owner_job="default/j1")
    store.put_pvc("default", "c3", {"storage": "1Gi"}, owner_job="other")
    dropped = store.delete_pvcs_owned_by("default/j1")
    store.add_node(a.Node(name="n0", allocatable={"cpu": "1",
                                                  "memory": "1Gi"}))
    store.add_pod_group(a.PodGroup(name="g", min_member=1))
    store.add_pod(a.Pod(name="p0", annotations={a.GROUP_NAME_ANNOTATION: "g"},
                        containers=[{"cpu": "8", "memory": "1Gi"}]))
    store.add_pod(a.Pod(name="p1", annotations={a.GROUP_NAME_ANNOTATION: "g"},
                        containers=[{"cpu": "1", "memory": "1Gi"}],
                        node_name="n0"))
    pending = sorted(p.name for p in store.pending_pods())
    uid = next(p.uid for p in store.pods.values() if p.name == "p0")
    found = store.task_in_store(uid).name
    return {
        "batch_jobs": {k: vars(v) for k, v in store.batch_jobs.items()},
        "commands": {k: vars(v) for k, v in store.commands.items()},
        "config_maps": store.config_maps,
        "secrets": store.secrets,
        "services": store.services,
        "network_policies": store.network_policies,
        "pvcs": sorted(store.pvcs),
        "dropped": dropped,
        "pending": pending,
        "found": (found, store.task_in_store("nope")),
        "notified": [s for s in seen
                     if s[0] in ("Job", "Command")],
    }


def test_controller_plane_records_equal_jax():
    want, got = _both(_records_run)
    assert got == want
    assert got["batch_jobs"] == {"default/j1": {"key": "default/j1",
                                                "name": "j1", "version": 2}}
    assert got["notified"] == [("Job", "add"), ("Job", "update"),
                               ("Job", "add"), ("Job", "delete"),
                               ("Command", "add"), ("Command", "add")]
    assert got["dropped"] == 2 and got["pvcs"] == ["default/c3"]
    assert got["pending"] == ["p0"] and got["found"] == ("p0", None)
