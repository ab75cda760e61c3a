"""The port's fast-path cycle against the JAX package's, cycle by cycle.

Twin runs: the JAX ``Scheduler`` and the port's ``Scheduler(device="cpu")``
on ``synthetic_cluster(n_nodes=24, n_pods=72, gang_size=4, seed=13)``,
pipeline off, a feed that re-pends the pods bound to nodes 0 and 1 every
cycle, and the randomized churn sequence of ``tests/test_devincr.py``
(gang adds, pod deletes, node flaps, solo pods) after every odd cycle.
After each of 10 cycles the mirror state, the binds, the PodGroup phases,
the device-incremental counters (warm / full / skip, static-plane hits and
builds) and the device-snapshot counters (full / delta / hits) must be
equal.  The port with ``VOLCANO_TPU_DEVINCR=0`` and
``VOLCANO_TPU_DEVSNAP=0`` must give the same binds, phases and mirror
states as with both on; and its solve must never copy a resident node
plane back to the host.
"""

import itertools
import random

import pytest
import torch

from test_torch_fixtures import churn as _churn
from test_torch_fixtures import mirror_state as _mirror_state
from test_torch_fixtures import repend_feed as _partial_feed

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _twin(pkg, cycles=10, on_cycle=None):
    _reset_uid_counters()
    store = pkg.synth.synthetic_cluster(n_nodes=24, n_pods=72, gang_size=4,
                                        seed=13)
    if pkg is volcano_tpu:
        store.pipeline = False
        sched = JaxScheduler(store)
    else:
        sched = PortScheduler(store, device="cpu")
    store.cycle_feed = _partial_feed([0, 1])
    rng = random.Random(7)
    trace = []
    for step in range(cycles):
        sched.run_once()
        dv = store._devincr_cache
        snap = store.device_snapshot
        trace.append({
            "mirror": _mirror_state(store),
            "binds": dict(store.binder.binds),
            "phases": {uid: pg.status.phase
                       for uid, pg in sorted(store.pod_groups.items())},
            "devincr": (None if dv is None else
                        (dict(dv.counts), dv.static_hits,
                         dv.static_builds)),
            "devsnap": (None if snap is None else
                        (snap.full_uploads, snap.delta_uploads, snap.hits)),
        })
        if on_cycle is not None:
            on_cycle(store)
        if step % 2 == 1:
            _churn(pkg.api, store, rng, step)
    store.close()
    return trace


import volcano_tpu.synth  # noqa: E402
import volcano_tpu_torch.synth  # noqa: E402

_CACHE = {}


def _jax_trace():
    if "jax" not in _CACHE:
        _CACHE["jax"] = _twin(volcano_tpu)
    return _CACHE["jax"]


@pytest.mark.parametrize("field", ["mirror", "binds", "phases", "devincr",
                                   "devsnap"])
def test_twin_cycles_equal_jax(field, monkeypatch):
    monkeypatch.delenv("VOLCANO_TPU_DEVINCR", raising=False)
    monkeypatch.delenv("VOLCANO_TPU_DEVSNAP", raising=False)
    want = _jax_trace()
    got = _twin(volcano_tpu_torch)
    assert len(got) == len(want) == 10
    for step, (a, b) in enumerate(zip(want, got)):
        assert a[field] == b[field], (field, step)


def test_twin_run_exercises_every_lane(monkeypatch):
    """The run is not vacuous: both warm and full shortlists, static-plane
    hits and builds, devsnap deltas and hits, and binds every cycle."""
    monkeypatch.delenv("VOLCANO_TPU_DEVINCR", raising=False)
    monkeypatch.delenv("VOLCANO_TPU_DEVSNAP", raising=False)
    got = _twin(volcano_tpu_torch)
    counts, hits, builds = got[-1]["devincr"]
    assert counts["warm"] >= 1 and counts["full"] >= 1
    assert hits >= 1 and builds >= 1
    full, delta, snap_hits = got[-1]["devsnap"]
    assert full >= 1 and delta >= 1 and snap_hits >= 1
    assert all(len(t["binds"]) > 0 for t in got)


@pytest.mark.parametrize("switch", ["VOLCANO_TPU_DEVINCR",
                                    "VOLCANO_TPU_DEVSNAP", "both"])
def test_lanes_off_equal_lanes_on(switch, monkeypatch):
    monkeypatch.delenv("VOLCANO_TPU_DEVINCR", raising=False)
    monkeypatch.delenv("VOLCANO_TPU_DEVSNAP", raising=False)
    on = _twin(volcano_tpu_torch)
    for name in (("VOLCANO_TPU_DEVINCR", "VOLCANO_TPU_DEVSNAP")
                 if switch == "both" else (switch,)):
        monkeypatch.setenv(name, "0")
    off = _twin(volcano_tpu_torch)
    for a, b in zip(on, off):
        for field in ("mirror", "binds", "phases"):
            assert a[field] == b[field], field
    if switch != "VOLCANO_TPU_DEVSNAP":
        assert off[-1]["devincr"] is None
    if switch != "VOLCANO_TPU_DEVINCR":
        assert off[-1]["devsnap"] is None


def test_solve_never_copies_resident_planes_to_host(monkeypatch):
    """A guard on the solve's host-copy helper: no resident devsnap plane
    or class table ever reaches it, and the solve counts no host reads."""
    import volcano_tpu_torch.ops.wave as tw

    stores = []
    real_np = tw._np

    def guarded(a):
        for store in stores:
            snap = store.device_snapshot
            if snap is None:
                continue
            for t in list(snap._planes.values()) + list(
                    snap._cls_planes.values()):
                if a is t:
                    raise AssertionError("resident plane copied to host")
        return real_np(a)

    monkeypatch.setattr(tw, "_np", guarded)
    reads = []

    def record(store):
        stores[:] = [store]
        reads.append(tw.LAST_TWOPHASE.get("host_reads"))

    _reset_uid_counters()
    store = volcano_tpu_torch.synth.synthetic_cluster(
        n_nodes=24, n_pods=72, gang_size=4, seed=13)
    stores.append(store)
    sched = PortScheduler(store, device="cpu")
    store.cycle_feed = _partial_feed([0, 1])
    for _ in range(4):
        sched.run_once()
        record(store)
    assert store.device_snapshot is not None
    assert store.device_snapshot.full_uploads == 1
    assert reads == [0, 0, 0, 0]


def test_resident_planes_unchanged_by_a_solve():
    """Only scatter_rows writes a resident plane: a cycle whose node table
    did not move leaves every resident tensor byte-equal."""
    _reset_uid_counters()
    store = volcano_tpu_torch.synth.synthetic_cluster(
        n_nodes=24, n_pods=72, gang_size=4, seed=13)
    sched = PortScheduler(store, device="cpu")
    store.cycle_feed = _partial_feed([0, 1])
    sched.run_once()
    snap = store.device_snapshot
    before = {k: v.clone() for k, v in snap._planes.items()}
    sched.run_once()
    assert snap.hits >= 1
    for k, v in before.items():
        assert torch.equal(v, snap._planes[k]), k


def test_update_node_takes_the_delta_scatter():
    """An allocatable change on a few nodes goes out as a row delta."""
    _reset_uid_counters()
    api = volcano_tpu_torch.api
    store = volcano_tpu_torch.synth.synthetic_cluster(
        n_nodes=24, n_pods=72, gang_size=4, seed=13)
    sched = PortScheduler(store, device="cpu")
    store.cycle_feed = _partial_feed([0, 1])
    sched.run_once()
    for name in ("node-000003", "node-000017"):
        store.update_node(api.Node(
            name=name, allocatable={"cpu": "32", "memory": "128Gi",
                                    "pods": 256}))
    sched.run_once()
    snap = store.device_snapshot
    assert snap.delta_uploads == 1 and snap.full_uploads == 1
    row = store.mirror.n_row["node-000003"]
    assert float(snap._planes["allocatable"][row, 0]) == 32000.0


def _flaky_binder(pkg, fail_keys):
    """A binder that fails each of ``fail_keys`` once (per-pod binds, so
    the commit takes its BindFailure revert path)."""
    BindFailure = pkg.cache.interface.BindFailure

    class Flaky:
        def __init__(self):
            self.binds = {}
            self.fail = set(fail_keys)

        def bind(self, task, hostname):
            key = f"{task.namespace}/{task.name}"
            if key in self.fail:
                self.fail.discard(key)
                raise BindFailure([key])
            self.binds[key] = hostname

    return Flaky()


def _bind_failure_run(pkg):
    _reset_uid_counters()
    store = pkg.synth.synthetic_cluster(n_nodes=8, n_pods=24, gang_size=4,
                                        seed=5)
    store.binder = _flaky_binder(pkg, ["default/pg-000001-2",
                                       "default/pg-000004-0"])
    if pkg is volcano_tpu:
        store.pipeline = False
        sched = JaxScheduler(store)
    else:
        sched = PortScheduler(store, device="cpu")
    out = []
    for _ in range(3):
        sched.run_once()
        out.append((dict(store.binder.binds), _mirror_state(store),
                    {u: pg.status.phase
                     for u, pg in sorted(store.pod_groups.items())}))
    return out


def test_bind_failures_revert_and_retry_like_jax():
    """A failed bind reverts its task to Pending and the next cycle
    re-places it: identical to the JAX package cycle by cycle."""
    import volcano_tpu.cache.interface  # noqa: F401
    import volcano_tpu_torch.cache.interface  # noqa: F401

    want = _bind_failure_run(volcano_tpu)
    got = _bind_failure_run(volcano_tpu_torch)
    assert got == want
    assert len(got[0][0]) == 22 and len(got[-1][0]) == 24


def test_dispatch_binds_failures_drain_with_backoff():
    """Binds dispatched through the store land on the binder; a failed
    one re-enters Pending with a backoff entry at the next drain."""
    api = volcano_tpu_torch.api
    _reset_uid_counters()
    store = volcano_tpu_torch.synth.synthetic_cluster(
        n_nodes=2, n_pods=2, gang_size=1, seed=1)
    store.binder = _flaky_binder(volcano_tpu_torch, ["default/pg-000001-0"])
    pods = sorted(store.pods.values(), key=lambda p: p.name)
    for pod in pods:
        pod.node_name = "node-000000"
        store.mirror.set_pod_state(pod.uid, int(api.TaskStatus.Bound), 0)
    keys = [f"{p.namespace}/{p.name}" for p in pods]
    store.dispatch_binds(keys, ["node-000000"] * 2, pods)
    assert store.flush_binds()
    assert store.binder.binds == {keys[0]: "node-000000"}
    assert store.events_for(f"Pod/{keys[0]}")[0]["reason"] == "Scheduled"
    assert store.drain_bind_failures() == 1
    assert keys[1] in store.bind_backoff and pods[1].node_name is None
    row = store.mirror.p_row[pods[1].uid]
    assert int(store.mirror.p_status[row]) == int(api.TaskStatus.Pending)
