"""The port's asynchronous bind dispatch against the JAX package's.

``store.async_bind = True`` queues a cycle's binds on
``volcano_tpu_torch/cache/bindqueue.py:BindDispatcher`` (a
``vc-bind-dispatch`` thread) at cycle end, and with them the pod-record
walk (``store.defer_bind_records``); failed binds re-enter Pending with a
rate-limited backoff at the next cycle's drain.  The twins of
``tests/test_bindqueue.py`` (those that need neither lockdep nor the
journey log) run the same store, seed and binder script through the JAX
``Scheduler`` and the port's ``Scheduler(device="cpu")``: binds, backoff
keys, events and pod records must be equal.
"""

import itertools
import threading
import time

import numpy as np
import pytest

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.cache.bindqueue as jax_bindqueue
import volcano_tpu.synth
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.cache.bindqueue as port_bindqueue
import volcano_tpu_torch.synth
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

PKGS = (volcano_tpu, volcano_tpu_torch)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("VOLCANO_TPU_PIPELINE", "VOLCANO_TPU_DEVINCR",
              "VOLCANO_TPU_DEVSNAP"):
        monkeypatch.delenv(k, raising=False)
    # The suite's setting (tests/conftest.py), pinned: a test that ran
    # earlier in the same worker may have unset it, and under the default
    # ("auto") the error a cycle here is expected to raise falls back
    # instead.
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "never")


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _sched(pkg, store, conf=None):
    if pkg is volcano_tpu:
        store.pipeline = False
        return JaxScheduler(store, conf_str=conf)
    return PortScheduler(store, conf_str=conf, device="cpu")


def _bindqueue(pkg):
    return jax_bindqueue if pkg is volcano_tpu else port_bindqueue


def _failure_cls(pkg):
    return pkg.cache.interface.BindFailure


def _flaky(pkg, store, fail_times):
    """The first ``fail_times`` batches fail the second half of their
    keys."""
    orig = store.binder.bind_keys
    state = {"left": fail_times}
    BindFailure = _failure_cls(pkg)

    def flaky(keys, hosts):
        if state["left"] > 0:
            state["left"] -= 1
            half = len(keys) // 2
            orig(list(keys[:half]), list(hosts[:half]))
            raise BindFailure(list(keys[half:]))
        orig(keys, hosts)

    store.binder.bind_keys = flaky
    return state


def _cluster(pkg, **kw):
    _reset_uid_counters()
    return pkg.synth.synthetic_cluster(**kw)


def _named(store):
    return sorted((f"{p.namespace}/{p.name}", p.node_name)
                  for p in store.pods.values())


def _twin(fn):
    """``fn(pkg)`` on both packages; the results must be equal."""
    want, got = fn(volcano_tpu), fn(volcano_tpu_torch)
    assert want == got
    return got


def test_async_bind_failure_reverts_with_backoff(monkeypatch):
    """tests/test_bindqueue.py:29."""
    for pkg in PKGS:
        monkeypatch.setattr(_bindqueue(pkg), "BACKOFF_BASE", 0.05)

    def run(pkg):
        store = _cluster(pkg, n_nodes=8, n_pods=24, gang_size=1)
        store.async_bind = True
        _flaky(pkg, store, fail_times=1)
        sched = _sched(pkg, store)
        steps = []
        sched.run_once()
        assert store.flush_binds(timeout=10)
        steps.append((dict(store.binder.binds), sorted(store.bind_backoff)))
        assert len(store.binder.binds) == 12
        sched.run_once()
        assert store.flush_binds(timeout=10)
        steps.append((dict(store.binder.binds), sorted(store.bind_backoff)))
        assert len(store.bind_backoff) == 12
        assert len(store.binder.binds) == 12
        key = sorted(store.bind_backoff)[0]
        evs = store.events_for(f"Pod/{key}")
        assert any(e["reason"] == "FailedScheduling" for e in evs)
        time.sleep(0.12)
        sched.run_once()
        assert store.flush_binds(timeout=10)
        steps.append((dict(store.binder.binds), _named(store)))
        assert len(store.binder.binds) == 24
        assert all(p.node_name for p in store.pods.values())
        sched.run_once()
        assert not store.bind_backoff
        store.close()
        return steps

    _twin(run)


def test_async_bind_success_records_scheduled_events():
    """tests/test_bindqueue.py:71."""
    def run(pkg):
        store = _cluster(pkg, n_nodes=4, n_pods=8, gang_size=1)
        store.async_bind = True
        _sched(pkg, store).run_once()
        assert store.flush_binds(timeout=10)
        out = {}
        for pod in store.pods.values():
            key = f"{pod.namespace}/{pod.name}"
            out[key] = [e["reason"] for e in store.events_for(f"Pod/{key}")]
        assert all("Scheduled" in r for r in out.values())
        store.close()
        return out

    _twin(run)


def test_unschedulable_gang_records_podgroup_event():
    """tests/test_bindqueue.py:81."""
    def run(pkg):
        store = _cluster(pkg, n_nodes=1, n_pods=4, gang_size=4,
                         pod_cpu_choices=("64",),
                         pod_mem_choices=("256Gi",))
        _sched(pkg, store).run_once()
        out = {}
        for pg in store.pod_groups.values():
            evs = store.events_for(f"PodGroup/{pg.namespace}/{pg.name}")
            out[pg.name] = sorted({e["reason"] for e in evs})
        assert any("Unschedulable" in r for r in out.values())
        store.close()
        return out

    _twin(run)


def test_evict_records_event(monkeypatch):
    """tests/test_bindqueue.py:97, on the device-native preempt / reclaim
    lanes (the port does not run the host victim walk)."""
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    conf = """
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

    def run(pkg):
        _reset_uid_counters()
        store = pkg.synth.preempt_cluster(n_nodes=4, fill_per_node=4,
                                          n_pending=8, gang_size=1)
        _sched(pkg, store, conf).run_once()
        evicted = list(getattr(store.evictor, "evicts", []))
        assert evicted
        reasons = [e["reason"] for e in store.events_for(f"Pod/{evicted[0]}")]
        store.close()
        return evicted, reasons

    evicted, reasons = _twin(run)
    assert "Evict" in reasons or "Reclaim" in reasons or "Preempt" in reasons


def test_indeterminate_batch_exception_redrives_per_key():
    """tests/test_bindqueue.py:119: a non-BindFailure exception from
    bind_keys re-drives the batch per key; nothing re-enters Pending."""
    def run(pkg):
        store = _cluster(pkg, n_nodes=8, n_pods=16, gang_size=1)
        store.async_bind = True
        orig = store.binder.bind_keys
        state = {"left": 1}

        def broken(keys, hosts):
            if state["left"] > 0:
                state["left"] -= 1
                half = len(keys) // 2
                orig(list(keys[:half]), list(hosts[:half]))
                raise RuntimeError("transport blew up mid-batch")
            orig(keys, hosts)

        store.binder.bind_keys = broken
        sched = _sched(pkg, store)
        sched.run_once()
        assert store.flush_binds(timeout=10)
        assert len(store.binder.binds) == 16
        sched.run_once()
        assert not store.bind_backoff
        assert all(p.node_name for p in store.pods.values())
        out = (dict(store.binder.binds), _named(store))
        store.close()
        return out

    _twin(run)


def test_deleted_pod_prunes_backoff_entry(monkeypatch):
    """tests/test_bindqueue.py:150."""
    for pkg in PKGS:
        monkeypatch.setattr(_bindqueue(pkg), "BACKOFF_BASE", 60.0)

    def run(pkg):
        store = _cluster(pkg, n_nodes=8, n_pods=8, gang_size=1)
        store.async_bind = True
        _flaky(pkg, store, fail_times=1)
        sched = _sched(pkg, store)
        sched.run_once()
        assert store.flush_binds(timeout=10)
        sched.run_once()
        keys = sorted(store.bind_backoff)
        assert keys
        ns, name = keys[0].split("/", 1)
        pod = next(p for p in store.pods.values()
                   if p.namespace == ns and p.name == name)
        store.delete_pod(pod)
        assert keys[0] not in store.bind_backoff
        out = (keys, sorted(store.bind_backoff))
        store.close()
        return out

    _twin(run)


def test_bind_failure_releases_claim_pin(monkeypatch):
    """tests/test_bindqueue.py:170."""
    for pkg in PKGS:
        monkeypatch.setattr(_bindqueue(pkg), "BACKOFF_BASE", 0.05)

    def run(pkg):
        api = pkg.api
        _reset_uid_counters()
        store = pkg.cache.ClusterStore()
        for n in ("n0", "n1"):
            store.add_node(api.Node(name=n, allocatable={
                "cpu": "8", "memory": "16Gi"}))
        store.put_pvc("default", "claim", {"storage": "1Gi"})
        store.add_pod_group(api.PodGroup(name="g", min_member=1))
        store.add_pod(api.Pod(
            name="p0", containers=[{"cpu": "1", "memory": "1Gi"}],
            annotations={api.GROUP_NAME_ANNOTATION: "g"},
            volumes=[("claim", "/data")]))
        store.async_bind = True
        _flaky(pkg, store, fail_times=1)
        sched = _sched(pkg, store)
        sched.run_once()
        assert store.flush_binds(timeout=10)
        sched.run_once()
        pod = next(iter(store.pods.values()))
        assert pod.node_name is None
        rec = store.pvcs["default/claim"]
        assert rec["phase"] == "Pending" and rec["node"] is None
        time.sleep(0.12)
        sched.run_once()
        assert store.flush_binds(timeout=10)
        pod = next(iter(store.pods.values()))
        assert pod.node_name is not None
        assert store.pvcs["default/claim"]["phase"] == "Bound"
        assert store.pvcs["default/claim"]["node"] == pod.node_name
        out = (pod.node_name, dict(store.binder.binds))
        store.close()
        return out

    _twin(run)


def test_dispatcher_vs_store_churn_stress(monkeypatch):
    """tests/test_bindqueue.py:213 on the port: concurrent dispatch, bind
    failures, pod deletes and re-adds, and cycle-thread drains -- no
    deadlock, no lost pod; every surviving pod binds or waits out a
    backoff, and the binder agrees with the records."""
    api = volcano_tpu_torch.api
    BindFailure = _failure_cls(volcano_tpu_torch)
    monkeypatch.setattr(port_bindqueue, "BACKOFF_BASE", 0.02)
    store = _cluster(volcano_tpu_torch, n_nodes=16, n_pods=64, gang_size=1,
                     seed=5)
    store.async_bind = True
    orig = store.binder.bind_keys
    calls = {"n": 0}

    def flaky(keys, hosts):
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            half = len(keys) // 2
            orig(list(keys[:half]), list(hosts[:half]))
            raise BindFailure(list(keys[half:]))
        orig(keys, hosts)

    store.binder.bind_keys = flaky
    sched = PortScheduler(store, device="cpu")
    stop = threading.Event()
    errors = []

    def churner():
        i = 0
        try:
            while not stop.is_set() and i < 400:
                i += 1
                name = f"churn-{i}"
                store.add_pod_group(api.PodGroup(name=name, min_member=1))
                pod = api.Pod(
                    name=f"{name}-0",
                    annotations={api.GROUP_NAME_ANNOTATION: name},
                    containers=[{"cpu": "1", "memory": "1Gi"}])
                store.add_pod(pod)
                time.sleep(0.002)
                if i % 2 == 0:
                    store.delete_pod(pod)
                    store.delete_pod_group(f"default/{name}")
        except Exception as e:  # pragma: no cover - failure channel
            errors.append(e)

    t = threading.Thread(target=churner)
    t.start()
    try:
        deadline = time.time() + 3.0
        while time.time() < deadline:
            sched.run_once()
            time.sleep(0.01)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert not errors, errors
    assert store.flush_binds(timeout=30)
    time.sleep(0.1)
    for _ in range(6):
        sched.run_once()
        store.flush_binds(timeout=30)
        time.sleep(0.03)
    store.close()
    for p in store.pods.values():
        key = f"{p.namespace}/{p.name}"
        if p.node_name is None and not p.deleting:
            assert key in store.bind_backoff, key
        if p.node_name is not None:
            assert store.binder.binds.get(key) == p.node_name


def test_flush_timeout_returns_false_on_wedged_binder():
    """tests/test_bindqueue.py:299."""
    release = threading.Event()

    class Wedged:
        def bind_keys(self, keys, hosts):
            release.wait(10)

    d = port_bindqueue.BindDispatcher(Wedged(), lambda pairs: None)
    assert d._thread.name == "vc-bind-dispatch"
    d.dispatch(["a/b"], ["n0"], [None])
    t0 = time.time()
    assert d.flush(timeout=0.2) is False
    assert time.time() - t0 < 5
    release.set()
    assert d.flush(timeout=10) is True
    d.stop()


def test_deferred_record_walk_sets_node_name_post_cycle():
    """tests/test_bindqueue.py:320."""
    def run(pkg):
        store = _cluster(pkg, n_nodes=4, n_pods=32, gang_size=4, seed=5)
        store.async_bind = True
        _sched(pkg, store).run_once()
        assert store.flush_binds(timeout=30)
        assert len(store.binder.binds) == 32
        out = (dict(store.binder.binds), _named(store))
        assert all(n for _, n in out[1])
        store.close()
        return out

    _twin(run)


def test_deferred_record_walk_applies_before_failure_resync(monkeypatch):
    """tests/test_bindqueue.py:336: a cycle failing after its commit
    applies the deferred record walk before the mirror resync."""
    from volcano_tpu.fastpath import FastCycle as JaxCycle

    from volcano_tpu_torch.fastpath import FastCycle as PortCycle

    def boom(self):
        raise RuntimeError("injected close failure")

    def run(pkg):
        store = _cluster(pkg, n_nodes=4, n_pods=32, gang_size=4, seed=6)
        store.async_bind = True
        cls = JaxCycle if pkg is volcano_tpu else PortCycle
        with monkeypatch.context() as mp:
            mp.setattr(cls, "_close", boom)
            with pytest.raises(RuntimeError, match="injected"):
                _sched(pkg, store).run_once()
        out = _named(store)
        assert all(n for _, n in out)
        store.flush_binds(timeout=30)
        store.close()
        return out

    _twin(run)


def test_apply_pending_bind_records_covers_undispatched_batches():
    """tests/test_bindqueue.py:362."""
    def run(pkg):
        store = _cluster(pkg, n_nodes=4, n_pods=32, gang_size=4, seed=7)
        store.async_bind = True
        _sched(pkg, store).run_once()
        store.apply_pending_bind_records()
        out = _named(store)
        assert all(n for _, n in out)
        store.flush_binds(timeout=30)
        assert len(store.binder.binds) == 32
        store.close()
        return out

    _twin(run)


def test_materialize_bind_entry_removes_by_identity():
    """tests/test_bindqueue.py:378: the deferred entry leaves the pending
    list by identity (``list.remove``'s == scan over numpy object arrays
    raises), and the drain loop terminates."""
    from volcano_tpu_torch.cache import ClusterStore

    class Rec:
        node_name = None

    store = ClusterStore()

    def batch(n, tag):
        keys = np.array([f"default/{tag}-{i}" for i in range(n)],
                        dtype=object)
        hosts = np.array([f"n{i}" for i in range(n)], dtype=object)
        pods = np.array([Rec() for _ in range(n)], dtype=object)
        return keys, hosts, pods

    e1 = store.defer_bind_records(*batch(3, "a"))
    e2 = store.defer_bind_records(*batch(3, "b"))
    keys, hosts, pods = store._materialize_bind_entry(e2)
    assert keys == ["default/b-0", "default/b-1", "default/b-2"]
    assert [p.node_name for p in pods] == ["n0", "n1", "n2"]
    assert not any(e is e2 for e in store._pending_record_walks)
    store.apply_pending_bind_records()
    assert store._pending_record_walks == []
    assert e1[3] is True
    store.close()


def test_sync_binds_stay_inline():
    """async_bind off (the default): the binds land before run_once
    returns, with no dispatcher thread."""
    store = _cluster(volcano_tpu_torch, n_nodes=4, n_pods=8, gang_size=1)
    assert store.async_bind is False
    PortScheduler(store, device="cpu").run_once()
    assert len(store.binder.binds) == 8
    assert store._bind_dispatcher is None
    assert all(p.node_name for p in store.pods.values())
    store.close()
