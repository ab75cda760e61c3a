"""The object session: twin ``Scheduler.run_once()`` cycles, the JAX
package's against the port's (``device="cpu"``), on the same store built
in each package.

A conf the fast path cannot run -- custom plugins, an unknown action,
``solver: seq`` -- or any conf while ``VOLCANO_TPU_FASTPATH=0`` runs the
object session: open a session over a snapshot, run the conf's actions
through the plugins' tiered callbacks, close it.  The port's allocate
action hands the solve to ``solve_wave`` or, under ``solver: seq``, to the
sequential ``solve``, with custom plugins' predicate and node-order
callbacks as ``extra_ok`` / ``extra_score`` planes.  After every cycle
both sides must hold the same binds, pipelined tasks, evictions, PodGroup
phases and conditions.
"""

import itertools
import logging
import re

import pytest

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.framework
import volcano_tpu.scheduler
import volcano_tpu.sim
import volcano_tpu.synth
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.framework
import volcano_tpu_torch.scheduler
import volcano_tpu_torch.sim
import volcano_tpu_torch.synth
from volcano_tpu_torch.api import TaskStatus
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

PKGS = (volcano_tpu, volcano_tpu_torch)

TIERS = """tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
{extra}- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""
SEQ = """configurations:
- name: allocate
  arguments:
    solver: seq
"""


def conf(actions="enqueue, allocate, backfill", extra=(), seq=False):
    plugins = "".join(f"  - name: {p}\n" for p in extra)
    return (f'actions: "{actions}"\n' + TIERS.format(extra=plugins)
            + (SEQ if seq else ""))


def _num(name: str) -> int:
    """The last number in a name (its length when it has none)."""
    digits = re.findall(r"\d+", name)
    return int(digits[-1]) if digits else len(name)


class PickyNodes:
    """A custom predicate: vetoes every fourth node with the package's
    FitError, and for tasks of odd gangs raises a plain RuntimeError on
    nodes 7 mod 10 (a buggy plugin: logged once, treated as a veto)."""

    def __init__(self, pkg):
        self.pkg = pkg

    name = "picky-nodes"

    def on_session_open(self, ssn):
        def predicate(task, node):
            n = _num(node.name)
            if n % 4 == 0:
                raise self.pkg.api.FitError(task.name, node.name, "picky")
            if n % 10 == 7 and _num(task.job) % 2:
                raise RuntimeError("picky plugin bug")

        ssn.add_predicate_fn(self.name, predicate)

    def on_session_close(self, ssn):
        pass


class FewNodeScorer:
    """A custom batch scorer: each task scores three nodes (by its gang
    number), the rest score nothing."""

    name = "few-node-scorer"

    def __init__(self, pkg):
        pass

    def on_session_open(self, ssn):
        def batch(task, nodes):
            g = _num(task.job)
            names = [n.name for n in nodes]
            return {names[(7 * g + 3 * k) % len(names)]: 5.0 - 2 * k
                    for k in range(3)}

        ssn.add_batch_node_order_fn(self.name, batch)

    def on_session_close(self, ssn):
        pass


class RowMask:
    """A device-mask plugin: task row i may use node column j unless
    (i + j) % 3 == 0."""

    name = "row-mask"

    def __init__(self, pkg):
        pass

    def on_session_open(self, ssn):
        import numpy as np

        def mask(cluster, pending, node_names):
            i = np.arange(len(pending))[:, None]
            j = np.arange(len(node_names))[None, :]
            return (i + j) % 3 != 0

        ssn.add_device_mask_fn(self.name, mask)

    def on_session_close(self, ssn):
        pass


@pytest.fixture(autouse=True)
def _plugins():
    for pkg in PKGS:
        for cls in (PickyNodes, FewNodeScorer, RowMask):
            pkg.framework.register_plugin_builder(
                cls.name, lambda args, cls=cls, pkg=pkg: cls(pkg))


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _cluster(pkg, n_nodes=24, n_pods=120, gang_size=4, seed=0):
    store = pkg.synth.synthetic_cluster(n_nodes=n_nodes, n_pods=n_pods,
                                        gang_size=gang_size, seed=seed)
    store.pipeline = False
    return store


def _state(store, pipelined):
    return {
        "binds": dict(store.binder.binds),
        "pipelined": pipelined,
        "evictions": list(store.evictor.evicts),
        "phases": {uid: pg.status.phase
                   for uid, pg in sorted(store.pod_groups.items())},
        "conditions": {uid: [(c.type, c.status, c.reason)
                             for c in pg.status.conditions]
                       for uid, pg in sorted(store.pod_groups.items())},
        "releasing": sum(1 for p in store.pods.values() if p.deleting),
    }


def _twin(pkg, make, conf_str, cycles=1, grace=None):
    """Run ``cycles`` cycles on ``make(pkg)``; the state after each.
    Pipelined tasks live in the session only: they are read as it
    closes."""
    _reset_uid_counters()
    store = make(pkg)
    if pkg is volcano_tpu:
        sched = JaxScheduler(store, conf_str=conf_str)
    else:
        sched = PortScheduler(store, conf_str=conf_str, device="cpu")
    sim = None if grace is None else pkg.sim.ClusterSimulator(
        store, grace_steps=grace)
    mod = pkg.scheduler
    close = mod.close_session
    seen = []

    def closing(ssn):
        seen.append(sorted(
            (t.uid, t.node_name) for j in ssn.jobs.values()
            for t in j.task_status_index.get(TaskStatus.Pipelined,
                                             {}).values()))
        close(ssn)

    trace = []
    mod.close_session = closing
    try:
        for _ in range(cycles):
            seen.clear()
            sched.run_once()
            trace.append(_state(store, list(seen)))
            if sim is not None:
                sim.step()
    finally:
        mod.close_session = close
    return trace, store


def _assert_twins(make, conf_str, cycles=1, grace=None):
    want, _ = _twin(volcano_tpu, make, conf_str, cycles, grace)
    got, store = _twin(volcano_tpu_torch, make, conf_str, cycles, grace)
    assert len(want) == len(got)
    for step, (a, b) in enumerate(zip(want, got)):
        for f in a:
            assert a[f] == b[f], (f, step, a[f], b[f])
    return got, store


def _object_record(store):
    rec = store.flight.last()
    assert rec.path == "object", rec.path
    assert rec.error is None
    return rec


CASES = {
    "seq": dict(seq=True),
    "custom wave": dict(extra=("picky-nodes", "few-node-scorer")),
    "custom seq": dict(extra=("picky-nodes", "few-node-scorer"), seq=True),
    "device mask wave": dict(extra=("row-mask",)),
    "device mask seq": dict(extra=("row-mask",), seq=True),
}


@pytest.mark.parametrize("what", sorted(CASES))
def test_object_session_matches_jax(what):
    got, store = _assert_twins(_cluster, conf(**CASES[what]), cycles=2)
    rec = _object_record(store)
    assert {"open", "allocate", "close"} <= set(rec.lanes)
    assert got[0]["binds"]


def test_custom_plugins_steer_the_binds():
    """Every bind of the custom-plugin cycle lands on a node the picky
    predicate allows, and the scorer moves binds against the same conf
    without it."""
    got, _ = _assert_twins(_cluster, conf(extra=("picky-nodes",)))
    assert got[0]["binds"]
    assert all(_num(n) % 4 for n in got[0]["binds"].values())
    scored, _ = _assert_twins(
        _cluster, conf(extra=("picky-nodes", "few-node-scorer")))
    assert scored[0]["binds"] != got[0]["binds"]


def test_unknown_action_is_warned_and_skipped(caplog):
    with caplog.at_level(logging.WARNING):
        got, store = _assert_twins(
            _cluster, conf("enqueue, shuffle, allocate, backfill"))
    assert "Unknown action shuffle" in caplog.text
    assert got[0]["binds"]
    _object_record(store)


def test_fastpath_switched_off_runs_the_object_session(monkeypatch):
    """ROADMAP queue 3's input: synthetic_cluster(32, 200, 4, seed=0),
    the deployed conf, no pipelining, VOLCANO_TPU_FASTPATH=0."""
    monkeypatch.setenv("VOLCANO_TPU_FASTPATH", "0")

    def make(pkg):
        return _cluster(pkg, n_nodes=32, n_pods=200, gang_size=4, seed=0)

    cf = volcano_tpu_torch.framework.DEPLOYED_SCHEDULER_CONF
    want, jstore = _twin(volcano_tpu, make, cf)
    got, store = _twin(volcano_tpu_torch, make, cf)
    assert want == got
    assert len(got[0]["binds"]) == 200
    lanes = (getattr(jstore, "last_cycle_lanes", None) or {},
             store.last_cycle_lanes or {})
    assert set(lanes[0]) == set(lanes[1]) == set()
    _object_record(store)


def test_fastpath_on_keeps_the_fast_path():
    _, store = _assert_twins(
        _cluster, volcano_tpu_torch.framework.DEPLOYED_SCHEDULER_CONF)
    assert store.flight.last().path == "fast"
    assert "encode" in store.last_cycle_lanes


def _tier(pkg):
    store = pkg.cache.ClusterStore(binder=pkg.cache.FakeBinder(),
                                   evictor=pkg.cache.FakeEvictor())
    store.pipeline = False
    pkg.sim.ClusterSimulator.priority_tier_workload(
        store, workers=8, serving_tasks=4)
    return store


def _reclaim(pkg):
    store = pkg.synth.preempt_cluster(n_nodes=16, n_pending=32, gang_size=4)
    store.evictor = pkg.cache.FakeEvictor()
    store.pipeline = False
    return store


def test_object_session_preempt_matches_jax():
    """priority_tier_workload under a custom-plugin conf with preempt:
    the object session's host preempt walk evicts batch pods through
    store.evict and pipelines the serving gang; it binds once they are
    gone."""
    cf = conf("enqueue, allocate, preempt", extra=("few-node-scorer",))
    got, store = _assert_twins(_tier, cf, cycles=6, grace=2)
    assert any(t["evictions"] for t in got)
    assert any(p for t in got for p in t["pipelined"])
    assert sum(k.startswith("default/serving-")
               for k in got[-1]["binds"]) == 4
    _object_record(store)


def test_object_session_reclaim_matches_jax():
    cf = conf("enqueue, allocate, reclaim, backfill",
              extra=("few-node-scorer",))
    got, _ = _assert_twins(_reclaim, cf, cycles=4, grace=1)
    assert any(t["evictions"] for t in got)
    assert any(t["releasing"] for t in got)
