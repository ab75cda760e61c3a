"""The single-phase solve (``VOLCANO_TPU_TWOPHASE=0``): the port against
the JAX package on the CPU.

With the switch off, the JAX ``solve_wave`` runs its reference mode: no
node classes, no shortlists, node-level static planes per wave, every
attempt ranking all N nodes, no fallback rescore.  The port runs the same
(``ops/wave.py``: ``static_planes`` over identity classes, ``aff_live``
and ``rank_candidates`` over all N).  Both modules' ``TOPK`` and the
environment are pinned as ``tests/test_twophase.py:_pin`` pins them, and
the same solve args go through both solves; every ``AllocResult`` field is
compared bit for bit (requests are whole CPUs and GiB, soft weights
integers: every float sum is exact in any order), with the fallback
counters 0.

Cases: ``synthetic_cluster(64, 512)``; ``feature_store`` (taints,
selectors, node affinity) with finite deserved shares; releasing and
pipelined capacity; host ports; ``affinity_store`` with residents and
domain-less nodes; both sparse-shipping thresholds forced in both
packages; custom ``extra_ok`` / ``extra_score`` planes; a ``node_bias``;
a 0-node solve.  Then the port's single-phase solve against its own
two-phase solve at a pinned K < N, the node-level static planes against
the class planes expanded, and cycles: ``Scheduler.run_once()`` twins on
the deployed conf and on the affinity mix, a pipelined cycle against the
synchronous one, a preempt what-if twin, the object session's allocate
action, and the solve's record (``enabled`` false, no host reads, no
resident plane copied to the host).  The JAX results are computed once
per case and shared.
"""

import itertools

import numpy as np
import pytest
import torch

from test_torch_fixtures import (affinity_store, feature_store,
                                 mirror_state, repend_feed, tonp)

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.sim
import volcano_tpu.ops.wave as jw
from volcano_tpu.scheduler import Scheduler as JaxScheduler
from volcano_tpu.synth import solve_args_from_store as jax_args
from volcano_tpu.synth import synthetic_cluster as jax_cluster

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.sim
import volcano_tpu_torch.ops.wave as tw
from volcano_tpu_torch import interop
from volcano_tpu_torch.ops import kernels
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

FIELDS = ("assigned", "pipelined", "never_ready", "fit_failed", "idle",
          "q_alloc", "iters", "fb_exhausted", "fb_affinity")
GI = float(2 ** 30)
K_PIN = 16

CONF_BASE = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""

PREEMPT_CONF = """
actions: "enqueue, allocate, preempt, backfill"
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

# JAX results, one per case name, shared by every test of the module.
_JAX = {}


def _pin(monkeypatch, k=K_PIN, twophase=False):
    """Shortlist length and walk depth pinned to ``k`` in both packages
    (the module TOPK is read at import), the phase mode set for both."""
    monkeypatch.setenv("VOLCANO_TPU_TOPK", str(k))
    monkeypatch.setenv("VOLCANO_TPU_TWOPHASE", "1" if twophase else "0")
    for mod in (jw, tw):
        monkeypatch.setattr(mod, "TOPK", k)


@pytest.fixture
def single(monkeypatch):
    _pin(monkeypatch)
    return monkeypatch


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _assert_equal(jr, tr):
    for f in FIELDS:
        a, b = np.asarray(getattr(jr, f)), np.asarray(getattr(tr, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        assert np.array_equal(a, b), (f, a, b)


def _port(args, wave, *extra, **kw):
    return interop.result_to_numpy(tw.solve_wave(
        *interop.solve_args_from_numpy(tonp(args)), *extra, wave=wave,
        device="cpu", **kw))


def _jax(name, args, wave, *extra, **kw):
    """The JAX single-phase solve of case ``name`` (computed once)."""
    if name not in _JAX:
        _JAX[name] = tonp(jw.solve_wave(*args, *extra, wave=wave, **kw))
        assert jw.LAST_TWOPHASE["enabled"] is False
    return _JAX[name]


def _with_nodes(args, **planes):
    nodes = tonp(args[0])
    return (nodes._replace(**{k: np.asarray(v, np.float32)
                              for k, v in planes.items()}),) + args[1:]


def _with_deserved(args, rows):
    q = args[3]
    des = np.array(q.deserved, np.float32)
    for i, row in enumerate(rows):
        des[i] = row
    return args[:3] + (q._replace(deserved=des),) + args[4:]


def _release(args):
    """Half the nodes' idle turned releasing, a quarter of the rest's
    CPU counted pipelined: tasks pipeline onto the future idle."""
    nodes = tonp(args[0])
    idle = np.array(nodes.idle, np.float32)
    rel = np.zeros_like(idle)
    rel[::2] = idle[::2]
    idle[::2] = 0.0
    pip = np.zeros_like(idle)
    pip[1::4, 0] = 1000.0
    return _with_nodes(args, idle=idle, releasing=rel, pipelined=pip)


def _planes(args, seed, veto=0.3):
    """Per-job [P, N] verdicts and integer scores (many ties)."""
    job = np.asarray(args[1].job)
    N = np.asarray(args[0].idle).shape[0]
    rng = np.random.default_rng(seed)
    uniq, inv = np.unique(job, return_inverse=True)
    ok = rng.random((len(uniq), N)) >= veto
    score = rng.integers(-3, 4, (len(uniq), N)).astype(np.float32)
    return ok[inv], score[inv]


def _aff_args(**kw):
    return jax_args(affinity_store(volcano_tpu, **kw), binpack=True,
                    nodeorder=True)[0]


def _case(name):
    """(args, wave, extra positional args, keyword args, expect) of a
    solve-level case; ``expect`` names the record flag the case must set."""
    if name == "synthetic":
        args, _ = jax_args(jax_cluster(n_nodes=64, n_pods=512, gang_size=4,
                                       n_queues=2, seed=2),
                           binpack=True, nodeorder=True)
        return args, 128, (), {}, None
    if name == "features":
        args, _ = jax_args(feature_store(volcano_tpu, n_nodes=64,
                                         n_pods=512, seed=3))
        args = _with_deserved(args, [[160000.0, 640 * GI],
                                     [120000.0, 480 * GI]])
        return args, 128, (), {}, None
    if name == "releasing":
        args, _ = jax_args(jax_cluster(n_nodes=12, n_pods=256, gang_size=2,
                                       seed=4))
        return _release(args), 64, (), {}, "future"
    if name == "ports":
        return (_aff_args(mix=("plain",), n_nodes=12, n_gangs=12,
                          gang_size=4), 16, (), {}, "ports")
    if name == "affinity":
        return (_aff_args(n_nodes=40, n_gangs=30, gang_size=4, residents=3,
                          seed=1), 32, (), {}, "cnt0_any")
    if name == "affinity_release":
        args = _aff_args(n_nodes=16, n_gangs=30, seed=5)
        return _release(args), 32, (), {}, "future"
    if name == "sparse":
        return (_aff_args(n_nodes=24, n_gangs=20, residents=3, seed=2), 32,
                (), {}, "sparse")
    if name == "extra":
        args, _ = jax_args(jax_cluster(n_nodes=48, n_pods=192, gang_size=4,
                                       n_queues=2, seed=1))
        ok, score = _planes(args, 7)
        return args, 64, (), {"extra_ok": ok, "extra_score": score}, None
    if name == "bias":
        args, _ = jax_args(jax_cluster(n_nodes=48, n_pods=160, gang_size=4,
                                       n_queues=2, seed=1), nodeorder=True)
        N = int(np.asarray(args[0].idle).shape[0])
        rng = np.random.RandomState(1)
        bias = np.where(rng.rand(N) < 0.25, 3.0, 0.0).astype(np.float32)
        return args, 64, (bias,), {}, None
    raise KeyError(name)


CASES = ("synthetic", "features", "releasing", "ports", "affinity",
         "affinity_release", "sparse", "extra", "bias")


@pytest.mark.parametrize("name", CASES)
def test_single_phase_solve_equals_jax(single, name):
    if name == "sparse":
        for mod in (jw, tw):
            single.setattr(mod, "CNT0_SPARSE_MIN", 0)
            single.setattr(mod, "PROF_SPARSE_MIN", 0)
    args, wave, extra, kw, expect = _case(name)
    jr = _jax(name, args, wave, *extra, **kw)
    tr = _port(args, wave, *extra, **kw)
    _assert_equal(jr, tr)
    rec = tw.LAST_TWOPHASE
    assert rec["enabled"] is False and rec["shortlist"] is None
    assert rec["compacted_classes"] is False and rec["devincr"] is None
    assert int(tr.fb_exhausted) == 0 and int(tr.fb_affinity) == 0
    assert int((np.asarray(tr.assigned) >= 0).sum()) > 0
    if expect == "sparse":
        assert tuple(rec["sparse"]) == (True, True)
    elif expect is not None:
        assert rec[expect], expect
    if name == "releasing":
        assert int((np.asarray(tr.pipelined) >= 0).sum()) > 0


@pytest.mark.parametrize("twophase", [False, True])
def test_zero_node_solves_equal_jax(monkeypatch, twophase):
    """A cluster without nodes (the encoder pads not-ready rows) places
    nothing, in either phase mode."""
    _pin(monkeypatch, twophase=twophase)
    args, _ = jax_args(jax_cluster(n_nodes=0, n_pods=16, gang_size=4,
                                   seed=0))
    jr = tonp(jw.solve_wave(*args, wave=8))
    tr = _port(args, 8)
    _assert_equal(jr, tr)
    assert (np.asarray(tr.assigned) == -1).all()
    assert tw.LAST_TWOPHASE["enabled"] is twophase


# tests/test_twophase.py's PARITY_SHAPES.
PARITY_SHAPES = [
    ("cfg2", 12, dict(n_nodes=48, n_pods=160, gang_size=4, n_queues=2,
                      seed=3)),
    ("cfg3", 16, dict(n_nodes=48, n_pods=128, n_queues=4,
                      queue_weights=(1, 2, 4, 8),
                      gang_sizes=(2, 4, 8, 16), seed=5)),
    ("cfg5", 16, dict(n_nodes=32, n_pods=96, gang_size=4, zones=4,
                      affinity_fraction=0.2, anti_affinity_fraction=0.1,
                      spread_fraction=0.2, seed=3)),
]


@pytest.mark.parametrize("name,k,shape", PARITY_SHAPES,
                         ids=[s[0] for s in PARITY_SHAPES])
def test_single_phase_equals_port_two_phase_at_pinned_k(monkeypatch, name,
                                                        k, shape):
    """K << N: the port's two-phase solve binds what its single-phase
    solve binds (test_twophase.py's parity, held on the port)."""
    args, _ = jax_args(jax_cluster(**shape))
    _pin(monkeypatch, k, twophase=False)
    full = _port(args, 64)
    assert tw.LAST_TWOPHASE["enabled"] is False
    _pin(monkeypatch, k, twophase=True)
    two = _port(args, 64)
    assert tw.LAST_TWOPHASE["enabled"] is True
    assert tw.LAST_TWOPHASE["shortlist"][1] == k
    assert tw.LAST_TWOPHASE["n_nodes"] >= 2 * k
    assert np.array_equal(np.asarray(full.assigned),
                          np.asarray(two.assigned))
    assert int((np.asarray(full.assigned) >= 0).sum()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_node_level_static_planes_equal_expanded_class_planes(seed):
    """``static_planes`` over identity classes equals the class planes
    expanded through ``class_id`` (the two-phase planes), custom planes and
    a bias left to the rankings."""
    from volcano_tpu_torch.ops.nodeclass import build_node_classes

    args, _ = jax_args(feature_store(volcano_tpu, n_nodes=48, n_pods=256,
                                     seed=seed))
    targs = interop.solve_args_from_numpy(tonp(args))
    nodes, tasks = targs[0], targs[1]

    def t(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32)
                               if np.asarray(a).dtype.kind in "uib"
                               and np.asarray(a).dtype != bool
                               else np.asarray(a))

    prof = tw.SolveProfiles(*[None] * len(tw.SolveProfiles._fields))
    prof = prof._replace(
        sel_bits=t(tasks.sel_bits), aff_bits=t(tasks.aff_bits),
        aff_terms=t(tasks.aff_terms), tol_bits=t(tasks.tol_bits),
        pref_bits=t(tasks.pref_bits),
        pref_w=torch.as_tensor(np.asarray(tasks.pref_w, np.float32)))
    npl = {f: np.asarray(getattr(nodes, f)) for f in (
        "label_bits", "taint_bits", "ready", "allocatable", "max_tasks")}
    ident = tw._identity_classes(nodes._replace(
        idle=torch.as_tensor(np.asarray(nodes.idle)),
        label_bits=t(npl["label_bits"]), taint_bits=t(npl["taint_bits"]),
        ready=torch.as_tensor(npl["ready"])))
    ok_n, sc_n = kernels.static_planes(prof, ident, 2.0, True)
    cls, _n, _sig = build_node_classes(
        npl["label_bits"], npl["taint_bits"], npl["ready"],
        npl["allocatable"].astype(np.float32),
        npl["max_tasks"].astype(np.int32))
    from volcano_tpu_torch.ops.nodeclass import NodeClasses
    cls_t = NodeClasses(torch.as_tensor(np.asarray(cls.class_id)),
                        t(cls.label_bits), t(cls.taint_bits),
                        torch.as_tensor(np.asarray(cls.ready)))
    ok_c, sc_c = kernels.static_planes(prof, cls_t, 2.0, True)
    cid = cls_t.class_id.long()
    assert torch.equal(ok_n, ok_c[:, cid])
    assert torch.equal(sc_n, sc_c[:, cid])
    assert bool(ok_n.any()) and not bool(ok_n.all())
    assert bool((sc_n != 0).any())


# ------------------------------------------------------------- cycles


def _cycles(pkg, make, conf, cycles, pipe=False, feed=None, sim=False):
    _reset_uid_counters()
    store = make(pkg)
    store.pipeline = pipe
    if pkg is volcano_tpu:
        sched = JaxScheduler(store, conf_str=conf)
    else:
        sched = PortScheduler(store, conf_str=conf, device="cpu")
    if feed is not None:
        store.cycle_feed = feed
    simulator = pkg.sim.ClusterSimulator(store, grace_steps=2) if sim \
        else None
    trace = []
    for _ in range(cycles):
        sched.run_once()
        store.flush_binds()
        rec = store.flight.last()
        trace.append({
            "binds": dict(store.binder.binds),
            "phases": {u: pg.status.phase
                       for u, pg in sorted(store.pod_groups.items())},
            "mirror": mirror_state(store),
            "whatif": rec.whatif,
            "evictions": list(getattr(store.evictor, "evicts", [])),
        })
        if simulator is not None:
            simulator.step()
    store.close()
    return trace


def _synthetic(pkg):
    return pkg.synth.synthetic_cluster(n_nodes=24, n_pods=72, gang_size=4,
                                       seed=13)


def _config5(pkg):
    return pkg.synth.synthetic_cluster(
        n_nodes=48, n_pods=256, gang_size=8, zones=4, affinity_fraction=0.1,
        anti_affinity_fraction=0.1, spread_fraction=0.2, seed=3)


def _tier_store(pkg):
    cache = pkg.cache
    store = cache.ClusterStore(binder=cache.FakeBinder(),
                               evictor=cache.FakeEvictor())
    pkg.sim.ClusterSimulator.priority_tier_workload(
        store, workers=8, serving_tasks=4)
    return store


def _jax_cycles(name, make, conf, cycles, **kw):
    key = f"cycles:{name}"
    if key not in _JAX:
        _JAX[key] = _cycles(volcano_tpu, make, conf, cycles, **kw)
    return _JAX[key]


CYCLE_CASES = {
    "deployed": (_synthetic, None, 4, {"feed": repend_feed([0, 1])}),
    "affinity": (_config5, CONF_BASE, 3, {"feed": repend_feed([0, 1, 2])}),
    "preempt": (_tier_store, PREEMPT_CONF, 6, {"sim": True}),
}


@pytest.mark.parametrize("name", sorted(CYCLE_CASES))
def test_single_phase_cycles_equal_jax(single, name):
    single.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    make, conf, cycles, kw = CYCLE_CASES[name]
    want = _jax_cycles(name, make, conf, cycles, **kw)
    solves = []
    real = tw.solve_wave

    def counted(*a, **k):
        out = real(*a, **k)
        solves.append(dict(tw.LAST_TWOPHASE))
        return out

    single.setattr(tw, "solve_wave", counted)
    got = _cycles(volcano_tpu_torch, make, conf, cycles, **kw)
    for step, (a, b) in enumerate(zip(want, got)):
        for field in a:
            assert a[field] == b[field], (name, field, step)
    assert solves and all(s["enabled"] is False for s in solves)
    assert all(s["host_reads"] == 0 for s in solves)
    assert all(s["devincr"] is None for s in solves)
    assert len(got[-1]["binds"]) > 0
    if name == "preempt":
        assert any(t["evictions"] for t in got)
        assert any(t["whatif"] for t in got)


def test_pipelined_cycles_equal_synchronous(single):
    """A pipelined single-phase run lands the synchronous run's binds one
    cycle later, and the worker's record says single-phase."""
    sync = _cycles(volcano_tpu_torch, _synthetic, None, 1)
    records = []
    real = tw.solve_wave

    def counted(*a, **k):
        out = real(*a, **k)
        records.append(dict(tw._twophase()))
        return out

    single.setattr(tw, "solve_wave", counted)
    pipe = _cycles(volcano_tpu_torch, _synthetic, None, 2, pipe=True)
    assert pipe[0]["binds"] == {}
    assert pipe[1]["binds"] == sync[0]["binds"]
    assert len(sync[0]["binds"]) == 72
    assert records and all(r["enabled"] is False for r in records)


def test_object_session_allocate_equals_jax(single):
    """The object session's allocate action (``solver: wave``, fast path
    off) with the single-phase solve."""
    single.setenv("VOLCANO_TPU_FASTPATH", "0")

    def run(pkg):
        _reset_uid_counters()
        store = _synthetic(pkg)
        sched = (JaxScheduler(store) if pkg is volcano_tpu
                 else PortScheduler(store, device="cpu"))
        sched.run_once()
        store.flush_binds()
        assert store.flight.last().path == "object"
        binds = dict(store.binder.binds)
        store.close()
        return binds

    if "object" not in _JAX:
        _JAX["object"] = run(volcano_tpu)
    want = _JAX["object"]
    got = run(volcano_tpu_torch)
    assert want == got and len(got) == 72
    assert tw.LAST_TWOPHASE["enabled"] is False


def test_solve_never_copies_resident_planes_to_host(single):
    """Single-phase cycles on the device-resident snapshot: no resident
    plane reaches the solve's host-copy helper, no host read is counted,
    and no class table is built."""
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

    single.setattr(tw, "_np", guarded)
    built = []
    real_cls = tw._host_node_classes
    single.setattr(tw, "_host_node_classes",
                   lambda *a: built.append(1) or real_cls(*a))
    _reset_uid_counters()
    store = _synthetic(volcano_tpu_torch)
    stores.append(store)
    sched = PortScheduler(store, device="cpu")
    store.cycle_feed = repend_feed([0, 1])
    reads = []
    for _ in range(3):
        sched.run_once()
        reads.append(tw.LAST_TWOPHASE["host_reads"])
        assert tw.LAST_TWOPHASE["enabled"] is False
    assert store.device_snapshot is not None
    assert reads == [0, 0, 0] and not built
    store.close()
