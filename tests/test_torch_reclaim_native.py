"""The host reclaim engine of the walk (``csrc/host/vcreclaim.cc``).

The port's reclaim round-robin runs in its own C++ engine, built with
``g++`` on first use (``volcano_tpu_torch/native.py``).  Here:

- the cross-queue scenarios of the JAX package's
  ``tests/test_reclaim_multiqueue.py`` (two and three pending queues, the
  round robin, the unreclaimable queue, the yield-ratio bail) and
  ``tests/test_evict_oracle.py``'s drive-yield seeds, the port against the
  JAX package every cycle (``test_torch_fixtures.walk_run``) and against
  the port's object session;
- the engine against the port's Python walk (``VOLCANO_TPU_NO_NATIVE=1``):
  equal evicted and pipelined uids, binds, phases and mirror states every
  cycle, and the drive engaged (a spy on ``_native_reclaim_drive``) only
  with the engine;
- the engine's first cycle against the JAX package's engine;
- the ctypes declarations against the C prototypes, and the loader: one
  build a source, a failed build raises, and ``VOLCANO_TPU_NO_NATIVE`` is
  read at every call (that it builds the port's own source only is
  ``tests/test_torch_isolation.py``'s).
"""

import re

import pytest

import volcano_tpu
import volcano_tpu.api
import volcano_tpu.cache
import volcano_tpu.fastpath_evict
import volcano_tpu.sim
import volcano_tpu.synth

import volcano_tpu_torch
import volcano_tpu_torch.fastpath_evict as port_fe
import volcano_tpu_torch.sim
import volcano_tpu_torch.synth
from volcano_tpu_torch import native
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

from test_torch_fixtures import (
    EVICT_CONF,
    oversubscribed_store,
    reset_uid_counters,
    scalar_store,
    three_queue_store,
    two_queue_store,
    unreclaimable_store,
    walk_run,
    yield_bail_store,
    yield_path_store,
)


@pytest.fixture(autouse=True)
def _walk(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "0")
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "never")
    for k in ("VOLCANO_TPU_NO_NATIVE", "VOLCANO_TPU_FASTPATH",
              "VOLCANO_TPU_PIPELINE"):
        monkeypatch.delenv(k, raising=False)


class _DriveSpy:
    """Counts ``_native_reclaim_drive`` calls (and those that finished the
    action in C), ``_drive_python_turn`` yields and reclaim actions."""

    def __init__(self, monkeypatch):
        self.drives = self.finished = self.yields = self.reclaims = 0
        E = port_fe.FastEvictor
        drive, turn, reclaim = (E._native_reclaim_drive,
                                E._drive_python_turn, E.reclaim)

        def drive_spy(ev, *a, **k):
            self.drives += 1
            out = drive(ev, *a, **k)
            self.finished += bool(out)
            return out

        def turn_spy(ev, *a, **k):
            self.yields += 1
            return turn(ev, *a, **k)

        def reclaim_spy(ev):
            self.reclaims += 1
            return reclaim(ev)

        monkeypatch.setattr(E, "_native_reclaim_drive", drive_spy)
        monkeypatch.setattr(E, "_drive_python_turn", turn_spy)
        monkeypatch.setattr(E, "reclaim", reclaim_spy)


def _twin(build, **kw):
    want = walk_run(volcano_tpu, build, **kw)
    got = walk_run(volcano_tpu_torch, build, **kw)
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert g[k] == w[k], f"cycle {c}: {k} differs"
    return got


def _port_object_evicts(build, monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_FASTPATH", "0")
    reset_uid_counters()
    store = build(volcano_tpu_torch)
    PortScheduler(store, conf_str=EVICT_CONF, device="cpu").run_once()
    monkeypatch.delenv("VOLCANO_TPU_FASTPATH")
    assert store.flight.last().path == "object"
    return set(store.evictor.evicts)


# ------------------------------------- tests/test_reclaim_multiqueue.py


def test_two_queue_equals_jax_and_object_session(monkeypatch):
    spy = _DriveSpy(monkeypatch)
    got = _twin(two_queue_store, cycles=3)
    assert set(got[0]["evicts"]) == _port_object_evicts(two_queue_store,
                                                        monkeypatch)
    assert got[0]["evicts"]
    assert spy.drives >= 1 and spy.finished == spy.drives


def test_round_robin_serves_both_queues():
    """Six reclaimers over six nodes of two 8-cpu victims: each reclaimer
    is covered by one eviction, and the lower-weight queue is served."""
    got = walk_run(volcano_tpu_torch, two_queue_store)
    assert len(got[0]["evicts"]) == 6
    pipelined = got[0]["pipelined"]
    assert len(pipelined) == 6


def test_drive_engages_on_every_reclaim_action(monkeypatch):
    spy = _DriveSpy(monkeypatch)
    walk_run(volcano_tpu_torch, two_queue_store, cycles=3)
    assert spy.reclaims == 3
    assert spy.drives >= 1 and spy.finished == spy.drives, \
        "the drive fell back to the Python loop"


def test_unreclaimable_queue_protects_its_pods(monkeypatch):
    got = _twin(unreclaimable_store, cycles=2)
    assert not got[-1]["evicts"]
    assert not _port_object_evicts(unreclaimable_store, monkeypatch)


def test_three_pending_queues_equal_jax_and_object_session(monkeypatch):
    got = _twin(three_queue_store, cycles=3)
    assert got[0]["evicts"]
    assert set(got[0]["evicts"]) == _port_object_evicts(three_queue_store,
                                                        monkeypatch)


def test_yield_ratio_bail_equals_jax(monkeypatch):
    """Most reclaimers carry host ports: the drive yields, then bails to
    the Python loop mid-stream with coherent state (rebuilt job heaps,
    frozen overused verdicts)."""
    spy = _DriveSpy(monkeypatch)
    got = _twin(yield_bail_store, cycles=3)
    assert got[0]["evicts"]
    assert spy.drives > spy.finished, "the bail path never fired"
    assert set(got[0]["evicts"]) == _port_object_evicts(yield_bail_store,
                                                        monkeypatch)


# ------------------------------------------- tests/test_evict_oracle.py


@pytest.mark.parametrize("seed", range(4))
def test_drive_yield_path_equals_jax(seed, monkeypatch):
    """Half the reclaimers carry host ports: the drive yields them to a
    Python turn; the port equals the JAX package and its object session."""
    spy = _DriveSpy(monkeypatch)
    build = lambda pkg: yield_path_store(pkg, seed)  # noqa: E731
    got = _twin(build, cycles=2)
    assert set(got[0]["evicts"]) == _port_object_evicts(build, monkeypatch)
    assert spy.yields > 0, "the yield path never ran"


# --------------------------------------------- engine vs Python walk

NATIVE_CASES = {
    "two-queue": two_queue_store,
    "three-queue": three_queue_store,
    "yield-bail": yield_bail_store,
    "preempt-cluster": lambda pkg: pkg.synth.preempt_cluster(
        n_nodes=8, n_pending=12, seed=0),
    **{f"fuzz-{s}": (lambda pkg, s=s: oversubscribed_store(pkg, s))
       for s in range(8)},
    **{f"scalar-{s}": (lambda pkg, s=s: scalar_store(pkg, s))
       for s in range(4)},
    **{f"yield-{s}": (lambda pkg, s=s: yield_path_store(pkg, s))
       for s in range(2)},
}


@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_engine_equals_python_walk(case, monkeypatch):
    spy = _DriveSpy(monkeypatch)
    build = NATIVE_CASES[case]
    py = walk_run(volcano_tpu_torch, build, cycles=3, grace=2,
                  native=False)
    assert spy.drives == 0
    nat = walk_run(volcano_tpu_torch, build, cycles=3, grace=2,
                   native=True)
    assert nat == py
    if any(r["evicted"] for r in nat):
        assert spy.drives >= 1


@pytest.mark.parametrize("case", ["two-queue", "three-queue", "fuzz-0",
                                  "fuzz-3", "yield-0"])
def test_first_cycle_equals_jax_engine(case):
    """On the first cycle (before the JAX replay's missing dirty marks can
    matter) the port's engine equals the JAX package's engine."""
    build = NATIVE_CASES[case]
    want = walk_run(volcano_tpu, build, native=True)
    got = walk_run(volcano_tpu_torch, build, native=True)
    assert got == want


def test_engine_declares_flows_and_journey():
    """The engine's evictions carry the auditor's ``evict`` flow and the
    journey's ``evicted`` event: no conservation mismatch, and the journey
    holds every evicted uid."""
    def obs(store):
        return {"anomalies": dict(store.auditor.anomaly_counts),
                "journey": sorted(r["uid"] for r in
                                  store.journey.trace_rows()
                                  if r["kind"] == "evicted")}

    got = walk_run(volcano_tpu_torch, two_queue_store, cycles=3, grace=2,
                   on_cycle=obs)
    evicted = sorted(u for r in got for u in r["evicted"])
    assert evicted and got[-1]["journey"] == evicted
    assert all(r["anomalies"] == {} for r in got)


# ------------------------------------------------ bindings and loader


def _prototypes():
    """C name -> (return type, [parameter types]) of every declaration in
    the engine's source."""
    src = native.SOURCE.read_text()
    out = {}
    for m in re.finditer(r"^([\w\s\*]+?)\b(vcreclaim_\w+)\(([^)]*)\);",
                         src, re.M):
        params = [p.strip() for p in m.group(3).split(",") if p.strip()]
        out[m.group(2)] = (m.group(1).strip(), params)
    return out


def _ctype(decl: str):
    import ctypes

    decl = decl.replace("const ", "").strip()
    if "*" in decl:
        return ctypes.c_void_p
    base = " ".join(decl.split()[:-1]) if len(decl.split()) > 1 else decl
    return {"long long": ctypes.c_longlong, "void": None}[base]


def test_bindings_match_c_prototypes():
    protos = _prototypes()
    assert set(protos) == set(native.SIGS)
    for name, (restype, argtypes) in native.SIGS.items():
        ret, params = protos[name]
        assert _ctype(ret + " x") is restype or (
            ret == "void" and restype is None), name
        assert [_ctype(p) for p in params] == list(argtypes), name
    # Every prototype is also defined in the same source (the compiler
    # then holds the definition to the declaration).
    src = native.SOURCE.read_text()
    for name in protos:
        assert src.count(f"{name}(") >= 2, name


def test_build_is_keyed_by_the_source(monkeypatch, tmp_path):
    """One compile a source: a second build reuses the library, an edited
    source builds a library of its own."""
    import subprocess

    calls = []
    real = subprocess.run

    def spy(cmd, *a, **k):
        calls.append(cmd)
        return real(cmd, *a, **k)

    src = tmp_path / "vcreclaim.cc"
    src.write_text(native.SOURCE.read_text())
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native.subprocess, "run", spy)
    lib = native.build()
    assert lib.parent == tmp_path / "build" and lib.exists()
    assert native.build() == lib and len(calls) == 1
    src.write_text(src.read_text() + "\n// edited\n")
    other = native.build()
    assert other != lib and other.exists() and len(calls) == 2
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No quiet fallback: a source that does not compile, and a missing
    compiler, both raise."""
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="build failed"):
        native.build()
    good = tmp_path / "good.cc"
    good.write_text("int x;\n")
    monkeypatch.setattr(native, "SOURCE", good)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="build failed"):
        native.build()


def test_no_native_is_read_at_every_call(monkeypatch):
    assert native.reclaim_lib() is not None
    monkeypatch.setenv("VOLCANO_TPU_NO_NATIVE", "1")
    assert native.reclaim_lib() is None
    monkeypatch.delenv("VOLCANO_TPU_NO_NATIVE")
    assert native.reclaim_lib() is native.load()


def test_wide_slot_layout_takes_the_python_walk(monkeypatch):
    """More than 8 resource slots: the whole reclaim action takes the
    Python walk (the engine's scratch holds 8), with the same result."""
    def build(pkg):
        s = two_queue_store(pkg, n_nodes=2, hi_a=1, hi_b=1)
        # Seven extended resources on one extra node: R = 2 + 7.
        s.add_node(pkg.api.Node(name="wide", allocatable={
            "cpu": "1", "memory": "1Gi",
            **{f"ex.dev/r{i}": 1 for i in range(7)}}))
        return s

    spy = _DriveSpy(monkeypatch)
    got = _twin(build, cycles=2)
    assert got[0]["evicts"]
    assert spy.reclaims >= 1 and spy.drives == 0
