"""Device-crash recovery in the port's fast cycle against the JAX package's.

The twins of ``tests/test_crash_recovery.py`` and of the fetch-time tests
of ``tests/test_pipeline.py``: the same store, the same injection at the
same call index -- the JAX package gets its TPU crash string ("TPU worker
process crashed"), the port a ``torch.cuda.OutOfMemoryError`` (what a card
raises when a solve does not fit).  Binds, the affinity chunk budget's
scale, the ``DeviceCrashRecovered`` events, the
``volcano_device_crash_recoveries_total`` counter, drops by reason and the
journey's ``dropped`` rows must be equal.  A programming error, and a
crash whose probe finds the card gone (a sticky fault), propagate.
"""

import itertools

import pytest
import torch

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.ops.wave as jax_wave
import volcano_tpu.pipeline as jax_pipeline
import volcano_tpu.synth  # noqa: F401
from volcano_tpu.fastpath import FastCycle as JaxFastCycle
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.ops.wave as port_wave
import volcano_tpu_torch.synth  # noqa: F401
from volcano_tpu_torch.fastpath import FastCycle
from volcano_tpu_torch.metrics import metrics as port_metrics
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

JAX_CRASH = "TPU worker process crashed"
PORT_CRASH = "CUDA out of memory. Tried to allocate 2.00 GiB"


def _crash(pkg):
    if pkg is volcano_tpu:
        return RuntimeError(JAX_CRASH)
    return torch.cuda.OutOfMemoryError(PORT_CRASH)


def crashing(real_fn, at, n, make_exc):
    """Wrap a solver: calls ``at`` .. ``at + n - 1`` (1-based) raise
    ``make_exc()``; the others delegate."""
    state = {"calls": 0}

    def fn(*args, **kw):
        state["calls"] += 1
        if at <= state["calls"] < at + n:
            raise make_exc()
        return real_fn(*args, **kw)

    return fn, state


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _sched(pkg, store, conf=None):
    if pkg is volcano_tpu:
        return JaxScheduler(store, conf_str=conf)
    return PortScheduler(store, conf_str=conf, device="cpu")


def _affinity_store(pkg, seed=0):
    _reset_uid_counters()
    return pkg.synth.synthetic_cluster(
        n_nodes=48, n_pods=192, gang_size=4, zones=4,
        affinity_fraction=0.2, anti_affinity_fraction=0.1,
        spread_fraction=0.1, seed=seed)


def _wave(pkg):
    return jax_wave if pkg is volcano_tpu else port_wave


def _crash_counter(pkg):
    met = jax_metrics if pkg is volcano_tpu else port_metrics
    return sum(met.device_crash_recoveries.data.values())


def _events(store):
    return [(e["reason"], e["message"].split("; ")[-1])
            for e in store.events_for("Scheduler/device")]


def _crash_cycle(pkg, monkeypatch, at=1, n=1, make_exc=None, budget=None,
                 cycles=1):
    if budget is not None:
        monkeypatch.setenv("VOLCANO_TPU_AFF_BUDGET_MB", budget)
    store = _affinity_store(pkg)
    wave = _wave(pkg)
    fake, state = crashing(wave.solve_wave, at, n,
                           make_exc or (lambda: _crash(pkg)))
    monkeypatch.setattr(wave, "solve_wave", fake)
    before = _crash_counter(pkg)
    sched = _sched(pkg, store)
    err = None
    try:
        for _ in range(cycles):
            sched.run_once()
    except Exception as e:  # the twins compare what propagated
        err = e
    out = {
        "calls": state["calls"],
        "binds": dict(store.binder.binds),
        "scale": getattr(store, "_aff_budget_scale", 1.0),
        "events": _events(store),
        "recoveries": _crash_counter(pkg) - before,
        "error": None if err is None else type(err).__name__,
    }
    store.close()
    monkeypatch.undo()
    return out, err


def test_cycle_completes_after_injected_crash(monkeypatch):
    want, _ = _crash_cycle(volcano_tpu, monkeypatch)
    got, _ = _crash_cycle(volcano_tpu_torch, monkeypatch)
    assert got == want
    assert got["calls"] >= 2  # crashed once, then resumed
    assert len(got["binds"]) == 192  # the cycle completed degraded
    assert got["scale"] == 0.5
    assert got["events"] == [("DeviceCrashRecovered",
                              "chunk budget now 0.5x")]
    assert got["recoveries"] == 1


def test_repeated_crashes_eventually_propagate(monkeypatch):
    """More than 3 crashes in one cycle give up (the health machinery
    takes over) instead of looping forever."""
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "never")
    want, _ = _crash_cycle(volcano_tpu, monkeypatch, n=99)
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "never")
    got, err = _crash_cycle(volcano_tpu_torch, monkeypatch, n=99)
    assert isinstance(err, torch.OutOfMemoryError)
    assert want["error"] == "RuntimeError"
    for k in ("calls", "binds", "scale", "events", "recoveries"):
        assert got[k] == want[k], k
    assert got["scale"] <= 0.25 and got["recoveries"] == 3


def test_programming_errors_are_not_swallowed(monkeypatch):
    """Only device crashes trigger recovery; a genuine bug propagates at
    once (no silent degradation)."""
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "never")
    bug = lambda: RuntimeError("name 'x' is not defined")  # noqa: E731
    want, _ = _crash_cycle(volcano_tpu, monkeypatch, make_exc=bug)
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "never")
    got, err = _crash_cycle(volcano_tpu_torch, monkeypatch, make_exc=bug)
    assert got == want
    assert "not defined" in str(err)
    assert got["scale"] == 1.0 and got["recoveries"] == 0


def test_chunked_solve_crash_rechunks_equal_jax(monkeypatch):
    """A crash at the second chunk of a chunked solve: the chunks already
    committed stand, the rest re-derive and solve in chunks of half the
    budget -- more of them -- placing as the JAX package does."""
    def run(pkg):
        counts = []
        cyc = JaxFastCycle if pkg is volcano_tpu else FastCycle
        real = cyc._solve_chunks

        def spy(self, *a, **k):
            chunks = list(real(self, *a, **k))
            counts.append(len(chunks))
            return iter(chunks)

        monkeypatch.setattr(cyc, "_solve_chunks", spy)
        out, _ = _crash_cycle(pkg, monkeypatch, at=2, budget="0.008")
        return out, counts

    want, want_counts = run(volcano_tpu)
    got, got_counts = run(volcano_tpu_torch)
    assert got == want and got_counts == want_counts
    # 4 chunks, one committed; the other 3 chunks' work in more chunks.
    assert got_counts[0] == 4 and got_counts[1] > 3
    assert got["scale"] == 0.5 and len(got["binds"]) == 192


def test_budget_scale_recovers_after_clean_cycles(monkeypatch):
    def run(pkg):
        api = pkg.api
        store = _affinity_store(pkg)
        wave = _wave(pkg)
        fake, _ = crashing(wave.solve_wave, 1, 1, lambda: _crash(pkg))
        monkeypatch.setattr(wave, "solve_wave", fake)
        sched = _sched(pkg, store)
        sched.run_once()
        scales = [store._aff_budget_scale]
        # Fresh pending AFFINITY work each cycle: only affinity-bearing
        # solves count toward walking the degraded budget back up.
        for i in range(FastCycle._SCALE_RECOVER_AFTER):
            pg = api.PodGroup(name=f"late-{i}", min_member=1)
            store.add_pod_group(pg)
            store.add_pod(api.Pod(
                name=f"late-{i}-0",
                annotations={api.GROUP_NAME_ANNOTATION: pg.name},
                containers=[{"cpu": "1", "memory": "1Gi"}],
                topology_spread=[("zone", 10)],
            ))
            sched.run_once()
            scales.append(store._aff_budget_scale)
        binds = dict(store.binder.binds)
        store.close()
        monkeypatch.undo()
        return scales, binds

    want = run(volcano_tpu)
    got = run(volcano_tpu_torch)
    assert got == want
    assert got[0][0] == 0.5 and got[0][-1] == 1.0
    assert FastCycle._SCALE_RECOVER_AFTER == JaxFastCycle._SCALE_RECOVER_AFTER
    assert FastCycle._MIN_BUDGET_SCALE == JaxFastCycle._MIN_BUDGET_SCALE


def _launch_error(rc):
    return RuntimeError(f"walk_accept kernel launch failed: CUDA error {rc}")


@pytest.mark.parametrize("exc,crash", [
    (torch.cuda.OutOfMemoryError(PORT_CRASH), True),
    (torch.OutOfMemoryError("out of memory"), True),
    (_launch_error(2), True),  # cudaErrorMemoryAllocation
    (_launch_error(700), True),  # illegal address (sticky)
    (_launch_error(710), True),  # device-side assert (sticky)
    (_launch_error(719), True),  # launch failure (sticky)
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (_launch_error(1), False),  # invalid value
    (_launch_error(9), False),  # invalid configuration
    (_launch_error(98), False),  # invalid device function
    (RuntimeError("name 'x' is not defined"), False),
    (RuntimeError("divide by zero"), False),
    (ValueError("shape mismatch"), False),
    (KeyboardInterrupt("CUDA out of memory"), False),
])
def test_crash_classification(exc, crash):
    assert FastCycle._is_device_crash(exc) is crash


def test_jax_crash_strings_are_not_card_crashes():
    """The TPU runtime's strings mean nothing on the card."""
    assert JaxFastCycle._is_device_crash(RuntimeError(JAX_CRASH))
    assert not FastCycle._is_device_crash(RuntimeError(JAX_CRASH))


def test_failed_probe_raises_the_original_error(monkeypatch):
    """A sticky fault: the crash is classified, the probe finds the card
    gone, and the cycle raises the solve's own error (the health machinery
    takes over)."""
    monkeypatch.setenv("VOLCANO_TPU_FALLBACK", "never")
    probes = []

    def dead(self):
        probes.append(1)
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(FastCycle, "_probe_device", dead)
    store = _affinity_store(volcano_tpu_torch)
    fake, state = crashing(port_wave.solve_wave, 1, 1,
                           lambda: _launch_error(710))
    monkeypatch.setattr(port_wave, "solve_wave", fake)
    try:
        with pytest.raises(RuntimeError, match="CUDA error 710"):
            PortScheduler(store, device="cpu").run_once()
        assert probes == [1] and state["calls"] == 1
        assert store._aff_budget_scale == 0.5
    finally:
        store.close()


def test_probe_on_cpu_store_passes():
    store = _affinity_store(volcano_tpu_torch)
    try:
        sched = PortScheduler(store, device="cpu")
        from volcano_tpu_torch.framework import parse_scheduler_conf
        from volcano_tpu_torch.framework.conf import DEFAULT_SCHEDULER_CONF

        cyc = FastCycle(store, parse_scheduler_conf(DEFAULT_SCHEDULER_CONF),
                        device=sched.device)
        cyc._probe_device()
    finally:
        store.close()


# ------------------------------------------------- the pipelined fetch


def _pipelined_fetch_crash(pkg, monkeypatch, seed=29):
    """Cycle 1 dispatches, cycle 2's fetch of that solve crashes.  The JAX
    package's fetch raises its crash string; the port's worker solve
    raises the out-of-memory error, which crosses to the cycle thread at
    the fetch."""
    _reset_uid_counters()
    store = pkg.synth.synthetic_cluster(n_nodes=8, n_pods=32, gang_size=4,
                                        seed=seed)
    store.pipeline = True
    sched = _sched(pkg, store)
    if pkg is volcano_tpu_torch:
        fake, _ = crashing(port_wave.solve_wave, 1, 1, lambda: _crash(pkg))
        monkeypatch.setattr(port_wave, "solve_wave", fake)
    sched.run_once()
    assert store._inflight_solve is not None
    before = _crash_counter(pkg)
    if pkg is volcano_tpu:
        real_fetch = jax_pipeline.InflightSolve.fetch
        calls = {"n": 0}

        def crash_once(self):
            if calls["n"] == 0:
                calls["n"] += 1
                raise RuntimeError(JAX_CRASH + " mid-solve")
            return real_fetch(self)

        monkeypatch.setattr(jax_pipeline.InflightSolve, "fetch", crash_once)
    sched.run_once()  # the fetch crashes; the rows re-dispatch
    rec = store.flight.last()
    crash_rec = (rec.pods_dropped, dict(rec.drop_reasons))
    scale = store._aff_budget_scale
    dropped = sorted((r["uid"], r.get("detail")) for r in
                     store.journey.trace_rows() if r["kind"] == "dropped")
    sched.run_once()  # the redispatched solve lands
    sched.run_once()
    store.flush_binds()
    with store._lock:
        all_bound = all(p.node_name for p in store.pods.values())
    out = {"crash_record": crash_rec, "scale": scale,
           "events": _events(store), "dropped": dropped,
           "recoveries": _crash_counter(pkg) - before,
           "all_bound": all_bound}
    binds = dict(store.binder.binds)
    store.close()
    monkeypatch.undo()
    return out, binds


def test_fetch_device_crash_degrades_budget_and_replaces(monkeypatch):
    """A crash of the worker's solve surfacing at the pipelined fetch
    routes through the same budget degradation as a synchronous solve:
    its rows drop as device-crash (journey rows too) and re-place."""
    want, want_binds = _pipelined_fetch_crash(volcano_tpu, monkeypatch)
    got, got_binds = _pipelined_fetch_crash(volcano_tpu_torch, monkeypatch)
    assert got == want
    assert got["scale"] == 0.5 and got["recoveries"] == 1
    n, reasons = got["crash_record"]
    assert reasons == {"device-crash": n} and n > 0
    assert len(got["dropped"]) == n
    assert {d for _, d in got["dropped"]} == {"device-crash"}
    assert got["all_bound"]
    assert sorted(got_binds) == sorted(want_binds)


def test_fetch_programming_error_propagates(monkeypatch):
    """A non-crash fetch error is a programming error and propagates, as
    from a synchronous solve."""
    from volcano_tpu_torch import pipeline as pl
    from volcano_tpu_torch.fastpath import run_cycle_fast

    store = volcano_tpu_torch.synth.synthetic_cluster(
        n_nodes=8, n_pods=32, gang_size=4, seed=31)
    try:
        store.pipeline = True
        sched = PortScheduler(store, device="cpu")
        sched.run_once()
        assert store._inflight_solve is not None

        def boom(self):
            raise ValueError("shape mismatch: solver returned garbage")

        monkeypatch.setattr(pl.InflightSolve, "fetch", boom)
        with pytest.raises(ValueError, match="shape mismatch"):
            run_cycle_fast(store, sched._load_conf(), device="cpu")
        assert store._aff_budget_scale == 1.0
    finally:
        store.close()


def test_crash_invalidates_devincr_keeps_devsnap(monkeypatch):
    """After an out-of-memory error the device-incremental caches drop
    (the next solve ranks in full) and the resident snapshot stays."""
    store = volcano_tpu_torch.synth.synthetic_cluster(
        n_nodes=16, n_pods=64, gang_size=4, seed=3)
    try:
        from test_torch_fixtures import repend_feed

        store.cycle_feed = repend_feed([0, 1])
        sched = PortScheduler(store, device="cpu")
        sched.run_once()
        sched.run_once()
        dv = store._devincr_cache
        snap = store.device_snapshot
        assert dv._cand is not None and snap is not None
        full = dv.counts["full"]
        fake, _ = crashing(port_wave.solve_wave, 1, 1,
                           lambda: _crash(volcano_tpu_torch))
        monkeypatch.setattr(port_wave, "solve_wave", fake)
        sched.run_once()
        assert store._aff_budget_scale == 0.5
        assert store.device_snapshot is snap
        assert dv.counts["full"] == full + 1  # re-ranked in full
    finally:
        store.close()
