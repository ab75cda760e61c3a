"""Scheduler loop: the per-period session loop
(pkg/scheduler/scheduler.go).

Every ``schedule_period`` (default 1 s): re-read the conf (hot reload,
scheduler.go:77,89-106) and run one cycle.  A conf the fast path can run
(built-in plugins; enqueue / allocate / backfill / preempt / reclaim /
rebalance; the wave solver) runs on the fast path over the store's array
mirror (``fastpath.run_cycle_fast``).  Anything else -- custom plugins, an
unknown action, ``solver: seq`` -- and every cycle while
``VOLCANO_TPU_FASTPATH=0`` runs the object session (open a session, run the
conf's actions, close it), as the JAX package's ``scheduler.py`` does.  A
conf that fails to parse on a hot reload keeps the last good conf; with no
good conf yet, the error propagates.

A fast-path cycle that raises falls back to the object session for that
cycle, as the JAX package's does (``VOLCANO_TPU_FALLBACK``: ``auto``, the
default, falls back while pending tasks x nodes stays within
``FALLBACK_MAX_WORK`` and re-raises past it; ``always``; ``never``
re-raises).  Before the object session runs, the pipelined solve and
what-if plan still parked are abandoned and the deferred bind records
applied.  The fast cycle recovers from a device crash on its own
(``fastpath.FastCycle._on_device_crash``: a CUDA out-of-memory error
halves the affinity chunk budget and the cycle goes on); what still
raises reaches this fallback.

``VOLCANO_TPU_TRACE_DIR=<dir>`` traces every cycle with ``torch.profiler``
(CPU activities, and CUDA activities on the card) and writes one
Chrome-trace JSON a cycle into that directory, named
``cycle-<pid>-<n>.json`` (``n`` counts the traced cycles of the process
from 1).  The trace is best-effort: a directory that cannot be written or
a profiler that is already running logs a warning, and the cycle goes on.

With ``store.pipeline`` a cycle dispatches its
solve to the store's solve worker and commits it in the next cycle
(``pipeline.py``); ``stop()`` abandons what is still parked.  The cycle
runs on the card unless the scheduler is built with ``device="cpu"``;
without a card the default raises.

The periodic loop (``run()``) honours a leadership gate: with ``gate=`` (a
callable, e.g. ``ha.LeaderElector``'s ``is_leader`` read) it skips every
period in which the gate returns False, as an active/passive standby
does, and skipping clears the failure count.  A failed cycle is logged
and counted; ``healthy()`` turns False after ``UNHEALTHY_AFTER``
consecutive failures, so a supervisor or a standby can take over.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import logging
import os
import threading
import time
from pathlib import Path
from typing import Optional

from . import actions as _actions  # noqa: F401  (registers actions)
from . import plugins as _plugins  # noqa: F401  (registers plugins)
from .device import resolve_device
from .framework import (
    DEFAULT_SCHEDULER_CONF,
    close_session,
    get_action,
    open_session,
    parse_scheduler_conf,
)
from .metrics import metrics

log = logging.getLogger(__name__)

# Cycles traced by _device_trace in this process (names the files).
_TRACES = itertools.count(1)


@contextlib.contextmanager
def _device_trace(device):
    """A ``torch.profiler`` trace of the cycle when
    ``VOLCANO_TPU_TRACE_DIR`` is set (the JAX package's per-cycle device
    trace), written as ``cycle-<pid>-<n>.json`` into that directory; a
    no-op context otherwise.  Best-effort: a failure to start (a profiler
    already running), to stop or to write logs a warning, and the cycle's
    own errors pass through untouched."""
    trace_dir = os.environ.get("VOLCANO_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = None
    try:
        if torch._C._autograd._profiler_enabled():
            # A second profiler would stop the caller's at its exit.
            raise RuntimeError("a profiler is already running")
        os.makedirs(trace_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as err:
        log.warning("device trace unavailable: %s", err)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                path = os.path.join(
                    trace_dir, f"cycle-{os.getpid()}-{next(_TRACES)}.json")
                prof.export_chrome_trace(path)
            except Exception as err:
                log.warning("device trace not written: %s", err)


class Scheduler:
    def __init__(
        self,
        store,
        conf_path: Optional[str] = None,
        conf_str: Optional[str] = None,
        schedule_period: float = 1.0,
        device=None,
        gate=None,
    ):
        self.store = store
        self.conf_path = conf_path
        self.conf_str = conf_str
        self.schedule_period = schedule_period
        self.device = resolve_device(device)
        store.device = self.device
        # Optional leadership gate: the periodic loop skips cycles while
        # it returns False (active/passive HA, see ha.py).
        self.gate = gate
        self._stop = threading.Event()
        # run() / stop() may race from different operator threads; the
        # lifecycle lock keeps two run() calls from both starting loops.
        self._lifecycle_lock = threading.Lock()
        # guarded-by: _lifecycle_lock
        self._thread: Optional[threading.Thread] = None
        self._last_conf = None
        self._consecutive_failures = 0

    # --------------------------------------------------------------- config

    def _load_conf(self):
        conf_str = self.conf_str
        if self.conf_path:
            try:
                conf_str = Path(self.conf_path).read_text()
            except OSError as err:
                log.error("Failed to read scheduler conf %s: %s",
                          self.conf_path, err)
                conf_str = None
        if conf_str is None:
            conf_str = DEFAULT_SCHEDULER_CONF
        try:
            conf = parse_scheduler_conf(conf_str)
        except Exception:
            if self._last_conf is None:
                raise
            log.exception("Failed to parse scheduler conf; keeping last")
            return self._last_conf
        self._last_conf = conf
        return conf

    # ---------------------------------------------------------------- cycle

    def run_once(self) -> None:
        """One scheduling cycle (scheduler.go:71-87).

        The cyclic GC is suspended for the cycle (a generation-2 walk of
        a 100k-pod store's objects costs seconds); a young-generation
        sweep runs after it."""
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            self._run_once_inner()
        finally:
            if gc_was_enabled:
                gc.enable()
                gc.collect(0)

    def _run_once_inner(self) -> None:
        from .fastpath import run_cycle_fast

        conf = self._load_conf()
        action_names = [
            a.strip() for a in conf.actions.split(",") if a.strip()
        ]
        # Queued bind failures re-enter Pending (with backoff) before the
        # cycle derives or snapshots (cache.go errTasks resync).
        self.store.drain_bind_failures()
        with metrics.e2e_timer(), _device_trace(self.device):
            if self._fastpath_enabled():
                try:
                    if run_cycle_fast(self.store, conf, device=self.device):
                        return
                except Exception:
                    if not self._fallback_sensible():
                        # At hyperscale the object session takes hours a
                        # cycle: falling back would stall scheduling while
                        # masking the failure.
                        log.exception(
                            "Fast path failed and the cluster is too large "
                            "for the object-session fallback (override "
                            "with VOLCANO_TPU_FALLBACK=always)")
                        raise
                    log.exception(
                        "Fast path failed; falling back to object session")
            # A pipelined solve or what-if plan must not survive into the
            # object session: its pods read as Pending there and would
            # double-schedule when a later fast cycle committed the stale
            # result.  Abandoning is safe -- the pods re-place here.
            from .pipeline import abandon_inflight, abandon_inflight_plan

            abandon_inflight(self.store)
            abandon_inflight_plan(self.store)
            # The object session reads pod RECORDS as scheduling truth:
            # force the deferred bind-record walks first.
            self.store.apply_pending_bind_records()
            self._run_object_session(conf, action_names)

    def _run_object_session(self, conf, action_names) -> None:
        """One object-session cycle, traced and flight-recorded with
        ``path="object"`` (the fast path records its own cycles)."""
        from .obs.recorder import CycleRecord
        from .obs.trace import tracer_of

        tracer = tracer_of(self.store)
        lanes = {}
        t_wall = time.time()
        t0 = time.perf_counter()
        ssn = None
        err = None
        try:
            with tracer.span("cycle", cat="object"):
                with tracer.span("open", lanes=lanes):
                    ssn = open_session(
                        self.store, conf.tiers, conf.configurations
                    )
                try:
                    for name in action_names:
                        action = get_action(name)
                        if action is None:
                            log.warning("Unknown action %s", name)
                            continue
                        with metrics.action_timer(name), tracer.span(
                                f"action:{name}", cat="action",
                                lanes=lanes, lane=name):
                            action.execute(ssn)
                finally:
                    with tracer.span("close", lanes=lanes):
                        close_session(ssn)
        except BaseException as e:
            err = e
            raise
        finally:
            flight = getattr(self.store, "flight", None)
            if flight is not None:
                flight.record(CycleRecord(
                    session=getattr(ssn, "uid", ""), path="object",
                    t_wall=t_wall,
                    duration_s=time.perf_counter() - t0,
                    lanes=lanes,
                    error=type(err).__name__ if err is not None else None,
                    spans=tracer.drain(),
                ))
            else:
                tracer.drain()

    @staticmethod
    def _fastpath_enabled() -> bool:
        """``VOLCANO_TPU_FASTPATH=0`` runs every cycle on the object
        session."""
        return os.environ.get("VOLCANO_TPU_FASTPATH", "1") != "0"

    # Above this tasks x nodes product the object-session fallback is
    # slower than retrying the fast path next period (the object walk is
    # O(tasks x nodes) Python).
    FALLBACK_MAX_WORK = 50_000_000

    def _fallback_sensible(self) -> bool:
        """Whether a failed fast cycle falls back to the object session
        (``VOLCANO_TPU_FALLBACK``: ``auto`` / ``always`` / ``never``)."""
        import numpy as np

        from .api import TaskStatus

        mode = os.environ.get("VOLCANO_TPU_FALLBACK", "auto")
        if mode == "always":
            return True
        if mode == "never":
            return False
        m = self.store.mirror
        # The object walk is O(pending tasks x nodes): a mostly-scheduled
        # large cluster with a handful of pending pods falls back fine.
        with self.store._lock:
            pending = int(np.count_nonzero(
                (m.p_status[:m.n_pods] == int(TaskStatus.Pending))
                & m.p_alive[:m.n_pods]))
            n_nodes = m.n_nodes
        return pending * max(n_nodes, 1) <= self.FALLBACK_MAX_WORK

    # ----------------------------------------------------------------- loop

    def run(self) -> None:
        """Start the periodic loop in a background thread (no-op when it
        is already running; restartable after ``stop()``)."""
        with self._lifecycle_lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    # Consecutive failed cycles before healthy() reports False (a device
    # runtime that crashed is not recovered in-process; the health signal
    # lets a supervisor or the HA standby take over).
    UNHEALTHY_AFTER = 3

    def healthy(self) -> bool:
        return self._consecutive_failures < self.UNHEALTHY_AFTER

    # Full (gen-2) garbage collections run between periods every N cycles.
    GC_FULL_EVERY = 120

    def _loop(self):
        cycles = 0
        while not self._stop.is_set():
            t0 = time.time()
            try:
                if self.gate is None or self.gate():
                    self.run_once()
                    self._consecutive_failures = 0
                    cycles += 1
                    if cycles % self.GC_FULL_EVERY == 0:
                        gc.collect()
                else:
                    # A standby runs no cycles; failures from its time as
                    # leader must not keep its health check red.
                    self._consecutive_failures = 0
            except Exception:
                self._consecutive_failures += 1
                log.exception("Scheduling cycle failed (%d consecutive)",
                              self._consecutive_failures)
            elapsed = time.time() - t0
            self._stop.wait(max(self.schedule_period - elapsed, 0.0))

    STOP_TIMEOUT = 30.0

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop the periodic loop, join its thread, and abandon the
        pipelined solve and what-if plan left parked between cycles: the
        solved pods are still Pending store-side, so a restarted
        scheduler re-places them on its first cycle."""
        with self._lifecycle_lock:
            self._stop.set()
            t = self._thread
            if t is not None:
                t.join(self.STOP_TIMEOUT if timeout is None else timeout)
                if t.is_alive():
                    log.error("scheduler loop thread did not exit within "
                              "%.0fs; in-flight state NOT drained",
                              self.STOP_TIMEOUT if timeout is None
                              else timeout)
                    return
                self._thread = None
        # Only after the thread is dead: the cycle thread owns the
        # in-flight handles while it runs.
        from .pipeline import abandon_inflight, abandon_inflight_plan

        abandon_inflight(self.store)
        abandon_inflight_plan(self.store)
