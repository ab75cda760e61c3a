"""Scheduler loop: the per-period session loop
(pkg/scheduler/scheduler.go), on the port's fast path.

Every ``schedule_period`` (default 1 s): re-read the conf (hot reload,
scheduler.go:77,89-106), run one fast-path cycle over the store's array
mirror (``fastpath.run_cycle_fast``: enqueue, allocate on the device,
backfill, close).  A conf that fails to parse on a hot reload keeps the
last good conf; with no good conf yet, the error propagates.

The fast path is the only path.  A conf the fast path cannot run (custom
plugins or actions, the sequential solver) raises ``NotImplementedError``
naming the object session's ROADMAP.md item, and a cycle that fails
propagates its error: there is no fallback to an object session.  The
cycle runs on the card unless the scheduler is built with
``device="cpu"``; without a card the default raises.
"""

from __future__ import annotations

import gc
import logging
import threading
import time
from pathlib import Path
from typing import Optional

from .cache.store import not_ported
from .device import resolve_device
from .framework import DEFAULT_SCHEDULER_CONF, parse_scheduler_conf
from .metrics import metrics

log = logging.getLogger(__name__)


class Scheduler:
    def __init__(
        self,
        store,
        conf_path: Optional[str] = None,
        conf_str: Optional[str] = None,
        schedule_period: float = 1.0,
        device=None,
    ):
        self.store = store
        self.conf_path = conf_path
        self.conf_str = conf_str
        self.schedule_period = schedule_period
        self.device = resolve_device(device)
        store.device = self.device
        self._stop = threading.Event()
        self._lifecycle_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._last_conf = None

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
        # Queued bind failures re-enter Pending (with backoff) before the
        # cycle derives (cache.go errTasks resync).
        self.store.drain_bind_failures()
        with metrics.e2e_timer():
            if not run_cycle_fast(self.store, conf, device=self.device):
                raise not_ported(
                    "the object session (custom plugins or actions, or the "
                    "sequential solver), which this scheduler conf needs,",
                    "the object session")

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

    # Full (gen-2) garbage collections run between periods every N cycles.
    GC_FULL_EVERY = 120

    def _loop(self):
        cycles = 0
        while not self._stop.is_set():
            t0 = time.time()
            try:
                self.run_once()
                cycles += 1
                if cycles % self.GC_FULL_EVERY == 0:
                    gc.collect()
            except Exception:
                log.exception("Scheduling cycle failed")
            elapsed = time.time() - t0
            self._stop.wait(max(self.schedule_period - elapsed, 0.0))

    STOP_TIMEOUT = 30.0

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop the periodic loop and join its thread."""
        with self._lifecycle_lock:
            self._stop.set()
            t = self._thread
            if t is not None:
                t.join(self.STOP_TIMEOUT if timeout is None else timeout)
                if t.is_alive():
                    log.error("scheduler loop thread did not exit within "
                              "%.0fs",
                              self.STOP_TIMEOUT if timeout is None
                              else timeout)
                    return
                self._thread = None
