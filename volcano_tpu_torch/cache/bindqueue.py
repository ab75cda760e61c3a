"""Asynchronous bind dispatch and the rate-limited bind-failure queue.

The counterpart of the JAX package's ``cache/bindqueue.py``.  The reference
dispatches every bind on a goroutine and never waits for it in the
scheduling cycle (``pkg/scheduler/cache/cache.go:536-552``); failed binds
push the task onto a rate-limited ``errTasks`` workqueue whose resync
re-derives the task with exponential backoff (``cache.go:106-107,
627-649``).  This module is that machinery for the fast path:

- ``BindDispatcher`` owns a worker thread (``vc-bind-dispatch``) draining
  batched bind requests to the store's ``Binder``.  The cycle only pays
  the queue append.
- Failures land in the store's failure list, which the scheduler drains at
  the START of the next cycle (every mirror mutation stays on the cycle
  thread); each failure re-enters Pending with an exponential per-task
  backoff (``not_before``) during which the solver does not re-place it.

The JAX dispatcher arms the runtime lock checker (``obs.lockdep.attach``)
before its thread starts; lockdep is not ported (ROADMAP.md, queue 1:
lockdep), so this one does not.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

# The reference's workqueue.DefaultItemBasedRateLimiter starts at 5 ms and
# caps at 1000 s; scheduling periods are ~1 s, so the backoff starts at one
# period instead.
BACKOFF_BASE = 1.0
BACKOFF_MAX = 60.0


class BindDispatcher:
    """Single worker thread draining batched bind requests."""

    def __init__(self, binder,
                 on_failure: Callable[[List[Tuple[str, object]]], None],
                 on_success: Optional[
                     Callable[[List[str], List[str]], None]] = None,
                 materialize: Optional[Callable[[list], tuple]] = None):
        self._binder = binder
        self._on_failure = on_failure
        self._on_success = on_success
        self._materialize = materialize
        self._cv = threading.Condition()
        self._q: List[tuple] = []  # guarded-by: _cv
        self._stopped = False  # guarded-by: _cv
        self._inflight = 0  # guarded-by: _cv
        self._thread = threading.Thread(
            target=self._run, name="vc-bind-dispatch", daemon=True)
        self._thread.start()

    def dispatch(self, keys: Sequence[str], hosts: Sequence[str],
                 pods: Sequence[object],
                 entry: Optional[list] = None) -> None:
        """Deferred batches pass ``entry`` (from the store's
        ``defer_bind_records``); the worker materializes the lists and
        applies the pod.node_name record walk off the cycle."""
        with self._cv:
            self._q.append((keys, hosts, pods, entry))
            self._inflight += 1
            self._cv.notify()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every dispatched batch has been processed; False
        past ``timeout``."""
        deadline = None if timeout is None else time.time() + timeout
        with self._cv:
            while self._inflight > 0:
                remaining = (None if deadline is None
                             else deadline - time.time())
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------- worker

    def _run(self) -> None:
        from .interface import BindFailure

        while True:
            with self._cv:
                while not self._q and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._q:
                    return
                keys, hosts, pods, entry = self._q.pop(0)
            if entry is not None:
                # Deferred record walk: tolist + setattr over the batch
                # runs here, off the cycle (idempotent: a failure path may
                # already have forced it through the store's
                # apply_pending_bind_records).
                keys, hosts, pods = self._materialize(entry)
            failed: List[str] = []
            bind_keys = getattr(self._binder, "bind_keys", None)
            batch_ok = False
            if bind_keys is not None:
                try:
                    bind_keys(list(keys), list(hosts))
                    batch_ok = True
                except BindFailure as bf:
                    failed = list(bf.failed)
                    batch_ok = True
                except Exception:
                    # Indeterminate: some binds may have taken effect.
                    # Failing the whole batch would re-queue pods already
                    # bound and later re-bind them, possibly elsewhere.
                    # Re-drive per key instead: a bind is idempotent (key
                    # -> node), so a key that landed repeats as a no-op
                    # and each key gets a definite outcome.
                    log.exception(
                        "bind batch indeterminate; retrying per key")
            if not batch_ok:
                for pod, host, key in zip(pods, hosts, keys):
                    try:
                        self._binder.bind(pod, host)
                    except BindFailure:
                        failed.append(key)
                    except Exception:
                        log.exception("bind failed for %s", key)
                        failed.append(key)
            if failed:
                try:
                    # Pod objects travel with the keys, so the store's
                    # drain never re-derives key -> pod.
                    by_key = {k: p for k, p in zip(keys, pods)}
                    self._on_failure([(k, by_key.get(k)) for k in failed])
                except Exception:
                    log.exception("bind-failure handler failed")
            if self._on_success is not None:
                if failed:
                    fset = set(failed)
                    ok_pairs = (
                        [k for k in keys if k not in fset],
                        [h for k, h in zip(keys, hosts) if k not in fset],
                    )
                else:
                    ok_pairs = (list(keys), list(hosts))
                try:
                    self._on_success(*ok_pairs)
                except Exception:
                    log.exception("bind-success handler failed")
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()
