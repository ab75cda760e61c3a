"""Double-buffered scheduler sessions: the solve worker and the in-flight
handles.

The counterpart of the JAX package's ``pipeline.py``.  The pipelined cycle
dispatches the wave solve of session N without waiting for it; the solve
then runs beside cycle N's close and cycle N+1's derive, and its
assignment is fetched and committed at the top of cycle N+1, after a
staleness guard has checked it against the store mutations that landed
during the overlap (``fastpath.FastCycle._commit_inflight``).

A jax call returns futures, so the JAX package gets the overlap by simply
not reading them.  The port's ``solve_wave`` is a host loop that reads its
loop conditions off the device, so "dispatch without waiting" means a
thread: ``SolveWorker`` owns one thread per store (``vc-solve-dispatch``)
and, on a CUDA store, one ``torch.cuda.Stream``.  The kernel wrappers
launch on torch's current stream, which is per thread, so the worker's
solve runs on its own stream.  On the CPU the same thread runs with no
stream, so the CPU tests exercise the overlap.

What the port does that the JAX package gets for free:

- The worker's stream waits on an event the cycle thread records after
  the solve's inputs were encoded (the device-resident snapshot's planes
  are uploaded and scattered on the cycle thread's stream).
- Every host array of the inputs is copied at dispatch
  (``owned``): an input that is a view of a mirror array would otherwise
  change under the worker when a store event lands during the overlap.
- The job holds every input until its fetch has joined, so the caching
  allocator reuses no block the worker still reads; a writer of a
  resident snapshot plane waits for every pending job first
  (``ops/devsnap.DeviceSnapshot.wait_readers``).
- The job keeps its own ``LAST_TWOPHASE`` record and launch counts
  (``wave.own_twophase``, ``kernels.own_counts``): two threads launch.
- The result comes back as one packed device-to-host copy into pinned
  memory, made by the worker after the solve.

An exception raised in the worker is raised again by ``fetch()`` in the
cycle that reads the result, on the cycle thread: a device crash (a CUDA
out-of-memory error) drops the solve's rows as ``device-crash`` and
degrades the affinity chunk budget there (``fastpath.FastCycle.
_commit_inflight``), anything else propagates.  A fetch whose worker does
not finish within ``FETCH_TIMEOUT_S`` raises instead of hanging.

``InflightSolve`` is the handle the fast path parks on the store
(``store._inflight_solve``) between the two cycles; ``InflightPlan`` the
what-if plan's (``store._inflight_plan``).  Two payload kinds:

- ``"local"``: a ``SolveJob`` on the store's solve worker;
- ``"remote"``: a ``solver_service.PendingSolve`` (or a solver pool's
  ``PoolPendingSolve``): the frame was sent to the solver child and its
  reply is still unread; ``fetch()`` receives and decodes it.

The per-shard slots are not ported (ROADMAP.md, queue 1: the sharded
control plane).

Validity bookkeeping captured at dispatch, as in the JAX package:
``mutation_seq`` (equality at fetch proves nothing moved, so the
re-validation is skipped), ``epoch`` (a node-table change drops rows with
node-sensitive constraints), ``compact_gen`` (a pod-table compaction voids
the whole result), ``dirty_seq`` (the dirty set must agree with
``mutation_seq``) and ``devincr_token`` (the null-delta skip proof the
dispatch anchored).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

# How long a fetch waits for the worker before it raises: 600 s.  A
# north-star solve takes well under a second on the card; this bounds a
# wedged worker, never a healthy one.
FETCH_TIMEOUT_S = 600.0


def owned(tree):
    """``tree`` with every numpy leaf copied (NamedTuples and tuples kept,
    tensors and scalars passed as they are)."""
    if isinstance(tree, np.ndarray):
        return np.array(tree, copy=True)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[owned(x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(owned(x) for x in tree)
    return tree


class SolveJob:
    """One solve handed to the worker: ``fn`` returns the packed int32
    result tensor.  ``keep`` holds the inputs until the job is dropped."""

    __slots__ = ("fn", "keep", "ready", "done", "packed", "copied",
                 "error", "twophase", "launches", "worker")

    def __init__(self, fn, keep, ready, worker):
        self.fn = fn
        self.keep = keep
        self.ready = ready  # CUDA event on the cycle stream, or None
        self.done = threading.Event()
        self.packed: Optional[torch.Tensor] = None
        self.copied = None  # CUDA event after the device-to-host copy
        self.error: Optional[BaseException] = None
        self.twophase: dict = {}
        self.launches: dict = {}
        self.worker = worker

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the worker finished this job; raises TimeoutError
        past ``timeout`` (default ``FETCH_TIMEOUT_S``) and RuntimeError
        when the worker thread is gone with the job unfinished."""
        limit = FETCH_TIMEOUT_S if timeout is None else timeout
        end = time.monotonic() + limit
        while not self.done.wait(max(0.0, min(1.0, end - time.monotonic()))):
            if not self.worker.alive():
                raise RuntimeError(
                    "solve worker died with a solve in flight")
            if time.monotonic() >= end:
                raise TimeoutError(
                    f"in-flight solve not finished after {limit:.0f} s")

    def result(self) -> np.ndarray:
        """Join the job and return its packed result as numpy; re-raises
        the worker's exception."""
        self.wait()
        if self.error is not None:
            raise self.error
        if self.copied is not None:
            self.copied.synchronize()
        return self.packed.numpy()


class SolveWorker:
    """One thread (``vc-solve-dispatch``) running submitted solves in
    order, on its own CUDA stream on a CUDA device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._cv = threading.Condition()
        self._q: collections.deque = collections.deque()
        self._busy = False
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name="vc-solve-dispatch", daemon=True)
        self._thread.start()

    def alive(self) -> bool:
        return self._thread.is_alive()

    def submit(self, fn, keep) -> SolveJob:
        """Queue ``fn``; on the card its stream first waits on an event
        recorded now on the caller's current stream (after the inputs
        were encoded and uploaded)."""
        ready = None
        if self.stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        job = SolveJob(fn, keep, ready, self)
        with self._cv:
            if self._stopped:
                raise RuntimeError("solve worker stopped")
            self._q.append(job)
            self._cv.notify_all()
        return job

    def idle(self, timeout: Optional[float] = None) -> bool:
        """Wait until no job is queued or running; False past
        ``timeout``."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._q and not self._busy, timeout)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=FETCH_TIMEOUT_S)

    def _run(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._q or self._stopped)
                if not self._q:
                    return
                job = self._q.popleft()
                self._busy = True
            try:
                self._run_job(job)
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()
                job.done.set()

    def _run_job(self, job: SolveJob) -> None:
        from .ops import kernels, wave

        try:
            with wave.own_twophase(job.twophase), \
                    kernels.own_counts(job.launches):
                if self.stream is None:
                    job.packed = job.fn()
                    return
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self.stream):
                    self.stream.wait_event(job.ready)
                    packed = job.fn()
                    host = torch.empty(packed.shape, dtype=packed.dtype,
                                       pin_memory=True)
                    host.copy_(packed, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(self.stream)
                    job.packed, job.copied = host, done
        except BaseException as e:  # handed to the fetching cycle
            job.error = e


def solve_worker(store, device) -> SolveWorker:
    """The store's solve worker on ``device``, created on first use; a
    worker on another device is stopped and replaced."""
    device = torch.device(device)
    w = getattr(store, "_solve_worker", None)
    if w is None or w.device != device or not w.alive():
        if w is not None:
            w.stop()
        w = store._solve_worker = SolveWorker(device)
    return w


def _pack(res, fields) -> torch.Tensor:
    return torch.cat([getattr(res, f).reshape(-1).to(torch.int32)
                      for f in fields])


# The result fields one packed copy carries: the allocate solve's five
# (assignment, never-ready and fit-failed flags, the two shortlist-
# fallback counters), a what-if plan's two.
SOLVE_FIELDS = ("assigned", "never_ready", "fit_failed", "fb_exhausted",
                "fb_affinity")
PLAN_FIELDS = ("assigned", "never_ready")


def dispatch_solve(store, device, inputs, fields, snap=None,
                   **kwargs) -> SolveJob:
    """Hand ``solve_wave(*inputs, **kwargs)`` to the store's worker and
    return its job without waiting.  The inputs are owned copies;
    ``snap`` (the device-resident snapshot whose planes the inputs carry)
    registers the job as a reader its writers wait for."""
    from .ops.wave import solve_wave

    inputs = owned(tuple(inputs))
    kwargs = {k: owned(v) for k, v in kwargs.items()}

    def run():
        return _pack(solve_wave(*inputs, device=device, **kwargs), fields)

    job = solve_worker(store, device).submit(run, (inputs, kwargs))
    if snap is not None:
        snap.add_reader(job)
    return job


class InflightSolve:
    """A dispatched-but-uncommitted solve (session N's result, consumed at
    the top of session N+1)."""

    __slots__ = (
        "kind", "payload", "solve_jobs", "task_rows", "req_gather",
        "mutation_seq", "epoch", "compact_gen", "n_nodes", "solve_id",
        "fallbacks", "dirty_seq", "devincr_token", "shard", "shard_seq",
        "twophase", "launches",
    )

    def __init__(self, kind: str, payload: SolveJob, solve_jobs: List[int],
                 task_rows: np.ndarray, req_gather: Tuple,
                 mutation_seq: int, epoch: int, compact_gen: int,
                 n_nodes: int, solve_id: int = 0, dirty_seq: int = 0,
                 devincr_token=None):
        self.kind = kind
        self.payload = payload
        self.solve_jobs = solve_jobs
        self.task_rows = task_rows
        # (elem_rows, slot_idx, values) c_req gather over task_rows,
        # prepared at dispatch so the commit needs no host gather.
        self.req_gather = req_gather
        self.mutation_seq = mutation_seq
        self.epoch = epoch
        self.compact_gen = compact_gen
        self.n_nodes = n_nodes
        # Flow id linking the dispatch span (cycle N) to the fetch and
        # commit spans (cycle N+1); 0 = untracked.
        self.solve_id = solve_id
        # (exhausted, affinity-required) shortlist-fallback counts of the
        # solve, filled by fetch().
        self.fallbacks = (0, 0)
        self.dirty_seq = dirty_seq
        # The null-delta skip proof this dispatch anchored: an abandoned
        # solve voids it (_abandon_one).
        self.devincr_token = devincr_token
        # The per-shard slots are not ported: always None here.
        self.shard = None
        self.shard_seq = None
        # The worker's LAST_TWOPHASE record and launch counts of this
        # solve, filled by fetch().
        self.twophase: dict = {}
        self.launches: dict = {}

    def fetch(self) -> np.ndarray:
        """Join the worker's solve (or read the solver child's reply);
        return the assignment ([P] node row or -1) as numpy.  The fallback
        counters ride the same packed copy (the same reply)."""
        P = len(self.task_rows)
        if self.kind == "remote":
            res = self.payload.fetch()
            if res.fb_exhausted is not None:
                self.fallbacks = (int(res.fb_exhausted),
                                  int(res.fb_affinity))
            return np.asarray(res.assigned)[:P].astype(np.int64)
        job = self.payload
        packed = job.result()
        self.twophase = job.twophase
        self.launches = job.launches
        J = (len(packed) - P - 2) // 2
        self.fallbacks = (int(packed[P + 2 * J]), int(packed[P + 2 * J + 1]))
        return packed[:P].astype(np.int64)

    def abandon(self) -> bool:
        """Drop the pending result without committing it: the solved pods
        are still Pending store-side and re-place on a later cycle.  The
        worker's solve is waited for (bounded), so that nothing it writes
        -- the device-incremental planes -- outlives the handle.  Returns
        whether the solve finished without an error (a remote solve's
        reply is dropped unread: its connection resets its framing, and
        the child's planes are the child's)."""
        if self.kind == "remote":
            return _drop_remote(self, "in-flight remote solve")
        return _wait_dropped(self, "in-flight solve")


def _drop_remote(handle, what: str) -> bool:
    """Abandon ``handle``'s unread remote reply (best effort)."""
    pending, handle.payload = handle.payload, None
    if pending is not None:
        try:
            pending.abandon()
        except Exception:
            log.debug("%s abandon failed", what, exc_info=True)
    return True


def _wait_dropped(handle, what: str) -> bool:
    """Take ``handle``'s job off it and wait for the worker to finish it;
    whether it finished without an error."""
    job, handle.payload = handle.payload, None
    if job is None:
        return True
    try:
        job.wait()
    except Exception:
        log.warning("abandoned %s did not finish", what, exc_info=True)
        return False
    return job.error is None


def take_inflight(store) -> Optional[InflightSolve]:
    """Pop the store's in-flight solve (None when no dispatch is pending).
    The slot is lock-guarded: ``store.close()`` and ``Scheduler.stop()``
    pop it from other threads."""
    with store._lock:
        inflight = store._inflight_solve
        if inflight is not None:
            store._inflight_solve = None
    return inflight


def _abandon_one(store, inflight: InflightSolve) -> None:
    log.info("abandoning in-flight solve of %d task rows",
             len(inflight.task_rows))
    # The abandoned solve's result is lost: void the null-delta skip
    # proof its dispatch anchored, or a restarted scheduler facing an
    # unchanged store would skip forever while the pods stay Pending.
    with store._lock:
        dvc = getattr(store, "_devincr_cache", None)
    if dvc is not None and inflight.devincr_token is not None:
        dvc.skip_token = None
    if not inflight.abandon() and dvc is not None:
        # Its dirty set was anchored at dispatch: a solve that failed left
        # the warm candidates behind it, so the next one re-ranks fully.
        dvc.accumulate_dirty(None)


def abandon_inflight(store) -> bool:
    """Drop the pending dispatch (scheduler shutdown / restart: the solved
    pods stay Pending and re-place on the next cycle).  Returns True when
    one was abandoned."""
    inflight = take_inflight(store)
    if inflight is None:
        return False
    _abandon_one(store, inflight)
    return True


class InflightPlan:
    """A dispatched-but-uncommitted what-if solve (the plan of cycle N --
    rebalance, preempt or reclaim, ``whatif.WhatIfPlan`` -- committed or
    voided at the top of cycle N+1).  A stale plan commits nothing: any
    ``mutation_seq`` / ``epoch`` / ``compact_gen`` / node-count drift voids
    it wholesale (``volcano_whatif_plans_total`` outcome=stale-voided) and
    the planner re-plans against fresh state.  A plan mutates the store
    only at commit."""

    __slots__ = (
        "kind", "payload", "plan", "mutation_seq", "epoch",
        "compact_gen", "n_nodes", "plan_id",
    )

    def __init__(self, payload, plan, mutation_seq: int,
                 epoch: int, compact_gen: int, n_nodes: int,
                 plan_id: int = 0, kind: str = "local"):
        # "local": a SolveJob on the store's worker.  "remote": a
        # solver_pool.PoolPendingSolve, the plan solve offloaded to an
        # idle pool replica, its reply still unread.
        self.kind = kind
        self.payload = payload
        self.plan = plan
        self.mutation_seq = mutation_seq
        self.epoch = epoch
        self.compact_gen = compact_gen
        self.n_nodes = n_nodes
        self.plan_id = plan_id

    def fetch(self):
        """Join the worker's what-if solve (or read the replica's reply);
        (assigned [P], never_ready [J] bool) as numpy."""
        from .whatif import plan_task_order

        if self.kind == "remote":
            res = self.payload.fetch()
            return (np.asarray(res.assigned),
                    np.asarray(res.never_ready).astype(bool))
        packed = self.payload.result()
        P = len(plan_task_order(self.plan)[1])
        return packed[:P], packed[P:].astype(bool)

    def abandon(self) -> bool:
        """Drop the pending plan (nothing was mutated store-side); the
        worker's solve is waited for, bounded, as ``InflightSolve``'s (an
        offloaded plan's reply is dropped unread)."""
        if self.kind == "remote":
            return _drop_remote(self, "in-flight plan")
        return _wait_dropped(self, "what-if plan solve")


def take_inflight_plan(store) -> Optional[InflightPlan]:
    """Pop the store's in-flight what-if plan (None when none is
    pending).  Same locking contract as ``take_inflight``."""
    with store._lock:
        inflight = getattr(store, "_inflight_plan", None)
        if inflight is not None:
            store._inflight_plan = None
    return inflight


def abandon_inflight_plan(store) -> bool:
    """Drop a pending what-if plan, if any (plans mutate nothing until
    committed, so this is free).  Returns True when one was abandoned."""
    inflight = take_inflight_plan(store)
    if inflight is None:
        return False
    log.info("abandoning in-flight what-if plan of %d victims",
             len(inflight.plan.victim_rows))
    inflight.abandon()
    return True
