"""The fast path's preempt and reclaim over the array mirror.

The counterpart of the JAX package's ``fastpath_evict.py``.  Two lanes use
it:

- the device-native lanes of the what-if engine (``whatif.py``, the
  default) and the rebalance lane commit their evictions through a lean
  ``EvictState`` (``FastCycle._evict_state``): no walk state is built;
- the host victim walk, which ``VOLCANO_TPU_EVICT_DEVICE=0`` selects for
  preempt and reclaim: ``FastEvictor.preempt`` / ``reclaim``, bind for bind
  the object session's ``actions/preempt.py`` / ``actions/reclaim.py``.
  Its ``FastEvictor`` wraps the cycle's ``EvictState`` and adds the walk's
  state to it (``EvictState.for_walk``), so a cycle whose rebalance lane
  evicted before a walk action shares one state.

The walk keeps the reference's control flow at task / victim granularity
(the part that is sequential: evictions change what later preemptors see)
but evaluates the node-level math -- predicates, scores, future-idle
checks -- as [N] numpy expressions over the FastCycle's derived arrays.  It
is host work, as in the JAX package: no device plane is read.

Semantics reproduced from preempt.go:41-262 / reclaim.go:40-189 +
session_plugins.go:110-193 (tiered victim intersection):

- preempt phase 1: per queue, job-ordered preemptors, statement-wrapped;
  commit iff the job reaches Pipelined, else every eviction/pipeline of
  the statement is rolled back (an undo log over the arrays).
- preempt phase 2: intra-job task preemption, committed unconditionally.
- reclaim: queue-ordered round-robin, immediate (unwrapped) evictions,
  victims only from Reclaimable queues.  The round-robin runs in the host
  engine ``csrc/host/vcreclaim.cc`` (``native.py``; ``g++``, built on first
  use), which yields the tasks it cannot handle exactly (host ports,
  inter-pod terms, ghost pods) back to a Python turn;
  ``VOLCANO_TPU_NO_NATIVE=1`` runs the whole action on the Python walk, and
  so do a slot layout wider than 8 and a node with more than
  ``_NATIVE_MAX_CAND`` residents.
- victim sets: tier-by-tier intersection across the enabled plugins
  (priority / gang / conformance / drf for preempt; gang / proportion /
  conformance for reclaim), stopping at the first tier boundary with a
  non-empty set -- including Go's nil-slice quirk (an initialized-empty
  set keeps poisoning later tiers).
- victims are evicted lowest-task-order-first until FutureIdle covers the
  preemptor; the preemptor is pipelined onto the node.

Pipelines are session-scoped (they never reach the store -- the reference
recomputes them each cycle); committed evictions mark the store pods
deleting and dispatch the evictor at cycle end (``EvictState.flush``), as
``cache.Evict`` does.  Evictor failures revert exactly the failed pods to
Running, cancel their ledger entries and stamp the mirror's mutation
counter.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

import heapq

from .api import PodGroupPhase, TaskStatus

log = logging.getLogger(__name__)

F = np.float32

ST_PENDING = int(TaskStatus.Pending)
ST_RUNNING = int(TaskStatus.Running)
ST_RELEASING = int(TaskStatus.Releasing)



class EvictState:
    """Per-cycle eviction state, built on the first eviction of a cycle.

    The device-native and rebalance lanes commit through the lean part
    alone (``req``, future idle, the version stamps, ``evicted_rows``,
    ``flush``).  The host victim walk adds its own state (``for_walk``)
    when ``FastEvictor`` first wraps this state: the resident lists, the
    victim vectors, the pipelines and the init requests."""

    # Lives inside FastCycle.run, under run_cycle_fast's store lock.
    # vclint: class-holds: _lock

    def __init__(self, cyc):
        self.cyc = cyc
        m = cyc.m
        Pn, R = cyc.Pn, cyc.R
        self.req = np.zeros((Pn, R), F)
        self._alive_rows = rows = np.flatnonzero(m.p_alive[:Pn])
        if len(rows):
            er, si, v = m.c_req.gather(rows)
            self.req[rows[er], si] = v
        # The residents as this state first saw them: the walk's victim
        # vectors and critical rows snapshot them here, whenever the walk
        # first runs (allocate flips cyc.resident in place).
        self._resident0 = cyc.resident.copy()
        # Incrementally-maintained FutureIdle = idle + releasing -
        # pipelined (node_info.go:56-58); n_idle is static while the
        # evict actions run, so only the event methods touch this.
        self.fi = cyc.n_idle + cyc.n_releasing
        # Committed evictions (flushed to the store at cycle end).
        self.evicted_rows: List[int] = []
        # Monotonic state version: bumped by every evict/unevict/
        # pipeline/unpipeline; memoized shares key off it.
        self.version = 0
        # Callback (set by FastEvictor) keeping aggregate evictable-
        # capacity caches incremental: on_change(row, sign).
        self.on_change = None
        # Callback (set by FastEvictor) invalidating per-node derived
        # masks: on_node_change(n) after ANY event touching node n's
        # fi / evictable state.
        self.on_node_change = None
        # Per-job mutation stamps (DRF share memoization granularity).
        self.j_version = np.zeros(cyc.Jn, np.int64)
        # Per-queue mutation stamps (queue-share memoization): bumped
        # whenever q_alloc[qi] changes.
        self.q_version = np.zeros(
            cyc.q_alloc.shape[0] if cyc.q_alloc is not None else 0,
            np.int64,
        )
        self.walk = False

    def for_walk(self) -> None:
        """Add the host victim walk's state (once per cycle)."""
        if self.walk:
            return
        self.walk = True
        cyc = self.cyc
        m = cyc.m
        Pn, Nn, R = cyc.Pn, cyc.Nn, cyc.R
        self.init_req = np.zeros((Pn, R), F)
        rows = self._alive_rows
        if len(rows):
            er, si, v = m.c_init_req.gather(rows)
            self.init_req[rows[er], si] = v
        self.req_empty = (m.c_req.lens(np.arange(Pn)) == 0) if Pn else \
            np.zeros(0, bool)
        resident = self._resident0
        # Session-scoped node deltas.
        self.n_pipelined = np.zeros((Nn, R), F)
        self.pipelined_rows: List[int] = []  # rows pipelined this cycle
        self.pipe_node = np.full(Pn, -1, np.int64)
        self.j_waiting = np.zeros(cyc.Jn, np.int64)
        # Critical (conformance-exempt) pods, resident rows only -- read
        # from the mirror's precomputed column instead of a 40k-object
        # walk per session (conformance.go:44-66 semantics encoded at
        # pod add time).
        self.critical = m.p_critical[:Pn] & resident
        # Residents grouped per node, in row order (NodeInfo.tasks
        # iteration order == pod arrival order).
        self.node_rows: List[List[int]] = [[] for _ in range(Nn)]
        node = m.p_node[:Pn]
        for r in np.flatnonzero(resident):
            self.node_rows[node[r]].append(int(r))
        # Victim base vectors (resident, non-empty-request rows): the
        # aggregate evictable caches build from these with numpy masks.
        vr = np.flatnonzero(resident & ~self.req_empty[:Pn])
        self.v_rows = vr
        self.v_node = m.p_node[:Pn][vr].astype(np.int64)
        self.v_job = m.p_job[:Pn][vr].astype(np.int64)
        self.v_qi = np.where(
            self.v_job >= 0, cyc.q_of_job[np.maximum(self.v_job, 0)], -1
        )
        self.v_req = self.req[vr]

    # ------------------------------------------------------------ futures

    def future_idle(self, n: int) -> np.ndarray:
        return self.fi[n]

    # ------------------------------------------------------------- events

    def evict(self, row: int, log_: Optional[list]) -> None:
        """Session-level evict (session.go:334-380): Running -> Releasing;
        node releasing grows; shares shrink."""
        c = self.cyc
        m = c.m
        n = int(m.p_node[row])
        req = self.req[row]
        c._audit_flow(int(m.p_status[row]), ST_RELEASING, "evict")
        c._journey_event(row, "evicted")
        m.p_status[row] = ST_RELEASING
        # Direct mirror status write: the incremental derive's dirty set
        # must see it (the action stamps mutation_seq at its end).
        m.mark_pod_dirty(row)
        c.n_releasing[n] += req
        self.fi[n] += req
        jr = int(m.p_job[row])
        if jr >= 0:
            self.j_version[jr] += 1
            c.j_cnt_alloc[jr] -= 1
            c.j_cnt_run[jr] -= 1
            c.j_cnt_releasing[jr] += 1
            c.j_ready_base[jr] -= 1
            c.j_alloc_res[jr] -= req
            qi = c.q_of_job[jr]
            if qi >= 0:
                c.q_alloc[qi] -= req
                self.q_version[qi] += 1
        self.version += 1
        if self.on_change is not None:
            self.on_change(row, -1)
        if self.on_node_change is not None:
            self.on_node_change(n)
        if log_ is not None:
            log_.append(("evict", row, n, jr))

    def unevict(self, row: int, n: int, jr: int) -> None:
        c = self.cyc
        m = c.m
        req = self.req[row]
        c._audit_flow(int(m.p_status[row]), ST_RUNNING, "evict-revert")
        c._journey_event(row, "evict-reverted")
        m.p_status[row] = ST_RUNNING
        m.mark_pod_dirty(row)
        c.n_releasing[n] -= req
        self.fi[n] -= req
        if jr >= 0:
            self.j_version[jr] += 1
            c.j_cnt_alloc[jr] += 1
            c.j_cnt_run[jr] += 1
            c.j_cnt_releasing[jr] -= 1
            c.j_ready_base[jr] += 1
            c.j_alloc_res[jr] += req
            qi = c.q_of_job[jr]
            if qi >= 0:
                c.q_alloc[qi] += req
                self.q_version[qi] += 1
        self.version += 1
        if self.on_change is not None:
            self.on_change(row, 1)
        if self.on_node_change is not None:
            self.on_node_change(n)

    def pipeline(self, row: int, n: int, log_: Optional[list]) -> None:
        """Session-level pipeline: future capacity claim + share growth
        (session.go:207-249)."""
        c = self.cyc
        m = c.m
        req = self.req[row]
        self.n_pipelined[n] += req
        self.fi[n] -= req
        self.pipe_node[row] = n
        c.n_ntasks[n] += 1
        jr = int(m.p_job[row])
        if jr >= 0:
            self.j_version[jr] += 1
            self.j_waiting[jr] += 1
            c.j_cnt_pending[jr] -= 1
            c.j_alloc_res[jr] += req
            qi = c.q_of_job[jr]
            if qi >= 0:
                c.q_alloc[qi] += req
                self.q_version[qi] += 1
        self.version += 1
        self.pipelined_rows.append(row)
        self.node_rows[n].append(row)
        if self.on_node_change is not None:
            self.on_node_change(n)
        if log_ is not None:
            log_.append(("pipeline", row, n, jr))

    def unpipeline(self, row: int, n: int, jr: int) -> None:
        c = self.cyc
        m = c.m
        req = self.req[row]
        self.n_pipelined[n] -= req
        self.fi[n] += req
        self.pipe_node[row] = -1
        c.n_ntasks[n] -= 1
        if jr >= 0:
            self.j_version[jr] += 1
            self.j_waiting[jr] -= 1
            c.j_cnt_pending[jr] += 1
            c.j_alloc_res[jr] -= req
            qi = c.q_of_job[jr]
            if qi >= 0:
                c.q_alloc[qi] -= req
                self.q_version[qi] += 1
        self.version += 1
        self.pipelined_rows.remove(row)
        try:
            self.node_rows[n].remove(row)
        except ValueError:
            pass
        if self.on_node_change is not None:
            self.on_node_change(n)

    def rollback(self, log_: list) -> None:
        for op in reversed(log_):
            if op[0] == "evict":
                _, row, n, jr = op
                self.unevict(row, n, jr)
            else:
                _, row, n, jr = op
                self.unpipeline(row, n, jr)

    def commit(self, log_: list) -> None:
        for op in log_:
            if op[0] == "evict":
                self.evicted_rows.append(op[1])

    # -------------------------------------------------------- commit/store

    def flush(self) -> None:
        """Apply committed evictions to the store (cache.Evict semantics:
        pod marked deleting, evictor dispatched -- one batch when the
        evictor supports it).  Evictor failures revert exactly the
        failed pods to Running, the cache.go:461-466 resyncTask analog:
        the next preempt/reclaim cycle re-selects a victim set."""
        if not self.evicted_rows:
            return
        c = self.cyc
        m = c.m
        store = c.store
        from .cache.interface import EvictFailure

        evictor = store.evictor
        evict_keys = getattr(evictor, "evict_keys", None)
        # Object-array gathers over the mirror's pod/key columns: the
        # 20k-victim dict-lookup + f-string walk costs ~60 ms at
        # config-4 scale.
        rows_arr = np.asarray(self.evicted_rows, np.int64)
        pod_a, key_a, _ = c._obj_arrays()
        pods_l = pod_a[rows_arr].tolist()
        keys_l = key_a[rows_arr].tolist()
        entries = []  # (row, "ns/name", pod)
        for row, pod, key in zip(self.evicted_rows, pods_l, keys_l):
            if pod is None:
                continue
            pod.deleting = True
            entries.append((row, key, pod))
        failed = set()
        if evict_keys is not None:
            try:
                evict_keys([k for _, k, _ in entries])
            except EvictFailure as ef:
                failed = set(ef.failed)
            except Exception:
                # Transport-level error (connection reset, timeout):
                # indeterminate -- re-drive per key so each gets a
                # definite outcome (evictions are idempotent: deleting
                # an already-terminating pod is a no-op), mirroring the
                # bind dispatcher's indeterminate-batch handling.
                log.exception("evict batch indeterminate; "
                              "retrying per key")
                for row, key, pod in entries:
                    try:
                        evictor.evict(pod)
                    except Exception:
                        failed.add(key)
        else:
            for row, key, pod in entries:
                try:
                    evictor.evict(pod)
                except Exception:
                    failed.add(key)
        events = []
        ledger = getattr(store, "migrations", None)
        for row, key, pod in entries:
            if key in failed:
                # The pod is NOT terminating.  unevict restores the
                # mirror status AND the cycle's job/queue counters so
                # the session-close status write-back matches reality.
                pod.deleting = False
                self.unevict(row, int(m.p_node[row]), int(m.p_job[row]))
                if ledger is not None:
                    # A rebalance victim whose eviction never dispatched
                    # must leave the migration ledger too: a stranded
                    # entry would pin its group's disruption budget and
                    # block every future plan (ledger.active), and the
                    # pod's EVENTUAL normal deletion would wrongly
                    # "restore" (resurrect) it.
                    ledger.cancel(pod.uid)
                events.append((f"Pod/{key}", "EvictFailed",
                               "evict dispatch failed; will retry"))
            else:
                events.append((f"Pod/{key}", "Evict",
                               "evicted by scheduler (preempt/reclaim)"))
                if store._watchers:
                    store._notify("Pod", "evict", pod)
        if failed:
            log.warning("%d evictions failed; pods revert to Running",
                        len(failed))
            # The unevict reverts above flipped p_status AFTER the
            # action loop already stamped the mutation counter: without
            # a fresh stamp the pipelined staleness guard (and the
            # cross-shard commit gate) would judge an in-flight solve
            # against pre-revert state and happily commit onto rows
            # that moved back to Running.  One stamp covers the batch.
            m.mutation_seq += 1
        if ledger is not None:
            # Ledgered victims whose eviction actually dispatched
            # (failed ones were cancelled above): the counters must
            # reflect evictions that happened, not plans that intended
            # them.  Preempt, reclaim and rebalance waves share the
            # ledger; each counts in its own series.
            by_action: Dict[str, int] = {}
            for _row, key, pod in entries:
                if key in failed:
                    continue
                entry = ledger.entries.get(pod.uid)
                if entry is not None:
                    a = entry.action
                    by_action[a] = by_action.get(a, 0) + 1
            if by_action:
                from .metrics import metrics

                n_reb = by_action.pop("rebalance", 0)
                if n_reb:
                    metrics.rebalance_evictions.inc(n_reb)
                for a, n in by_action.items():
                    metrics.preempt_evictions.inc(n, action=a)
        store.record_events_deferred(events)
        store.mark_objects_stale()


class _LazyHeap:
    """Priority queue over live keys without Python comparator callbacks.

    Entries carry the key frozen at push time (heap sifts are then C-level
    tuple compares); pop re-derives the key and re-pushes when it went
    stale, so the element actually returned is ordered by its CURRENT key
    -- at least as fresh as the comparator-driven heap it replaces, whose
    sift decisions also mix pre- and post-mutation views."""

    __slots__ = ("key_fn", "h")

    def __init__(self, key_fn):
        self.key_fn = key_fn
        self.h: list = []

    def push(self, item) -> None:
        heapq.heappush(self.h, (self.key_fn(item), item))

    def pop(self):
        h = self.h
        while True:
            key, item = heapq.heappop(h)
            fresh = self.key_fn(item)
            if fresh == key:
                return item
            heapq.heappush(h, (fresh, item))

    def empty(self) -> bool:
        return not self.h


class FastEvictor:
    """Shared machinery for fast preempt + reclaim over one FastCycle."""

    # Lives inside FastCycle.run, under run_cycle_fast's store lock.
    # vclint: class-holds: _lock

    def __init__(self, cyc, st: EvictState):
        self.cyc = cyc
        st.for_walk()
        self.st = st
        self._score_w = self._collect_score_args()
        self._share_cache: Dict[int, tuple] = {}
        self._qshare_cache: Dict[int, tuple] = {}
        self._profile_scores: Dict[int, np.ndarray] = {}
        self._profile_static: Dict[int, np.ndarray] = {}
        self._evictable: Dict[tuple, np.ndarray] = {}
        self._rq_keys: List[tuple] = []
        self._qorder_has_prop = None
        self._zero_nr: Optional[np.ndarray] = None
        self._total_list = None
        self.st.on_change = self._evictable_update
        # Node-prefilter caches for queue-scoped evict scopes ("pq"/"rq"),
        # maintained per-node on events:
        # evict_key -> [N] bool "node has any in-scope evictable capacity"
        # (evict_key, init_req bytes) -> (init_req, [N] fi+ev fit mask).
        # Preemptors/reclaimers dedupe by request profile, so the O(N)
        # prefilter builds once per (scope, profile) instead of per task.
        # Job-scoped ("job", jr) prefilters are NOT cached (one per job);
        # they get an O(1) j_cnt_run guard instead.
        self._ev_any: Dict[tuple, np.ndarray] = {}
        self._ev_feas: Dict[tuple, tuple] = {}
        # Pod-count predicate column, maintained per-node (n_ntasks only
        # changes via pipeline/unpipeline).
        self._slots_mask: Optional[np.ndarray] = None
        # Nodes whose fi/evictable/ntasks changed since the cached masks
        # were last read; fixups are applied in batch at read time
        # (_apply_dirty) instead of once per event.
        self._dirty: set = set()
        self.st.on_node_change = self._dirty.add
        # Reclaim walk cursors: (evict_key, profile, pred-profile) ->
        # first node index not yet permanently ruled out.  Valid because
        # every prefilter component is monotone False-ward within an
        # evict action (see reclaim()); _apply_dirty rewinds the cursor
        # on the rare False->True flip (cross-queue victim of a
        # reclaiming queue).
        self._walk_cursor: Dict[tuple, int] = {}
        # Tier-ordered plugin-name lists per victim registry (precomputed:
        # the per-victim intersection walks these thousands of times).
        self._tiers_preempt = [
            [o.name for o in t.plugins if o.enabled_preemptable]
            for t in cyc.conf.tiers
        ]
        self._tiers_reclaim = [
            [o.name for o in t.plugins if o.enabled_reclaimable]
            for t in cyc.conf.tiers
        ]
        # Comparator hot-path constants (config is static for the cycle).
        self._job_order_names = [
            o.name for o in cyc._tier_opts("enabled_job_order")
        ]
        self._task_prio_enabled = any(
            o.name == "priority" for o in cyc._tier_opts("enabled_task_order")
        )
        # Per-job pending rows, task-ordered, built in one grouped pass
        # (replaces a full pod-axis scan per job).
        self._job_pending: Dict[int, List[int]] = {}
        c = cyc
        m = c.m
        rows = np.flatnonzero(
            m.p_alive[:c.Pn] & (m.p_status[:c.Pn] == ST_PENDING)
            & ~self.st.req_empty[:c.Pn] & (self.st.pipe_node[:c.Pn] < 0)
        )
        if len(rows):
            prio = (-m.p_prio[rows] if self._task_prio_enabled
                    else np.zeros(len(rows)))
            uids = np.array([m.p_uid[r] for r in rows])
            order = np.lexsort((uids, m.p_create[rows], prio))
            for r in rows[order]:
                self._job_pending.setdefault(
                    int(c.jobr[r]), []
                ).append(int(r))

    # -------------------------------------------------------------- session

    def resync(self) -> None:
        """Re-derive caches of FastCycle state that an allocate/backfill
        action may have mutated since the last evict action: fi snapshots
        n_idle, the slot mask snapshots n_ntasks, the share memos key off
        versions allocate never bumps, and node_rows misses pods the
        allocate action bound."""
        st = self.st
        c = self.cyc
        m = c.m
        st.fi = c.n_idle + c.n_releasing - st.n_pipelined
        self._slots_mask = None
        self._ev_any.clear()
        self._ev_feas.clear()
        self._walk_cursor.clear()
        self._dirty.clear()
        self._share_cache.clear()
        self._qshare_cache.clear()
        if hasattr(self, "_jkey_cache"):
            self._jkey_cache.clear()
        self._reclaim_poss_cache = None
        # Rebuild the per-node resident lists (allocate binds appear as
        # new residents; the host-port predicate walks these).  Session
        # pipelines re-append in pipelined order, as pipeline() did.
        st.node_rows = [[] for _ in range(c.Nn)]
        node = m.p_node[:c.Pn]
        for r in np.flatnonzero(c.resident):
            st.node_rows[node[r]].append(int(r))
        for r in st.pipelined_rows:
            if st.pipe_node[r] >= 0:
                st.node_rows[st.pipe_node[r]].append(int(r))

    def job_pipelined(self, jr: int) -> bool:
        """Gang JobPipelined veto (gang.go: waiting + ready >= min)."""
        c = self.cyc
        if not c._has("gang"):
            return True
        return bool(
            self.st.j_waiting[jr] + c.j_ready_base[jr] >= c.m.j_minav[jr]
        )

    # ------------------------------------------------------------ ordering

    def _job_key(self, jr: int) -> tuple:
        """Live tier-ordered job sort key (shares move during the action,
        so _LazyHeap re-derives this on pop).  Lexicographic order of the
        tuple == the reference's tiered job-order comparator.  Memoized
        per (job, j_version) -- every live input is versioned by the same
        events that bump j_version."""
        cache = getattr(self, "_jkey_cache", None)
        if cache is None:
            cache = self._jkey_cache = {}
        jv = self.st.j_version[jr]
        hit = cache.get(jr)
        if hit is not None and hit[0] == jv:
            return hit[1]
        c = self.cyc
        m = c.m
        parts = []
        for name in self._job_order_names:
            if name == "priority":
                parts.append(-int(m.j_prio[jr]))
            elif name == "gang":
                # Non-ready jobs order first.
                parts.append(
                    1 if c.j_ready_base[jr] >= m.j_minav[jr] else 0
                )
            elif name == "drf":
                parts.append(self._drf_share(jr))
        parts.append(m.j_create[jr])
        parts.append(m.j_uid[jr])
        key = tuple(parts)
        cache[jr] = (jv, key)
        return key

    def _drf_share(self, jr: int) -> float:
        cache = self._share_cache
        hit = cache.get(jr)
        if hit is not None and hit[0] == self.st.j_version[jr]:
            return hit[1]
        c = self.cyc
        totals = self._total_list
        if totals is None:
            totals = self._total_list = [float(t) for t in c.total_res]
        alloc = c.j_alloc_res[jr]
        out = 0.0
        for k, t in enumerate(totals):
            a = float(alloc[k])
            v = a / t if t > 0.0 else (1.0 if a > 0.0 else 0.0)
            if v > out:
                out = v
        cache[jr] = (self.st.j_version[jr], out)
        return out

    def _queue_share(self, qi: int) -> float:
        cache = self._qshare_cache
        hit = cache.get(qi)
        qv = self.st.q_version[qi] if qi < len(self.st.q_version) else -1
        if hit is not None and hit[0] == qv:
            return hit[1]
        c = self.cyc
        des = c.q_deserved_res.get(qi)
        if des is None:
            return 0.0
        alloc = c._res(c.q_alloc[qi])
        s = 0.0
        from .api.resource import share as _share

        for rn in des.resource_names():
            v = _share(alloc.get(rn), des.get(rn))
            if v > s:
                s = v
        self._qshare_cache[qi] = (qv, s)
        return s

    def _queue_key(self, qname: str) -> tuple:
        """Live queue sort key (see _job_key)."""
        c = self.cyc
        has_prop = self._qorder_has_prop
        if has_prop is None:
            has_prop = self._qorder_has_prop = c._has("proportion") and any(
                opt.name == "proportion"
                for opt in c._tier_opts("enabled_queue_order")
            )
        q = c.store.queues[qname]
        if has_prop:
            return (self._queue_share(c.queue_index.get(qname, -1)),
                    q.queue.creation_timestamp, q.uid)
        return (q.queue.creation_timestamp, q.uid)

    def _task_rows_sorted(self, jr: int) -> List[int]:
        """Pending task rows of a job, task-ordered (from the grouped
        index; rows pipelined since init are filtered live)."""
        m = self.cyc.m
        pipe = self.st.pipe_node
        return [
            r for r in self._job_pending.get(jr, ())
            if pipe[r] < 0 and m.p_status[r] == ST_PENDING
        ]

    # ---------------------------------------------------------- predicates

    def feasible_mask(self, row: int) -> np.ndarray:
        """[N] host-predicate feasibility for one pending task
        (predicates.go:144-293 minus resource fit).  Static parts
        (selector / node affinity / taints) are cached per profile;
        pod-count, ports, and inter-pod terms are live."""
        c = self.cyc
        m = c.m
        N = c.Nn
        if not c._has("predicates"):
            return c.n_alive.copy()
        feat = m.p_feat[row]
        pod = c.store.pods.get(m.p_uid[row])
        if pod is None:
            return np.zeros(N, bool)
        pidr = int(m.p_prof[row])
        static = self._profile_static.get(pidr)
        if static is None:
            static = self._static_mask(feat)
            self._profile_static[pidr] = static
        self._apply_dirty()
        slots = self._slots_mask
        if slots is None:
            slots = self._slots_mask = (
                (c.n_maxtasks <= 0) | (c.n_ntasks < c.n_maxtasks)
            )
        ok = static & slots
        # Host ports.
        if feat.ports:
            myports = set(feat.ports)
            for n in range(N):
                if not ok[n]:
                    continue
                for r in self.st.node_rows[n]:
                    f = m.p_feat[r]
                    if f is not None and myports & set(f.ports):
                        ok[n] = False
                        break
        # Inter-pod required affinity (domain-count based, live counts
        # maintained by the allocate/preempt events this cycle are NOT
        # consulted here: matches the host path, which checks resident
        # node.tasks -- evicted residents still count until deleted).
        if feat.ip_req_aff or feat.ip_req_anti:
            ok &= self._interpod_ok(row, feat)
        return ok

    def _static_mask(self, feat) -> np.ndarray:
        c = self.cyc
        m = c.m
        ok = c.n_ready.copy()
        labels_tbl = self._node_labels()
        if feat.sel:
            ok &= self._nodes_with_all(feat.sel, labels_tbl)
        if feat.aff_alts:
            any_alt = np.zeros(c.Nn, bool)
            for alt in feat.aff_alts:
                any_alt |= self._nodes_with_all(alt, labels_tbl)
            ok &= any_alt
        if len(m.taints):
            tol_idx = self._tolerated(feat)
            for k in range(len(m.taints.items)):
                if k not in tol_idx:
                    ok &= ~self._nodes_with_taint(k)
        return ok

    def _node_labels(self):
        cache = getattr(self, "_labels_cache", None)
        if cache is None:
            m = self.cyc.m
            cache = self._labels_cache = [
                (m.node_objs[n].labels if m.node_objs[n] is not None else {})
                for n in range(self.cyc.Nn)
            ]
        return cache

    def _nodes_with_all(self, sel_idx: List[int], labels_tbl) -> np.ndarray:
        m = self.cyc.m
        key = ("sel", tuple(sorted(sel_idx)))
        cache = getattr(self, "_mask_cache", None)
        if cache is None:
            cache = self._mask_cache = {}
        hit = cache.get(key)
        if hit is not None:
            return hit
        pairs = [m.labels.items[i] for i in sel_idx]
        out = np.fromiter(
            (all(lbl.get(k) == v for k, v in pairs) for lbl in labels_tbl),
            bool, count=len(labels_tbl),
        )
        cache[key] = out
        return out

    def _nodes_with_taint(self, k: int) -> np.ndarray:
        cache = getattr(self, "_taint_cache", None)
        if cache is None:
            cache = self._taint_cache = {}
        hit = cache.get(k)
        if hit is not None:
            return hit
        m = self.cyc.m
        tkey, tval, teff = m.taints.items[k]
        out = np.fromiter(
            (
                any(t.key == tkey and t.value == tval and t.effect == teff
                    for t in (m.node_objs[n].taints
                              if m.node_objs[n] is not None else []))
                for n in range(self.cyc.Nn)
            ),
            bool, count=self.cyc.Nn,
        )
        cache[k] = out
        return out

    def _tolerated(self, feat) -> set:
        m = self.cyc.m
        idx = set()
        for k, (tkey, tval, teff) in enumerate(m.taints.items):
            for tol in feat.tol:
                if tol.operator == "Exists":
                    key_ok = tol.key == "" or tol.key == tkey
                else:
                    key_ok = tol.key == tkey and tol.value == tval
                if key_ok and (tol.effect == "" or tol.effect == teff):
                    idx.add(k)
                    break
        return idx

    def _interpod_ok(self, row: int, feat) -> np.ndarray:
        """Required inter-pod (anti)affinity per node for one task, from
        the term membership lists (resident pods incl. Releasing +
        session pipelines, matching the host predicate)."""
        c = self.cyc
        m = c.m
        N = c.Nn
        node_dom = m.node_dom()
        ok = np.ones(N, bool)
        for e in feat.ip_req_aff:
            dom_col = m.topo_keys.index.get(m.term_info[e][1], 0)
            doms = node_dom[:N, dom_col]
            counts = self._term_node_counts(e, row)
            total = counts.sum()
            if total == 0:
                # self-match rule
                jr = int(m.p_job[row])
                juid = m.j_uid[jr] if jr >= 0 else ""
                pod = c.store.pods.get(m.p_uid[row])
                if pod is not None and m._term_matches(
                    e, pod.namespace, pod.labels, juid or ""
                ):
                    continue
                ok &= False
                continue
            ok &= np.where(doms >= 0, counts[np.maximum(doms, 0)] > 0, False)
        for e in feat.ip_req_anti:
            dom_col = m.topo_keys.index.get(m.term_info[e][1], 0)
            doms = node_dom[:N, dom_col]
            counts = self._term_node_counts(e, row)
            ok &= ~np.where(doms >= 0, counts[np.maximum(doms, 0)] > 0,
                            False)
        return ok

    def _term_node_counts(self, e: int, skip_row: int) -> np.ndarray:
        """[D] resident-match counts per domain for term e (incl.
        session pipelines, excl. the task itself)."""
        c = self.cyc
        m = c.m
        D = max(1, len(m.domains))
        counts = np.zeros(D, np.int64)
        node_dom = m.node_dom()
        dom_col = m.topo_keys.index.get(m.term_info[e][1], 0)
        for r in m.term_members[e]:
            if r == skip_row or r >= c.Pn:
                continue
            n = int(m.p_node[r]) if self.st.pipe_node[r] < 0 else \
                int(self.st.pipe_node[r])
            if n < 0:
                continue
            if not (c.resident[r] or self.st.pipe_node[r] >= 0):
                continue
            d = node_dom[n, dom_col]
            if d >= 0:
                counts[d] += 1
        return counts

    # -------------------------------------------------------------- scores

    def _collect_score_args(self):
        from .framework.arguments import Arguments

        c = self.cyc
        out = {"binpack": None, "nodeorder": None}
        for opt in c._tier_opts("enabled_node_order"):
            if opt.name in out and out[opt.name] is None:
                out[opt.name] = Arguments(opt.arguments)
        return out

    def scores(self, row: int) -> np.ndarray:
        """[N] additive node-order score (binpack.go:200-260 +
        nodeorder.go:38-84), vectorized.  Cached per task profile:
        node used/allocatable never change during preempt/reclaim
        (evictions move resources to Releasing, not back to idle)."""
        pidr = int(self.cyc.m.p_prof[row])
        hit = self._profile_scores.get(pidr)
        if hit is not None:
            return hit
        out = self._scores_uncached(row)
        self._profile_scores[pidr] = out
        return out

    def _scores_uncached(self, row: int) -> np.ndarray:
        c = self.cyc
        N = c.Nn
        req = self.st.req[row]
        s = np.zeros(N, F)
        bp = self._score_w.get("binpack")
        if bp is not None:
            weight = max(bp.get_int("binpack.weight", 1), 1)
            w = np.zeros(c.R, F)
            w[0] = max(bp.get_int("binpack.cpu", 1), 0)
            w[1] = max(bp.get_int("binpack.memory", 1), 0)
            for name in (bp.get("binpack.resources") or "").split(","):
                name = name.strip()
                idx = c.m.scalar_slots.index.get(name) if name else None
                if idx is not None:
                    w[2 + idx] = max(
                        bp.get_int(f"binpack.resources.{name}", 1), 0
                    )
            used_f = c.n_used + req[None, :]
            with np.errstate(divide="ignore", invalid="ignore"):
                per = np.where(
                    (req[None, :] > 0) & (c.n_alloc > 0)
                    & (used_f <= c.n_alloc) & (w[None, :] > 0),
                    used_f * w[None, :] / np.where(c.n_alloc > 0,
                                                   c.n_alloc, 1.0),
                    0.0,
                )
            # weight_sum counts weights of requested-and-known resources.
            wsum = float(w[req > 0].sum())
            if wsum > 0:
                s += per.sum(axis=1) / wsum * 10.0 * weight
        no = self._score_w.get("nodeorder")
        if no is not None:
            least = no.get_int("leastrequested.weight", 1)
            most = no.get_int("mostrequested.weight", 0)
            balanced = no.get_int("balancedresource.weight", 1)
            cap_cpu = c.n_alloc[:, 0]
            cap_mem = c.n_alloc[:, 1]
            req_cpu = c.n_used[:, 0] + req[0]
            req_mem = c.n_used[:, 1] + req[1]
            with np.errstate(divide="ignore", invalid="ignore"):
                if least:
                    pc = np.where(cap_cpu > 0,
                                  np.maximum(cap_cpu - req_cpu, 0)
                                  * 10.0 / np.where(cap_cpu > 0, cap_cpu, 1),
                                  0.0)
                    pm = np.where(cap_mem > 0,
                                  np.maximum(cap_mem - req_mem, 0)
                                  * 10.0 / np.where(cap_mem > 0, cap_mem, 1),
                                  0.0)
                    s += (pc + pm) / 2.0 * least
                if most:
                    pc = np.where((cap_cpu > 0) & (req_cpu <= cap_cpu),
                                  req_cpu * 10.0
                                  / np.where(cap_cpu > 0, cap_cpu, 1), 0.0)
                    pm = np.where((cap_mem > 0) & (req_mem <= cap_mem),
                                  req_mem * 10.0
                                  / np.where(cap_mem > 0, cap_mem, 1), 0.0)
                    s += (pc + pm) / 2.0 * most
                if balanced:
                    cf = np.where(cap_cpu > 0, req_cpu
                                  / np.where(cap_cpu > 0, cap_cpu, 1), 1.0)
                    mf = np.where(cap_mem > 0, req_mem
                                  / np.where(cap_mem > 0, cap_mem, 1), 1.0)
                    bal = np.where((cf > 1.0) | (mf > 1.0), 0.0,
                                   (1.0 - np.abs(cf - mf)) * 10.0)
                    s += bal * balanced
        return s

    # ----------------------------------------------- evictable prefilter

    def _le_rows(self, l: np.ndarray, a: np.ndarray,
                 b: Optional[np.ndarray] = None) -> np.ndarray:
        """Row-wise epsilon Resource.less_equal: l [R] vs a(+b) [N, R].

        (l < r) | (|l - r| < eps) is equivalent to r > l - eps, and
        scalar slots with l <= eps pass unconditionally, so only the
        remaining columns need the comparison.  The per-column loop
        (R is 2-4) avoids materializing any [N, R] temporary -- this
        runs once per preemptor task over 10k+ nodes."""
        c = self.cyc
        cols = np.flatnonzero(~(c.scalar_slot & (l <= c.eps)))
        out = np.ones(a.shape[0], bool)
        thresh = l - c.eps
        for k in cols:
            col = a[:, k] if b is None else a[:, k] + b[:, k]
            out &= col > thresh[k]
        return out

    def _vjob_group(self, jr: int) -> np.ndarray:
        """Indices into the victim base vectors for one job (grouped once;
        a per-job O(#victims) mask scan repeated for thousands of jobs in
        preempt phase 2 dominated the action otherwise)."""
        groups = getattr(self, "_vjob_groups", None)
        if groups is None:
            st = self.st
            groups = self._vjob_groups = {}
            order = np.argsort(st.v_job, kind="stable")
            uniq, starts = np.unique(st.v_job[order], return_index=True)
            bounds = list(starts) + [len(order)]
            for i, j in enumerate(uniq):
                groups[int(j)] = order[bounds[i]:bounds[i + 1]]
        return groups.get(jr, np.empty(0, np.int64))

    def _evictable_for(self, key: tuple) -> np.ndarray:
        arr = self._evictable.get(key)
        if arr is not None:
            return arr
        c = self.cyc
        m = c.m
        st = self.st
        kind = key[0]
        if kind == "job":
            sel = self._vjob_group(int(key[1]))
            if len(sel):
                sel = sel[m.p_status[:c.Pn][st.v_rows[sel]] == ST_RUNNING]
        else:
            mask = (m.p_status[:c.Pn][st.v_rows] == ST_RUNNING) \
                & (st.v_job >= 0)
            if kind == "pq":
                qi = c.queue_index.get(key[1], -1)
                mask &= st.v_qi == qi
            elif kind == "rq":
                qi = c.queue_index.get(key[1], -1)
                reclaimable = np.zeros(c.Qn + 1, bool)
                for name, i in c.queue_index.items():
                    q = c.store.queues.get(name)
                    reclaimable[i] = bool(q is not None and q.reclaimable())
                mask &= (st.v_qi != qi) & (st.v_qi >= 0) \
                    & reclaimable[np.maximum(st.v_qi, 0)]
            sel = np.flatnonzero(mask)
        if not len(sel):
            # Copy-on-write zero: thousands of "job" keys (one per
            # under-request job in preempt phase 2) have no Running
            # victims at all; share one read-only zero array for them.
            arr = self._zero_nr
            if arr is None:
                arr = np.zeros((c.Nn, c.R), F)
                arr.flags.writeable = False
                self._zero_nr = arr
        else:
            arr = np.zeros((c.Nn, c.R), F)
            np.add.at(arr, st.v_node[sel], st.v_req[sel])
        self._evictable[key] = arr
        if kind == "rq":
            self._rq_keys.append(key)
        return arr

    def _apply_dirty(self) -> None:
        """Apply queued per-node fixups to every cached prefilter mask
        (O(#dirty x #cached entries); dirty is typically 1-2 nodes).
        A False->True flip rewinds affected walk cursors."""
        dirty = self._dirty
        if not dirty:
            return
        c = self.cyc
        st = self.st
        ev = self._evictable
        slots = self._slots_mask
        for n in dirty:
            if slots is not None:
                slots[n] = (
                    c.n_maxtasks[n] <= 0
                    or c.n_ntasks[n] < c.n_maxtasks[n]
                )
            for key, anym in self._ev_any.items():
                arr = ev.get(key)
                new = bool((arr[n] > 1e-6).any()) if arr is not None \
                    else False
                if new and not anym[n]:
                    self._rewind_cursors(key, n)
                anym[n] = new
            if self._ev_feas:
                fi_n = st.fi[n]
                for (key, _), (init_req, mask) in self._ev_feas.items():
                    arr = ev.get(key)
                    tot = fi_n + arr[n] if arr is not None else fi_n
                    ok = (init_req < tot) \
                        | (np.abs(init_req - tot) < c.eps) \
                        | (c.scalar_slot & (init_req <= c.eps))
                    new = bool(ok.all())
                    if new and not mask[n]:
                        self._rewind_cursors(key, n)
                    mask[n] = new
        dirty.clear()

    def _rewind_cursors(self, evict_key: tuple, n: int) -> None:
        for wkey, cur in self._walk_cursor.items():
            if wkey[0] == evict_key and cur > n:
                self._walk_cursor[wkey] = n

    def _prefilter(self, evict_key: tuple, init_req: np.ndarray,
                   ev: np.ndarray) -> np.ndarray:
        """[N] cached necessary-condition mask for a queue-scoped evict
        scope: node has in-scope victims AND fi + evictable covers the
        request.  Built once per (scope, request-profile); per-node
        fixups applied lazily (_apply_dirty)."""
        self._apply_dirty()
        anym = self._ev_any.get(evict_key)
        if anym is None:
            anym = self._ev_any[evict_key] = (ev > 1e-6).any(axis=1)
        fkey = (evict_key, init_req.tobytes())
        ent = self._ev_feas.get(fkey)
        if ent is None:
            ent = (init_req.copy(),
                   self._le_rows(init_req, self.st.fi, ev))
            self._ev_feas[fkey] = ent
        return anym & ent[1]

    def _evictable_update(self, row: int, sign: int) -> None:
        """Direct-addressed cache update: a Running victim row counts
        toward at most its own ("pq", queue) key (an upper bound -- own-job
        and higher-priority victims stay included; the exact walk filters
        them, so one cache serves every preemptor of the queue), its own
        ("job", job) key, and the "rq" keys of OTHER queues when the
        victim's queue is reclaimable -- O(1 + #rq keys) instead of a scan
        over every cached key.  Gang caps and conformance are checked
        exactly downstream."""
        c = self.cyc
        m = c.m
        jr = int(m.p_job[row])
        if jr < 0:
            return
        n = int(m.p_node[row])
        req = self.st.req[row]
        ev = self._evictable
        jq = m.j_queue[jr]
        sreq = sign * req
        for key in (("pq", jq), ("job", jr)):
            arr = ev.get(key)
            if arr is not None:
                if arr is self._zero_nr:  # copy-on-write
                    arr = ev[key] = np.zeros((c.Nn, c.R), F)
                arr[n] += sreq
        if self._rq_keys:
            vq = c.store.queues.get(jq)
            if vq is not None and vq.reclaimable():
                for key in self._rq_keys:
                    if key[1] != jq:
                        arr = ev[key]
                        if arr is self._zero_nr:
                            arr = ev[key] = np.zeros((c.Nn, c.R), F)
                        arr[n] += sreq

    # -------------------------------------------------------------- victims

    def _victims(self, preemptor_row: int, cand: List[int],
                 registry: str) -> List[int]:
        """Tiered victim intersection (session_plugins.go:110-193)."""
        c = self.cyc
        victims: List[int] = []
        init = False
        tiers = (self._tiers_preempt if registry == "preempt"
                 else self._tiers_reclaim)
        for tier in tiers:
            for pname in tier:
                sel = self._plugin_victims(pname, preemptor_row, cand,
                                           registry)
                if sel is None:
                    continue
                if not init:
                    victims = list(sel)
                    init = True
                else:
                    keep = set(sel)
                    victims = [v for v in victims if v in keep]
            if victims:
                return victims
            if init:
                return victims
        return victims

    def _plugin_victims(self, name: str, prow: int, cand: List[int],
                        registry: str) -> Optional[List[int]]:
        c = self.cyc
        m = c.m
        st = self.st
        if name == "priority" and registry == "preempt":
            pj = int(m.p_job[prow])
            ppri = m.j_prio[pj] if pj >= 0 else 0
            return [r for r in cand
                    if m.j_prio[max(int(m.p_job[r]), 0)] < ppri
                    and int(m.p_job[r]) >= 0]
        if name == "gang":
            occupied: Dict[int, int] = {}
            out = []
            for r in cand:
                jr = int(m.p_job[r])
                if jr < 0:
                    continue
                cnt = occupied.get(jr)
                if cnt is None:
                    cnt = int(c.j_ready_base[jr])
                min_av = int(m.j_minav[jr])
                if min_av <= cnt - 1 or min_av == 1:
                    occupied[jr] = cnt - 1
                    out.append(r)
                else:
                    occupied[jr] = cnt
            return out
        if name == "conformance":
            return [r for r in cand if not st.critical[r]]
        if name == "drf" and registry == "preempt":
            pj = int(m.p_job[prow])
            total = c.total_res
            l_alloc = c.j_alloc_res[pj] + st.req[prow]
            ls = self._share_of(l_alloc, total)
            allocations: Dict[int, np.ndarray] = {}
            out = []
            for r in cand:
                jr = int(m.p_job[r])
                if jr not in allocations:
                    allocations[jr] = c.j_alloc_res[jr].copy()
                allocations[jr] = allocations[jr] - st.req[r]
                rs = self._share_of(allocations[jr], total)
                if ls < rs or abs(ls - rs) <= 1e-6:
                    out.append(r)
            return out
        if name == "proportion" and registry == "reclaim":
            from .api.resource import Resource

            allocations: Dict[int, object] = {}
            out = []
            for r in cand:
                jr = int(m.p_job[r])
                qi = int(c.q_of_job[jr]) if jr >= 0 else -1
                if qi < 0:
                    continue
                des = c.q_deserved_res.get(qi)
                if des is None:
                    continue
                if qi not in allocations:
                    allocations[qi] = c._res(c.q_alloc[qi])
                allocated = allocations[qi]
                victim_req = c._res(st.req[r])
                if allocated.less(victim_req):
                    continue
                allocated.sub(victim_req)
                if des.less_equal_strict(allocated):
                    out.append(r)
            return out
        return None

    @staticmethod
    def _share_of(alloc: np.ndarray, total: np.ndarray) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(total > 0, alloc / np.where(total > 0, total, 1),
                             np.where(alloc > 0, 1.0, 0.0))
        return float(ratio.max()) if len(ratio) else 0.0

    # ------------------------------------------------------------- preempt

    def _try_preempt(self, prow: int, cand_filter, stmt: Optional[list],
                     evict_key: tuple) -> bool:
        """One preemptor against all nodes (preempt.go:183-262)."""
        c = self.cyc
        m = c.m
        st = self.st
        eps = c.eps
        scalar = c.scalar_slot
        from .fastpath import _vec_le

        init_req = st.init_req[prow]
        # Necessary-condition prefilter first (cheaper than the full
        # predicate mask): the node must HOLD in-scope victims (an empty
        # candidate list just `continue`s below) and its future idle
        # plus ALL its in-scope victims' resources must cover the
        # preemptor -- otherwise the exact walk cannot succeed there.
        if evict_key[0] == "job":
            # Intra-job scope: no running members -> no victims anywhere
            # (O(1), avoids scoring nodes for hopeless preemptors).
            if c.j_cnt_run[int(evict_key[1])] <= 0:
                return False
            ev = self._evictable_for(evict_key)
            feasible = (ev > 1e-6).any(axis=1) \
                & self._le_rows(init_req, st.fi, ev) & c.n_alive
        else:
            ev = self._evictable_for(evict_key)
            feasible = self._prefilter(evict_key, init_req, ev) \
                & c.n_alive
        if not feasible.any():
            return False
        feasible &= self.feasible_mask(prow)
        rows_f = np.flatnonzero(feasible)
        if not len(rows_f):
            return False
        sc = self.scores(prow)[rows_f]
        order = rows_f[np.argsort(-sc, kind="stable")]
        for n in order:
            cand = [r for r in st.node_rows[n]
                    if m.p_status[r] == ST_RUNNING
                    and not st.req_empty[r] and cand_filter(r)]
            if not cand:
                continue
            victims = self._victims(prow, cand, "preempt")
            if not victims:
                continue
            # validate_victims: victims' resources must suffice.
            fut = st.future_idle(n)
            vsum = st.req[victims].sum(axis=0)
            if not _vec_le(init_req, fut + vsum, eps, scalar):
                continue
            # Evict lowest task order first: inverse of task_order.
            prio_enabled = self._task_prio_enabled
            vp = [(-int(m.p_prio[r]) if prio_enabled else 0,
                   m.p_create[r], m.p_uid[r], r) for r in victims]
            vp.sort(reverse=True)  # lowest order popped first
            for _pk, _ck, _uk, r in vp:
                if _vec_le(init_req, st.future_idle(n), eps, scalar):
                    break
                st.evict(r, stmt)
            if _vec_le(init_req, st.future_idle(n), eps, scalar):
                st.pipeline(prow, int(n), stmt)
                return True
        return False

    def preempt(self) -> None:
        """preempt.go:41-177."""
        c = self.cyc
        m = c.m
        st = self.st
        preemptors_map: Dict[str, _LazyHeap] = {}
        tasks_map: Dict[int, List[int]] = {}
        under_request: List[int] = []
        queue_seq: List[str] = []
        seen_q = set()
        for jr in self._schedulable_jobs():
            qname = m.j_queue[jr]
            if qname not in seen_q:
                seen_q.add(qname)
                queue_seq.append(qname)
            pending = self._task_rows_sorted(jr)
            if pending and not self.job_pipelined(jr):
                preemptors_map.setdefault(
                    qname, _LazyHeap(self._job_key)
                ).push(jr)
                under_request.append(jr)
                tasks_map[jr] = pending
        for qname in queue_seq:
            preemptors = preemptors_map.get(qname)
            # Phase 1 can only evict RUNNING same-queue victims
            # (job_filter below; no victims -> _try_preempt never
            # pipelines, preempt.go's empty-preemptees continue).  A
            # queue with no running tasks at all makes every phase-1
            # turn a no-op whose only observable effect is draining the
            # preemptor task lists -- do exactly that, wholesale.
            if preemptors is not None and not preemptors.empty():
                qi = c.queue_index.get(qname)
                if qi is not None:
                    has_running = bool(np.any(
                        (c.q_of_job[:c.Jn] == qi)
                        & (c.j_cnt_run[:c.Jn] > 0)
                    ))
                    if not has_running:
                        for _k, jr0 in preemptors.h:
                            lst = tasks_map.get(jr0)
                            if lst:
                                lst.clear()
                        preemptors.h.clear()
            # Phase 1: inter-job preemption within the queue.
            while preemptors is not None and not preemptors.empty():
                jr = preemptors.pop()
                stmt: list = []
                assigned = False
                tasks = tasks_map.get(jr, [])
                while True:
                    if self.job_pipelined(jr):
                        break
                    if not tasks:
                        break
                    prow = tasks.pop(0)
                    pq = m.j_queue[jr]

                    def job_filter(r: int) -> bool:
                        vjr = int(m.p_job[r])
                        if vjr < 0:
                            return False
                        return (m.j_queue[vjr] == pq) and vjr != jr

                    if self._try_preempt(prow, job_filter, stmt,
                                          ("pq", pq)):
                        assigned = True
                if self.job_pipelined(jr):
                    st.commit(stmt)
                else:
                    st.rollback(stmt)
                    continue
                if assigned:
                    preemptors.push(jr)
            # Phase 2: intra-job task preemption (the reference iterates
            # ALL under-request jobs inside each queue pass; the shared
            # task lists make it drain once).
            for jr in under_request:
                tasks = tasks_map.get(jr, [])
                while tasks:
                    prow = tasks.pop(0)
                    stmt2: list = []

                    def task_filter(r: int) -> bool:
                        return int(m.p_job[r]) == jr

                    assigned = self._try_preempt(
                        prow, task_filter, stmt2, ("job", jr)
                    )
                    st.commit(stmt2)
                    if not assigned:
                        break

    def _schedulable_jobs(self) -> List[int]:
        c = self.cyc
        m = c.m
        srows = np.asarray(c.session_jobs, np.int64)
        if not len(srows):
            return []
        # Vectorized over the derive-time snapshot: j_phase code 1 =
        # Pending-with-PodGroup (enqueue's in-place Inqueue transitions
        # update the same array); q_of_job < 0 <=> queue unknown.
        keep = c.j_phase[srows] != 1
        if c._has("gang"):
            keep &= c.j_valid[srows] >= m.j_minav[srows]
        keep &= c.q_of_job[srows] >= 0
        return srows[keep].tolist()

    # ------------------------------------------------------------- reclaim

    def _reclaim_prop_gated(self) -> bool:
        """True when proportion sits in the FIRST tier containing any
        reclaimable-registered plugin: only then does its queue-slack
        veto gate the walk (an earlier tier producing victims stops
        before proportion is consulted -- session_plugins.go tier-
        boundary semantics).  Shared by the Python veto and the C
        engine's reclaim_gated flag."""
        registered = {"gang", "conformance", "proportion"}
        first = next(
            (t for t in self._tiers_reclaim if registered & set(t)), None
        )
        return bool(first is not None and "proportion" in first)

    def _reclaim_possible(self, qname: str) -> bool:
        """True when some OTHER reclaimable queue still has slack above
        its deserved share (necessary for any proportion-admitted victim;
        trivially true when proportion is not in the reclaim tiers)."""
        c = self.cyc
        if not self._reclaim_prop_gated():
            return True
        cache = getattr(self, "_reclaim_poss_cache", None)
        if cache is not None and cache[0] == self.st.version:
            verdicts = cache[1]
        else:
            verdicts = {}
            self._reclaim_poss_cache = (self.st.version, verdicts)
        hit = verdicts.get(qname)
        if hit is not None:
            return hit
        out = False
        for name, qi in c.queue_index.items():
            if name == qname:
                continue
            q = c.store.queues.get(name)
            if q is None or not q.reclaimable():
                continue
            des = c.q_deserved_res.get(qi)
            if des is None:
                continue
            if des.less_equal_strict(c._res(c.q_alloc[qi])):
                out = True
                break
        verdicts[qname] = out
        return out

    def reclaim(self) -> None:
        """reclaim.go:40-189: cross-queue eviction, immediate."""
        c = self.cyc
        m = c.m
        st = self.st
        from .fastpath import _vec_le

        queues_pq = _LazyHeap(self._queue_key)
        seen_q = set()
        jobs_map: Dict[str, _LazyHeap] = {}
        tasks_map: Dict[int, List[int]] = {}
        for jr in self._schedulable_jobs():
            qname = m.j_queue[jr]
            if qname not in seen_q:
                seen_q.add(qname)
                queues_pq.push(qname)
            pending = self._task_rows_sorted(jr)
            if pending:
                jobs_map.setdefault(
                    qname, _LazyHeap(self._job_key)
                ).push(jr)
                tasks_map[jr] = pending

        overused = c._overused_fn()
        nat = self._native_reclaim_setup()
        try:
            if nat is None or not self._native_reclaim_drive(
                    nat, jobs_map, tasks_map):
                seed = self.__dict__.pop("_reclaim_over_seed", None)
                if seed:
                    # Verdicts the C drive already froze stay frozen in
                    # the fallback (first-evaluation semantics span the
                    # whole pass).
                    base_overused = overused

                    def overused(qinfo, _b=base_overused, _s=seed):
                        v = _s.get(qinfo.name)
                        return bool(v) if v is not None else _b(qinfo)
                self._reclaim_loop(queues_pq, jobs_map, tasks_map,
                                   overused, nat)
        finally:
            if nat is not None:
                nat["lib"].vcreclaim_ctx_free(nat["ctx"])

    def _reclaim_loop(self, queues_pq, jobs_map, tasks_map, overused,
                      nat) -> None:
        c = self.cyc
        m = c.m
        st = self.st
        while not queues_pq.empty():
            qname = queues_pq.pop()
            if overused(c.store.queues[qname]):
                continue
            jobs = jobs_map.get(qname)
            if jobs is None or jobs.empty():
                continue
            jr = jobs.pop()
            tasks = tasks_map.get(jr, [])
            if not tasks:
                continue
            prow = tasks.pop(0)

            assigned = False
            if not self._reclaim_possible(qname):
                # Necessary condition: proportion only admits a victim
                # while its queue stays at/above deserved after the
                # eviction; once no reclaimable queue has slack, no node
                # can yield victims (proportion.go:209-211) -- skip the
                # node walk wholesale.
                queues_pq.push(qname)
                continue
            init_req = st.init_req[prow]
            # Node prefilter = validate_victims (scheduler_helper.go:
            # 224-239): FutureIdle + victim capacity must cover the
            # task.  NOT evictable-alone: reclaim.go's victim loop runs
            # on any validated node and its evictions stand even when
            # the reclaimed sum never covers the task (the pipeline
            # check `resreq.less_equal(reclaimed)` gates only the
            # pipeline, reclaim.go:166-175) -- an evictable-only filter
            # would skip those collateral evictions and diverge.
            ev = self._evictable_for(("rq", qname))
            # Victim-less nodes drop out entirely (validate_victims
            # raises "no victims" there); exhausted nodes thus stop
            # costing their Python candidate walk as victims deplete.
            # Cached per (scope, request-profile), maintained per-node.
            comb = self._prefilter(("rq", qname), init_req, ev)
            # Reclaim walks nodes in insertion (= index) order
            # (reclaim.go `for _, n := range ssn.Nodes`).  Every cheap
            # prefilter component only flips False-ward while the action
            # runs (evicting an in-scope victim keeps fi+ev constant;
            # pipelines shrink fi; pod-count only grows; static masks
            # are constant), so nodes ruled out by THESE masks are ruled
            # out for every later reclaimer of the same (scope, profile)
            # -- a persistent cursor skips them once instead of scanning
            # [N] per task.  _apply_dirty rewinds it on the rare
            # False->True flip.  Nodes failing only the exact per-node
            # walk (victim narrowing) are NOT skipped by the cursor.
            feat = m.p_feat[prow]
            pidr = int(m.p_prof[prow])
            has_pred = c._has("predicates")
            static = None
            if has_pred:
                static = self._profile_static.get(pidr)
                if static is None:
                    static = self._static_mask(feat)
                    self._profile_static[pidr] = static
            plain_feat = not (feat.ports or feat.ip_req_aff
                              or feat.ip_req_anti)
            if has_pred and c.store.pods.get(m.p_uid[prow]) is None:
                # feasible_mask's ghost-task guard: a pending row with no
                # live pod record schedules nowhere.
                queues_pq.push(qname)
                continue
            if plain_feat:
                wkey = (("rq", qname), init_req.tobytes(), pidr)
                slots = self._slots_mask
                if slots is None and has_pred:
                    slots = self._slots_mask = (
                        (c.n_maxtasks <= 0) | (c.n_ntasks < c.n_maxtasks)
                    )
                qid = c.queue_index.get(qname, -1)
                if nat is not None and qid >= 0:
                    assigned = self._native_reclaim_step(
                        nat, prow, qid, init_req, wkey, static, slots,
                        comb, qname,
                    )
                else:
                    assigned = self._python_reclaim_walk(
                        prow, init_req, qname, wkey, comb, static, slots,
                    )
            else:
                feasible = comb
                if feasible.any():
                    feasible = feasible & self.feasible_mask(prow)
                for n in np.flatnonzero(feasible & c.n_alive):
                    if self._reclaim_node(prow, init_req, qname,
                                          int(n)):
                        assigned = True
                        break
            if assigned:
                jobs.push(jr)
            queues_pq.push(qname)

    def _python_reclaim_walk(self, prow: int, init_req: np.ndarray,
                             qname: str, wkey, comb, static,
                             slots) -> bool:
        """Cursor walk over nodes in index order (the exact fallback for
        the C engine; identical semantics)."""
        c = self.cyc
        n = self._walk_cursor.get(wkey, 0)
        advancing = True
        n_alive = c.n_alive
        Nn = c.Nn
        while n < Nn:
            if not (comb[n] and n_alive[n]
                    and (static is None or (static[n] and slots[n]))):
                n += 1
                if advancing:
                    self._walk_cursor[wkey] = n
                continue
            advancing = False
            if self._reclaim_node(prow, init_req, qname, n):
                return True
            n += 1
        return False

    def _reclaim_node(self, prow: int, init_req: np.ndarray,
                      qname: str, n: int) -> bool:
        """The exact per-node reclaim walk (reclaim.go:136-175): collect
        cross-queue Running candidates of reclaimable queues, narrow via
        the tiered Reclaimable intersection, validate, evict victims in
        order until the reclaimed sum covers the task, pipeline iff it
        does.  Returns True when the task pipelined on this node."""
        c = self.cyc
        m = c.m
        st = self.st
        from .fastpath import _vec_le

        cand = []
        for r in st.node_rows[n]:
            if m.p_status[r] != ST_RUNNING or st.req_empty[r]:
                continue
            vjr = int(m.p_job[r])
            if vjr < 0 or m.j_queue[vjr] == qname:
                continue
            vq = c.store.queues.get(m.j_queue[vjr])
            if vq is None or not vq.reclaimable():
                continue
            cand.append(r)
        victims = self._victims(prow, cand, "reclaim")
        if not victims:
            return False
        fut = st.future_idle(n)
        vsum = st.req[victims].sum(axis=0)
        if not _vec_le(init_req, fut + vsum, c.eps, c.scalar_slot):
            return False
        reclaimed = np.zeros(c.R, F)
        for r in victims:
            st.evict(r, None)
            st.evicted_rows.append(r)
            reclaimed += st.req[r]
            if _vec_le(init_req, reclaimed, c.eps, c.scalar_slot):
                break
        if _vec_le(init_req, reclaimed, c.eps, c.scalar_slot):
            st.pipeline(prow, n, None)
            return True
        return False

    # ------------------------------------------------- native reclaim core

    _NATIVE_MAX_CAND = 512  # VC_MAX_CAND in csrc/host/vcreclaim.cc

    def _native_reclaim_setup(self):
        """Prepare the dense context for the C reclaim step
        (csrc/host/vcreclaim.cc vcreclaim_step) -- or None to use the Python
        walk.  The C side mutates the SAME numpy buffers the Python
        bookkeeping uses, so the two paths are interchangeable
        per-reclaimer."""
        c = self.cyc
        st = self.st
        m = c.m
        if c.R > 8:
            return None
        from .native import reclaim_lib

        lib = reclaim_lib()
        if lib is None:
            return None
        # Degenerate nodes (> C scratch capacity) use the Python walk
        # for the whole action to keep mid-walk state exact.
        max_res = max((len(r) for r in st.node_rows), default=0)
        if max_res > self._NATIVE_MAX_CAND:
            return None
        # Contiguity: some cycle arrays are views; the C engine needs
        # C-order buffers, and replacing the attribute keeps them live
        # for the Python side too.
        for name in ("j_cnt_alloc", "j_cnt_run", "j_cnt_releasing",
                     "j_ready_base", "j_cnt_pending", "q_of_job",
                     "n_ntasks", "n_maxtasks"):
            arr = getattr(c, name)
            if not arr.flags["C_CONTIGUOUS"] or arr.dtype != np.int32:
                setattr(c, name, np.ascontiguousarray(arr, np.int32))
        if not c.j_alloc_res.flags["C_CONTIGUOUS"]:
            c.j_alloc_res = np.ascontiguousarray(c.j_alloc_res)
        if not c.q_alloc.flags["C_CONTIGUOUS"]:
            c.q_alloc = np.ascontiguousarray(c.q_alloc)
        if not st.fi.flags["C_CONTIGUOUS"]:
            st.fi = np.ascontiguousarray(st.fi)
        if not c.n_releasing.flags["C_CONTIGUOUS"]:
            c.n_releasing = np.ascontiguousarray(c.n_releasing)
        # Resident CSR (row order = NodeInfo.tasks iteration order).
        counts = [len(r) for r in st.node_rows]
        node_ptr = np.zeros(c.Nn + 1, np.int64)
        np.cumsum(counts, out=node_ptr[1:])
        flat = np.fromiter(
            (r for rows in st.node_rows for r in rows),
            np.int64, count=int(node_ptr[-1]),
        )
        Q = len(c.queue_names)
        q_rec = np.zeros(Q, np.uint8)
        for qi, qname in enumerate(c.queue_names):
            q = c.store.queues.get(qname)
            q_rec[qi] = bool(q is not None and q.reclaimable())
        q_des = np.zeros((Q, c.R), np.float32)
        q_has = np.zeros(Q, np.uint8)
        for qi, res in c.q_deserved_res.items():
            q_has[qi] = 1
            q_des[qi] = c._slots_vec(res)
        tiers = []
        ids = {"gang": 0, "conformance": 1, "proportion": 2}
        for tier in self._tiers_reclaim:
            for pname in tier:
                if pname in ids:
                    tiers.append(ids[pname])
            tiers.append(-1)
        # Keep references to every array the C context captures: the
        # context holds raw pointers, so anything here being collected
        # or reallocated would leave it dangling.
        nat = {
            "lib": lib,
            "node_ptr": node_ptr,
            "node_rows": flat,
            "p_status": m.p_status,
            "p_job": np.ascontiguousarray(m.p_job, np.int32),
            "req": st.req,
            "req_empty": np.ascontiguousarray(
                st.req_empty.view(np.uint8)),
            "critical": np.ascontiguousarray(st.critical.view(np.uint8)),
            "j_minav": np.ascontiguousarray(m.j_minav, np.int32),
            "q_rec": q_rec,
            "q_des": q_des,
            "q_has": q_has,
            "tiers": np.asarray(tiers, np.int32),
            "eps": np.ascontiguousarray(c.eps, np.float32),
            "scalar_slot": np.ascontiguousarray(
                c.scalar_slot.view(np.uint8)),
            "alive": np.ascontiguousarray(c.n_alive.view(np.uint8)),
            "init_req_base": st.init_req,
            "ones": np.ones(c.Nn, np.uint8),
            "cursor_buf": np.zeros(1, np.int64),
            # Sized so one step can never overflow it: a step evicts a
            # row at most once, and rows < Pn.
            "out_rows": np.zeros(max(c.Pn, 1), np.int64),
            "out_n": np.zeros(1, np.int64),
            # Mutable cycle arrays the ctx points into (pin them too).
            "pins": (c.j_ready_base, c.j_cnt_alloc, c.j_cnt_run,
                     c.j_cnt_releasing, c.j_alloc_res, c.q_of_job,
                     c.q_alloc, st.fi, c.n_releasing),
        }
        # Batch-mode inputs: job-order encoding, (create, uid) rank,
        # and the pipeline-side arrays the C batch mutates.
        Jn = c.Jn
        uids = np.array([m.j_uid[j] for j in range(Jn)])
        order = np.lexsort((uids, m.j_create[:Jn]))
        j_rank = np.empty(Jn, np.int32)
        j_rank[order] = np.arange(Jn, dtype=np.int32)
        order_ids = {"priority": 0, "gang": 1, "drf": 2}
        job_order = np.asarray(
            [order_ids[n] for n in self._job_order_names
             if n in order_ids], np.int32,
        )
        reclaim_gated = self._reclaim_prop_gated()
        nat_extra = {
            "j_rank": j_rank,
            "j_prio": np.ascontiguousarray(m.j_prio, np.int32),
            "p_node": np.ascontiguousarray(m.p_node, np.int32),
            "job_order": job_order,
            "total_res": np.ascontiguousarray(c.total_res, np.float32),
            "out_pipe_rows": np.zeros(max(c.Pn, 1), np.int64),
            "out_pipe_nodes": np.zeros(max(c.Pn, 1), np.int64),
            "out_n_pipe": np.zeros(1, np.int64),
            "out_touched": np.zeros(2 * max(c.Pn, 1), np.int64),
            "out_n_touched": np.zeros(1, np.int64),
            "reclaim_gated": reclaim_gated,
        }
        d = lambda a: a.ctypes.data
        (j_ready_base, j_cnt_alloc, j_cnt_run, j_cnt_releasing,
         j_alloc_res, q_of_job, q_alloc, fi, n_releasing) = nat["pins"]
        if not st.pipe_node.flags["C_CONTIGUOUS"] \
                or st.pipe_node.dtype != np.int64:
            st.pipe_node = np.ascontiguousarray(st.pipe_node, np.int64)
        nat["pins2"] = (st.n_pipelined, c.n_ntasks, c.n_maxtasks,
                        st.pipe_node, c.j_cnt_pending, st.j_waiting,
                        st.j_version, st.q_version)
        nat.update(nat_extra)
        nat["ctx"] = lib.vcreclaim_ctx_new(
            d(node_ptr), d(flat),
            d(nat["p_status"]), d(nat["p_job"]),
            d(nat["req"]), d(nat["req_empty"]), d(nat["critical"]),
            d(nat["j_minav"]), d(j_ready_base),
            d(j_cnt_alloc), d(j_cnt_run), d(j_cnt_releasing),
            d(j_alloc_res), d(q_of_job),
            d(q_rec), d(q_alloc), d(q_des), d(q_has),
            d(fi), d(n_releasing),
            d(nat["tiers"]), len(nat["tiers"]),
            d(nat["eps"]), d(nat["scalar_slot"]),
            d(nat["alive"]), d(nat["init_req_base"]),
            c.Nn, c.R, ST_RUNNING, ST_RELEASING,
            d(st.n_pipelined), d(c.n_ntasks), d(c.n_maxtasks),
            d(st.pipe_node), d(c.j_cnt_pending), d(st.j_waiting),
            d(st.j_version), d(st.q_version),
            int(len(st.q_version)),
            d(nat["j_prio"]), d(nat["j_rank"]), d(nat["p_node"]),
            d(nat["total_res"]), d(nat["job_order"]),
            len(nat["job_order"]), int(reclaim_gated),
        )
        nat["step"] = lib.vcreclaim_step
        nat["cur_addr"] = nat["cursor_buf"].ctypes.data
        nat["out_addr"] = nat["out_rows"].ctypes.data
        nat["out_n_addr"] = nat["out_n"].ctypes.data
        return nat

    def _native_reclaim_drive(self, nat, jobs_map, tasks_map) -> bool:
        """Run the ENTIRE reclaim round-robin in C -- any number of
        pending queues (vcreclaim_drive_mq: a lazy QUEUE heap with live
        share/create/uid keys over per-queue lazy job heaps, the
        per-turn proportion veto, overused verdicts frozen at first
        evaluation, cursor node walks, pipeline bookkeeping).  Tasks the
        C side cannot handle exactly (inter-pod terms / host ports /
        ghost pods) yield back here, are run through the exact Python
        turn, and the drive resumes.  Returns False to fall back to the
        Python loop."""
        c = self.cyc
        st = self.st
        m = c.m
        live = [(q, h) for q, h in jobs_map.items() if not h.empty()]
        if not live:
            return True
        has_pred = c._has("predicates")
        pods = c.store.pods
        lib = nat["lib"]
        # Queue-key components (the share component is derived live in
        # C; creation/uid tie-breaks are static per pass).
        has_prop_order = c._has("proportion") and any(
            opt.name == "proportion"
            for opt in c._tier_opts("enabled_queue_order")
        )
        # Deserved-NAMED slots per global queue (cpu/memory always;
        # scalars the deserved dict carries, zero-valued included) --
        # _queue_share iterates exactly these.
        q_named = np.zeros((max(c.Qn, 1), c.R), np.uint8)
        for qi, res in c.q_deserved_res.items():
            q_named[qi, 0] = q_named[qi, 1] = 1
            if res.scalars:
                for name in res.scalars:
                    idx = m.scalar_slots.index.get(name)
                    if idx is not None:
                        q_named[qi, 2 + idx] = 1
        # Per-queue active job lists + overused memo (persists across
        # yield re-entries, mirroring the Python closure's per-pass
        # cache).
        active_by_q: Dict[str, List[int]] = {
            q: [it for (_k, it) in h.h] for q, h in live
        }
        over_memo: Dict[str, int] = {}
        n_yields = 0
        while True:
            qnames = [q for q in active_by_q
                      if active_by_q[q] and c.queue_index.get(q, -1) >= 0]
            if not qnames:
                for _q, h in live:
                    h.h.clear()
                return True
            qids = np.asarray(
                [c.queue_index[q] for q in qnames], np.int64
            )
            q_create = np.asarray(
                [c.store.queues[q].queue.creation_timestamp
                 for q in qnames], np.float64,
            )
            uid_order = sorted(
                range(len(qnames)),
                key=lambda i: c.store.queues[qnames[i]].uid,
            )
            q_rank = np.empty(len(qnames), np.int32)
            for rk, i in enumerate(uid_order):
                q_rank[i] = rk
            q_over = np.asarray(
                [over_memo.get(q, -1) for q in qnames], np.int8
            )
            q_dropped = np.zeros(len(qnames), np.uint8)

            task_ptr = [0]
            flat: List[int] = []
            job_list: List[int] = []
            job_qslot: List[int] = []
            for slot, q in enumerate(qnames):
                for jr in active_by_q[q]:
                    job_list.append(jr)
                    job_qslot.append(slot)
                    flat.extend(tasks_map.get(jr, []))
                    task_ptr.append(len(flat))
            if not flat:
                for _q, h in live:
                    h.h.clear()
                return True
            if n_yields and n_yields * 4 > len(flat):
                # Many yielding (port/inter-pod/ghost) reclaimers: each
                # yield re-registers O(pending) state, so the Python
                # loop's linear walk is cheaper past this ratio.
                # Evictions/pipelines already landed, so the fallback
                # loop must see the drive's CURRENT state: rebuild the
                # job heaps minus dropped/consumed jobs (an emptied heap
                # drops the queue on pop, the round-robin's own drop
                # path) and hand the frozen overused verdicts to the
                # caller -- re-evaluating them at post-eviction state
                # would diverge from the object path.
                for q, h in live:
                    h.h.clear()
                    for jr in active_by_q.get(q, ()):
                        h.push(jr)
                self._reclaim_over_seed = dict(over_memo)
                return False
            row_maskidx = np.full(c.Pn, -1, np.int32)
            regs: List[dict] = []
            seen_prof: Dict[tuple, int] = {}
            for slot, q in enumerate(qnames):
                scope = ("rq", q)
                ev = self._evictable_for(scope)
                qid_g = int(qids[slot])
                for jr in active_by_q[q]:
                    for r in tasks_map.get(jr, ()):
                        feat = m.p_feat[r]
                        if feat.ports or feat.ip_req_aff or feat.ip_req_anti:
                            continue
                        if has_pred and pods.get(m.p_uid[r]) is None:
                            continue
                        key = (q, int(m.p_prof[r]),
                               st.init_req[r].tobytes())
                        mi = seen_prof.get(key)
                        if mi is None:
                            init_req = st.init_req[r]
                            self._prefilter(scope, init_req, ev)
                            static = None
                            if has_pred:
                                static = self._profile_static.get(key[1])
                                if static is None:
                                    static = self._static_mask(feat)
                                    self._profile_static[key[1]] = static
                            slots = self._slots_mask
                            if slots is None and has_pred:
                                slots = self._slots_mask = (
                                    (c.n_maxtasks <= 0)
                                    | (c.n_ntasks < c.n_maxtasks)
                                )
                            wkey = (scope, key[2], key[1])
                            mi = len(regs)
                            seen_prof[key] = mi
                            regs.append({
                                "wkey": wkey,
                                "qid": qid_g,
                                "anym": self._ev_any[scope],
                                "feas": self._ev_feas[(scope, key[2])][1],
                                "static": static if static is not None
                                else nat["ones"],
                                "slots": slots if slots is not None
                                else nat["ones"],
                                "init_req": np.ascontiguousarray(
                                    init_req, np.float32),
                            })
                        row_maskidx[r] = mi
            M = len(regs)
            d = lambda a: a.ctypes.data
            anym_p = np.asarray([d(g["anym"]) for g in regs], np.uint64)
            feas_p = np.asarray([d(g["feas"]) for g in regs], np.uint64)
            stat_p = np.asarray([d(g["static"]) for g in regs],
                                np.uint64)
            slot_p = np.asarray([d(g["slots"]) for g in regs], np.uint64)
            ireq_p = np.asarray([d(g["init_req"]) for g in regs],
                                np.uint64)
            mask_cur = np.asarray(
                [self._walk_cursor.get(g["wkey"], 0) for g in regs],
                np.int64,
            )
            mask_qid = np.asarray([g["qid"] for g in regs], np.int64)
            job_arr = np.asarray(job_list, np.int64)
            jq_arr = np.asarray(job_qslot, np.int64)
            ptr_arr = np.asarray(task_ptr, np.int64)
            flat_arr = np.asarray(flat, np.int64)
            task_cur = np.zeros(max(len(job_list), 1), np.int64)
            j_dropped = np.zeros(max(len(job_list), 1), np.uint8)
            yield_job = np.zeros(1, np.int64)
            out_n_ev = nat["out_n"]
            out_n_ev[0] = 0
            nat["out_n_pipe"][0] = 0
            nat["out_n_touched"][0] = 0
            rc = lib.vcreclaim_drive_mq(
                nat["ctx"], 1 if has_pred else 0,
                qids.ctypes.data, len(qnames),
                q_create.ctypes.data, q_rank.ctypes.data,
                q_named.ctypes.data, 1 if has_prop_order else 0,
                q_over.ctypes.data, q_dropped.ctypes.data,
                job_arr.ctypes.data, len(job_list),
                jq_arr.ctypes.data,
                ptr_arr.ctypes.data, flat_arr.ctypes.data,
                task_cur.ctypes.data,
                row_maskidx.ctypes.data,
                M,
                anym_p.ctypes.data, feas_p.ctypes.data,
                stat_p.ctypes.data, slot_p.ctypes.data,
                ireq_p.ctypes.data,
                mask_qid.ctypes.data,
                mask_cur.ctypes.data,
                nat["out_addr"], out_n_ev.ctypes.data,
                len(nat["out_rows"]),
                nat["out_pipe_rows"].ctypes.data,
                nat["out_pipe_nodes"].ctypes.data,
                nat["out_n_pipe"].ctypes.data,
                nat["out_touched"].ctypes.data,
                nat["out_n_touched"].ctypes.data,
                len(nat["out_touched"]),
                yield_job.ctypes.data,
                j_dropped.ctypes.data,
            )
            # ---- replay the store-facing bookkeeping
            n_ev = int(out_n_ev[0])
            if n_ev:
                st.version += n_ev
                for r in nat["out_rows"][:n_ev].tolist():
                    self._native_evicted(r)
                    st.evicted_rows.append(r)
                    vjr = int(m.p_job[r])
                    if vjr >= 0:
                        st.j_version[vjr] += 1
                        qi = int(c.q_of_job[vjr])
                        if 0 <= qi < len(st.q_version):
                            st.q_version[qi] += 1
                    self._evictable_update(r, -1)
            n_pipe = int(nat["out_n_pipe"][0])
            if n_pipe:
                st.version += n_pipe
                for row, node in zip(
                        nat["out_pipe_rows"][:n_pipe].tolist(),
                        nat["out_pipe_nodes"][:n_pipe].tolist()):
                    st.pipelined_rows.append(row)
                    st.node_rows[node].append(row)
            n_t = int(nat["out_n_touched"][0])
            if n_t:
                self._dirty.update(
                    int(x) for x in nat["out_touched"][:n_t].tolist())
            for g, cur in zip(regs, mask_cur.tolist()):
                self._walk_cursor[g["wkey"]] = int(cur)
            for i, jr in enumerate(job_list):
                k = int(task_cur[i])
                if k:
                    del tasks_map[jr][:k]
            # Persist overused verdicts + dropped queues across
            # re-entries (the Python closure's per-pass memo / the
            # missing queue re-push).
            for slot, q in enumerate(qnames):
                if q_over[slot] >= 0:
                    over_memo[q] = int(q_over[slot])
                if q_dropped[slot]:
                    active_by_q[q] = []
            if rc == -4:
                # Key buffer bound exceeded (very long job-order config):
                # nothing was mutated -- use the Python loop.
                return False
            if rc == 0:
                for _q, h in live:
                    h.h.clear()
                return True
            # rc == -3: one exact Python turn for the yielded job.
            # rc == -5: the turn's veto already ran in C and the walk
            # bailed mid-node; resume walk-only (re-running the veto
            # here could diverge after the turn's partial evictions).
            n_yields += 1
            ji = int(yield_job[0])
            jr_y = job_list[ji]
            q_y = qnames[job_qslot[ji]]
            keep = self._drive_python_turn(jr_y, tasks_map, q_y,
                                           walk_only=(rc == -5))
            dropped_set = {
                jr for jr, dr in zip(job_list, j_dropped[:len(job_list)])
                if dr
            }
            for q in qnames:
                active_by_q[q] = [
                    jr for jr in active_by_q[q]
                    if jr not in dropped_set and jr != jr_y
                ]
            if keep:
                active_by_q[q_y].append(jr_y)

    def _native_evicted(self, row: int) -> None:
        """What ``EvictState.evict`` does beside the counters the engine
        moved itself, for a row the engine evicted: the auditor's
        ``evict`` flow, the journey's ``evicted`` event and the mirror's
        dirty mark (the engine wrote ``p_status`` directly).  The JAX
        package's replay does none of the three, so its auditor reports a
        conservation mismatch after a native reclaim and its journey
        misses those evictions."""
        c = self.cyc
        c._audit_flow(ST_RUNNING, ST_RELEASING, "evict")
        c._journey_event(row, "evicted")
        c.m.mark_pod_dirty(row)

    def _drive_python_turn(self, jr: int, tasks_map, qname: str,
                           walk_only: bool = False) -> bool:
        """One exact reclaim turn for a task the C drive yielded
        (mirror of the _reclaim_loop body for one (job, task)).
        ``walk_only`` resumes a turn whose veto/guards already ran in C
        before its walk bailed."""
        c = self.cyc
        st = self.st
        m = c.m
        tasks = tasks_map.get(jr, [])
        if not tasks:
            return False
        prow = tasks.pop(0)
        if not walk_only:
            if not self._reclaim_possible(qname):
                return False
            if c._has("predicates") \
                    and c.store.pods.get(m.p_uid[prow]) is None:
                return False
        init_req = st.init_req[prow]
        ev = self._evictable_for(("rq", qname))
        comb = self._prefilter(("rq", qname), init_req, ev)
        feasible = comb
        if feasible.any():
            feasible = feasible & self.feasible_mask(prow)
        for n in np.flatnonzero(feasible & c.n_alive):
            if self._reclaim_node(prow, init_req, qname, int(n)):
                return True
        return False

    def _native_reclaim_step(self, nat, prow: int, qid: int,
                             init_req: np.ndarray, wkey, static, slots,
                             comb, qname: str) -> bool:
        """Run one reclaimer through the C engine; apply the Python-side
        bookkeeping the C core does not own (evicted-row caches, event
        versioning, dirty marking, the pipeline)."""
        c = self.cyc
        st = self.st
        m = c.m
        cur = nat["cursor_buf"]
        cur[0] = self._walk_cursor.get(wkey, 0)
        out_n = nat["out_n"]
        out_n[0] = 0
        # Mask addresses are stable per (scope, profile); resolve once.
        addrs = nat.setdefault("addrs", {})
        ap = addrs.get(wkey)
        if ap is None:
            ap = (
                self._ev_any[wkey[0]].ctypes.data,
                self._ev_feas[(wkey[0], wkey[1])][1].ctypes.data,
                (static if static is not None
                 else nat["ones"]).ctypes.data,
                (slots if slots is not None
                 else nat["ones"]).ctypes.data,
            )
            addrs[wkey] = ap
        node = nat["step"](
            nat["ctx"], prow, qid, nat["cur_addr"],
            ap[0], ap[1], ap[2], ap[3],
            nat["out_addr"], nat["out_n_addr"], len(nat["out_rows"]),
        )
        self._walk_cursor[wkey] = int(cur[0])
        n_ev = int(nat["out_n"][0])
        if n_ev:
            rows = nat["out_rows"][:n_ev]
            st.version += n_ev
            for r in rows.tolist():
                self._native_evicted(r)
                st.evicted_rows.append(r)
                jr = int(m.p_job[r])
                if jr >= 0:
                    st.j_version[jr] += 1
                    qi = int(c.q_of_job[jr])
                    if 0 <= qi < len(st.q_version):
                        st.q_version[qi] += 1
                self._evictable_update(r, -1)
                self._dirty.add(int(m.p_node[r]))
        if node == -2:
            # C scratch overflow (should be prevented by setup): finish
            # this reclaimer on the exact Python walk.
            return self._python_reclaim_walk(prow, init_req, qname,
                                             wkey, comb, static, slots)
        if node >= 0:
            st.pipeline(prow, int(node), None)
            return True
        return False
