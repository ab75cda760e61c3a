"""The eviction state of the fast path's preempt and reclaim lanes.

The counterpart of ``EvictState`` in the JAX package's
``fastpath_evict.py`` (:57-379), as the device-native lanes use it: a
committed what-if plan evicts each victim here (Running -> Releasing in the
mirror, with the cycle's node, job and queue counters moved to match), and
``flush`` hands the evictions to the store's evictor at cycle end (pod
marked deleting, one batch when the evictor supports it).  Evictor failures
revert exactly the failed pods to Running, cancel their ledger entries and
stamp the mirror's mutation counter.

The host victim walk (``FastEvictor.preempt`` / ``reclaim``, its pipelines,
undo logs and plugin victim tiers) is not ported yet: ROADMAP.md, queue 1,
"the host victim walk".
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from .api import TaskStatus

log = logging.getLogger(__name__)

F = np.float32

ST_RUNNING = int(TaskStatus.Running)
ST_RELEASING = int(TaskStatus.Releasing)


class EvictState:
    """Per-cycle eviction state (built on the first eviction of a cycle).

    Lives inside FastCycle.run, under run_cycle_fast's store lock."""

    # vclint: class-holds: _lock

    def __init__(self, cyc):
        self.cyc = cyc
        m = cyc.m
        Pn, R = cyc.Pn, cyc.R
        self.req = np.zeros((Pn, R), F)
        rows = np.flatnonzero(m.p_alive[:Pn])
        if len(rows):
            er, si, v = m.c_req.gather(rows)
            self.req[rows[er], si] = v
        # Committed evictions (flushed to the store at cycle end).
        self.evicted_rows: List[int] = []

    def evict(self, row: int) -> None:
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
        # must see it.
        m.mark_pod_dirty(row)
        c.n_releasing[n] += req
        jr = int(m.p_job[row])
        if jr >= 0:
            c.j_cnt_alloc[jr] -= 1
            c.j_cnt_run[jr] -= 1
            c.j_cnt_releasing[jr] += 1
            c.j_ready_base[jr] -= 1
            c.j_alloc_res[jr] -= req
            qi = c.q_of_job[jr]
            if qi >= 0:
                c.q_alloc[qi] -= req

    def unevict(self, row: int, n: int, jr: int) -> None:
        c = self.cyc
        m = c.m
        req = self.req[row]
        c._audit_flow(int(m.p_status[row]), ST_RUNNING, "evict-revert")
        c._journey_event(row, "evict-reverted")
        m.p_status[row] = ST_RUNNING
        m.mark_pod_dirty(row)
        c.n_releasing[n] -= req
        if jr >= 0:
            c.j_cnt_alloc[jr] += 1
            c.j_cnt_run[jr] += 1
            c.j_cnt_releasing[jr] -= 1
            c.j_ready_base[jr] += 1
            c.j_alloc_res[jr] += req
            qi = c.q_of_job[jr]
            if qi >= 0:
                c.q_alloc[qi] += req

    def flush(self) -> None:
        """Apply committed evictions to the store (cache.Evict semantics:
        pod marked deleting, evictor dispatched -- one batch when the
        evictor supports it).  Evictor failures revert exactly the failed
        pods to Running, the cache.go:461-466 resyncTask analog: the next
        preempt/reclaim cycle re-selects a victim set."""
        if not self.evicted_rows:
            return
        c = self.cyc
        m = c.m
        store = c.store
        from .cache.interface import EvictFailure

        evictor = store.evictor
        evict_keys = getattr(evictor, "evict_keys", None)
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
                # Transport-level error: indeterminate -- re-drive per key
                # so each gets a definite outcome (evictions are
                # idempotent).
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
                # The pod is NOT terminating.  unevict restores the mirror
                # status AND the cycle's job/queue counters so the
                # session-close status write-back matches reality.
                pod.deleting = False
                self.unevict(row, int(m.p_node[row]), int(m.p_job[row]))
                if ledger is not None:
                    # A victim whose eviction never dispatched leaves the
                    # ledger: a stranded entry would pin its group's
                    # budget, and its eventual normal deletion would
                    # wrongly "restore" it.
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
            # The reverts flipped p_status after the action loop: one
            # fresh stamp covers the batch.
            m.mutation_seq += 1
        if ledger is not None:
            # Ledgered victims whose eviction actually dispatched: the
            # counters reflect evictions that happened, each action in its
            # own series.
            by_action: Dict[str, int] = {}
            for _row, key, pod in entries:
                if key in failed:
                    continue
                entry = ledger.entries.get(pod.uid)
                if entry is not None:
                    by_action[entry.action] = by_action.get(
                        entry.action, 0) + 1
            if by_action:
                from .metrics import metrics

                n_reb = by_action.pop("rebalance", 0)
                if n_reb:
                    metrics.rebalance_evictions.inc(n_reb)
                for a, n in by_action.items():
                    metrics.preempt_evictions.inc(n, action=a)
        store.record_events_deferred(events)
        store.mark_objects_stale()
