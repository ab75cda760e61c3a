"""Pod-journey tracing: per-pod scheduling timelines.

The counterpart of the JAX package's ``obs/journey.py``, with the same
events, verdicts, counters and latency feeds.  The other observability
layers are cycle-centric (lane spans, flight records, conservation flows,
SLO windows); none answers what a batch-system user asks: *where did my
pod's time go, and why is it still pending?*  ``JourneyLog`` is the
pod-centric plane: a bounded columnar event ring plus a per-pod summary,
captured at every writer of the mirror's pod state and at the fast
cycle's seams.

Event vocabulary (docs/observability.md):

- ``enqueued``           pod row created in the mirror (store edge)
- ``status-sync``        external status overwrite (update / resync)
- ``dispatched``         first entered a device solve (solve_id, shard)
- ``dropped``            staleness-guard drop, one exclusive reason
- ``bound``              commit/backfill landed the placement
- ``unbound``            bind-failure resync or steady-state re-pend
- ``evicted`` / ``evict-reverted``  fastpath_evict state transitions
- ``migration-planned``  what-if plan committed this pod as a victim
- ``restored``           migration ledger re-added it under a new uid
- ``removed``            pod row tombstoned (store edge)

The port runs one scheduler, so every event's shard is -1; the field
stays for the sharded control plane (ROADMAP.md, queue 1).

Cost discipline: the fast cycle feeds per-pod work only for *state
changes* -- first consideration, first bind, drops, evictions, churn
edges.  The steady-state feed (re-pend and re-bind of the same rows every
cycle) is folded into bulk counters by the caller
(``fastpath.FastCycle._journey_rows``'s row masks).  Where the JAX package
keeps one Python object a pod, this log keeps the per-pod summary in
numpy columns indexed by a slot a pod (a uid keeps its slot until the
pod is removed), so a cold cycle's first dispatch and first bind of every
pod -- two events a pod -- are array operations over the batch
(``pod_rows``), not interpreter work a pod.  Every capture takes host
values the cycle already holds (uids, numpy row indices); none reads a
tensor.

Latency feeds: first dispatch observes time-to-first-consider, first bind
observes time-to-bind (per queue) and the gang's time-to-full-bind once
every member seen is bound; time-to-bind also feeds the ``ttb`` SLO lane
(``VOLCANO_TPU_SLO_TTB_P99_MS``), whose breaches surface as
``slo-budget-exceeded`` anomalies.

Conservation: ``conservation_check(bound_uids)`` proves every bound pod
has a complete, orphan-free journey -- a state rooted at ``enqueued``
(``journey-orphan`` otherwise) with a recorded bind and monotone event
order (``journey-incomplete`` otherwise).  A harness that ran with the
journey detached re-adopts pods through ``pod_resync`` (synthetic roots,
explicitly tolerated).

One small lock guards all state; kill switch ``VOLCANO_TPU_JOURNEY=0``
leaves the store with ``journey = None`` so hot paths pay one attribute
load.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .audit import Anomaly

DEFAULT_EVENTS = 65536

# TaskStatus bit-flags that mean "this pod holds (or held) a placement"
# (api/types.py): Allocated | Binding | Bound | Running | Succeeded.
_BOUND_MASK = (1 << 1) | (1 << 3) | (1 << 4) | (1 << 5) | (1 << 7)
_ST_PENDING = 1
_ST_BOUND = 1 << 4

KINDS = (
    "enqueued", "status-sync", "dispatched", "dropped", "bound",
    "unbound", "evicted", "evict-reverted", "migration-planned",
    "restored", "removed",
)
_KIND_CODE = {k: i for i, k in enumerate(KINDS)}
_DISPATCHED = _KIND_CODE["dispatched"]
_BOUND = _KIND_CODE["bound"]

# Per-pod drop-chain depth (why-pending evidence window).
_DROP_CHAIN = 8
# Percentile sample windows.
_TTB_WINDOW = 4096
_GANG_WINDOW = 1024
_QUEUE_WINDOW = 256
# Per-kind metric counts fold into the registry counter in batches of
# this many events (read paths flush too, so totals stay fresh).
_FLUSH_EVERY = 256
# "Not yet" in the first-consider and bind timestamp columns.
_NEVER = -1


def journey_on() -> bool:
    return os.environ.get("VOLCANO_TPU_JOURNEY", "1") != "0"


def ring_capacity() -> int:
    try:
        return max(int(os.environ.get("VOLCANO_TPU_JOURNEY_EVENTS",
                                      DEFAULT_EVENTS)), 1024)
    except ValueError:
        return DEFAULT_EVENTS


def _pct(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    vals = sorted(vals)
    i = min(int(q * (len(vals) - 1) + 0.5), len(vals) - 1)
    return round(vals[i], 3)


class _GangState:
    __slots__ = ("first_enq_ns", "members", "bound", "alive", "done")

    def __init__(self, now_ns: int):
        self.first_enq_ns = now_ns
        self.members = 0
        self.bound = 0
        self.alive = 0
        self.done = False


class JourneyLog:
    """Bounded columnar per-pod event timeline + per-pod summaries.

    Writers call under the store lock (mirror writers, the fast cycle);
    readers may be any thread.  All shared state is guarded by the
    journey's own ``_lock``, never taken around store state, so a reader
    cannot block the cycle thread on store work.

    Per-pod summary columns (slot-indexed; ``_slot`` maps a uid to its
    slot, a removed pod's slot is reused): queue and gang (interned ids;
    gang -1 when none), enqueue / first-consider / bind / last-event
    timestamps (``_NEVER`` when not yet), last event kind, status, solve
    id, shard, monotone and synthetic flags; the drop chain and the
    restore link are dicts over the few slots that have them.
    """

    def __init__(self, capacity: Optional[int] = None, slo=None,
                 auditor=None):
        cap = ring_capacity() if capacity is None else max(int(capacity), 8)
        self._cap = cap
        self._lock = threading.Lock()
        # Wall anchor (obs/trace.py idiom): perf_counter deltas stay
        # monotone; adding the anchor aligns exported timestamps with
        # the tracer's span clock.
        self._anchor_ns = time.time_ns() - time.perf_counter_ns()
        # Columnar ring, overwrite-oldest.  guarded-by: _lock
        self._ev_uid: List[Optional[str]] = [None] * cap
        self._ev_detail: List[Optional[str]] = [None] * cap
        self._ev_kind = np.zeros(cap, np.int8)
        self._ev_shard = np.zeros(cap, np.int32)
        self._ev_solve = np.zeros(cap, np.int64)
        self._ev_epoch = np.zeros(cap, np.int64)
        self._ev_ts = np.zeros(cap, np.int64)
        self._head = 0  # next write slot; guarded-by: _lock
        self._count = 0  # events ever written; guarded-by: _lock
        # Per-pod summaries.  guarded-by: _lock
        self._slot: Dict[str, int] = {}
        self._free: List[int] = []
        self._n_slots = 0
        self._grow(1024)
        self._drops: Dict[int, deque] = {}
        self._restored: Dict[int, str] = {}
        self._qid: Dict[str, int] = {}
        self._qnames: List[str] = []
        self._gid: Dict[str, int] = {}
        self._gnames: List[str] = []
        self._gangs: Dict[str, _GangState] = {}
        # Counters.  guarded-by: _lock
        self.events_total = 0
        self.rebinds = 0  # steady-state re-pend loop, counted in bulk
        self.reconsiders = 0
        self.unbinds_bulk = 0
        self.bound_total = 0
        # Per-kind event counts batched toward the registry counter.
        # guarded-by: _lock
        self._kind_counts: Dict[str, int] = {}
        self._unflushed = 0
        self._metrics = None  # lazy ..metrics handle (import cycle)
        # Self-timed capture cost: nanoseconds spent inside the capture
        # entry points, two perf_counter reads per CALL (not per event).
        self.capture_ns = 0
        # Latency sample windows for stats() / queue_rollup().
        self._ttb_ms: deque = deque(maxlen=_TTB_WINDOW)
        self._ttfc_ms: deque = deque(maxlen=_TTB_WINDOW)
        self._gang_ttfb_ms: deque = deque(maxlen=_GANG_WINDOW)
        self._queue_ttb: Dict[str, deque] = {}
        self._queue_counts: Dict[str, Dict[str, int]] = {}
        # SLO feed (ttb lane) + breach intake (auditor.report).
        self.slo = slo
        self.auditor = auditor

    # ------------------------------------------------------- slot columns

    def _grow(self, n: int) -> None:
        """Size the per-pod columns for at least ``n`` slots."""
        old = getattr(self, "_s_enq", None)
        have = 0 if old is None else len(old)
        if n <= have:
            return
        size = max(n, 2 * have, 1024)

        def col(name, dtype, fill):
            a = np.full(size, fill, dtype)
            if old is not None:
                a[:have] = getattr(self, name)
            setattr(self, name, a)

        col("_s_queue", np.int32, 0)
        col("_s_gang", np.int32, -1)
        col("_s_enq", np.int64, 0)
        col("_s_first", np.int64, _NEVER)
        col("_s_bound", np.int64, _NEVER)
        col("_s_last", np.int64, 0)
        col("_s_kind", np.int8, 0)
        col("_s_status", np.int64, _ST_PENDING)
        col("_s_solve", np.int64, 0)
        col("_s_shard", np.int32, -1)
        col("_s_mono", np.bool_, True)
        col("_s_synth", np.bool_, False)

    def _intern(self, table: Dict[str, int], names: List[str],
                name: str) -> int:
        i = table.get(name)
        if i is None:
            i = table[name] = len(names)
            names.append(name)
        return i

    def _init_slots(self, s, now: int, queue: str, gang: str,
                    synthetic: bool) -> None:
        """A fresh summary (the JAX ``_PodState``) in slot ``s``, a slot
        or an array of slots."""
        self._s_queue[s] = self._intern(self._qid, self._qnames, queue)
        self._s_gang[s] = (self._intern(self._gid, self._gnames, gang)
                           if gang else -1)
        self._s_enq[s] = now
        self._s_first[s] = _NEVER
        self._s_bound[s] = _NEVER
        self._s_last[s] = now
        self._s_kind[s] = _KIND_CODE["enqueued"]
        self._s_status[s] = _ST_PENDING
        self._s_solve[s] = 0
        self._s_shard[s] = -1
        self._s_mono[s] = True
        self._s_synth[s] = synthetic

    def _new_state(self, uid: str, queue: str, gang: str, now: int,
                   synthetic: bool = False) -> int:
        """A fresh summary for ``uid``: its slot."""
        if self._free:
            s = self._free.pop()
        else:
            s = self._n_slots
            self._n_slots += 1
            self._grow(self._n_slots)
        self._slot[uid] = s
        self._init_slots(s, now, queue, gang, synthetic)
        return s

    def _new_states(self, uids: List[str], now: int) -> np.ndarray:
        """Synthetic roots for a batch of unseen uids, in order: their
        slots."""
        n = len(uids)
        take = min(n, len(self._free))
        slots = [self._free.pop() for _ in range(take)]
        start = self._n_slots
        self._n_slots += n - take
        self._grow(self._n_slots)
        slots.extend(range(start, self._n_slots))
        for uid, s in zip(uids, slots):
            self._slot[uid] = s
        s = np.asarray(slots, np.int64)
        self._init_slots(s, now, "", "", True)
        return s

    def _queue_of(self, s: int) -> str:
        return self._qnames[int(self._s_queue[s])]

    def _gang_of(self, s: int) -> str:
        g = int(self._s_gang[s])
        return self._gnames[g] if g >= 0 else ""

    def _by_queue(self, slots: np.ndarray, values: np.ndarray):
        """The batch's values split by the slots' queue label (the queue
        name, "none" for none), each part in batch order."""
        qids = self._s_queue[slots]
        groups: Dict[str, list] = {}
        for q in np.unique(qids).tolist():
            groups.setdefault(self._qnames[q] or "none", []).append(q)
        for name, qs in groups.items():
            sel = qids == qs[0] if len(qs) == 1 else np.isin(qids, qs)
            yield name, values[sel]

    def _metrics_handle(self):
        if self._metrics is None:
            from ..metrics import metrics

            self._metrics = metrics
        return self._metrics

    # ------------------------------------------------------------ capture

    def pod_event(self, uid: Optional[str], kind: str, *,
                  status: int = -1, queue: str = "", gang: str = "",
                  shard: int = -1, solve_id: int = 0, epoch: int = -1,
                  detail: str = "") -> None:
        """Record one event for one pod (writers hold the store lock)."""
        if not uid:
            return
        t0 = time.perf_counter_ns()
        now = time.time_ns() - self._anchor_ns
        with self._lock:
            self._apply(uid, kind, now, status, queue, gang, shard,
                        solve_id, epoch, detail)
            self.capture_ns += time.perf_counter_ns() - t0

    def pod_rows(self, uids: Iterable[Optional[str]], kind: str, *,
                 shard: int = -1, solve_id: int = 0, epoch: int = -1,
                 detail: str = "") -> None:
        """Bulk capture sharing one timestamp and lock acquisition (the
        fast cycle's vectorized writers).  First dispatch and first bind
        are array operations over the batch; other kinds (drops, churn-
        sized) apply event by event."""
        t0 = time.perf_counter_ns()
        now = time.time_ns() - self._anchor_ns
        uids = [u for u in uids if u]
        with self._lock:
            if not (kind in ("dispatched", "bound") and uids
                    and self._apply_rows(uids, kind, now, shard, solve_id,
                                         epoch, detail)):
                for uid in uids:
                    self._apply(uid, kind, now, -1, "", "", shard,
                                solve_id, epoch, detail)
            self.capture_ns += time.perf_counter_ns() - t0

    def repeat_rows(self, n: int, kind: str) -> None:
        """Steady-state bulk accounting: the feed re-pends and re-binds
        the SAME rows every cycle; their journeys are already complete,
        so only counters move (per-cycle journey cost stays
        churn-proportional)."""
        if n <= 0:
            return
        t0 = time.perf_counter_ns()
        with self._lock:
            if kind == "bound":
                self.rebinds += n
            elif kind == "dispatched":
                self.reconsiders += n
            else:
                self.unbinds_bulk += n
            self.capture_ns += time.perf_counter_ns() - t0

    def pod_resync(self, pairs: Iterable[Tuple[Optional[str], int]]
                   ) -> None:
        """Bulk status adoption (mirror.resync_status, or a harness
        re-attaching a detached journey): missing pods get synthetic
        roots; pods whose status says placed get a state-sync bind so
        the conservation invariant holds across the blind window."""
        t0 = time.perf_counter_ns()
        now = time.time_ns() - self._anchor_ns
        with self._lock:
            marks: List[int] = []
            marked = set()
            for uid, status in pairs:
                if not uid:
                    continue
                s = self._slot.get(uid)
                if s is None:
                    s = self._new_state(uid, "", "", now, synthetic=True)
                self._s_status[s] = int(status)
                if (status & _BOUND_MASK) and s not in marked \
                        and self._s_bound[s] == _NEVER:
                    marks.append(s)
                    marked.add(s)
            if marks:
                self._mark_bound_many(np.asarray(marks, np.int64), now)
            self.capture_ns += time.perf_counter_ns() - t0

    def pod_restored(self, old_uid: str, new_uid: str) -> None:
        """Migration-ledger stitch: the restored pod's fresh journey
        links back to the evicted victim's uid."""
        now = time.time_ns() - self._anchor_ns
        with self._lock:
            s = self._slot.get(new_uid)
            if s is not None:
                self._restored[s] = old_uid
            self._apply(new_uid, "restored", now, -1, "", "", -1, 0,
                        -1, old_uid)

    # ------------------------------------------------------- apply (locked)

    def _apply(self, uid: str, kind: str, now: int, status: int,
               queue: str, gang: str, shard: int, solve_id: int,
               epoch: int, detail: str) -> None:
        s = self._slot.get(uid)
        if kind == "enqueued":
            if s is None:
                s = self._new_state(uid, queue, gang, now)
                if gang:
                    g = self._gangs.get(gang)
                    if g is None:
                        g = self._gangs[gang] = _GangState(now)
                    g.members += 1
                    g.alive += 1
                qc = self._queue_counts.setdefault(
                    queue, {"enqueued": 0, "bound": 0})
                qc["enqueued"] += 1
            if status >= 0:
                self._s_status[s] = status
                if (status & _BOUND_MASK) and self._s_bound[s] == _NEVER:
                    self._mark_bound(s, now)
        elif s is None:
            # Event for a pod the journey never saw enqueue (adopted
            # mid-life, e.g. re-attach after an A/B window): synthesize
            # the root so the timeline stays rooted.
            s = self._new_state(uid, queue, gang, now, synthetic=True)
        if now < self._s_last[s]:
            self._s_mono[s] = False
        self._s_last[s] = now
        self._s_kind[s] = _KIND_CODE.get(kind, 0)
        if kind == "dispatched":
            self._s_solve[s] = solve_id
            self._s_shard[s] = shard
            if self._s_first[s] == _NEVER:
                self._s_first[s] = now
                ms = (now - int(self._s_enq[s])) / 1e6
                self._ttfc_ms.append(ms)
                self._metrics_handle().pod_time_to_first_consider.observe(
                    ms, queue=self._queue_of(s) or "none")
        elif kind == "dropped":
            chain = self._drops.get(s)
            if chain is None:
                chain = self._drops[s] = deque(maxlen=_DROP_CHAIN)
            chain.append((detail, shard))
        elif kind == "bound":
            self._s_status[s] = _ST_BOUND
            if self._s_bound[s] == _NEVER:
                self._mark_bound(s, now)
        elif kind == "status-sync":
            if status >= 0:
                self._s_status[s] = status
                if (status & _BOUND_MASK) and self._s_bound[s] == _NEVER:
                    self._mark_bound(s, now)
        elif kind == "removed":
            gang_name = self._gang_of(s)
            del self._slot[uid]
            self._drops.pop(s, None)
            self._restored.pop(s, None)
            self._free.append(s)
            if gang_name:
                g = self._gangs.get(gang_name)
                if g is not None:
                    g.alive -= 1
                    if g.alive <= 0:
                        del self._gangs[gang_name]
        self._ring_write([uid], _KIND_CODE.get(kind, 0), kind, shard,
                         solve_id, epoch, now, detail)

    def _apply_rows(self, uids: List[str], kind: str, now: int, shard: int,
                    solve_id: int, epoch: int, detail: str) -> bool:
        """``_apply`` of a ``dispatched`` or ``bound`` event to every uid
        of the batch, as array operations.  Returns False (nothing done)
        when a uid repeats in the batch; the caller then applies the
        events one by one."""
        if len(set(uids)) != len(uids):
            return False
        get = self._slot.get
        slots = np.asarray([get(u, -1) for u in uids], np.int64)
        unseen = slots < 0
        if unseen.any():
            idx = np.flatnonzero(unseen)
            slots[idx] = self._new_states([uids[i] for i in idx.tolist()],
                                          now)
        self._s_mono[slots] &= ~(now < self._s_last[slots])
        self._s_last[slots] = now
        if kind == "dispatched":
            self._s_kind[slots] = _DISPATCHED
            self._s_solve[slots] = solve_id
            self._s_shard[slots] = shard
            first = slots[self._s_first[slots] == _NEVER]
            if len(first):
                self._s_first[first] = now
                ms = (now - self._s_enq[first]) / 1e6
                self._ttfc_ms.extend(ms.tolist())
                hist = self._metrics_handle().pod_time_to_first_consider
                for q, vs in self._by_queue(first, ms):
                    hist.observe_many(vs, queue=q)
            code = _DISPATCHED
        else:
            self._s_kind[slots] = _BOUND
            self._s_status[slots] = _ST_BOUND
            first = slots[self._s_bound[slots] == _NEVER]
            if len(first):
                self._mark_bound_many(first, now)
            code = _BOUND
        self._ring_write(uids, code, kind, shard, solve_id, epoch, now,
                         detail)
        return True

    def _ring_write(self, uids: List[str], code: int, kind: str,
                    shard: int, solve_id: int, epoch: int, now: int,
                    detail: str) -> None:
        """Append one event a uid (same kind, ids and timestamp) to the
        ring, overwriting the oldest."""
        n = len(uids)
        cap = self._cap
        if n == 1:
            i = self._head
            self._ev_uid[i] = uids[0]
            self._ev_detail[i] = detail or None
            self._ev_kind[i] = code
            self._ev_shard[i] = shard
            self._ev_solve[i] = solve_id
            self._ev_epoch[i] = epoch
            self._ev_ts[i] = now
        else:
            keep = uids[n - cap:] if n > cap else uids
            pos = (self._head + n - len(keep)) % cap
            d = detail or None
            start = 0
            while start < len(keep):
                m = min(len(keep) - start, cap - pos)
                self._ev_uid[pos:pos + m] = keep[start:start + m]
                self._ev_detail[pos:pos + m] = [d] * m
                self._ev_kind[pos:pos + m] = code
                self._ev_shard[pos:pos + m] = shard
                self._ev_solve[pos:pos + m] = solve_id
                self._ev_epoch[pos:pos + m] = epoch
                self._ev_ts[pos:pos + m] = now
                pos = (pos + m) % cap
                start += m
        self._head = (self._head + n) % cap
        self._count += n
        self.events_total += n
        kc = self._kind_counts
        kc[kind] = kc.get(kind, 0) + n
        self._unflushed += n
        if self._unflushed >= _FLUSH_EVERY:
            self._flush_kind_counts()

    def _flush_kind_counts(self) -> None:
        """Fold the batched per-kind counts into the registry counter
        (caller holds ``_lock``); also runs on every read path so a
        scrape after a quiet spell sees fresh totals."""
        if not self._kind_counts:
            return
        inc = self._metrics_handle().journey_events.inc
        for kind, n in self._kind_counts.items():
            inc(n, kind=kind)
        self._kind_counts.clear()
        self._unflushed = 0

    def _mark_bound(self, s: int, now: int) -> None:
        """First bind of slot ``s`` (``_mark_bound_many`` of one slot,
        in scalars)."""
        self._s_bound[s] = now
        self.bound_total += 1
        ms = (now - int(self._s_enq[s])) / 1e6
        self._ttb_ms.append(ms)
        q = self._queue_of(s) or "none"
        self._queue_ttb.setdefault(q, deque(maxlen=_QUEUE_WINDOW)) \
            .append(ms)
        qc = self._queue_counts.setdefault(q, {"enqueued": 0, "bound": 0})
        qc["bound"] += 1
        metrics = self._metrics_handle()
        metrics.pod_time_to_bind.observe(ms, queue=q)
        if self.slo is not None and not self._s_synth[s]:
            for breach in self.slo.observe_sample("ttb", ms):
                if self.auditor is not None:
                    self.auditor.report(
                        Anomaly("slo-budget-exceeded", breach))
        gang = self._gang_of(s)
        g = self._gangs.get(gang) if gang else None
        if g is not None:
            g.bound += 1
            if not g.done and g.members > 0 and g.bound >= g.members:
                g.done = True
                gms = (now - g.first_enq_ns) / 1e6
                self._gang_ttfb_ms.append(gms)
                metrics.gang_time_to_full_bind.observe(gms)

    def _mark_bound_many(self, slots: np.ndarray, now: int) -> None:
        """First bind of every slot of ``slots`` (in event order): the
        time-to-bind feeds (window, per queue, histogram, the ``ttb`` SLO
        lane for non-synthetic pods) and the gangs' full-bind."""
        self._s_bound[slots] = now
        self.bound_total += len(slots)
        ms = (now - self._s_enq[slots]) / 1e6
        self._ttb_ms.extend(ms.tolist())
        metrics = self._metrics_handle()
        for q, vs in self._by_queue(slots, ms):
            self._queue_ttb.setdefault(
                q, deque(maxlen=_QUEUE_WINDOW)).extend(vs.tolist())
            qc = self._queue_counts.setdefault(
                q, {"enqueued": 0, "bound": 0})
            qc["bound"] += len(vs)
            metrics.pod_time_to_bind.observe_many(vs, queue=q)
        if self.slo is not None:
            samples = ms[~self._s_synth[slots]].tolist()
            for breach in self.slo.observe_samples("ttb", samples):
                if self.auditor is not None:
                    self.auditor.report(
                        Anomaly("slo-budget-exceeded", breach))
        gids = self._s_gang[slots]
        if not (gids >= 0).any():
            return
        # Gangs: each gang's bound count moves by its pods in the batch,
        # and a gang completes at the pod that brings it to its member
        # count -- completions are recorded in that pod order.
        pos = np.flatnonzero(gids >= 0)
        order = np.argsort(gids[pos], kind="stable")
        pos = pos[order]
        g_sorted = gids[pos]
        cut = np.flatnonzero(np.diff(g_sorted)) + 1
        starts = np.concatenate([[0], cut]).tolist()
        ends = np.concatenate([cut, [len(pos)]]).tolist()
        done_at = []
        for a, b in zip(starts, ends):
            gname = self._gnames[int(g_sorted[a])]
            g = self._gangs.get(gname)
            if g is None:
                continue
            need = g.members - g.bound
            g.bound += b - a
            if not g.done and g.members > 0 and g.bound >= g.members:
                g.done = True
                done_at.append((int(pos[a + max(need, 1) - 1]), g))
        if done_at:
            done_at.sort(key=lambda x: x[0])
            gms = [(now - g.first_enq_ns) / 1e6 for _p, g in done_at]
            self._gang_ttfb_ms.extend(gms)
            for v in gms:
                metrics.gang_time_to_full_bind.observe(v)

    # -------------------------------------------------------------- reads

    def _ring_indices(self) -> List[int]:
        if self._count < self._cap:
            return list(range(self._head))
        return list(range(self._head, self._cap)) + \
            list(range(self._head))

    def _row(self, i: int) -> dict:
        row = {
            "uid": self._ev_uid[i],
            "kind": KINDS[int(self._ev_kind[i])],
            "ts_us": round((self._anchor_ns + int(self._ev_ts[i])) / 1e3,
                           1),
        }
        if self._ev_shard[i] >= 0:
            row["shard"] = int(self._ev_shard[i])
        if self._ev_solve[i]:
            row["solve_id"] = int(self._ev_solve[i])
        if self._ev_epoch[i] >= 0:
            row["handoff_epoch"] = int(self._ev_epoch[i])
        if self._ev_detail[i]:
            row["detail"] = self._ev_detail[i]
        return row

    def trace_rows(self) -> List[dict]:
        """Chronological ring dump for the Perfetto exporter."""
        with self._lock:
            return [self._row(i) for i in self._ring_indices()]

    def timeline(self, uid: str) -> Optional[dict]:
        """One pod's event list (oldest first), summary and why-pending
        verdict.  Returns None for a pod the journey never saw."""
        with self._lock:
            s = self._slot.get(uid)
            events = [self._row(i) for i in self._ring_indices()
                      if self._ev_uid[i] == uid]
            if s is None and not events:
                return None
            body = {"uid": uid, "events": events}
            if s is not None:
                enq = int(self._s_enq[s])
                first = int(self._s_first[s])
                bound = int(self._s_bound[s])
                body.update({
                    "queue": self._queue_of(s),
                    "gang": self._gang_of(s),
                    "status": int(self._s_status[s]),
                    "enqueued_us": round((self._anchor_ns + enq) / 1e3, 1),
                    "time_to_first_consider_ms": (
                        round((first - enq) / 1e6, 3)
                        if first != _NEVER else None),
                    "time_to_bind_ms": (
                        round((bound - enq) / 1e6, 3)
                        if bound != _NEVER else None),
                    "last_kind": KINDS[int(self._s_kind[s])],
                    "monotone": bool(self._s_mono[s]),
                    "restored_from": self._restored.get(s),
                    "why_pending": self._verdict(s),
                })
            else:
                body["why_pending"] = "removed (events only)"
            return body

    def why_pending(self, uid: str) -> str:
        with self._lock:
            s = self._slot.get(uid)
            if s is None:
                return "unknown (no journey state)"
            return self._verdict(s)

    def _verdict(self, s: int) -> str:
        """Compress the recent drop-reason chain into one operator
        sentence, e.g. ``capacity-taken x4, topology-infeasible``."""
        if int(self._s_status[s]) & _BOUND_MASK:
            return "bound"
        last_kind = KINDS[int(self._s_kind[s])]
        if last_kind in ("evicted", "migration-planned"):
            return f"{last_kind} (awaiting restore)"
        # Drop evidence wins over the never-dispatched check: a pregate
        # hold (e.g. topology-infeasible) drops the pod without it ever
        # entering a solve, and THAT is the verdict, not "backlog".
        drops = self._drops.get(s)
        if not drops:
            if self._s_first[s] == _NEVER:
                return "never considered (queue backlog)"
            return "considered, no drops recorded (awaiting commit)"
        parts: List[str] = []
        run: Optional[Tuple[str, int]] = None
        n = 0
        for reason, shard in drops:
            key = (reason, shard)
            if key == run:
                n += 1
                continue
            if run is not None:
                parts.append(self._drop_phrase(run, n))
            run, n = key, 1
        if run is not None:
            parts.append(self._drop_phrase(run, n))
        return ", ".join(parts)

    @staticmethod
    def _drop_phrase(key: Tuple[str, int], n: int) -> str:
        reason, shard = key
        out = reason or "dropped"
        if n > 1:
            out += f" x{n}"
        if shard >= 0:
            out += f" on shard {shard}"
        return out

    def queue_rollup(self) -> dict:
        """Per-queue scheduling-latency rollup."""
        with self._lock:
            self._flush_kind_counts()
            out: Dict[str, dict] = {}
            for q, counts in sorted(self._queue_counts.items()):
                win = list(self._queue_ttb.get(q, ()))
                out[q] = {
                    "enqueued_total": counts["enqueued"],
                    "bound_total": counts["bound"],
                    "ttb_p50_ms": _pct(win, 0.50),
                    "ttb_p99_ms": _pct(win, 0.99),
                }
            return {
                "queues": out,
                "pods_tracked": len(self._slot),
                "gangs_tracked": len(self._gangs),
                "events_total": self.events_total,
            }

    def stats(self) -> dict:
        """Event counts, capture cost and latency percentiles."""
        with self._lock:
            self._flush_kind_counts()
            ttb = list(self._ttb_ms)
            ttfc = list(self._ttfc_ms)
            gang = list(self._gang_ttfb_ms)
            return {
                "events": self.events_total,
                "capture_ms": round(self.capture_ns / 1e6, 3),
                "events_dropped": max(self._count - self._cap, 0),
                "pods": len(self._slot),
                "bound": self.bound_total,
                "rebinds": self.rebinds,
                "reconsiders": self.reconsiders,
                "ttfc_p50_ms": _pct(ttfc, 0.50),
                "ttb_p50_ms": _pct(ttb, 0.50),
                "ttb_p95_ms": _pct(ttb, 0.95),
                "ttb_p99_ms": _pct(ttb, 0.99),
                "gang_ttfb_p50_ms": _pct(gang, 0.50),
                "gang_ttfb_p99_ms": _pct(gang, 0.99),
            }

    # ------------------------------------------------------- conservation

    def conservation_check(self, bound_uids: Iterable[str]
                           ) -> List[Anomaly]:
        """Every pod in ``bound_uids`` has a complete, orphan-free
        journey.

        - ``journey-orphan``: a bound pod with NO journey state -- some
          writer bypassed the capture seams entirely.
        - ``journey-incomplete``: state exists but the bind was never
          recorded, or the event order went non-monotone.

        Synthetic roots (``pod_resync`` adoption after a deliberate
        detach window) count as complete -- the adoption is itself the
        recorded provenance.
        """
        uids = list(bound_uids)
        with self._lock:
            get = self._slot.get
            slots = np.asarray([get(u, -1) for u in uids], np.int64)
            seen = slots >= 0
            ok = np.zeros(len(uids), bool)
            s = slots[seen]
            ok[seen] = (self._s_bound[s] != _NEVER) & self._s_mono[s]
        orphans = [uids[i] for i in np.flatnonzero(~seen).tolist()]
        incomplete = [uids[i] for i in np.flatnonzero(seen & ~ok).tolist()]
        out: List[Anomaly] = []
        if orphans:
            out.append(Anomaly("journey-orphan", {
                "count": len(orphans), "uids": orphans[:5],
            }))
        if incomplete:
            out.append(Anomaly("journey-incomplete", {
                "count": len(incomplete), "uids": incomplete[:5],
            }))
        return out
