"""Cycle flight recorder: a fixed-size ring of per-cycle records.

The scheduler's interesting behavior spans TWO cycles since the
pipelined sessions landed (dispatch in N, commit in N+1), and the only
prior visibility was ``store.last_cycle_lanes`` — last cycle only, lane
seconds only.  The flight recorder keeps the last N cycles (default
256, ``VOLCANO_TPU_FLIGHT_CYCLES``) of everything a post-hoc "why did
cycle 48231 drop 17 rows" investigation needs:

- the lane breakdown (derive/feed/encode/device/order/commit/close),
- pods considered / bound / dropped, drop counts BY REASON (the
  staleness guard's deleted / competing-bind / capacity-taken /
  constraint-sensitive / node-epoch-churn, the topology gate's
  topology-infeasible, plus the whole-result voids compaction /
  lost-reply / device-crash),
- the in-flight fetch wait (the pipeline's health signal),
- device crash / budget-degradation events,
- mirror ``mutation_seq`` / node-table ``epoch`` at dispatch vs commit
  (how much the world moved during the overlap),
- the dispatched and committed solve-ids (the cross-cycle link),
- the cycle's trace spans (``obs.trace``), and
- the runtime auditor's anomalies for the cycle (``obs.audit``).

Concurrency: the cycle thread records (holding the store lock — the
ring lock nests strictly inside it and is never taken around store
state); the HTTP ``/debug`` handlers and bench read from their own
threads.  Everything shared is guarded by ``_lock`` (vclint-checked).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

DEFAULT_CAPACITY = 256


class CycleRecord:
    """One scheduling cycle's accounting.  Plain data; built by the
    cycle thread, sealed by ``FlightRecorder.record`` (which assigns
    ``seq``), then read-only."""

    __slots__ = (
        "seq", "session", "path", "t_wall", "duration_s", "shard",
        "lanes",
        "pods_considered", "pods_bound", "pods_dropped", "drop_reasons",
        "inflight_fetch_wait_ms", "dispatched_solve_id",
        "committed_solve_id", "mutation_seq_at_dispatch",
        "mutation_seq_at_commit", "epoch_at_dispatch", "epoch_at_commit",
        "device_events", "error", "spans", "rebalance", "whatif",
        "pool", "anomalies",
    )

    def __init__(self, session: str = "", path: str = "fast",
                 t_wall: float = 0.0, duration_s: float = 0.0,
                 shard: Optional[int] = None,
                 lanes: Optional[Dict[str, float]] = None,
                 pods_considered: int = 0, pods_bound: int = 0,
                 pods_dropped: int = 0,
                 drop_reasons: Optional[Dict[str, int]] = None,
                 inflight_fetch_wait_ms: Optional[float] = None,
                 dispatched_solve_id: Optional[int] = None,
                 committed_solve_id: Optional[int] = None,
                 mutation_seq_at_dispatch: Optional[int] = None,
                 mutation_seq_at_commit: Optional[int] = None,
                 epoch_at_dispatch: Optional[int] = None,
                 epoch_at_commit: Optional[int] = None,
                 device_events: Optional[List[str]] = None,
                 error: Optional[str] = None,
                 spans: Optional[list] = None,
                 rebalance: Optional[dict] = None,
                 whatif: Optional[dict] = None,
                 pool: Optional[dict] = None,
                 anomalies: Optional[List[dict]] = None):
        self.seq = -1  # assigned by FlightRecorder.record
        self.session = session
        self.path = path
        self.t_wall = t_wall
        self.duration_s = duration_s
        # The recording shard's index under VOLCANO_TPU_SHARDS>1, None
        # on the single-scheduler path.  The store's ONE recorder is
        # shared by every shard's cycle thread (the ring lock
        # serializes them), so /debug/cycles and /debug/trace already
        # aggregate all shards — the tag says who recorded what.
        self.shard = shard
        self.lanes = lanes or {}
        self.pods_considered = pods_considered
        self.pods_bound = pods_bound
        self.pods_dropped = pods_dropped
        self.drop_reasons = drop_reasons or {}
        self.inflight_fetch_wait_ms = inflight_fetch_wait_ms
        self.dispatched_solve_id = dispatched_solve_id
        self.committed_solve_id = committed_solve_id
        self.mutation_seq_at_dispatch = mutation_seq_at_dispatch
        self.mutation_seq_at_commit = mutation_seq_at_commit
        self.epoch_at_dispatch = epoch_at_dispatch
        self.epoch_at_commit = epoch_at_commit
        self.device_events = device_events or []
        self.error = error
        self.spans = spans or []
        # Rebalance lane accounting for the cycle, when the lane ran:
        # outcome, gang uid, need, drain/victim counts, frag score
        # (fastpath.FastCycle._rebalance).  None when the lane was idle.
        self.rebalance = rebalance
        # Device-native preempt/reclaim plan accounting (whatif.py):
        # action, outcome, gang uid, victim counts.  None when neither
        # lane planned anything.
        self.whatif = whatif
        # Solver-pool fetch accounting for the cycle (the JAX package's
        # solver_pool.py): winning replica, hedge / failover flags,
        # residual wait.  None for local-solver stores, the only kind
        # the port runs.
        self.pool = pool
        # Runtime-auditor findings for THIS cycle (obs/audit.py,
        # Anomaly.to_dict): empty on a healthy cycle.
        self.anomalies = anomalies or []

    def to_dict(self, include_spans: bool = False) -> dict:
        d = {
            "seq": self.seq,
            "session": self.session,
            "path": self.path,
            "t_wall": self.t_wall,
            "shard": self.shard,
            "duration_ms": round(self.duration_s * 1e3, 3),
            "lanes_ms": {
                k: round(v * 1e3, 3) for k, v in self.lanes.items()
            },
            "pods_considered": self.pods_considered,
            "pods_bound": self.pods_bound,
            "pods_dropped": self.pods_dropped,
            "drop_reasons": dict(self.drop_reasons),
            "inflight_fetch_wait_ms": self.inflight_fetch_wait_ms,
            "dispatched_solve_id": self.dispatched_solve_id,
            "committed_solve_id": self.committed_solve_id,
            "mutation_seq_at_dispatch": self.mutation_seq_at_dispatch,
            "mutation_seq_at_commit": self.mutation_seq_at_commit,
            "epoch_at_dispatch": self.epoch_at_dispatch,
            "epoch_at_commit": self.epoch_at_commit,
            "device_events": list(self.device_events),
            "error": self.error,
            "rebalance": (dict(self.rebalance)
                          if self.rebalance is not None else None),
            "whatif": (dict(self.whatif)
                       if self.whatif is not None else None),
            "pool": (dict(self.pool)
                     if self.pool is not None else None),
            "anomalies": [dict(a) for a in self.anomalies],
        }
        if include_spans:
            d["spans"] = [s.to_dict() for s in self.spans]
        return d


class FlightRecorder:
    """Fixed-size ring of the most recent ``capacity`` CycleRecords."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    "VOLCANO_TPU_FLIGHT_CYCLES", DEFAULT_CAPACITY))
            except ValueError:
                capacity = DEFAULT_CAPACITY
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._ring: List[CycleRecord] = []  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock

    def record(self, rec: CycleRecord) -> int:
        """Seal + append a cycle record; returns its assigned seq."""
        with self._lock:
            self._seq += 1
            rec.seq = self._seq
            self._ring.append(rec)
            if len(self._ring) > self.capacity:
                del self._ring[0]
            return rec.seq

    def recent(self, n: Optional[int] = None) -> List[CycleRecord]:
        """The most recent ``n`` records (all retained when None,
        none when ``n <= 0``), oldest first."""
        with self._lock:
            ring = list(self._ring)
        if n is None:
            return ring
        n = int(n)
        return ring[-n:] if n > 0 else []

    def get(self, seq: int) -> Optional[CycleRecord]:
        with self._lock:
            for rec in reversed(self._ring):
                if rec.seq == seq:
                    return rec
        return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def last(self) -> Optional[CycleRecord]:
        with self._lock:
            return self._ring[-1] if self._ring else None
