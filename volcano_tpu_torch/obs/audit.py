"""Runtime conservation auditor: always-on correctness observation.

The counterpart of the JAX package's ``obs/audit.py``, unchanged in
behaviour.  The flight recorder and the metrics registry observe
*latency*; this module observes *correctness* while the scheduler runs.
The store carries state a long-running deployment can silently corrupt
(the cycle's keyed cache slots, the device-incremental skip tokens, the
migration ledger), and a corruption only a from-scratch rebuild would
notice is one production never notices.  Three mechanisms, all cheap
enough to stay on:

1. **Conservation ledger** (``ConservationLedger``): an append-only
   double-entry record of pod-count flows.  Every writer of the mirror's
   dynamic pod state declares its transition (pending -> bound at commit,
   bound -> pending on unbind or revert, running -> releasing on evict,
   added / deleted at the store edge, restore re-adds from the migration
   ledger); each entry debits one status class and credits another.  At
   cycle end the auditor reconciles the declared net flow against an
   independent census of the mirror (one bincount over the host
   ``p_status`` / ``p_alive``), so a lost or duplicated pod surfaces as a
   ``conservation-mismatch`` anomaly within ONE cycle.  A cycle with no
   flows and an unmoved ``mutation_seq`` skips the census (the null-delta
   idle case), except on sampled cycles, which force it.

2. **Coherence samples**: spot-checks of the keyed cache slots against
   from-scratch truth at a sample rate (``VOLCANO_TPU_AUDIT_SAMPLE``,
   default one audited cycle in 64): the persistent ``CycleAggregates``
   planes re-verify against ``_build_aggregates``
   (``aggregate-divergence``); the encode cache and the devincr static
   planes are guarded by content sentinels -- a strided signature that
   must hold still while the slot's key holds still
   (``cache-content-mutated``); every migration-ledger entry whose victim
   is gone must carry its restore (``ledger-restore-lost``, the
   zero-lost-pods contract).  A sentinel hashes host numpy arrays only: a
   ``torch.Tensor`` (the devincr planes live on the card) is signed by
   its type name and shape and never copied to the host, so a sampled
   cycle adds no device-to-host copy.  The remote solver's wire mirror
   (``wire-mirror-divergence``) and the shard census
   (``shard-ownership-violation``) are audited when the store has those
   slots; the port's store has neither yet, so both return at once.

3. **SLO feed**: the auditor drives ``obs.slo.SLOTracker`` with each
   cycle's lane latencies and turns burn-rate breaches into
   ``slo-budget-exceeded`` anomalies (at the breach edge).

Anomalies land in a bounded ring, in the cycle's flight-recorder record
(``CycleRecord.anomalies``, exported as Perfetto instants) and in
``volcano_audit_anomalies_total``.  The reason catalog is
docs/observability.md.

Threading: flow recording and ``end_cycle`` run on the cycle thread under
the store lock (never on the solve worker); readers take only the
auditor's own ``_lock``, which is never held around store state.

Stdlib-only at module scope (numpy is imported inside the functions that
read mirror arrays), like the rest of ``obs/``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# Virtual status classes for the double-entry ledger's store edge: a
# pod appearing debits ADDED, a pod leaving credits GONE.  Real classes
# are the raw TaskStatus ints (opaque to this module).
ADDED = -1
GONE = -2

# Census width: raw status values are clipped into [0, CENSUS_W).
# TaskStatus values are BIT FLAGS up to 1 << 9 = 512 (api/types.py), so
# the width must clear 512; 1024 leaves headroom plus an aliasing bucket
# that would itself show up as a mismatch.  (A narrower width would alias
# Releasing (1 << 6) into the clip bucket while the declared flow keeps
# the raw class: a phantom mismatch every cycle ending with an evicted
# pod still in its grace window.)
CENSUS_W = 1024

DEFAULT_SAMPLE = 64
DEFAULT_RING = 256
DEFAULT_LEDGER_ENTRIES = 4096


def audit_on() -> bool:
    return os.environ.get("VOLCANO_TPU_AUDIT", "1") != "0"


def sample_rate() -> int:
    try:
        return max(int(os.environ.get("VOLCANO_TPU_AUDIT_SAMPLE",
                                      DEFAULT_SAMPLE)), 1)
    except ValueError:
        return DEFAULT_SAMPLE


class Anomaly:
    """One detected invariant violation.  ``reason`` is a catalogued
    string (docs/observability.md); ``detail`` is a small JSON-safe
    dict."""

    __slots__ = ("reason", "detail", "t_wall", "cycle_seq")

    def __init__(self, reason: str, detail: Optional[dict] = None,
                 cycle_seq: Optional[int] = None):
        self.reason = reason
        self.detail = detail or {}
        self.t_wall = time.time()
        self.cycle_seq = cycle_seq

    def to_dict(self) -> dict:
        return {
            "reason": self.reason,
            "detail": dict(self.detail),
            "t_wall": self.t_wall,
            "cycle_seq": self.cycle_seq,
        }


class ConservationLedger:
    """Append-only double-entry record of declared pod-count flows.

    Writers call ``flow`` under the store lock; the auditor serializes
    access with its own lock (see Auditor).  ``net`` accumulates the
    per-class delta since the last reconcile; ``entries`` keeps the
    most recent transitions for post-hoc inspection; ``totals`` counts
    rows per flow reason forever (monotonic, like a counter series)."""

    __slots__ = ("net", "entries", "totals")

    def __init__(self, max_entries: int = DEFAULT_LEDGER_ENTRIES):
        self.net: Dict[int, int] = {}
        self.entries: deque = deque(maxlen=max_entries)
        self.totals: Dict[str, int] = {}

    def record(self, reason: str, src: int, dst: int, n: int) -> None:
        if n <= 0 or src == dst:
            return
        self.net[src] = self.net.get(src, 0) - n
        self.net[dst] = self.net.get(dst, 0) + n
        self.entries.append((reason, src, dst, n))
        self.totals[reason] = self.totals.get(reason, 0) + n

    def reset_net(self) -> None:
        self.net = {}


class _Sentinel:
    """Content sentinel over one registered cache slot: while the
    slot's cache key holds still, a strided signature of its array
    content must hold still too (an in-place mutation of cached planes
    is exactly the corruption the cache keys cannot see)."""

    __slots__ = ("key", "sig")

    def __init__(self):
        self.key = None
        self.sig = None


def _content_sig(arrays) -> int:
    """Strided content signature over a list of numpy arrays -- samples
    at most ~4096 elements per array so a 100k-row plane costs
    microseconds, not a full pass.  Anything else (a ``torch.Tensor`` on
    the CPU or the card, a scalar) is signed by its type name and shape
    only: hashing a device tensor's bytes would add a device-to-host copy
    to every sampled cycle."""
    import numpy as np
    import zlib

    sig = 0
    for a in arrays:
        if a is None:
            sig = zlib.crc32(b"\x00", sig)
            continue
        if not isinstance(a, np.ndarray):
            # Tensors / scalars: type and shape only (never .cpu()'d).
            sig = zlib.crc32(str((type(a).__name__, getattr(
                a, "shape", None))).encode(), sig)
            continue
        flat = a.reshape(-1)
        stride = max(1, len(flat) // 4096)
        sample = np.ascontiguousarray(flat[::stride])
        sig = zlib.crc32(sample.tobytes(), sig)
        sig = zlib.crc32(str((a.shape, a.dtype.str)).encode(), sig)
    return sig


class Auditor:
    """Per-store runtime auditor; one instance per ``ClusterStore``.

    Writers (store lock held) record flows; ``end_cycle`` (cycle
    thread, store lock held) reconciles and samples; readers take
    snapshots.  All shared state below is guarded by
    ``_lock`` — the lock is never held around store/mirror access from
    the read side, so a slow scrape cannot stall the cycle."""

    def __init__(self, sample: Optional[int] = None,
                 ring_capacity: int = DEFAULT_RING,
                 enabled: Optional[bool] = None):
        self.enabled = audit_on() if enabled is None else bool(enabled)
        self.sample = sample_rate() if sample is None else max(int(sample), 1)
        self._lock = threading.Lock()
        self.ledger = ConservationLedger()  # guarded-by: _lock
        self._ring: deque = deque(maxlen=ring_capacity)  # guarded-by: _lock
        self.anomaly_counts: Dict[str, int] = {}  # guarded-by: _lock
        # Census anchor: per-class pod counts at the last reconcile
        # (None until the first), plus the mutation_seq observed then.
        self._census = None  # guarded-by: _lock
        self._census_mut = None  # guarded-by: _lock
        self._reanchor_reason: Optional[str] = None  # guarded-by: _lock
        # Cache sentinels by slot name.  # guarded-by: _lock
        self._sentinels: Dict[str, _Sentinel] = {}
        # Anomalies found mid-cycle (the derive-time aggregate audit),
        # drained into the cycle's end_cycle batch.  # guarded-by: _lock
        self._pending: List[Anomaly] = []
        # id() of the remote-solver client each wire sentinel slot
        # ("wire-mirror" single client, "wire-mirror-<i>" pool
        # replicas) last audited: a replaced client restarts its
        # generation, which must re-anchor, not read as a
        # regression.  # guarded-by: _lock
        self._wire_client: Dict[str, int] = {}
        # Accounting for audit_stats() / health().
        self.cycles = 0  # guarded-by: _lock
        self.sampled_cycles = 0  # guarded-by: _lock
        self.reconciles = 0  # guarded-by: _lock
        self.census_skips = 0  # guarded-by: _lock
        self.overhead_ns = 0  # guarded-by: _lock
        self.overhead_max_ns = 0  # guarded-by: _lock
        # SLO tracker (obs/slo.py), attached by the store; internally
        # synchronized, so reads need no auditor lock.
        self.slo = None

    # -------------------------------------------------------------- flows

    def flow(self, reason: str, src: int, dst: int, n: int = 1) -> None:
        """Declare ``n`` pods transitioning ``src`` -> ``dst`` status
        classes (raw TaskStatus ints, or ADDED/GONE at the store edge)."""
        if not self.enabled:
            return
        with self._lock:
            self.ledger.record(reason, src, dst, n)

    def flow_added(self, status: int, reason: str = "pod-added") -> None:
        self.flow(reason, ADDED, status)

    def flow_removed(self, status: int,
                     reason: str = "pod-deleted") -> None:
        self.flow(reason, status, GONE)

    def flow_rows(self, p_status, rows, new_status: int,
                  reason: str) -> None:
        """Bulk transition declaration for the fast path's vectorized
        status writes: call with the OLD ``p_status`` column (before
        the write), the row index array, and the uniform new status."""
        if not self.enabled or not len(rows):
            return
        import numpy as np

        old = np.clip(p_status[rows].astype(np.int64), 0, CENSUS_W - 1)
        vals, counts = np.unique(old, return_counts=True)
        with self._lock:
            for v, c in zip(vals.tolist(), counts.tolist()):
                self.ledger.record(reason, int(v), int(new_status),
                                   int(c))

    def sampling_now(self) -> bool:
        """True when the cycle currently running will be sampled at its
        ``end_cycle`` — lets in-cycle audit hooks (the derive-time
        aggregate verify) share the same amortization schedule."""
        if not self.enabled:
            return False
        with self._lock:
            return (self.cycles + 1) % self.sample == 0

    def audit_aggregates_now(self, m) -> None:
        """Derive-time coherence audit of the persistent
        ``CycleAggregates`` planes — must run right after
        ``CycleAggregates.refresh``, the one point where the planes
        equal mirror truth by construction (by cycle end they
        legitimately lag the cycle's own commits until the next
        derive reconciles them)."""
        if not self.sampling_now():
            return
        t0 = time.perf_counter_ns()
        found: List[Anomaly] = []
        try:
            self._audit_aggregates(m, found)
        except Exception as e:
            found.append(Anomaly("audit-error", {
                "error": type(e).__name__, "message": str(e)[:200],
            }))
        dt = time.perf_counter_ns() - t0
        with self._lock:
            self.overhead_ns += dt
            if dt > self.overhead_max_ns:
                self.overhead_max_ns = dt
            if found:
                self._pending.extend(found)

    def report(self, anomaly: Anomaly) -> None:
        """Out-of-band anomaly intake (the journey's time-to-bind SLO
        breaches): thread-safe, lands in the same ring and counters the
        cycle-end audits feed, bypassing ``enabled`` and sampling -- the
        reporter has its own kill switch."""
        with self._lock:
            self._ring.append(anomaly)
            self.anomaly_counts[anomaly.reason] = (
                self.anomaly_counts.get(anomaly.reason, 0) + 1)
        from ..metrics import metrics

        metrics.audit_anomalies.inc(reason=anomaly.reason)

    def reanchor(self, why: str) -> None:
        """Void the next reconcile (bulk resync: the declared-flow
        model can no longer match; re-anchor the census instead of
        reporting a phantom mismatch)."""
        if not self.enabled:
            return
        with self._lock:
            self._reanchor_reason = why

    def set_enabled(self, flag: bool) -> None:
        """Flip the auditor at runtime (the overhead A/B).
        Re-enabling re-anchors: mutations while disabled recorded no
        flows, so the first reconcile back must not compare."""
        flag = bool(flag)
        if flag and not self.enabled:
            self.enabled = True
            self.reanchor("re-enabled")
        else:
            self.enabled = flag

    # -------------------------------------------------------------- cycle

    def end_cycle(self, cyc, duration_s: float,
                  err: Optional[BaseException] = None) -> List[Anomaly]:
        """Run the cycle-end audits; returns (and retains) anomalies.
        Called by the cycle thread with the store lock held."""
        if not self.enabled:
            return []
        t0 = time.perf_counter_ns()
        with self._lock:
            self.cycles += 1
            n_cycle = self.cycles
        sampled = (n_cycle % self.sample == 0)
        with self._lock:
            anomalies: List[Anomaly] = self._pending
            self._pending = []
        mode = "reconciled"
        try:
            mode = self._reconcile(cyc.store, cyc.m, anomalies,
                                   force=sampled, failed=err is not None)
            self._audit_ledger(cyc.store, anomalies)
            self._audit_shards(cyc.store, anomalies)
            if sampled:
                self._audit_encode_cache(cyc.store, anomalies)
                self._audit_devincr(cyc.store, anomalies)
                self._audit_wire(cyc.store, anomalies)
            if self.slo is not None:
                idle = cyc.stats.get("dispatched_solve_id") is None
                for breach in self.slo.observe(duration_s, cyc.lanes,
                                               idle=idle):
                    anomalies.append(Anomaly(
                        "slo-budget-exceeded", breach))
        except Exception as e:  # the auditor must never fail the cycle
            anomalies.append(Anomaly("audit-error", {
                "error": type(e).__name__, "message": str(e)[:200],
            }))
        dt = time.perf_counter_ns() - t0
        with self._lock:
            if sampled:
                self.sampled_cycles += 1
            self.overhead_ns += dt
            if dt > self.overhead_max_ns:
                self.overhead_max_ns = dt
            for a in anomalies:
                self._ring.append(a)
                self.anomaly_counts[a.reason] = (
                    self.anomaly_counts.get(a.reason, 0) + 1)
        from ..metrics import metrics

        metrics.audit_cycles.inc(
            mode="sampled" if sampled else mode)
        for a in anomalies:
            metrics.audit_anomalies.inc(reason=a.reason)
        return anomalies

    # -------------------------------------------------- conservation audit

    def _census_now(self, m):
        import numpy as np

        Pn = len(m.p_uid)
        alive = m.p_alive[:Pn]
        st = m.p_status[:Pn][alive]
        return np.bincount(
            np.clip(st.astype(np.int64), 0, CENSUS_W - 1),
            minlength=CENSUS_W,
        )

    def _reconcile(self, store, m, anomalies: List[Anomaly],
                   force: bool, failed: bool) -> str:
        import numpy as np

        with self._lock:
            net = dict(self.ledger.net)
            anchor = self._census
            anchor_mut = self._census_mut
            reanchor = self._reanchor_reason
        mut = m.mutation_seq
        if (anchor is not None and reanchor is None and not net
                and mut == anchor_mut and not force and not failed):
            # Nothing declared, nothing stamped: the census cannot have
            # moved unless a writer bypassed BOTH bookkeeping layers —
            # the sampled cycles still force the census, bounding that
            # detection latency to one sample interval.
            with self._lock:
                self.census_skips += 1
            return "skipped"
        census = self._census_now(m)
        if anchor is not None and reanchor is None and not failed:
            expected = anchor.copy()
            for cls, d in net.items():
                if 0 <= cls < CENSUS_W:
                    expected[cls] += d
            if not np.array_equal(expected, census):
                diff = {}
                for cls in np.flatnonzero(expected != census).tolist():
                    diff[str(cls)] = {
                        "expected": int(expected[cls]),
                        "actual": int(census[cls]),
                    }
                anomalies.append(Anomaly("conservation-mismatch", {
                    "classes": diff,
                    "flows": {k: int(v) for k, v in net.items()},
                }))
        with self._lock:
            self._census = census
            self._census_mut = mut
            self._reanchor_reason = None
            self.ledger.reset_net()
            self.reconciles += 1
        return "reconciled"

    # ------------------------------------------------------- ledger audit

    def _audit_ledger(self, store, anomalies: List[Anomaly]) -> None:
        """Zero-lost-pods: every migration entry whose victim pod is
        gone must have produced its restore (actions/rebalance.py
        ``MigrationLedger.pod_deleted``); an entry stranded without one
        is a pod the eviction machinery lost."""
        ledger = getattr(store, "migrations", None)
        if ledger is None:
            return
        for uid, entry in list(ledger.entries.items()):
            if uid not in store.pods and entry.restored_uid is None:
                anomalies.append(Anomaly("ledger-restore-lost", {
                    "victim": uid,
                    "group": entry.group_uid,
                    "action": entry.action,
                }))

    # ---------------------------------------------------- cross-shard census

    def _audit_shards(self, store, anomalies: List[Anomaly]) -> None:
        """Sharded-control-plane ownership census: every queue must
        resolve to exactly one IN-RANGE owning shard (a steal override
        naming a shard outside [0, n_shards) would orphan its queue,
        which the conservation reconcile cannot see).  The port's store
        has no shard table yet (ROADMAP.md, queue 1: the sharded control
        plane): returns at once."""
        table = getattr(store, "shard_table", None)
        if table is None:
            return
        n = table.n_shards
        bad = {
            name: int(owner)
            for name, owner in table._overrides.items()
            if not 0 <= int(owner) < n
        }
        if bad:
            anomalies.append(Anomaly("shard-ownership-violation", {
                "n_shards": n,
                "overrides": bad,
            }))

    # -------------------------------------------------- coherence samples

    def _audit_aggregates(self, m, anomalies: List[Anomaly]) -> None:
        """Sampled re-verify of the persistent CycleAggregates planes
        against a from-scratch ``_build_aggregates`` — the same check
        ``VOLCANO_TPU_INCR_VERIFY=1`` runs every delta derive, here
        amortized to the sample rate and always on."""
        aggr = getattr(m, "_cycle_aggr", None)
        if aggr is None or aggr.n_used is None:
            return
        Pn, Nn = len(m.p_uid), len(m.n_name)
        R = aggr.n_used.shape[1]
        if aggr.key != (m.node_liveness_gen, m.compact_gen, Nn, R) \
                or aggr.Pn != Pn:
            # Planes are stale by key (next derive rebuilds them):
            # nothing coherent to check against.
            return
        try:
            aggr._verify(m, Pn, Nn, R, m.n_alive[:Nn])
        except AssertionError as e:
            anomalies.append(Anomaly("aggregate-divergence", {
                "message": str(e)[:200],
            }))

    def _sentinel_check(self, slot: str, key, arrays,
                        monotonic_key: bool = False) -> Optional[dict]:
        """Advance one slot's sentinel; returns a violation detail dict
        (the caller wraps it in the slot's catalogued Anomaly reason)
        or None when the contract held."""
        with self._lock:
            s = self._sentinels.get(slot)
            if s is None:
                s = self._sentinels[slot] = _Sentinel()
            prev_key, prev_sig = s.key, s.sig
        detail = None
        if monotonic_key and prev_key is not None and key is not None \
                and key < prev_key:
            detail = {
                "slot": slot, "kind": "key-regressed",
                "prev": str(prev_key), "now": str(key),
            }
            sig = _content_sig(arrays) if arrays is not None else None
        elif key is not None and key == prev_key:
            sig = _content_sig(arrays) if arrays is not None else None
            if prev_sig is not None and sig is not None \
                    and sig != prev_sig:
                detail = {
                    "slot": slot, "kind": "content-changed-under-key",
                    "key": str(key),
                }
        else:
            sig = _content_sig(arrays) if arrays is not None else None
        with self._lock:
            s.key = key
            s.sig = sig
        return detail

    def _audit_encode_cache(self, store,
                            anomalies: List[Anomaly]) -> None:
        cached = getattr(store, "_encode_cache", None)
        if not cached:
            with self._lock:
                self._sentinels.pop("encode", None)
            return
        arrays = [cached.get("task_rows"), cached.get("pid"),
                  cached.get("term_key")]
        arrays.extend(cached.get("members") or [])
        detail = self._sentinel_check(
            "encode", (cached.get("key"), cached.get("gen")), arrays)
        if detail is not None:
            anomalies.append(Anomaly("cache-content-mutated", detail))

    def _audit_devincr(self, store, anomalies: List[Anomaly]) -> None:
        dvc = getattr(store, "_devincr_cache", None)
        if dvc is None or dvc._static is None:
            with self._lock:
                self._sentinels.pop("devincr-static", None)
            return
        detail = self._sentinel_check(
            "devincr-static", dvc._static_key, list(dvc._static))
        if detail is not None:
            anomalies.append(Anomaly("cache-content-mutated", detail))

    def _audit_wire(self, store, anomalies: List[Anomaly]) -> None:
        """Client-side wire-mirror invariants of a remote solver: the
        frame generation only ever grows, and the private mirror copies
        may only change when the generation does.  A solver pool is
        audited per replica (sentinel slot ``wire-mirror-<i>``).  The
        port's store has no remote solver yet (ROADMAP.md, queue 1: the
        solver service): ``remote_solver`` is None and this returns at
        once."""
        client = getattr(store, "remote_solver", None)
        if client is None:
            with self._lock:
                for slot in [s for s in self._sentinels
                             if s.startswith("wire-mirror")]:
                    self._sentinels.pop(slot, None)
                self._wire_client.clear()
            return
        replicas = getattr(client, "replicas", None)
        if replicas is not None:
            for r in replicas:
                self._audit_wire_client(
                    r.client, f"wire-mirror-{r.index}", anomalies,
                    replica=r.index)
            return
        self._audit_wire_client(client, "wire-mirror", anomalies)

    def _audit_wire_client(self, client, slot: str,
                           anomalies: List[Anomaly],
                           replica: Optional[int] = None) -> None:
        if getattr(client, "_wire", None) is None:
            with self._lock:
                self._sentinels.pop(slot, None)
                self._wire_client.pop(slot, None)
            return
        with self._lock:
            if self._wire_client.get(slot) != id(client):
                # A replaced client (solver failover, endpoint
                # reconfiguration) legitimately restarts its
                # generation at 0 — re-anchor, don't report a
                # regression that never happened.
                self._sentinels.pop(slot, None)
                self._wire_client[slot] = id(client)
        w = client._wire
        arrays = w.arrays if w.arrays is not None else None
        detail = self._sentinel_check(
            slot, int(client._gen), arrays, monotonic_key=True)
        if detail is not None:
            if replica is not None:
                detail["replica"] = replica
            anomalies.append(Anomaly("wire-mirror-divergence", detail))

    # ------------------------------------------------------------- reads

    def anomalies(self, n: Optional[int] = None) -> List[Anomaly]:
        with self._lock:
            ring = list(self._ring)
        if n is None:
            return ring
        n = int(n)
        return ring[-n:] if n > 0 else []

    def total_anomalies(self) -> int:
        with self._lock:
            return sum(self.anomaly_counts.values())

    def audit_stats(self) -> dict:
        """Sampled cycles and measured overhead (``overhead_ns`` exact,
        ``overhead_ms`` rounded)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "sample_every": self.sample,
                "cycles": self.cycles,
                "sampled_cycles": self.sampled_cycles,
                "reconciles": self.reconciles,
                "census_skips": self.census_skips,
                "overhead_ns": self.overhead_ns,
                "overhead_ms": round(self.overhead_ns / 1e6, 3),
                "overhead_max_ms": round(self.overhead_max_ns / 1e6, 3),
                "anomalies": sum(self.anomaly_counts.values()),
            }

    def health(self) -> dict:
        """Audit verdict, armed verifiers, SLO state, anomaly summary.
        Reads only auditor and SLO state under their own locks -- never
        the store lock, so a reader never blocks the cycle thread."""
        with self._lock:
            counts = dict(self.anomaly_counts)
            last = self._ring[-1].to_dict() if self._ring else None
            stats = {
                "enabled": self.enabled,
                "sample_every": self.sample,
                "cycles": self.cycles,
                "sampled_cycles": self.sampled_cycles,
                "reconciles": self.reconciles,
                "census_skips": self.census_skips,
                "overhead_ms": round(self.overhead_ns / 1e6, 3),
            }
            flow_totals = dict(self.ledger.totals)
        n_anom = sum(counts.values())
        body = {
            "status": "ok" if n_anom == 0 else "anomalous",
            "anomalies_total": n_anom,
            "anomalies_by_reason": counts,
            "last_anomaly": last,
            "audit": stats,
            "flow_totals": flow_totals,
            "verifiers": armed_verifiers(),
        }
        if self.slo is not None:
            body["slo"] = self.slo.snapshot()
        return body


def armed_verifiers() -> Dict[str, object]:
    """Which runtime verification layers are armed right now: the
    all-or-nothing ``VOLCANO_TPU_INCR_VERIFY`` knob against the always-on
    sampled audits of this module."""
    return {
        "host_incr_verify": os.environ.get(
            "VOLCANO_TPU_INCR_VERIFY", "0") == "1",
        "audit": audit_on(),
        "audit_sample_every": sample_rate(),
    }
