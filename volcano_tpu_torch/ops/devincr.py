"""Device-lane incrementality: cross-solve plane reuse + warm shortlists.

The counterpart of the JAX package's ``ops/devincr.py``: the device analog
of ``fastpath_incr`` -- the same subtract-old/add-new discipline, applied
to the two-phase solve's coarse machinery.  Three pieces, all bit-for-bit
equal to a fresh solve, with a proven fallback and the
``VOLCANO_TPU_DEVINCR`` kill switch:

1. **Persistent static planes** -- kernel ``static_planes``
   (``ops/kernels.py``) produces the [U, C] per-(profile x class)
   feasibility/score planes once; they stay on the device here, keyed on
   (class-table content sig, profile content generation, epoch-relevant
   bits), and pass into ``solve_wave`` as given planes -- steady-state
   solves skip static evaluation entirely, in the coarse pass and per
   wave.  Any key component moving rebuilds them wholesale.

2. **Warm-started shortlists** -- the coarse pass keeps per-block
   (score, global node id) candidate lists ([U, B, klb], kernel
   ``coarse_shortlist`` with ``n_blocks``); on the next solve only blocks
   holding a dirty node row re-rank (kernel ``warm_shortlist``) and the
   winners merge exactly like the full pass.  The caller proves the dirty
   superset via ``begin_solve``; anything it cannot prove re-ranks fully,
   and the fine phase's full-N fallback still guarantees no binding is
   lost to pruning.

3. **Null-delta fast cycles** -- ``skip_token`` (written by the fast path
   at dispatch) proves a later cycle's solve would see bit-equal inputs
   and produce the identical (empty) outcome, so the cycle skips it.

Cached planes and candidates are never handed to a kernel that writes
them: ``warm_shortlist`` returns new candidate tensors.  A solver child
(``solver_service.py``) keeps one context per connection, keyed by the
token dict the scheduler's frame carries (``FastCycle._devincr_prepare``).
The JAX package's mesh placements are not ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import affkernels, kernels


def devincr_on() -> bool:
    """The device-incremental kill switch (read per call)."""
    return os.environ.get("VOLCANO_TPU_DEVINCR", "1") != "0"


def _pow2_knob(name: str, default: int) -> int:
    """The environment knob ``name`` rounded down to a power of two (read
    per call); a value that does not parse gives ``default``."""
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        v = default
    p = 1
    while p * 2 <= max(1, v):
        p *= 2
    return p


def warm_blocks() -> int:
    """Node-axis block count of the warm-shortlist candidates
    (``VOLCANO_TPU_WARM_BLOCKS``, default 16, a power of two)."""
    return _pow2_knob("VOLCANO_TPU_WARM_BLOCKS", 16)


def warm_block_rows() -> int:
    """The most node rows a warm block holds before the block count
    grows instead (``VOLCANO_TPU_WARM_BLOCK_ROWS``, default 8,192, a power
    of two): one dirty node then re-ranks a bounded number of rows."""
    return _pow2_knob("VOLCANO_TPU_WARM_BLOCK_ROWS", 8192)


# Past this fraction of blocks dirty, a full re-rank beats the warm pass
# (and seeds fresh candidates anyway).
WARM_MAX_BLOCK_FRACTION = 0.5


def block_geometry(N: int, sl_k: int) -> Tuple[int, int, int]:
    """(B, nlb, klb) of the warm candidates for an N-row node axis."""
    B = warm_blocks()
    max_rows = warm_block_rows()
    while N % (B * 2) == 0 and N // B > max_rows:
        B *= 2
    B = min(B, N)
    while N % B:
        B //= 2
    B = max(B, 1)
    nlb = N // B
    return B, nlb, min(sl_k, nlb)


class DeviceIncremental:
    """Persistent device-side caches for one solve stream (one per
    store).  Accessed on the cycle thread under the store lock."""

    def __init__(self):
        self._static_key = None
        self._static: Optional[Tuple] = None  # (ok [U,C], score [U,C])
        self._warm_key = None
        self._cand: Optional[Tuple] = None  # (cand_s, cand_i, sl)
        # Host info for the CURRENT solve (begin_solve).
        self._pend_static = None
        self._pend_warm = None
        self._pend_dirty: Optional[np.ndarray] = None
        # Node rows whose derive-visible dynamic state changed since the
        # previous solve's inputs were built; None = poisoned (a full
        # derive ran, or nothing accumulated yet).
        self._acc_dirty: Optional[list] = None
        self._dirty_consumed = False
        # Solve-input token captured at the previous dispatch (the
        # null-delta skip proof).
        self.skip_token = None
        # Telemetry.
        self.last_mode = "off"  # warm | full | off (per solve)
        self.last_static = "off"  # hit | build | off
        self.last_blocks = (0, 0)  # (dirty blocks, total blocks)
        self.counts = {"warm": 0, "full": 0, "skip": 0}
        self.static_hits = 0
        self.static_builds = 0

    # ------------------------------------------------- host-side state

    def accumulate_dirty(self, nodes: Optional[np.ndarray]) -> None:
        """Fold one derive's changed-node capture into the accumulator.
        ``None`` poisons it -- the next solve re-ranks fully."""
        if nodes is None:
            self._acc_dirty = None
            return
        if self._acc_dirty is None:
            return
        if len(nodes):
            self._acc_dirty.append(np.asarray(nodes, np.int64))

    def take_dirty(self, extra: Optional[np.ndarray]):
        """The dirty-node superset for the solve being dispatched, or None
        when unprovable.  The accumulator reset is deferred to
        ``end_solve``: a solve that fails before its shortlist ran must
        not consume the set."""
        self._dirty_consumed = True
        acc = self._acc_dirty
        if acc is None or extra is None:
            return None
        parts = acc + [np.asarray(extra, np.int64)]
        cat = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        cat = cat[cat >= 0]
        return np.unique(cat)

    def begin_solve(self, static_key, warm_key,
                    dirty_nodes: Optional[np.ndarray]) -> None:
        """Validity info for the next ``solve_wave`` call."""
        self._pend_static = static_key
        self._pend_warm = warm_key
        self._pend_dirty = (None if dirty_nodes is None
                            else np.asarray(dirty_nodes, np.int64))

    def invalidate(self) -> None:
        """Drop every cached plane and proof (a device crash): the next
        solve recomputes in full on fresh buffers."""
        self._static_key = None
        self._static = None
        self._warm_key = None
        self._cand = None
        self.skip_token = None
        self._dirty_consumed = False
        self.end_solve()
        self._acc_dirty = None

    def anchor_dirty(self) -> None:
        self._acc_dirty = []
        self._dirty_consumed = False

    def end_solve(self) -> None:
        """Consume the pending host info and anchor the dirty accumulator
        on the solve that just completed."""
        self._pend_static = None
        self._pend_warm = None
        self._pend_dirty = None
        if self._dirty_consumed:
            self.anchor_dirty()

    def solve_info(self) -> dict:
        return {
            "mode": self.last_mode,
            "static": self.last_static,
            "blocks": self.last_blocks,
        }

    # -------------------------------------------------- solve services

    def static_planes(self, prof, cls, naff_weight: float,
                      has_taints: bool, cls_identity: bool, plain=False):
        """The persistent [U, C] static planes for this solve, produced
        on miss and reused on key match; None when the caller supplied no
        static key."""
        if self._pend_static is None:
            self.last_static = "off"
            return None
        key = (self._pend_static, bool(has_taints),
               bool(cls_identity), int(prof.sel_bits.shape[0]),
               str(prof.sel_bits.device))
        if self._static is not None and self._static_key == key:
            self.static_hits += 1
            self.last_static = "hit"
            return self._static
        self._static = kernels.static_planes(
            prof, cls, float(naff_weight), bool(has_taints), plain=plain)
        self._static_key = key
        self.static_builds += 1
        self.last_static = "build"
        return self._static

    def shortlist(self, nodes, prof, cls, weights, eps, scalar_slot,
                  sl_k: int, features: tuple, cls_identity: bool, stat,
                  future=None, ports=None, aff1=None, plain: bool = False):
        """The solve's [U, sl_k] shortlists: warm-started when the warm
        key held and the dirty-block fraction is low, full re-rank
        (seeding fresh candidates) otherwise.  Bit-identical to the
        direct coarse pass either way.  ``future``: the releasing-capacity
        planes the fit reads (``kernels.Future``), None without them;
        ``ports`` the solve-start port planes; ``aff1`` the solve-start
        affinity inputs (``wave.Phase1Aff``, None when no resident pod
        matches a term).  The warm key the caller passed covers the count
        table's content (its hash), so the clean blocks' candidates were
        ranked on the same counts."""
        N = int(nodes.idle.shape[0])
        U = int(prof.req.shape[0])
        dev = nodes.idle.device
        B, nlb, klb = block_geometry(N, sl_k)
        meta = (U, N, B, klb, int(sl_k), tuple(features),
                aff1 is not None, bool(cls_identity), stat is not None,
                str(dev))
        rows_u = (None if aff1 is None
                  else torch.arange(U, dtype=torch.int32, device=dev))
        key = ((self._pend_warm, meta)
               if self._pend_warm is not None else None)
        dirty = self._pend_dirty
        if (key is not None and self._cand is not None
                and self._warm_key == key and dirty is not None
                and stat is not None):
            db = np.unique(
                dirty[(dirty >= 0) & (dirty < N)].astype(np.int64) // nlb
            ).astype(np.int32)
            if len(db) == 0:
                # Null delta at shortlist granularity: the previous
                # shortlist (and candidates) stand as they are.
                self.last_mode = "warm"
                self.last_blocks = (0, B)
                self.counts["warm"] += 1
                return self._cand[2]
            if len(db) <= max(1, int(B * WARM_MAX_BLOCK_FRACTION)):
                cand_s, cand_i, _sl = self._cand
                db_t = torch.from_numpy(db).to(dev)
                aff = None
                if aff1 is not None:
                    # The dirty blocks' node rows, in db order.
                    drows = (db_t.long()[:, None] * nlb + torch.arange(
                        nlb, device=dev)[None, :]).reshape(-1)
                    aff = affkernels.aff_live(
                        rows_u, drows.to(torch.int32), aff1.terms, aff1.at,
                        plain=plain)
                sl, cand_s, cand_i = kernels.warm_shortlist(
                    prof, cls.class_id, stat[0], stat[1], nodes.idle,
                    nodes.allocatable, nodes.ntasks, nodes.max_tasks, eps,
                    scalar_slot, weights, db_t, cand_s, cand_i, int(sl_k),
                    future=future, ports=ports, aff=aff, plain=plain,
                )
                self._cand = (cand_s, cand_i, sl)
                self.last_mode = "warm"
                self.last_blocks = (int(len(db)), B)
                self.counts["warm"] += 1
                return sl
        # Full re-rank -- also seeds the candidates for the next solve.
        aff = None if aff1 is None else affkernels.aff_live(
            rows_u, None, aff1.terms, aff1.at, plain=plain)
        sl, _ok, _sc, cand_s, cand_i = kernels.coarse_shortlist(
            prof, cls, nodes.idle, nodes.allocatable, nodes.ntasks,
            nodes.max_tasks, eps, scalar_slot, weights, int(sl_k),
            has_taints=bool(features[2]), stat=stat, n_blocks=B,
            future=future, ports=ports, aff=aff, plain=plain,
        )
        self._cand = (cand_s, cand_i, sl)
        self._warm_key = key
        self.last_mode = "full"
        self.last_blocks = (B, B)
        self.counts["full"] += 1
        return sl


def of_store(store) -> DeviceIncremental:
    """The store's device-incremental context, created on first use
    (``store._devincr_cache``, cleared by ``store.close()``)."""
    dv = getattr(store, "_devincr_cache", None)
    if dv is None:
        dv = store._devincr_cache = DeviceIncremental()
    return dv
