"""Rebalance action: gang-aware defragmentation with disruption budgets.

The counterpart of the JAX package's ``actions/rebalance.py``.  The lane
itself is the fast path's ``FastCycle._rebalance`` (plan with the
``frag_scores`` kernel, prove with a what-if ``solve_wave`` over the
hypothetically drained cluster, commit evictions through the what-if
engine); this module holds its switches and the migration state every
what-if engine action (rebalance, preempt, reclaim) shares:

- ``rebalance_enabled`` / ``drain_cap`` -- the lane's kill switch
  (``VOLCANO_TPU_REBALANCE``) and the most nodes one plan may drain
  (``VOLCANO_TPU_REBALANCE_DRAIN_CAP``);
- ``MigrationLedger`` -- the store-attached record of in-flight evictions
  (``store.migrations``), shared by every what-if engine action; entries
  carry the evicting ``action`` and the beneficiary gang.  When an evicted
  pod finishes terminating (``store.delete_pod``), the ledger restores it
  as an identical Pending pod, uid ``{uid}-mig{seq}``: no pod is lost.
- disruption budgets -- ``max_unavailable_of`` resolves a PodGroup's
  ceiling (``PodGroup.max_unavailable``, else
  ``VOLCANO_TPU_REBALANCE_MAX_UNAVAIL``); the ledger's ``disrupted`` count
  (victims whose restored pod is not yet bound) is charged against it at
  plan time and at the commit re-check.
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Dict, Optional

log = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def rebalance_enabled() -> bool:
    """Master switch (the action string is the real opt-in; this kills the
    lane without a config rollout)."""
    return os.environ.get("VOLCANO_TPU_REBALANCE", "1") != "0"


def drain_cap() -> int:
    """Max nodes one plan may hypothetically drain."""
    return max(1, _env_int("VOLCANO_TPU_REBALANCE_DRAIN_CAP", 32))


def min_gain() -> int:
    """Min starved-gang tasks a plan must newly place to commit."""
    return max(1, _env_int("VOLCANO_TPU_REBALANCE_MIN_GAIN", 1))


def default_max_unavailable() -> int:
    """Per-PodGroup disruption ceiling when the group sets none."""
    return max(0, _env_int("VOLCANO_TPU_REBALANCE_MAX_UNAVAIL", 1))


def max_unavailable_of(pg) -> int:
    """Resolve a PodGroup's disruption budget (PDB max_unavailable
    equivalent).  ``None``/missing falls back to the env default."""
    v = getattr(pg, "max_unavailable", None) if pg is not None else None
    if v is None:
        return default_max_unavailable()
    return max(0, int(v))


class _Migration:
    """One victim's evict -> restore -> rebind lifecycle."""

    __slots__ = ("uid", "group_uid", "planned_node", "restored_uid",
                 "action", "for_gang")

    def __init__(self, uid: str, group_uid: str, planned_node: str,
                 action: str = "rebalance", for_gang: str = ""):
        self.uid = uid
        self.group_uid = group_uid
        self.planned_node = planned_node
        # uid of the restored Pending pod, set when the eviction's
        # termination completes and the ledger re-creates the pod.
        self.restored_uid: Optional[str] = None
        # Which engine action evicted this victim (preempt,
        # reclaim and rebalance share one ledger and one per-PodGroup
        # disruption-budget pool) and which starved gang the wave
        # served (the planner suppresses re-plans for it while the
        # victims terminate).
        self.action = action
        self.for_gang = for_gang


class MigrationLedger:
    """Store-attached in-flight migration record (``store.migrations``).

    Called from inside the store's lock (``delete_pod``) and from the
    fast-path cycle (which holds the same re-entrant lock), so no lock
    of its own is needed.
    """

    def __init__(self):
        self.entries: Dict[str, _Migration] = {}  # victim uid -> entry
        self._restore_seq = 0
        # Monotonic counters for the flight recorder / tests.
        self.committed_plans = 0
        self.restored_pods = 0

    # ------------------------------------------------------------ commit

    def register(self, uid: str, group_uid: str, planned_node: str,
                 action: str = "rebalance", for_gang: str = "") -> None:
        self.entries[uid] = _Migration(uid, group_uid, planned_node,
                                       action=action, for_gang=for_gang)

    def cancel(self, uid: str) -> None:
        """Drop a migration whose eviction never dispatched (the
        evictor failed and the pod reverted to Running —
        ``fastpath_evict.EvictState.flush``).  The pod was never
        unavailable, so it must not pin its group's budget nor be
        "restored" when it eventually terminates for ordinary
        reasons."""
        self.entries.pop(uid, None)

    # ----------------------------------------------------------- restore

    def pod_deleted(self, store, pod) -> None:
        """``store.delete_pod`` hook: a terminating migration victim is
        restored as a fresh Pending pod (the owning controller's
        recreate, played in-process so migration e2e is hermetic).

        Only an eviction-driven termination restores: a pod deleted
        while NOT marked ``deleting`` (an operator/controller delete),
        or whose PodGroup is gone (the workload itself was removed),
        must stay deleted — resurrecting it would both override an
        explicit delete and strand an unschedulable orphan that pins
        the ledger (and with it the lane) forever.  Either way the
        entry leaves the ledger."""
        entry = self.entries.get(pod.uid)
        if entry is None or entry.restored_uid is not None:
            return
        if not pod.deleting or store.pod_groups.get(
                entry.group_uid) is None:
            del self.entries[pod.uid]
            return
        restored = copy.copy(pod)
        self._restore_seq += 1
        restored.uid = f"{pod.uid}-mig{self._restore_seq}"
        restored.node_name = None
        restored.deleting = False
        from ..api import PodPhase

        restored.phase = PodPhase.Pending
        restored.exit_code = 0
        entry.restored_uid = restored.uid
        self.restored_pods += 1
        store.add_pod(restored)
        planned = (f" (planned node {entry.planned_node})"
                   if entry.planned_node else "")
        store.record_event(
            f"Pod/{pod.namespace}/{pod.name}", "MigrationRestored",
            f"restored as {restored.uid} after {entry.action} "
            f"eviction{planned}",
        )

    # ----------------------------------------------------------- budgets

    def _done(self, store, entry: _Migration) -> bool:
        """A migration is complete once its restored pod is bound."""
        # The workload itself was removed mid-migration: nothing left
        # to restore or re-bind; the entry must not pin the budget (or
        # the one-wave-at-a-time gate) forever.
        if store.pod_groups.get(entry.group_uid) is None:
            return True
        if entry.restored_uid is None:
            return False
        pod = store.pods.get(entry.restored_uid)
        # Restored pod deleted again (external actor): nothing left to
        # track; the ledger must not pin the budget forever.
        if pod is None:
            return True
        return pod.node_name is not None

    def prune(self, store) -> None:
        done = [uid for uid, e in self.entries.items()
                if self._done(store, e)]
        for uid in done:
            del self.entries[uid]

    def active(self, store, action: Optional[str] = None) -> bool:
        """True while any migration (of ``action``, when given) is
        incomplete: the rebalance lane runs one wave at a time, and a
        preempted pod that stays Pending must not wedge that gate."""
        self.prune(store)
        if action is None:
            return bool(self.entries)
        return any(e.action == action for e in self.entries.values())

    def disrupted(self, store, group_uid: str) -> int:
        """Victims of the group still unavailable (evicted / terminating
        / restored-but-unbound)."""
        self.prune(store)
        return sum(1 for e in self.entries.values()
                   if e.group_uid == group_uid)


def ledger_of(store) -> MigrationLedger:
    """The store's migration ledger, created on first use."""
    ledger = getattr(store, "migrations", None)
    if ledger is None:
        ledger = store.migrations = MigrationLedger()
    return ledger


class RebalanceAction:
    """Object-session registration for the ``rebalance`` action name.

    The rebalance lane needs the array mirror, the profile tables and the
    wave solver -- none of which exist on the object-session path.
    Configurations that include ``rebalance`` with fast-path-eligible
    plugins run it in ``FastCycle._rebalance``; on the object path the
    action is a no-op (as in the reference, where defragmentation lives in
    a separate descheduler, not the scheduler's action list).
    """

    name = "rebalance"

    def initialize(self):
        pass

    def un_initialize(self):
        pass

    def execute(self, ssn) -> None:
        log.debug(
            "rebalance is a fast-path lane; the object-session path does "
            "not implement it (session %s)", ssn.uid,
        )
