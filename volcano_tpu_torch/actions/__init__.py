"""Scheduling actions, registered by name
(pkg/scheduler/actions/factory.go), and the shared state of the what-if
engine's lanes (``rebalance.MigrationLedger``)."""

from ..framework.plugins import register_action
from .allocate import AllocateAction
from .backfill import BackfillAction
from .enqueue import EnqueueAction
from .preempt import PreemptAction
from .rebalance import RebalanceAction
from .reclaim import ReclaimAction

register_action(EnqueueAction())
register_action(AllocateAction())
register_action(BackfillAction())
register_action(PreemptAction())
register_action(ReclaimAction())
register_action(RebalanceAction())

__all__ = [
    "AllocateAction",
    "BackfillAction",
    "EnqueueAction",
    "PreemptAction",
    "RebalanceAction",
    "ReclaimAction",
]
