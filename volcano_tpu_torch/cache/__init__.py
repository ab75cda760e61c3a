"""Cluster state store (scheduler cache) and side-effect interfaces."""

from .interface import (
    Binder,
    Evictor,
    FakeBinder,
    FakeEvictor,
    FakeStatusUpdater,
    FakeVolumeBinder,
    StatusUpdater,
    VolumeBinder,
)
from .store import DEFAULT_QUEUE, ClusterStore

__all__ = [
    "Binder",
    "Evictor",
    "FakeBinder",
    "FakeEvictor",
    "FakeStatusUpdater",
    "FakeVolumeBinder",
    "StatusUpdater",
    "VolumeBinder",
    "ClusterStore",
    "DEFAULT_QUEUE",
]
