"""Dense array schema + snapshot encoder (numpy)."""

from .affinity import AffinityArgs, empty_affinity, encode_affinity
from .schema import (
    ClusterArrays,
    IndexMaps,
    JobArrays,
    NodeArrays,
    QueueArrays,
    ResourceSlots,
    TaskArrays,
    encode_cluster,
    pad_dim,
)

__all__ = [
    "AffinityArgs",
    "empty_affinity",
    "encode_affinity",
    "ClusterArrays",
    "IndexMaps",
    "JobArrays",
    "NodeArrays",
    "QueueArrays",
    "ResourceSlots",
    "TaskArrays",
    "encode_cluster",
    "pad_dim",
]
