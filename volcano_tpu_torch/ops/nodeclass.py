"""Node-class compaction: the coarse axis of the two-phase device solve.

Production clusters are overwhelmingly *homogeneous in the static planes*:
10k nodes share a handful of (capacity, label set, taint set,
readiness) combinations even when their dynamic state (idle, ports,
pod counts) differs per node.  The reference never exploits this — it
samples nodes instead (``scheduler_helper.go:37-62``); the device-native
equivalent is to collapse the node table into *node classes* and evaluate
every static per-(profile x node) predicate once per
(profile x class), then expand the verdicts back through a [N] gather.

A class is the set of nodes with byte-identical static signature:

- label bit plane row (node-selector / node-affinity / preferred terms),
- taint bit plane row (toleration gating),
- readiness (ready & schedulable & real),
- capacity bucket (allocatable vector + max-task count — not consumed by
  the static masks themselves, but keeping capacity in the signature
  makes class membership meaningful for mixed-hardware fleets and keeps
  the class axis aligned with how operators reason about node pools).

Classes are ordered by *sorted signature bytes*, NOT first occurrence:
the ordering is then a pure function of the signature SET, so a node
mutation that does not add/remove a signature leaves every other node's
class id untouched — which is what lets the JAX package's device-resident snapshot ship the
``class_id`` plane as a dirty-row delta scatter (the class tables
themselves re-upload only when ``tables_sig`` moves).

The class count axis is padded to a power-of-two bucket (inert rows:
not-ready, zero bits) so the coarse kernel compiles per bucket, not per
distinct class count.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Tuple

import numpy as np


class NodeClasses(NamedTuple):
    """Device inputs of the class axis ([N] nodes -> [C] classes).

    ``class_id`` maps every (padded) node row to its class; the three
    tables carry one row per class (padded classes are inert:
    ``ready=False``, zero bit rows — never referenced by ``class_id``).
    """

    class_id: np.ndarray  # [N] int32
    label_bits: np.ndarray  # [C, LW] uint32
    taint_bits: np.ndarray  # [C, TW] uint32
    ready: np.ndarray  # [C] bool


def _np(a) -> np.ndarray:
    return np.ascontiguousarray(a)


def build_node_classes(
    label_bits: np.ndarray,
    taint_bits: np.ndarray,
    ready: np.ndarray,
    allocatable: np.ndarray,
    max_tasks: np.ndarray,
) -> Tuple[NodeClasses, int, str]:
    """Group nodes into classes (host, numpy, exact).

    Returns ``(classes, n_classes, tables_sig)`` — ``n_classes`` the
    real (pre-padding) class count, ``tables_sig`` a content digest of
    the padded class tables (a device-resident snapshot keys its table upload on it, and
    the delta path for ``class_id`` is valid exactly while it holds
    still — see module doc on the sorted-signature ordering).
    """
    from .wave import bucket_pow2

    N = int(np.asarray(label_bits).shape[0])
    lb = _np(label_bits)
    tb = _np(taint_bits)
    rd = _np(ready).astype(np.uint8).reshape(N, 1)
    al = _np(np.asarray(allocatable, np.float32))
    mt = _np(np.asarray(max_tasks, np.int32)).reshape(N, -1)
    sig = np.concatenate(
        [
            lb.view(np.uint8).reshape(N, -1),
            tb.view(np.uint8).reshape(N, -1),
            rd,
            al.view(np.uint8).reshape(N, -1),
            mt.view(np.uint8).reshape(N, -1),
        ],
        axis=1,
    )
    sig = np.ascontiguousarray(sig)
    # np.unique over the structured row view sorts lexicographically —
    # exactly the signature-set-stable ordering the delta path needs.
    rows = sig.view([("", np.uint8)] * sig.shape[1]).ravel()
    _, rep, inv = np.unique(rows, return_index=True, return_inverse=True)
    C = len(rep)
    Cp = bucket_pow2(C, floor=8)

    def pad_rows(a, n_pad):
        return np.concatenate(
            [a, np.zeros((n_pad, *a.shape[1:]), a.dtype)]
        )

    cls_label = pad_rows(lb[rep], Cp - C)
    cls_taint = pad_rows(tb[rep], Cp - C)
    cls_ready = np.concatenate(
        [_np(ready)[rep], np.zeros(Cp - C, bool)]
    )
    digest = hashlib.blake2b(digest_size=16)
    digest.update(cls_label.tobytes())
    digest.update(cls_taint.tobytes())
    digest.update(cls_ready.tobytes())
    classes = NodeClasses(
        class_id=inv.reshape(N).astype(np.int32),
        label_bits=cls_label,
        taint_bits=cls_taint,
        ready=cls_ready,
    )
    return classes, C, digest.hexdigest()
