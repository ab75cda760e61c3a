"""Topology-aware gang placement: fabric planes and contiguous blocks.

The counterpart of the JAX package's ``ops/topology.py``:

- **fabric model** -- nodes carry fabric coordinates from labels
  (``fabric.volcano-tpu/rack`` / ``slice`` / ``host``, ``api/spec.py``).
  The mirror interns the values append-only (``_fabric_vals`` /
  ``_fabric_blocks``, carried across compaction) and ``fabric_planes``
  derives the epoch-cached ``[N, 3]`` coordinate plane and ``[N]`` block
  ids, a block being one interned ``(rack, slice)`` pair; unlabeled nodes
  get -1 and join no block.
- **contiguous-block gang scoring** -- ``gang_block_fit`` (kernel
  ``csrc/topology.cu``): per-node task capacity per gang profile,
  summed per block, reduced to whole-gang feasibility and a partial-fit
  score; ``select_block`` picks the block on the host.  A
  ``require-contiguous`` gang is held out of the solve while no block can
  host it whole and its scattered placements are vetoed before commit; a
  ``prefer-contiguous`` gang gets ``contig_bias`` on its block's nodes,
  added to the solve's static node score.
- **fabric defragmentation** -- ``fabric_frag`` scores stranded partial
  blocks; ``gang_block_fit``'s launch writes it as its ``frag`` plane, and
  the standalone kernel (same source) serves a caller that holds only
  ``cfit`` and ``whole``.  The rebalance lane drains one target block for
  a constrained gang.

``VOLCANO_TPU_TOPOLOGY=0`` turns every hook off; so does a cluster without
fabric labels, and the solve inputs are then what they were without this
module.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..api.spec import FABRIC_L, FABRIC_LEVELS
from ..device import to_tensor
from . import kernels

F = np.float32
I = np.int32


def topology_on() -> bool:
    """Master switch (``VOLCANO_TPU_TOPOLOGY``, default on), read per
    decision."""
    return os.environ.get("VOLCANO_TPU_TOPOLOGY", "1") != "0"


def topo_weight() -> float:
    """Additive node-order bias for the selected block's nodes
    (``VOLCANO_TPU_TOPO_WEIGHT``, default 1.0)."""
    raw = os.environ.get("VOLCANO_TPU_TOPO_WEIGHT", "1.0")
    try:
        return float(raw)
    except ValueError:
        return 1.0


# ------------------------------------------------------------ mirror planes

def _fabric_interners(m) -> Tuple[dict, dict]:
    """The mirror's append-only fabric interners: ``_fabric_vals`` maps
    ``(level, label value) -> code``, ``_fabric_blocks`` ``(rack code,
    slice code) -> block id``.  Both survive compaction, so codes and block
    ids are stable for the life of the store."""
    vals = getattr(m, "_fabric_vals", None)
    if vals is None:
        vals = m._fabric_vals = {}
    blocks = getattr(m, "_fabric_blocks", None)
    if blocks is None:
        blocks = m._fabric_blocks = {}
    return vals, blocks


def fabric_planes(m) -> Tuple[np.ndarray, np.ndarray, int]:
    """``(coords [Nrows, FABRIC_L] int32, block_id [Nrows] int32,
    n_blocks)`` for the mirror's node table; -1 marks a missing coordinate
    or a blockless node.  Cached on the mirror by node epoch: coordinates
    are a function of the node table, and the interners only grow."""
    N = len(m.n_name)
    cache = getattr(m, "_fabric_cache", None)
    key = (m.epoch, N)
    if cache is not None and cache[0] == key:
        return cache[1], cache[2], cache[3]
    vals, blocks = _fabric_interners(m)
    coords = np.full((N, FABRIC_L), -1, I)
    block = np.full((N,), -1, I)
    for ni in range(N):
        if not m.n_alive[ni]:
            continue
        node = m.node_objs[ni]
        labels = getattr(node, "labels", None) if node is not None else None
        if not labels:
            continue
        for li, lkey in enumerate(FABRIC_LEVELS):
            v = labels.get(lkey)
            if v is None:
                continue
            code = vals.get((li, v))
            if code is None:
                code = vals[(li, v)] = len(vals)
            coords[ni, li] = code
        if coords[ni, 0] >= 0 and coords[ni, 1] >= 0:
            bkey = (int(coords[ni, 0]), int(coords[ni, 1]))
            bid = blocks.get(bkey)
            if bid is None:
                bid = blocks[bkey] = len(blocks)
            block[ni] = bid
    n_blocks = len(blocks)
    m._fabric_cache = (key, coords, block, n_blocks)
    return coords, block, n_blocks


def has_fabric(m) -> bool:
    """True when a live node carries a complete block coordinate (the
    cheap gate every fast-path hook checks first; cached with the
    planes)."""
    _, block, n_blocks = fabric_planes(m)
    return n_blocks > 0 and bool((block >= 0).any())


# --------------------------------------------------------------- kernels

class BlockFit(NamedTuple):
    """Per-block gang-fit planes (tensors on the device they were computed
    on).  The JAX ``BlockFit`` has the first three fields; ``frag`` is its
    ``fabric_frag(cfit, whole, prof_cnt)``, written here by the same
    launch."""

    cfit: torch.Tensor   # [B, U] i32 gang tasks of profile u the block holds
    whole: torch.Tensor  # [B] bool block can host the WHOLE gang
    score: torch.Tensor  # [B] f32 partial-fit score (sum of min(cfit, cnt))
    frag: torch.Tensor   # [B] f32 stranded-partial-block score (fabric_frag)


def gang_block_fit(idle, ready, ntasks, max_tasks, block_id, prof_req,
                   prof_cnt, eps, *, n_blocks: int, device,
                   plain: bool = False) -> BlockFit:
    """Whole-gang fit per fabric block (the JAX ``gang_block_fit``,
    ops/topology.py:179), from numpy planes: ``idle`` [N, R], ``ready``
    [N], ``ntasks`` / ``max_tasks`` [N] (``max_tasks`` 0 = unlimited),
    ``block_id`` [N] (-1 = blockless), ``prof_req`` [U, R] (all-zero rows
    inert), ``prof_cnt`` [U] (0 for padding), ``eps`` [R]; ``n_blocks``
    block rows (callers bucket it to a power of two and slice).

    - per (node, profile) capacity = min over requested slots of
      ``floor((idle + eps) / req)``, 0 for a profile with no requested
      slot or on a node that is not ready, capped by the node's free pod
      slots when ``max_tasks > 0``;
    - ``cfit[b, u]`` = sum of the capacity over the block's nodes;
    - ``whole[b]`` = ``cfit[b, u] >= prof_cnt[u]`` for every profile;
    - ``score[b]`` = sum over profiles of ``min(cfit[b, u], cnt[u])``;
    - ``frag[b]`` = ``fabric_frag``: 0 on a whole block, else ``score[b] /
      max(sum cnt, 1)``.

    Profiles are taken as independent, so ``whole`` is an upper bound; the
    post-solve topology gate is the exact enforcer."""
    def t(a, dtype):
        return to_tensor(np.asarray(a, dtype), device)

    out = kernels.gang_block_fit(
        t(idle, F), t(ready, np.bool_), t(ntasks, I), t(max_tasks, I),
        t(block_id, I), t(prof_req, F), t(prof_cnt, I), t(eps, F),
        int(n_blocks), plain=plain)
    return BlockFit(*out)


def fabric_frag(cfit, whole, prof_cnt, *, device,
                plain: bool = False) -> torch.Tensor:
    """Stranded-partial-block score per block, in [0, 1] (the JAX
    ``fabric_frag``, ops/topology.py:240): ``(1 - whole[b]) * score[b] /
    total_need``, from numpy ``cfit`` / ``whole`` planes.  The mean over
    blocks is the ``volcano_topology_frag_score`` gauge; the rebalance
    planner reads it from ``gang_block_fit``'s ``frag``."""
    def t(a, dtype):
        return to_tensor(np.asarray(a, dtype), device)

    return kernels.fabric_frag(t(cfit, I), t(whole, np.bool_),
                               t(prof_cnt, I), plain=plain)


# ------------------------------------------------------------- host side

def select_block(whole: np.ndarray, score: np.ndarray,
                 require: bool) -> int:
    """Deterministic target-block pick over fetched planes: the max-score
    block (tie: lowest block id), restricted to whole-gang blocks when
    ``require``.  -1 when no candidate exists."""
    whole = np.asarray(whole, bool)
    score = np.asarray(score, np.float32)
    cand = whole if require else np.ones(len(score), bool)
    if not cand.any():
        return -1
    masked = np.where(cand, score, -np.inf)
    return int(np.argmax(masked))  # argmax ties -> lowest index


def contig_bias(block_id: np.ndarray, target_block: int, n_pad: int,
                weight: Optional[float] = None) -> np.ndarray:
    """``[n_pad]`` f32 additive node-order bias: ``weight`` on the target
    block's nodes, 0 elsewhere (padding rows included).  Added to the
    solve's static node score, so it never outranks feasibility."""
    if weight is None:
        weight = topo_weight()
    bias = np.zeros((n_pad,), F)
    if target_block >= 0 and weight != 0.0:
        n = min(len(block_id), n_pad)
        bias[:n][np.asarray(block_id[:n]) == target_block] = F(weight)
    return bias
