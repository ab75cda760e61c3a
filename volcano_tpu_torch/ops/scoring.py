"""Node-scoring functions: binpack, least/most-requested, balanced (torch).

The counterpart of the JAX package's ``ops/scoring.py``
(binpack.go:200-260, nodeorder.go:172-235).  Scores are additive across the
enabled scorers (session_plugins.go:448-468).

Every operation rounds one at a time in float32 in the order the JAX
functions use, and the sums over the resource axis run left to right: a
one-ulp score difference flips a tie in the node ranking, and a flipped tie
changes an assignment.  The CUDA kernels in ``csrc/common.cuh`` repeat this
arithmetic line for line (built with ``-fmad=false``).

``req`` broadcasts against ``allocatable``/``idle``: [U, 1, R] against
[1, N, R] scores every profile against every node.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAX_PRIORITY = 10.0


class ScoreWeights(NamedTuple):
    """Enable/weight knobs for the additive scorers (binpack.go:94-151,
    nodeorder.go:95-124).  A weight of 0 disables a scorer."""

    binpack_weight: float
    binpack_res: object  # [R] per-resource weights
    least_req_weight: float
    most_req_weight: float
    balanced_weight: float
    node_affinity_weight: float


def _rsum(x):
    """Left-to-right sum over the trailing axis."""
    acc = x[..., 0]
    for r in range(1, x.shape[-1]):
        acc = acc + x[..., r]
    return acc


def _where(cond, a, b):
    return torch.where(cond, a, torch.as_tensor(b, dtype=torch.float32,
                                                device=cond.device))


def binpack_score(req, allocatable, used, weights: ScoreWeights):
    """sum_r w_r * (used_r + req_r) / capacity_r over the requested
    resources, normalized to [0, 10] * BinPackingWeight."""
    bres = torch.as_tensor(weights.binpack_res, dtype=torch.float32,
                           device=allocatable.device)
    used_finally = used + req
    valid = (
        (req > 0) & (allocatable > 0) & (bres > 0)
        & (used_finally <= allocatable)
    )
    per_res = _where(
        valid,
        used_finally * bres / _where(allocatable > 0, allocatable, 1.0),
        0.0,
    )
    counted = (req > 0) & (bres > 0)
    weight_sum = _rsum(_where(counted, bres.expand_as(counted), 0.0))
    score = _rsum(per_res)
    score = torch.where(weight_sum > 0, score / weight_sum, score)
    return score * MAX_PRIORITY * weights.binpack_weight


def _mean2(per):
    return (per[..., 0] + per[..., 1]) / 2.0


def least_requested_score(req, allocatable, used, weights: ScoreWeights):
    requested = used[..., :2] + req[..., :2]
    cap = allocatable[..., :2]
    per = _where(
        cap > 0,
        torch.clamp(cap - requested, min=0.0) * MAX_PRIORITY
        / _where(cap > 0, cap, 1.0),
        0.0,
    )
    return _mean2(per) * weights.least_req_weight


def most_requested_score(req, allocatable, used, weights: ScoreWeights):
    requested = used[..., :2] + req[..., :2]
    cap = allocatable[..., :2]
    per = _where(
        (cap > 0) & (requested <= cap),
        requested * MAX_PRIORITY / _where(cap > 0, cap, 1.0),
        0.0,
    )
    return _mean2(per) * weights.most_req_weight


def balanced_score(req, allocatable, used, weights: ScoreWeights):
    requested = used[..., :2] + req[..., :2]
    cap = allocatable[..., :2]
    frac = _where(cap > 0, requested / _where(cap > 0, cap, 1.0), 1.0)
    diff = torch.abs(frac[..., 0] - frac[..., 1])
    over = (frac[..., 0] > 1.0) | (frac[..., 1] > 1.0)
    score = _where(~over, (1.0 - diff) * MAX_PRIORITY, 0.0)
    return score * weights.balanced_weight


def node_score(req, allocatable, idle, weights: ScoreWeights):
    """Additive score of ``req`` on every node; used = allocatable - idle."""
    used = allocatable - idle
    s = binpack_score(req, allocatable, used, weights)
    s = s + least_requested_score(req, allocatable, used, weights)
    s = s + most_requested_score(req, allocatable, used, weights)
    s = s + balanced_score(req, allocatable, used, weights)
    return s


def default_weights(width: int, binpack_enabled: bool = False,
                    nodeorder_enabled: bool = True) -> ScoreWeights:
    """Weights matching the reference defaults: nodeorder on (least=1,
    balanced=1), binpack per helm config (cpu=1, mem=1, weight=1)."""
    return ScoreWeights(
        binpack_weight=1.0 if binpack_enabled else 0.0,
        binpack_res=np.ones((width,), np.float32),
        least_req_weight=1.0 if nodeorder_enabled else 0.0,
        most_req_weight=0.0,
        balanced_weight=1.0 if nodeorder_enabled else 0.0,
        node_affinity_weight=1.0 if nodeorder_enabled else 0.0,
    )
