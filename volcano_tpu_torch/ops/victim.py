"""Victim selection of the device-native preempt and reclaim lanes.

The counterpart of the JAX package's ``ops/victim.py``:

- ``victim_scores`` -- one kernel pass (``kernels.victim_scores``, CUDA
  source ``csrc/victim_scores.cu``) over the victim rows and the queue
  planes: the tier-gated eligibility mask, the eviction order (job priority
  ascending, youngest victim first, input index tie-break), the per-node
  evictable plane and the queue shares.  Preempt gates victims to the
  preemptor's queue at strictly lower job priority; reclaim to OTHER
  queues that are reclaimable and over their deserved share.
- ``select_victims`` -- the deterministic host greedy over the fetched
  planes under disruption budgets, gang floors and (reclaim) queue slack;
  ``fit_counts`` and ``queue_shares`` are its host helpers.  These three
  are numpy, copied from the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import kernels

F = np.float32
I = np.int32

# Sentinel above which a deserved slot means "uncapped" (matches the
# 3.0e38 fill FastCycle._proportion writes for capless queues/slots).
DESERVED_UNCAPPED = kernels.DESERVED_UNCAPPED
# Relative tolerance on the overuse test (f32 share arithmetic).
SHARE_TOL = kernels.SHARE_TOL

PREEMPT = kernels.PREEMPT
RECLAIM = kernels.RECLAIM


class VictimPlanes(NamedTuple):
    """The kernel's outputs (tensors on the device they were computed on)."""

    eligible: torch.Tensor   # [V] bool tier-gated victim mask
    order: torch.Tensor      # [V] i32 eviction order (eligible first)
    evictable: torch.Tensor  # [N, R] f32 per-node eligible request sum
    q_share: torch.Tensor    # [Q] f32 queue share = max alloc/deserved


def queue_shares(q_alloc: np.ndarray, q_deserved: np.ndarray) -> np.ndarray:
    """[Q] share plane from the cycle's queue planes: max over capped
    slots of allocated/deserved (0 when no slot is capped).  Host-side
    mirror of the kernel's formula so planners can pre-gate targets
    without a device round trip."""
    q_alloc = np.asarray(q_alloc, F)
    q_des = np.asarray(q_deserved, F)
    capped = q_des < DESERVED_UNCAPPED
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(capped, q_alloc / np.maximum(q_des, 1e-9), 0.0)
    return ratio.max(axis=-1).astype(F) if ratio.size else \
        np.zeros(len(q_alloc), F)


def victim_scores(v_ok, v_jprio, v_crank, v_tie, v_queue, v_node, v_req,
                  p_prio: int, p_queue: int, q_alloc, q_deserved,
                  q_reclaimable, mode: int, n_nodes: int, device,
                  plain: bool = False) -> VictimPlanes:
    """Tier-gated victim eligibility + eviction order + evictable plane
    (the JAX ``victim_scores``, ops/victim.py:82) over V unpadded victim
    rows given as numpy: ``v_ok`` [V] bool base validity (Running
    resident, non-empty request, not critical, job and queue known, not
    the starved gang itself); ``v_jprio`` / ``v_crank`` / ``v_tie`` [V]
    job priority, creation rank (a permutation of 0..V-1, larger =
    younger) and tie-break; ``v_queue`` / ``v_node`` [V]; ``v_req`` [V, R];
    ``q_alloc`` / ``q_deserved`` [Q, R]; ``q_reclaimable`` [Q]; ``mode`` 0
    preempt, 1 reclaim; the evictable plane has ``n_nodes`` rows.  The
    arrays go to ``device`` and the kernel runs there (its plain version on
    the CPU).  Ineligible rows sort to the tail of ``order``; the eligible
    prefix orders by (job priority asc, creation rank desc, tie asc)."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    out = kernels.victim_scores(
        t(v_ok, np.bool_), t(v_jprio, np.int32), t(v_crank, np.int32),
        t(v_tie, np.int32), t(v_queue, np.int32), t(v_node, np.int32),
        t(v_req, F), int(p_prio), int(p_queue), t(q_alloc, F),
        t(q_deserved, F), t(q_reclaimable, np.bool_), int(mode),
        int(n_nodes), plain=plain)
    return VictimPlanes(*out)


def fit_counts(plane: np.ndarray, prof_req: np.ndarray,
               eps: np.ndarray) -> np.ndarray:
    """[N] whole gang tasks each node row of ``plane`` can host: per
    (node, profile) the min over requested slots of
    ``floor((plane + eps) / req)`` (0 when the profile requests
    nothing), max over profiles — the same fit spec as
    ``ops.rebalance.frag_scores`` so the two planners agree on what "a
    freed slot" means."""
    plane = np.atleast_2d(np.asarray(plane, F))
    req = np.asarray(prof_req, F)
    eps = np.asarray(eps, F)
    requested = req > eps[None, :]  # [U, R]
    per = np.floor(
        (plane[:, None, :] + eps[None, None, :])
        / np.maximum(req[None, :, :], 1e-9)
    )
    per = np.where(requested[None, :, :], per, np.float32(2 ** 30))
    cnt = per.min(axis=-1)
    cnt = np.where(requested.any(axis=-1)[None, :], cnt, 0.0)
    return np.maximum(cnt, 0.0).max(axis=-1).astype(np.int64)


class VictimSelection(NamedTuple):
    """``select_victims`` verdict (host-side, deterministic)."""

    chosen: List[int]      # indices into the victim arrays, evict order
    feasible: bool         # freed capacity covers the need
    budget_blocked: bool   # budgets (not capacity/cap) blocked the plan
    gain: int              # gang tasks the chosen drain frees


def select_victims(
    order: np.ndarray,
    eligible: np.ndarray,
    v_node: np.ndarray,
    v_req: np.ndarray,
    v_job: np.ndarray,
    v_group: Sequence[str],
    v_queue: np.ndarray,
    need: int,
    idle: np.ndarray,
    evictable: np.ndarray,
    prof_req: np.ndarray,
    eps: np.ndarray,
    j_ready: np.ndarray,
    j_minav: np.ndarray,
    budget_left: Dict[str, int],
    cap: int,
    q_alloc: Optional[np.ndarray] = None,
    q_deserved: Optional[np.ndarray] = None,
) -> VictimSelection:
    """Greedy ranked-victim selection under disruption budgets.

    Walks victims in kernel ``order``; a victim is taken iff its node
    can gain gang capacity at all (draining every eligible victim there
    beats the node's as-is fit), its job stays at/above
    ``minAvailable`` after the eviction (or ``minAvailable == 1`` —
    the gang tier), its PodGroup's remaining budget covers one more
    disruption, and (reclaim, ``q_alloc``/``q_deserved`` given) its
    queue's share stays at/above deserved after the eviction — a queue
    is never reclaimed below its deserved share.  Gain is
    measured in whole gang tasks (``fit_counts``); selection stops at
    ``need`` covered or ``cap`` victims.  Victims on nodes whose final
    fit never improved are pruned (their slot never completed — the
    eviction would free nothing the gang can use).  Mutates none of its
    inputs.
    """
    order = np.asarray(order, np.int64)
    eligible = np.asarray(eligible, bool)
    v_node = np.asarray(v_node, np.int64)
    v_req = np.asarray(v_req, F)
    v_job = np.asarray(v_job, np.int64)
    idle = np.asarray(idle, F)
    ev = np.asarray(evictable, F)

    touched = np.unique(v_node[eligible]) if eligible.any() else \
        np.zeros(0, np.int64)
    fit0: Dict[int, int] = {}
    gain_ok: Dict[int, bool] = {}
    if len(touched):
        base = fit_counts(idle[touched], prof_req, eps)
        drained = fit_counts(idle[touched] + ev[touched], prof_req, eps)
        for i, n in enumerate(touched.tolist()):
            fit0[n] = int(base[i])
            gain_ok[n] = bool(drained[i] > base[i])

    def walk(budgets: Dict[str, int]):
        freed: Dict[int, np.ndarray] = {}
        cur_fit: Dict[int, int] = {}
        occupancy: Dict[int, int] = {}
        qa = None if q_alloc is None else np.array(q_alloc, F)
        chosen: List[int] = []
        gain = 0
        skipped_budget = False
        for idx in order.tolist():
            if not eligible[idx]:
                break  # ineligible rows are sorted to the tail
            if gain >= need or len(chosen) >= cap:
                break
            n = int(v_node[idx])
            if not gain_ok.get(n, False):
                continue
            j = int(v_job[idx])
            cnt = occupancy.get(j)
            if cnt is None:
                cnt = int(j_ready[j]) if 0 <= j < len(j_ready) else 0
            minav = int(j_minav[j]) if 0 <= j < len(j_minav) else 1
            if not (minav <= cnt - 1 or minav == 1):
                continue  # gang tier: job would drop below minAvailable
            g = v_group[idx]
            if budgets.get(g, 0) < 1:
                skipped_budget = True
                continue
            if qa is not None:
                # Proportion tier: the victim queue must stay AT or
                # ABOVE its deserved share after the eviction — the
                # same share metric the kernel's overuse gate reads.
                # Unknown queues (defensive: eligibility already
                # excludes them) are never reclaimable.
                q = int(v_queue[idx])
                if not 0 <= q < len(qa):
                    continue
                after = queue_shares(
                    (qa[q] - v_req[idx])[None, :],
                    q_deserved[q][None, :])[0]
                if after < 1.0 - SHARE_TOL:
                    continue  # queue would drop below deserved
                qa[q] = qa[q] - v_req[idx]
            occupancy[j] = cnt - 1
            budgets[g] = budgets.get(g, 0) - 1
            f = freed.get(n)
            if f is None:
                f = freed[n] = np.zeros(v_req.shape[1], F)
            old = cur_fit.get(n, fit0[n])
            f += v_req[idx]
            new = int(fit_counts(idle[n] + f, prof_req, eps)[0])
            cur_fit[n] = new
            gain += new - old
            chosen.append(idx)
        # Prune whole nodes whose fit never improved: every victim
        # taken there freed a partial slot the gang cannot use.
        dead = {n for n in freed
                if cur_fit.get(n, fit0[n]) <= fit0[n]}
        if dead:
            chosen = [i for i in chosen if int(v_node[i]) not in dead]
        return chosen, gain, skipped_budget

    chosen, gain, skipped = walk(dict(budget_left))
    if gain >= need:
        return VictimSelection(chosen=chosen, feasible=True,
                               budget_blocked=False, gain=gain)
    blocked = False
    if skipped:
        # Label the outcome honestly: budgets blocked the plan only if
        # the same greedy with unlimited budgets (same cap, same gang
        # floors, same queue slack) would have covered the need.
        inf = {g: 1 << 30 for g in set(v_group)}
        _, ugain, _ = walk(inf)
        blocked = ugain >= need
    return VictimSelection(chosen=[], feasible=False,
                           budget_blocked=blocked, gain=gain)
