"""Rebalance planner: gang-aware defragmentation scoring.

The counterpart of the JAX package's ``ops/rebalance.py``:

- ``frag_scores`` -- one kernel pass (``kernels.frag_scores``, CUDA source
  ``csrc/frag_scores.cu``) over the node planes for one starved gang: per
  node a fragmentation score (idle-rich but unable to host any task of the
  gang's profiles), the gang tasks the node's idle holds now, and the gang
  tasks it would hold after its migratable pods were drained.  The inputs
  go to the card in one staged copy, the three planes come back in one.
- ``select_drain_set`` -- the deterministic host greedy over the fetched
  planes: cheapest-to-drain nodes first, per-PodGroup disruption budgets
  charged as nodes are taken, stopping once the freed capacity covers the
  gang's need or the drain cap is hit.  numpy, copied from the JAX package.

The placement half of a plan is a what-if ``solve_wave`` over the
hypothetically drained cluster (``FastCycle._rebalance``, ``whatif.py``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import kernels


class FragScores(NamedTuple):
    """Per-node planner vectors (tensors on the device they were computed
    on), the rows of one [3, N] int32 buffer (``packed``)."""

    frag: torch.Tensor       # [N] f32 fragmentation score in [0, 1]
    fit_now: torch.Tensor    # [N] i32 gang tasks the node's idle holds now
    fit_freed: torch.Tensor  # [N] i32 gang tasks after draining evictables

    @property
    def packed(self) -> torch.Tensor:
        """The [3, N] int32 buffer whose rows the three planes are
        (``frag`` as its f32 bits): one copy fetches all three."""
        mid = self.fit_now
        n = mid.shape[0]
        if not (self.frag.untyped_storage().data_ptr()
                == mid.untyped_storage().data_ptr()
                == self.fit_freed.untyped_storage().data_ptr()
                and self.frag.data_ptr() == mid.data_ptr() - 4 * n
                and self.fit_freed.data_ptr() == mid.data_ptr() + 4 * n):
            raise ValueError("FragScores: the planes are not the rows of "
                             "one buffer")
        return mid.as_strided((3, n), (n, 1), mid.storage_offset() - n)


def frag_scores(idle, allocatable, ready, evictable, prof_req, eps, *,
                device, plain: bool = False) -> FragScores:
    """Fragmentation planes for one starved gang (the JAX ``frag_scores``,
    ops/rebalance.py:61), from numpy planes: ``idle`` / ``allocatable`` /
    ``evictable`` [N, R] (evictable = summed requests of the node's
    migratable Running pods), ``ready`` [N] bool, ``prof_req`` [U, R]
    per-profile init requests of the gang's pending tasks (all-zero rows
    inert), ``eps`` [R].  The planes go to ``device`` in one buffer
    (``kernels.stage_frag``: one pinned buffer and one asynchronous copy
    for the card) and the kernel runs there (its plain version on the
    CPU).

    - per (node, profile) fit count = min over requested slots of
      ``floor((plane + eps) / req)``, 0 when the profile requests nothing;
      ``fit_*`` takes the max over profiles;
    - ``frag`` = mean idle fraction over provisioned slots, zeroed on nodes
      that are not ready, hold no idle, or can already host a gang task.
    """
    staged = kernels.stage_frag(idle, allocatable, ready, evictable,
                                prof_req, eps, device)
    return FragScores(*kernels.frag_scores(*staged, plain=plain))


def select_drain_set(
    frag: np.ndarray,
    fit_now: np.ndarray,
    fit_freed: np.ndarray,
    need: int,
    victims_by_node: Sequence[Sequence[int]],
    victim_group: Dict[int, str],
    budget_left: Dict[str, int],
    drain_cap: int,
) -> Tuple[List[int], bool]:
    """Deterministic greedy drain-set selection over fetched planes.

    ``victims_by_node[n]``: migratable Running rows resident on node n;
    ``victim_group[row]``: PodGroup uid of a victim row;
    ``budget_left[uid]``: remaining disruption budget per group (plans in
    flight already subtracted).  Mutates nothing.

    A node is a candidate iff draining it gains gang capacity
    (``fit_freed > fit_now``), it is fragmented, and it holds at least one
    victim.  Candidates are taken cheapest-first -- key ``(len(victims),
    -gain, node)`` -- each charged against its victims' group budgets; a
    node whose victims would overdraw any budget is skipped.  Selection
    stops when the accumulated gain covers ``need`` or ``drain_cap`` nodes
    are taken.

    Returns ``(nodes, budget_blocked)``: the chosen node list (empty when
    the need cannot be covered) and whether budget exhaustion -- rather
    than capacity or the drain cap -- blocked an otherwise sufficient plan.
    """
    gain = fit_freed.astype(np.int64) - fit_now.astype(np.int64)
    cand = [
        int(n) for n in np.flatnonzero((gain > 0) & (frag > 0.0))
        if victims_by_node[int(n)]
    ]
    cand.sort(key=lambda n: (len(victims_by_node[n]), -int(gain[n]), n))
    left = dict(budget_left)
    chosen: List[int] = []
    acc = 0
    skipped_for_budget = False
    for n in cand:
        if acc >= need or len(chosen) >= drain_cap:
            break
        charges: Dict[str, int] = {}
        for row in victims_by_node[n]:
            g = victim_group[row]
            charges[g] = charges.get(g, 0) + 1
        if any(left.get(g, 0) < c for g, c in charges.items()):
            skipped_for_budget = True
            continue
        for g, c in charges.items():
            left[g] = left.get(g, 0) - c
        chosen.append(n)
        acc += int(gain[n])
    if acc < need:
        # "Budgets blocked it" versus "capacity / drain cap cannot cover",
        # for the plan outcome: the same greedy with unlimited budgets
        # under the same cap.
        unbudgeted = int(sum(int(gain[n]) for n in cand[:drain_cap]))
        return [], bool(skipped_for_budget and unbudgeted >= need)
    return chosen, False
