"""Pure-NumPy Go-semantics oracle for the allocate solver.

This is the rebuild's CPU-reference parity harness (SURVEY.md section 7 /
M5): an *independent*, deliberately naive reimplementation of the reference
allocate loop (``pkg/scheduler/actions/allocate/allocate.go:40-250``) written
the way the Go code is written — object-at-a-time, explicit statement
rollback — over the exact same dense arrays the sequential solve consumes
(``volcano_tpu_torch.ops.allocate.solve``, the ``seq_solve`` kernel on the
card).  Tests feed randomized snapshots to both and require identical
assignment matrices; any divergence is a solver bug (or a documented
deviation).

It stays NumPy and runs on the host: it is the independent reference, not
a device path.  Inputs may be numpy arrays or CPU tensors (bit words as
int32 tensors are read back as the same uint32 bits); a caller holding
tensors on the card moves them to the host first.

Semantics mirrored, with allocate.go anchors:
- queue-overuse skip at job open (allocate.go:126-133)
- per-task: static predicates AND InitResreq <= FutureIdle (allocate.go:98-105)
  AND pod-count AND host-port availability; no feasible node aborts the
  remaining tasks of the job (allocate.go:189-193)
- additive node scoring on live node state, best node = lowest index among
  maxima (deterministic stand-in for SelectBestNode's random-among-max,
  scheduler_helper.go:201-212)
- fits Idle -> stmt.Allocate; else -> ssn.Pipeline (session-level: survives
  statement discard, allocate.go:224-232)
- gang commit/discard at job end: roll back allocation-side effects iff the
  job never reached ready (statement.go:324-367; allocate.go:241-245)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

MAX_PRIORITY = 10.0


def np_less_equal(l, r, eps, scalar_slot):
    """Epsilon-tolerant Resource.LessEqual (resource_info.go:286-320)."""
    l = np.asarray(l, np.float32)
    r = np.asarray(r, np.float32)
    per_slot = (l < r) | (np.abs(l - r) < eps)
    per_slot = per_slot | (scalar_slot & (l <= eps))
    return bool(np.all(per_slot, axis=-1)) if per_slot.ndim == 1 else np.all(
        per_slot, axis=-1
    )


def _binpack(req, allocatable, used, w):
    requested = req[None, :]
    used_finally = used + requested
    valid = (
        (requested > 0)
        & (allocatable > 0)
        & (np.asarray(w.binpack_res)[None, :] > 0)
        & (used_finally <= allocatable)
    )
    safe_alloc = np.where(allocatable > 0, allocatable, 1.0)
    per_res = np.where(
        valid, used_finally * np.asarray(w.binpack_res)[None, :] / safe_alloc, 0.0
    )
    counted = (requested > 0) & (np.asarray(w.binpack_res)[None, :] > 0)
    weight_sum = np.sum(
        np.where(counted, np.asarray(w.binpack_res)[None, :], 0.0), axis=-1
    )
    score = np.sum(per_res, axis=-1)
    score = np.where(weight_sum > 0, score / np.where(weight_sum > 0, weight_sum, 1.0), score)
    return score * MAX_PRIORITY * w.binpack_weight


def _least_requested(req, allocatable, used, w):
    requested = used[:, :2] + req[None, :2]
    cap = allocatable[:, :2]
    safe = np.where(cap > 0, cap, 1.0)
    per = np.where(cap > 0, np.clip(cap - requested, 0.0, None) * MAX_PRIORITY / safe, 0.0)
    return per.mean(axis=-1) * w.least_req_weight


def _most_requested(req, allocatable, used, w):
    requested = used[:, :2] + req[None, :2]
    cap = allocatable[:, :2]
    safe = np.where(cap > 0, cap, 1.0)
    per = np.where((cap > 0) & (requested <= cap), requested * MAX_PRIORITY / safe, 0.0)
    return per.mean(axis=-1) * w.most_req_weight


def _balanced(req, allocatable, used, w):
    requested = used[:, :2] + req[None, :2]
    cap = allocatable[:, :2]
    safe = np.where(cap > 0, cap, 1.0)
    frac = np.where(cap > 0, requested / safe, 1.0)
    diff = np.abs(frac[:, 0] - frac[:, 1])
    score = np.where(np.any(frac > 1.0, axis=-1), 0.0, (1.0 - diff) * MAX_PRIORITY)
    return score * w.balanced_weight


def _node_score(req, allocatable, idle, w):
    used = allocatable - idle
    return (
        _binpack(req, allocatable, used, w)
        + _least_requested(req, allocatable, used, w)
        + _most_requested(req, allocatable, used, w)
        + _balanced(req, allocatable, used, w)
    )


class OracleResult(NamedTuple):
    assigned: np.ndarray  # [P] node index or -1 (committed only)
    pipelined: np.ndarray  # [P]
    never_ready: np.ndarray  # [J] bool
    fit_failed: np.ndarray  # [J] bool
    idle: np.ndarray  # [N, R]
    q_alloc: np.ndarray  # [Q, R] allocated + pipelined


def _subset_np(bits_row, table):
    """[..., W] & [N, W] -> [..., N]: row bits all present in table rows."""
    missing = bits_row[..., None, :] & ~table
    return np.all(missing == 0, axis=-1)


def solve_oracle(
    nodes,
    tasks,
    jobs,
    queues,
    weights,
    eps,
    scalar_slot,
    aff=None,
) -> OracleResult:
    """Run the Go-shaped sequential loop over the dense snapshot (same
    grouped inputs as ops.allocate.solve)."""
    to_np = lambda a: np.array(a, copy=True)
    idle = to_np(nodes.idle).astype(np.float32)
    allocatable = to_np(nodes.allocatable).astype(np.float32)
    releasing = to_np(nodes.releasing).astype(np.float32)
    pipelined0 = to_np(nodes.pipelined).astype(np.float32)
    ntasks = to_np(nodes.ntasks).astype(np.int64)
    max_tasks = to_np(nodes.max_tasks).astype(np.int64)
    nports = to_np(nodes.ports).astype(np.uint32)
    n_ready = np.asarray(nodes.ready, bool)
    n_labels = np.asarray(nodes.label_bits, np.uint32)
    n_taints = np.asarray(nodes.taint_bits, np.uint32)
    req = to_np(tasks.req).astype(np.float32)
    init_req = to_np(tasks.init_req).astype(np.float32)
    task_job = to_np(tasks.job).astype(np.int64)
    task_real = to_np(tasks.real).astype(bool)
    task_ports = to_np(tasks.ports).astype(np.uint32)
    t_sel = np.asarray(tasks.sel_bits, np.uint32)
    t_aff_bits = np.asarray(tasks.aff_bits, np.uint32)
    t_aff_terms = np.asarray(tasks.aff_terms, np.int64)
    t_tol = np.asarray(tasks.tol_bits, np.uint32)
    t_pref = np.asarray(tasks.pref_bits, np.uint32)
    t_prefw = np.asarray(tasks.pref_w, np.float32)
    job_queue = to_np(jobs.queue).astype(np.int64)
    min_available = to_np(jobs.min_available).astype(np.int64)
    ready_base = to_np(jobs.ready_base).astype(np.int64)
    deserved = to_np(queues.deserved).astype(np.float32)
    q_alloc = to_np(queues.allocated).astype(np.float32)
    eps = np.asarray(eps, np.float32)
    scalar_slot = np.asarray(scalar_slot, bool)

    P = req.shape[0]
    J = min_available.shape[0]

    if aff is None:
        from .arrays.affinity import empty_affinity

        aff = empty_affinity(idle.shape[0], P)
    node_dom = np.asarray(aff.node_dom, np.int64)
    term_key = np.asarray(aff.term_key, np.int64)
    cnt_alloc = np.array(aff.cnt0, np.int64, copy=True)
    cnt_pip = np.zeros_like(cnt_alloc)
    t_req_aff = np.asarray(aff.t_req_aff, bool)
    t_req_anti = np.asarray(aff.t_req_anti, bool)
    t_matches = np.asarray(aff.t_matches, bool)
    t_soft = np.asarray(aff.t_soft, np.float32)
    E = cnt_alloc.shape[0]
    term_ar = np.arange(E)

    pip_extra = np.zeros_like(idle)
    pip_ntasks = np.zeros_like(ntasks)
    pip_nports = np.zeros_like(nports)
    q_pip = np.zeros_like(q_alloc)

    assigned = np.full((P,), -1, np.int32)
    pipelined = np.full((P,), -1, np.int32)
    never_ready = np.zeros((J,), bool)
    fit_failed = np.zeros((J,), bool)

    # Group task rows by job preserving encode order (jobs are contiguous).
    job_rows = []
    cur_job, cur = None, []
    for t in range(P):
        if not task_real[t]:
            continue
        j = int(task_job[t])
        if j != cur_job:
            if cur:
                job_rows.append((cur_job, cur))
            cur_job, cur = j, []
        cur.append(t)
    if cur:
        job_rows.append((cur_job, cur))

    for j, rows in job_rows:
        qj = int(job_queue[j])
        q_total = q_alloc[qj] + q_pip[qj]
        if not np_less_equal(q_total, deserved[qj], eps, scalar_slot):
            continue  # overused queue: job skipped, no statement opened

        # Open a statement: checkpoint allocation-side state.
        ck_idle = idle.copy()
        ck_ntasks = ntasks.copy()
        ck_nports = nports.copy()
        ck_cnt = cnt_alloc.copy()
        ck_q_alloc = q_alloc.copy()
        ck_assigned = assigned.copy()
        job_ready = ready_base[j] >= min_available[j]
        alloc_cnt = 0

        for t in rows:
            # Static predicates from the bitset tables (selector, required
            # node affinity OR-terms, taints, node readiness).
            stat = n_ready & _subset_np(t_sel[t], n_labels)
            term_ok = _subset_np(t_aff_bits[t], n_labels)  # [A, N]
            A = t_aff_bits.shape[1]
            term_real = np.arange(A) < t_aff_terms[t]
            stat &= (
                np.any(term_ok & term_real[:, None], axis=0)
                | (t_aff_terms[t] == 0)
            )
            untol = n_taints & ~t_tol[t][None, :]
            stat &= np.all(untol == 0, axis=-1)

            future_idle = idle + releasing - pipelined0 - pip_extra
            fit_future = np_less_equal(
                init_req[t][None, :], future_idle, eps, scalar_slot
            )
            total_ntasks = ntasks + pip_ntasks
            pods_ok = (max_tasks <= 0) | (total_ntasks < max_tasks)
            ports_used = nports | pip_nports
            ports_ok = np.all((task_ports[t][None, :] & ports_used) == 0, axis=-1)

            cnt = cnt_alloc + cnt_pip  # [E, D]
            dome = node_dom[:, term_key]  # [N, E]
            cval = cnt[term_ar[None, :], np.maximum(dome, 0)]
            cval = np.where(dome >= 0, cval, 0)
            total = cnt.sum(axis=-1)  # [E]
            aff_term_ok = (cval > 0) | ((total == 0) & t_matches[t])[None, :]
            aff_ok = np.all(~t_req_aff[t][None, :] | aff_term_ok, axis=-1)
            anti_ok = np.all(~t_req_anti[t][None, :] | (cval == 0), axis=-1)

            feasible = stat & fit_future & pods_ok & ports_ok
            feasible = feasible & aff_ok & anti_ok
            if not feasible.any():
                fit_failed[j] = True
                break  # abort the rest of this job's tasks

            score = _node_score(req[t], allocatable, idle, weights)
            pref_match = _subset_np(t_pref[t], n_labels)  # [AP, N]
            score = score + np.float32(weights.node_affinity_weight) * np.sum(
                pref_match * t_prefw[t][:, None], axis=0, dtype=np.float32
            )
            score = score + np.sum(
                t_soft[t][None, :] * cval.astype(np.float32), axis=-1
            )
            score = np.where(feasible, score, np.float32(-3.0e38))
            best = int(np.argmax(score))

            dom_t = node_dom[best, term_key]  # [E]
            inc = t_matches[t] & (dom_t >= 0)
            if np_less_equal(init_req[t], idle[best], eps, scalar_slot):
                idle[best] -= req[t]
                ntasks[best] += 1
                nports[best] |= task_ports[t]
                np.add.at(cnt_alloc, (term_ar, np.maximum(dom_t, 0)),
                          inc.astype(np.int64))
                q_alloc[qj] += req[t]
                assigned[t] = best
                alloc_cnt += 1
                if ready_base[j] + alloc_cnt >= min_available[j]:
                    job_ready = True
            else:
                pip_extra[best] += req[t]
                pip_ntasks[best] += 1
                pip_nports[best] |= task_ports[t]
                np.add.at(cnt_pip, (term_ar, np.maximum(dom_t, 0)),
                          inc.astype(np.int64))
                q_pip[qj] += req[t]
                pipelined[t] = best

        if not job_ready:
            # stmt.Discard: roll back allocation-side effects; pipelines stay.
            idle = ck_idle
            ntasks = ck_ntasks
            nports = ck_nports
            cnt_alloc = ck_cnt
            q_alloc = ck_q_alloc
            assigned = ck_assigned
            never_ready[j] = True

    return OracleResult(
        assigned=assigned,
        pipelined=pipelined,
        never_ready=never_ready,
        fit_failed=fit_failed,
        idle=idle,
        q_alloc=q_alloc + q_pip,
    )


# ---------------------------------------------------------------------------
# Eviction-side oracles (preempt/reclaim/enqueue/backfill): the Go-shaped
# references for the victim-selection machinery in fastpath_evict.py and
# the device victim kernel.  Deliberately naive, sequential NumPy.
# ---------------------------------------------------------------------------


class VictimSelection(NamedTuple):
    evicted: np.ndarray  # indices into the victims arrays, eviction order
    satisfied: bool  # preemptor fits the resulting future idle
    future_idle: np.ndarray  # [R] after the evictions


def oracle_victims(demand, future_idle, victims_res, victims_order,
                   eps, scalar_slot) -> VictimSelection:
    """Per-node victim pop loop (preempt.go:228-242): victims leave in
    inverted task-order (lowest order first — preempt.go:219-224) until
    the preemptor's init request fits the accumulating future idle; the
    preemptor pipelines iff the final fit holds.

    ``victims_order``: sort key per victim, ascending = evicted first
    (the caller encodes task_order_fn: priority asc, creation desc, ...
    inverted).  Ties broken by input index (stable), matching the
    deterministic heap replay of the fast path."""
    demand = np.asarray(demand, np.float32)
    fi = np.array(future_idle, np.float32, copy=True)
    victims_res = np.asarray(victims_res, np.float32)
    order = np.argsort(np.asarray(victims_order), kind="stable")
    evicted = []
    for i in order:
        if np_less_equal(demand, fi, eps, scalar_slot):
            break
        fi = fi + victims_res[i]
        evicted.append(int(i))
    return VictimSelection(
        evicted=np.asarray(evicted, np.int64),
        satisfied=bool(np_less_equal(demand, fi, eps, scalar_slot)),
        future_idle=fi,
    )


def oracle_gang_protection(min_available, ready_counts, victim_jobs):
    """gang.go:74-98 as a mask: walking the candidate victims in order,
    a victim is allowed iff its job's remaining occupancy stays >= its
    MinAvailable after this eviction, or MinAvailable == 1."""
    occupied = {int(j): int(ready_counts[int(j)])
                for j in set(int(j) for j in victim_jobs)}
    allowed = np.zeros(len(victim_jobs), bool)
    for i, j in enumerate(int(j) for j in victim_jobs):
        cnt = occupied[j]
        ma = int(min_available[j])
        if ma <= cnt - 1 or ma == 1:
            occupied[j] = cnt - 1
            allowed[i] = True
    return allowed


def oracle_enqueue(min_res, queue_of_group, group_order, idle_budget,
                   queue_caps, queue_alloc, eps, scalar_slot):
    """enqueue.go:52-132 over dense vectors: groups in (queue order,
    job order) charge MinResources against the overcommitted idle
    budget; the walk stops for everyone once the budget goes empty.

    ``min_res``: [G, R] (NaN row = MinResources nil: charges nothing,
    always accepted while the walk lives); ``queue_caps``: [Q, R] with
    +inf rows for capability-less queues (proportion JobEnqueueable).
    Returns [G] bool inqueue mask."""
    G = len(group_order)
    idle = np.array(idle_budget, np.float32, copy=True)
    q_alloc = np.array(queue_alloc, np.float32, copy=True)
    inqueue = np.zeros(G, bool)
    for g in group_order:
        if bool(np.all(idle < eps)):
            break
        row = min_res[g]
        if np.any(np.isnan(row)):
            inqueue[g] = True
            continue
        q = int(queue_of_group[g])
        if not np_less_equal(row + q_alloc[q], queue_caps[q], eps,
                             scalar_slot):
            continue
        if np_less_equal(row, idle, eps, scalar_slot):
            idle = idle - row
            q_alloc[q] = q_alloc[q] + row
            inqueue[g] = True
    return inqueue


class RebalanceVerdict(NamedTuple):
    frag: np.ndarray          # [N] f32 fragmentation score
    fit_now: np.ndarray       # [N] i64 gang tasks idle holds now
    fit_freed: np.ndarray     # [N] i64 gang tasks after draining
    drain_nodes: np.ndarray   # [K] chosen node indices (selection order)
    feasible: bool            # drain set covers the need within budgets
    budget_blocked: bool      # budgets (not capacity) blocked the plan


def oracle_rebalance(idle, allocatable, ready, evictable, prof_req, eps,
                     need, victims_by_node, victim_group, budget_left,
                     drain_cap) -> RebalanceVerdict:
    """Go-shaped reference for the rebalance planner's scoring +
    drain-set selection (``ops/rebalance.py``): object-at-a-time loops
    over nodes, profiles and victims, no vectorization.  The fast
    planner must agree exactly on ``frag``/``fit_*`` and on the chosen
    drain set (tests/test_rebalance.py parity).

    Definitions (shared spec with ``ops.rebalance.frag_scores`` /
    ``select_drain_set``):

    - per (node, profile) fit = min over requested slots of
      ``floor((plane + eps) / req)``; a profile requesting nothing fits
      0; the node's fit is the max over profiles.
    - frag = mean idle fraction over provisioned slots, zero unless the
      node is ready, holds idle, and fits no gang task as-is.
    - selection: candidates (gain > 0, frag > 0, has victims) sorted by
      ``(victim count, -gain, node)``; each charged against per-group
      budgets; stop at ``need`` covered or ``drain_cap`` taken; an
      uncoverable need returns an empty set.
    """
    idle = np.asarray(idle, np.float32)
    alloc = np.asarray(allocatable, np.float32)
    ev = np.asarray(evictable, np.float32)
    req = np.asarray(prof_req, np.float32)
    eps = np.asarray(eps, np.float32)
    ready = np.asarray(ready, bool)
    N, R = idle.shape
    U = req.shape[0]

    def fit_one(plane_row, req_row):
        cnt = None
        any_req = False
        for r in range(R):
            if req_row[r] <= eps[r]:
                continue
            any_req = True
            c = int(np.floor((plane_row[r] + eps[r]) / max(req_row[r], 1e-9)))
            cnt = c if cnt is None else min(cnt, c)
        if not any_req:
            return 0
        return max(cnt, 0)

    fit_now = np.zeros(N, np.int64)
    fit_freed = np.zeros(N, np.int64)
    frag = np.zeros(N, np.float32)
    for n in range(N):
        best_now = 0
        best_freed = 0
        for u in range(U):
            best_now = max(best_now, fit_one(idle[n], req[u]))
            best_freed = max(best_freed, fit_one(idle[n] + ev[n], req[u]))
        fit_now[n] = best_now
        fit_freed[n] = best_freed
        prov = [r for r in range(R) if alloc[n][r] > eps[r]]
        if not prov:
            idle_frac = 0.0
        else:
            idle_frac = sum(
                min(max(idle[n][r] / max(alloc[n][r], 1e-9), 0.0), 1.0)
                for r in prov
            ) / len(prov)
        has_idle = any(idle[n][r] > eps[r] for r in range(R))
        if ready[n] and has_idle and best_now == 0:
            frag[n] = np.float32(idle_frac)

    # Selection, re-derived independently of select_drain_set's
    # sort-then-walk: repeatedly SCAN all remaining candidates for the
    # best next node by the shared key spec (victim count asc, gain
    # desc, index asc), charging budgets per victim as it goes.  A
    # defect in either formulation (sort order, skip handling, budget
    # charge) diverges here instead of being cloned.
    gain = fit_freed - fit_now

    def is_cand(n):
        return gain[n] > 0 and frag[n] > 0.0 and bool(victims_by_node[n])

    def best_next(taken):
        best = None
        for n in range(N):
            if n in taken or not is_cand(n):
                continue
            key = (len(victims_by_node[n]), -int(gain[n]), n)
            if best is None or key < best[0]:
                best = (key, n)
        return None if best is None else best[1]

    left = dict(budget_left)
    chosen = []
    taken = set()
    acc = 0
    skipped = False
    while acc < need and len(chosen) < drain_cap:
        n = best_next(taken)
        if n is None:
            break
        taken.add(n)
        overdraw = False
        charges = {}
        for row in victims_by_node[n]:
            g = victim_group[row]
            charges[g] = charges.get(g, 0) + 1
        for g, c in charges.items():
            if left.get(g, 0) < c:
                overdraw = True
        if overdraw:
            skipped = True
            continue
        for g, c in charges.items():
            left[g] = left.get(g, 0) - c
        chosen.append(n)
        acc += int(gain[n])
    feasible = acc >= need
    if not feasible:
        # Budget-blocked only when the same greedy with unlimited
        # budgets, under the same cap, would have covered the need —
        # again re-derived as a scan loop.
        taken2 = set()
        unbudgeted = 0
        while len(taken2) < drain_cap:
            n = best_next(taken2)
            if n is None:
                break
            taken2.add(n)
            unbudgeted += int(gain[n])
        return RebalanceVerdict(
            frag=frag, fit_now=fit_now, fit_freed=fit_freed,
            drain_nodes=np.zeros(0, np.int64), feasible=False,
            budget_blocked=bool(skipped and unbudgeted >= need),
        )
    return RebalanceVerdict(
        frag=frag, fit_now=fit_now, fit_freed=fit_freed,
        drain_nodes=np.asarray(chosen, np.int64), feasible=True,
        budget_blocked=False,
    )


class TopologyVerdict(NamedTuple):
    """``oracle_topology`` output: per-block gang-fit planes and the
    deterministic target-block pick, re-derived naively."""

    cfit: np.ndarray      # [B, U] int gang tasks of profile u per block
    whole: np.ndarray     # [B] bool block hosts the WHOLE gang
    score: np.ndarray     # [B] partial-fit score
    frag: np.ndarray      # [B] stranded-partial-slice score
    selected: int         # target block (-1 = none)


def oracle_topology(idle, ready, ntasks, max_tasks, block_id, prof_req,
                    prof_cnt, eps, require) -> TopologyVerdict:
    """Go-shaped reference for the contiguous-block gang scorer
    (``ops/topology.gang_block_fit`` / ``fabric_frag`` /
    ``select_block``): object-at-a-time loops over nodes, profiles and
    blocks, no vectorization.  The kernel must agree exactly
    (tests/test_topology.py parity on seeded fragmented fabrics).

    Definitions (shared spec with ``ops.topology``):

    - per (node, profile) capacity = min over requested slots of
      ``floor((idle + eps) / req)``; a profile requesting nothing
      caps 0; not-ready nodes cap 0; ``max_tasks > 0`` caps by the
      node's remaining pod slots;
    - ``cfit[b, u]`` = sum of the capacity over the block's nodes
      (block -1 nodes belong to no block);
    - ``whole[b]`` = every profile's ``cfit[b, u] >= prof_cnt[u]``;
    - ``score[b]`` = sum of ``min(cfit[b, u], cnt[u])``;
    - ``frag[b]`` = 0 when whole, else ``score[b] / total task count``;
    - selection = max score among candidates (all blocks, or
      whole-gang blocks when ``require``), tie -> lowest block id,
      -1 when no candidate.
    """
    idle = np.asarray(idle, np.float32)
    req = np.asarray(prof_req, np.float32)
    eps = np.asarray(eps, np.float32)
    cnt = np.asarray(prof_cnt, np.int64)
    ready = np.asarray(ready, bool)
    ntasks = np.asarray(ntasks, np.int64)
    max_tasks = np.asarray(max_tasks, np.int64)
    block_id = np.asarray(block_id, np.int64)
    N, R = idle.shape
    U = req.shape[0]
    B = int(block_id.max()) + 1 if len(block_id) else 0

    def cap_one(n, u):
        if not ready[n]:
            return 0
        c = None
        for r in range(R):
            if req[u][r] <= eps[r]:
                continue
            per = int(np.floor(
                np.float32(idle[n][r] + eps[r])
                / np.float32(max(req[u][r], 1e-9))
            ))
            c = per if c is None else min(c, per)
        if c is None:
            return 0
        c = max(c, 0)
        if max_tasks[n] > 0:
            c = min(c, max(int(max_tasks[n] - ntasks[n]), 0))
        return c

    cfit = np.zeros((B, U), np.int64)
    for n in range(N):
        b = int(block_id[n])
        if b < 0:
            continue
        for u in range(U):
            cfit[b][u] += cap_one(n, u)

    whole = np.zeros(B, bool)
    score = np.zeros(B, np.float64)
    frag = np.zeros(B, np.float32)
    total = max(int(cnt.sum()), 1)
    for b in range(B):
        whole[b] = all(cfit[b][u] >= cnt[u] for u in range(U))
        score[b] = sum(min(int(cfit[b][u]), int(cnt[u])) for u in range(U))
        # f32 division to match the kernel's rounding exactly (an f64
        # divide + cast can differ by 1 ulp).
        frag[b] = (np.float32(0.0) if whole[b]
                   else np.float32(score[b]) / np.float32(total))

    selected = -1
    best = None
    for b in range(B):
        if require and not whole[b]:
            continue
        if best is None or score[b] > best:
            best = score[b]
            selected = b
    return TopologyVerdict(cfit=cfit, whole=whole, score=score,
                           frag=frag, selected=selected)


def oracle_backfill(be_feasible, group_inqueue, task_group):
    """backfill.go:39-88: zero-request pending tasks of Inqueue groups
    place on the first feasible node in index order (no resource charge
    — BestEffort).  ``be_feasible``: [T, N] bool.  Returns [T] node or
    -1."""
    T, N = be_feasible.shape
    out = np.full(T, -1, np.int64)
    for t in range(T):
        if not group_inqueue[int(task_group[t])]:
            continue
        feas = np.flatnonzero(be_feasible[t])
        if len(feas):
            out[t] = int(feas[0])
    return out


class EvictWaveVerdict(NamedTuple):
    """``oracle_preempt``/``oracle_reclaim`` output: the victim planes
    and the selected wave, re-derived naively."""

    eligible: np.ndarray   # [V] bool tier-gated victim mask
    order: np.ndarray      # [V] eviction order (eligible first)
    q_share: np.ndarray    # [Q] queue share = max alloc/deserved
    chosen: np.ndarray     # selected victim indices, eviction order
    feasible: bool         # freed capacity covers the need
    budget_blocked: bool   # budgets (not capacity/cap) blocked it
    gain: int              # gang tasks the chosen wave frees


def _oracle_victim_wave(mode, v_ok, v_jprio, v_crank, v_tie, v_queue,
                        v_node, v_req, p_prio, p_queue, q_alloc,
                        q_deserved, q_reclaimable, idle, prof_req, eps,
                        need, v_job, v_group, j_ready, j_minav,
                        budget_left, cap) -> EvictWaveVerdict:
    """Go-shaped reference for the device victim kernel + greedy
    selection (``ops/victim.py``): object-at-a-time loops, the order
    re-derived as a repeated best-next scan instead of a lexsort, the
    fit/slack arithmetic as per-slot loops.  ``mode``: 0 = preempt,
    1 = reclaim.  Shared spec (tests require exact agreement):

    - queue share = max over capped slots (deserved < 1e30) of
      allocated/deserved, 0 with no capped slot.
    - preempt eligibility: base-valid AND same queue as the preemptor
      AND victim job priority strictly lower.
    - reclaim eligibility: base-valid AND a DIFFERENT queue that is
      Reclaimable and overused (share > 1 + 1e-6).
    - eviction order: job priority asc, creation rank desc (youngest
      first), tie asc; ineligible rows order last.
    - selection: victims in order; skip nodes whose full drain gains no
      gang capacity; gang floor (job stays >= minAvailable unless
      minAvailable == 1); one budget charge per victim per PodGroup;
      reclaim keeps the victim queue's share >= 1 - 1e-6 after each
      eviction; stop at need covered or cap victims; prune victims on
      nodes whose final fit never improved; budget_blocked iff the same
      walk with unlimited budgets covers the need.
    """
    v_ok = np.asarray(v_ok, bool)
    v_jprio = np.asarray(v_jprio, np.int64)
    v_crank = np.asarray(v_crank, np.int64)
    v_tie = np.asarray(v_tie, np.int64)
    v_queue = np.asarray(v_queue, np.int64)
    v_node = np.asarray(v_node, np.int64)
    v_req = np.asarray(v_req, np.float32)
    q_alloc = np.asarray(q_alloc, np.float32)
    q_deserved = np.asarray(q_deserved, np.float32)
    idle = np.asarray(idle, np.float32)
    prof_req = np.asarray(prof_req, np.float32)
    eps = np.asarray(eps, np.float32)
    V = len(v_ok)
    Q, R = q_alloc.shape
    U = prof_req.shape[0]

    def share_of(alloc_row, des_row):
        s = np.float32(0.0)
        for r in range(R):
            if des_row[r] < np.float32(1.0e30):
                ratio = np.float32(alloc_row[r]) / np.float32(
                    max(des_row[r], np.float32(1e-9)))
                if ratio > s:
                    s = ratio
        return np.float32(s)

    q_share = np.array([share_of(q_alloc[q], q_deserved[q])
                        for q in range(Q)], np.float32)

    eligible = np.zeros(V, bool)
    for i in range(V):
        if not v_ok[i]:
            continue
        q = int(v_queue[i])
        if mode == 0:
            eligible[i] = (q == int(p_queue)
                           and int(v_jprio[i]) < int(p_prio))
        else:
            eligible[i] = (q != int(p_queue) and 0 <= q < Q
                           and bool(q_reclaimable[q])
                           and float(q_share[q]) > 1.0 + 1e-6)

    # Eviction order: repeated best-next scan by the shared key spec.
    remaining = list(range(V))
    order = []
    while remaining:
        best = None
        for i in remaining:
            # Ineligible rows share one sentinel priority key (the
            # kernel masks their priority before sorting), so their
            # relative order still follows (-crank, tie).
            prio_key = (int(v_jprio[i]) if eligible[i]
                        else np.iinfo(np.int32).max)
            key = (0 if eligible[i] else 1, prio_key,
                   -int(v_crank[i]), int(v_tie[i]))
            if best is None or key < best[0]:
                best = (key, i)
        order.append(best[1])
        remaining.remove(best[1])
    order = np.asarray(order, np.int64)

    def fit_one(plane_row):
        best = 0
        for u in range(U):
            cnt = None
            any_req = False
            for r in range(R):
                if prof_req[u][r] <= eps[r]:
                    continue
                any_req = True
                c = int(np.floor((plane_row[r] + eps[r])
                                 / max(prof_req[u][r], 1e-9)))
                cnt = c if cnt is None else min(cnt, c)
            if any_req:
                best = max(best, max(cnt, 0))
        return best

    evictable = np.zeros_like(idle)
    for i in range(V):
        if eligible[i]:
            evictable[int(v_node[i])] += v_req[i]
    fit0 = {}
    gain_ok = {}
    for n in set(int(v_node[i]) for i in range(V) if eligible[i]):
        fit0[n] = fit_one(idle[n])
        gain_ok[n] = fit_one(idle[n] + evictable[n]) > fit0[n]

    def walk(budgets):
        freed = {}
        cur_fit = {}
        occupancy = {}
        qa = np.array(q_alloc, np.float32)
        chosen = []
        gain = 0
        skipped = False
        for i in order.tolist():
            if not eligible[i]:
                break
            if gain >= need or len(chosen) >= cap:
                break
            n = int(v_node[i])
            if not gain_ok.get(n, False):
                continue
            j = int(v_job[i])
            cnt = occupancy.get(j)
            if cnt is None:
                cnt = int(j_ready[j]) if 0 <= j < len(j_ready) else 0
            minav = int(j_minav[j]) if 0 <= j < len(j_minav) else 1
            if not (minav <= cnt - 1 or minav == 1):
                continue
            g = v_group[i]
            if budgets.get(g, 0) < 1:
                skipped = True
                continue
            if mode == 1:
                q = int(v_queue[i])
                after = share_of(qa[q] - v_req[i], q_deserved[q])
                if float(after) < 1.0 - 1e-6:
                    continue
                qa[q] = qa[q] - v_req[i]
            occupancy[j] = cnt - 1
            budgets[g] = budgets.get(g, 0) - 1
            f = freed.get(n)
            if f is None:
                f = freed[n] = np.zeros(R, np.float32)
            old = cur_fit.get(n, fit0[n])
            f += v_req[i]
            new = fit_one(idle[n] + f)
            cur_fit[n] = new
            gain += new - old
            chosen.append(i)
        dead = {n for n in freed if cur_fit.get(n, fit0[n]) <= fit0[n]}
        if dead:
            chosen = [i for i in chosen if int(v_node[i]) not in dead]
        return chosen, gain, skipped

    chosen, gain, skipped = walk(dict(budget_left))
    if gain >= need:
        return EvictWaveVerdict(
            eligible=eligible, order=order, q_share=q_share,
            chosen=np.asarray(chosen, np.int64), feasible=True,
            budget_blocked=False, gain=gain)
    blocked = False
    if skipped:
        inf = {g: 1 << 30 for g in set(v_group)}
        _, ugain, _ = walk(inf)
        blocked = ugain >= need
    return EvictWaveVerdict(
        eligible=eligible, order=order, q_share=q_share,
        chosen=np.zeros(0, np.int64), feasible=False,
        budget_blocked=blocked, gain=gain)


def oracle_preempt(v_ok, v_jprio, v_crank, v_tie, v_queue, v_node,
                   v_req, p_prio, p_queue, q_alloc, q_deserved,
                   q_reclaimable, idle, prof_req, eps, need, v_job,
                   v_group, j_ready, j_minav, budget_left,
                   cap) -> EvictWaveVerdict:
    """Preempt-mode victim wave (same-queue, strictly lower priority)."""
    return _oracle_victim_wave(
        0, v_ok, v_jprio, v_crank, v_tie, v_queue, v_node, v_req,
        p_prio, p_queue, q_alloc, q_deserved, q_reclaimable, idle,
        prof_req, eps, need, v_job, v_group, j_ready, j_minav,
        budget_left, cap)


def oracle_reclaim(v_ok, v_jprio, v_crank, v_tie, v_queue, v_node,
                   v_req, p_prio, p_queue, q_alloc, q_deserved,
                   q_reclaimable, idle, prof_req, eps, need, v_job,
                   v_group, j_ready, j_minav, budget_left,
                   cap) -> EvictWaveVerdict:
    """Reclaim-mode victim wave (cross-queue, Reclaimable + overused,
    never below deserved)."""
    return _oracle_victim_wave(
        1, v_ok, v_jprio, v_crank, v_tie, v_queue, v_node, v_req,
        p_prio, p_queue, q_alloc, q_deserved, q_reclaimable, idle,
        prof_req, eps, need, v_job, v_group, j_ready, j_minav,
        budget_left, cap)
