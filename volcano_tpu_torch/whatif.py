"""The what-if engine: hypothetical solves, proven atomically.

The counterpart of the JAX package's ``whatif.py`` for the device-native
preempt and reclaim lanes: plan a wave of victims with the
``victim_scores`` kernel (``ops/victim.py``), patch the cycle arrays to
the hypothetically drained cluster, run the *exact* allocate solve over it
(``ops.wave.solve_wave``), judge the verdict, and commit -- evictions
through ``fastpath_evict.EvictState``, restores through the shared
``MigrationLedger`` -- only when the solve proved the outcome.  A plan
mutates nothing until commit, so rejecting one is free.

- ``preempt`` -- a starved higher-priority gang drains same-queue
  lower-priority victims; victims do not re-enter the solve, they are
  restored as Pending by the ledger and wait their turn.
- ``reclaim`` -- a gang in an under-deserved queue drains victims from
  OTHER queues that are reclaimable and over their deserved share, never
  below deserved.
- ``rebalance`` -- drain fragmented nodes (``FastCycle._plan_rebalance``
  picks them with the ``frag_scores`` kernel); the victims re-enter the
  what-if solve beside the gang, and the plan commits only when every
  victim re-places too.

The what-if solve runs on the cycle's device with no device-incremental
state (it neither builds nor reuses static planes or warm shortlists and
anchors no dirty set), never writes through the live cycle's arrays, and
restores the store's encode cache around its encode.  Pipelined stores
park the what-if as ``pipeline.InflightPlan``, its solve on the store's
solve worker behind the allocate lane's, and commit it at the next cycle's
top behind the staleness guard: any ``mutation_seq`` / ``epoch`` /
``compact_gen`` / node-count drift voids the plan wholesale
(``commit_inflight_plan``).  The JAX package's mesh dispatch and
remote-solver offload are unreachable here: the port refuses meshes and
remote solvers up front (``FastCycle.check_ported``).

Every function here runs on the cycle thread inside ``FastCycle.run``
(under ``run_cycle_fast``'s store lock).
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .api import TaskStatus
from .metrics import metrics


F = np.float32
I = np.int32


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def evict_device_enabled() -> bool:
    """Master switch for the device-native preempt/reclaim lanes.
    ``VOLCANO_TPU_EVICT_DEVICE=0`` asks for the host-side victim walk,
    which the port does not run yet (the cycle raises)."""
    return os.environ.get("VOLCANO_TPU_EVICT_DEVICE", "1") != "0"


def evict_cap() -> int:
    """Max victims one preempt/reclaim wave may take."""
    return max(1, _env_int("VOLCANO_TPU_EVICT_CAP", 64))


class WhatIfPlan(NamedTuple):
    """One hypothetical eviction wave.  The preempt and reclaim lanes
    solve the gang alone (``resolve_victims`` False): victims restore as
    Pending and wait.  Rebalance re-solves its victims beside the gang
    (``resolve_victims`` True)."""

    action: str                  # "preempt" | "reclaim" | "rebalance"
    gang_job: int                # mirror job row of the starved gang
    gang_uid: str                # its PodGroup uid (events / ledger)
    gang_rows: np.ndarray        # [G] pending mirror rows entering the solve
    victim_rows: np.ndarray      # [V] running mirror rows to evict
    victim_jobs: np.ndarray      # [V] mirror job rows of the victims
    drain_nodes: np.ndarray      # [K] node rows drained (rebalance; else [])
    need: int                    # gang tasks outstanding at plan time
    frag_before: float           # mean frag score (rebalance; else 0.0)
    budgets: Dict[str, int]      # group uid -> victims this plan takes
    resolve_victims: bool        # victims re-enter the what-if solve


# --------------------------------------------------------------- ordering


def plan_task_order(plan: WhatIfPlan):
    """(solve_jobs, task_rows, victims-in-solve-order) for a plan's
    what-if solve: the starved gang's pending rows first (it is the point
    of the wave), then -- only when the plan re-solves its victims -- the
    victims job-contiguously, the order the assignment vector is aligned
    to."""
    if not plan.resolve_victims or not len(plan.victim_rows):
        return ([plan.gang_job], plan.gang_rows.astype(np.int64),
                np.zeros(0, np.int64))
    vorder = np.argsort(plan.victim_jobs, kind="stable")
    vr = plan.victim_rows[vorder]
    task_rows = np.concatenate([plan.gang_rows, vr]).astype(np.int64)
    solve_jobs = [plan.gang_job]
    seen = {plan.gang_job}
    for j in plan.victim_jobs[vorder].tolist():
        if j not in seen:
            seen.add(j)
            solve_jobs.append(int(j))
    return solve_jobs, task_rows, vr


# ----------------------------------------------------------- input patch


def whatif_inputs(cyc, plan: WhatIfPlan):
    """Solver inputs for the hypothetically drained cluster: the drained
    victims' capacity returns to idle, their rows leave the resident set,
    their jobs' ready counts drop and their queues' allocations shrink by
    the drained members.  When the plan re-solves its victims,
    queue-deserved gating is lifted for the victim queues only.  The
    cycle's planes are swapped for patched copies around the encode and
    swapped back after it, and the store's encode cache and profile
    generation are saved and restored: the what-if entry would evict the
    live lane's entry and bump the generation that keys the
    device-incremental planes."""
    m = cyc.m
    # Deferred aggregate scatters must land on the REAL q_alloc before it
    # is copied, or they would be lost to the patch.
    cyc._flush_aggr()
    solve_jobs, task_rows, vr = plan_task_order(plan)
    vnode = m.p_node[:cyc.Pn][plan.victim_rows].astype(np.int64)
    er, si, v = m.c_req.gather(plan.victim_rows)
    idle_patch = cyc.n_idle.copy()
    np.add.at(idle_patch, (vnode[er], si), v)
    ntasks_patch = cyc.n_ntasks - np.bincount(
        vnode, minlength=cyc.Nn).astype(I)
    ready_patch = cyc.j_ready_base.copy()
    np.add.at(ready_patch, plan.victim_jobs, -1)
    resident_patch = cyc.resident.copy()
    resident_patch[plan.victim_rows] = False
    deserved_patch = cyc.q_deserved.copy()
    q_alloc_patch = cyc.q_alloc.copy()
    vq = cyc.q_of_job[plan.victim_jobs]
    vq_ok = vq >= 0
    if vq_ok.any():
        if plan.resolve_victims:
            deserved_patch[np.unique(vq[vq_ok])] = 3.0e38
        # Un-charge the drained victims so a gang sharing a victim's
        # queue is not double-gated against allocations the eviction
        # itself returns.
        er_q = vq_ok[er]
        np.add.at(q_alloc_patch, (vq[er][er_q], si[er_q]), -v[er_q])
    saved = (cyc.n_idle, cyc.n_ntasks, cyc.j_ready_base,
             cyc.resident, cyc.q_deserved, cyc.q_alloc)
    (cyc.n_idle, cyc.n_ntasks, cyc.j_ready_base, cyc.resident,
     cyc.q_deserved, cyc.q_alloc) = (
        idle_patch, ntasks_patch, ready_patch, resident_patch,
        deserved_patch, q_alloc_patch)
    store = cyc.store
    saved_cache = store._encode_cache
    saved_gen = getattr(store, "_encode_gen", 0)
    try:
        inputs, pid, profiles, ncls = cyc._solve_inputs(
            solve_jobs, task_rows, slim=True)
    finally:
        (cyc.n_idle, cyc.n_ntasks, cyc.j_ready_base,
         cyc.resident, cyc.q_deserved, cyc.q_alloc) = saved
        store._encode_cache = saved_cache
        store._encode_gen = saved_gen
    return inputs, pid, profiles, ncls


# ------------------------------------------------------ dispatch / commit


def dispatch_plan(cyc, plan: WhatIfPlan) -> None:
    """Run (or, pipelined, park) the plan's what-if solve on the cycle's
    device and judge it.  No device-incremental state rides along (the JAX
    package passes none to the plan solve either)."""
    from .ops.wave import solve_wave

    m = cyc.m
    store = cyc.store
    with cyc.tracer.span(
            "whatif_solve", cat="whatif",
            args={"action": plan.action, "gang": plan.gang_uid,
                  "victims": len(plan.victim_rows),
                  "need": plan.need}):
        inputs, pid, profiles, ncls = whatif_inputs(cyc, plan)
        if cyc._pipeline_on:
            from .pipeline import PLAN_FIELDS, InflightPlan, dispatch_solve

            job = dispatch_solve(
                store, cyc.device, inputs, PLAN_FIELDS,
                snap=getattr(store, "device_snapshot", None), pid=pid,
                profiles=profiles, taint_any=cyc._taint_any,
                node_classes=ncls)
            store._solve_seq += 1
            store._inflight_plan = InflightPlan(
                job, plan, m.mutation_seq, m.epoch, m.compact_gen, cyc.Nn,
                plan_id=store._solve_seq)
            return
        res = solve_wave(*inputs, pid=pid, profiles=profiles,
                         taint_any=cyc._taint_any, node_classes=ncls,
                         device=cyc.device)
        # One device -> host copy of the two results the verdict reads.
        P = int(res.assigned.shape[0])
        packed = torch.cat([
            res.assigned.reshape(-1).to(torch.int32),
            res.never_ready.reshape(-1).to(torch.int32),
        ]).cpu().numpy()
        assigned, never_ready = packed[:P], packed[P:].astype(bool)
    apply_plan(cyc, plan, assigned, never_ready)


def commit_inflight_plan(cyc) -> None:
    """Land (or void) the previous cycle's pipelined what-if plan.  A
    whole-cluster what-if has no per-row salvage, so ANY drift -- mutation
    counter, node-table epoch, compaction generation, node count -- voids
    the plan wholesale (it mutated nothing; the planner re-forms against
    fresh state).  An error the worker raised propagates."""
    from .pipeline import take_inflight_plan

    inflight = take_inflight_plan(cyc.store)
    if inflight is None:
        return
    m = cyc.m
    plan = inflight.plan
    with cyc.tracer.span(
            "whatif_commit", cat="whatif", lanes=cyc.lanes,
            lane=plan.action,
            args={"plan_id": inflight.plan_id,
                  "action": plan.action, "gang": plan.gang_uid,
                  "victims": len(plan.victim_rows)}):
        if (m.mutation_seq != inflight.mutation_seq
                or m.epoch != inflight.epoch
                or m.compact_gen != inflight.compact_gen
                or cyc.Nn != inflight.n_nodes):
            inflight.abandon()
            count_plan(cyc, plan.action, "stale-voided",
                       gang=plan.gang_uid,
                       victims=len(plan.victim_rows))
            return
        assigned, never_ready = inflight.fetch()
        apply_plan(cyc, plan, assigned, never_ready)


def apply_plan(cyc, plan: WhatIfPlan, assigned: np.ndarray,
               never_ready: np.ndarray) -> None:
    """Judge the what-if verdict and commit iff the solve proved the
    wave's point: the gang reaches ready."""
    from .actions.rebalance import min_gain

    m = cyc.m
    _, task_rows, vr_sorted = plan_task_order(plan)
    assigned = assigned[:len(task_rows)].astype(np.int64)
    G = len(plan.gang_rows)
    # The gang must still be the pending work the plan targeted.
    gr = plan.gang_rows
    st_pending = int(TaskStatus.Pending)
    if not bool((m.p_alive[gr] & (m.p_status[gr] == st_pending)).all()):
        count_plan(cyc, plan.action, "stale-voided", gang=plan.gang_uid,
                   victims=len(plan.victim_rows))
        return
    gang_assigned = int((assigned[:G] >= 0).sum())
    victims_ok = (bool((assigned[G:] >= 0).all())
                  if len(assigned) > G else True)
    gang_ready = (
        not bool(never_ready[0])
        and cyc.j_ready_base[plan.gang_job] + gang_assigned
        >= int(m.j_minav[plan.gang_job])
    )
    floor = min_gain() if plan.action == "rebalance" else 1
    if not (victims_ok and gang_ready and gang_assigned >= floor):
        count_plan(cyc, plan.action, "rejected-no-gain",
                   gang=plan.gang_uid, need=plan.need,
                   victims=len(plan.victim_rows),
                   gang_placed=gang_assigned,
                   frag=round(plan.frag_before, 4))
        # The identical plan would re-form (and re-fail) next cycle; cool
        # down until the cluster has had time to move.
        set_backoff(cyc.store, plan.action, plan.gang_uid,
                    cyc.REBALANCE_REJECT_BACKOFF)
        return
    if plan.resolve_victims:
        victim_nodes = assigned[G:]
    else:
        vr_sorted = plan.victim_rows.astype(np.int64)
        victim_nodes = np.full(len(vr_sorted), -1, np.int64)
    commit_plan(cyc, plan, vr_sorted, victim_nodes)


def commit_plan(cyc, plan: WhatIfPlan, victim_rows: np.ndarray,
                victim_nodes: np.ndarray) -> None:
    """Execute a proven plan: evict every victim through the cycle's
    ``EvictState`` (flushed to the store at cycle end) and register each
    restore with the shared migration ledger so no pod is ever lost."""
    from .actions.rebalance import ledger_of, max_unavailable_of

    m = cyc.m
    store = cyc.store
    st_running = int(TaskStatus.Running)
    # Exact commit re-check: victims must still be the Running residents
    # the plan drained.
    ok = m.p_alive[victim_rows] & (m.p_status[victim_rows] == st_running)
    if not bool(ok.all()):
        count_plan(cyc, plan.action, "stale-voided",
                   gang=plan.gang_uid, victims=len(victim_rows))
        return
    ledger = ledger_of(store)
    # Budget re-check at commit time, against the ledger's live
    # cross-action disrupted counts: the engine's actions share one
    # disruption-budget pool per PodGroup.
    for uid, n_new in plan.budgets.items():
        row = m.j_row.get(uid, -1)
        pg = m.j_pg[row] if row >= 0 else None
        if (ledger.disrupted(store, uid) + n_new
                > max_unavailable_of(pg)):
            count_plan(cyc, plan.action, "rejected-budget",
                       gang=plan.gang_uid, victims=len(victim_rows))
            return
    st = cyc._evict_machinery()
    events = []
    reason = plan.action.capitalize()  # Preempt, Reclaim, Rebalance
    for row, tgt in zip(victim_rows.tolist(), victim_nodes.tolist()):
        st.evict(int(row))
        st.evicted_rows.append(int(row))
        tgt_name = m.n_name[int(tgt)] if 0 <= int(tgt) < cyc.Nn else ""
        # Journey: the victim's timeline shows the planned target, so the
        # later restore stitch reads as one migration.
        cyc._journey_event(int(row), "migration-planned",
                           detail=tgt_name)
        ledger.register(m.p_uid[row], m.j_uid[int(cyc.jobr[row])],
                        tgt_name, action=plan.action,
                        for_gang=plan.gang_uid)
        events.append((
            f"Pod/{m.p_key[row]}", reason,
            f"evicted for gang {plan.gang_uid} "
            f"({plan.action} what-if plan"
            + (f", planned node {tgt_name})" if tgt_name else ")"),
        ))
    ledger.committed_plans += 1
    # Evictions moved mirror state.  Eviction counters are bumped at the
    # cycle-end flush (EvictState.flush), where a failed dispatch reverts
    # its victim.
    m.mutation_seq += 1
    store.record_events_deferred(events)
    count_plan(cyc, plan.action, "committed", gang=plan.gang_uid,
               need=plan.need, victims=len(victim_rows),
               drain_nodes=len(plan.drain_nodes),
               frag=round(plan.frag_before, 4))


# ------------------------------------------------------------ accounting


def count_plan(cyc, action: str, outcome: str, **info) -> None:
    """Fold a plan outcome into the counter series and the cycle's
    flight-recorder accounting; an earlier outcome of the same cycle is
    kept under ``prior``.  Rebalance keeps its own
    ``volcano_rebalance_plans_total`` series and flight-record slot beside
    the engine-wide ones."""
    metrics.whatif_plans.inc(action=action, outcome=outcome)
    if action == "rebalance":
        metrics.rebalance_plans.inc(outcome=outcome)
        key = "rebalance"
        d = {"outcome": outcome}
    else:
        key = "whatif"
        d = {"action": action, "outcome": outcome}
    d.update(info)
    existing = cyc.stats.get(key)
    if existing is not None:
        d["prior"] = existing.pop("prior", []) + [existing]
    cyc.stats[key] = d


# --------------------------------------------------- streaks / backoffs


def update_streaks(store, action: str, uids) -> Tuple[dict, dict]:
    """Per-(action, gang) starvation streaks + rejection backoffs: a
    rejected plan cools the gang down instead of re-paying the kernel and
    the what-if every cycle.  Leaving the starved set clears both."""
    streaks, backoff = store._whatif_streaks, store._whatif_backoff
    live = {(action, uid) for uid in uids}
    for key in list(streaks):
        if key[0] == action and key not in live:
            del streaks[key]
    for key in live:
        streaks[key] = streaks.get(key, 0) + 1
    for key in list(backoff):
        if key[0] != action:
            continue
        if key not in live:
            del backoff[key]
        elif backoff[key] > 0:
            backoff[key] -= 1
    return streaks, backoff


def set_backoff(store, action: str, uid: str, passes: int) -> None:
    if action == "rebalance":
        # The rebalance lane keeps its own per-uid map (cleared by its own
        # streak bookkeeping, FastCycle._find_starved_gang).
        store._rebalance_backoff[uid] = passes
        return
    store._whatif_backoff[(action, uid)] = passes


# ------------------------------------------------------------- planners


def _starved_candidates(cyc):
    """Session job rows that are schedulable-but-unready gangs."""
    m = cyc.m
    srows = np.asarray(cyc.session_jobs, np.int64)
    if not len(srows):
        return srows
    mask = (
        (cyc.j_phase[srows] != 1)  # Inqueue gate, as _schedulable_rows
        & (cyc.j_cnt_pending[srows] > 0)
        & (cyc.j_ready_base[srows] < m.j_minav[srows])
        & (cyc.j_valid[srows] >= m.j_minav[srows])
        & (cyc.q_of_job[srows] >= 0)
    )
    return srows[mask]


def _gang_profile_table(cyc, pend: np.ndarray):
    """(gang_rows, [Up, R] init-request table) of a gang's pending
    non-best-effort task rows ``pend`` (ascending), profile-deduped and
    padded as the JAX planner builds it (all-zero pad rows are inert in
    ``fit_counts``)."""
    from .fastpath import _pow2

    m = cyc.m
    if not len(pend):
        return pend, None
    gang_rows = pend[np.argsort(m.p_create[pend], kind="stable")]
    _, first = np.unique(m.p_prof[gang_rows], return_index=True)
    urows = gang_rows[np.sort(first)]
    Up = _pow2(max(len(urows), 1), 4)
    prof_req = np.zeros((Up, cyc.R), F)
    er, si, v = m.c_init_req.gather(urows)
    prof_req[er, si] = v
    return gang_rows, prof_req


def _victim_base(cyc, gang_jrow: int) -> np.ndarray:
    """Mirror rows eligible as wave victims BEFORE tier gating: Running
    residents with requests, not critical (conformance), without required
    inter-pod terms, never the starved gang itself."""
    m = cyc.m
    Pn = cyc.Pn
    st_running = int(TaskStatus.Running)
    vict = np.flatnonzero(
        cyc.resident[:Pn]
        & (m.p_status[:Pn] == st_running)
        & ~m.p_critical[:Pn]
        & ~m.p_has_ip[:Pn]
        & (cyc.jobr >= 0)
        & (cyc.jobr != gang_jrow)
    )
    if len(vict):
        vict = vict[m.c_req.lens(vict) > 0]
    return vict.astype(np.int64)


def _budget_left(cyc, groups) -> Dict[str, int]:
    """Remaining per-PodGroup disruption budget after waves already in
    flight, across every action sharing the ledger."""
    from .actions.rebalance import max_unavailable_of

    m = cyc.m
    ledger = cyc.store.migrations
    out: Dict[str, int] = {}
    for uid in set(groups):
        row = m.j_row.get(uid, -1)
        pg = m.j_pg[row] if row >= 0 else None
        used = (ledger.disrupted(cyc.store, uid)
                if ledger is not None else 0)
        out[uid] = max_unavailable_of(pg) - used
    return out


class _VictimPass:
    """The victim rows and kernel planes of one planning pass.

    Every gang a pass considers sees the same cluster (nothing commits
    until a plan is returned), so the victim rows -- Running residents with
    requests, minus the gang's own -- and the kernel's planes for one
    (gang priority, gang queue) pair are the same for every gang without
    Running members of its own: they are built once and reused.  A gang
    with Running members gets its rows and planes afresh.  The planes are a
    pure function of these inputs, so this is exact; the JAX planner
    re-runs the kernel for every gang (thousands per cycle while a queue of
    starved gangs finds no eligible victim)."""

    def __init__(self, cyc, mode: int):
        self.cyc = cyc
        self.mode = mode
        m = cyc.m
        Pn = cyc.Pn
        self.base = _victim_base(cyc, -1)
        self.base_jobs = cyc.jobr[self.base].astype(np.int64)
        self.victim_jobs = set(np.unique(self.base_jobs).tolist())
        # Pending non-best-effort rows grouped by job, ascending rows.
        pend = np.flatnonzero(
            m.p_alive[:Pn] & (m.p_status[:Pn] == int(TaskStatus.Pending))
            & ~m.p_be[:Pn] & (cyc.jobr >= 0))
        pend = pend[np.argsort(cyc.jobr[pend], kind="stable")]
        jobs, starts = np.unique(cyc.jobr[pend], return_index=True)
        self.pending = dict(zip(jobs.tolist(),
                                np.split(pend, starts[1:].tolist())))
        self.rows: Dict[int, tuple] = {}
        self.planes: Dict[tuple, tuple] = {}
        self.q_planes = None

    def gang_rows(self, jrow: int) -> np.ndarray:
        return self.pending.get(jrow, np.zeros(0, np.int64))

    def victims(self, jrow: int):
        """(vict, vjobs, kernel row arrays, groups, key) for gang
        ``jrow``."""
        key = jrow if jrow in self.victim_jobs else -1
        hit = self.rows.get(key)
        if hit is None:
            vict = (self.base[self.base_jobs != jrow] if key >= 0
                    else self.base)
            hit = self.rows[key] = (vict,) + self._row_arrays(vict)
        return hit + (key,)

    def _row_arrays(self, vict):
        cyc = self.cyc
        m = cyc.m
        vjobs = cyc.jobr[vict].astype(np.int64)
        # A victim whose job has no known queue has no share to gate on:
        # excluded at the base level rather than clipped onto queue 0.
        v_ok = cyc.q_of_job[vjobs] >= 0
        v_jprio = m.j_prio[vjobs].astype(I)
        # Creation rank: larger = younger (evicted first among equals).
        v_crank = np.argsort(
            np.argsort(m.p_create[vict], kind="stable")).astype(I)
        v_tie = np.arange(len(vict), dtype=I)
        v_queue = cyc.q_of_job[vjobs].astype(I)
        v_node = m.p_node[:cyc.Pn][vict].astype(I)
        v_req = np.zeros((len(vict), cyc.R), F)
        er, si, vv = m.c_req.gather(vict)
        v_req[er, si] = vv
        groups = [m.j_uid[int(j)] for j in vjobs]
        return (vjobs, (v_ok, v_jprio, v_crank, v_tie, v_queue, v_node,
                        v_req), groups)

    def fetch(self, key: int, arrays, prio: int, queue: int):
        """(eligible, order, evictable) as numpy: one kernel run and one
        device -> host copy per (rows, priority, queue)."""
        from .fastpath import _pow2
        from .ops import victim as vk

        hit = self.planes.get((key, prio, queue))
        if hit is not None:
            return hit
        cyc = self.cyc
        if self.q_planes is None:
            Qp = _pow2(max(cyc.Qn, 1), 4)
            q_alloc_p = np.zeros((Qp, cyc.R), F)
            q_des_p = np.full((Qp, cyc.R), 3.0e38, F)
            q_alloc_p[:cyc.Qn] = cyc.q_alloc
            q_des_p[:cyc.Qn] = cyc.q_deserved
            q_rec = np.zeros(Qp, bool)
            for name, qi in cyc.queue_index.items():
                q = cyc.store.queues.get(name)
                q_rec[qi] = bool(q is not None and q.reclaimable())
            self.q_planes = (q_alloc_p, q_des_p, q_rec)
        planes = vk.victim_scores(
            *arrays, prio, queue, *self.q_planes, self.mode,
            max(cyc.Nn, 1), device=cyc.device)
        V = len(arrays[0])
        packed = torch.cat([
            planes.eligible.to(torch.float32),
            planes.order.to(torch.float32),
            planes.evictable.reshape(-1),
        ]).cpu().numpy()
        hit = self.planes[(key, prio, queue)] = (
            packed[:V] != 0, packed[V:2 * V].astype(np.int64),
            packed[2 * V:].reshape(-1, cyc.R))
        return hit


def _plan_evict(cyc, action: str) -> Optional[WhatIfPlan]:
    """Plan one preempt/reclaim wave: pick the starved gang, score and
    rank victims with the kernel (ops/victim.py), select under budgets,
    and return the plan for the what-if solve to prove."""
    from .ops import victim as vk

    m = cyc.m
    store = cyc.store
    # Deferred aggregate scatters (same-cycle bind charges) must land
    # before any queue-share read below.
    cyc._flush_aggr()
    cand = _starved_candidates(cyc)
    is_reclaim = action == "reclaim"
    if is_reclaim and len(cand):
        q_share_host = vk.queue_shares(cyc.q_alloc, cyc.q_deserved)
        # Reclaim serves queues still UNDER their deserved share; a gang
        # in an overused queue must preempt within it instead.
        under = q_share_host[cyc.q_of_job[cand]] <= 1.0 + vk.SHARE_TOL
        cand = cand[under]
    uids = [m.j_uid[int(r)] for r in cand]
    streaks, backoff = update_streaks(store, action, uids)
    if not len(cand):
        return None
    # Pipelined cycles see starvation one commit behind.
    need_streak = 2 if cyc._pipeline_on else 1
    ledger = store.migrations
    needs = (m.j_minav[cand] - cyc.j_ready_base[cand]).astype(np.int64)
    prios = m.j_prio[cand].astype(np.int64)
    # Highest-priority gang first (the point of preemption), then the
    # largest shortfall, then the lowest row for determinism.
    order = np.lexsort((cand, -needs, -prios))
    vpass = _VictimPass(cyc, vk.RECLAIM if is_reclaim else vk.PREEMPT)
    # Gangs whose prior wave is still freeing capacity (victims evicted,
    # not yet restored): re-planning for them would double-evict for the
    # same need.  The JAX planner asks the ledger per gang
    # (``wave_pending``, which prunes it each time); here the ledger is
    # pruned once, at the first gang that reaches the check, since nothing
    # moves it during the pass.
    waves = None
    with cyc.tracer.span(f"{action}_plan", cat="whatif"):
        for r in cand[order]:
            jrow = int(r)
            uid = m.j_uid[jrow]
            if streaks.get((action, uid), 0) < need_streak \
                    or backoff.get((action, uid), 0) > 0:
                continue
            if ledger is not None:
                if waves is None:
                    ledger.prune(store)
                    waves = {e.for_gang for e in ledger.entries.values()
                             if e.restored_uid is None}
                if uid in waves:
                    continue
            plan = _plan_evict_gang(cyc, action, jrow, vpass)
            if plan is not None:
                return plan
    return None


def _plan_evict_gang(cyc, action: str, jrow: int,
                     vpass: _VictimPass) -> Optional[WhatIfPlan]:
    from .ops import victim as vk

    m = cyc.m
    store = cyc.store
    is_reclaim = action == "reclaim"
    need = int(m.j_minav[jrow] - cyc.j_ready_base[jrow])
    if need <= 0:
        return None
    gang_rows, prof_req = _gang_profile_table(cyc, vpass.gang_rows(jrow))
    if prof_req is None:
        return None
    # Unpadded victim rows (the JAX planner pads V, N and Q to powers of
    # two; the kernel's order over the real rows is the same).
    vict, vjobs, arrays, groups, key = vpass.victims(jrow)
    if not len(vict):
        return None
    eligible, order, evictable = vpass.fetch(
        key, arrays, int(m.j_prio[jrow]), int(cyc.q_of_job[jrow]))
    if not bool(eligible.any()):
        return None
    _v_ok, _v_jprio, _v_crank, _v_tie, v_queue, v_node, v_req = arrays
    budget_left = _budget_left(cyc, groups)
    qa_sel = qd_sel = None
    if is_reclaim:
        qa_sel = cyc.q_alloc.astype(F)
        qd_sel = cyc.q_deserved.astype(F)
    sel = vk.select_victims(
        order, eligible, v_node, v_req, vjobs, groups, v_queue, need,
        cyc.n_idle.astype(F), evictable, prof_req, cyc.eps,
        cyc.j_ready_base, m.j_minav, budget_left, evict_cap(),
        q_alloc=qa_sel, q_deserved=qd_sel,
    )
    uid = m.j_uid[jrow]
    if not sel.feasible:
        if sel.budget_blocked:
            count_plan(cyc, action, "rejected-budget", gang=uid, need=need)
        # Cooldown either way: no wave can form until the cluster moves.
        set_backoff(store, action, uid, cyc.REBALANCE_REJECT_BACKOFF)
        return None
    chosen = np.asarray(sel.chosen, np.int64)
    victim_rows = vict[chosen]
    victim_jobs = vjobs[chosen]
    budgets: Dict[str, int] = {}
    for j in victim_jobs.tolist():
        g = m.j_uid[int(j)]
        budgets[g] = budgets.get(g, 0) + 1
    return WhatIfPlan(
        action=action, gang_job=jrow, gang_uid=uid,
        gang_rows=gang_rows, victim_rows=victim_rows,
        victim_jobs=victim_jobs,
        drain_nodes=np.zeros(0, np.int64), need=need,
        frag_before=0.0, budgets=budgets, resolve_victims=False,
    )


def run_evict_action(cyc, action: str) -> None:
    """The device-native preempt/reclaim lane body: plan, prove, commit (or
    park the proof for the next cycle's top).  One what-if wave is in
    flight at a time across every engine action: the ``_inflight_plan``
    slot is shared."""
    if cyc.store._inflight_plan is not None:
        return
    plan = _plan_evict(cyc, action)
    if plan is None:
        return
    dispatch_plan(cyc, plan)
