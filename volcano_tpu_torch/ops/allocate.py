"""The exact sequential allocate solver, its containers and the
encoded-arrays -> solve-args builder.

The counterpart of the JAX package's ``ops/allocate.py``: the
``SolveNodes/Tasks/Jobs/Queues`` inputs and the ``AllocResult`` output of
the allocate solvers, ``NEG`` (the infeasible-score sentinel),
``solve_inputs``, and ``solve`` -- Volcano's allocate loop
(``allocate.go:40-250``) as one sequential pass over the job-contiguous
task rows (the JAX ``fori_loop``, :276-458).  Leaves are numpy arrays on
the host and torch tensors on the device.

``solve`` runs on the card as the ``seq_solve`` kernel
(``csrc/seq_solve.cu``: a row pass, then one persistent block that keeps
each profile of equal rows' node keys and rescores only the nodes a step
changed; no host read until the result) and on CPU tensors as
``_solve_plain``, the same
arithmetic in PyTorch.  Per task row: predicates from the bitsets, the fit
on FutureIdle ((idle + releasing) - pipelined) - pip_extra, pod slots,
host ports, inter-pod verdicts on the live counts and ``extra_ok``; the
score ((node_score + extra_score) + naff * sum_AP(pref)) + sum_E(soft);
the masked argmax (lowest node index wins ties); allocate when the task
fits the live idle, else pipeline onto future capacity.  A task with no
feasible node aborts the rest of its job; a job over its queue's deserved
share is skipped at its boundary; a job that never became ready is rolled
back at the next boundary by replaying its rows' adds in ascending row
order (``_undo_job``, :245-274).  Pipeline-side state survives the
rollback (session-level Pipeline).

An update the JAX solve makes with a masked-out zero (``x + 0.0`` on an
inactive step, or on an unassigned row of a discarded job) is skipped
here: it could only turn a -0.0 into +0.0, and no idle, queue or pipelined
plane holds a -0.0 (they start from non-negative sums and x - x is +0.0).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device, to_tensor
from .resreq import less_equal
from .scoring import node_score

NEG = float(np.float32(-3.0e38))

# The last sequential solve's per-job allocation counts ([J] int32 on the
# solve's device; a discarded job keeps its count).  With the pipelined
# rows and the fit failures they give the rows the solve scored against
# every node: alloc_cnt.sum() + (pipelined >= 0).sum() + fit_failed.sum().
LAST_SEQ: dict = {}


class SolveNodes(NamedTuple):
    """Node-side solver inputs (all leading dim N)."""

    idle: object  # [N, R]
    allocatable: object  # [N, R]
    releasing: object  # [N, R]
    pipelined: object  # [N, R]
    ntasks: object  # [N] int32
    max_tasks: object  # [N] int32 (0 = unlimited)
    ports: object  # [N, PW] uint32
    ready: object  # [N] bool (ready & schedulable & real)
    label_bits: object  # [N, LW] uint32
    taint_bits: object  # [N, TW] uint32


class SolveTasks(NamedTuple):
    """Task-side solver inputs (leading dim P, job-contiguous order)."""

    req: object  # [P, R]
    init_req: object  # [P, R]
    job: object  # [P] int32
    real: object  # [P] bool
    ports: object  # [P, PW] uint32
    sel_bits: object  # [P, LW] node-selector label pairs (AND)
    aff_bits: object  # [P, A, LW] required node-affinity alternatives
    aff_terms: object  # [P] int32 number of alternatives (0 = none)
    tol_bits: object  # [P, TW] tolerated taints
    pref_bits: object  # [P, AP, LW] preferred node-affinity terms
    pref_w: object  # [P, AP] float32 term scores (pre-normalized *10)


class SolveJobs(NamedTuple):
    queue: object  # [J] int32
    min_available: object  # [J] int32
    ready_base: object  # [J] int32


class SolveQueues(NamedTuple):
    deserved: object  # [Q, R] (+inf when proportion disabled)
    allocated: object  # [Q, R] at session open


class AllocResult(NamedTuple):
    assigned: object  # [P] committed node index or -1
    pipelined: object  # [P] pipelined node index or -1
    never_ready: object  # [J] bool (gang discard happened)
    fit_failed: object  # [J] bool
    idle: object  # [N, R] final idle
    q_alloc: object  # [Q, R] final queue allocated (incl. pipelines)
    iters: object = None  # [] total attempt iterations (diagnostics)
    # Two-phase wave solve only (ops/wave.py): shortlist-fallback
    # rescore counts by reason — profiles whose candidate shortlist ran
    # dry (exhausted) vs required-(anti)affinity profiles whose live
    # domain landscape drifted from the solve-start counts the
    # shortlist was built on.  None from the sequential solver.
    fb_exhausted: object = None  # [] int32
    fb_affinity: object = None  # [] int32


def solve_inputs(arrays, deserved=None, q_alloc0=None):
    """Build the (nodes, tasks, jobs, queues) solver groups from encoded
    ClusterArrays.  ``deserved`` defaults to +inf (proportion gating off)."""
    n, t, j, q = arrays.nodes, arrays.tasks, arrays.jobs, arrays.queues
    Q, R = q.capability.shape
    if deserved is None:
        deserved = np.full((Q, R), 3.0e38, np.float32)
    if q_alloc0 is None:
        q_alloc0 = q.allocated
    return (
        SolveNodes(
            idle=n.idle,
            allocatable=n.allocatable,
            releasing=n.releasing,
            pipelined=n.pipelined,
            ntasks=n.num_tasks,
            max_tasks=n.max_tasks,
            ports=n.port_bits,
            ready=n.ready & n.real,
            label_bits=n.label_bits,
            taint_bits=n.taint_bits,
        ),
        SolveTasks(
            req=t.req,
            init_req=t.init_req,
            job=t.job,
            real=t.real,
            ports=t.port_bits,
            sel_bits=t.sel_bits,
            aff_bits=t.aff_bits,
            aff_terms=t.aff_terms,
            tol_bits=t.tol_bits,
            pref_bits=t.pref_bits,
            pref_w=t.pref_w,
        ),
        SolveJobs(
            queue=j.queue,
            min_available=j.min_available,
            ready_base=j.ready_base,
        ),
        SolveQueues(
            deserved=np.asarray(deserved, np.float32),
            allocated=np.asarray(q_alloc0, np.float32),
        ),
    )


# ------------------------------------------------------ sequential solve

class SeqInputs(NamedTuple):
    """The ``seq_solve`` kernel's inputs, as tensors on one device (bit
    planes as int32, masks as bool).  ``extra_ok`` / ``extra_score`` are
    [P, N] or None."""

    idle: torch.Tensor  # [N, R] f32
    allocatable: torch.Tensor  # [N, R] f32
    releasing: torch.Tensor  # [N, R] f32
    pipelined: torch.Tensor  # [N, R] f32
    ntasks: torch.Tensor  # [N] int32
    max_tasks: torch.Tensor  # [N] int32
    nports: torch.Tensor  # [N, PW] int32
    ready: torch.Tensor  # [N] bool
    label_bits: torch.Tensor  # [N, LW] int32
    taint_bits: torch.Tensor  # [N, TW] int32
    req: torch.Tensor  # [P, R] f32
    init_req: torch.Tensor  # [P, R] f32
    job: torch.Tensor  # [P] int32
    real: torch.Tensor  # [P] bool
    ports: torch.Tensor  # [P, PW] int32
    sel_bits: torch.Tensor  # [P, LW] int32
    aff_bits: torch.Tensor  # [P, A, LW] int32
    aff_terms: torch.Tensor  # [P] int32
    tol_bits: torch.Tensor  # [P, TW] int32
    pref_bits: torch.Tensor  # [P, AP, LW] int32
    pref_w: torch.Tensor  # [P, AP] f32
    queue: torch.Tensor  # [J] int32
    min_available: torch.Tensor  # [J] int32
    ready_base: torch.Tensor  # [J] int32
    deserved: torch.Tensor  # [Q, R] f32
    q_alloc: torch.Tensor  # [Q, R] f32
    eps: torch.Tensor  # [R] f32
    scalar_slot: torch.Tensor  # [R] bool
    bres: torch.Tensor  # [R] f32
    node_dom: torch.Tensor  # [N, K] int32
    term_key: torch.Tensor  # [E] int32
    cnt0: torch.Tensor  # [E, D] int32
    t_req_aff: torch.Tensor  # [P, E] bool
    t_req_anti: torch.Tensor  # [P, E] bool
    t_matches: torch.Tensor  # [P, E] bool
    t_soft: torch.Tensor  # [P, E] f32
    extra_ok: Optional[torch.Tensor]  # [P, N] bool
    extra_score: Optional[torch.Tensor]  # [P, N] f32


def seq_inputs(nodes, tasks, jobs, queues, weights, eps, scalar_slot, aff,
               extra_ok, extra_score, dev) -> SeqInputs:
    """The solve's arguments as ``SeqInputs`` on ``dev``."""
    f32, i32 = torch.float32, torch.int32

    def t(a, dtype):
        return to_tensor(a, dev).to(dtype).contiguous()

    return SeqInputs(
        idle=t(nodes.idle, f32), allocatable=t(nodes.allocatable, f32),
        releasing=t(nodes.releasing, f32), pipelined=t(nodes.pipelined, f32),
        ntasks=t(nodes.ntasks, i32), max_tasks=t(nodes.max_tasks, i32),
        nports=t(nodes.ports, i32), ready=t(nodes.ready, torch.bool),
        label_bits=t(nodes.label_bits, i32),
        taint_bits=t(nodes.taint_bits, i32),
        req=t(tasks.req, f32), init_req=t(tasks.init_req, f32),
        job=t(tasks.job, i32), real=t(tasks.real, torch.bool),
        ports=t(tasks.ports, i32), sel_bits=t(tasks.sel_bits, i32),
        aff_bits=t(tasks.aff_bits, i32), aff_terms=t(tasks.aff_terms, i32),
        tol_bits=t(tasks.tol_bits, i32), pref_bits=t(tasks.pref_bits, i32),
        pref_w=t(tasks.pref_w, f32),
        queue=t(jobs.queue, i32), min_available=t(jobs.min_available, i32),
        ready_base=t(jobs.ready_base, i32),
        deserved=t(queues.deserved, f32), q_alloc=t(queues.allocated, f32),
        eps=t(eps, f32), scalar_slot=t(scalar_slot, torch.bool),
        bres=t(weights.binpack_res, f32),
        node_dom=t(aff.node_dom, i32), term_key=t(aff.term_key, i32),
        cnt0=t(aff.cnt0, i32), t_req_aff=t(aff.t_req_aff, torch.bool),
        t_req_anti=t(aff.t_req_anti, torch.bool),
        t_matches=t(aff.t_matches, torch.bool), t_soft=t(aff.t_soft, f32),
        extra_ok=None if extra_ok is None else t(extra_ok, torch.bool),
        extra_score=None if extra_score is None else t(extra_score, f32),
    )


def _subset(rows, table):
    """rows [..., W] against table [N, W] -> [..., N]: every row bit is
    present in the table row."""
    return ((rows.unsqueeze(-2) & ~table) == 0).all(dim=-1)


def _solve_plain(x: SeqInputs, weights):
    """The sequential solve in PyTorch, step by step as the JAX
    ``fori_loop``; control scalars live on the host, read once a step
    (best node, any feasible, fits idle)."""
    dev = x.idle.device
    N, R = x.idle.shape
    P = int(x.req.shape[0])
    J = int(x.queue.shape[0])
    E, D = x.cnt0.shape
    naff = float(weights.node_affinity_weight)
    w = weights._replace(binpack_res=x.bres)
    job_h = x.job.cpu().numpy()
    real_h = x.real.cpu().numpy()
    queue_h = x.queue.cpu().numpy()
    min_av_h = x.min_available.cpu().numpy()
    rbase_h = x.ready_base.cpu().numpy()
    aff_terms_h = x.aff_terms.cpu().numpy()
    # The soft terms each task reads: adding 0 * count changes no score.
    soft_cols = [torch.nonzero(r).flatten().tolist()
                 for r in (x.t_soft != 0).cpu()]
    terms = torch.arange(E, device=dev)
    node_dom_t = x.node_dom[:, x.term_key.long()]  # [N, E]
    dom_c = node_dom_t.clamp(min=0).long()
    has_dom = node_dom_t >= 0

    idle = x.idle.clone()
    pip_extra = torch.zeros_like(idle)
    ntasks = x.ntasks.clone()
    pip_ntasks = torch.zeros_like(ntasks)
    nports = x.nports.clone()
    pip_nports = torch.zeros_like(nports)
    cnt_alloc = x.cnt0.clone()
    cnt_pip = torch.zeros_like(cnt_alloc)
    q_alloc = x.q_alloc.clone()
    q_pip = torch.zeros_like(q_alloc)
    assigned = [-1] * P
    pipelined = [-1] * P
    alloc_cnt = [0] * J
    never_ready = [False] * J
    fit_failed = [False] * J
    job_start, prev_job = 0, -1
    job_ready = job_skip = job_overskip = True

    def undo(start, end, pj):
        # _undo_job (:245-274): the job's rows in ascending order.
        qj = int(queue_h[pj])
        for u in range(start, end):
            n = assigned[u]
            if n < 0:
                continue
            idle[n] = idle[n] + x.req[u]
            ntasks[n] -= 1
            nports[n] = nports[n] & ~x.ports[u]
            dec = x.t_matches[u] & has_dom[n]
            cnt_alloc[terms[dec], dom_c[n][dec]] -= 1
            q_alloc[qj] = q_alloc[qj] + (-x.req[u])

    for t in range(P + 1):
        tt = min(t, P - 1)
        is_pad = t >= P or not bool(real_h[tt])
        jt = -1 if is_pad else int(job_h[tt])
        if jt != prev_job:
            if prev_job >= 0 and not job_ready and not job_overskip:
                undo(job_start, t, prev_job)
                never_ready[prev_job] = True
            job_start = t
            qj = int(queue_h[max(jt, 0)])
            overused = not bool(less_equal(q_alloc[qj] + q_pip[qj],
                                           x.deserved[qj], x.eps,
                                           x.scalar_slot))
            job_skip = job_overskip = jt < 0 or overused
            job_ready = jt >= 0 and int(rbase_h[jt]) >= int(min_av_h[jt])
            prev_job = jt
        if is_pad or job_skip:
            continue

        ok = x.ready & _subset(x.sel_bits[tt], x.label_bits)
        n_terms = int(aff_terms_h[tt])
        if n_terms:
            A = x.aff_bits.shape[1]
            alts = _subset(x.aff_bits[tt], x.label_bits)  # [A, N]
            real_alt = torch.arange(A, device=dev) < n_terms
            ok = ok & (alts & real_alt[:, None]).any(dim=0)
        ok = ok & ((x.taint_bits & ~x.tol_bits[tt]) == 0).all(dim=-1)
        fi = ((idle + x.releasing) - x.pipelined) - pip_extra
        fit = less_equal(x.init_req[tt][None, :], fi, x.eps, x.scalar_slot)
        pods_ok = (x.max_tasks <= 0) | (ntasks + pip_ntasks < x.max_tasks)
        ports_ok = ((x.ports[tt] & (nports | pip_nports)) == 0).all(dim=-1)
        cnt = cnt_alloc + cnt_pip
        cval = torch.where(has_dom, cnt[terms[None, :], dom_c], 0)  # [N, E]
        total = cnt.sum(dim=1)
        aff_term_ok = (cval > 0) | ((total == 0) & x.t_matches[tt])[None, :]
        aff_ok = (~x.t_req_aff[tt][None, :] | aff_term_ok).all(dim=-1)
        anti_ok = (~x.t_req_anti[tt][None, :] | (cval == 0)).all(dim=-1)
        feasible = ok & fit & pods_ok & ports_ok & aff_ok & anti_ok
        if x.extra_ok is not None:
            feasible = feasible & x.extra_ok[tt]

        score = node_score(x.req[tt], x.allocatable, idle, w)
        if x.extra_score is not None:
            score = score + x.extra_score[tt]
        pref = _subset(x.pref_bits[tt], x.label_bits)  # [AP, N]
        acc = None
        for a in range(pref.shape[0]):
            term = pref[a].to(torch.float32) * x.pref_w[tt, a]
            acc = term if acc is None else acc + term
        if acc is not None:
            score = score + naff * acc
        soft = torch.zeros(N, dtype=torch.float32, device=dev)
        for e in soft_cols[tt]:
            soft = soft + x.t_soft[tt, e] * cval[:, e].to(torch.float32)
        score = score + soft
        score = torch.where(feasible, score, torch.full_like(score, NEG))
        best_t = torch.argmax(score)
        fits_t = less_equal(x.init_req[tt], idle[best_t], x.eps,
                            x.scalar_slot)
        best, any_ok, fits = torch.stack(
            [best_t, feasible.any().long(), fits_t.long()]).tolist()
        if not any_ok:
            # A task with no feasible node aborts the rest of its job.
            fit_failed[jt] = True
            job_skip = True
            continue
        qj = int(queue_h[jt])
        dom_b = dom_c[best]
        inc = x.t_matches[tt] & has_dom[best]
        if fits:
            idle[best] = idle[best] + (-x.req[tt])
            ntasks[best] += 1
            nports[best] = nports[best] | x.ports[tt]
            cnt_alloc[terms[inc], dom_b[inc]] += 1
            q_alloc[qj] = q_alloc[qj] + x.req[tt]
            assigned[tt] = best
            alloc_cnt[jt] += 1
            if int(rbase_h[jt]) + alloc_cnt[jt] >= int(min_av_h[jt]):
                job_ready = True
        else:
            pip_extra[best] = pip_extra[best] + x.req[tt]
            pip_ntasks[best] += 1
            pip_nports[best] = pip_nports[best] | x.ports[tt]
            cnt_pip[terms[inc], dom_b[inc]] += 1
            q_pip[qj] = q_pip[qj] + x.req[tt]
            pipelined[tt] = best

    LAST_SEQ["alloc_cnt"] = torch.tensor(alloc_cnt, dtype=torch.int32,
                                         device=dev)
    out_assigned = torch.tensor(assigned, dtype=torch.int32, device=dev)
    nr = torch.tensor(never_ready, dtype=torch.bool, device=dev)
    if P:
        discarded = nr[x.job.clamp(min=0).long()] & x.real
        out_assigned = torch.where(discarded, -1, out_assigned)
    return AllocResult(
        assigned=out_assigned,
        pipelined=torch.tensor(pipelined, dtype=torch.int32, device=dev),
        never_ready=nr,
        fit_failed=torch.tensor(fit_failed, dtype=torch.bool, device=dev),
        idle=idle,
        q_alloc=q_alloc + q_pip,
    )


def solve(nodes: SolveNodes, tasks: SolveTasks, jobs: SolveJobs,
          queues: SolveQueues, weights, eps, scalar_slot, aff,
          extra_ok=None, extra_score=None, device=None,
          plain: bool = False) -> AllocResult:
    """The exact sequential solve (the JAX ``ops/allocate.py:solve``
    signature and result, :201-213), plus ``device``: where it runs, the
    card unless the caller passes ``device="cpu"``.  Inputs may be numpy
    arrays or tensors; the result's tensors live on ``device``.  On the
    card it launches ``seq_solve``; ``plain=True`` runs the plain version
    there instead (only for comparisons)."""
    from .kernels import seq_solve

    dev = resolve_device(device)
    x = seq_inputs(nodes, tasks, jobs, queues, weights, eps, scalar_slot,
                   aff, extra_ok, extra_score, dev)
    return seq_solve(x, weights, plain=plain)
