"""Solver containers and the encoded-arrays -> solve-args builder.

The counterpart of the JAX package's ``ops/allocate.py:57-198``: the
``SolveNodes/Tasks/Jobs/Queues`` inputs and the ``AllocResult`` output of
the allocate solvers, ``NEG`` (the infeasible-score sentinel) and
``solve_inputs``.  Leaves are numpy arrays on the host and torch tensors on
the device.  The sequential solver (``allocate.py:201``) comes in a later
slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NEG = float(np.float32(-3.0e38))


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
