"""Wave-batched allocate solver, two-phase, on torch and the CUDA kernels of
``ops/kernels.py``.

The counterpart of the JAX package's ``ops/wave.py`` (its module docstring
states the semantics: waves of W tasks in task order, per-profile rankings,
a capacity walk with in-order prefix acceptance, queue-overuse gating at a
job's first task, fit-failure aborts, and one vectorized gang discard).
This module runs the same computation:

1. host prep in numpy, copied byte for byte from ``wave.py:2316-2673`` and
   ``:2780-2960`` (profile dedup with first-occurrence ``pid`` numbering,
   padding, wave profile lists, per-wave term windows, node classes); past
   ``CNT0_SPARSE_MIN`` / ``PROF_SPARSE_MIN`` the affinity count table and
   the profile-term tables ship as sparse entries and are rebuilt on the
   device (kernels ``scatter_cnt0``, ``scatter_profile_tables``);
2. phase 1, ``_coarse_shortlist``: static (profile x class) planes and each
   profile's top-S shortlist over all nodes (kernel ``coarse_shortlist``);
   the single-phase solve (``VOLCANO_TPU_TWOPHASE=0``, the JAX package's
   reference mode) has no phase 1;
3. phase 2, ``_solve_wave``: the wave / attempt / sub-round loops of
   ``wave.py:2260, 2225, 2151`` as Python loops around the kernels
   ``rank_candidates``, ``walk_accept`` and ``apply_commit``, with
   ``aff_live`` (the affinity verdicts and soft scores on the wave's
   count window, kept across the wave's attempts and recomputed only
   after a sub-round changed a count: JAX's attempt cache, gated by a
   device byte) and ``aff_filter`` (the sub-round's live affinity
   recheck and pair conflicts) on waves that carry terms; with
   ``AFF_STEER`` also ``aff_steer`` (the ranked candidates' required
   (anti-)affinity rechecked against the live window after a sub-round
   accepted a task that carries or gives to a required term).  Single
   phase, each wave's static planes come from ``static_planes`` over
   identity classes and every attempt ranks all N nodes.  The loop
   conditions are read on the host, one sync per iteration;
4. the gang discard (``apply_commit`` again) and the int16 narrowing of the
   result.

Supported: node selectors, required and preferred node affinity (through
the static class planes), taints and tolerations, pod-slot limits,
queue-overuse gating, compacted and identity node classes, the
shortlist-exhaustion fallback rescore, the gang discard, device-resident
node planes, the device-incremental lane (``devincr``: persistent static
planes, warm-started shortlists) and releasing / pipelined capacity (the
JAX ``has_future`` branch: fits read FutureIdle = ((idle + releasing) -
pipelined) - pip_extra, tasks that fit only the future idle are accepted as
pipelined and charge ``pip_extra`` / ``pip_ntasks`` / ``q_pip``) and the
fabric topology's node-order bias (``node_bias``: added to every profile's
static score in phase 2's rankings, never in phase 1), host ports (a
clash against the nodes' used ports in every ranking, pair clashes within
a sub-round), and inter-pod affinity, anti-affinity and soft terms
(preferred affinity, topology spread) through the per-(term, domain)
count tables of ``arrays/affinity.py``: phase 1 reads the solve-start
counts, phase 2 each wave's window of them, updated as tasks commit.
Custom plugin masks and scores come in as ``extra_ok`` / ``extra_score``
(per-task [P, N] planes, split into profiles as the JAX solve splits
them).  Mesh sharding raises ``NotImplementedError``: the port never
computes a different answer for it.
"""

from __future__ import annotations

import os as _os
import threading as _threading
import time as _time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..arrays.affinity import AffinityArgs
from ..device import resolve_device, to_numpy, to_tensor, tree_to
from . import affkernels, kernels
from .affkernels import AffTerms
from .allocate import (AllocResult, SolveJobs, SolveNodes, SolveQueues,
                       SolveTasks)
from .nodeclass import NodeClasses
from .resreq import less_equal
from .scoring import ScoreWeights


def _env_int(name: str, default: int) -> int:
    try:
        return int(_os.environ.get(name, default))
    except ValueError:
        return default


# Knobs under the JAX package's names, so one env var steers both.
DEFAULT_WAVE = _env_int("VOLCANO_TPU_WAVE", 2048)
# diversification breadth: k-th contender takes its k-th best node
TOPK = _env_int("VOLCANO_TPU_TOPK", 256)
# In-attempt re-walk rounds for conflict losers.
SUBROUNDS = _env_int("VOLCANO_TPU_SUBROUNDS", 4)
# cnt0 tables above this element count ship as sparse entries and are
# scattered on the device (tests lower it to force the sparse path).
CNT0_SPARSE_MIN = 4_000_000
# Same for the profile-term tables ([U, Ep]): past this element count the
# four tables ship as one sparse entry list.
PROF_SPARSE_MIN = _env_int("VOLCANO_TPU_PROF_SPARSE_MIN", 1_000_000)
# Live affinity steering inside sub-rounds (wave.py:1594-1652, off by
# default as in the JAX package).  Read at call time: tests set it on the
# module.
AFF_STEER = _env_int("VOLCANO_TPU_AFF_STEER", 0)
# The attempt cache of the affinity planes (wave.py AFF_ACACHE): a live
# wave's shortlist-width planes are recomputed only after a sub-round
# changed a count.  Exact (the same values); 0 recomputes every attempt.
AFF_ACACHE = _env_int("VOLCANO_TPU_AFF_ACACHE", 1)


def _two_phase_on() -> bool:
    return _os.environ.get("VOLCANO_TPU_TWOPHASE", "1") != "0"


def _nodeclass_on() -> bool:
    return _os.environ.get("VOLCANO_TPU_NODECLASS", "1") != "0"


def _fallback_cap() -> int:
    """Max shortlist-fallback rescores per solve (0 = unlimited)."""
    try:
        return max(0, int(_os.environ.get("VOLCANO_TPU_FB_CAP", 0)))
    except ValueError:
        return 0


def shortlist_size(n: int) -> int:
    """Phase-2 shortlist length per profile (wave.py:179).
    VOLCANO_TPU_TOPK pins it; the default mirrors the reference's adaptive
    percentageOfNodesToFind (50 - N/125 percent, floor 5%, at least 100
    nodes, scheduler_helper.go:37-62) and never drops below TOPK."""
    raw = _os.environ.get("VOLCANO_TPU_TOPK")
    if raw:
        try:
            return max(1, min(n, int(raw)))
        except ValueError:
            pass
    pct = max(5, 50 - n // 125)
    return min(n, max(100, TOPK, n * pct // 100))


# Telemetry of the most recent solve on this host: prep_s, coarse_s,
# fine_s (host wall seconds, each ending in a device sync), shortlist
# (U, S), n_nodes, compacted_classes, syncs (host reads of loop
# conditions), host_reads (device planes read back), future (the
# releasing-capacity branch ran).  A thread inside ``own_twophase`` (the
# pipelined session's solve worker) writes its own record instead.
LAST_TWOPHASE: dict = {"enabled": False}
_OWN = _threading.local()


def _twophase() -> dict:
    """The record the calling thread's solve writes."""
    rec = getattr(_OWN, "record", None)
    return LAST_TWOPHASE if rec is None else rec


class own_twophase:
    """Within the block, the calling thread's solves write ``record``
    instead of ``LAST_TWOPHASE``."""

    def __init__(self, record: dict):
        self.record = record

    def __enter__(self):
        self.prev = getattr(_OWN, "record", None)
        _OWN.record = self.record
        return self.record

    def __exit__(self, *exc):
        _OWN.record = self.prev
        return False


class SolveProfiles(NamedTuple):
    """Distinct task profiles ([U] rows): every per-task input that shapes
    the [*, N] feasibility/score tensors.  Tasks map to profiles via
    ``pid``; waves gather their present profiles via ``wave_prof``."""

    req: object  # [U, R]
    init_req: object  # [U, R]
    ports: object  # [U, PW] uint32
    sel_bits: object  # [U, LW]
    aff_bits: object  # [U, A, LW]
    aff_terms: object  # [U]
    tol_bits: object  # [U, TW]
    pref_bits: object  # [U, AP, LW]
    pref_w: object  # [U, AP]
    t_req_aff: object  # [U, E]
    t_req_anti: object  # [U, E]
    t_matches: object  # [U, E]
    t_soft: object  # [U, E]


class GState(NamedTuple):
    """Cluster state threaded through waves and attempts (the fields the
    port carries; ports and affinity counts arrive with their features).
    The ``pip_*`` / ``q_pip`` / ``pipelined`` fields move only with
    releasing capacity."""

    idle: object  # [N, R]
    pip_extra: object  # [N, R]
    ntasks: object  # [N] int32
    pip_ntasks: object  # [N] int32
    q_alloc: object  # [Q, R]
    q_pip: object  # [Q, R]
    alloc_cnt: object  # [JP] int32
    fit_failed: object  # [JP] bool
    job_skip: object  # [JP] bool (fit abort OR overuse skip)
    job_overskip: object  # [JP] bool (skipped for overuse only)
    assigned: object  # [P] int32
    pipelined: object  # [P] int32


def _np(a):
    # Host copy of a leaf: tensors come back from their device; numpy
    # stays as it is (contiguous, for the profile-hash .view(uint8)).
    return to_numpy(a)


_HASH_SEED = np.random.RandomState(0x5EED)


def _profile_tasks(tasks: SolveTasks, aff: AffinityArgs, extra_ok=None,
                   extra_score=None):
    """Group tasks into distinct profiles (host, numpy).

    Returns (profiles, pid[P]) where profiles hold one row per distinct
    combination of every per-task solver input except job identity, and
    pid is ordered by first occurrence (so job-contiguous task order keeps
    per-wave profile ranges narrow).

    Grouping hashes each row with a random linear map and verifies the
    result exactly (every row compared against its representative); on the
    astronomically unlikely hash collision it falls back to exact grouping.
    """
    P = tasks.req.shape[0]
    cols = [
        _np(tasks.req).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(tasks.init_req).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(tasks.ports).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(tasks.sel_bits).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(tasks.aff_bits).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(tasks.aff_terms).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(tasks.tol_bits).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(tasks.pref_bits).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(tasks.pref_w).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(aff.t_req_aff).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(aff.t_req_anti).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(aff.t_matches).reshape(P, -1).view(np.uint8).reshape(P, -1),
        _np(aff.t_soft).reshape(P, -1).view(np.uint8).reshape(P, -1),
    ]
    if extra_ok is not None:
        # Custom per-task node masks split profiles: tasks of one profile
        # must share a mask row (the kernel applies it per profile).
        cols.append(np.packbits(_np(extra_ok), axis=1))
    if extra_score is not None:
        cols.append(
            _np(extra_score).astype(np.float32)
            .reshape(P, -1).view(np.uint8).reshape(P, -1)
        )
    raw = np.concatenate(cols, axis=1)  # [P, C] uint8
    # Three independent linear hashes with small coefficients: every dot
    # product stays below 2^33, so the float64 BLAS matmul is exact and two
    # distinct rows collide in one column with probability ~2^-20 (the
    # coefficients are random); across three columns ~2^-60 per pair.
    rnd = _HASH_SEED.randint(1, 1 << 20, size=(raw.shape[1], 3))
    h = (raw.astype(np.float64) @ rnd.astype(np.float64)).astype(np.int64)
    p1 = np.uint64(0x9E3779B97F4A7C15).astype(np.int64)
    p2 = np.uint64(0xC2B2AE3D27D4EB4F).astype(np.int64)
    with np.errstate(over="ignore"):
        hv = h[:, 0] + h[:, 1] * p1 + h[:, 2] * p2
    _, first_idx, inv = np.unique(
        hv, return_index=True, return_inverse=True
    )
    # Renumber profiles by first occurrence so pid follows task order.
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    pid = rank[inv].astype(np.int32)
    u = first_idx[order]

    if not np.array_equal(raw, raw[u][pid]):  # hash collision: exact path
        key = np.ascontiguousarray(raw)
        _, first_idx, inv = np.unique(
            key.view([("", np.uint8)] * key.shape[1]).ravel(),
            return_index=True,
            return_inverse=True,
        )
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        pid = rank[inv].astype(np.int32)
        u = first_idx[order]

    profiles = SolveProfiles(
        req=_np(tasks.req)[u],
        init_req=_np(tasks.init_req)[u],
        ports=_np(tasks.ports)[u],
        sel_bits=_np(tasks.sel_bits)[u],
        aff_bits=_np(tasks.aff_bits)[u],
        aff_terms=_np(tasks.aff_terms)[u],
        tol_bits=_np(tasks.tol_bits)[u],
        pref_bits=_np(tasks.pref_bits)[u],
        pref_w=_np(tasks.pref_w)[u],
        t_req_aff=_np(aff.t_req_aff)[u],
        t_req_anti=_np(aff.t_req_anti)[u],
        t_matches=_np(aff.t_matches)[u],
        t_soft=_np(aff.t_soft)[u],
    )
    extra_prof = _np(extra_ok)[u] if extra_ok is not None else None
    score_prof = (
        _np(extra_score).astype(np.float32)[u]
        if extra_score is not None else None
    )
    return profiles, pid, extra_prof, score_prof


def _renumber_pid(pid: np.ndarray):
    """Renumber profile ids by first occurrence; return (pid2, u_rows) where
    u_rows[k] is the first task row of profile k."""
    _, first_idx, inv = np.unique(pid, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    return rank[inv].astype(np.int32), first_idx[order]


def _profiles_from_pid(tasks: SolveTasks, aff: AffinityArgs,
                       pid: np.ndarray):
    """Build SolveProfiles from caller-supplied profile ids (the store
    mirror interns them at pod-add time, so no per-cycle hashing)."""
    pid, u = _renumber_pid(pid)
    profiles = SolveProfiles(
        req=_np(tasks.req)[u],
        init_req=_np(tasks.init_req)[u],
        ports=_np(tasks.ports)[u],
        sel_bits=_np(tasks.sel_bits)[u],
        aff_bits=_np(tasks.aff_bits)[u],
        aff_terms=_np(tasks.aff_terms)[u],
        tol_bits=_np(tasks.tol_bits)[u],
        pref_bits=_np(tasks.pref_bits)[u],
        pref_w=_np(tasks.pref_w)[u],
        t_req_aff=_np(aff.t_req_aff)[u],
        t_req_anti=_np(aff.t_req_anti)[u],
        t_matches=_np(aff.t_matches)[u],
        t_soft=_np(aff.t_soft)[u],
    )
    return profiles, pid


def bucket_pow2(n: int, floor: int, min_pad: int = 8) -> int:
    """Shape bucket: next power of two >= n plus 25% headroom (the JAX
    package buckets to bound recompiles; the port keeps the same shapes so
    both packages prepare identical arrays).  ``floor`` bounds the
    smallest bucket per axis."""
    target = n + max(n // 4, min_pad)
    b = max(floor, 1)
    while b < target:
        b *= 2
    return b


def _pad_profiles_rows(profiles: SolveProfiles) -> SolveProfiles:
    """Pad the profile table's row axis to a power of two (min 64) with
    inert zero rows.  The row count is data-dependent (distinct task
    profiles this cycle); the JAX package pads it to bound recompiles and
    the port pads the same way.  Padded rows are never referenced: pid
    and wave_prof only index real rows."""
    U = int(_np(profiles.req).shape[0])
    pad = bucket_pow2(U, floor=64) - U
    if pad == 0:
        return profiles
    def z(a):
        a = _np(a)
        return np.concatenate(
            [a, np.zeros((pad, *a.shape[1:]), a.dtype)]
        )

    return SolveProfiles(*[z(a) for a in profiles])


def _term_windows(profiles: SolveProfiles, aff: AffinityArgs,
                  pid: np.ndarray, wave_prof: np.ndarray, n_waves: int,
                  skip_cnt0: bool = False, skip_prof: bool = False):
    """Per-wave lists of the affinity terms the wave's profiles reference.

    Every [*, E] tensor in the kernel is gathered down to the wave's term
    list, bounding the affinity machinery by terms-per-wave instead of
    total terms.  One dummy scratch row is appended to the term axis and
    used as list padding, so the windowed count write-back scatters to
    unique real rows (duplicates only hit the dummy).
    Returns (profiles, aff, wave_terms [NW, EW], EW, iom) — iom being
    the [U, E] nonzero union of the four profile-term tables (pre-dummy
    columns; the sparse-shipping path reuses it).  ``skip_prof``: leave
    the profile tables without the dummy column (the caller rebuilds
    them on device at the dummy-extended width — skips four ~dense host
    copies).
    """
    t_req_aff = _np(profiles.t_req_aff)
    E = t_req_aff.shape[1]
    iom = (
        t_req_aff | _np(profiles.t_req_anti) | _np(profiles.t_matches)
        | (_np(profiles.t_soft) != 0)
    )
    # Append the dummy scratch term row E.
    def zc(a):
        a = _np(a)
        return np.concatenate(
            [a, np.zeros((*a.shape[:-1], 1), a.dtype)], axis=-1
        )

    if not skip_prof:
        profiles = profiles._replace(
            t_req_aff=zc(profiles.t_req_aff),
            t_req_anti=zc(profiles.t_req_anti),
            t_matches=zc(profiles.t_matches),
            t_soft=zc(profiles.t_soft),
        )
    repl = {
        "term_key": np.concatenate(
            [_np(aff.term_key), np.zeros(1, np.int32)]
        ),
    }
    if not skip_cnt0:
        # skip_cnt0: the caller rebuilds cnt0 on device with the dummy
        # row included — skip the dense [Ep, D] host copy here.
        repl["cnt0"] = np.concatenate(
            [_np(aff.cnt0),
             np.zeros((1, _np(aff.cnt0).shape[1]), _np(aff.cnt0).dtype)]
        )
    aff = aff._replace(**repl)
    wp = _np(wave_prof)
    U = iom.shape[0]
    term_lists = []
    ew = 1
    for w in range(n_waves):
        pids = np.unique(np.clip(wp[w], 0, U - 1))
        terms = np.flatnonzero(iom[pids].any(axis=0))
        term_lists.append(terms)
        ew = max(ew, len(terms))
    EW = bucket_pow2(ew, floor=16, min_pad=4)
    wave_terms = np.full((n_waves, EW), E, np.int32)  # pad = dummy row
    for w, terms in enumerate(term_lists):
        wave_terms[w, :len(terms)] = terms
    # Term sets are usually wave-disjoint (terms select a job's own app
    # label and jobs never split across waves): no wave then reads a
    # count another wave wrote, and the per-wave window write-back into
    # the global [E, D] tables can be skipped wholesale.
    if term_lists:
        all_terms = np.concatenate(term_lists)
        terms_disjoint = bool(
            len(all_terms) == len(np.unique(all_terms))
        )
    else:
        terms_disjoint = True
    # iom's dummy column is all-zero; callers reuse it as the nonzero
    # union of the four tables (the sparse-shipping path).
    return profiles, aff, wave_terms, int(EW), iom, terms_disjoint


def _wave_profiles(pid: np.ndarray, n_waves: int, wave: int):
    """Per-wave lists of the profiles actually PRESENT in each wave.

    Shared profiles recur across the whole task list, so id *ranges* per
    wave degenerate to the full profile table at scale; explicit presence
    lists keep UM at (distinct profiles per wave), padded to a power of
    two across waves.  Padding repeats the wave's first profile
    (read-only duplication).  Returns wave_prof [NW, UM]; each task's
    index into its wave's list is its first match there
    (``_wave_host_index``).
    """
    seg = pid.reshape(n_waves, wave)
    lists = []
    um = 1
    for w in range(n_waves):
        u = np.unique(seg[w])
        lists.append(u)
        um = max(um, len(u))
    UM = 1
    while UM < um:
        UM *= 2
    wave_prof = np.zeros((n_waves, UM), np.int32)
    for w, u in enumerate(lists):
        wave_prof[w, :len(u)] = u
        wave_prof[w, len(u):] = u[0]
    return wave_prof


def _pad_tasks(tasks: SolveTasks, pad: int) -> SolveTasks:
    def z(a):
        a = _np(a)
        return np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])

    return SolveTasks(
        req=z(tasks.req),
        init_req=z(tasks.init_req),
        job=np.concatenate(
            [_np(tasks.job), np.full((pad,), -1, np.int32)]
        ),
        real=np.concatenate([_np(tasks.real), np.zeros((pad,), bool)]),
        ports=z(tasks.ports),
        sel_bits=z(tasks.sel_bits),
        aff_bits=z(tasks.aff_bits),
        aff_terms=z(tasks.aff_terms),
        tol_bits=z(tasks.tol_bits),
        pref_bits=z(tasks.pref_bits),
        pref_w=z(tasks.pref_w),
    )


def _pad_aff(aff: AffinityArgs, pad: int) -> AffinityArgs:
    def z(a):
        a = _np(a)
        return np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])

    return AffinityArgs(
        node_dom=aff.node_dom,
        term_key=aff.term_key,
        cnt0=aff.cnt0,
        t_req_aff=z(aff.t_req_aff),
        t_req_anti=z(aff.t_req_anti),
        t_matches=z(aff.t_matches),
        t_soft=z(aff.t_soft),
    )


def _host_node_classes(nodes: SolveNodes):
    """Compact the node table into classes from host (numpy) arrays.

    The grouping is memoized on a content digest of the static planes
    (one entry): a node table is epoch-stable cycle to cycle, and the
    digest (a linear byte hash) is cheaper than re-running the
    structured-row unique sort every solve."""
    import hashlib

    from .nodeclass import build_node_classes

    h = hashlib.blake2b(digest_size=16)
    planes = (
        nodes.label_bits, nodes.taint_bits, np.asarray(nodes.ready),
        np.asarray(nodes.allocatable, np.float32),
        np.asarray(nodes.max_tasks, np.int32),
    )
    for a in planes:
        a = np.ascontiguousarray(a)
        h.update(repr((a.shape, a.dtype.str)).encode())
        h.update(memoryview(a).cast("B"))
    key = h.hexdigest()
    cached = _host_node_classes._cache
    if cached is not None and cached[0] == key:
        return cached[1]
    classes, _n, _sig = build_node_classes(*planes)
    _host_node_classes._cache = (key, classes)
    return classes


_host_node_classes._cache = None

# The profile columns the static planes read.
_STATIC_FIELDS = ("sel_bits", "aff_bits", "aff_terms", "tol_bits",
                  "pref_bits", "pref_w")

# ------------------------------------------------------------------ device

def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"volcano_tpu_torch solve_wave does not support {what} yet "
        f"(ROADMAP.md: {item})"
    )


def _identity_classes(nodes: SolveNodes) -> NodeClasses:
    """Per-node identity classes (wave.py:331): every node its own class."""
    N = nodes.idle.shape[0]
    return NodeClasses(
        class_id=torch.arange(N, dtype=torch.int32, device=nodes.idle.device),
        label_bits=nodes.label_bits,
        taint_bits=nodes.taint_bits,
        ready=nodes.ready,
    )


def _coarse_shortlist(nodes: SolveNodes, prof: SolveProfiles,
                      cls: Optional[NodeClasses], weights: ScoreWeights,
                      eps, scalar_slot, sl_k: int, features: tuple,
                      future=None, ports=None, aff1=None, extra=None,
                      plain: bool = False):
    """Phase 1 (wave.py:547): ``(shortlists [U, sl_k] int32 ascending node
    ids, stat_ok [U, C] bool, stat_score [U, C] f32)``.  ``cls`` None means
    identity classes.  Masks and scores are evaluated at solve-start state
    (with ``future``, the fit reads fi0 = (idle + releasing) - pipelined;
    ``ports`` the solve-start port planes; ``aff1`` the solve-start
    affinity inputs, ``Phase1Aff``; ``extra`` the custom plugins'
    ``kernels.Extra`` planes); the selection keeps each profile's top
    ``sl_k`` by (score desc, node id asc)."""
    if cls is None:
        cls = _identity_classes(nodes)
    aff = None
    if aff1 is not None:
        U = int(prof.req.shape[0])
        rows = torch.arange(U, dtype=torch.int32, device=nodes.idle.device)
        aff = affkernels.aff_live(rows, None, aff1.terms, aff1.at,
                                  plain=plain)
    return kernels.coarse_shortlist(
        prof, cls, nodes.idle, nodes.allocatable, nodes.ntasks,
        nodes.max_tasks, eps, scalar_slot, weights, sl_k,
        has_taints=bool(features[2]), future=future, ports=ports, aff=aff,
        extra=extra, plain=plain,
    )


class Phase1Aff(NamedTuple):
    """Phase 1's affinity inputs: the solve-start counts and the whole
    profile tables (``at``), and each profile row's term columns
    (``terms`` [U, T] int32, -1 padded) -- the columns where one of its
    four table entries is nonzero, the only ones its verdict and score
    read.  Phase 1 reads them only when some resident pod matches a term
    (``cnt0_any``): with all-zero counts every verdict and score is
    uniform per profile and cannot change a shortlist (wave.py:586-592)."""

    at: AffTerms
    terms: torch.Tensor


def _profile_term_lists(iom: np.ndarray) -> np.ndarray:
    """[U, T] int32 term columns per profile row (ascending, -1 padded,
    T >= 1) from the [U, E] nonzero union of the profile tables."""
    ur, ec = np.nonzero(iom)
    U = iom.shape[0]
    counts = np.bincount(ur, minlength=U)
    T = max(1, int(counts.max()) if len(counts) else 1)
    out = np.full((U, T), -1, np.int32)
    start = np.concatenate(([0], np.cumsum(counts)[:-1]))
    out[ur, np.arange(len(ur)) - start[ur]] = ec
    return out


def _future_planes(nodes: SolveNodes, features: tuple):
    """The solve-start releasing-capacity planes as a ``kernels.Future``
    (``releasing`` / ``pipelined`` broadcast to [N, R]: the caller may pass
    a [1, R] dummy, wave.py:764-768), or None without releasing capacity."""
    if not features[3]:
        return None
    N, R = nodes.idle.shape

    def full(a):
        a = a.to(torch.float32)
        return a.expand(N, R).contiguous() if a.shape[0] != N else \
            a.contiguous()

    return kernels.Future(full(nodes.releasing), full(nodes.pipelined))


def _wave_host_index(job, real, pid, wave_prof, queue, J: int, W: int):
    """Per-task wave indices computed once on the host: the job window
    start ``jlo`` per wave, each task's window slot ``jw``, its row in the
    wave's profile list ``pid_l`` (first match, the JAX argmax), and its
    queue through the window (``queue_p[jlo + jw]``)."""
    NW = wave_prof.shape[0]
    tjob = np.where(real, job.astype(np.int64), J)
    queue_p = np.concatenate([queue.astype(np.int32), np.zeros(W, np.int32)])
    jlo = np.empty(NW, np.int64)
    jw = np.empty(NW * W, np.int32)
    pid_l = np.empty(NW * W, np.int32)
    qidx = np.empty(NW * W, np.int32)
    lut = np.zeros(int(pid.max()) + 1 if len(pid) else 1, np.int32)
    UM = wave_prof.shape[1]
    for w in range(NW):
        sl = slice(w * W, (w + 1) * W)
        jraw = tjob[sl]
        lo = int(np.min(np.where(real[sl], jraw, J)))
        jlo[w] = lo
        jw[sl] = np.clip(jraw - lo, 0, W - 1)
        rows = wave_prof[w].astype(np.int64)
        lut[rows[::-1]] = np.arange(UM - 1, -1, -1, dtype=np.int32)
        pid_l[sl] = lut[pid[sl]]
        qidx[sl] = queue_p[lo + jw[sl]]
    return tjob, queue_p, jlo, jw, pid_l, qidx


def _solve_wave(nodes: SolveNodes, jobs: SolveJobs,
                queues: SolveQueues, weights: ScoreWeights, eps, scalar_slot,
                prof: SolveProfiles, pid, wave_prof: np.ndarray,
                cls: Optional[NodeClasses], shortlists, stat_ok, stat_score,
                host: dict, wave: int, n_waves: int, features: tuple,
                fb_cap: int = 0, future0=None, bias=None, aff=None,
                wave_terms: Optional[np.ndarray] = None,
                terms_disjoint: bool = True, extra=None,
                plain: bool = False) -> AllocResult:
    """Phase 2 (wave.py:860).

    ``shortlists`` None runs the single-phase solve (wave.py:1131-1170,
    :1513-1522): each wave's [UM, N] static planes are its profile rows
    through ``kernels.static_planes`` over identity classes (``stat_ok`` /
    ``stat_score`` unused), every attempt ranks all N nodes on an [UM, N]
    affinity attempt cache, and there is no shortlist-exhaustion fallback.

    ``host`` carries the numpy task/job columns the loops index with
    (``job``, ``real``, ``pid``, ``queue``); the device tensors carry the
    state.  Every loop condition is one host read.  ``future0``: the
    solve-start releasing-capacity planes (``_future_planes``), None
    without releasing capacity.  ``bias``: the [N] node-order bias both
    rankings add to the static score (wave.py:1170-1179), or None.

    With host ports (``features[0]``) the state carries the used-port
    planes ``nport`` / ``pip_nport``; with affinity (``features[1]``)
    ``aff`` holds the device ``node_dom``, ``term_key`` and ``cnt0`` (its
    last row the dummy term), ``wave_terms`` [NW, EW] each wave's term
    columns (padded with the dummy) and ``terms_disjoint`` whether no two
    waves share a term: then every wave reads its window straight from
    ``cnt0`` and nothing is written back (wave.py:2181-2236).  A wave
    whose window is all dummy neither reads nor changes a count, so its
    attempts skip the affinity kernels: the planes they would give are
    all-feasible and zero-scored.  ``extra``: the custom plugins' [U, N]
    ``kernels.Extra`` planes, read by both rankings at each wave row's
    profile (wave.py:1127-1139, :1165-1168)."""
    has_overuse = bool(features[4])
    has_future = future0 is not None
    has_ports = bool(features[0])
    has_aff = bool(features[1])
    dev = nodes.idle.device
    N, R = nodes.idle.shape
    P = int(host["real"].shape[0])
    J = int(jobs.min_available.shape[0])
    Q = int(queues.deserved.shape[0])
    W = wave
    UM = int(wave_prof.shape[1])
    single = shortlists is None
    S = N if single else int(shortlists.shape[1])
    K = min(TOPK, S)
    steer_on = bool(AFF_STEER)
    JP = J + W
    i32 = torch.int32
    if cls is None:
        cls = _identity_classes(nodes)
    tjob_h, queue_p_h, jlo_h, jw_h, pid_l_h, qidx_h = _wave_host_index(
        host["job"], host["real"], host["pid"], wave_prof, host["queue"],
        J, W,
    )
    real = to_tensor(host["real"], dev)
    tjob = torch.from_numpy(tjob_h).to(dev)
    prev = np.concatenate([[-1], tjob_h[:-1]])
    is_first = to_tensor(host["real"] & (tjob_h != prev), dev)
    jw_all = to_tensor(jw_h, dev)
    pid_l_all = to_tensor(pid_l_h, dev)
    qidx_all = to_tensor(qidx_h, dev)
    wave_prof_t = to_tensor(wave_prof.astype(np.int64), dev)
    queue_p = to_tensor(queue_p_h, dev)

    job_seen = torch.zeros(JP, dtype=torch.bool, device=dev)
    job_seen[tjob[real]] = True
    # The solve never writes through its inputs: every state plane is a
    # fresh copy (apply_commit updates them in place).
    st = GState(
        idle=nodes.idle.clone(),
        pip_extra=torch.zeros((N, R), dtype=torch.float32, device=dev),
        ntasks=nodes.ntasks.clone(),
        pip_ntasks=torch.zeros(N, dtype=i32, device=dev),
        q_alloc=queues.allocated.clone(),
        q_pip=torch.zeros((Q, R), dtype=torch.float32, device=dev),
        alloc_cnt=torch.zeros(JP, dtype=i32, device=dev),
        fit_failed=torch.zeros(JP, dtype=torch.bool, device=dev),
        job_skip=torch.zeros(JP, dtype=torch.bool, device=dev),
        job_overskip=torch.zeros(JP, dtype=torch.bool, device=dev),
        assigned=torch.full((P,), -1, dtype=i32, device=dev),
        pipelined=torch.full((P,), -1, dtype=i32, device=dev),
    )
    # apply_commit's float64 accumulators, kept zeroed between calls.
    scratch = kernels.commit_scratch(N, R, Q, dev)
    # The live future planes: the in-solve pipelined charges ride along.
    fut = None
    pip_scratch = None
    if has_future:
        fut = kernels.Future(future0.rel, future0.pip, st.pip_extra,
                             st.pip_ntasks)
        pip_scratch = kernels.commit_scratch(N, R, Q, dev)
    t_idx = torch.arange(W, device=dev)
    all_rows = torch.arange(UM, dtype=i32, device=dev)
    TOPOV = min(16, K)
    iters = 0
    fb_exhausted = 0
    fb_affinity = 0
    fb_rounds = 0
    syncs = 0
    aff_attempts = 0
    steer_calls = 0
    if has_ports:
        # Used host ports per node (wave.py:947-948): committed and
        # pipelined tasks' ports, OR-ed in by apply_commit.
        nport = nodes.ports.clone()
        pip_nport = torch.zeros_like(nport) if has_future else None
    if has_aff:
        dummy = int(aff.cnt0.shape[0]) - 1
        D = int(aff.cnt0.shape[1])
        EW = int(wave_terms.shape[1])
        cnt0_i = aff.cnt0
        if not terms_disjoint:
            cnt_alloc = cnt0_i.clone()
            cnt_pip = torch.zeros_like(cnt0_i)
        # aff_filter's earliest-giver scratch, kept at W between calls.
        gm = torch.full((EW, D), W, dtype=i32, device=dev)
        all_terms = torch.arange(EW, dtype=i32, device=dev)[None, :]

    for w in range(n_waves):
        sl = slice(w * W, (w + 1) * W)
        jlo = int(jlo_h[w])
        jwin = slice(jlo, jlo + W)
        real_w = real[sl]
        is_first_w = is_first[sl]
        jw = jw_all[sl]
        jw_l = jw.long()
        pid_l = pid_l_all[sl]
        pl = pid_l.long()
        qidx = qidx_all[sl]
        pids = wave_prof_t[w]
        pids_i = pids.to(i32) if extra is not None else None
        p_req = prof.req[pids].contiguous()
        p_init_req = prof.init_req[pids].contiguous()
        if single:
            # Node-level static planes of the wave's rows: class_static at
            # C = N equals the JAX solve's _subset_mm planes (wave.py:
            # 285-298), and stays [UM, N].
            ok_w, score_w = kernels.static_planes(
                prof._replace(**{f: getattr(prof, f)[pids].contiguous()
                                 for f in _STATIC_FIELDS}),
                cls, weights.node_affinity_weight, bool(features[2]),
                plain=plain)
            sl_w = None
        else:
            ok_w = stat_ok[pids].contiguous()
            score_w = stat_score[pids].contiguous()
            sl_w = shortlists[pids].contiguous()
        ports_w = None
        if has_ports:
            ports_w = kernels.Ports(prof.ports[pids].contiguous(), nport,
                                    pip_nport)
        at_w = None
        match_w = None
        self_anti = None
        prof_req_terms = None
        term_req = None
        if has_aff:
            wt_h = wave_terms[w]
            wt = torch.from_numpy(wt_h.astype(np.int64)).to(dev)

            def cols(t):
                return t[pids][:, wt].contiguous()

            p_aff = cols(prof.t_req_aff)
            p_anti = cols(prof.t_req_anti)
            p_match = cols(prof.t_matches)
            # Profiles with required terms: their fallback rescores count
            # as fb_affinity (wave.py:1437-1441).
            prof_req_terms = (p_aff | p_anti).any(dim=1)
            if bool((wt_h != dummy).any()):
                # The wave's count window (wave.py:2181-2190).
                if terms_disjoint:
                    cw_a = cnt0_i[wt]
                    cw_p = torch.zeros_like(cw_a) if has_future else None
                else:
                    cw_a = cnt_alloc[wt]
                    cw_p = cnt_pip[wt] if has_future else None
                at_w = AffTerms(aff.node_dom, aff.term_key[wt].contiguous(),
                                cw_a, cw_p, p_aff, p_anti, p_match,
                                cols(prof.t_soft))
                # Each row's matched terms, listed for apply_commit.
                match_w = kernels.window_match_terms(p_match)
                # The filter's constant planes, once per wave: the terms
                # some row requires (the givers' terms).
                term_req = (p_aff | p_anti).any(dim=0)
                # Self anti-affine profiles walk one copy per node
                # (wave.py:1690-1696).
                self_anti = (p_anti & p_match).any(dim=1)
                # The attempt cache (wave.py:2186-2194): the planes live
                # across the wave's attempts, (all-true, zeros) at first,
                # and a device byte says whether a count changed since they
                # were computed -- set for the first attempt.  The tasks
                # that change a count when accepted: those matching a
                # window term (wave.py:1567).
                aff_c = (torch.ones((UM, S), dtype=torch.bool, device=dev),
                         torch.zeros((UM, S), dtype=torch.float32,
                                     device=dev))
                aff_dirty = torch.ones(1, dtype=torch.bool, device=dev)
                matches_any_t = p_match[pl].any(dim=1)
                if steer_on:
                    # The tasks whose acceptance sets the steering byte
                    # (wave.py:2133-2140): a required or anti term of
                    # their own, or a match to a term some row requires.
                    steer_rel = prof_req_terms[pl] | (
                        p_match[pl] & term_req[None, :]).any(dim=1)
                    steer_dirty = torch.zeros(1, dtype=torch.bool,
                                              device=dev)

        alloc_l = st.alloc_cnt[jwin].clone()
        fitf_l = st.fit_failed[jwin].clone()
        skip_l = st.job_skip[jwin].clone()
        over_l = st.job_overskip[jwin].clone()
        assigned_w = torch.full((W,), -1, dtype=i32, device=dev)
        pipelined_w = torch.full((W,), -1, dtype=i32, device=dev)
        pip = None if not has_future else {
            "pip_extra": st.pip_extra, "pip_ntasks": st.pip_ntasks,
            "q_pip": st.q_pip, "pipelined": pipelined_w,
            "scratch": pip_scratch}
        done = ~real_w
        it = 0
        stalled = False
        while True:
            skip_t = skip_l[jw_l] & real_w
            syncs += 1
            if (stalled or it >= 2 * W + 64
                    or not bool((~done & ~skip_t).any())):
                break
            skip_l0 = skip_l.clone()
            if has_overuse:
                # Queue-overuse gating at each job's first task (live q,
                # pipelined charges included: wave.py:1424).
                gate = is_first_w & ~done
                q_tot = st.q_alloc + st.q_pip if has_future else st.q_alloc
                overused = ~less_equal(q_tot[qidx.long()],
                                       queues.deserved[qidx.long()],
                                       eps, scalar_slot)
                gate_over = gate & overused & real_w
                gated = torch.zeros(W, dtype=torch.bool, device=dev)
                gated[jw_l[gate_over]] = True
                skip_l = skip_l | gated
                over_l = over_l | gated
            skip_t = skip_l[jw_l] & real_w
            cand = ~done & ~skip_t

            # The affinity planes at shortlist width, on the live window,
            # recomputed only while the dirty byte is set (wave.py:
            # 1368-1371); without the cache every attempt recomputes.
            aff_sl = None
            if at_w is not None:
                aff_sl = affkernels.aff_live(
                    all_rows, sl_w, all_terms, at_w,
                    gate=aff_dirty if AFF_ACACHE else None, out=aff_c,
                    plain=plain)
                aff_attempts += 1
            ranked, feas_k, p_any = kernels.rank_candidates(
                all_rows, sl_w, ok_w, score_w, cls.class_id, p_req,
                p_init_req, st.idle, nodes.allocatable, st.ntasks,
                nodes.max_tasks, eps, scalar_slot, weights, K, future=fut,
                bias=bias, ports=ports_w, aff=aff_sl, extra=extra,
                pids=pids_i, plain=plain,
            )
            # Shortlist exhaustion -> full-N rescore of the affected
            # profiles only (wave.py:1450-1512); a single-phase ranking
            # already covers every node.
            need_fb = False
            if not single:
                cand_u = torch.zeros(UM, dtype=torch.bool, device=dev)
                cand_u[pl[cand]] = True
                exhausted = cand_u & ~p_any
                syncs += 1
                need_fb = bool(exhausted.any())
                if fb_cap:
                    need_fb = need_fb and fb_rounds < fb_cap
            if need_fb:
                rows_x = exhausted.nonzero().squeeze(1).to(i32)
                # Fresh full-N affinity planes (wave.py:1455-1470).
                aff_fb = None if at_w is None else affkernels.aff_live(
                    rows_x, None, all_terms, at_w, plain=plain)
                r_f, f_f, a_f = kernels.rank_candidates(
                    rows_x, None, ok_w, score_w, cls.class_id, p_req,
                    p_init_req, st.idle, nodes.allocatable, st.ntasks,
                    nodes.max_tasks, eps, scalar_slot, weights, K,
                    future=fut, bias=bias, ports=ports_w, aff=aff_fb,
                    extra=extra, pids=pids_i, plain=plain,
                )
                rx = rows_x.long()
                ranked[rx] = r_f
                feas_k[rx] = f_f
                p_any[rx] = a_f
                n_aff = (0 if prof_req_terms is None
                         else int(prof_req_terms[rx].sum()))
                fb_exhausted += int(rows_x.shape[0]) - n_aff
                fb_affinity += n_aff
                fb_rounds += 1

            any_feasible = p_any[pl]
            no_node = cand & ~any_feasible
            # Abort-in-order: a no-node task masks the later tasks of its
            # job from this attempt (allocate.go:189-193).
            first_nn = torch.full((W,), W, dtype=torch.int64, device=dev)
            first_nn.scatter_reduce_(0, jw_l[no_node], t_idx[no_node],
                                     reduce="amin")
            aborted = first_nn[jw_l] < t_idx

            # Contention groups: profiles sharing most of their top nodes.
            top = ranked[:, :TOPOV].long()
            member = torch.zeros((UM, N), dtype=torch.bool, device=dev)
            member.scatter_(1, top, True)
            ov = member[:, top].sum(dim=-1).T  # [UM, UM] shared-top counts
            grp = (ov >= (TOPOV + 1) // 2).contiguous()

            steer = steer_on and at_w is not None
            if steer:
                # The attempt's ranking feasibility, and the working copy
                # the sub-rounds carry (steered in place).
                feas_k_att = feas_k
                feas_k = feas_k_att.clone()
                steer_dirty.zero_()
            done_sub = done.clone()
            subs = 0
            syncs += 1
            go = bool((cand & ~done_sub & ~aborted).any())
            while go and subs < SUBROUNDS:
                cand_s = cand & ~done_sub & ~aborted
                if steer and subs:
                    # Live steering (wave.py:1594-1652): behind the byte
                    # the last sub-round set, the ranked candidates'
                    # required (anti-)affinity on the live window.
                    affkernels.aff_steer(ranked, feas_k_att, at_w,
                                         gate=steer_dirty, out=feas_k,
                                         plain=plain)
                    steer_calls += 1
                live = None if at_w is None else torch.empty(
                    W, dtype=torch.bool, device=dev)
                choice, acc, acc_pipe = kernels.walk_accept(
                    ranked, feas_k, p_req, p_init_req, pid_l, cand_s,
                    any_feasible, grp, st.idle, st.ntasks, nodes.max_tasks,
                    eps, scalar_slot, future=fut, ports=ports_w,
                    self_anti=self_anti, live_out=live, plain=plain,
                )
                if at_w is not None:
                    affkernels.aff_filter(choice, live, pid_l, at_w, acc,
                                          acc_pipe, gm=gm, term_req=term_req,
                                          prof_req=prof_req_terms,
                                          plain=plain)
                kernels.apply_commit(
                    choice, acc, p_req, pid_l, qidx, st.idle, st.q_alloc,
                    mode=0, idle_sign=-1.0, jw=jw, ntasks=st.ntasks,
                    alloc_l=alloc_l, assigned=assigned_w, scratch=scratch,
                    pipe=acc_pipe, pip=pip, ports=ports_w, counts=at_w,
                    match_terms=match_w, plain=plain,
                )
                resolved = acc if acc_pipe is None else acc | acc_pipe
                done_sub = done_sub | resolved
                if steer:
                    torch.any(resolved & steer_rel, dim=0, keepdim=True,
                              out=steer_dirty)
                subs += 1
                syncs += 1
                go = bool(resolved.any()
                          & (cand & ~done_sub & ~aborted).any())

            if at_w is not None and AFF_ACACHE:
                # JAX's cnt_changed, OR-ed over this attempt's sub-rounds
                # (wave.py:2115-2122): a task they accepted or pipelined
                # matches a window term.  The next attempt's gate.
                torch.any((done_sub & ~done) & matches_any_t, dim=0,
                          keepdim=True, out=aff_dirty)
            fit_upd = torch.zeros(W, dtype=torch.bool, device=dev)
            fit_upd[jw_l[no_node & real_w]] = True
            fitf_l = fitf_l | fit_upd
            skip_l = skip_l | fit_upd
            new_done = done_sub | no_node
            syncs += 1
            stalled = not bool((new_done & ~done).any()) and bool(
                torch.equal(skip_l, skip_l0))
            done = done | new_done
            it += max(subs, 1)

        iters += it
        if at_w is not None and not terms_disjoint:
            # Window write-back: real rows are unique in the window, the
            # repeated dummy rows hold zeros (wave.py:2226-2236).
            cnt_alloc[wt] = at_w.cnt_a
            if has_future:
                cnt_pip[wt] = at_w.cnt_p
        st.alloc_cnt[jwin] = alloc_l
        st.fit_failed[jwin] = fitf_l
        st.job_skip[jwin] = skip_l
        st.job_overskip[jwin] = over_l
        st.assigned[sl] = assigned_w
        st.pipelined[sl] = pipelined_w

    # ---- gang commit/discard (stmt.Discard, wave.py:2262-2274) ----------
    # Readiness counts allocations only, and the discard leaves pipelined
    # rows alone (wave.py:2262-2272).
    min_av_p = torch.cat([jobs.min_available.to(i32),
                          torch.full((W,), 1 << 30, dtype=i32, device=dev)])
    ready_base_p = torch.cat([jobs.ready_base.to(i32),
                              torch.zeros(W, dtype=i32, device=dev)])
    job_ready = ready_base_p + st.alloc_cnt >= min_av_p
    never_ready_p = job_seen & ~st.job_overskip & ~job_ready
    discard = never_ready_p[tjob] & real & (st.assigned >= 0)
    kernels.apply_commit(
        st.assigned.clamp(min=0), discard, prof.req, pid,
        queue_p[tjob].contiguous(), st.idle, st.q_alloc, mode=1,
        idle_sign=1.0, assigned=st.assigned, scratch=scratch, plain=plain,
    )
    assigned = st.assigned
    pipelined = st.pipelined
    if N <= 32000:
        # Node indices fit int16 whenever N does (wave.py:2275).
        assigned = assigned.to(torch.int16)
        pipelined = pipelined.to(torch.int16)
    rec = _twophase()
    rec["syncs"] = syncs
    rec["aff_attempts"] = aff_attempts
    rec["steer_calls"] = steer_calls
    return AllocResult(
        assigned=assigned,
        pipelined=pipelined,
        never_ready=never_ready_p[:J],
        fit_failed=st.fit_failed[:J],
        idle=st.idle,
        q_alloc=st.q_alloc + st.q_pip,
        iters=torch.tensor(iters, dtype=i32, device=dev),
        fb_exhausted=torch.tensor(fb_exhausted, dtype=i32, device=dev),
        fb_affinity=torch.tensor(fb_affinity, dtype=i32, device=dev),
    )


def _sync(dev: torch.device) -> None:
    """Wait for the calling thread's current stream (a pipelined solve
    runs on the worker's stream beside the cycle thread's)."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def solve_wave(
    nodes: SolveNodes,
    tasks: SolveTasks,
    jobs: SolveJobs,
    queues: SolveQueues,
    weights: ScoreWeights,
    eps,
    scalar_slot,
    aff: AffinityArgs,
    node_bias=None,
    wave: int = DEFAULT_WAVE,
    pid=None,
    profiles: SolveProfiles = None,
    extra_ok=None,
    extra_score=None,
    taint_any=None,
    node_classes: NodeClasses = None,
    mesh_shards: int = 1,
    devincr=None,
    device=None,
    plain: bool = False,
) -> AllocResult:
    """Wave-batched solve, two-phase unless ``VOLCANO_TPU_TWOPHASE=0``
    (read per call) or the node table is empty; the JAX ``solve_wave``'s
    signature and result (wave.py:2674).  Single-phase, ``node_classes``
    and ``devincr`` are not used and ``LAST_TWOPHASE["enabled"]`` is
    False, as in JAX.  Also:

    ``device``: where the solve runs -- the card unless the caller passes
    ``device="cpu"`` (without a card the default raises).  Task, job,
    queue and affinity inputs are read as numpy.  Node planes are taken as
    given: numpy planes upload, tensors already on ``device`` (a
    device-resident snapshot) are used in place and never copied back; the
    host flags the prep needs come from ``taint_any`` / ``node_classes``
    or from host arrays, and any flag read off a device tensor counts in
    ``LAST_TWOPHASE["host_reads"]``.

    ``node_bias``: the [N] f32 fabric-topology node-order bias
    (``ops/topology.contig_bias``), added to every profile's static score
    in the live rankings (shortlist and full-N fallback) and nowhere in
    phase 1, as the JAX solve folds it (wave.py:1170-1179); None adds
    nothing.

    ``devincr``: an ``ops.devincr.DeviceIncremental`` primed by
    ``begin_solve`` -- its persistent static planes and warm shortlists
    replace the direct coarse pass, with identical results.

    ``extra_ok`` / ``extra_score``: a custom plugin's [P, N] verdicts and
    scores (the object session's allocate action).  They split profiles
    (``_profile_tasks``), and ``coarse_shortlist`` and both rankings read
    them per profile: verdicts ANDed into feasibility, scores added to the
    static score (wave.py:642-645, :1127-1139, :1165-1168).  Such a solve
    computes its own profiles (``pid`` / ``profiles`` refused) and sits
    ``devincr`` out, as the JAX solve does.

    ``plain``: run the kernels' plain PyTorch versions on the card.  Only
    the kernel-versus-plain comparison of ``chip_smoke.py`` sets it; on CPU
    tensors the plain versions run regardless.

    The result's tensors live on ``device``.
    """
    dev = resolve_device(device)
    if mesh_shards and int(mesh_shards) > 1:
        raise _unsupported("mesh sharding (mesh_shards > 1)",
                           "queue 1, multi-GPU")
    if (extra_ok is not None or extra_score is not None) and (
            pid is not None or profiles is not None):
        raise ValueError(
            "extra_ok/extra_score require in-call profile computation"
        )
    t_start = _time.perf_counter()
    # Node planes are taken as given: numpy planes upload, tensors (the
    # fast path's device-resident snapshot) are used where they lie and
    # are never read back.  Host flags come from host arrays or from the
    # caller (taint_any, node_classes); a flag that has to be read off a
    # device tensor is counted in LAST_TWOPHASE["host_reads"].
    host_reads = 0

    def host_any(a) -> bool:
        nonlocal host_reads
        if isinstance(a, torch.Tensor) and a.device.type != "cpu":
            host_reads += 1
            return bool(a.any())
        return bool(_np(a).any())

    tasks = SolveTasks(*[_np(a) for a in tasks])
    jobs = SolveJobs(*[_np(a) for a in jobs])
    queues = SolveQueues(*[_np(a) for a in queues])
    aff = AffinityArgs(*[_np(a) for a in aff])
    P = int(tasks.job.shape[0])
    wave = int(min(wave, max(1, P)))
    pad = (-P) % wave
    if pad:
        tasks = _pad_tasks(tasks, pad)
        if profiles is None:
            aff = _pad_aff(aff, pad)
        if extra_ok is not None:
            extra_ok = np.concatenate([
                _np(extra_ok).astype(bool),
                np.ones((pad, _np(extra_ok).shape[1]), bool),
            ])
        if extra_score is not None:
            extra_score = np.concatenate([
                _np(extra_score).astype(np.float32),
                np.zeros((pad, _np(extra_score).shape[1]), np.float32),
            ])
    n_waves = (P + pad) // wave
    if profiles is not None and pid is not None:
        pid = np.asarray(_np(pid), np.int64)
        profiles = SolveProfiles(*[_np(a) for a in profiles])
        if pad:
            # Padded rows are all-zero features: append a fresh profile.
            fresh = int(pid.max() + 1) if len(pid) else 0
            pid = np.concatenate([pid, np.full(pad, fresh, np.int64)])
            profiles = SolveProfiles(*[
                np.concatenate([a, np.zeros((1, *a.shape[1:]), a.dtype)])
                for a in profiles
            ])
        pid = pid.astype(np.int32)
    elif pid is not None:
        pid = np.asarray(_np(pid), np.int64)
        if pad:
            fresh = (pid.max() + 1) if len(pid) else 0
            pid = np.concatenate([pid, np.full(pad, fresh, np.int64)])
        profiles, pid = _profiles_from_pid(tasks, aff, pid)
    else:
        profiles, pid, extra_prof, score_prof = _profile_tasks(
            tasks, aff, extra_ok, extra_score)
    u_before = int(profiles.req.shape[0])
    profiles = _pad_profiles_rows(profiles)
    u_pad = int(profiles.req.shape[0]) - u_before
    extra = None
    if extra_ok is not None or extra_score is not None:
        # The custom plugins' planes per profile row, padded rows
        # all-feasible and zero-scored (wave.py:2786-2802).
        if extra_ok is not None:
            extra_prof = np.concatenate([
                extra_prof.astype(bool),
                np.ones((u_pad, extra_prof.shape[1]), bool)])
        if extra_score is not None:
            score_prof = np.concatenate([
                score_prof, np.zeros((u_pad, score_prof.shape[1]),
                                     np.float32)])
        extra = kernels.Extra(
            None if extra_ok is None else to_tensor(extra_prof, dev),
            None if extra_score is None else to_tensor(score_prof, dev))
    wave_prof = _wave_profiles(pid, n_waves, wave)
    cnt0_host = _np(aff.cnt0)
    cnt0_sparse = cnt0_host.size > CNT0_SPARSE_MIN
    if cnt0_sparse:
        # One scan serves both the feature bit and the sparse extraction.
        rows_nz, cols_nz = np.nonzero(cnt0_host)
        cnt0_any = bool(len(rows_nz))
    else:
        cnt0_any = bool(cnt0_host.any())
    features = (
        bool(_np(profiles.ports).any()),
        bool(
            _np(profiles.t_req_aff).any()
            or _np(profiles.t_req_anti).any()
            or _np(profiles.t_soft).any()
            or cnt0_any
        ),
        (bool(taint_any) if taint_any is not None
         else host_any(nodes.taint_bits)),
        host_any(nodes.releasing) or host_any(nodes.pipelined),
        bool((_np(queues.deserved) < 1.0e38).any()),
        extra_ok is not None,
        extra_score is not None,
    )
    prof_sparse = _np(profiles.t_req_aff).size > PROF_SPARSE_MIN
    profiles, aff, wave_terms, _ew, prof_iom, terms_disjoint = (
        _term_windows(profiles, aff, pid, wave_prof, n_waves,
                      skip_cnt0=cnt0_sparse, skip_prof=prof_sparse))
    if prof_sparse:
        # Past the threshold the four tables ship as their nonzero entries
        # and are rebuilt on the device at the dummy-extended width
        # (wave.py:2858-2905): the dummy column is all-zero, so the entry
        # set is the same.
        t_aff_h = _np(profiles.t_req_aff)
        ur, ec = np.nonzero(prof_iom)
        flags = (
            t_aff_h[ur, ec].astype(np.int8)
            | (_np(profiles.t_req_anti)[ur, ec].astype(np.int8) << 1)
            | (_np(profiles.t_matches)[ur, ec].astype(np.int8) << 2)
        )
        soft_vals = _np(profiles.t_soft)[ur, ec].astype(np.float32)
        k = bucket_pow2(len(ur), floor=16)
        ppad = k - len(ur)
        # Padded entries add flags 0 and +0.0 at (0, 0).
        ur = np.concatenate([ur, np.zeros(ppad, np.int64)])
        ec = np.concatenate([ec, np.zeros(ppad, np.int64)])
        flags = np.concatenate([flags, np.zeros(ppad, np.int8)])
        soft_vals = np.concatenate([soft_vals, np.zeros(ppad, np.float32)])
        d_aff, d_anti, d_mat, d_soft = affkernels.scatter_profile_tables(
            to_tensor(ur.astype(np.int32), dev),
            to_tensor(ec.astype(np.int32), dev), to_tensor(flags, dev),
            to_tensor(soft_vals, dev), t_aff_h.shape[0],
            t_aff_h.shape[1] + 1, plain=plain)
        profiles = profiles._replace(t_req_aff=d_aff, t_req_anti=d_anti,
                                     t_matches=d_mat, t_soft=d_soft)
    if cnt0_sparse:
        # Large [Ep, D] count tables ship as their resident entries and are
        # scattered on the device into the dummy-extended shape
        # (wave.py:2906-2930).
        vals_nz = cnt0_host[rows_nz, cols_nz].astype(np.int32)
        k = bucket_pow2(len(rows_nz), floor=16)
        cpad = k - len(rows_nz)
        # Padded entries add 0 to cell (0, 0): a no-op.
        rows_nz = np.concatenate([rows_nz, np.zeros(cpad, np.int64)])
        cols_nz = np.concatenate([cols_nz, np.zeros(cpad, np.int64)])
        vals_nz = np.concatenate([vals_nz, np.zeros(cpad, np.int32)])
        aff = aff._replace(cnt0=affkernels.scatter_cnt0(
            to_tensor(rows_nz.astype(np.int32), dev),
            to_tensor(cols_nz.astype(np.int32), dev),
            to_tensor(vals_nz, dev), cnt0_host.shape[0] + 1,
            cnt0_host.shape[1], plain=plain))
    N_in = int(nodes.idle.shape[0])
    # The single-phase solve (wave.py:2959) builds no classes, no
    # shortlists and no device-incremental state.
    two_phase = _two_phase_on() and N_in > 0
    if two_phase and node_classes is None and _nodeclass_on():
        planes = (nodes.label_bits, nodes.taint_bits, nodes.ready,
                  nodes.allocatable, nodes.max_tasks)
        host_reads += sum(isinstance(a, torch.Tensor)
                          and a.device.type != "cpu" for a in planes)
        node_classes = _host_node_classes(
            nodes._replace(**{f: _np(getattr(nodes, f)) for f in (
                "label_bits", "taint_bits", "ready", "allocatable",
                "max_tasks")}))
    cls_identity = node_classes is None or not two_phase
    sl_k = shortlist_size(N_in)

    # Device placement.  Bit planes travel as int32 (same bits).
    nodes_t = tree_to(nodes, dev)
    prof_t = tree_to(profiles, dev)
    cls_t = _identity_classes(nodes_t) if cls_identity else tree_to(
        NodeClasses(*node_classes), dev)
    weights_t = ScoreWeights(
        binpack_weight=float(weights.binpack_weight),
        binpack_res=to_tensor(np.asarray(_np(weights.binpack_res),
                                         np.float32), dev),
        least_req_weight=float(weights.least_req_weight),
        most_req_weight=float(weights.most_req_weight),
        balanced_weight=float(weights.balanced_weight),
        node_affinity_weight=float(weights.node_affinity_weight),
    )
    eps_t = to_tensor(np.asarray(_np(eps), np.float32), dev)
    slot_t = to_tensor(np.asarray(_np(scalar_slot), bool), dev)
    jobs_t = tree_to(jobs, dev)
    queues_t = tree_to(queues, dev)
    bias_t = None
    if node_bias is not None:
        bias_t = to_tensor(np.asarray(_np(node_bias), np.float32), dev)
        if tuple(bias_t.shape) != (N_in,):
            raise ValueError(f"node_bias is {tuple(bias_t.shape)}, "
                             f"not [{N_in}]")
    pid_t = to_tensor(pid.astype(np.int32), dev)
    aff_t = None
    aff1 = None
    ports1 = None
    if features[0] and two_phase:
        ports1 = kernels.Ports(prof_t.ports, nodes_t.ports)
    if features[1]:
        aff_t = AffinityArgs(
            node_dom=to_tensor(np.asarray(_np(aff.node_dom), np.int32), dev),
            term_key=to_tensor(np.asarray(_np(aff.term_key), np.int32),
                               dev),
            cnt0=to_tensor(aff.cnt0, dev).to(torch.int32),
            t_req_aff=None, t_req_anti=None, t_matches=None, t_soft=None)
        if cnt0_any and two_phase:
            aff1 = Phase1Aff(
                AffTerms(aff_t.node_dom, aff_t.term_key, aff_t.cnt0, None,
                         prof_t.t_req_aff, prof_t.t_req_anti,
                         prof_t.t_matches, prof_t.t_soft),
                to_tensor(_profile_term_lists(prof_iom), dev))
    host = {
        "job": tasks.job.astype(np.int64),
        "real": tasks.real.astype(bool),
        "pid": pid.astype(np.int64),
        "queue": jobs.queue,
    }
    _sync(dev)
    t_prep = _time.perf_counter() - t_start

    t0 = _time.perf_counter()
    # Custom-plugin solves carry per-solve [U, N] planes the
    # device-incremental lane's keys cannot cover: it sits them out, as in
    # the JAX package (wave.py:2981-2985).
    dv = devincr if extra is None and two_phase else None
    # Device-incremental lane: persistent [U, C] static planes and
    # warm-started shortlists, bit-identical to the direct pass (None
    # without a static key from begin_solve).
    stat = None if dv is None else dv.static_planes(
        prof_t, cls_t, weights_t.node_affinity_weight,
        has_taints=features[2], cls_identity=cls_identity, plain=plain)
    future0 = _future_planes(nodes_t, features)
    if not two_phase:
        sl = stat_ok = stat_score = None
    elif stat is not None:
        sl = dv.shortlist(nodes_t, prof_t, cls_t, weights_t, eps_t, slot_t,
                          sl_k, features, cls_identity, stat,
                          future=future0, ports=ports1, aff1=aff1,
                          plain=plain)
        stat_ok, stat_score = stat
    else:
        sl, stat_ok, stat_score = _coarse_shortlist(
            nodes_t, prof_t, cls_t, weights_t, eps_t, slot_t, sl_k,
            features, future=future0, ports=ports1, aff1=aff1, extra=extra,
            plain=plain,
        )
    _sync(dev)
    t_coarse = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    res = _solve_wave(
        nodes_t, jobs_t, queues_t, weights_t, eps_t, slot_t, prof_t,
        pid_t, wave_prof, cls_t, sl, stat_ok, stat_score, host,
        wave=wave, n_waves=n_waves, features=features,
        fb_cap=_fallback_cap(), future0=future0, bias=bias_t, aff=aff_t,
        wave_terms=wave_terms, terms_disjoint=terms_disjoint, extra=extra,
        plain=plain,
    )
    _sync(dev)
    t_fine = _time.perf_counter() - t0
    rec = _twophase()
    syncs = rec.get("syncs", 0)
    aff_attempts = rec.get("aff_attempts", 0)
    steer_calls = rec.get("steer_calls", 0)
    rec.clear()
    rec.update({
        "enabled": two_phase,
        "prep_s": t_prep,
        "coarse_s": t_coarse,
        "fine_s": t_fine,
        "shortlist": ((int(profiles.req.shape[0]), sl_k) if two_phase
                      else None),
        "n_nodes": N_in,
        "compacted_classes": not cls_identity,
        "waves": n_waves,
        "syncs": syncs,
        # Attempts of live waves: the attempt cache's affinity calls
        # (computing or, behind the cache's byte, gated).
        "aff_attempts": aff_attempts,
        # aff_steer calls (computing or, behind the steering byte, gated).
        "steer_calls": steer_calls,
        "host_reads": host_reads,
        # The solve ran the releasing-capacity (has_future) branch.
        "future": future0 is not None,
        # Host ports, inter-pod terms, and whether phase 1 read counts.
        "ports": bool(features[0]),
        "affinity": bool(features[1]),
        "cnt0_any": cnt0_any,
        "sparse": (bool(cnt0_sparse), bool(prof_sparse)),
        "terms_disjoint": bool(terms_disjoint),
        "devincr": dv.solve_info() if dv is not None else None,
    })
    if dv is not None:
        dv.end_solve()
    if pad:
        res = res._replace(
            assigned=res.assigned[:P], pipelined=res.pipelined[:P]
        )
    return res
