"""The inter-pod affinity kernels of the wave solve, and their plain
PyTorch versions.

=============================  ============================================
wrapper                        replaces (JAX package)
=============================  ============================================
``scatter_cnt0``               ``ops/wave.py:_scatter_cnt0`` (:2296)
``scatter_profile_tables``     ``ops/wave.py:_scatter_profile_tables``
                               (:2301)
``aff_live``                   the count-window reads of ``_solve_wave``:
                               phase 1's ``cnt0`` planes (:615-660,
                               :777-812), the attempt cache of
                               ``live_parts_sl`` (:1329-1389) and the
                               fallback's ``live_parts`` (:1229-1282)
``aff_filter``                 the sub-round's live per-task recheck and
                               pair-conflict filter (:1749-2000)
``aff_steer``                  the sub-round's live steering (``steer``,
                               :1594-1652): the ranked candidates'
                               required (anti-)affinity on the live window
=============================  ============================================

The loader, the launch counts and the input capture are ``ops/kernels.py``'s;
the sources are ``csrc/aff_tables.cu``, ``csrc/aff_live.cu``,
``csrc/aff_steer.cu`` and ``csrc/aff_filter.cu``.  Each wrapper runs its
plain version on CPU tensors and launches its kernel on CUDA tensors
(``plain=True`` forces the plain version on the card, for comparisons
only).

The count reads gather: a term's count at node n is ``cnt[e, node_dom[n,
term_key[e]]]`` (0 where the node has no domain under the term's key).  The
JAX package reads them on a TPU as one MXU product against a dense [N, D]
domain one-hot (``dom_ohT``) below ``DOM_MM_MAX_MB`` and by the same gather
above it; the two agree because counts are integers and only one product
per output is nonzero, so the port keeps the gather alone and never builds
the [N, D] plane.  The TPU's bf16 violation products only classify zero
against nonzero: here they are integer and boolean tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .kernels import (_capture, _check, _on_card, _ptr, _req,
                      _stream, count_launch, load, tally)

AFF_TOTAL_CHUNK = 4096  # csrc/aff_live.cu kTotChunk


class AffTerms(NamedTuple):
    """The count tables and profile-term tables one affinity read works
    on: the whole solve's (phase 1: ``cnt0`` with its dummy row, the
    [U, E + 1] profile tables) or one wave's window (phase 2: the [EW, D]
    windows ``cw_a`` / ``cw_p`` and the wave's [UM, EW] table columns)."""

    node_dom: torch.Tensor  # [N, K] int32 domain per topology key, -1 none
    term_key: torch.Tensor  # [E] int32 key column of each count row
    cnt_a: torch.Tensor  # [E, D] int32 resident (allocated) matches
    cnt_p: Optional[torch.Tensor]  # [E, D] int32 pipelined matches, or None
    t_req_aff: torch.Tensor  # [U, E] bool
    t_req_anti: torch.Tensor  # [U, E] bool
    t_matches: torch.Tensor  # [U, E] bool
    t_soft: torch.Tensor  # [U, E] f32


def _counts(at: AffTerms) -> torch.Tensor:
    return at.cnt_a if at.cnt_p is None else at.cnt_a + at.cnt_p


def _check_terms(at: AffTerms, name: str) -> AffTerms:
    i32 = torch.int32
    a = AffTerms(
        node_dom=_req(at.node_dom, i32, f"{name} node_dom"),
        term_key=_req(at.term_key, i32, f"{name} term_key"),
        cnt_a=_req(at.cnt_a, i32, f"{name} cnt_a"),
        cnt_p=None if at.cnt_p is None else _req(at.cnt_p, i32,
                                                 f"{name} cnt_p"),
        t_req_aff=_req(at.t_req_aff, torch.bool, f"{name} t_req_aff"),
        t_req_anti=_req(at.t_req_anti, torch.bool, f"{name} t_req_anti"),
        t_matches=_req(at.t_matches, torch.bool, f"{name} t_matches"),
        t_soft=_req(at.t_soft, torch.float32, f"{name} t_soft"),
    )
    E, D = a.cnt_a.shape
    U = a.t_req_aff.shape[0]
    if (a.term_key.shape != (E,) or a.node_dom.dim() != 2
            or (a.cnt_p is not None and a.cnt_p.shape != (E, D))
            or any(t.shape != (U, E) for t in (a.t_req_aff, a.t_req_anti,
                                               a.t_matches, a.t_soft))):
        raise ValueError(f"{name}: inconsistent affinity table shapes")
    return a


# ----------------------------------------------------------- scatter_cnt0

def scatter_cnt0(rows, cols, vals, e: int, d: int, plain: bool = False):
    """Dense [e, d] int32 counts from sparse entries (wave.py:2296): every
    entry adds ``vals[i]`` at ``(rows[i], cols[i])``; padded entries add 0
    at (0, 0).  Integer adds are exact in any order."""
    if not _on_card(plain, rows, cols, vals):
        out = torch.zeros((e, d), dtype=torch.int32, device=vals.device)
        out.index_put_((rows.long(), cols.long()), vals, accumulate=True)
        return out
    i32 = torch.int32
    rows = _req(rows, i32, "rows")
    cols = _req(cols, i32, "cols")
    vals = _req(vals, i32, "vals")
    k = rows.shape[0]
    if rows.dim() != 1 or cols.shape != (k,) or vals.shape != (k,):
        raise ValueError("scatter_cnt0: entries must be three [k] vectors")
    if e < 1 or d < 1 or e * d >= 1 << 62:
        raise ValueError(f"scatter_cnt0: bad table shape ({e}, {d})")
    _capture("scatter_cnt0", rows=rows, cols=cols, vals=vals, e=e, d=d)
    out = torch.empty((e, d), dtype=i32, device=vals.device)
    rc = load().vtt_scatter_cnt0(_ptr(rows), _ptr(cols), _ptr(vals), k, e, d,
                                 _ptr(out), _stream())
    _check(rc, "scatter_cnt0")
    count_launch("scatter_cnt0")
    return out


# ------------------------------------------------- scatter_profile_tables

def _profile_tables_plain(rows, cols, flags, soft, u: int, e: int):
    idx = (rows.long(), cols.long())
    dev = soft.device
    f = flags.to(torch.int8)
    out = []
    for bit in range(3):
        zb = torch.zeros((u, e), dtype=torch.int8, device=dev)
        zb.index_put_(idx, (f >> bit) & 1, accumulate=True)
        out.append(zb > 0)
    st = torch.zeros((u, e), dtype=torch.float32, device=dev)
    st.index_put_(idx, soft, accumulate=True)
    return out[0], out[1], out[2], st


def scatter_profile_tables(rows, cols, flags, soft, u: int, e: int,
                           plain: bool = False):
    """The dense [u, e] profile-term tables from sparse entries
    (wave.py:2301): ``flags`` bits 0/1/2 are required affinity, required
    anti-affinity and self-match, each summed as int8 counts per cell and
    then tested > 0; ``soft`` adds as f32.  Returns ``(t_req_aff,
    t_req_anti, t_matches, t_soft)``.

    Real (row, col) pairs are unique, so a real cell takes exactly one
    add; the padded entries add flags 0 and +0.0 at (0, 0).  A cell's
    count is therefore its entry's flag bit, and its soft value 0.0 + v
    in any add order (v + 0.0 = v for every v other than -0.0, which a
    table built by adding onto +0.0 never holds).

    On the card: two launches, a zero fill of the four planes with
    16-byte stores and a scatter of the entries.  The planes are views of
    one buffer, each starting at a multiple of 16 bytes."""
    if not _on_card(plain, rows, cols, soft):
        return _profile_tables_plain(rows, cols, flags, soft, u, e)
    i32 = torch.int32
    rows = _req(rows, i32, "rows")
    cols = _req(cols, i32, "cols")
    flags = _req(flags, torch.int8, "flags")
    soft = _req(soft, torch.float32, "soft")
    k = rows.shape[0]
    if (rows.dim() != 1 or cols.shape != (k,) or flags.shape != (k,)
            or soft.shape != (k,)):
        raise ValueError("scatter_profile_tables: entries must be [k]")
    if u < 1 or e < 1:
        raise ValueError(f"scatter_profile_tables: bad shape ({u}, {e})")
    _capture("scatter_profile_tables", rows=rows, cols=cols, flags=flags,
             soft=soft, u=u, e=e)
    cells = u * e
    # soft, aff, anti, match: each plane's offset a multiple of 16 bytes
    # in one buffer (whose start the allocator aligns far wider).
    sizes = (4 * cells, cells, cells, cells)
    offs, off = [], 0
    for n in sizes:
        offs.append(off)
        off += -(-n // 16) * 16
    buf = torch.empty(off, dtype=torch.uint8, device=soft.device)
    st = buf[:sizes[0]].view(torch.float32).view(u, e)
    aff, anti, match = (buf[o:o + cells].view(torch.bool).view(u, e)
                        for o in offs[1:])
    rc = load().vtt_scatter_profile_tables(
        _ptr(rows), _ptr(cols), _ptr(flags), _ptr(soft), k, u, e,
        _ptr(aff), _ptr(anti), _ptr(match), _ptr(st), _stream())
    _check(rc, "scatter_profile_tables")
    count_launch("scatter_profile_tables")
    return aff, anti, match, st


# --------------------------------------------------------------- aff_live

def _node_rows(rows, cand, N: int, dev):
    M = rows.shape[0]
    if cand is None:
        return torch.arange(N, device=dev)[None, :].expand(M, N)
    if cand.dim() == 1:
        return cand.long()[None, :].expand(M, -1)
    return cand.long()[rows.long()]


def _aff_live_plain(rows, cand, terms, at: AffTerms):
    N = at.node_dom.shape[0]
    dev = at.cnt_a.device
    nodes = _node_rows(rows, cand, N, dev)  # [M, L]
    M = rows.shape[0]
    cnt = _counts(at)
    tot = cnt.sum(dim=1)
    tsel = terms.long().expand(M, -1)  # [M, T]
    valid = tsel >= 0
    tc = tsel.clamp(min=0)
    key = at.term_key.long()[tc]  # [M, T]
    dom = at.node_dom.long()[nodes[:, :, None], key[:, None, :]]  # [M,L,T]
    cv = torch.where(dom >= 0, cnt[tc[:, None, :], dom.clamp(min=0)],
                     torch.zeros_like(dom, dtype=cnt.dtype))
    u = rows.long()[:, None]
    ra = at.t_req_aff[u, tc] & valid
    an = at.t_req_anti[u, tc] & valid
    ma = at.t_matches[u, tc] & valid
    selfok = (tot[tc] == 0) & ma
    need = ra & ~selfok
    viol = ((need[:, None, :] & (cv == 0))
            | (an[:, None, :] & (cv > 0))).any(dim=-1)
    w = torch.where(valid, at.t_soft[u, tc], torch.zeros_like(
        at.t_soft[u, tc]))
    soft = torch.zeros(nodes.shape, dtype=torch.float32, device=dev)
    for j in range(tc.shape[1]):
        soft = soft + w[:, j:j + 1] * cv[:, :, j].to(torch.float32)
    return ~viol, soft


def aff_live(rows, cand, terms, at: AffTerms, plain: bool = False, *,
             gate=None, out=None):
    """Required-affinity / anti-affinity verdicts and soft scores of the
    profile rows ``rows`` ([M] int32 into the tables' rows) at candidate
    nodes: ``cand`` None (all N nodes), [L] int32 (one node list shared
    by every row) or [U, L] int32 (row ``rows[b]``'s own candidates, as
    ``rank_candidates`` reads them).  ``terms`` ([M, T] or [1, T] int32,
    -1 padded at the end) lists the term columns each row reads: a row's
    verdict and score only depend on the columns where one of its four
    table entries is nonzero, so phase 1 passes each profile's own list
    and phase 2 the whole window.

    For each (row, node): cv[e] = cnt[e, node_dom[n, term_key[e]]] (0
    without a domain); the row is feasible unless a required term with
    cv == 0 lacks the self-match rule (no match anywhere: total == 0 and
    the task matches its own term) or an anti term has cv > 0; its soft
    score is sum_e t_soft[u, e] * cv[e] over the listed terms, left to
    right from +0.0 (integer products: exact below 2^24).

    The attempt cache (wave.py:1368-1371): with ``gate`` (a [1] bool
    tensor beside the counts) the planes are written into ``out`` (the
    caller's [M, L] ``(ok, soft)`` buffers) only when the gate is set, and
    ``out`` is left as it was when it is clear.  On the card the kernel
    reads the gate itself (no host read); the plain version reads it on the
    host.  Every computing call adds one to ``kernels.tally("aff_live")``
    on the counts' device.

    Returns ``(ok [M, L] bool, soft [M, L] f32)`` (``out`` when given)."""
    if gate is not None and out is None:
        raise ValueError("aff_live: a gate needs the out buffers")
    dev = at.cnt_a.device
    if not _on_card(plain, rows, at.cnt_a, terms):
        if gate is not None and not bool(gate[0]):
            return out
        tally("aff_live", dev).add_(1)
        ok, soft = _aff_live_plain(rows, cand, terms, at)
        if out is None:
            return ok, soft
        out[0].copy_(ok)
        out[1].copy_(soft)
        return out
    at = _check_terms(at, "aff_live")
    rows = _req(rows, torch.int32, "rows")
    terms = _req(terms, torch.int32, "terms")
    N, K = at.node_dom.shape
    E, D = at.cnt_a.shape
    U = at.t_req_aff.shape[0]
    M = rows.shape[0]
    if cand is None:
        mode, L = 0, N
    else:
        cand = _req(cand, torch.int32, "cand")
        mode, L = (1, cand.shape[0]) if cand.dim() == 1 else (
            2, cand.shape[1])
        if mode == 2 and cand.shape[0] != U:
            raise ValueError("aff_live: cand rows must match the tables")
    if (rows.dim() != 1 or terms.dim() != 2
            or terms.shape[0] not in (1, M) or terms.shape[1] < 1):
        raise ValueError("aff_live: inconsistent input shapes")
    if out is None:
        ok = torch.empty((M, L), dtype=torch.bool, device=dev)
        soft = torch.empty((M, L), dtype=torch.float32, device=dev)
    else:
        ok = _req(out[0], torch.bool, "aff_live out ok")
        soft = _req(out[1], torch.float32, "aff_live out soft")
        if ok.shape != (M, L) or soft.shape != (M, L):
            raise ValueError(f"aff_live: out planes are not [{M}, {L}]")
    if gate is not None and (_req(gate, torch.bool, "aff_live gate").shape
                             != (1,)):
        raise ValueError("aff_live: gate is not [1]")
    if M == 0 or L == 0:
        return ok, soft
    # The gate and the buffers' prior contents are captured too: a gated
    # launch's replay compares "unchanged" against "unchanged".
    _capture("aff_live", rows=rows, cand=cand, terms=terms, at=at,
             gate=gate, out=None if out is None else (ok, soft))
    # The totals' partial sums, one per (term row, AFF_TOTAL_CHUNK domains).
    part = torch.empty(E * max(1, -(-D // AFF_TOTAL_CHUNK)),
                       dtype=torch.int32, device=dev)
    rc = load().vtt_aff_live(
        _ptr(rows), M, _ptr(cand), mode, L, _ptr(terms),
        int(terms.shape[0] != 1), terms.shape[1], _ptr(at.node_dom), K,
        _ptr(at.term_key), _ptr(at.cnt_a), _ptr(at.cnt_p), E, D,
        _ptr(at.t_req_aff), _ptr(at.t_req_anti), _ptr(at.t_matches),
        _ptr(at.t_soft), _ptr(part), _ptr(gate),
        _ptr(tally("aff_live", dev)), _ptr(ok), _ptr(soft), _stream())
    _check(rc, "aff_live")
    count_launch("aff_live")
    return ok, soft


# ------------------------------------------------------------- aff_filter

def _aff_filter_plain(choice, live, pid_l, at: AffTerms):
    W = choice.shape[0]
    E, D = at.cnt_a.shape
    dev = at.cnt_a.device
    cnt = _counts(at)
    tot = cnt.sum(dim=1)
    ch = choice.long()
    dw = at.node_dom.long()[ch[:, None], at.term_key.long()[None, :]]
    e_idx = torch.arange(E, device=dev)[None, :]
    cval = torch.where(dw >= 0, cnt[e_idx, dw.clamp(min=0)],
                       torch.zeros_like(dw, dtype=cnt.dtype))
    pl = pid_l.long()
    req_aff = at.t_req_aff[pl]
    anti = at.t_req_anti[pl]
    match = at.t_matches[pl]
    selfok = (tot == 0)[None, :] & match
    aff_ok = ~(req_aff & ~selfok & (cval == 0)).any(dim=1)
    anti_ok = ~(anti & (cval > 0)).any(dim=1)
    anti_inv = anti & (dw >= 0)
    uses_selfok = req_aff & selfok & (cval == 0)
    term_req = (at.t_req_aff | at.t_req_anti).any(dim=0)
    gmask = match & (dw >= 0) & live[:, None] & term_req[None, :]
    jidx = torch.arange(W, device=dev)
    jb = jidx[:, None].expand(W, E)
    # Earliest live giver per (term, domain): 2-D keys in a flat int64
    # index, padded column D for the entries that give nothing.
    keys = e_idx * (D + 1) + torch.where(gmask, dw, torch.full_like(dw, D))
    gm = torch.full((E * (D + 1),), W, dtype=torch.int64, device=dev)
    gm.scatter_reduce_(0, keys.reshape(-1), jb.reshape(-1), reduce="amin")
    gt = torch.where(gmask, jb, torch.full_like(jb, W)).min(dim=0).values
    gm_my = gm[e_idx * (D + 1) + dw.clamp(min=0)]
    c_anti = (anti_inv & (gm_my < jidx[:, None])).any(dim=1)
    gm_self = torch.where(dw >= 0, gm_my, torch.full_like(gm_my, W))
    c_self = (uses_selfok & (gt[None, :] < jidx[:, None])
              & (gm_self > gt[None, :])).any(dim=1)
    return aff_ok & anti_ok & ~(c_anti | c_self)


def aff_filter(choice, live, pid_l, at: AffTerms, acc, pipe=None, *,
               gm=None, term_req=None, prof_req=None,
               plain: bool = False) -> None:
    """The sub-round's affinity filter (wave.py:1749-2000), applied in
    place to ``acc`` (and ``pipe``): a live task keeps its acceptance only
    if, at its choice node against the live window counts, every required
    term holds (or its self-match rule does), no anti term is violated,
    no earlier live task of this sub-round gives to one of its anti terms
    in its domain, and -- when it relies on the self-match rule -- the
    term's earliest giver in any domain is not earlier than it unless that
    giver is in its own domain.  Only required terms' givers count; the
    earliest giver per (term, domain) is a min, so any order finds it.

    ``choice``, ``pid_l`` [W] int32; ``live``, ``acc``, ``pipe`` [W]
    bool; ``at`` the wave's window.  ``gm`` is the kernel's [E, D] int32
    scratch, filled with W by the caller and left so.  The kernel takes the
    window's constant planes from its caller, derived once per wave:
    ``term_req`` [E] bool (some row requires term e: ``(at.t_req_aff |
    at.t_req_anti).any(0)``) and ``prof_req`` [UM] bool (the row requires
    some term: ``.any(1)``); the plain version derives its own."""
    if not _on_card(plain, choice, at.cnt_a, acc):
        filt = _aff_filter_plain(choice, live, pid_l, at)
        acc &= filt
        if pipe is not None:
            pipe &= filt
        return
    at = _check_terms(at, "aff_filter")
    u8 = torch.bool
    choice = _req(choice, torch.int32, "choice")
    pid_l = _req(pid_l, torch.int32, "pid_l")
    live = _req(live, u8, "live")
    acc = _req(acc, u8, "acc")
    W = choice.shape[0]
    E, D = at.cnt_a.shape
    UM = at.t_req_aff.shape[0]
    N, K = at.node_dom.shape
    if (pid_l.shape != (W,) or live.shape != (W,) or acc.shape != (W,)
            or (pipe is not None and _req(pipe, u8, "pipe").shape != (W,))):
        raise ValueError("aff_filter: inconsistent task shapes")
    if gm is None or gm.dtype != torch.int32 or gm.shape != (E, D):
        raise ValueError("aff_filter: gm must be the [E, D] int32 scratch")
    if (term_req is None or prof_req is None
            or _req(term_req, u8, "term_req").shape != (E,)
            or _req(prof_req, u8, "prof_req").shape != (UM,)):
        raise ValueError("aff_filter: term_req [E] and prof_req [UM] "
                         "bool planes are required")
    if W == 0:
        return
    _capture("aff_filter", choice=choice, live=live, pid_l=pid_l, at=at,
             acc=acc, pipe=pipe, W=W, term_req=term_req, prof_req=prof_req)
    dev = acc.device
    scratch = torch.empty(2 * E + 1 + W, dtype=torch.int32, device=dev)
    rc = load().vtt_aff_filter(
        _ptr(choice), _ptr(live), _ptr(pid_l), W, _ptr(at.node_dom), K,
        _ptr(at.term_key), _ptr(at.cnt_a), _ptr(at.cnt_p), E, D,
        _ptr(at.t_req_aff), _ptr(at.t_req_anti), _ptr(at.t_matches),
        _ptr(term_req), _ptr(prof_req), _ptr(gm), _ptr(scratch), _ptr(acc),
        _ptr(pipe), _stream())
    _check(rc, "aff_filter")
    count_launch("aff_filter")


# -------------------------------------------------------------- aff_steer

def _aff_steer_plain(ranked, feas_att, at: AffTerms):
    E = at.cnt_a.shape[0]
    cnt = _counts(at)
    tot = cnt.sum(dim=1)
    dom = at.node_dom.long()[ranked.long()[:, :, None],
                             at.term_key.long()[None, None, :]]  # [UM,K,E]
    e_idx = torch.arange(E, device=cnt.device)[None, None, :]
    cv = torch.where(dom >= 0, cnt[e_idx, dom.clamp(min=0)],
                     torch.zeros_like(dom, dtype=cnt.dtype))
    need = at.t_req_aff & ~((tot == 0)[None, :] & at.t_matches)
    viol = ((need[:, None, :] & (cv == 0))
            | (at.t_req_anti[:, None, :] & (cv > 0))).any(dim=-1)
    return feas_att & ~viol


def aff_steer(ranked, feas_att, at: AffTerms, plain: bool = False, *,
              gate=None, out=None):
    """The sub-round's live steering (wave.py:1594-1652): ``feas_att``
    ([UM, K] bool, the attempt's feasibility at its ranked nodes
    ``ranked`` [UM, K] int32) kept only where node ``ranked[u, k]`` holds
    every required term of row u on the live window ``at`` (the count
    over the term's domain > 0, unless the self-match rule exempts it:
    no match anywhere and row u matches the term itself) and violates no
    anti term (count 0) -- ``aff_live``'s verdict, at the ranked nodes, on
    the window's [UM, EW] table columns, with no soft score.

    ``gate`` (a [1] bool tensor beside the counts) writes the result into
    ``out`` (the caller's [UM, K] working plane) only when set, leaving it
    as it was when clear; on the card the kernel reads the gate itself.
    Every computing call adds one to ``kernels.tally("aff_steer")`` on the
    counts' device.  On the card a call is one launch, computing or gated,
    with no allocation but a fresh plane when ``out`` is None; a term's
    count row is read only for an entry with ``t_req_aff & t_matches``,
    and only until its first nonzero word.  Returns the [UM, K] bool
    plane (``out`` when given)."""
    if gate is not None and out is None:
        raise ValueError("aff_steer: a gate needs the out plane")
    dev = at.cnt_a.device
    if not _on_card(plain, ranked, at.cnt_a, feas_att):
        if gate is not None and not bool(gate[0]):
            return out
        tally("aff_steer", dev).add_(1)
        res = _aff_steer_plain(ranked, feas_att, at)
        if out is None:
            return res
        out.copy_(res)
        return out
    at = _check_terms(at, "aff_steer")
    ranked = _req(ranked, torch.int32, "ranked")
    feas_att = _req(feas_att, torch.bool, "feas_att")
    UM, K = ranked.shape
    N, NK = at.node_dom.shape
    E, D = at.cnt_a.shape
    if feas_att.shape != (UM, K) or at.t_req_aff.shape[0] != UM:
        raise ValueError("aff_steer: inconsistent input shapes")
    if out is None:
        out = torch.empty((UM, K), dtype=torch.bool, device=dev)
    elif _req(out, torch.bool, "aff_steer out").shape != (UM, K):
        raise ValueError(f"aff_steer: out is not [{UM}, {K}]")
    if gate is not None and (_req(gate, torch.bool, "aff_steer gate").shape
                             != (1,)):
        raise ValueError("aff_steer: gate is not [1]")
    if UM == 0 or K == 0:
        return out
    _capture("aff_steer", ranked=ranked, feas_att=feas_att, at=at,
             gate=gate, out=out)
    rc = load().vtt_aff_steer(
        _ptr(ranked), _ptr(feas_att), UM, K, _ptr(at.node_dom), NK,
        _ptr(at.term_key), _ptr(at.cnt_a), _ptr(at.cnt_p), E, D,
        _ptr(at.t_req_aff), _ptr(at.t_req_anti), _ptr(at.t_matches),
        _ptr(gate), _ptr(tally("aff_steer", dev)), _ptr(out), _stream())
    _check(rc, "aff_steer")
    count_launch("aff_steer")
    return out
