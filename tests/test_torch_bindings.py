"""The kernels' ctypes bindings, checked without a card.

The CUDA sources build only on the card's machine, and ctypes checks a
call only against the argument types the loader declares.  So:

1. every ``extern "C"`` entry of ``volcano_tpu_torch/csrc/*.cu`` has a
   declaration in ``ops/kernels._SIGS`` with the same parameter types, in
   order (pointers ``c_void_p``, ``int`` ``c_int``, ``int64_t``
   ``c_int64``, ``float`` ``c_float``), and nothing else is declared;
2. each wrapper, forced down its card path with a stand-in library that
   checks every call against those declarations, passes one argument of
   the declared kind per parameter -- for the affinity kernels and for
   the solve kernels with their port and count arguments;
3. the solver service's host frame codec (``csrc/host/vcsnap.cc``): its
   six entry points are declared in ``native.CODEC_SIGS`` with the C
   return and parameter types.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from test_torch_fixtures import shortlist_case, shortlist_tensors

from volcano_tpu_torch.ops import affkernels, kernels

CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
KINDS = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_int64: "l",
         ctypes.c_float: "f"}


def _prototypes():
    out = {}
    for f in sorted(CSRC.glob("*.cu")):
        text = f.read_text()
        for m in re.finditer(r'extern "C" int (vtt_\w+)\((.*?)\)\s*\{', text,
                             re.S):
            kinds = []
            for p in (x.strip() for x in m.group(2).split(",")):
                if "*" in p:
                    kinds.append("p")
                elif p.startswith("int64_t"):
                    kinds.append("l")
                elif p.startswith("int"):
                    kinds.append("i")
                elif p.startswith("float"):
                    kinds.append("f")
                else:
                    raise AssertionError(f"{f.name}: parameter {p!r}")
            out[m.group(1)] = kinds
    return out


def test_declarations_match_the_c_prototypes():
    protos = _prototypes()
    assert set(protos) == set(kernels._SIGS)
    for name, kinds in protos.items():
        assert [KINDS[t] for t in kernels._SIGS[name]] == kinds, name


class _Lib:
    """Stands in for the built library: checks each call's arguments
    against the declaration and records the entry."""

    def __init__(self):
        self.calls = []
        self.args = []

    def __getattr__(self, name):
        decl = kernels._SIGS[name]

        def call(*args):
            assert len(args) == len(decl), (name, len(args), len(decl))
            for i, (a, t) in enumerate(zip(args, decl)):
                if t is ctypes.c_void_p:
                    assert a is None or isinstance(a, ctypes.c_void_p), \
                        (name, i, a)
                elif t is ctypes.c_float:
                    assert isinstance(a, float), (name, i, a)
                else:
                    assert isinstance(a, int) and not isinstance(a, bool), \
                        (name, i, a)
            self.calls.append(name)
            self.args.append(args)
            return 1024 if name == "vtt_block_shortlist_smem" else 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    lib = _Lib()
    for mod in (kernels, affkernels):
        monkeypatch.setattr(mod, "load", lambda: lib)
        monkeypatch.setattr(mod, "_on_card", lambda plain, *t: True)
        monkeypatch.setattr(mod, "_stream", lambda: ctypes.c_void_p(0))
    return lib


I32, F32, B8 = torch.int32, torch.float32, torch.bool


def _z(*shape, dtype=I32):
    return torch.zeros(shape, dtype=dtype)


def _terms(U, E, D, N, K):
    return affkernels.AffTerms(_z(N, K), _z(E), _z(E, D), _z(E, D),
                               _z(U, E, dtype=B8), _z(U, E, dtype=B8),
                               _z(U, E, dtype=B8), _z(U, E, dtype=F32))


def test_affinity_wrappers_match_their_entries(fake_card):
    U, E, D, N, K, W = 8, 5, 6, 32, 2, 16
    at = _terms(U, E, D, N, K)
    affkernels.scatter_cnt0(_z(4), _z(4), _z(4), E, D)
    affkernels.scatter_profile_tables(_z(4), _z(4), _z(4, dtype=torch.int8),
                                      _z(4, dtype=F32), U, E)
    rows = torch.arange(U, dtype=I32)
    for cand in (None, _z(10), _z(U, 7)):
        affkernels.aff_live(rows, cand, _z(1, E), at)
    affkernels.aff_live(rows, None, _z(U, 3), at)
    affkernels.aff_filter(_z(W), _z(W, dtype=B8), _z(W), at,
                          _z(W, dtype=B8), _z(W, dtype=B8), gm=_z(E, D),
                          term_req=_z(E, dtype=B8), prof_req=_z(U, dtype=B8))
    assert fake_card.calls == (["vtt_scatter_cnt0",
                                "vtt_scatter_profile_tables"]
                               + ["vtt_aff_live"] * 4 + ["vtt_aff_filter"])


def test_topology_and_table_wrappers_match_their_entries(fake_card):
    """gang_block_fit passes its cluster size (0: chosen by N), a [B, U]
    cfit and the [B] frag plane its launch writes; scatter_profile_tables
    passes four planes that start at multiples of 16 bytes (the kernel's
    fill stores 16 bytes at a time)."""
    N, U, R, B = 40, 3, 2, 8
    args = (_z(N, R, dtype=F32), _z(N, dtype=B8), _z(N), _z(N), _z(N),
            _z(U, R, dtype=F32), _z(U), _z(R, dtype=F32), B)
    for cluster in (0, 1, 8, 16):
        cfit, whole, score, frag = kernels.gang_block_fit(
            *args, cluster=cluster)
        assert cfit.shape == (B, U) and whole.shape == score.shape == (B,)
        assert frag.shape == (B,) and frag.dtype == F32
        assert fake_card.args[-1][12] == cluster
        assert fake_card.args[-1][16].value == frag.data_ptr()
    with pytest.raises(ValueError):
        kernels.gang_block_fit(*args, cluster=17)
    kernels.fabric_frag(cfit, whole, _z(U))
    for u, e in ((1, 1), (7, 5), (33, 17)):
        out = affkernels.scatter_profile_tables(
            _z(16), _z(16), _z(16, dtype=torch.int8), _z(16, dtype=F32),
            u, e)
        assert all(t.shape == (u, e) for t in out)
        assert all(t.data_ptr() % 16 == 0 for t in out)
        ptrs = [a.value for a in fake_card.args[-1][7:11]]
        assert ptrs == [t.data_ptr() for t in out]
    assert fake_card.calls == (["vtt_gang_block_fit"] * 4
                               + ["vtt_fabric_frag"]
                               + ["vtt_scatter_profile_tables"] * 3)


def test_frag_scores_wrapper_reads_staged_views_writes_one_buffer(
        fake_card):
    """frag_scores on ``stage_frag``'s views passes the six views' pointers
    (16-byte offsets into one staged buffer) and, as its three outputs,
    the rows of one [3, N] int32 buffer."""
    import numpy as np

    N, U, R = 37, 5, 3
    rng = np.random.RandomState(0)
    staged = kernels.stage_frag(
        rng.rand(N, R), rng.rand(N, R), rng.rand(N) < 0.5, rng.rand(N, R),
        rng.rand(U, R), rng.rand(R), "cpu")
    frag, now, freed = kernels.frag_scores(*staged)
    args = fake_card.args[-1]
    assert fake_card.calls == ["vtt_frag_scores"]
    base = staged[0].data_ptr()
    assert [a.value for a in args[:6]] == [v.data_ptr() for v in staged]
    assert all((a.value - base) % 16 == 0 for a in args[:6])
    assert args[6:9] == (N, U, R)
    assert frag.dtype == F32 and now.dtype == freed.dtype == I32
    ptrs = [a.value for a in args[9:12]]
    assert ptrs == [frag.data_ptr(), now.data_ptr(), freed.data_ptr()]
    assert ptrs[1] - ptrs[0] == ptrs[2] - ptrs[1] == 4 * N


def test_solve_wrappers_with_ports_and_counts_match(fake_card):
    U, N, R, PW, UM, W, S = 8, 32, 3, 2, 4, 16, 8
    prof, cls, nodes, weights, eps, slot = shortlist_tensors(
        shortlist_case(0, U=U, N=N), "cpu")
    args = (nodes["idle"], nodes["alloc"], nodes["ntasks"],
            nodes["max_tasks"], eps, slot, weights)
    C = cls.ready.shape[0]
    stat = (_z(U, C, dtype=B8), _z(U, C, dtype=F32))
    ports = kernels.Ports(_z(U, PW), _z(N, PW))
    aff = (_z(U, N, dtype=B8), _z(U, N, dtype=F32))
    kernels.coarse_shortlist(prof, cls, *args, 4, True, ports=ports,
                             aff=aff)
    kernels.coarse_shortlist(prof, cls, *args, 4, True, stat=stat,
                             n_blocks=4, ports=ports, aff=aff)
    kernels.warm_shortlist(prof, cls.class_id, *stat, *args,
                           torch.tensor([1], dtype=I32),
                           _z(U, 4, 4, dtype=F32), _z(U, 4, 4), 4,
                           ports=ports, aff=(_z(U, 8, dtype=B8),
                                             _z(U, 8, dtype=F32)))
    p_req, p_init = prof.req[:UM].contiguous(), prof.init_req[:UM].contiguous()
    pw = kernels.Ports(_z(UM, PW), _z(N, PW), _z(N, PW))
    kernels.rank_candidates(
        torch.arange(UM, dtype=I32), _z(UM, S), stat[0][:UM].contiguous(),
        stat[1][:UM].contiguous(), cls.class_id, p_req, p_init, *args[:6],
        weights, 4, ports=pw, aff=(_z(UM, S, dtype=B8),
                                   _z(UM, S, dtype=F32)))
    fut = kernels.Future(_z(N, R, dtype=F32), _z(N, R, dtype=F32),
                         _z(N, R, dtype=F32), _z(N))
    kernels.walk_accept(_z(UM, 4), _z(UM, 4, dtype=B8), p_req, p_init,
                        _z(W), _z(W, dtype=B8), _z(W, dtype=B8),
                        _z(UM, UM, dtype=B8), nodes["idle"],
                        nodes["ntasks"], nodes["max_tasks"], eps, slot,
                        future=fut, ports=pw, self_anti=_z(UM, dtype=B8),
                        live_out=_z(W, dtype=B8))
    f64 = torch.float64
    counts = _terms(UM, 5, 6, N, 2)
    kernels.apply_commit(
        _z(W), _z(W, dtype=B8), p_req, _z(W), _z(W), nodes["idle"],
        _z(2, R, dtype=F32), mode=0, idle_sign=-1.0,
        scratch=kernels.commit_scratch(N, R, 2, "cpu"), jw=_z(W),
        ntasks=nodes["ntasks"], alloc_l=_z(W), assigned=_z(W),
        pipe=_z(W, dtype=B8),
        pip={"pip_extra": _z(N, R, dtype=F32), "pip_ntasks": _z(N),
             "q_pip": _z(2, R, dtype=F32), "pipelined": _z(W),
             "scratch": (_z(N, R, dtype=f64), _z(2, R, dtype=f64))},
        ports=pw, counts=counts,
        match_terms=kernels.window_match_terms(counts.t_matches))
    assert fake_card.calls == [
        "vtt_coarse_shortlist", "vtt_block_shortlist_smem",
        "vtt_block_shortlist", "vtt_block_shortlist_smem",
        "vtt_block_shortlist", "vtt_rank_candidates", "vtt_walk_accept",
        "vtt_apply_commit"]


def test_apply_commit_counts_need_match_terms(fake_card):
    """On the card, apply_commit with window counts takes the per-wave
    term lists (``window_match_terms``) from its caller and raises
    without them, before any launch."""
    N, R, UM, W = 32, 3, 4, 16
    counts = _terms(UM, 5, 6, N, 2)
    f64 = torch.float64
    with pytest.raises(ValueError, match="match_terms"):
        kernels.apply_commit(
            _z(W), _z(W, dtype=B8), _z(UM, R, dtype=F32), _z(W), _z(W),
            _z(N, R, dtype=F32), _z(2, R, dtype=F32), mode=0,
            idle_sign=-1.0, scratch=(_z(N, R, dtype=f64),
                                     _z(2, R, dtype=f64)),
            jw=_z(W), ntasks=_z(N), alloc_l=_z(W), assigned=_z(W),
            counts=counts)
    assert fake_card.calls == []


def test_seq_solve_and_extra_planes_match_their_entries(fake_card):
    """seq_solve's 87 arguments, and the custom-plugin planes of
    coarse_shortlist and rank_candidates."""
    from test_torch_fixtures import seq_extra, seq_store

    from volcano_tpu_torch.ops.allocate import seq_inputs
    from volcano_tpu_torch.synth import solve_args_from_store

    import volcano_tpu_torch

    args, _ = solve_args_from_store(
        seq_store(volcano_tpu_torch, "affinity", 1), device="cpu")
    ok, score = seq_extra(args, 0)
    for kw in ({}, {"extra_ok": ok, "extra_score": score}):
        x = seq_inputs(*args, kw.get("extra_ok"), kw.get("extra_score"),
                       torch.device("cpu"))
        kernels.seq_solve(x, args[4])
    U, N, UM, S = 8, 32, 4, 8
    prof, cls, nodes, weights, eps, slot = shortlist_tensors(
        shortlist_case(0, U=U, N=N), "cpu")
    a = (nodes["idle"], nodes["alloc"], nodes["ntasks"], nodes["max_tasks"],
         eps, slot, weights)
    ex = kernels.Extra(_z(U, N, dtype=B8), _z(U, N, dtype=F32))
    kernels.coarse_shortlist(prof, cls, *a, 4, True, extra=ex)
    C = cls.ready.shape[0]
    kernels.rank_candidates(
        torch.arange(UM, dtype=I32), _z(UM, S), _z(UM, C, dtype=B8),
        _z(UM, C, dtype=F32), cls.class_id, prof.req[:UM].contiguous(),
        prof.init_req[:UM].contiguous(), *a[:6], weights, 4,
        extra=kernels.Extra(None, ex.score), pids=_z(UM))
    assert fake_card.calls == ["vtt_seq_solve"] * 2 + [
        "vtt_coarse_shortlist", "vtt_rank_candidates"]


@pytest.mark.parametrize("K,W,cumcap,sort", [(4, 16, False, False),
                                             (12289, 16, True, False),
                                             (4, 20000, False, True)])
def test_walk_accept_scratch_past_shared_memory(fake_card, K, W, cumcap,
                                                sort):
    """walk_accept keeps its running capacities and sort keys in shared
    memory and passes null scratches; past csrc/walk_accept.cu's limits
    (a [UM, K] f32 row over 48 KB, 9 bytes per key of the power of two >=
    W over 200 KB) it passes global ones of those sizes."""
    UM, N, R = 4, 32, 3
    prof, cls, nodes, weights, eps, slot = shortlist_tensors(
        shortlist_case(0, U=UM, N=N), "cpu")
    kernels.walk_accept(_z(UM, K), _z(UM, K, dtype=B8),
                        prof.req[:UM].contiguous(),
                        prof.init_req[:UM].contiguous(), _z(W),
                        _z(W, dtype=B8), _z(W, dtype=B8),
                        _z(UM, UM, dtype=B8), nodes["idle"],
                        nodes["ntasks"], nodes["max_tasks"], eps, slot)
    assert fake_card.calls == ["vtt_walk_accept"]
    args = fake_card.args[0]
    # (..., scalar_slot, cumcap, sort_scratch, live, ...)
    assert (args[22] is not None) == cumcap
    assert (args[23] is not None) == sort
    assert args[24] is not None and args[25] is not None


@pytest.mark.parametrize("N,B,S,scratch", [(1024, 0, 100, False),
                                            (57344, 0, 100, False),
                                            (57345, 0, 100, True),
                                            (16384, 16, 819, False),
                                            (65536, 16, 4096, True)])
def test_shortlist_scratch_past_shared_memory(fake_card, N, B, S, scratch):
    """coarse_shortlist keeps a row's 4-byte ordered scores in shared
    memory up to kernels.COARSE_SMEM (57,344 nodes) and passes a null
    scratch; past it an int32 [U, N] one.  The block form's merge keeps
    its B * klb scores beside the S winners' keys up to
    kernels.BLOCK_MERGE_SMEM, else it passes an int32 [U, B * klb]
    scratch."""
    U = 4
    prof, cls, nodes, weights, eps, slot = shortlist_tensors(
        shortlist_case(0, U=U, N=N), "cpu")
    C = cls.ready.shape[0]
    stat = (_z(U, C, dtype=B8), _z(U, C, dtype=F32)) if B else None
    kernels.coarse_shortlist(prof, cls, nodes["idle"], nodes["alloc"],
                             nodes["ntasks"], nodes["max_tasks"], eps, slot,
                             weights, S, True, stat=stat, n_blocks=B)
    entry = "vtt_block_shortlist" if B else "vtt_coarse_shortlist"
    assert fake_card.calls[-1] == entry
    args = fake_card.args[-1]
    # (..., keys_scratch, out, ports, ...): the block form's scratch is its
    # ninth argument from the end, the full row's its tenth.
    keys = args[-9] if B else args[-10]
    assert (keys is not None) == scratch
    assert args[-8 if B else -9] is not None


@pytest.mark.parametrize("L,tiles", [(2048, 0), (2049, 3), (10016, 10)])
def test_rank_candidates_scratch_past_the_sort_limit(fake_card, L, tiles):
    """Up to csrc/rank_candidates.cu's one-block sort (2,048 candidates)
    the three scratches are null; past it the wrapper passes the tiles'
    top keys [M, T, min(K, 1,024)], the feasibility [M, L] and the tiles'
    flags [M, T]."""
    U, N, UM, K = 8, 10016, 4, 256
    prof, cls, nodes, weights, eps, slot = shortlist_tensors(
        shortlist_case(0, U=U, N=N), "cpu")
    C = cls.ready.shape[0]
    cand = None if L == N else _z(UM, L)
    kernels.rank_candidates(
        torch.arange(UM, dtype=I32), cand, _z(UM, C, dtype=B8),
        _z(UM, C, dtype=F32), cls.class_id, prof.req[:UM].contiguous(),
        prof.init_req[:UM].contiguous(), nodes["idle"], nodes["alloc"],
        nodes["ntasks"], nodes["max_tasks"], eps, slot, weights, K)
    assert fake_card.calls == ["vtt_rank_candidates"]
    args = fake_card.args[0]
    # (..., K, tile_keys, feas_scratch, any_scratch, out_ranked, ...)
    assert args[27] == K
    scratch = args[28:31]
    assert all((a is None) == (tiles == 0) for a in scratch)
    assert args[31] is not None


def test_aff_live_passes_the_gate_and_the_tally(fake_card):
    """aff_live hands the kernel the gate byte, the computing tally and
    the caller's buffers (without a gate: null, the tally, fresh planes);
    buffers of another shape raise before any launch."""
    U, E, D, N, K = 8, 5, 9000, 32, 2
    at = _terms(U, E, D, N, K)
    rows = torch.arange(U, dtype=I32)
    gate = _z(1, dtype=B8)
    buf = (_z(U, 7, dtype=B8), _z(U, 7, dtype=F32))
    got = affkernels.aff_live(rows, _z(U, 7), _z(1, E), at, gate=gate,
                              out=buf)
    assert got[0] is buf[0] and got[1] is buf[1]
    affkernels.aff_live(rows, None, _z(1, E), at)
    g, fresh = fake_card.args
    # (..., t_soft, part, gate, computed, out_ok, out_soft, stream)
    assert g[20].value == gate.data_ptr() and fresh[20] is None
    tally = kernels.tally("aff_live", torch.device("cpu")).data_ptr()
    assert g[21].value == tally and fresh[21].value == tally
    assert g[22].value == buf[0].data_ptr()
    assert g[23].value == buf[1].data_ptr()
    with pytest.raises(ValueError):
        affkernels.aff_live(rows, _z(U, 7), _z(1, E), at, gate=gate,
                            out=(_z(U, 6, dtype=B8), _z(U, 6, dtype=F32)))
    assert len(fake_card.calls) == 2


def test_aff_steer_passes_the_gate_the_tally_and_the_plane(fake_card):
    """aff_steer hands the kernel the ranked ids, the attempt's plane, the
    window, the gate byte, the computing tally and the caller's working
    plane (without a gate: null, the tally, a fresh plane), and no scratch;
    a plane of another shape or a gate without one raises before any
    launch."""
    U, E, D, N, K, KR = 8, 5, 9000, 32, 2, 16
    at = _terms(U, E, D, N, K)
    ranked, feas = _z(U, KR), _z(U, KR, dtype=B8)
    gate = _z(1, dtype=B8)
    out = _z(U, KR, dtype=B8)
    assert affkernels.aff_steer(ranked, feas, at, gate=gate,
                                out=out) is out
    fresh_out = affkernels.aff_steer(ranked, feas, at)
    assert fresh_out.shape == (U, KR) and fresh_out.dtype == B8
    g, fresh = fake_card.args
    # (ranked, feas_att, UM, K, node_dom, NK, term_key, cnt_a, cnt_p, E, D,
    #  t_aff, t_anti, t_match, gate, computed, feas_k, stream)
    assert g[0].value == ranked.data_ptr() and g[1].value == feas.data_ptr()
    assert (g[2], g[3], g[5], g[9], g[10]) == (U, KR, K, E, D)
    assert g[14].value == gate.data_ptr() and fresh[14] is None
    tally = kernels.tally("aff_steer", torch.device("cpu")).data_ptr()
    assert g[15].value == tally and fresh[15].value == tally
    assert g[16].value == out.data_ptr()
    assert fresh[16].value == fresh_out.data_ptr()
    with pytest.raises(ValueError):
        affkernels.aff_steer(ranked, feas, at, gate=gate,
                             out=_z(U, KR - 1, dtype=B8))
    with pytest.raises(ValueError):
        affkernels.aff_steer(ranked, feas, at, gate=gate)
    assert fake_card.calls == ["vtt_aff_steer"] * 2


def test_aff_filter_needs_the_wave_planes(fake_card):
    """On the card the filter takes term_req [E] and prof_req [UM] from
    its caller; without them (or at other shapes) it raises and launches
    nothing."""
    U, E, D, N, K, W = 8, 5, 6, 32, 2, 16
    at = _terms(U, E, D, N, K)
    for planes in ({}, {"term_req": _z(E, dtype=B8)},
                   {"term_req": _z(E + 1, dtype=B8),
                    "prof_req": _z(U, dtype=B8)},
                   {"term_req": _z(E), "prof_req": _z(U, dtype=B8)}):
        with pytest.raises((ValueError, TypeError)):
            affkernels.aff_filter(_z(W), _z(W, dtype=B8), _z(W), at,
                                  _z(W, dtype=B8), gm=_z(E, D), **planes)
    assert fake_card.calls == []


def test_in_launch_static_planes_and_scatter_planes_match(fake_card,
                                                          monkeypatch):
    """The row-form shortlist launch without planes passes the profile
    bitsets and the class tables with ``static_ext`` 0 and returns the
    planes it writes (counted in ``FUSED``); with the planes given it
    passes nulls and zero widths.  ``scatter_planes`` passes the staged
    buffer and a host array of (address, row bytes, offset) per plane,
    offsets at multiples of 16."""
    U, N, S = 8, 32, 4
    prof, cls, nodes, weights, eps, slot = shortlist_tensors(
        shortlist_case(0, U=U, N=N), "cpu")
    args = (nodes["idle"], nodes["alloc"], nodes["ntasks"],
            nodes["max_tasks"], eps, slot, weights, S, True)
    C = cls.ready.shape[0]
    stat = (_z(U, C, dtype=B8), _z(U, C, dtype=F32))
    kernels.reset_launches()
    out = kernels.coarse_shortlist(prof, cls, *args)
    row = fake_card.args[-1]
    assert row[36] == 0 and row[4] is not None and row[5] == 2
    assert row[15] is not None and row[17] is not None
    assert [row[37].value, row[38].value] == [t.data_ptr() for t in out[1:]]
    kernels.coarse_shortlist(prof, cls, *args, stat=stat)
    row = fake_card.args[-1]
    assert row[36] == 1 and row[4] is None and row[5] == 0
    assert row[15] is None and row[37].value == stat[0].data_ptr()
    assert kernels.FUSED["static_planes"] == 1
    assert kernels.LAUNCHES["coarse_shortlist"] == 2
    bufs = [_z(N, 3, dtype=F32), _z(N), _z(N, dtype=B8), _z(N, 2)]
    rows = torch.tensor([3, 7, 30], dtype=I32).numpy()
    vals = [b[:3].numpy() for b in bufs]
    staged = kernels.stage_delta(rows, vals, "cpu")
    seen = []

    class Peek:
        """Reads the host descriptor array while the call holds it."""

        def __getattr__(self, name):
            fn = getattr(fake_card, name)

            def call(*a):
                if name == "vtt_scatter_planes":
                    seen.append(list((ctypes.c_int64 * (3 * a[2]))
                                     .from_address(a[3].value)))
                return fn(*a)
            return call

    monkeypatch.setattr(kernels, "load", lambda: Peek())
    kernels.scatter_planes(bufs, staged, 3)
    sp = fake_card.args[-1]
    assert sp[0].value == staged.data_ptr() and sp[1:3] == (3, 4)
    offs, _ = kernels.delta_layout(3, [12, 4, 1, 8])
    assert seen == [[x for b, rb, o in zip(bufs, (12, 4, 1, 8), offs)
                     for x in (b.data_ptr(), rb, o)]]
    assert kernels.LAUNCHES["scatter_rows"] == 1
    with pytest.raises(ValueError):
        kernels.scatter_planes(bufs * 3, staged, 3)
    assert fake_card.calls == ["vtt_coarse_shortlist"] * 2 + [
        "vtt_scatter_planes"]


# ------------------------------------------------ the host frame codec


def _codec_prototypes():
    """C name -> (return type, [parameter types]) of every entry point
    defined in the frame codec's ``extern "C"`` block."""
    from volcano_tpu_torch import native

    text = native.CODEC_SOURCE.read_text()
    block = text[text.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^(\w+)\s+(vcsnap_\w+)\((.*?)\)\s*\{", block,
                         re.S | re.M):
        params = [" ".join(p.split()) for p in m.group(3).split(",")
                  if p.strip()]
        out[m.group(2)] = (m.group(1), params)
    return out


def _codec_ctype(decl):
    decl = decl.replace("const ", "").strip()
    if "*" in decl:
        return ctypes.c_void_p
    base = decl.split()[0]
    return {"int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32,
            "void": None}[base]


def test_codec_declarations_match_the_c_prototypes():
    """The six entry points of ``csrc/host/vcsnap.cc`` -- the frame size,
    pack, info and unpack, the delta check and apply -- are declared in
    ``native.CODEC_SIGS`` with the C return and parameter types, in order,
    and nothing else is declared; the library built here exports them."""
    from volcano_tpu_torch import native

    protos = _codec_prototypes()
    assert set(protos) == {
        "vcsnap_frame_bytes", "vcsnap_frame_pack", "vcsnap_frame_info",
        "vcsnap_frame_unpack", "vcsnap_delta_check", "vcsnap_delta_apply"}
    assert set(protos) == set(native.CODEC_SIGS)
    for name, (restype, argtypes) in native.CODEC_SIGS.items():
        ret, params = protos[name]
        assert _codec_ctype(ret) is restype, name
        assert [_codec_ctype(p) for p in params] == list(argtypes), name
    lib = native.load_codec()
    for name in protos:
        fn = getattr(lib, name)
        assert fn.restype is native.CODEC_SIGS[name][0]
