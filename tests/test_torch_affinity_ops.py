"""The port's inter-pod affinity kernels (plain versions) against the JAX
package on the CPU.

- ``scatter_cnt0`` / ``scatter_profile_tables`` against the JAX jits
  ``_scatter_cnt0`` / ``_scatter_profile_tables`` on the same sparse
  entries, padded entries (0 at (0, 0)) included: bit-equal.
- ``aff_live`` against the JAX package's count-window formulas
  (``_coarse_shortlist``'s phase-1 planes, wave.py:615-660, and the
  attempt planes of ``live_parts_sl``, :1337-1389) written here in
  jax.numpy as the JAX code writes them -- the bf16 indicator products
  and the f32 soft product, with the dense domain one-hot and with the
  gather -- on the same random tables: verdicts equal, soft scores equal
  exactly (integer weights 5 and 10 of both signs, integer counts: every
  partial sum is an integer below 2^24).
- ``aff_filter`` against the JAX sub-round filter (``_aff_filter``'s full
  form, wave.py:1749-2000, in jax.numpy), with more than GCAP = 256 live
  givers: the accepted set equal.
- ``_profile_term_lists`` lists exactly the nonzero columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.ops import wave as jw

from volcano_tpu_torch.ops import affkernels
from volcano_tpu_torch.ops import wave as tw
from volcano_tpu_torch.ops.affkernels import AffTerms


def _entries(seed, k, e, d, real):
    rng = np.random.RandomState(seed)
    cells = rng.choice(e * d, real, replace=False)
    pad = k - real
    rows = np.concatenate([cells // d, np.zeros(pad, np.int64)])
    cols = np.concatenate([cells % d, np.zeros(pad, np.int64)])
    return rng, rows.astype(np.int32), cols.astype(np.int32)


@pytest.mark.parametrize("k,e,d,real", [(16, 5, 7, 9), (256, 33, 120, 200),
                                        (1024, 129, 300, 1000)])
def test_scatter_cnt0_matches_jax(k, e, d, real):
    rng, rows, cols = _entries(k, k, e, d, real)
    vals = np.concatenate([rng.randint(1, 40, real),
                           np.zeros(k - real, np.int64)]).astype(np.int32)
    want = np.asarray(jw._scatter_cnt0(rows, cols, vals, e, d))
    got = affkernels.scatter_cnt0(torch.from_numpy(rows),
                                  torch.from_numpy(cols),
                                  torch.from_numpy(vals), e, d).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("k,u,e,real", [(16, 6, 5, 11), (512, 64, 40, 400),
                                        (2048, 200, 97, 2000)])
def test_scatter_profile_tables_match_jax(k, u, e, real):
    rng, rows, cols = _entries(k + 1, k, u, e, real)
    flags = np.concatenate([rng.randint(0, 8, real),
                            np.zeros(k - real, np.int64)]).astype(np.int8)
    soft = np.concatenate([
        rng.choice([0.0, 5.0, -5.0, 10.0, -10.0], real),
        np.zeros(k - real)]).astype(np.float32)
    want = [np.asarray(x) for x in jw._scatter_profile_tables(
        rows, cols, flags, soft, u, e)]
    got = affkernels.scatter_profile_tables(
        torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(flags), torch.from_numpy(soft), u, e)
    for a, b, what in zip(want, got, ("aff", "anti", "match", "soft")):
        b = b.numpy()
        assert a.dtype == b.dtype, what
        assert np.array_equal(a.view(np.uint8) if a.dtype == bool else a,
                              b.view(np.uint8) if b.dtype == bool else b), \
            what


@pytest.mark.parametrize("kind,k,u,e", [
    ("pad", 16, 6, 5), ("pad", 16, 1, 1), ("origin", 16, 1, 1),
    ("origin", 32, 7, 5), ("negzero", 64, 9, 13), ("full", 16, 3, 5),
    ("full", 64, 1, 33)])
def test_scatter_profile_tables_edges_match_jax(kind, k, u, e):
    """The entries the card kernel treats specially (it writes nothing for
    an entry without flag bits and with a soft value of +-0.0, and stores
    a flag bit where JAX sums counts): padding only, a real entry at
    (0, 0) beside the padded ones, real soft values of -0.0 (JAX gives
    +0.0), every cell real; cells counts that are not a multiple of 16,
    and a single cell.  Bit-equal to the JAX jit, +0.0 and -0.0 told
    apart."""
    from test_torch_fixtures import profile_entry_case

    rows, cols, flags, soft = profile_entry_case(kind, k, u, e, seed=k + u)
    want = [np.asarray(x) for x in jw._scatter_profile_tables(
        rows, cols, flags, soft, u, e)]
    got = affkernels.scatter_profile_tables(
        torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(flags), torch.from_numpy(soft), u, e)
    for a, b, what in zip(want, got, ("aff", "anti", "match", "soft")):
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    assert not (np.signbit(want[3]) & (want[3] == 0)).any()
    if kind == "origin":
        assert want[0][0, 0] and want[3][0, 0] == -5.0


def _tables(seed, U=20, E=14, D=30, N=90, K=3):
    rng = np.random.RandomState(seed)
    nd = rng.randint(-1, D, (N, K)).astype(np.int32)
    tk = rng.randint(0, K, E).astype(np.int32)
    cnt = np.where(rng.rand(E, D) < 0.25, rng.randint(1, 5, (E, D)),
                   0).astype(np.int32)
    cnt[rng.rand(E) < 0.3] = 0
    soft = (rng.choice([5.0, -5.0, 10.0, -10.0], (U, E))
            * (rng.rand(U, E) < 0.3)).astype(np.float32)
    return dict(node_dom=nd, term_key=tk, cnt=cnt,
                t_req_aff=rng.rand(U, E) < 0.15,
                t_req_anti=rng.rand(U, E) < 0.15,
                t_matches=rng.rand(U, E) < 0.3, t_soft=soft)


def _at(t, cnt=None, cnt_p=None):
    f = torch.from_numpy
    return AffTerms(f(t["node_dom"]), f(t["term_key"]),
                    f(t["cnt"] if cnt is None else cnt),
                    None if cnt_p is None else f(cnt_p),
                    f(t["t_req_aff"]), f(t["t_req_anti"]),
                    f(t["t_matches"]), f(t["t_soft"]))


def _jax_planes(t, cnt, dom_mm):
    """The JAX package's count-window planes over all nodes
    (wave.py:1230-1264), with the dense domain one-hot (``dom_mm``) or
    the gather: (ok [U, N], soft [U, N])."""
    nd = jnp.asarray(t["node_dom"])
    N, K = nd.shape
    E, D = cnt.shape
    cnt = jnp.asarray(cnt)
    f32, bf = jnp.float32, jnp.bfloat16
    node_dom_t = jnp.take(nd, jnp.asarray(t["term_key"]), axis=1)
    if dom_mm:
        dom_ohT = jnp.zeros((N, D), f32)
        for k in range(K):
            nd_k = nd[:, k]
            dom_ohT = dom_ohT.at[
                jnp.arange(N), jnp.where(nd_k >= 0, nd_k, D)
            ].max(jnp.where(nd_k >= 0, 1.0, 0.0), mode="drop")
        cv = jax.lax.dot_general(cnt.astype(f32), dom_ohT,
                                 (((1,), (1,)), ((), ()))).T
    else:
        cv = cnt[jnp.arange(E)[None, :], jnp.maximum(node_dom_t, 0)]
        cv = jnp.where(node_dom_t >= 0, cv, 0)
    total = jnp.sum(cnt, axis=-1)
    selfok = (total == 0)[None, :] & t["t_matches"]
    need = (t["t_req_aff"] & ~selfok).astype(bf)
    aff_viol = jnp.matmul(need, (cv == 0).astype(bf).T)
    anti_viol = jnp.matmul(jnp.asarray(t["t_req_anti"]).astype(bf),
                           (cv > 0).astype(bf).T)
    soft = jnp.matmul(jnp.asarray(t["t_soft"]), cv.T.astype(f32))
    return (np.asarray((aff_viol < 0.5) & (anti_viol < 0.5)),
            np.asarray(soft))


@pytest.mark.parametrize("dom_mm", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aff_live_matches_jax_planes(seed, dom_mm):
    """All nodes, every row, all terms -- and each row's own term list,
    which phase 1 passes -- against the JAX planes.  Where the domain
    one-hot is used, a node belongs to several keys' domains; counts are
    zero outside a term's own key's domains only when the domain ids of
    different keys do not collide, so that form is checked on tables
    whose keys own disjoint domain ranges (as the mirror interns them)."""
    t = _tables(seed)
    if dom_mm:
        # Disjoint domain ranges per key, as the mirror interns them.
        D = t["cnt"].shape[1]
        K = t["node_dom"].shape[1]
        span = D // K
        nd = t["node_dom"]
        t["node_dom"] = np.where(nd >= 0, nd % span + span * np.arange(
            K)[None, :], -1).astype(np.int32)
        own = (np.arange(D)[None, :] // span) == t["term_key"][:, None]
        t["cnt"] = np.where(own, t["cnt"], 0).astype(np.int32)
    with jax.default_matmul_precision("float32"):
        ok_j, soft_j = _jax_planes(t, t["cnt"], dom_mm)
    U, E = t["t_req_aff"].shape
    rows = torch.arange(U, dtype=torch.int32)
    terms = torch.arange(E, dtype=torch.int32)[None]
    ok, soft = affkernels.aff_live(rows, None, terms, _at(t))
    assert np.array_equal(ok.numpy(), ok_j)
    assert np.array_equal(soft.numpy(), soft_j)
    iom = (t["t_req_aff"] | t["t_req_anti"] | t["t_matches"]
           | (t["t_soft"] != 0))
    lists = torch.from_numpy(tw._profile_term_lists(iom))
    ok2, soft2 = affkernels.aff_live(rows, None, lists, _at(t))
    assert torch.equal(ok2, ok) and torch.equal(soft2, soft)


def test_aff_live_candidate_modes_and_pipelined_counts():
    """Shared and per-row candidate lists read the all-node planes at
    their nodes; the pipelined table adds to the allocated one."""
    t = _tables(7)
    rng = np.random.RandomState(7)
    cnt_p = np.where(rng.rand(*t["cnt"].shape) < 0.1, 1, 0).astype(np.int32)
    at = _at(t, cnt_p=cnt_p)
    U, E = t["t_req_aff"].shape
    N = t["node_dom"].shape[0]
    rows = torch.from_numpy(rng.permutation(U)[:U - 4].astype(np.int32))
    terms = torch.arange(E, dtype=torch.int32)[None]
    ok, soft = affkernels.aff_live(rows, None, terms, at)
    summed = affkernels.aff_live(rows, None, terms,
                                 _at(t, cnt=t["cnt"] + cnt_p))
    assert torch.equal(ok, summed[0]) and torch.equal(soft, summed[1])
    shared = torch.from_numpy(rng.randint(0, N, 31).astype(np.int32))
    ok_s, soft_s = affkernels.aff_live(rows, shared, terms, at)
    assert torch.equal(ok_s, ok[:, shared.long()])
    assert torch.equal(soft_s, soft[:, shared.long()])
    per = torch.from_numpy(rng.randint(0, N, (U, 12)).astype(np.int32))
    ok_p, soft_p = affkernels.aff_live(rows, per, terms, at)
    idx = per[rows.long()].long()
    assert torch.equal(ok_p, torch.gather(ok, 1, idx))
    assert torch.equal(soft_p, torch.gather(soft, 1, idx))


def _jax_filter(choice, live, pid_l, clean, t, cnt):
    """wave.py's ``_aff_filter`` (full form, 2-D keys) in jax.numpy."""
    W = choice.shape[0]
    EW, D = cnt.shape
    nd = jnp.asarray(t["node_dom"])
    node_dom_t = jnp.take(nd, jnp.asarray(t["term_key"]), axis=1)
    term_arange = jnp.arange(EW)
    p_aff = jnp.asarray(t["t_req_aff"])
    p_anti = jnp.asarray(t["t_req_anti"])
    p_match = jnp.asarray(t["t_matches"])
    term_req_w = jnp.any(p_aff | p_anti, axis=0)
    pid_l = jnp.asarray(pid_l)
    t_matches_w = p_match[pid_l]
    live = jnp.asarray(live)
    choice = jnp.asarray(choice)
    dw = node_dom_t[choice]
    cnt_live = jnp.asarray(cnt)
    total_live = jnp.sum(cnt_live, axis=-1)
    cval_t = cnt_live[term_arange[None, :], jnp.maximum(dw, 0)]
    cval_t = jnp.where(dw >= 0, cval_t, 0)
    req_aff_t = p_aff[pid_l]
    selfok_t = (total_live == 0)[None, :] & t_matches_w
    aff_ok = ~jnp.any(req_aff_t & ~selfok_t & (cval_t == 0), axis=1)
    anti_ok = ~jnp.any(p_anti[pid_l] & (cval_t > 0), axis=1)
    out = jnp.asarray(clean) & aff_ok & anti_ok
    anti_inv = p_anti[pid_l] & (dw >= 0)
    gives = t_matches_w & (dw >= 0)
    uses_selfok = req_aff_t & selfok_t & (cval_t == 0)
    jidx = jnp.arange(W, dtype=jnp.int32)
    gmask = gives & live[:, None] & term_req_w[None, :]
    cols = jnp.where(gmask, jnp.maximum(dw, 0), D)
    gm = (jnp.full((EW, D + 1), W, jnp.int32)
          .at[jnp.broadcast_to(term_arange[None, :], (W, EW)), cols]
          .min(jnp.broadcast_to(jidx[:, None], (W, EW))))
    jb = jnp.broadcast_to(jidx[:, None], (W, EW))
    gt = jnp.min(jnp.where(gmask, jb, W), axis=0)
    gm_my = gm[term_arange[None, :], jnp.maximum(dw, 0)]
    c_anti = jnp.any(anti_inv & (gm_my < jidx[:, None]), axis=1)
    gm_my_self = jnp.where(dw >= 0, gm_my, W)
    c_self = jnp.any(uses_selfok & (gt[None, :] < jidx[:, None])
                     & (gm_my_self > gt[None, :]), axis=1)
    return np.asarray(out & ~(c_anti | c_self))


@pytest.mark.parametrize("W,N,seed", [(64, 90, 0), (512, 24, 1),
                                      (700, 60, 2)])
def test_aff_filter_matches_jax(W, N, seed):
    """W = 512 on 24 nodes: more than 256 live givers in one sub-round
    (the JAX GCAP overflow form)."""
    t = _tables(seed, U=12, N=N)
    rng = np.random.RandomState(100 + seed)
    U = t["t_req_aff"].shape[0]
    choice = rng.randint(0, N, W).astype(np.int32)
    live = rng.rand(W) < 0.85
    pid_l = rng.randint(0, U, W).astype(np.int32)
    clean = live & (rng.rand(W) < 0.8)
    if W == 512:
        assert int((t["t_matches"][pid_l].any(axis=1) & live).sum()) > 256
    want = _jax_filter(choice, live, pid_l, clean, t, t["cnt"])
    acc = torch.from_numpy(clean.copy())
    affkernels.aff_filter(torch.from_numpy(choice), torch.from_numpy(live),
                          torch.from_numpy(pid_l), _at(t), acc,
                          gm=torch.full(t["cnt"].shape, W,
                                        dtype=torch.int32))
    assert np.array_equal(acc.numpy(), want)
    assert (want != clean).any()


def test_profile_term_lists():
    rng = np.random.RandomState(3)
    iom = rng.rand(17, 9) < 0.2
    iom[4] = False
    lists = tw._profile_term_lists(iom)
    assert lists.dtype == np.int32 and lists.shape[0] == 17
    for u in range(17):
        row = lists[u]
        assert list(row[row >= 0]) == list(np.flatnonzero(iom[u]))
        assert (row[len(np.flatnonzero(iom[u])):] == -1).all()
