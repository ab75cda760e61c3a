"""The device-incremental lane's kernels, plain versions, against the JAX
package's jits on identical prepared inputs.

- ``static_planes`` vs ``ops/wave.py:_static_planes``;
- ``coarse_shortlist`` with ``stat`` and ``n_blocks`` vs
  ``_coarse_shortlist(with_cand=True, static_ext=True)``;
- ``coarse_shortlist``'s row form computing the static planes in its
  launch vs ``_static_planes`` and the JAX pass, and ``DeviceIncremental``
  through static misses and hits before full and warm shortlists vs the
  JAX context;
- ``warm_shortlist`` vs ``_warm_shortlist`` after a state change confined
  to the dirty blocks, and against a full re-rank of the new state;
- ``scatter_rows`` and ``scatter_planes`` vs ``ops/devsnap.py:_scatter_rows``,
  and the port's ``DeviceSnapshot`` vs the JAX one through full, delta,
  chunked-delta and over-threshold uploads, with four and with six planes
  (one re-uploaded whole).

Every output must be identical: shortlists and candidate ids exactly,
candidate scores and static scores bit for bit.  Cases: taints, selectors
and node affinity (compacted and identity classes), an all-tie cluster,
and blocks that are mostly NEG.
"""

import numpy as np
import pytest
import torch

from test_torch_fixtures import feature_store, tonp

import volcano_tpu
import volcano_tpu.ops.devincr as jdevincr
import volcano_tpu.ops.devsnap as jdevsnap
import volcano_tpu.ops.wave as jw
from volcano_tpu.ops.nodeclass import NodeClasses as JaxClasses
from volcano_tpu.synth import solve_args_from_store as jax_args
from volcano_tpu.synth import synthetic_cluster as jax_cluster

import volcano_tpu_torch.ops.devincr as tdevincr
import volcano_tpu_torch.ops.devsnap as tdevsnap
import volcano_tpu_torch.ops.wave as tw
from volcano_tpu_torch import interop
from volcano_tpu_torch.device import to_tensor, tree_to
from volcano_tpu_torch.ops import kernels
from volcano_tpu_torch.ops.nodeclass import NodeClasses
from volcano_tpu_torch.ops.scoring import ScoreWeights

CPU = torch.device("cpu")


def _case(name):
    if name == "features":
        store = feature_store(volcano_tpu, n_nodes=96, n_pods=300, seed=1)
        return jax_args(store, binpack=True, nodeorder=True)[0]
    if name == "ties":
        return jax_args(jax_cluster(n_nodes=64, n_pods=128, gang_size=4,
                                    zones=4, seed=2))[0]
    # "neg": nine nodes in ten have no room left.
    store = feature_store(volcano_tpu, n_nodes=128, n_pods=256, seed=3)
    args = jax_args(store, binpack=True, nodeorder=True)[0]
    idle = np.asarray(args[0].idle).copy()
    rng = np.random.default_rng(5)
    idle[rng.random(idle.shape[0]) < 0.9] = 0.0
    return (args[0]._replace(idle=idle),) + tuple(args[1:])


class _Both:
    """One prepared case in both packages' containers."""

    def __init__(self, args, compacted):
        jn = tonp(args)
        self.nodes, _t, _j, _q, self.w, self.eps, self.slot, self.aff = jn
        profiles, _pid, _, _ = jw._profile_tasks(jn[1], self.aff)
        self.prof = jw._pad_profiles_rows(profiles)
        self.U = self.prof.req.shape[0]
        self.compacted = compacted
        if compacted:
            jw._host_node_classes._cache = None
            self.cls = jw._host_node_classes(self.nodes)
        else:
            z = np.zeros
            self.cls = JaxClasses(class_id=z((1,), np.int32),
                                  label_bits=z((1, 1), np.uint32),
                                  taint_bits=z((1, 1), np.uint32),
                                  ready=z((1,), bool))
        self.taints = bool(np.asarray(self.nodes.taint_bits).any())
        self.feats = (False, False, self.taints, False, False, False, False)
        tn = interop.solve_args_from_numpy(jn)
        w = tn[4]
        self.w_t = ScoreWeights(
            float(w.binpack_weight), to_tensor(w.binpack_res, CPU),
            float(w.least_req_weight), float(w.most_req_weight),
            float(w.balanced_weight), float(w.node_affinity_weight))
        self.prof_t = tree_to(tw.SolveProfiles(*self.prof), CPU)
        self.eps_t = to_tensor(tn[5], CPU)
        self.slot_t = to_tensor(tn[6], CPU)

    def nodes_t(self, nodes=None):
        return tree_to(nodes if nodes is not None else self.nodes, CPU)

    def cls_t(self, nodes_t):
        if self.compacted:
            return tree_to(NodeClasses(*self.cls), CPU)
        return tw._identity_classes(nodes_t)

    def jax_static(self):
        ok, sc = jw._static_planes(
            self.nodes, self.prof, self.cls, self.w.node_affinity_weight,
            chunk=min(self.U, 64), has_taints=self.taints,
            cls_identity=not self.compacted)
        return np.asarray(ok), np.asarray(sc)

    def jax_cold(self, stat, sl_k, B):
        return [np.asarray(x) for x in jw._coarse_shortlist(
            self.nodes, self.prof, np.ones((1, 1), bool),
            np.zeros((1, 1), np.float32), self.cls, self.aff, self.w,
            self.eps, self.slot, sl_k=sl_k, chunk=min(self.U, 64),
            features=self.feats, cnt0_any=False,
            cls_identity=not self.compacted, n_blocks=B, with_cand=True,
            static_ext=True, stat_ok=stat[0], stat_score=stat[1])]

    def port_cold(self, stat_t, sl_k, B, nodes=None):
        nt = self.nodes_t(nodes)
        return kernels.coarse_shortlist(
            self.prof_t, self.cls_t(nt), nt.idle, nt.allocatable,
            nt.ntasks, nt.max_tasks, self.eps_t, self.slot_t, self.w_t,
            sl_k, self.taints, stat=stat_t, n_blocks=B)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        assert np.array_equal(a, b)


CASES = [("features", True), ("features", False), ("ties", True),
         ("ties", False), ("neg", True)]


@pytest.mark.parametrize("name,compacted", CASES)
def test_static_planes_identical(name, compacted):
    c = _Both(_case(name), compacted)
    want = c.jax_static()
    nt = c.nodes_t()
    got = kernels.static_planes(c.prof_t, c.cls_t(nt),
                                c.w.node_affinity_weight, c.taints)
    _bits_equal(want[0], got[0].numpy())
    _bits_equal(want[1], got[1].numpy())


@pytest.mark.parametrize("name,compacted", CASES)
@pytest.mark.parametrize("sl_k,B", [(24, 4), (20, 8)])
def test_coarse_with_cand_static_ext_identical(name, compacted, sl_k, B):
    c = _Both(_case(name), compacted)
    stat = c.jax_static()
    want_sl, want_s, want_i = c.jax_cold(stat, sl_k, B)
    stat_t = (torch.from_numpy(stat[0].copy()),
              torch.from_numpy(stat[1].copy()))
    sl, ok, sc, cand_s, cand_i = c.port_cold(stat_t, sl_k, B)
    _bits_equal(want_sl, sl.numpy())
    _bits_equal(want_s, cand_s.numpy())
    _bits_equal(want_i, cand_i.numpy())
    assert ok is stat_t[0] and sc is stat_t[1]
    # The blocked selection is the direct one.
    nt = c.nodes_t()
    direct, _, _ = kernels.coarse_shortlist(
        c.prof_t, c.cls_t(nt), nt.idle, nt.allocatable, nt.ntasks,
        nt.max_tasks, c.eps_t, c.slot_t, c.w_t, sl_k, c.taints)
    _bits_equal(direct.numpy(), sl.numpy())
    if name == "neg":
        assert (want_s <= -1e38).mean() > 0.5  # mostly-NEG blocks


@pytest.mark.parametrize("name,compacted", CASES)
def test_warm_shortlist_identical(name, compacted):
    sl_k, B = 24, 4
    c = _Both(_case(name), compacted)
    stat = c.jax_static()
    stat_t = (torch.from_numpy(stat[0].copy()),
              torch.from_numpy(stat[1].copy()))
    _sl0, cand_s0, cand_i0 = c.jax_cold(stat, sl_k, B)
    N = c.nodes.idle.shape[0]
    nlb = N // B
    klb = min(sl_k, nlb)
    # Capacity changes confined to blocks 1 and 3.
    idle = np.asarray(c.nodes.idle).copy()
    idle[nlb:nlb + nlb // 2] *= 0.25
    ntasks = np.asarray(c.nodes.ntasks).copy()
    ntasks[3 * nlb + 1] += 3
    idle[3 * nlb + 2] = 0.0
    nodes2 = c.nodes._replace(idle=idle, ntasks=ntasks)
    db = np.array([1, 3], np.int32)
    want = [np.asarray(x) for x in jw._warm_shortlist(
        nodes2, c.prof, np.ones((1, 1), bool), np.zeros((1, 1), np.float32),
        c.cls, c.aff, c.w, c.eps, c.slot, stat[0], stat[1], db, cand_s0,
        cand_i0, sl_k=sl_k, klb=klb, nlb=nlb, chunk=min(c.U, 64),
        features=c.feats, cnt0_any=False, cls_identity=not compacted,
        static_ext=True)]
    nt2 = c.nodes_t(nodes2)
    got = kernels.warm_shortlist(
        c.prof_t, c.cls_t(nt2).class_id, *stat_t, nt2.idle,
        nt2.allocatable, nt2.ntasks, nt2.max_tasks, c.eps_t, c.slot_t,
        c.w_t, torch.from_numpy(db), torch.from_numpy(cand_s0.copy()),
        torch.from_numpy(cand_i0.copy()), sl_k)
    for a, b in zip(want, got):
        _bits_equal(a, b.numpy())
    # Warm equals a full re-rank of the new state, in both packages.
    full = c.port_cold(stat_t, sl_k, B, nodes=nodes2)
    for a, b in zip(got, (full[0], full[3], full[4])):
        _bits_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("dtype,width", [
    (np.float32, 3), (np.int32, 0), (np.bool_, 0), (np.uint32, 2),
])
def test_scatter_rows_identical(dtype, width):
    rng = np.random.default_rng(11)
    shape = (64,) + ((width,) if width else ())
    base = rng.integers(0, 1000, size=shape).astype(dtype)
    rows = rng.permutation(64)[:9].astype(np.int32)
    vals = rng.integers(0, 1000, size=(9,) + shape[1:]).astype(dtype)
    want = np.asarray(jdevsnap._scatter_rows(base.copy(), rows, vals))
    buf = to_tensor(base.copy(), CPU)
    kernels.scatter_rows(buf, torch.from_numpy(rows), to_tensor(vals, CPU))
    got = buf.numpy()
    if dtype == np.uint32:
        got = got.view(np.uint32)
    _bits_equal(want, got)


class _FakeMirror:
    """The two mirror calls a snapshot makes, over an explicit dirty list."""

    def __init__(self):
        self.rows = np.zeros(0, np.int64)

    def node_delta_rows(self, since_epoch):
        return self.rows

    def reset_node_delta(self):
        self.rows = np.zeros(0, np.int64)


def _planes(rng, N):
    return {
        "allocatable": rng.integers(0, 64, size=(N, 3)).astype(np.float32),
        "max_tasks": rng.integers(0, 110, size=N).astype(np.int32),
        "ready": rng.random(N) < 0.9,
        "label_bits": rng.integers(0, 1 << 31, size=(N, 2)).astype(
            np.uint32),
    }


def _build(truth):
    return {name: (lambda rows, a=a: a if rows is None else a[rows])
            for name, a in truth.items()}


def test_device_snapshot_deltas_identical(monkeypatch):
    """Full, duplicate-free delta, chunked delta (a staging budget below
    one delta) and over-threshold uploads: the port's resident planes and
    counters equal the JAX snapshot's after every step."""
    N = 4096
    rng = np.random.default_rng(4)
    truth = _planes(rng, N)
    snaps = {"jax": jdevsnap.DeviceSnapshot(), "port":
             tdevsnap.DeviceSnapshot(CPU)}
    mirrors = {k: _FakeMirror() for k in snaps}
    steps = [(1, None, 1.0), (2, 40, 1.0), (3, 0, 1.0), (4, 900, 0.004),
             (5, 1500, 1.0), (5, None, 1.0)]
    for epoch, n_dirty, budget_mb in steps:
        monkeypatch.setenv("VOLCANO_TPU_DEVSNAP_BUDGET_MB", str(budget_mb))
        if n_dirty:
            rows = np.sort(rng.permutation(N)[:n_dirty])
            fresh = _planes(rng, n_dirty)
            for name in truth:
                truth[name] = truth[name].copy()
                truth[name][rows] = fresh[name]
        else:
            rows = np.zeros(0, np.int64)
        for k in snaps:
            mirrors[k].rows = rows
        out = {k: snaps[k].node_planes(mirrors[k], (epoch, N, 3, 2),
                                       _build(truth)) for k in snaps}
        for name, want in truth.items():
            j = np.asarray(out["jax"][name])
            p = out["port"][name].numpy()
            if want.dtype == np.uint32:
                p = p.view(np.uint32)
            _bits_equal(want, j)
            _bits_equal(want, p)
        for attr in ("full_uploads", "delta_uploads", "hits",
                     "delta_chunks"):
            assert getattr(snaps["jax"], attr) == \
                getattr(snaps["port"], attr), attr
    assert snaps["port"].delta_chunks > 0
    assert snaps["port"].full_uploads == 2
    assert snaps["port"].delta_uploads == 2


def _feats(taints):
    return (False, False, bool(taints), False, False, False, False)


@pytest.mark.parametrize("name,compacted", CASES)
@pytest.mark.parametrize("taints", [True, False])
def test_coarse_in_launch_static_planes_identical(name, compacted, taints):
    """The row-form coarse_shortlist computing the static planes in its
    own launch returns ``_static_planes`` bit for bit and the JAX pass's
    shortlist; fed those planes back (``static_ext``), it returns the same
    shortlist again."""
    sl_k = 20
    c = _Both(_case(name), compacted)
    chunk = min(c.U, 64)
    ok, sc = (np.asarray(x) for x in jw._static_planes(
        c.nodes, c.prof, c.cls, c.w.node_affinity_weight, chunk=chunk,
        has_taints=taints, cls_identity=not compacted))
    want = np.asarray(jw._coarse_shortlist(
        c.nodes, c.prof, np.ones((1, 1), bool), np.zeros((1, 1), np.float32),
        c.cls, c.aff, c.w, c.eps, c.slot, sl_k=sl_k, chunk=chunk,
        features=_feats(taints), cnt0_any=False,
        cls_identity=not compacted))
    nt = c.nodes_t()
    args = (c.prof_t, c.cls_t(nt), nt.idle, nt.allocatable, nt.ntasks,
            nt.max_tasks, c.eps_t, c.slot_t, c.w_t, sl_k, taints)
    sl, t_ok, t_sc = kernels.coarse_shortlist(*args)
    _bits_equal(ok, t_ok.numpy())
    _bits_equal(sc, t_sc.numpy())
    _bits_equal(want, sl.numpy())
    again = kernels.coarse_shortlist(*args, stat=(t_ok, t_sc))
    _bits_equal(want, again[0].numpy())
    assert again[1] is t_ok and again[2] is t_sc


def _capacity_change(nodes, rows, factor):
    idle = np.asarray(nodes.idle).copy()
    idle[rows] *= factor
    return nodes._replace(idle=idle)


@pytest.mark.parametrize("compacted", [True, False])
def test_device_incremental_static_misses_identical(compacted,
                                                    monkeypatch):
    """miss -> full re-rank, hit -> warm, miss -> warm, hit -> null warm,
    miss -> full: the port's shortlists and planes equal the JAX
    context's, with equal static builds and hits; each miss calls
    ``static_planes`` once and a hit never."""
    sl_k = 16
    c = _Both(_case("features"), compacted)
    chunk = min(c.U, 64)
    N = int(np.asarray(c.nodes.idle).shape[0])
    B, nlb, _klb = tdevincr.block_geometry(N, sl_k)
    assert B == 16 and nlb >= 2
    standalone = []
    real = kernels.static_planes

    def counted(*a, **kw):
        standalone.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(kernels, "static_planes", counted)
    n1 = _capacity_change(c.nodes, [nlb + 1, 3 * nlb], 0.25)
    n2 = _capacity_change(n1, [5 * nlb + 1], 0.5)
    steps = [  # static key, warm key, dirty rows, nodes, mode, static
        (("s", 1), ("w", 1), None, c.nodes, "full", "build", 1),
        (("s", 1), ("w", 1), [nlb + 1, 3 * nlb], n1, "warm", "hit", 0),
        (("s", 2), ("w", 1), [5 * nlb + 1], n2, "warm", "build", 1),
        (("s", 2), ("w", 1), [], n2, "warm", "hit", 0),
        (("s", 3), ("w", 2), [0], n2, "full", "build", 1),
    ]
    jdv, tdv = jdevincr.DeviceIncremental(), tdevincr.DeviceIncremental()
    one, zero = np.ones((1, 1), bool), np.zeros((1, 1), np.float32)
    feats = _feats(c.taints)
    for skey, wkey, dirty, nodes, mode, static, launched in steps:
        d = None if dirty is None else np.asarray(dirty, np.int64)
        jdv.begin_solve(skey, wkey, d)
        tdv.begin_solve(skey, wkey, d)
        jstat = jdv.static_planes(nodes, c.prof, c.cls,
                                  c.w.node_affinity_weight, chunk,
                                  c.taints, not compacted)
        want = np.asarray(jdv.shortlist(
            nodes, c.prof, one, zero, c.cls, c.aff, c.w, c.eps, c.slot,
            sl_k, chunk, feats, False, not compacted, 1, jstat))
        nt = c.nodes_t(nodes)
        cls = c.cls_t(nt)
        before = len(standalone)
        tstat = tdv.static_planes(c.prof_t, cls, c.w.node_affinity_weight,
                                  c.taints, not compacted)
        got = tdv.shortlist(nt, c.prof_t, cls, c.w_t, c.eps_t, c.slot_t,
                            sl_k, feats, not compacted, tstat)
        planes = tdv._static
        assert planes is tstat
        assert len(standalone) - before == launched, (skey, wkey)
        _bits_equal(want, got.numpy())
        _bits_equal(np.asarray(jstat[0]), planes[0].numpy())
        _bits_equal(np.asarray(jstat[1]), planes[1].numpy())
        assert tdv.last_mode == jdv.last_mode == mode
        assert tdv.last_static == jdv.last_static == static
        assert (tdv.static_builds, tdv.static_hits) == \
            (jdv.static_builds, jdv.static_hits)
        assert tdv.counts == jdv.counts
        jdv.end_solve()
        tdv.end_solve()
    assert (tdv.static_builds, tdv.static_hits) == (3, 2)


def _six_planes(rng, N):
    out = _planes(rng, N)
    out["taint_bits"] = rng.integers(0, 1 << 31, size=(N, 1)).astype(
        np.uint32)
    out["class_id"] = rng.integers(0, 9, size=N).astype(np.int32)
    return out


def test_scatter_planes_identical():
    """One staged delta of six planes (f32, int32, bool, uint32 bits)
    written by ``scatter_planes`` equals ``_scatter_rows`` per plane."""
    rng = np.random.default_rng(12)
    N, k = 256, 37
    base = _six_planes(rng, N)
    rows = np.sort(rng.permutation(N)[:k]).astype(np.int32)
    fresh = _six_planes(rng, k)
    bufs = [to_tensor(base[n].copy(), CPU) for n in base]
    vals = [fresh[n].view(np.int32) if fresh[n].dtype == np.uint32
            else fresh[n] for n in base]
    staged = kernels.stage_delta(rows, vals, CPU)
    offs, total = kernels.delta_layout(k, [v.nbytes // k for v in vals])
    assert staged.dtype == torch.uint8 and staged.numel() >= total
    assert all(o % 16 == 0 for o in offs)
    kernels.scatter_planes(bufs, staged, k)
    for name, buf in zip(base, bufs):
        want = np.asarray(jdevsnap._scatter_rows(base[name].copy(), rows,
                                                 fresh[name]))
        got = buf.numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        _bits_equal(want, got)


@pytest.mark.parametrize("budget_mb", [1.0, 0.02, 0.004])
def test_device_snapshot_six_planes_identical(monkeypatch, budget_mb):
    """Six planes through full, delta (chunked under small budgets) and
    over-threshold uploads, one step re-uploading ``class_id`` whole (its
    delta unprovable): resident planes and counters equal the JAX
    snapshot's; the port writes each combined chunk with one launch."""
    N = 4096
    rng = np.random.default_rng(6)
    truth = _six_planes(rng, N)
    snaps = {"jax": jdevsnap.DeviceSnapshot(), "port":
             tdevsnap.DeviceSnapshot(CPU)}
    mirrors = {k: _FakeMirror() for k in snaps}
    monkeypatch.setenv("VOLCANO_TPU_DEVSNAP_BUDGET_MB", str(budget_mb))
    launched = []
    real = kernels.scatter_planes

    def counted(*a, **kw):
        launched.append(a[2])
        return real(*a, **kw)

    monkeypatch.setattr(kernels, "scatter_planes", counted)
    # (epoch, dirty rows, class ids unprovable)
    steps = [(1, None, False), (2, 40, False), (3, 700, True),
             (4, 1, False), (5, 1000, False), (6, 1500, False),
             (6, None, False)]
    for epoch, n_dirty, no_cls_delta in steps:
        if n_dirty:
            rows = np.sort(rng.permutation(N)[:n_dirty])
            fresh = _six_planes(rng, n_dirty)
            for name in truth:
                truth[name] = truth[name].copy()
                truth[name][rows] = fresh[name]
        else:
            rows = np.zeros(0, np.int64)
        for k in snaps:
            mirrors[k].rows = rows
        build = _build(truth)
        if no_cls_delta:
            a = truth["class_id"]
            build["class_id"] = lambda r, a=a: a if r is None else None
        launched.clear()
        before = snaps["port"].delta_launches
        out = {k: snaps[k].node_planes(mirrors[k], (epoch, N, 3, 2),
                                       build) for k in snaps}
        for name, want in truth.items():
            p = out["port"][name].numpy()
            if want.dtype == np.uint32:
                p = p.view(np.uint32)
            _bits_equal(want, np.asarray(out["jax"][name]))
            _bits_equal(want, p)
        for attr in ("full_uploads", "delta_uploads", "hits",
                     "delta_chunks"):
            assert getattr(snaps["jax"], attr) == \
                getattr(snaps["port"], attr), attr
        assert len(launched) == snaps["port"].delta_launches - before
        if launched:
            # Every combined chunk but the last is a full power of two,
            # and each fits the staging budget.
            assert sum(launched) == (n_dirty or 0)
            assert len(set(launched[:-1])) <= 1
            planes = 5 if no_cls_delta else 6
            row_nb = 4 + sum(truth[n][0].nbytes for n in truth
                             if n != "class_id" or not no_cls_delta)
            assert launched[0] * row_nb + 16 * planes <= \
                tdevsnap.budget_bytes()
    port = snaps["port"]
    assert (port.full_uploads, port.delta_uploads) == (2, 4)
    if budget_mb < 1:
        # The combined chunks split where the JAX per-plane chunks may
        # not (0.02 MB holds 1,024 rows of the widest plane alone).
        assert port.delta_launches > port.delta_uploads
    if budget_mb < 0.01:
        assert port.delta_chunks > 0
