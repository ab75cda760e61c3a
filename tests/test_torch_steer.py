"""Live affinity steering (``VOLCANO_TPU_AFF_STEER=1``): the port against the
JAX package on the CPU, in both phase modes.

After a sub-round accepted a task that carries a required term, or that
matches a term some row of the wave requires, the JAX solve rechecks the
ranked candidates' required (anti-)affinity against the live count window
before the next sub-round walks (``_solve_wave``'s ``steer``,
wave.py:1594-1652).  The port does the same with the ``aff_steer`` kernel
behind a device byte.  ``AFF_STEER`` is read at trace time in the JAX
package, so every JAX solve here runs between two ``jax.clear_caches()``.

Solve level: the contended store of ``affinity_store`` (64 nodes of 8 CPUs,
48 gangs of 8, required zone affinity and hostname anti-affinity to their
own app and to resident apps) at wave 32, every ``AllocResult`` field bit
for bit, steering on, in both phase modes, with a guard that steering
changes the binds there (so the twin is not vacuous); the same with
releasing capacity (pipelined counts in the window).  Cycle level: a twin
of ``Scheduler.run_once()`` cycles on a config-5 mix with steering on.
Kernel level: ``aff_steer``'s plain version against a direct numpy reading
of the JAX formulas (both its two-phase [UM, K, EW] form and its
single-phase [UM, N] form) on random windows with domain-less nodes, the
self-match rule and pipelined counts; a clear gate leaves the plane as it
was.  The card's kernel against the plain version is in
``tests/test_torch_cuda.py``.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from test_torch_fixtures import affinity_store, mirror_state, repend_feed
from test_torch_fixtures import tonp

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.ops.wave as jw
import volcano_tpu.synth
from volcano_tpu.scheduler import Scheduler as JaxScheduler
from volcano_tpu.synth import solve_args_from_store as jax_args

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.ops.wave as tw
import volcano_tpu_torch.synth
from volcano_tpu_torch import interop
from volcano_tpu_torch.ops import affkernels, kernels
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

FIELDS = ("assigned", "pipelined", "never_ready", "fit_failed", "idle",
          "q_alloc", "iters", "fb_exhausted", "fb_affinity")
CONTENDED = dict(n_nodes=64, n_gangs=48, gang_size=8, zones=4, node_cpu="8",
                 mix=("aff", "anti", "res_aff", "res_anti"))
CONF_BASE = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""

# JAX results by (case, phase mode, steering), shared by the module.
_JAX = {}


def _mode(monkeypatch, twophase, steer=1):
    monkeypatch.setenv("VOLCANO_TPU_TWOPHASE", "1" if twophase else "0")
    for mod in (jw, tw):
        monkeypatch.setattr(mod, "AFF_STEER", steer)


def _jax_solve(key, args, wave):
    """The JAX solve, its jit cache cleared on both sides (the knob is a
    trace-time constant there)."""
    if key not in _JAX:
        jax.clear_caches()
        try:
            _JAX[key] = tonp(jw.solve_wave(*args, wave=wave))
        finally:
            jax.clear_caches()
    return _JAX[key]


def _port(args, wave):
    return interop.result_to_numpy(tw.solve_wave(
        *interop.solve_args_from_numpy(tonp(args)), wave=wave,
        device="cpu"))


def _assert_equal(jr, tr):
    for f in FIELDS:
        a, b = np.asarray(getattr(jr, f)), np.asarray(getattr(tr, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), (f, a, b)


def _release(args):
    nodes = tonp(args[0])
    idle = np.array(nodes.idle, np.float32)
    rel = np.zeros_like(idle)
    rel[::2] = idle[::2]
    idle[::2] = 0.0
    return (nodes._replace(idle=idle, releasing=rel),) + tuple(args[1:])


def _contended(release=False):
    args, _ = jax_args(affinity_store(volcano_tpu, **CONTENDED),
                       binpack=True, nodeorder=True)
    return _release(args) if release else args


@pytest.mark.parametrize("release", [False, True])
@pytest.mark.parametrize("twophase", [True, False])
def test_steered_solve_equals_jax(monkeypatch, twophase, release):
    args = _contended(release)
    case = ("contended", twophase, release)
    _mode(monkeypatch, twophase, steer=0)
    unsteered = _jax_solve(case + (0,), args, 32)
    _mode(monkeypatch, twophase, steer=1)
    jr = _jax_solve(case + (1,), args, 32)
    kernels.reset_launches()
    tr = _port(args, 32)
    _assert_equal(jr, tr)
    rec = tw.LAST_TWOPHASE
    assert rec["enabled"] is twophase and rec["affinity"]
    # Steering ran, computed on some sub-rounds, and changed the binds.
    assert rec["steer_calls"] > 0
    assert 0 < kernels.read_tally("aff_steer") <= rec["steer_calls"]
    assert not np.array_equal(np.asarray(jr.assigned),
                              np.asarray(unsteered.assigned))
    if release:
        assert rec["future"]
        assert int((np.asarray(tr.pipelined) >= 0).sum()) > 0


def test_steering_off_calls_no_kernel(monkeypatch):
    """With the switch off the port never calls aff_steer and equals the
    unsteered JAX solve."""
    _mode(monkeypatch, True, steer=0)
    args = _contended()
    jr = _jax_solve(("contended", True, False, 0), args, 32)
    kernels.reset_launches()
    _assert_equal(jr, _port(args, 32))
    assert tw.LAST_TWOPHASE["steer_calls"] == 0
    assert kernels.read_tally("aff_steer") == 0


def _reset_uid_counters():
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)


def _cycles(pkg, cycles=3):
    _reset_uid_counters()
    store = pkg.synth.synthetic_cluster(
        n_nodes=48, n_pods=384, gang_size=8, zones=4, affinity_fraction=0.2,
        anti_affinity_fraction=0.2, spread_fraction=0.1, seed=5)
    if pkg is volcano_tpu:
        store.pipeline = False
        sched = JaxScheduler(store, conf_str=CONF_BASE)
    else:
        sched = PortScheduler(store, conf_str=CONF_BASE, device="cpu")
    store.cycle_feed = repend_feed([0, 1, 2, 3])
    trace = []
    for _ in range(cycles):
        sched.run_once()
        trace.append({
            "binds": dict(store.binder.binds),
            "phases": {u: pg.status.phase
                       for u, pg in sorted(store.pod_groups.items())},
            "mirror": mirror_state(store),
        })
    store.close()
    return trace


@pytest.mark.parametrize("twophase", [True, False])
def test_steered_cycles_equal_jax(monkeypatch, twophase):
    _mode(monkeypatch, twophase)
    key = ("cycles", twophase)
    if key not in _JAX:
        jax.clear_caches()
        try:
            _JAX[key] = _cycles(volcano_tpu)
        finally:
            jax.clear_caches()
    calls = []
    real = tw.solve_wave

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls.append(tw.LAST_TWOPHASE["steer_calls"])
        return out

    monkeypatch.setattr(tw, "solve_wave", counted)
    kernels.reset_launches()
    got = _cycles(volcano_tpu_torch)
    for step, (a, b) in enumerate(zip(_JAX[key], got)):
        for field in a:
            assert a[field] == b[field], (field, step)
    assert sum(calls) > 0 and kernels.read_tally("aff_steer") > 0
    assert len(got[-1]["binds"]) > 0


# -------------------------------------------------------- the kernel


def steer_window(seed, UM=6, K=9, E=7, D=11, N=30, keys=3, pip=True):
    """A random live window: domain-less nodes (-1), terms with no match
    anywhere (the self-match rule), pipelined counts."""
    rng = np.random.RandomState(seed)
    cnt = rng.randint(0, 3, (E, D)) * (rng.rand(E, D) < 0.5)
    cnt_p = (rng.rand(E, D) < 0.1).astype(np.int32)
    # Terms nobody matches yet, term 0 among them; row 0 requires it and
    # matches it itself (the self-match rule).
    cnt[rng.rand(E) < 0.3] = 0
    cnt[0] = cnt_p[0] = 0
    t_aff = rng.rand(UM, E) < 0.2
    t_match = rng.rand(UM, E) < 0.5
    t_aff[0, 0] = t_match[0, 0] = True
    at = affkernels.AffTerms(
        torch.from_numpy(rng.randint(-1, D, (N, keys)).astype(np.int32)),
        torch.from_numpy(rng.randint(0, keys, E).astype(np.int32)),
        torch.from_numpy(cnt.astype(np.int32)),
        torch.from_numpy(cnt_p) if pip else None,
        torch.from_numpy(t_aff),
        torch.from_numpy(rng.rand(UM, E) < 0.1),
        torch.from_numpy(t_match),
        torch.zeros((UM, E), dtype=torch.float32))
    ranked = torch.from_numpy(rng.randint(0, N, (UM, K)).astype(np.int32))
    feas = torch.from_numpy(rng.rand(UM, K) < 0.8)
    return ranked, feas, at


def _numpy_steer(ranked, feas_att, at):
    """JAX :1602-1645 read directly: bf16-style indicator sums compared
    with 0.5, in the two-phase [UM, K, EW] form and in the single-phase
    [UM, N] form gathered at ``ranked``."""
    node_dom = at.node_dom.numpy()
    tk = at.term_key.numpy()
    cnt = at.cnt_a.numpy() + (0 if at.cnt_p is None else at.cnt_p.numpy())
    E = cnt.shape[0]
    total = cnt.sum(axis=-1)
    t_aff, t_anti = at.t_req_aff.numpy(), at.t_req_anti.numpy()
    t_match = at.t_matches.numpy()
    need = (t_aff & ~((total == 0)[None, :] & t_match)).astype(np.float32)
    anti = t_anti.astype(np.float32)
    node_dom_t = node_dom[:, tk]  # [N, EW]
    rk = ranked.numpy()
    # Two-phase: the window at the ranked candidates.
    dw = node_dom_t[rk]  # [UM, K, EW]
    cval = np.where(dw >= 0, cnt[np.arange(E)[None, None, :],
                                 np.maximum(dw, 0)], 0)
    av = np.einsum("ue,uke->uk", need, (cval == 0).astype(np.float32))
    nv = np.einsum("ue,uke->uk", anti, (cval > 0).astype(np.float32))
    two = feas_att.numpy() & (av < 0.5) & (nv < 0.5)
    # Single-phase: the [UM, N] verdict, then taken at ranked.
    cv_n = np.where(node_dom_t >= 0, cnt[np.arange(E)[None, :],
                                         np.maximum(node_dom_t, 0)], 0)
    ok_n = ((need @ (cv_n == 0).astype(np.float32).T < 0.5)
            & (anti @ (cv_n > 0).astype(np.float32).T < 0.5))
    one = feas_att.numpy() & np.take_along_axis(ok_n, rk, axis=1)
    assert np.array_equal(two, one)
    return two


@pytest.mark.parametrize("pip", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_aff_steer_plain_equals_numpy_reading(seed, pip):
    ranked, feas, at = steer_window(seed, pip=pip)
    want = _numpy_steer(ranked, feas, at)
    got = affkernels.aff_steer(ranked, feas, at)
    assert np.array_equal(got.numpy(), want)
    # Not vacuous: the verdict drops some feasible candidates and keeps
    # others, and the cases hold domain-less nodes and exempt terms.
    assert (feas.numpy() & ~want).any() and want.any()
    assert (at.node_dom.numpy() < 0).any()
    tot = (at.cnt_a + (0 if at.cnt_p is None else at.cnt_p)).sum(1)
    assert ((tot == 0)[None, :] & at.t_matches & at.t_req_aff).any()


def test_aff_steer_self_match_rule():
    """A required term nobody matches yet is exempt for a row that matches
    it itself, and binding for one that does not."""
    node_dom = torch.tensor([[0], [1], [-1]], dtype=torch.int32)
    at = affkernels.AffTerms(
        node_dom, torch.zeros(1, dtype=torch.int32),
        torch.zeros((1, 2), dtype=torch.int32), None,
        torch.tensor([[True], [True]]), torch.tensor([[False], [False]]),
        torch.tensor([[True], [False]]),
        torch.zeros((2, 1), dtype=torch.float32))
    ranked = torch.tensor([[0, 1, 2], [0, 1, 2]], dtype=torch.int32)
    feas = torch.ones((2, 3), dtype=torch.bool)
    got = affkernels.aff_steer(ranked, feas, at)
    assert got[0].all() and not got[1].any()
    # One match in domain 1: only that domain holds the term now, and the
    # domain-less node has count 0.
    at = at._replace(cnt_a=torch.tensor([[0, 1]], dtype=torch.int32))
    got = affkernels.aff_steer(ranked, feas, at)
    assert got.tolist() == [[False, True, False], [False, True, False]]


def test_aff_steer_gate_and_tally():
    """A clear gate leaves the working plane and the computing tally as
    they were; a set gate writes the verdict; a gate needs the plane."""
    ranked, feas, at = steer_window(3)
    want = affkernels.aff_steer(ranked, feas, at)
    kernels.reset_launches()
    out = torch.ones_like(feas)
    got = affkernels.aff_steer(ranked, feas, at,
                               gate=torch.zeros(1, dtype=torch.bool),
                               out=out)
    assert got is out and bool(out.all())
    assert kernels.read_tally("aff_steer") == 0
    affkernels.aff_steer(ranked, feas, at,
                         gate=torch.ones(1, dtype=torch.bool), out=out)
    assert torch.equal(out, want)
    assert kernels.read_tally("aff_steer") == 1
    with pytest.raises(ValueError):
        affkernels.aff_steer(ranked, feas, at,
                             gate=torch.ones(1, dtype=torch.bool))
