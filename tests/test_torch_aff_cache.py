"""The affinity attempt cache: the port against the JAX package on the CPU.

The JAX solve keeps a live wave's shortlist-width affinity planes across
its attempts and recomputes them only after a sub-round changed a count
(``VOLCANO_TPU_AFF_ACACHE``, default 1).  The port does the same around
``aff_live`` with a device byte as the gate.  On BASELINE config 5's mix
at a small size (``test_torch_fixtures.affinity_store``, a few hundred
pods, with and without releasing capacity) the port's ``solve_wave`` must
give the same result with the cache on and off, each equal to the JAX
``solve_wave`` on the same inputs, and the cached run must compute the
planes on fewer attempts than it has.
"""

import numpy as np
import pytest
import torch

from test_torch_fixtures import affinity_store, tonp

import volcano_tpu
from volcano_tpu.ops.wave import solve_wave as jax_solve_wave
from volcano_tpu.synth import solve_args_from_store as jax_args

import volcano_tpu_torch.ops.wave as tw
from volcano_tpu_torch import interop
from volcano_tpu_torch.ops import affkernels, kernels

FIELDS = ("assigned", "pipelined", "never_ready", "fit_failed", "idle",
          "q_alloc", "iters", "fb_exhausted", "fb_affinity")


def _equal(a, b, what):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), (what, f)


def _release(args):
    """Half the nodes' idle turned releasing: tasks pipeline onto the
    future idle (pipelined counts in the window)."""
    nodes = tonp(args[0])
    idle = np.array(nodes.idle, np.float32)
    rel = np.zeros_like(idle)
    rel[::2] = idle[::2]
    idle[::2] = 0.0
    return (nodes._replace(idle=idle, releasing=rel),) + tuple(args[1:])


def _port(args, wave, acache, monkeypatch):
    """The port's solve with the cache on or off: (result, attempts of
    live waves, computing aff_live calls)."""
    monkeypatch.setattr(tw, "AFF_ACACHE", acache)
    kernels.reset_launches()
    res = interop.result_to_numpy(tw.solve_wave(
        *interop.solve_args_from_numpy(tonp(args)), wave=wave,
        device="cpu"))
    return (res, tw.LAST_TWOPHASE["aff_attempts"],
            kernels.read_tally("aff_live"))


@pytest.mark.parametrize("release", [False, True])
@pytest.mark.parametrize("seed,wave", [(0, 64), (2, 16)])
def test_attempt_cache_equals_jax_and_uncached(monkeypatch, seed, wave,
                                               release):
    """Cache on and off give the JAX result; the cache skips the planes
    on attempts whose previous attempt changed no count."""
    store = affinity_store(volcano_tpu, n_nodes=24, n_gangs=60,
                           gang_size=4, seed=seed)
    args, _ = jax_args(store, binpack=True, nodeorder=True)
    if release:
        args = _release(args)
    jr = tonp(jax_solve_wave(*args, wave=wave))
    on, att_on, comp_on = _port(args, wave, 1, monkeypatch)
    assert tw.LAST_TWOPHASE["affinity"]
    assert tw.LAST_TWOPHASE["future"] == release
    off, att_off, comp_off = _port(args, wave, 0, monkeypatch)
    _equal(jr, on, "cache on vs JAX")
    _equal(jr, off, "cache off vs JAX")
    if release:
        assert int((np.asarray(on.pipelined) >= 0).sum()) > 0
    # Same decisions, so the same attempts and the same ungated calls
    # (phase 1, fallback rescores); without the cache every attempt
    # computes, with it fewer do.
    assert att_on == att_off > 0
    gated = comp_off - comp_on
    assert 0 < gated < att_on


def test_aff_live_gate_and_buffers():
    """A clear gate leaves the buffers and the computing tally as they
    were; a set gate writes the fresh planes into them; a gate needs the
    buffers."""
    rng = np.random.RandomState(4)
    U, E, D, N, K = 6, 5, 9, 20, 2
    at = affkernels.AffTerms(
        torch.from_numpy(rng.randint(-1, D, (N, K)).astype(np.int32)),
        torch.from_numpy(rng.randint(0, K, E).astype(np.int32)),
        torch.from_numpy(rng.randint(0, 3, (E, D)).astype(np.int32)), None,
        torch.from_numpy(rng.rand(U, E) < 0.4),
        torch.from_numpy(rng.rand(U, E) < 0.3),
        torch.from_numpy(rng.rand(U, E) < 0.5),
        torch.from_numpy(rng.choice([0.0, 5.0, -10.0], (U, E))
                         .astype(np.float32)))
    rows = torch.arange(U, dtype=torch.int32)
    cand = torch.from_numpy(rng.randint(0, N, (U, 7)).astype(np.int32))
    terms = torch.arange(E, dtype=torch.int32)[None]
    want = affkernels.aff_live(rows, cand, terms, at)
    kernels.reset_launches()
    buf = (torch.ones((U, 7), dtype=torch.bool),
           torch.full((U, 7), 7.0, dtype=torch.float32))
    before = (buf[0].clone(), buf[1].clone())
    got = affkernels.aff_live(rows, cand, terms, at,
                              gate=torch.zeros(1, dtype=torch.bool), out=buf)
    assert got is buf
    assert torch.equal(buf[0], before[0]) and torch.equal(buf[1], before[1])
    assert kernels.read_tally("aff_live") == 0
    affkernels.aff_live(rows, cand, terms, at,
                        gate=torch.ones(1, dtype=torch.bool), out=buf)
    assert torch.equal(buf[0], want[0]) and torch.equal(buf[1], want[1])
    assert kernels.read_tally("aff_live") == 1
    assert not bool(want[0].all()), "the case rejects nothing"
    with pytest.raises(ValueError):
        affkernels.aff_live(rows, cand, terms, at,
                            gate=torch.ones(1, dtype=torch.bool))
