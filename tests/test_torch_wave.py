"""The port's solve_wave against the JAX package's on the CPU.

The same solve args (the JAX package's, converted to numpy and handed over
through ``interop.solve_args_from_numpy``) go through JAX ``solve_wave``
(plain jit on the CPU platform tests/conftest.py forces) and the port's
``solve_wave(device="cpu")``, which runs the kernels' plain versions.

Compared bit for bit: ``assigned``, ``pipelined``, ``never_ready``,
``fit_failed``, ``iters``, ``fb_exhausted``, ``fb_affinity``.  ``idle`` and
``q_alloc`` must be exactly equal too: every request on these fixtures is a
multiple of 1000 milli-CPU and of 1 GiB, and every partial sum stays below
2^24 units of its slot's quantum, so each float32 sum is exact and the
scatter order of either side cannot change it.
"""

import numpy as np
import pytest

from test_torch_fixtures import (feature_store, one_node_gang,
                                 selector_store, tonp)

import volcano_tpu
from volcano_tpu.ops.wave import solve_wave as jax_solve_wave
from volcano_tpu.synth import solve_args_from_store as jax_args
from volcano_tpu.synth import synthetic_cluster as jax_cluster

import volcano_tpu_torch
from volcano_tpu_torch import interop
from volcano_tpu_torch.ops.wave import LAST_TWOPHASE
from volcano_tpu_torch.ops.wave import solve_wave as port_solve_wave
from volcano_tpu_torch.synth import solve_args_from_store as port_args
from volcano_tpu_torch.synth import synthetic_cluster as port_cluster

FIELDS = ("assigned", "pipelined", "never_ready", "fit_failed", "idle",
          "q_alloc", "iters", "fb_exhausted", "fb_affinity")


def _both(args, wave):
    """(JAX result, port result) as numpy on the same JAX solve args."""
    jr = tonp(jax_solve_wave(*args, wave=wave))
    targs = interop.solve_args_from_numpy(tonp(args))
    tr = interop.result_to_numpy(
        port_solve_wave(*targs, wave=wave, device="cpu"))
    return jr, tr


def _assert_equal(jr, tr):
    for f in FIELDS:
        a, b = np.asarray(getattr(jr, f)), np.asarray(getattr(tr, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        assert np.array_equal(a, b), (f, a, b)


def _with_deserved(args, deserved_rows):
    """Replace the queues' +inf deserved shares with finite ones."""
    q = args[3]
    des = np.array(q.deserved, np.float32)
    for i, row in enumerate(deserved_rows):
        des[i] = row
    return args[:3] + (q._replace(deserved=des),) + args[4:]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_invariants_fixture_matches(seed):
    """test_wave.py's randomized-invariants shapes."""
    rng = np.random.RandomState(seed)
    store = jax_cluster(
        n_nodes=int(rng.randint(16, 64)), n_pods=int(rng.randint(64, 256)),
        gang_size=int(rng.randint(1, 6)), n_queues=int(rng.randint(1, 3)),
        seed=seed,
    )
    args, _ = jax_args(store)
    _assert_equal(*_both(args, 64))


def test_full_placement_fixture_matches():
    args, _ = jax_args(jax_cluster(n_nodes=64, n_pods=512, gang_size=4,
                                   n_queues=2))
    jr, tr = _both(args, 128)
    _assert_equal(jr, tr)
    assert int((tr.assigned >= 0).sum()) == 512


def test_heterogeneous_mix_matches():
    args, _ = jax_args(jax_cluster(n_nodes=48, n_pods=384, gang_size=3,
                                   n_queues=3, seed=7))
    _assert_equal(*_both(args, 96))


def test_gang_discard_matches():
    """A gang larger than the node commits nothing on either side."""
    args, _ = jax_args(one_node_gang(volcano_tpu, cpu="4", replicas=8,
                                     min_member=8))
    jr, tr = _both(args, 8)
    _assert_equal(jr, tr)
    assert int((tr.assigned >= 0).sum()) == 0 and tr.never_ready.any()
    assert np.array_equal(tr.idle, np.asarray(args[0].idle))


def test_partial_gang_matches():
    args, _ = jax_args(one_node_gang(volcano_tpu, cpu="4", replicas=8,
                                     min_member=2))
    jr, tr = _both(args, 8)
    _assert_equal(jr, tr)
    assert int((tr.assigned >= 0).sum()) == 4


def test_node_selector_matches():
    args, maps = jax_args(selector_store(volcano_tpu))
    jr, tr = _both(args, 8)
    _assert_equal(jr, tr)
    good = maps.node_index["good"]
    real = np.asarray(args[1].real)
    assert all(tr.assigned[i] == good for i in range(len(real)) if real[i])


@pytest.mark.parametrize("nodeclass", ["1", "0"])
def test_taints_selectors_affinity_mix_matches(monkeypatch, nodeclass):
    """Taints, tolerations, selectors, required and preferred node
    affinity, with compacted and with identity node classes."""
    monkeypatch.setenv("VOLCANO_TPU_NODECLASS", nodeclass)
    args, _ = jax_args(feature_store(volcano_tpu, n_nodes=64, n_pods=512,
                                     seed=3))
    _assert_equal(*_both(args, 128))
    assert LAST_TWOPHASE["compacted_classes"] == (nodeclass == "1")


def test_two_queues_finite_deserved_gates_overuse():
    """Finite deserved shares turn queue-overuse gating on; some jobs are
    skipped for overuse and both sides skip the same ones."""
    args, _ = jax_args(jax_cluster(n_nodes=32, n_pods=512, gang_size=4,
                                   n_queues=2, seed=5))
    args = _with_deserved(args, [[24000.0, 96 * 2.0 ** 30],
                                 [16000.0, 64 * 2.0 ** 30]])
    jr, tr = _both(args, 64)
    _assert_equal(jr, tr)
    placed = int((tr.assigned >= 0).sum())
    assert 0 < placed < 512


def test_forced_shortlist_exhaustion_matches(monkeypatch):
    """A shortlist of 8 of 64 nodes runs dry; both sides rescore on all
    nodes the same number of times."""
    monkeypatch.setenv("VOLCANO_TPU_TOPK", "8")
    args, _ = jax_args(jax_cluster(n_nodes=64, n_pods=512, gang_size=4,
                                   seed=1))
    jr, tr = _both(args, 128)
    _assert_equal(jr, tr)
    assert int(jr.fb_exhausted) > 0 and int(tr.fb_exhausted) > 0


def test_port_end_to_end_matches_jax_end_to_end():
    """The port's own store -> encode -> solve against the JAX package's
    own store -> encode -> solve, from the same seed."""
    kw = dict(n_nodes=48, n_pods=400, gang_size=5, n_queues=2, zones=4,
              seed=11)
    jargs, _ = jax_args(jax_cluster(**kw), binpack=True, nodeorder=True)
    jr = tonp(jax_solve_wave(*jargs, wave=128))
    targs, _ = port_args(port_cluster(**kw), binpack=True, nodeorder=True,
                         device="cpu")
    tr = interop.result_to_numpy(
        port_solve_wave(*targs, wave=128, device="cpu"))
    _assert_equal(jr, tr)
    assert volcano_tpu_torch.__name__ == "volcano_tpu_torch"
