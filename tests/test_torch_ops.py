"""The port's elementwise primitives against the JAX package's.

``less_equal`` and ``node_score`` on random inputs, bit for bit: the
epsilon edges (differences just under and over a quantum), extended
scalar slots, zero capacity, idle above allocatable, and -0.0 entries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from volcano_tpu.ops.resreq import less_equal as jax_less_equal
from volcano_tpu.ops.scoring import ScoreWeights as JaxWeights
from volcano_tpu.ops.scoring import node_score as jax_node_score

from volcano_tpu_torch.ops.resreq import less_equal
from volcano_tpu_torch.ops.scoring import ScoreWeights, node_score

EPS = np.array([10.0, 10.0 * 1024 * 1024, 10.0], np.float32)
SLOT = np.array([False, False, True])


def _edge_values(rng, shape):
    """Mostly integers in resource units, with -0.0, zeros and near-eps
    offsets mixed in."""
    base = rng.integers(0, 64, size=shape).astype(np.float32) * 1000.0
    base[..., 1] = rng.integers(0, 64, size=shape[:-1]) * float(2 ** 30)
    pick = rng.random(shape)
    base[pick < 0.1] = -0.0
    base[(pick >= 0.1) & (pick < 0.2)] = 0.0
    return base


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_less_equal_matches(seed):
    rng = np.random.default_rng(seed)
    r = _edge_values(rng, (4096, 3))
    off = rng.choice(
        np.array([0.0, 5.0, 9.99, 10.0, 10.01, 20.0, -5.0, -10.0, -10.01],
                 np.float32), size=r.shape)
    off[:, 1] *= 1024 * 1024
    l = (r + off).astype(np.float32)
    l[rng.random(l.shape) < 0.05] = -0.0
    l[:, 2] = rng.choice(np.array([0.0, 5.0, 10.0, 11.0, 1000.0],
                                  np.float32), size=len(l))
    want = np.asarray(jax_less_equal(jnp.asarray(l), jnp.asarray(r),
                                     jnp.asarray(EPS), jnp.asarray(SLOT)))
    got = less_equal(torch.from_numpy(l), torch.from_numpy(r),
                     torch.from_numpy(EPS), torch.from_numpy(SLOT)).numpy()
    assert np.array_equal(want, got)
    assert want.any() and not want.all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("R", [2, 3])
def test_node_score_matches(seed, R):
    rng = np.random.default_rng(seed)
    N = 2048
    alloc = _edge_values(rng, (N, R))
    alloc[rng.random(N) < 0.05, 0] = 0.0  # zero-capacity cpu
    alloc[rng.random(N) < 0.05, 1] = 0.0
    frac = rng.random((N, R)).astype(np.float32)
    idle = np.floor(alloc * frac / 1000.0).astype(np.float32) * 1000.0
    over = rng.random(N) < 0.05  # idle above allocatable
    idle[over] = alloc[over] + 4000.0
    idle[rng.random((N, R)) < 0.03] = -0.0
    req = _edge_values(rng, (R,))
    req[0] = float(rng.choice([0.0, 1000.0, 2000.0, 4000.0]))
    bres = rng.choice(np.array([0.0, 1.0, 2.0, 0.5], np.float32), size=R)
    w = dict(
        binpack_weight=float(rng.choice([0.0, 1.0, 3.0])),
        least_req_weight=float(rng.choice([0.0, 1.0, 2.0])),
        most_req_weight=float(rng.choice([0.0, 1.0])),
        balanced_weight=float(rng.choice([0.0, 1.0, 5.0])),
        node_affinity_weight=1.0,
    )
    want = np.asarray(jax_node_score(
        jnp.asarray(req), jnp.asarray(alloc), jnp.asarray(idle),
        JaxWeights(binpack_res=jnp.asarray(bres), **w)))
    got = node_score(torch.from_numpy(req), torch.from_numpy(alloc),
                     torch.from_numpy(idle),
                     ScoreWeights(binpack_res=bres, **w)).numpy()
    assert want.dtype == got.dtype == np.float32
    assert np.array_equal(want, got)


def test_node_score_broadcasts_profiles_against_nodes():
    """[U, 1, R] against [1, N, R] equals the row-by-row score."""
    rng = np.random.default_rng(9)
    alloc = _edge_values(rng, (64, 2)) + 1000.0
    idle = np.floor(alloc * 0.5 / 1000.0).astype(np.float32) * 1000.0
    req = _edge_values(rng, (5, 2))
    w = ScoreWeights(1.0, np.ones(2, np.float32), 1.0, 0.0, 1.0, 1.0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    both = node_score(t(req)[:, None, :], t(alloc)[None], t(idle)[None], w)
    for u in range(5):
        assert torch.equal(both[u], node_score(t(req[u]), t(alloc), t(idle),
                                               w))
