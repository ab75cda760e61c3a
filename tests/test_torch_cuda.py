"""The port's CUDA kernels on the card against the plain versions.

Marked ``cuda``: each test asks its fixture for a card and skips without
one (the CPU tests cover the plain versions against the JAX package).  On a
machine with a card (``--noconftest``: tests/conftest.py imports JAX,
which such a machine need not have):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from test_torch_fixtures import feature_store, one_node_gang

import volcano_tpu_torch
from volcano_tpu_torch import interop
from volcano_tpu_torch.ops import kernels
from volcano_tpu_torch.ops.wave import solve_wave
from volcano_tpu_torch.synth import solve_args_from_store, synthetic_cluster

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _solve_three_ways(store, wave):
    """(kernels on the card, plain versions on the card, CPU) results."""
    a_gpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True)
    a_cpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True,
                                     device="cpu")
    kernels.reset_launches()
    k = interop.result_to_numpy(solve_wave(*a_gpu, wave=wave))
    launched = dict(kernels.LAUNCHES)
    p = interop.result_to_numpy(solve_wave(*a_gpu, wave=wave, plain=True))
    c = interop.result_to_numpy(solve_wave(*a_cpu, wave=wave, device="cpu"))
    return k, p, c, launched


def _same(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("make,wave", [
    (lambda: synthetic_cluster(n_nodes=64, n_pods=512, gang_size=4,
                               n_queues=2, zones=4, seed=1), 128),
    (lambda: feature_store(volcano_tpu_torch, 96, 700, seed=2), 128),
    (lambda: one_node_gang(volcano_tpu_torch, cpu="4"), 8),
])
def test_card_solve_equals_plain_and_cpu(cuda, make, wave):
    k, p, c, launched = _solve_three_ways(make(), wave)
    _same(k, p)
    _same(k, c)
    assert all(v > 0 for v in launched.values()), launched


def test_rank_candidates_without_rows_launches_nothing(cuda):
    """An empty row list returns empty outputs and counts no launch."""
    N, R, UM, C, K = 16, 3, 4, 2, 4

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=cuda)

    i32 = torch.int32
    kernels.reset_launches()
    ranked, feas_k, p_any = kernels.rank_candidates(
        z(0, dtype=i32), None, z(UM, C, dtype=torch.bool), z(UM, C),
        z(N, dtype=i32), z(UM, R), z(UM, R), z(N, R), z(N, R),
        z(N, dtype=i32), z(N, dtype=i32), z(R), z(R, dtype=torch.bool),
        None, K)
    assert ranked.shape == (0, K) and ranked.dtype == i32
    assert feas_k.shape == (0, K) and feas_k.dtype == torch.bool
    assert p_any.shape == (0,)
    assert kernels.LAUNCHES["rank_candidates"] == 0
