"""The port's cluster generator and encoder against the JAX package's.

``synthetic_cluster`` draws from ``np.random.default_rng(seed)`` in the same
order in both packages, and ``solve_args_from_store`` encodes the snapshot
with the same dictionaries and padding, so every array of the solve args
must be byte-equal (uint32 bit planes travel as int32 tensors in the port:
same bits).
"""

import numpy as np
import pytest

from test_torch_fixtures import tonp

from volcano_tpu.synth import solve_args_from_store as jax_args
from volcano_tpu.synth import synthetic_cluster as jax_cluster

from volcano_tpu_torch.synth import solve_args_from_store as port_args
from volcano_tpu_torch.synth import synthetic_cluster as port_cluster

CASES = [
    dict(n_nodes=24, n_pods=96, gang_size=4, seed=0),
    dict(n_nodes=40, n_pods=200, gang_size=3, n_queues=3, zones=4, seed=1),
    dict(n_nodes=33, n_pods=150, gang_sizes=(1, 2, 8), n_queues=2,
         zones=3, pod_cpu_choices=("500m", "1", "3"), seed=2),
    dict(n_nodes=16, n_pods=64, gang_size=2, n_queues=4,
         queue_weights=(1, 3), seed=3),
]


@pytest.mark.parametrize("kw", CASES)
@pytest.mark.parametrize("flags", [(True, False), (True, True)])
def test_solve_args_byte_equal(kw, flags):
    binpack, nodeorder = flags
    jargs, jmaps = jax_args(jax_cluster(**kw), binpack=binpack,
                            nodeorder=nodeorder)
    targs, tmaps = port_args(port_cluster(**kw), binpack=binpack,
                             nodeorder=nodeorder, device="cpu")
    jargs = tonp(jargs)
    assert tmaps.node_names == jmaps.node_names
    assert tmaps.job_ids == jmaps.job_ids
    assert tmaps.queue_names == jmaps.queue_names
    for gi in (0, 1, 2, 3, 7):
        jg, tg = jargs[gi], targs[gi]
        assert tuple(tg._fields) == tuple(jg._fields)
        for f in jg._fields:
            a = np.asarray(getattr(jg, f))
            b = getattr(tg, f).numpy()
            if a.dtype == np.uint32:
                b = b.view(np.uint32)
            assert a.dtype == b.dtype and a.shape == b.shape, (gi, f)
            assert a.tobytes() == b.tobytes(), (gi, f)
    jw, tw = jargs[4], targs[4]
    for f in jw._fields:
        a, b = getattr(jw, f), getattr(tw, f)
        if f == "binpack_res":
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
        else:
            assert float(a) == float(b), f
    for gi in (5, 6):
        assert np.asarray(jargs[gi]).tobytes() == targs[gi].numpy().tobytes()
