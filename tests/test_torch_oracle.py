"""The port's allocate oracle (``volcano_tpu_torch/oracle.py``).

(a) The twins of ``tests/test_oracle_parity.py`` on the port: the port's
    sequential solve (``ops.allocate.solve`` on the CPU, the plain version
    of ``seq_solve``) against the port's NumPy oracle, on the same stores
    (``test_torch_fixtures.seq_store(pkg, "random", seed)`` is that file's
    ``_random_store``), with the same comparisons and invariants.
(b) The port's oracle against the JAX package's on the same numpy inputs,
    for each of its nine entry points: the outputs must be equal, exactly
    (the oracle is NumPy in both packages, with the same arithmetic).
"""

import numpy as np
import pytest

import volcano_tpu_torch
from test_torch_fixtures import seq_store, tonp
from volcano_tpu_torch import oracle as port_oracle
from volcano_tpu_torch.interop import result_to_numpy
from volcano_tpu_torch.ops.allocate import solve
from volcano_tpu_torch.synth import solve_args_from_store, synthetic_cluster


def _args(store):
    args, maps = solve_args_from_store(store, device="cpu")
    return args, maps


def _compare(args):
    got = result_to_numpy(solve(*args, device="cpu"))
    want = port_oracle.solve_oracle(*tonp(args))
    np.testing.assert_array_equal(got.assigned, want.assigned)
    np.testing.assert_array_equal(got.pipelined, want.pipelined)
    np.testing.assert_array_equal(got.never_ready.astype(bool),
                                  want.never_ready)
    np.testing.assert_array_equal(got.fit_failed.astype(bool),
                                  want.fit_failed)
    np.testing.assert_allclose(got.idle, want.idle, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got.q_alloc, want.q_alloc, rtol=1e-5,
                               atol=1e-2)
    return got, want


@pytest.mark.parametrize("seed", range(12))
def test_parity_random_clusters(seed):
    args, _ = _args(seq_store(volcano_tpu_torch, "random", seed))
    _compare(args)


@pytest.mark.parametrize("seed", [0, 1])
def test_parity_synthetic_uniform(seed):
    store = synthetic_cluster(n_nodes=32, n_pods=96, gang_size=3,
                              n_queues=2, seed=seed)
    _compare(_args(store)[0])


def test_parity_oversubscribed_gangs():
    """Cluster too small for all gangs: discard paths must agree."""
    store = synthetic_cluster(
        n_nodes=4, n_pods=64, gang_size=8,
        pod_cpu_choices=("8", "16"), pod_mem_choices=("16Gi", "32Gi"),
    )
    got, _want = _compare(_args(store)[0])
    assert got.never_ready.any() or got.fit_failed.any()


@pytest.mark.parametrize("seed", range(6))
def test_invariants(seed):
    args, _ = _args(seq_store(volcano_tpu_torch, "random", seed))
    res = result_to_numpy(solve(*args, device="cpu"))
    s_nodes, s_tasks, s_jobs = tonp(args[0]), tonp(args[1]), tonp(args[2])
    assigned = res.assigned
    idle0 = s_nodes.idle
    req = s_tasks.req
    expect = idle0.copy()
    for t, n in enumerate(assigned):
        if n >= 0:
            expect[n] -= req[t]
    np.testing.assert_allclose(res.idle, expect, rtol=1e-5, atol=1e-2)
    J = s_jobs.min_available.shape[0]
    counts = np.zeros((J,), int)
    for t, n in enumerate(assigned):
        if n >= 0 and s_tasks.real[t]:
            counts[s_tasks.job[t]] += 1
    for j in range(J):
        if counts[j] > 0:
            assert counts[j] + s_jobs.ready_base[j] >= \
                s_jobs.min_available[j]
    assert (res.idle >= -1e-2 * max(1, len(assigned))).all()


# ------------------------------------------- (b) the port against JAX


def _jax_oracle():
    import volcano_tpu.oracle

    return volcano_tpu.oracle


def _solve_case(rng, seed):
    import volcano_tpu
    import volcano_tpu.api
    import volcano_tpu.cache
    from volcano_tpu.synth import solve_args_from_store as jax_args

    args, _ = jax_args(seq_store(volcano_tpu, "random", seed))
    return tonp(args), {}


def _victims_case(rng, seed):
    V, R = 12, 3
    return ([rng.uniform(0, 9000), 0.0, rng.uniform(0, 3)],
            [rng.uniform(0, 3000), 0.0, 0.0],
            rng.uniform(0, 2500, (V, R)).astype(np.float32),
            rng.integers(0, 4, V),
            np.full(R, 10.0, np.float32),
            np.array([False, False, True])), {}


def _gang_case(rng, seed):
    J = 6
    return (rng.integers(1, 4, J), rng.integers(0, 5, J),
            rng.integers(0, J, 20)), {}


def _enqueue_case(rng, seed):
    G, Q, R = 10, 3, 2
    min_res = rng.uniform(0, 4, (G, R)).astype(np.float32)
    min_res[rng.random(G) < 0.2] = np.nan
    caps = rng.uniform(2, 12, (Q, R)).astype(np.float32)
    caps[0] = np.inf
    return (min_res, rng.integers(0, Q, G), rng.permutation(G),
            rng.uniform(4, 20, R).astype(np.float32), caps,
            rng.uniform(0, 3, (Q, R)).astype(np.float32),
            np.full(R, 1e-3, np.float32), np.array([False, True])), {}


def _rebalance_case(rng, seed):
    N, R, U = 24, 3, 2
    alloc = rng.uniform(2.0, 8.0, size=(N, R)).astype(np.float32)
    idle = (alloc * rng.uniform(0.0, 1.0, size=(N, R))).astype(np.float32)
    ev = (idle * rng.uniform(0.0, 1.5, size=(N, R))).astype(np.float32)
    ready = rng.random(N) > 0.1
    prof_req = rng.uniform(0.5, 6.0, size=(U, R)).astype(np.float32)
    prof_req[rng.random((U, R)) < 0.3] = 0.0
    eps = np.full(R, 1e-3, np.float32)
    victims_by_node = [[n * 10 + k for k in range(int(rng.integers(0, 3)))]
                       for n in range(N)]
    victim_group = {r: f"g{r % 5}" for rows in victims_by_node
                    for r in rows}
    budget_left = {f"g{i}": int(rng.integers(0, 4)) for i in range(5)}
    return (idle, alloc, ready, ev, prof_req, eps, int(rng.integers(1, 6)),
            victims_by_node, victim_group, budget_left,
            int(rng.integers(1, N))), {}


def _topology_case(rng, seed):
    N, R, U = 40, 3, 3
    B = int(rng.integers(2, 7))
    prof_req = rng.uniform(0.5, 4.0, size=(U, R)).astype(np.float32)
    prof_req[rng.random((U, R)) < 0.3] = 0.0
    return (rng.uniform(0.0, 8.0, size=(N, R)).astype(np.float32),
            rng.random(N) > 0.15,
            rng.integers(0, 6, size=N).astype(np.int32),
            np.where(rng.random(N) < 0.5, rng.integers(1, 8, size=N),
                     0).astype(np.int32),
            rng.integers(-1, B, size=N).astype(np.int32), prof_req,
            rng.integers(0, 9, size=U).astype(np.int32),
            np.full(R, 1e-3, np.float32), bool(seed % 2)), {}


def _backfill_case(rng, seed):
    T, N, G = 9, 7, 3
    return (rng.random((T, N)) < 0.3, rng.random(G) < 0.7,
            rng.integers(0, G, T)), {}


def _wave_case(rng, seed):
    V, N, Q, R, U, J = 32, 8, 4, 3, 2, 6
    q_des = rng.uniform(1.0, 6.0, (Q, R)).astype(np.float32)
    q_des[rng.random((Q, R)) < 0.3] = 3.0e38
    v_req = rng.uniform(0.0, 3.0, (V, R)).astype(np.float32)
    v_req[rng.random((V, R)) < 0.2] = 0.0
    prof_req = rng.uniform(0.5, 4.0, (U, R)).astype(np.float32)
    prof_req[rng.random((U, R)) < 0.3] = 0.0
    v_job = rng.integers(0, J, V).astype(np.int64)
    return (rng.random(V) > 0.2, rng.integers(0, 4, V).astype(np.int32),
            np.argsort(np.argsort(rng.random(V))).astype(np.int32),
            np.arange(V, dtype=np.int32),
            rng.integers(0, Q, V).astype(np.int32),
            rng.integers(0, N, V).astype(np.int32), v_req,
            np.int32(rng.integers(1, 5)), np.int32(rng.integers(0, Q)),
            rng.uniform(0.0, 8.0, (Q, R)).astype(np.float32), q_des,
            rng.random(Q) > 0.3,
            rng.uniform(0.0, 4.0, (N, R)).astype(np.float32), prof_req,
            np.full(R, 1e-3, np.float32), int(rng.integers(1, 5)), v_job,
            [f"g{j % 4}" for j in v_job],
            rng.integers(0, 4, J).astype(np.int64),
            rng.integers(1, 3, J).astype(np.int64),
            {f"g{i}": int(rng.integers(0, 5)) for i in range(4)},
            int(rng.integers(1, V))), {}


ENTRIES = {
    "solve_oracle": _solve_case,
    "oracle_victims": _victims_case,
    "oracle_gang_protection": _gang_case,
    "oracle_enqueue": _enqueue_case,
    "oracle_rebalance": _rebalance_case,
    "oracle_topology": _topology_case,
    "oracle_backfill": _backfill_case,
    "oracle_preempt": _wave_case,
    "oracle_reclaim": _wave_case,
}


def _equal(a, b, where):
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        assert type(b).__name__ == type(a).__name__, where
        assert a._fields == b._fields, where
        for f in a._fields:
            _equal(getattr(a, f), getattr(b, f), f"{where}.{f}")
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.dtype == y.dtype and x.shape == y.shape, where
    assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), where


def _copy(v):
    """A fresh copy of a case's inputs (an oracle may update a dict)."""
    if isinstance(v, dict):
        return {k: _copy(x) for k, x in v.items()}
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*[_copy(x) for x in v])
    if isinstance(v, (list, tuple)):
        return type(v)(_copy(x) for x in v)
    if isinstance(v, np.ndarray):
        return v.copy()
    return v


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_oracle_equals_jax_oracle(entry, seed):
    jo = _jax_oracle()
    rng = np.random.default_rng(1000 * seed + len(entry))
    args, kw = ENTRIES[entry](rng, seed)
    want = getattr(jo, entry)(*_copy(args), **_copy(kw))
    got = getattr(port_oracle, entry)(*_copy(args), **_copy(kw))
    _equal(want, got, entry)


def test_oracle_takes_the_ports_tensors():
    """The port's CPU solve args (int32 bit words) give the oracle the
    result the JAX args (uint32 words) give it."""
    import volcano_tpu
    import volcano_tpu.api
    import volcano_tpu.cache
    from volcano_tpu.synth import solve_args_from_store as jax_args

    jargs, _ = jax_args(seq_store(volcano_tpu, "random", 3))
    pargs, _ = _args(seq_store(volcano_tpu_torch, "random", 3))
    _equal(_jax_oracle().solve_oracle(*tonp(jargs)),
           port_oracle.solve_oracle(*pargs), "solve_oracle")
