"""The port's solve with releasing capacity against the JAX package's.

The JAX ``_solve_wave`` runs its ``has_future`` branch whenever a node has
releasing (or pipelined) capacity: fits read FutureIdle = ((idle +
releasing) - pipelined) - pip_extra, a task that fits only the future idle
is accepted as pipelined and charges ``pip_extra`` / ``pip_ntasks`` /
``q_pip``, readiness counts allocations only, the gang discard leaves
pipelined rows alone, and queue overuse gates on ``q_alloc + q_pip``.

The same solve args go through the JAX ``solve_wave`` (jit on the CPU) and
the port's ``solve_wave(device="cpu")`` (the kernels' plain versions).
Compared bit for bit: ``assigned``, ``pipelined``, ``never_ready``,
``fit_failed``, ``idle``, ``q_alloc``, ``iters`` and the fallback counters.
Exact equality is the right tolerance: every request and every releasing
value is an integer multiple of 1000 milli-CPU, of 1 GiB or (the
non-power-of-two memory case) of 1,000,000 bytes, and every partial sum
stays below 2^24 such quanta, so each float32 sum is exact whatever order
either side adds in.
"""

import numpy as np
import pytest
import torch

from test_torch_fixtures import one_node_gang, tonp

import volcano_tpu
from volcano_tpu.ops.wave import solve_wave as jax_solve_wave
from volcano_tpu.synth import solve_args_from_store as jax_args
from volcano_tpu.synth import synthetic_cluster as jax_cluster

from volcano_tpu_torch import interop
from volcano_tpu_torch.ops import kernels
from volcano_tpu_torch.ops.wave import LAST_TWOPHASE
from volcano_tpu_torch.ops.wave import solve_wave as port_solve_wave

FIELDS = ("assigned", "pipelined", "never_ready", "fit_failed", "idle",
          "q_alloc", "iters", "fb_exhausted", "fb_affinity")
GI = float(2 ** 30)


def _both(args, wave):
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


def _with_nodes(args, **planes):
    nodes = tonp(args[0])
    return (nodes._replace(**{k: np.asarray(v, np.float32)
                              for k, v in planes.items()}),) + args[1:]


def _with_deserved(args, rows):
    q = args[3]
    des = np.array(q.deserved, np.float32)
    for i, row in enumerate(rows):
        des[i] = row
    return args[:3] + (q._replace(deserved=des),) + args[4:]


def _drained(args, rng, mem_quantum=GI):
    """Move a random part of every node's idle capacity to releasing, in
    whole quanta (1000 milli-CPU and ``mem_quantum`` bytes)."""
    nodes = tonp(args[0])
    idle = np.array(nodes.idle, np.float32)
    q = np.array([1000.0, mem_quantum] + [1.0] * (idle.shape[1] - 2),
                 np.float32)
    units = np.floor(idle / q)
    moved = np.floor(units * rng.uniform(0.0, 1.0, units.shape))
    moved[rng.rand(idle.shape[0]) < 0.3] = 0.0  # some nodes release none
    rel = (moved * q).astype(np.float32)
    return _with_nodes(args, idle=idle - rel, releasing=rel,
                       pipelined=np.zeros_like(idle))


@pytest.mark.parametrize("seed", range(4))
def test_random_releasing_planes_match(seed):
    """Random non-zero releasing planes on synthetic clusters: some tasks
    fit the live idle, some only the future idle."""
    rng = np.random.RandomState(seed)
    store = jax_cluster(n_nodes=int(rng.randint(16, 48)),
                        n_pods=int(rng.randint(96, 320)),
                        gang_size=int(rng.randint(1, 5)),
                        n_queues=int(rng.randint(1, 3)), seed=seed)
    args, _ = jax_args(store)
    args = _drained(args, rng)
    jr, tr = _both(args, 64)
    _assert_equal(jr, tr)
    assert LAST_TWOPHASE["enabled"]
    assert (tr.pipelined >= 0).any(), "no task was pipelined"
    assert (tr.assigned >= 0).any(), "no task was allocated"


def test_non_power_of_two_memory_releasing_matches():
    """Releasing memory in multiples of 10^6 bytes (not a power of two)."""
    rng = np.random.RandomState(11)
    args, _ = jax_args(jax_cluster(n_nodes=32, n_pods=256, gang_size=2,
                                   seed=4))
    args = _drained(args, rng, mem_quantum=1.0e6)
    jr, tr = _both(args, 64)
    _assert_equal(jr, tr)
    assert (tr.pipelined >= 0).any()


def test_gang_fits_only_on_releasing_capacity():
    """A node with no idle capacity and all of it releasing: the gang of
    two 1-CPU tasks is pipelined whole, allocated nowhere, never ready."""
    store = one_node_gang(volcano_tpu, cpu="8", replicas=2, min_member=2)
    args, _ = jax_args(store)
    nodes = tonp(args[0])
    idle = np.array(nodes.idle, np.float32)
    rel = idle.copy()
    idle[:] = 0.0
    args = _with_nodes(args, idle=idle, releasing=rel,
                       pipelined=np.zeros_like(idle))
    jr, tr = _both(args, 8)
    _assert_equal(jr, tr)
    real = np.asarray(args[1].real)
    assert (tr.pipelined[real] == 0).all()
    assert (tr.assigned[real] == -1).all()
    assert tr.never_ready[0]
    assert np.array_equal(tr.idle, idle)


def test_discarded_gang_keeps_pipelined_members():
    """Idle fits 2 of a min-4 gang and releasing 2 more: 2 allocated and 2
    pipelined, the gang is never ready, the discard gives the 2
    allocations back and leaves the 2 pipelined rows."""
    store = one_node_gang(volcano_tpu, cpu="4", replicas=4, min_member=4)
    args, _ = jax_args(store)
    nodes = tonp(args[0])
    idle = np.array(nodes.idle, np.float32)
    rel = np.zeros_like(idle)
    idle[0, 0] = 2000.0
    rel[0, 0] = 2000.0
    args = _with_nodes(args, idle=idle, releasing=rel,
                       pipelined=np.zeros_like(idle))
    jr, tr = _both(args, 8)
    _assert_equal(jr, tr)
    real = np.asarray(args[1].real)
    assert int((tr.pipelined[real] >= 0).sum()) == 2
    assert int((tr.assigned[real] >= 0).sum()) == 0
    assert tr.never_ready[0]
    assert np.array_equal(tr.idle, idle)


def test_queue_gated_by_pipelined_charge():
    """Finite deserved shares and releasing capacity: pipelined tasks
    charge q_pip, and the overuse gate reads q_alloc + q_pip, so later jobs
    of the queue are skipped for overuse."""
    args, _ = jax_args(jax_cluster(n_nodes=16, n_pods=256, gang_size=4,
                                   n_queues=2, seed=5))
    nodes = tonp(args[0])
    idle = np.array(nodes.idle, np.float32)
    rel = np.zeros_like(idle)
    rel[:, 0] = np.floor(idle[:, 0] / 2000.0) * 1000.0
    rel[:, 1] = np.floor(idle[:, 1] / (2 * GI)) * GI
    args = _with_nodes(args, idle=idle - rel, releasing=rel,
                       pipelined=np.zeros_like(idle))
    args = _with_deserved(args, [[20000.0, 80 * GI], [12000.0, 48 * GI]])
    jr, tr = _both(args, 64)
    _assert_equal(jr, tr)
    assert (tr.pipelined >= 0).any()
    placed = int((tr.assigned >= 0).sum()) + int((tr.pipelined >= 0).sum())
    assert 0 < placed < 256
    # The pipelined charge is in the returned queue allocation.
    q0 = np.asarray(args[3].allocated)
    assert (tr.q_alloc[:2, 0] > q0[:2, 0]).all()


def test_future_idle_order_of_operations():
    """FutureIdle rounds left to right: ((idle + releasing) - pipelined) -
    pip_extra; another association gives other bits on these values."""
    idle = np.float32([1.0e8])  # ulp 8
    rel = np.float32([5.0])
    pip = np.float32([2.0])
    fut = kernels.future_idle(
        torch.tensor(idle), kernels.Future(torch.tensor(rel),
                                           torch.tensor(pip),
                                           torch.tensor(np.float32([1.0]))))
    want = ((idle + rel) - pip) - np.float32(1.0)
    assert fut.numpy().tobytes() == want.tobytes()
    assert want[0] != idle[0] + (rel[0] - pip[0] - np.float32(1.0))
