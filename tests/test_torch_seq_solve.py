"""The exact sequential solve: the port's ``ops.allocate.solve`` (its plain
version, on the CPU) against the JAX package's ``ops.allocate.solve`` on
the same inputs.

The stores are built in the JAX package (the inputs of ``test_ops.py``,
``test_affinity.py`` and ``test_oracle_parity.py`` where they fit), encoded
there, and the same numpy arguments go through both solvers.  The port
repeats the JAX step's float32 operations in the same order, so the
tolerance is zero: assignments, pipelines and job flags are identical and
``idle`` / ``q_alloc`` are equal bit for bit.
"""

import numpy as np
import pytest

from test_oracle_parity import _random_store
from test_torch_fixtures import (SEQ_CASES, SEQ_PROFILE_PLANES,
                                 SEQ_RUN_CASES, seq_extra,
                                 seq_plane_variant, seq_profile_reference,
                                 seq_store, tonp)

import volcano_tpu
import volcano_tpu.api
from volcano_tpu.cache import ClusterStore
from volcano_tpu.ops.allocate import SolveQueues
from volcano_tpu.ops.allocate import solve as jax_solve
from volcano_tpu.synth import solve_args_from_store

import torch

import volcano_tpu_torch.ops.allocate as port_allocate
from volcano_tpu_torch.ops import kernels
from volcano_tpu_torch.ops.allocate import LAST_SEQ, seq_inputs, solve


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _check(args, extra_ok=None, extra_score=None):
    """Run both solvers; require identical results.  Returns the JAX
    result."""
    want = jax_solve(*args, extra_ok=extra_ok, extra_score=extra_score)
    got = solve(*args, extra_ok=extra_ok, extra_score=extra_score,
                device="cpu")
    for f in ("assigned", "pipelined", "never_ready", "fit_failed", "idle",
              "q_alloc"):
        np.testing.assert_array_equal(
            _bits(getattr(got, f).numpy()), _bits(getattr(want, f)),
            err_msg=f)
    return want


@pytest.mark.parametrize("what", SEQ_CASES)
def test_seq_solve_matches_jax(what):
    args, _ = solve_args_from_store(seq_store(volcano_tpu, what),
                                    nodeorder=True)
    res = _check(args)
    assert (np.asarray(res.assigned) >= 0).any() or what == "releasing"


@pytest.mark.parametrize("seed", range(6))
def test_seq_solve_random_clusters_match_jax(seed):
    args, _ = solve_args_from_store(_random_store(seed))
    _check(args)
    # The fixture's copy of the generator builds the same solve inputs.
    copy, _ = solve_args_from_store(seq_store(volcano_tpu, "random", seed))
    for a, b in zip(tonp(args), tonp(copy)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", range(6))
def test_seq_solve_affinity_matches_jax(seed):
    args, _ = solve_args_from_store(seq_store(volcano_tpu, "affinity", seed),
                                    nodeorder=True)
    _check(args)


def test_seq_solve_paths_are_exercised():
    """The cases reach what they are named for: a gang discard, a fit
    failure, pipelines, and required terms that read domain -1."""
    def res(name, seed=0):
        args, _ = solve_args_from_store(seq_store(volcano_tpu, name, seed),
                                        nodeorder=True)
        return jax_solve(*args), args

    r, _ = res("gang discard")
    assert np.asarray(r.never_ready).any()
    r, _ = res("fit failure")
    assert np.asarray(r.fit_failed).any()
    r, _ = res("releasing")
    assert (np.asarray(r.pipelined) >= 0).any()
    _, args = res("affinity")
    aff = args[7]
    assert (np.asarray(aff.node_dom) < 0).any()
    assert np.asarray(aff.t_req_aff).any() or np.asarray(
        aff.t_req_anti).any()


def test_seq_solve_overused_queue_matches_jax():
    """Finite deserved shares: queue b fills up mid-solve and its later
    jobs are skipped at their boundary (not reported as discards)."""
    api = volcano_tpu.api
    store = ClusterStore()
    for i in range(4):
        store.add_node(api.Node(name=f"n{i}", allocatable={
            "cpu": "16", "memory": "64Gi"}))
    for q in ("a", "b"):
        store.add_queue(api.Queue(name=q, weight=1))
    for g in range(6):
        store.add_pod_group(api.PodGroup(name=f"g{g}", min_member=2,
                                         queue="ab"[g % 2]))
        for k in range(2):
            store.add_pod(api.Pod(
                name=f"g{g}-{k}", containers=[{"cpu": "3",
                                               "memory": "1Gi"}],
                annotations={api.GROUP_NAME_ANNOTATION: f"g{g}"}))
    args, maps = solve_args_from_store(store)
    queues = args[3]
    deserved = np.full(np.asarray(queues.deserved).shape, 3.0e38,
                       np.float32)
    qb = maps.queue_index["b"]
    deserved[qb, 0] = 7000.0  # b overuses after its second gang
    args = (*args[:3], SolveQueues(deserved=deserved,
                                   allocated=np.asarray(queues.allocated)),
            *args[4:])
    res = _check(args)
    assert (np.asarray(res.assigned) < 0).any()
    assert not np.asarray(res.never_ready).any()


def test_seq_solve_extra_planes_match_jax():
    """Custom-plugin verdicts and scores ([P, N], numpy seed) join the
    mask and the score in the JAX order."""
    args, _ = solve_args_from_store(_random_store(3))
    ok, score = seq_extra(args, 7)
    _check(args, extra_ok=ok)
    _check(args, extra_score=score)
    res = _check(args, extra_ok=ok, extra_score=score)
    plain = jax_solve(*args)
    assert not np.array_equal(np.asarray(res.assigned),
                              np.asarray(plain.assigned))


def test_seq_solve_padded_rows_match_jax():
    """Padded task rows (real False) inside the order close the job before
    them, as the JAX step's job boundary does."""
    args, _ = solve_args_from_store(seq_store(volcano_tpu, "plain fit"))
    tasks = args[1]
    real = np.asarray(tasks.real).copy()
    n_real = int(real.sum())
    assert n_real < real.shape[0]  # the encoder pads P
    real[4] = False
    real[n_real - 1] = False
    args = (args[0], tasks._replace(real=real), *args[2:])
    _check(args)


def test_seq_solve_returns_card_or_cpu_tensors():
    args, _ = solve_args_from_store(seq_store(volcano_tpu, "plain fit"))
    res = solve(*args, device="cpu")
    assert res.assigned.device.type == "cpu"
    assert res.assigned.dtype.is_signed and res.idle.dtype.is_floating_point


@pytest.mark.parametrize("what", ["gang discard", "fit failure",
                                  "releasing", "affinity"])
def test_seq_solve_scored_rows_from_alloc_counts(what, monkeypatch):
    """The rows the solve scored against every node (one ``node_score``
    call each) are the allocated rows of every job, discarded ones too,
    plus the pipelined rows plus one failing row per fit-failed job: the
    count a work bound reads from the result and ``LAST_SEQ``."""
    calls = []
    real_score = port_allocate.node_score

    def counting(*a, **k):
        calls.append(1)
        return real_score(*a, **k)

    monkeypatch.setattr(port_allocate, "node_score", counting)
    args, _ = solve_args_from_store(seq_store(volcano_tpu, what),
                                    nodeorder=True)
    res = solve(*args, device="cpu")
    scored = (int(LAST_SEQ["alloc_cnt"].sum())
              + int((res.pipelined >= 0).sum()) + int(res.fit_failed.sum()))
    assert scored == len(calls) > 0
    # The rows still assigned undercount a discarded job's work.
    if what == "gang discard":
        kept = int((res.assigned >= 0).sum()) + int(
            (res.pipelined >= 0).sum()) + int(res.fit_failed.sum())
        assert kept < scored


@pytest.mark.parametrize("what", SEQ_RUN_CASES)
def test_seq_solve_equal_row_runs_match_jax(what):
    """Runs of equal rows: across jobs with a gang rolled back mid-run,
    alternating, around term-reading rows, past the card kernel's profile
    cap."""
    args, _ = solve_args_from_store(seq_store(volcano_tpu, what),
                                    nodeorder=True)
    res = _check(args)
    assert (np.asarray(res.assigned) >= 0).any()


def test_seq_run_cases_reach_what_they_are_named_for():
    """"profile runs" rolls a gang back and gives its nodes to the next
    gang of the same profile; "terms between runs" has term-reading rows
    between two runs of one profile and profiled rows that match a term;
    "many profiles" has more distinct rows than the cap; the scalar cases
    have 3 and 6 resource slots."""
    def res(name):
        args, _ = solve_args_from_store(seq_store(volcano_tpu, name),
                                        nodeorder=True)
        return jax_solve(*args), args

    r, args = res("profile runs")
    nr = np.asarray(r.never_ready)
    assert nr.any()
    job = np.asarray(args[1].job)
    real = np.asarray(args[1].real)
    discarded = int(np.flatnonzero(nr)[0])
    nxt = np.asarray(r.assigned)[real & (job == discarded + 1)]
    assert (nxt >= 0).all() and len(nxt) > 0
    req = np.asarray(args[1].req)[real]
    assert (req == req[0]).all()

    _, args = res("terms between runs")
    aff = args[7]
    reads = (np.asarray(aff.t_req_aff) | np.asarray(aff.t_req_anti)
             | (np.asarray(aff.t_soft) != 0)).any(axis=1)
    matches = np.asarray(aff.t_matches).any(axis=1)
    real = np.asarray(args[1].real)
    assert (reads & real).any() and (matches & ~reads & real).any()
    first = int(np.flatnonzero(reads & real)[0])
    assert (~reads[:first] & real[:first]).any()
    assert (~reads[first:] & real[first:]).any()

    _, args = res("many profiles")
    req = np.asarray(args[1].req)[np.asarray(args[1].real)]
    assert len(np.unique(req, axis=0)) > kernels.SEQ_MAX_PROFILES

    for name, R in (("scalar resources", 3), ("many scalar resources", 6)):
        r, args = res(name)
        assert np.asarray(args[0].idle).shape[1] == R
        assert (np.asarray(r.assigned) >= 0).any()


@pytest.mark.parametrize("what,seed", [(n, 0) for n in SEQ_RUN_CASES]
                         + [("random", s) for s in range(3)]
                         + [("affinity", s) for s in range(2)])
def test_seq_profiles_equal_numpy_row_equality(what, seed):
    """The plain profile pass (``kernels.seq_profiles``) against numpy:
    two rows share a profile only when every plane the node loop reads
    is equal, term-reading rows have none, and ids follow the heads'
    order up to the cap."""
    args, _ = solve_args_from_store(seq_store(volcano_tpu, what, seed),
                                    nodeorder=True)
    x = seq_inputs(*tonp(args)[:8], None, None, torch.device("cpu"))
    got = kernels.seq_profiles(x).numpy()
    np.testing.assert_array_equal(
        got, seq_profile_reference(x, kernels.SEQ_MAX_PROFILES))
    words = kernels._seq_profile_words(x).numpy()
    for u in np.unique(got[got >= 0]):
        rows = words[got == u]
        assert (rows == rows[0]).all()


@pytest.mark.parametrize("plane", SEQ_PROFILE_PLANES)
def test_seq_profiles_split_rows_that_differ_in_one_plane(plane):
    """Two equal profiled rows of a run, then one of them changed in a
    single plane the node loop reads: the plain profile pass gives them
    different profiles, as the numpy reference over the planes listed in
    the test fixtures does."""
    args, _ = solve_args_from_store(seq_store(volcano_tpu, "profile runs"),
                                    nodeorder=True)
    x = seq_inputs(*tonp(args)[:8], None, None, torch.device("cpu"))
    y, t = seq_plane_variant(x, plane)
    got = kernels.seq_profiles(y).numpy()
    np.testing.assert_array_equal(
        got, seq_profile_reference(y, kernels.SEQ_MAX_PROFILES))
    assert got[t] >= 0 and got[t - 1] >= 0 and got[t] != got[t - 1]
