"""solve_wave with custom-plugin planes (``extra_ok`` / ``extra_score``):
the port against the JAX package on the CPU.

The planes are what the object session's allocate action hands the solve
for out-of-tree predicate and node-order plugins: [P, N] verdicts and
scores.  They are made with numpy from a seed, with vetoes and with
integer scores that tie, and go with the same solve args through JAX
``solve_wave`` and the port's ``solve_wave(device="cpu")`` (the plain
versions of ``coarse_shortlist`` and ``rank_candidates``).  Compared bit
for bit as in ``test_torch_wave.py``.
"""

import numpy as np
import pytest

from test_torch_fixtures import feature_store, tonp
from test_torch_wave import FIELDS, _assert_equal

import volcano_tpu
from volcano_tpu.ops.wave import solve_wave as jax_solve_wave
from volcano_tpu.synth import solve_args_from_store as jax_args
from volcano_tpu.synth import synthetic_cluster as jax_cluster

from volcano_tpu_torch import interop
from volcano_tpu_torch.ops import wave as port_wave
from volcano_tpu_torch.ops.wave import solve_wave as port_solve_wave


def _planes(args, seed, veto=0.3, rows="job"):
    """[P, N] verdicts (``veto`` of them False) and integer scores in
    [-3, 3] (many ties); one row per job, per task, or one row for all
    tasks (``rows``), so profiles split as far as that."""
    tasks = args[1]
    P = np.asarray(tasks.req).shape[0]
    N = np.asarray(args[0].idle).shape[0]
    rng = np.random.default_rng(seed)
    key = {"job": np.asarray(tasks.job), "task": np.arange(P),
           "one": np.zeros(P, np.int64)}[rows]
    uniq, inv = np.unique(key, return_inverse=True)
    ok = rng.random((len(uniq), N)) >= veto
    score = rng.integers(-3, 4, (len(uniq), N)).astype(np.float32)
    return ok[inv], score[inv]


def _both(args, wave, **extra):
    jr = tonp(jax_solve_wave(*args, wave=wave, **extra))
    targs = interop.solve_args_from_numpy(tonp(args))
    tr = interop.result_to_numpy(
        port_solve_wave(*targs, wave=wave, device="cpu", **extra))
    return jr, tr


@pytest.mark.parametrize("which", ["ok", "score", "both"])
@pytest.mark.parametrize("seed", [0, 1])
def test_extra_planes_match_jax(which, seed):
    store = jax_cluster(n_nodes=48, n_pods=192, gang_size=4, n_queues=2,
                        seed=seed)
    args, _ = jax_args(store)
    ok, score = _planes(args, seed)
    extra = {}
    if which in ("ok", "both"):
        extra["extra_ok"] = ok
    if which in ("score", "both"):
        extra["extra_score"] = score
    jr, tr = _both(args, 64, **extra)
    _assert_equal(jr, tr)
    # The planes change the placement, and no bind lands on a vetoed node.
    plain = tonp(jax_solve_wave(*args, wave=64))
    assert not np.array_equal(jr.assigned, plain.assigned)
    a = np.asarray(tr.assigned).astype(np.int64)
    if "extra_ok" in extra:
        rows = np.nonzero(a >= 0)[0]
        assert ok[rows, a[rows]].all()


@pytest.mark.parametrize("nodeclass", ["1", "0"])
def test_extra_planes_with_features_match_jax(monkeypatch, nodeclass):
    """Taints, selectors and node affinity (class-compacted or identity
    classes), per-task rows (every task its own profile)."""
    for mod in (volcano_tpu.ops.wave, port_wave):
        monkeypatch.setattr(mod, "_nodeclass_on", lambda v=nodeclass:
                            v == "1")
    args, _ = jax_args(feature_store(volcano_tpu))
    ok, score = _planes(args, 5, veto=0.2, rows="task")
    jr, tr = _both(args, 32, extra_ok=ok, extra_score=score)
    _assert_equal(jr, tr)


def test_extra_planes_with_shortlist_exhaustion_match_jax(monkeypatch):
    """A shortlist of 8 of 64 nodes runs dry under vetoes: the full-N
    fallback ranking reads the planes too."""
    monkeypatch.setenv("VOLCANO_TPU_TOPK", "8")
    args, _ = jax_args(jax_cluster(n_nodes=64, n_pods=512, gang_size=4,
                                   seed=1))
    ok, score = _planes(args, 9, veto=0.4, rows="one")
    jr, tr = _both(args, 128, extra_ok=ok, extra_score=score)
    _assert_equal(jr, tr)
    assert int(tr.fb_exhausted) > 0


def test_extra_planes_refused_with_given_profiles():
    args, _ = jax_args(jax_cluster(n_nodes=8, n_pods=16, seed=0))
    targs = interop.solve_args_from_numpy(tonp(args))
    P = np.asarray(args[1].req).shape[0]
    with pytest.raises(ValueError, match="in-call profile"):
        port_solve_wave(*targs, pid=np.zeros(P, np.int32),
                        extra_ok=np.ones((P, 8), bool), device="cpu")


def test_fields_cover_the_result():
    assert set(FIELDS) <= set(port_wave.AllocResult._fields)
