"""The port's host prep of the wave solve against the JAX package's.

The numpy half of ``ops/wave.py`` (lines 2316-2673) is copied into the port;
on the same inputs every prepared array must be byte-equal: task padding,
profile dedup with its first-occurrence ``pid`` numbering, profile-row
padding, the per-wave profile lists, the affinity term windows, and the
node classes.  The port's per-task wave indices (``_wave_host_index``) are
held against the JAX kernel's own formulas.
"""

import numpy as np
import pytest

from test_torch_fixtures import feature_store, tonp

import volcano_tpu
import volcano_tpu.ops.wave as jw
from volcano_tpu.synth import solve_args_from_store as jax_args
from volcano_tpu.synth import synthetic_cluster as jax_cluster

import volcano_tpu_torch.ops.wave as tw
from volcano_tpu_torch import interop


def _eq_tree(a, b):
    assert type(a).__name__ == type(b).__name__
    assert tuple(a._fields) == tuple(b._fields)
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def _cases():
    return [
        (jax_args(jax_cluster(n_nodes=40, n_pods=300, gang_size=3,
                              n_queues=2, zones=4, seed=4))[0], 64),
        (jax_args(feature_store(volcano_tpu, n_nodes=48, n_pods=333,
                                seed=6))[0], 128),
        (jax_args(jax_cluster(n_nodes=16, n_pods=200, gang_size=5,
                              spread_fraction=0.5, zones=2, seed=8))[0], 64),
    ]


@pytest.mark.parametrize("case", range(3))
def test_host_prep_byte_equal(case):
    args, wave = _cases()[case]
    jn = tonp(args)
    tn = interop.solve_args_from_numpy(jn)
    nodes_j, tasks_j, _jobs, _q, _w, _e, _s, aff_j = jn
    nodes_t, tasks_t, aff_t = tn[0], tn[1], tn[7]
    P = tasks_j.job.shape[0]
    pad = (-P) % wave
    tasks_j2, tasks_t2 = jw._pad_tasks(tasks_j, pad), tw._pad_tasks(tasks_t,
                                                                    pad)
    _eq_tree(tasks_j2, tasks_t2)
    aff_j2, aff_t2 = jw._pad_aff(aff_j, pad), tw._pad_aff(aff_t, pad)
    _eq_tree(aff_j2, aff_t2)
    pj, pid_j, _, _ = jw._profile_tasks(tasks_j2, aff_j2)
    pt, pid_t, _, _ = tw._profile_tasks(tasks_t2, aff_t2)
    assert pid_j.dtype == pid_t.dtype and np.array_equal(pid_j, pid_t)
    # first-occurrence numbering: each profile first appears in id order
    _, first = np.unique(pid_t, return_index=True)
    assert np.all(np.diff(first) > 0)
    _eq_tree(pj, pt)
    pj, pt = jw._pad_profiles_rows(pj), tw._pad_profiles_rows(pt)
    _eq_tree(pj, pt)
    n_waves = (P + pad) // wave
    wp_j = jw._wave_profiles(pid_j, n_waves, wave)
    wp_t = tw._wave_profiles(pid_t, n_waves, wave)
    assert wp_j.dtype == wp_t.dtype and np.array_equal(wp_j, wp_t)
    tj = jw._term_windows(pj, aff_j2, pid_j, wp_j, n_waves)
    tt = tw._term_windows(pt, aff_t2, pid_t, wp_t, n_waves)
    _eq_tree(tj[0], tt[0])
    _eq_tree(tj[1], tt[1])
    for x, y in zip(tj[2:], tt[2:]):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    # profiles given as caller ids renumber the same way
    fj, qj = jw._profiles_from_pid(tasks_j2, aff_j2, pid_j[::-1].copy())
    ft, qt = tw._profiles_from_pid(tasks_t2, aff_t2, pid_t[::-1].copy())
    _eq_tree(fj, ft)
    assert np.array_equal(qj, qt)
    jw._host_node_classes._cache = None
    tw._host_node_classes._cache = None
    _eq_tree(jw._host_node_classes(nodes_j), tw._host_node_classes(nodes_t))


@pytest.mark.parametrize("n", [0, 1, 7, 63, 64, 100, 1000])
def test_bucket_pow2_and_shortlist_size_match(n):
    assert jw.bucket_pow2(n, floor=64) == tw.bucket_pow2(n, floor=64)
    assert jw.bucket_pow2(n, 16, 4) == tw.bucket_pow2(n, 16, 4)
    if n:
        assert jw.shortlist_size(n) == tw.shortlist_size(n)


def test_wave_host_index_matches_kernel_formulas():
    """jlo / jw / pid_l / queue per task, as _solve_wave computes them on
    device (wave.py:1032-1057), from the same prepared arrays."""
    args, wave = _cases()[1]
    tasks, jobs = tonp(args)[1], tonp(args)[2]
    P = tasks.job.shape[0]
    profiles, pid, _, _ = tw._profile_tasks(tasks, tonp(args)[7])
    wp = tw._wave_profiles(pid, P // wave, wave)
    J = jobs.min_available.shape[0]
    tjob, queue_p, jlo, jwin, pid_l, qidx = tw._wave_host_index(
        tasks.job, tasks.real, pid.astype(np.int64), wp, jobs.queue, J, wave)
    for w in range(P // wave):
        sl = slice(w * wave, (w + 1) * wave)
        jraw = np.where(tasks.real[sl], tasks.job[sl], J)
        lo = np.min(np.where(tasks.real[sl], jraw, J))
        assert jlo[w] == lo
        assert np.array_equal(jwin[sl], np.clip(jraw - lo, 0, wave - 1))
        ref = np.argmax(pid[sl][:, None] == wp[w][None, :], axis=1)
        assert np.array_equal(pid_l[sl], ref)
        queue_l = queue_p[lo:lo + wave]
        assert np.array_equal(qidx[sl], queue_l[jwin[sl]])
