"""Phase 1 of the two-phase solve: the port's plain ``_coarse_shortlist``
against the JAX package's jitted ``_coarse_shortlist`` on identical
prepared inputs.

The [U, S] shortlists (ascending node ids of each profile's top-S by score
descending, node id ascending) must be identical, with compacted and with
identity node classes, on clusters with taints, tolerations, selectors and
node affinity.  The port's static (profile x class) planes must equal the
JAX ``_static_planes`` bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_fixtures import feature_store, tonp

import volcano_tpu
import volcano_tpu.ops.wave as jw
from volcano_tpu.ops.nodeclass import NodeClasses as JaxClasses
from volcano_tpu.synth import solve_args_from_store as jax_args
from volcano_tpu.synth import synthetic_cluster as jax_cluster

import volcano_tpu_torch.ops.wave as tw
from volcano_tpu_torch import interop
from volcano_tpu_torch.device import to_tensor, tree_to
from volcano_tpu_torch.ops.nodeclass import NodeClasses
from volcano_tpu_torch.ops.scoring import ScoreWeights

CPU = torch.device("cpu")


def _prepared(args):
    jn = tonp(args)
    nodes, tasks, _jobs, _queues, weights, eps, slot, aff = jn
    profiles, _pid, _, _ = jw._profile_tasks(tasks, aff)
    profiles = jw._pad_profiles_rows(profiles)
    return jn, profiles


def _features(nodes):
    taints = bool(np.asarray(nodes.taint_bits).any())
    return (False, False, taints, False, False, False, False)


def _run_both(args, sl_k, compacted):
    jn, profiles = _prepared(args)
    nodes, _t, _j, _q, weights, eps, slot, aff = jn
    feats = _features(nodes)
    U = profiles.req.shape[0]
    if compacted:
        jw._host_node_classes._cache = None
        cls = jw._host_node_classes(nodes)
    else:
        z = np.zeros
        cls = JaxClasses(class_id=z((1,), np.int32),
                         label_bits=z((1, 1), np.uint32),
                         taint_bits=z((1, 1), np.uint32), ready=z((1,), bool))
    want = np.asarray(jw._coarse_shortlist(
        nodes, profiles, np.ones((1, 1), bool), np.zeros((1, 1), np.float32),
        cls, aff, weights, eps, slot, sl_k=sl_k, chunk=min(U, 64),
        features=feats, cnt0_any=False, cls_identity=not compacted,
    ))
    want_ok, want_sc = jw._static_planes(
        nodes, profiles, cls, weights.node_affinity_weight, chunk=min(U, 64),
        has_taints=feats[2], cls_identity=not compacted,
    )
    tn = interop.solve_args_from_numpy(jn)
    w = tn[4]
    weights_t = ScoreWeights(
        float(w.binpack_weight), to_tensor(w.binpack_res, CPU),
        float(w.least_req_weight), float(w.most_req_weight),
        float(w.balanced_weight), float(w.node_affinity_weight))
    prof_t = tree_to(tw.SolveProfiles(*profiles), CPU)
    cls_t = tree_to(NodeClasses(*cls), CPU) if compacted else None
    got, ok, sc = tw._coarse_shortlist(
        tree_to(tn[0], CPU), prof_t, cls_t, weights_t,
        to_tensor(tn[5], CPU), to_tensor(tn[6], CPU), sl_k, feats)
    return want, got.numpy(), (np.asarray(want_ok), np.asarray(want_sc)), \
        (ok.numpy(), sc.numpy())


@pytest.mark.parametrize("compacted", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_shortlists_identical_taints_selectors(compacted, seed):
    args, _ = jax_args(feature_store(volcano_tpu, n_nodes=96, n_pods=300,
                                     seed=seed), binpack=True,
                       nodeorder=True)
    assert np.asarray(args[0].taint_bits).any()
    want, got, (wok, wsc), (tok, tsc) = _run_both(args, 24, compacted)
    assert want.dtype == got.dtype and np.array_equal(want, got)
    assert np.all(np.diff(got, axis=1) > 0)  # ascending, unique
    assert np.array_equal(wok, tok)
    assert np.array_equal(wsc.view(np.uint32), tsc.view(np.uint32))


@pytest.mark.parametrize("compacted", [True, False])
def test_shortlists_identical_on_ties(compacted):
    """Identical nodes: every score ties, the lowest node ids win."""
    args, _ = jax_args(jax_cluster(n_nodes=64, n_pods=128, gang_size=4,
                                   zones=4, seed=2))
    want, got, _, _ = _run_both(args, 16, compacted)
    assert np.array_equal(want, got)
    assert np.array_equal(got[0], np.arange(16))
