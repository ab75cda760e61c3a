"""The port's static predicate masks against the JAX package's.

``volcano_tpu_torch/ops/predicates.py`` holds the five functions of
``volcano_tpu/ops/predicates.py``.  The same stores, built with each
package's api and encoded by each package's ``encode_cluster``, go through
both; on CPU tensors the port runs its plain versions, which must equal
the JAX functions bit for bit (bool masks, exact).  Hand-built arrays reach
the edge cases the encode does not give: empty word axes (LW / TW / PW =
0), no affinity terms (A = 0), terms past ``aff_terms``, ``has_selector``
false with words set, padded rows on either axis, ``aff_terms`` past A or
negative.
"""

import numpy as np
import pytest
import torch

import volcano_tpu_torch
import volcano_tpu_torch.arrays
from test_torch_fixtures import (MASK_EDGE_KINDS, feature_store,
                                 mask_edge_arrays, pending_encode,
                                 seq_store)
from volcano_tpu_torch.device import to_tensor
from volcano_tpu_torch.ops import kernels
from volcano_tpu_torch.ops import predicates as port_pred


def _jax():
    import volcano_tpu
    import volcano_tpu.api
    import volcano_tpu.arrays
    import volcano_tpu.cache
    import volcano_tpu.synth

    return volcano_tpu


def _jax_masks(a):
    from volcano_tpu.ops import predicates as jp

    t, n = a.tasks, a.nodes
    return {
        "selector_mask": jp.selector_mask(t.sel_bits, t.has_selector,
                                          n.label_bits),
        "affinity_mask": jp.affinity_mask(t.aff_bits, t.aff_terms,
                                          n.label_bits),
        "taint_mask": jp.taint_mask(t.tol_bits, n.taint_bits),
        "port_mask": jp.port_mask(t.port_bits, n.port_bits),
        "static_predicate_mask": jp.static_predicate_mask(a),
    }


def _port_masks(a):
    cpu = torch.device("cpu")
    t = {f: to_tensor(getattr(a.tasks, f), cpu) for f in
         ("sel_bits", "has_selector", "aff_bits", "aff_terms", "tol_bits",
          "port_bits")}
    n = {f: to_tensor(getattr(a.nodes, f), cpu) for f in
         ("label_bits", "taint_bits", "port_bits")}
    return {
        "selector_mask": port_pred.selector_mask(
            t["sel_bits"], t["has_selector"], n["label_bits"]),
        "affinity_mask": port_pred.affinity_mask(
            t["aff_bits"], t["aff_terms"], n["label_bits"]),
        "taint_mask": port_pred.taint_mask(t["tol_bits"], n["taint_bits"]),
        "port_mask": port_pred.port_mask(t["port_bits"], n["port_bits"]),
        "static_predicate_mask": port_pred.static_predicate_mask(
            a, device="cpu"),
    }


def _same(jax_masks, port_masks):
    assert set(jax_masks) == set(port_masks)
    for name, j in jax_masks.items():
        j = np.asarray(j)
        p = port_masks[name]
        assert isinstance(p, torch.Tensor) and p.dtype == torch.bool, name
        p = p.numpy()
        assert j.dtype == p.dtype and j.shape == p.shape, name
        assert np.array_equal(j, p), name


STORES = ([("random", s) for s in range(8)] + [("features", 0),
                                                ("features", 1)])


def _build(pkg, kind, seed):
    if kind == "random":
        return seq_store(pkg, "random", seed)
    return feature_store(pkg, n_nodes=48, n_pods=256, seed=seed)


@pytest.mark.parametrize("kind,seed", STORES)
def test_masks_equal_jax_on_stores(kind, seed):
    """Both packages' encodes of one store agree on every word the masks
    read, and the five masks are equal bit for bit."""
    vt = _jax()
    ja = pending_encode(vt, _build(vt, kind, seed))[0]
    pa = pending_encode(volcano_tpu_torch,
                        _build(volcano_tpu_torch, kind, seed))[0]
    for side, fields in (("nodes", ("ready", "real", "label_bits",
                                    "taint_bits", "port_bits")),
                         ("tasks", ("real", "sel_bits", "has_selector",
                                    "aff_bits", "aff_terms", "tol_bits",
                                    "port_bits"))):
        for f in fields:
            x = np.asarray(getattr(getattr(ja, side), f))
            y = np.asarray(getattr(getattr(pa, side), f))
            assert x.dtype == y.dtype and np.array_equal(x, y), (side, f)
    jm = _jax_masks(ja)
    _same(jm, _port_masks(pa))
    m = np.asarray(jm["static_predicate_mask"])
    # The store exercises the gate: some cells pass, some fail.
    assert m.any() and not m.all()


@pytest.mark.parametrize("kind", MASK_EDGE_KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_masks_equal_jax_on_edge_arrays(kind, seed):
    _jax()
    a = mask_edge_arrays(kind, seed)
    _same(_jax_masks(a), _port_masks(a))


def test_edge_semantics():
    """The cases above do what the docstrings say (so an agreement is not
    an agreement on nothing)."""
    cpu = torch.device("cpu")
    a = mask_edge_arrays("empty words")
    m = _port_masks(a)
    for name in ("selector_mask", "taint_mask", "port_mask"):
        assert bool(m[name].all()), name
    a = mask_edge_arrays("terms masked")
    aff = port_pred.affinity_mask(to_tensor(a.tasks.aff_bits, cpu),
                                  to_tensor(a.tasks.aff_terms, cpu),
                                  to_tensor(a.nodes.label_bits, cpu))
    one = torch.from_numpy(a.tasks.aff_terms == 1)
    assert not bool(aff[one].any()) and bool(aff[~one].all())
    a = mask_edge_arrays("no selector")
    sel = port_pred.selector_mask(to_tensor(a.tasks.sel_bits, cpu),
                                  to_tensor(a.tasks.has_selector, cpu),
                                  to_tensor(a.nodes.label_bits, cpu))
    free = ~torch.from_numpy(a.tasks.has_selector)
    assert bool(sel[free].all())
    a = mask_edge_arrays("padded")
    m = port_pred.static_predicate_mask(a, device="cpu")
    assert not bool(m[-4:].any()) and not bool(m[:, -5:].any())
    assert not bool(m[:, :3].any())
    a = mask_edge_arrays("no terms")
    aff = _port_masks(a)["affinity_mask"]
    asked = torch.from_numpy(a.tasks.aff_terms > 0)
    assert not bool(aff[asked].any()) and bool(aff[~asked].all())


def test_cpu_tensors_never_load_the_kernels(monkeypatch):
    """On CPU tensors every function runs its plain version: the kernel
    library is never asked for."""
    def boom():
        raise AssertionError("kernel library loaded for CPU tensors")

    monkeypatch.setattr(kernels, "load", boom)
    before = kernels.LAUNCHES["static_predicate_mask"]
    _port_masks(mask_edge_arrays("random"))
    assert kernels.LAUNCHES["static_predicate_mask"] == before


def test_default_device_is_the_card(monkeypatch):
    """Without a card the default device raises; ``device="cpu"`` runs."""
    a = mask_edge_arrays("random")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_pred.static_predicate_mask(a)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_pred.static_predicate_mask(a, device="cuda")
    assert port_pred.static_predicate_mask(a, device="cpu").shape == (37, 45)


def test_helpers_take_tensors_only():
    a = mask_edge_arrays("random")
    with pytest.raises(TypeError):
        port_pred.taint_mask(a.tasks.tol_bits, a.nodes.taint_bits)


def test_ops_exports_static_predicate_mask():
    import volcano_tpu_torch.ops as ops

    assert ops.static_predicate_mask is port_pred.static_predicate_mask
