"""Static predicate masks: the [P, N] boolean gate.

The counterpart of the JAX package's ``ops/predicates.py``: node readiness,
node-selector and required node-affinity label matching, taints and
tolerations, host-port conflicts, as bitset algebra over the words
``arrays.encode_cluster`` packs (uint32 words, carried as int32 tensors
with the same bits).  Resource fit and pod counts are dynamic and live in
the solve kernels; everything here is constant within one session.

Each function takes tensors.  On CPU tensors it runs its plain PyTorch
version (the broadcast forms below, equal to the JAX functions bit for
bit); on CUDA tensors it launches the ``csrc/static_mask.cu`` kernel
(``ops/kernels.static_mask``: the whole mask in one launch, or one helper's
term) or raises.  ``plain=True`` forces the plain version on the card; only
comparisons ask for it.  ``static_predicate_mask`` takes the encode's
``ClusterArrays`` and a ``device``: the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import torch

from ..device import resolve_device, to_tensor
from . import kernels


def _bits(t, name: str) -> torch.Tensor:
    """A bit-word tensor as int32 (a uint32 tensor viewed, same bits)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    u32 = getattr(torch, "uint32", None)
    if u32 is not None and t.dtype == u32:
        t = t.view(torch.int32)
    return t


def _subset(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """rows [..., W] against table [N, W] -> [..., N]: every bit of a row
    set in the table's row (True over a zero-width word axis)."""
    miss = rows.unsqueeze(-2) & ~table
    return (miss == 0).all(dim=-1)


def _selector_plain(sel_bits, has_selector, node_label_bits):
    return _subset(sel_bits, node_label_bits) | ~has_selector[:, None]


def _affinity_plain(aff_bits, aff_terms, node_label_bits):
    term_ok = _subset(aff_bits, node_label_bits)  # [P, A, N]
    A = aff_bits.shape[1]
    term_real = (torch.arange(A, device=aff_terms.device)[None, :]
                 < aff_terms[:, None])  # [P, A]
    any_ok = (term_ok & term_real[:, :, None]).any(dim=1)  # [P, N]
    return any_ok | (aff_terms == 0)[:, None]


def _taint_plain(tol_bits, node_taint_bits):
    untolerated = node_taint_bits[None, :, :] & ~tol_bits[:, None, :]
    return (untolerated == 0).all(dim=-1)


def _port_plain(task_port_bits, node_port_bits):
    clash = task_port_bits[:, None, :] & node_port_bits[None, :, :]
    return (clash == 0).all(dim=-1)


def mask_plain(terms: int, **x) -> torch.Tensor:
    """The plain version of ``kernels.static_mask``: the mask of ``terms``
    from its named inputs."""
    if terms == kernels.MASK_SEL:
        return _selector_plain(x["sel_bits"], x["has_selector"],
                               x["node_label"])
    if terms == kernels.MASK_AFF:
        return _affinity_plain(x["aff_bits"], x["aff_terms"],
                               x["node_label"])
    if terms == kernels.MASK_TAINT:
        return _taint_plain(x["tol_bits"], x["node_taint"])
    if terms == kernels.MASK_PORT:
        return _port_plain(x["task_port"], x["node_port"])
    if terms != kernels.MASK_STATIC:
        raise ValueError(f"static_mask: no plain version for terms {terms}")
    mask = x["n_ready"][None, :] & x["n_real"][None, :] & x["t_real"][:, None]
    mask = mask & _selector_plain(x["sel_bits"], x["has_selector"],
                                  x["node_label"])
    mask = mask & _affinity_plain(x["aff_bits"], x["aff_terms"],
                                  x["node_label"])
    return mask & _taint_plain(x["tol_bits"], x["node_taint"])


def selector_mask(sel_bits, has_selector, node_label_bits,
                  plain: bool = False):
    """[P, N] node-selector match: the task's required label pairs are a
    subset of the node's (``sel_bits`` [P, LW], ``node_label_bits`` [N,
    LW]); a task without a selector matches every node."""
    return kernels.static_mask(
        kernels.MASK_SEL, plain=plain,
        sel_bits=_bits(sel_bits, "sel_bits"), has_selector=has_selector,
        node_label=_bits(node_label_bits, "node_label_bits"))


def affinity_mask(aff_bits, aff_terms, node_label_bits, plain: bool = False):
    """[P, N] required node affinity: the node matches ANY of the task's
    first ``aff_terms`` alternative terms (``aff_bits`` [P, A, LW]; k8s
    nodeSelectorTerms OR semantics); a task with no terms matches every
    node."""
    return kernels.static_mask(
        kernels.MASK_AFF, plain=plain,
        aff_bits=_bits(aff_bits, "aff_bits"), aff_terms=aff_terms,
        node_label=_bits(node_label_bits, "node_label_bits"))


def taint_mask(tol_bits, node_taint_bits, plain: bool = False):
    """[P, N] taint / toleration: every gating (NoSchedule / NoExecute)
    taint on the node is tolerated by the task."""
    return kernels.static_mask(
        kernels.MASK_TAINT, plain=plain, tol_bits=_bits(tol_bits, "tol_bits"),
        node_taint=_bits(node_taint_bits, "node_taint_bits"))


def port_mask(task_port_bits, node_port_bits, plain: bool = False):
    """[P, N] host-port conflict: the requested ports are disjoint from the
    ports already used on the node."""
    return kernels.static_mask(
        kernels.MASK_PORT, plain=plain,
        task_port=_bits(task_port_bits, "task_port_bits"),
        node_port=_bits(node_port_bits, "node_port_bits"))


def static_predicate_mask(arrays, device=None, plain: bool = False):
    """All static predicates of ``arrays`` (the encode's ``ClusterArrays``)
    in one [P, N] bool mask on ``device``: node ready and real, task real,
    selector, required node affinity, taints.  Host ports are not in it:
    the solves keep their own dynamic copy of the ports as they assign."""
    dev = resolve_device(device)
    t, n = arrays.tasks, arrays.nodes

    def put(a):
        return to_tensor(a, dev).contiguous()

    return kernels.static_mask(
        kernels.MASK_STATIC, plain=plain,
        n_ready=put(n.ready), n_real=put(n.real), t_real=put(t.real),
        node_label=put(n.label_bits), sel_bits=put(t.sel_bits),
        has_selector=put(t.has_selector), aff_bits=put(t.aff_bits),
        aff_terms=put(t.aff_terms), node_taint=put(n.taint_bits),
        tol_bits=put(t.tol_bits))
