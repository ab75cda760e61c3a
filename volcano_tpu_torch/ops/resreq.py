"""Vectorized resource-fit predicates (torch).

Device mirror of ``Resource.LessEqual`` (resource_info.go:286-320), the
counterpart of the JAX package's ``ops/resreq.py``.  ``l``/``r`` are
[..., R] resource vectors, ``eps`` the [R] per-slot quantum, ``scalar_slot``
the [R] bool mask of extended-resource slots.
"""

from __future__ import annotations

import torch


def less_equal(l, r, eps, scalar_slot):
    """Epsilon-tolerant fit: per-slot ``l < r or |l-r| < eps``; extended
    scalar slots requesting <= one quantum always pass.  Reduces over the
    trailing resource axis.  Broadcasts l and r."""
    per_slot = (l < r) | (torch.abs(l - r) < eps)
    per_slot = per_slot | (scalar_slot & (l <= eps))
    return torch.all(per_slot, dim=-1)
