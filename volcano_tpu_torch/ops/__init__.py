"""Solver kernels and containers (torch)."""

from .predicates import static_predicate_mask

__all__ = ["static_predicate_mask"]
