"""Carry solver state between the JAX package and the port.

``solve_args_from_numpy`` turns the JAX package's solve-args tuple
``(nodes, tasks, jobs, queues, weights, eps, scalar_slot, aff)`` -- every
leaf already converted to numpy by the caller -- into the port's
containers, matching fields by the NamedTuples' ``_fields`` rather than by
importing the JAX package's classes.  ``result_to_numpy`` brings an
``AllocResult`` of tensors back to numpy.  This is the scheduler's
counterpart of carrying weights across.
"""

from __future__ import annotations

import numpy as np

from .arrays.affinity import AffinityArgs
from .device import to_numpy
from .ops.allocate import (
    AllocResult,
    SolveJobs,
    SolveNodes,
    SolveQueues,
    SolveTasks,
)
from .ops.scoring import ScoreWeights

_ORDER = (SolveNodes, SolveTasks, SolveJobs, SolveQueues, ScoreWeights)


def _convert(src, cls):
    fields = getattr(src, "_fields", None)
    if fields is None:
        raise TypeError(f"expected a NamedTuple for {cls.__name__}, got "
                        f"{type(src).__name__}")
    if tuple(fields) != cls._fields:
        raise ValueError(
            f"{cls.__name__} fields differ: {tuple(fields)} != {cls._fields}"
        )
    return cls(**{f: getattr(src, f) for f in fields})


def solve_args_from_numpy(args) -> tuple:
    """JAX-package solve args (numpy leaves) -> the port's solve args."""
    if len(args) != 8:
        raise ValueError(f"expected 8 solve args, got {len(args)}")
    out = [_convert(a, cls) for a, cls in zip(args[:5], _ORDER)]
    out.append(np.asarray(args[5], np.float32))
    out.append(np.asarray(args[6], bool))
    out.append(_convert(args[7], AffinityArgs))
    return tuple(out)


def result_to_numpy(res: AllocResult) -> AllocResult:
    """AllocResult of tensors -> AllocResult of numpy arrays."""
    return AllocResult(*[None if x is None else to_numpy(x) for x in res])
