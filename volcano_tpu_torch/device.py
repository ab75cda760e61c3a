"""Device placement of solver containers.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card the default raises and never drops to the CPU.  Leaves move
between numpy (host) and torch (device) here: ``uint32`` bit planes travel as
``int32`` tensors with the same bit patterns (torch's uint32 support is
partial), everything else keeps its dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a host without one raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: volcano_tpu_torch runs on the card unless "
                "the caller passes device='cpu'"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is absent")
    return dev


def to_tensor(a, device: torch.device) -> torch.Tensor:
    """numpy / scalar / tensor leaf -> tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def to_numpy(a) -> np.ndarray:
    """tensor / array leaf -> contiguous numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.ascontiguousarray(a)


def tree_to(tree, device: torch.device):
    """Map ``to_tensor`` over a NamedTuple (floats stay floats)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_to(x, device) for x in tree])
    if isinstance(tree, (float, int)) and not isinstance(tree, bool):
        return tree
    return to_tensor(tree, device)
