"""Row gathers by one ``index_select``.

``x[idx]`` with an index tensor is advanced indexing, which on a
multi-threaded CPU is far slower than ``index_select`` over the
flattened indices for the small tables of the solver and the contact
grid; the CPU path of the physics runs on these gathers.
"""
from __future__ import annotations

import torch


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for non-negative integer ``idx`` of any shape."""
    return x.index_select(0, idx.reshape(-1)).reshape(*idx.shape,
                                                      *x.shape[1:])
