"""Index selection without host synchronization, the same on every device."""

from __future__ import annotations

import torch


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """i64 scalar — the index of the first True of a 1-D mask; 0 when
    there is none (what ``jnp.argmax`` gives an all-False mask). It is the
    least index of an integer ``where``, so ties resolve to the first on
    every device, with no reliance on ``argmax`` over booleans."""
    n = mask.shape[0]
    idx = torch.where(mask, torch.arange(n, device=mask.device), n).min()
    return torch.where(idx == n, 0, idx)


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, as a device gather (indexing with a
    0-d tensor would read the index back to the host)."""
    return x.index_select(0, i.reshape(1).long()).reshape(x.shape[1:])
