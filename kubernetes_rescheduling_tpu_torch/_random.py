"""Per-round random streams of the port.

The JAX package derives each round's key as ``fold_in(PRNGKey(seed),
round)``, so a round's random decisions depend only on the seed and the
round number (a resumed run decides like the uninterrupted one). The port
keeps that property with explicit CPU ``torch.Generator``s seeded from
``(seed, round)``: what a round draws is the same on the CPU and on the
card, and no threefry port is needed.
"""

from __future__ import annotations

import numpy as np
import torch


def round_generator(seed: int, rnd: int) -> torch.Generator:
    """A CPU generator whose stream depends only on ``(seed, rnd)``."""
    words = np.random.SeedSequence([seed % 2**63, rnd % 2**63]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(words[0]) << 31) | (int(words[1]) >> 1))


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Unit gumbel noise ``-log(-log(u))`` drawn from ``generator`` (whose
    device ``device`` must be)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))
