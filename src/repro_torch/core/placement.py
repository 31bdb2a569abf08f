"""Weighted page interleaving across memory tiers (the paper's §3.4).

The port's copy of ``interleave_pages`` and ``interleave_counts`` from the
reference's ``repro/core/placement.py``; its training- and KV-placement
planners come with the slices that use them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def interleave_pages(n_pages: int, weights: Sequence[int]) -> np.ndarray:
    """Assign page -> tier index by weighted round-robin.

    Matches the kernel's weighted-interleave semantics: in each round of
    sum(weights) pages, tier i receives weights[i] of them.
    """
    weights = list(weights)
    if any(w < 0 for w in weights) or sum(weights) == 0:
        raise ValueError(f"bad weights {weights}")
    pattern = []
    for tier_idx, w in enumerate(weights):
        pattern.extend([tier_idx] * w)
    reps = -(-n_pages // len(pattern))
    return np.tile(np.array(pattern, np.int32), reps)[:n_pages]


def interleave_counts(n_pages: int, weights: Sequence[int]) -> list[int]:
    a = interleave_pages(n_pages, weights)
    return [int((a == i).sum()) for i in range(len(weights))]
