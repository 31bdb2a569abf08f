"""Placement engine: weighted interleaving + training-state tiers.

The port's copy of two parts of the reference's ``repro/core/placement.py``:

1. **Page interleaving** (the paper's §3.4): ``interleave_pages`` assigns
   logical pages across tiers by weighted round-robin.
2. **Training-state placement** (§6.1.5 / Table 5):
   ``plan_training_placement`` decides which state groups (bf16 compute
   params, fp32 master, Adam mu/nu) live in device memory and which in
   pinned host memory, from a per-chip byte budget. Pure arithmetic, equal
   to the reference's; its default topology is the reference's
   ``tpu_v5e`` (16 GiB of HBM per chip).

The KV-placement planner comes with the slice that uses it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.config.base import ModelConfig
from repro_torch.core.tiers import TierTopology


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


# --------------------------------------------------------------------------
# Training-state placement
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PlacementPlan:
    """Tier assignment per state group + byte accounting (per chip)."""
    kinds: dict                  # group -> memory kind ('device'/'pinned_host')
    bytes_per_chip: dict         # group -> bytes
    hbm_used: int
    host_used: int
    hbm_capacity: int
    host_capacity: int
    notes: list

    @property
    def fits(self) -> bool:
        return (self.hbm_used <= self.hbm_capacity
                and self.host_used <= self.host_capacity)

    def memory_kinds(self) -> dict:
        return dict(self.kinds)


def _per_chip_param_bytes(cfg: ModelConfig, n_chips: int) -> int:
    return int(cfg.num_params) * 4 // n_chips      # fp32 master


def plan_training_placement(cfg: ModelConfig, n_chips: int,
                            topo: Optional[TierTopology] = None,
                            activation_budget: int = 4 << 30,
                            policy: str = "auto") -> PlacementPlan:
    """Decide device/host placement of training state for one chip.

    policy: 'auto' (capacity-driven, the paper's recommendation),
            'never' (all HBM), 'always' (offload everything offloadable).
    """
    topo = topo or TierTopology.tpu_v5e()
    hbm = topo.tier("hbm").capacity
    host = topo.tier("host").capacity
    p32 = _per_chip_param_bytes(cfg, n_chips)
    groups = {
        "params": p32 // 2,       # bf16 compute copy
        "master": p32,            # fp32 master
        "mu": p32,                # Adam first moment (fp32)
        "nu": p32,                # Adam second moment (fp32)
    }
    kinds = {g: "device" for g in groups}
    notes = []
    if policy == "always":
        for g in ("master", "mu", "nu"):
            kinds[g] = "pinned_host"
        notes.append("policy=always: master+moments offloaded")
    elif policy == "auto":
        # Offload in paper-recommended order (coldest state first: nu, mu,
        # master) until the HBM budget (activations + compute params) fits.
        order = ("nu", "mu", "master")

        def hbm_used():
            return (activation_budget
                    + sum(b for g, b in groups.items()
                          if kinds[g] == "device"))
        for g in order:
            if hbm_used() > hbm:
                kinds[g] = "pinned_host"
                notes.append(f"offloaded {g} to host (HBM budget)")
    hbm_used = activation_budget + sum(
        b for g, b in groups.items() if kinds[g] == "device")
    host_used = sum(b for g, b in groups.items()
                    if kinds[g] == "pinned_host")
    if hbm_used > hbm:
        notes.append("WARNING: does not fit HBM even fully offloaded")
    return PlacementPlan(kinds=kinds, bytes_per_chip=groups,
                         hbm_used=int(hbm_used), host_used=int(host_used),
                         hbm_capacity=int(hbm), host_capacity=int(host),
                         notes=notes)
