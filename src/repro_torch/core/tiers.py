"""Memory-tier and link topology model.

The port's copy of ``MemoryTier`` and ``TierTopology.tpu_v5e`` from the
reference's ``repro/core/tiers.py``, with the two tiers
``plan_training_placement`` reads: device HBM and the host share, with
capacity, bandwidth and latency. The planner budgets against the
reference's default ``tpu_v5e`` topology until the H100 host preset (the
calibration slice) exists; the pool and peer tiers, the links between
tiers, ``from_calibration`` and ``from_fabric`` come with that slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.roofline import hw


@dataclasses.dataclass(frozen=True)
class MemoryTier:
    name: str
    capacity: int              # bytes available per chip(-share)
    read_bw: float             # bytes/s per chip
    write_bw: float            # bytes/s per chip
    latency: float             # seconds (single cacheline-equivalent access)
    memory_kind: Optional[str]  # 'device' / 'pinned_host', None if not addressable


@dataclasses.dataclass(frozen=True)
class TierTopology:
    tiers: dict

    def tier(self, name: str) -> MemoryTier:
        return self.tiers[name]

    @classmethod
    def tpu_v5e(cls, chips_per_host: int = hw.CHIPS_PER_HOST
                ) -> "TierTopology":
        pcie_per_chip = hw.PCIE_BANDWIDTH / chips_per_host
        host_share = hw.HOST_DRAM_CAPACITY // chips_per_host
        tiers = {
            "hbm": MemoryTier("hbm", hw.HBM_CAPACITY, hw.HBM_BANDWIDTH,
                              hw.HBM_BANDWIDTH, 0.4e-6, "device"),
            "host": MemoryTier("host", host_share, pcie_per_chip,
                               pcie_per_chip, 2e-6, "pinned_host"),
        }
        return cls(tiers=tiers)
