"""Hardware constants of the reference's target platform (TPU v5e) and its
tier model.

Copies of ``repro/roofline/hw.py``'s published TPU v5e and host-tier
numbers, kept so the port's ``TierTopology.tpu_v5e`` and the dry-run's
default roofline (``ChipSpec``/``V5E``) equal the reference's. They
describe a TPU pod, not the H100 the port runs on, and no measurement of
the card comes from them; a card's roofline is a ``ChipSpec`` built from
that card's measured rates (``chip_smoke.py``'s dryrun phase). No H100
entry joins this module, as the reference has none.
"""

from __future__ import annotations

import dataclasses

# --- Per-chip roofline constants (TPU v5e) -------------------------------
PEAK_FLOPS_BF16 = 197e12       # FLOP/s per chip, bf16 on the MXU
PEAK_FLOPS_INT8 = 394e12       # FLOP/s per chip, int8
HBM_BANDWIDTH = 819e9          # bytes/s per chip
HBM_CAPACITY = 16 * 2**30      # bytes per chip
ICI_LINK_BANDWIDTH = 50e9      # bytes/s per ICI link (~50 GB/s/link)
ICI_LINKS_PER_CHIP = 4         # 2D torus on v5e: 4 links/chip
VMEM_CAPACITY = 128 * 2**20    # ~128 MiB VMEM per chip

# --- Host / pooled tiers (paper's CXL analogues) --------------------------
PCIE_BANDWIDTH = 32e9          # bytes/s host<->chip (PCIe Gen4 x16 class)
HOST_DRAM_BANDWIDTH = 200e9    # bytes/s host DRAM (paper Fig 5: ~208 GiB/s)
HOST_DRAM_CAPACITY = 512 * 2**30   # bytes per host
HOST_DRAM_LATENCY = 110e-9     # s (paper Fig 4 local DIMM ~100-150ns)
HOST_REMOTE_LATENCY = 250e-9   # s (paper Fig 4 remote DIMM ~200-260ns)
CXL_LIKE_LATENCY = 300e-9      # s (paper Fig 4 ASIC-CXL 200-300ns local)
POOL_LATENCY = 550e-9          # s (paper Fig 4 Pool/SHM-CXL >500ns)
DCN_BANDWIDTH_PER_HOST = 25e9  # bytes/s per host across pods (DCN)

# Chips per host on a v5e pod slice (4 chips/host typical).
CHIPS_PER_HOST = 4

MXU_DIM = 128                  # systolic array tile
LANE_DIM = 128                 # last-dim vector lanes
SUBLANE_DIM = 8                # second-to-last dim sublanes (f32)


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Roofline-relevant description of one accelerator chip."""

    name: str = "tpu_v5e"
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bandwidth: float = HBM_BANDWIDTH
    hbm_capacity: int = HBM_CAPACITY
    ici_bandwidth: float = ICI_LINK_BANDWIDTH
    ici_links: int = ICI_LINKS_PER_CHIP
    vmem_capacity: int = VMEM_CAPACITY

    @property
    def ridge_intensity(self) -> float:
        """FLOP/byte at which compute and HBM terms balance."""
        return self.peak_flops / self.hbm_bandwidth


V5E = ChipSpec()
