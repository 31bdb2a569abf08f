"""The reference's TPU v5e tier constants that ``core/tiers.py`` reads.

Copies of ``repro/roofline/hw.py``'s published v5e numbers, kept so the
port's ``TierTopology.tpu_v5e`` (the reference's default topology, which
``plan_training_placement`` budgets against) equals the reference's. They
describe a TPU host, not the H100 the port runs on, and no measurement of
the card comes from them.
"""

from __future__ import annotations

HBM_BANDWIDTH = 819e9          # bytes/s per chip
HBM_CAPACITY = 16 * 2**30      # bytes per chip
PCIE_BANDWIDTH = 32e9          # bytes/s host<->chip (PCIe Gen4 x16 class)
HOST_DRAM_CAPACITY = 512 * 2**30   # bytes per host
CHIPS_PER_HOST = 4
