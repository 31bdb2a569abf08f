"""The held experts' least time over their device time in the profiled
prefill, in %: what ``moe_experts_roofline.prefill`` reads (loaded by
path), in the cells whose family's yardstick counts the experts a chip
holds (``prefill_expert_flops``: 2 * 3 * d * ff per expected held pair,
over the card's bf16 peak)."""

import importlib.util
from pathlib import Path


def read(record):
    path = Path(__file__).with_name("moe_experts_roofline.prefill.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics.moe_experts_roofline_prefill", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)
