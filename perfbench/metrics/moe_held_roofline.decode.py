"""The held experts' least time over their device time in the profiled
decode steps, in %: what ``moe_experts_roofline.decode`` reads (loaded by
path), in the cells whose family's yardstick counts the experts a chip
holds (``decode_expert_bytes``: each MoE layer's held experts' weights
read once a step and the expected held pairs' rows in and out, over
3.35 TB/s, times the profiled steps)."""

import importlib.util
from pathlib import Path


def read(record):
    path = Path(__file__).with_name("moe_experts_roofline.decode.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics.moe_experts_roofline_decode", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)
