"""The expert layers' least time over their device time in the profiled
decode steps, in %. The least time is the yardstick's
``decode_expert_bytes`` (every expert's weights read once a step, the
routed rows in and out) over the card's 3.35 TB/s, times the steps
profiled; the device time is the union of the intervals of the kernels
that compute the experts, whatever implements them
(``moe_experts_roofline.prefill.KERNELS``).

The steps are counted from the trace: a decode step reads its tokens back
to the host once (one device-to-host copy), and the harness's profiled
batch runs with the program's tracer off, so no span of the program marks
a step there."""

import importlib.util
from pathlib import Path

from perfbench import arith
from perfbench.trace import intervals


def _prefill_reader():
    path = Path(__file__).with_name("moe_experts_roofline.prefill.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics.moe_experts_roofline_prefill", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(record):
    trace = record.get("trace")
    d = record.get("dims")
    if not trace or "decode" not in trace["marks"] or not d:
        return None
    need = d.decode_expert_bytes(record["profiled"]["batch"])
    if need is None:
        return None
    lo, hi = trace["marks"]["decode"]
    t = arith.covered(intervals(trace["device"], lo, hi,
                                _prefill_reader().is_expert_kernel), lo, hi)
    steps = sum(1 for e in trace["device"]
                if e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]
                and lo <= e["start"] < hi)
    if t <= 0 or steps == 0:
        return None
    bound = steps * need / arith.HBM_BYTES_PER_S
    return 100.0 * bound / t
