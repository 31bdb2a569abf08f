"""Attention's least time over its device time in the profiled prefill,
in %. The least time is the yardstick's ``prefill_attention_bound`` of
the shapes the engine hands attention (the padded batch, every layer:
``arith.attention_bound`` for the decoder family); the device time is
the union of the intervals of the kernels named below, whichever of them
implements attention, so the metric reads the same work whatever runs
it."""

from perfbench import arith
from perfbench.trace import intervals

# K1 (the port's flash attention), and PyTorch's SDPA back ends
KERNELS = ("flash_fwd_kernel", "flash_fwd_fp32_kernel", "fmha",
           "flash_attn", "cudnn_generated_fort_native_sdpa",
           "attention_kernel", "efficient_attention")


def read(record):
    trace = record.get("trace")
    if not trace or "prefill" not in trace["marks"]:
        return None
    lo, hi = trace["marks"]["prefill"]
    ivs = intervals(trace["device"], lo, hi,
                    lambda e: any(k in e["name"] for k in KERNELS))
    t = arith.covered(ivs, lo, hi)
    if t <= 0:
        return None
    p = record["profiled"]
    bound = record["dims"].prefill_attention_bound(p["batch"], p["plen"])
    return 100.0 * bound / t
