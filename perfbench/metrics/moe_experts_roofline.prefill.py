"""The expert layers' least time over their device time in the profiled
prefill, in %. The least time is the yardstick's ``prefill_expert_flops``
of the batch's routed tokens (every padded position is routed; the cells'
mixes pad none) over the card's bf16 peak (989 TFLOP/s); the device time
is the union of the intervals of the kernels named below, whichever of them
computes the experts, so the metric reads the same work whatever runs it.
Where none ran (the capacity body's batched GEMMs are cuBLAS kernels that
the attention projections share), it reads nothing."""

from perfbench import arith
from perfbench.trace import intervals

# torch._grouped_mm's CUTLASS grouped GEMM and the kernel that lays out its
# problem sizes from the offsets on the device
KERNELS = ("GroupProblemShape", "grouped_gemm", "grouped_mm")


def is_expert_kernel(e) -> bool:
    return e["cat"] == "kernel" and any(k in e["name"] for k in KERNELS)


def read(record):
    trace = record.get("trace")
    d = record.get("dims")
    if not trace or "prefill" not in trace["marks"] or not d:
        return None
    p = record["profiled"]
    flops = d.prefill_expert_flops(p["batch"] * p["plen"])
    if flops is None:
        return None
    lo, hi = trace["marks"]["prefill"]
    t = arith.covered(intervals(trace["device"], lo, hi, is_expert_kernel),
                      lo, hi)
    if t <= 0:
        return None
    return 100.0 * flops / arith.PEAK_FLOPS["bfloat16"] / t
