"""Decode attention's least time over its device time in the profiled
decode steps, in %. The least time is the live K and V those steps must
read, over the card's 3.35 TB/s: step i of a batch of ``batch`` sequences
whose prompts were padded to ``plen`` attends to ``plen + i + 1`` positions
of every layer, the yardstick's ``kv_bytes_per_token`` each. The device
time is the
union of the intervals of the dense decode attention kernel (K8: its split
kernel and its combine) in the profiled decode.

The steps are counted from the trace: a decode step reads its tokens back
to the host once (one device-to-host copy), as for
``moe_experts_roofline.decode``. Where no K8 kernel ran (a program that
decodes attention otherwise) nothing is read."""

from perfbench import arith
from perfbench.trace import intervals

KERNELS = ("decode_attention_kernel",)


def is_k8_kernel(e) -> bool:
    return e["cat"] == "kernel" and any(k in e["name"] for k in KERNELS)


def read(record):
    trace = record.get("trace")
    d = record.get("dims")
    if not trace or "decode" not in trace["marks"] or not d:
        return None
    lo, hi = trace["marks"]["decode"]
    t = arith.covered(intervals(trace["device"], lo, hi, is_k8_kernel),
                      lo, hi)
    steps = sum(1 for e in trace["device"]
                if e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]
                and lo <= e["start"] < hi)
    if t <= 0 or steps == 0:
        return None
    p = record["profiled"]
    positions = sum(p["plen"] + i + 1 for i in range(steps))
    bound = (p["batch"] * positions * d.kv_bytes_per_token
             / arith.HBM_BYTES_PER_S)
    return 100.0 * bound / t
