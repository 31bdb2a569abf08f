"""Bytes of the host-to-device copies in the profiled decode steps over
their device time (the union of their intervals), in GB/s: the rate the
host link gives the weight fetch."""

from perfbench import arith
from perfbench.trace import intervals


def read(record):
    trace = record.get("trace")
    if not trace or "decode" not in trace["marks"]:
        return None
    lo, hi = trace["marks"]["decode"]
    copies = [e for e in trace["device"]
              if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]
              and e["start"] >= lo and e["end"] <= hi]
    t = arith.covered(intervals(copies, lo, hi), lo, hi)
    nbytes = sum(float(e["bytes"] or 0) for e in copies)
    return nbytes / t / 1e9 if t > 0 and nbytes > 0 else None
