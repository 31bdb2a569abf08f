"""Device time of the host-to-device copies (the union of their
intervals) over the wall of the profiled decode steps, in %: the share of
a step the weight fetch from the host tier holds the card."""

from perfbench import arith
from perfbench.trace import intervals


def _h2d(e):
    return e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]


def read(record):
    trace = record.get("trace")
    if not trace or "decode" not in trace["marks"]:
        return None
    lo, hi = trace["marks"]["decode"]
    ivs = intervals(trace["device"], lo, hi, _h2d)
    return 100.0 * arith.covered(ivs, lo, hi) / (hi - lo) if ivs else None
