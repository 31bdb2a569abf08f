"""1 - (union of the device's kernel, copy and memset intervals) / wall,
over the profiled decode steps, in %."""

from perfbench import arith
from perfbench.trace import intervals


def read(record):
    trace = record.get("trace")
    if not trace or "decode" not in trace["marks"]:
        return None
    lo, hi = trace["marks"]["decode"]
    if not any(True for _ in intervals(trace["device"], lo, hi)):
        return None
    return 100.0 * (1.0 - arith.covered(
        intervals(trace["device"], lo, hi), lo, hi) / (hi - lo))
