"""95th percentile over the window's completed requests of the time from
a request's issue to its first token (the return of the engine's
prefill role, which ends in a device sync), in ms."""

from perfbench import arith


def read(record):
    ttft = [r["ttft_s"] for r in record["requests"]]
    return arith.percentile(ttft, 95) * 1e3 if ttft else None
