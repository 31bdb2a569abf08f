"""Median over the window's completed requests of (completion - first
token) / (tokens decoded after the first), in ms: vLLM's time per output
token, with the first token (made by prefill) counted as output. A short
answer in a batch that decodes a long one pays for the wait.

The median and not a higher percentile: the requests of one batch share
their times, so a run holds ~16 independent samples in an HBM cell and 2-3
offloaded, and a 95th percentile would be the slowest batch alone."""

from perfbench import arith


def read(record):
    tpot = [r["tpot_s"] for r in record["requests"]
            if r["tpot_s"] is not None]
    return arith.percentile(tpot, 50) * 1e3 if tpot else None
