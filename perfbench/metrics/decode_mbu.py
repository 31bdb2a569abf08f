"""Bytes a decode step must move (the yardstick's ``decode_step_bytes``:
every weight read once, every expert included; the live KV read once; the
new KV written) over the step's ``serve.decode_step`` span, against the
card's 3.35 TB/s, in %; the median over the window's steps."""

import statistics

from perfbench import arith


def read(record):
    shares = [100.0 * record["dims"].decode_step_bytes(s["batch"],
                                                       s["context"])
              / s["wall_s"] / arith.HBM_BYTES_PER_S
              for s in record.get("decode_steps", ())]
    return statistics.median(shares) if shares else None
