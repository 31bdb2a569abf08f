"""Model FLOPs of the real, unpadded prompt tokens of a batch (the
yardstick's ``prefill_flops``) over its ``serve.prefill`` span, against
the card's bf16 peak (989 TFLOP/s), in %; the median over the window's
batches. Padding, and in an offloaded cell the weight fetch inside the
span, lower it."""

import statistics

from perfbench import arith


def read(record):
    shares = [100.0 * record["dims"].prefill_flops(p["prompt_lens"])
              / p["wall_s"] / arith.PEAK_FLOPS["bfloat16"]
              for p in record.get("prefills", ())]
    return statistics.median(shares) if shares else None
