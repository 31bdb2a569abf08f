"""Median of the engine's ``serve.decode_step`` spans over the window,
in ms (a host wall that ends in the step's token read back)."""

import statistics


def read(record):
    steps = [s["wall_s"] for s in record.get("decode_steps", ())]
    return statistics.median(steps) * 1e3 if steps else None
