"""Set-up time: process start to the first timed request (torch and CUDA
start, kernel libraries loaded or built, weights drawn on the card from
the seed and, offloaded, pinned, the cell's largest shapes warmed up)."""


def read(record):
    return record["setup_s"]
