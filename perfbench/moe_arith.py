"""What the expert layers of a sparse MoE decoder must move and compute,
from the configuration's shapes: the yardstick of the
``moe_experts_roofline`` metrics. Beside ``arith.py`` (whose peaks it
uses) and, like it, in the benchmark's own folder."""

from __future__ import annotations

from perfbench.arith import BF16_BYTES, Dims


def expert_weight_bytes(dims: Dims) -> float:
    """Every expert's gate, up and down matrices over every layer, bf16."""
    return float(dims.layers * dims.experts * 3 * dims.d * dims.ff
                 * BF16_BYTES)


def decode_expert_bytes(dims: Dims, batch: int) -> float:
    """Bytes the expert layers of one decode step must move at ``batch``
    sequences: every expert's weights read once (a batch of tens of
    tokens leaves next to none unhit) and, in each layer, the routed rows
    read once and their outputs written once (``batch * top_k`` rows of
    ``d`` each way), all bf16."""
    rows = dims.layers * 2 * batch * dims.top_k * dims.d * BF16_BYTES
    return expert_weight_bytes(dims) + rows


def prefill_expert_flops(dims: Dims, tokens: int) -> float:
    """Operations of the expert layers over ``tokens`` routed tokens: each
    of their ``top_k`` (token, expert) pairs in each layer multiplies by
    the expert's gate, up and down matrices, two operations per weight."""
    return 2.0 * 3 * dims.d * dims.ff * tokens * dims.top_k * dims.layers
