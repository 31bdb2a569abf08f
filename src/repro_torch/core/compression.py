"""The int8 block compression model: wire bytes and expected error.

The port's copy of ``int8_compression_factor`` and
``expected_int8_rel_error`` from the reference's
``repro/core/compression.py`` (pure arithmetic that
``heimdall.kv_quant.bench_summary`` reads); its tree-level quantizer and
``compressed_pod_mean`` come with the training slice.
"""

from __future__ import annotations

import math

import torch

BLOCK = 256


def int8_compression_factor(dtype="bfloat16", block: int = BLOCK) -> float:
    """Wire-byte compression of blockwise int8 vs the fp dtype.

    One f32 scale rides with each ``block``-element int8 payload, so the
    factor is ``itemsize * block / (block + 4)`` — ~2x for bf16 KV pages
    (block = page_size * head_dim per (page, kv_head)), ~4x for f32 state.
    ``dtype`` is a ``torch.dtype`` or its name.
    """
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return dtype.itemsize * block / (block + 4)


def expected_int8_rel_error(block: int = BLOCK) -> float:
    """Expected relative RMS error of symmetric per-block int8 quant on
    roughly Gaussian data (what KV activations look like).

    Round-to-nearest error per element is ~U(-s/2, s/2) with
    s = absmax / 127; for an N(0, σ²) block E[absmax] ≈ σ·sqrt(2·ln block),
    giving rel RMS error ≈ sqrt(2·ln block) / (127·sqrt(12)). Grows only
    as sqrt(log) in block size — why per-(page, head) blocks are safe.
    """
    return math.sqrt(2 * math.log(block)) / (127 * math.sqrt(12.0))
