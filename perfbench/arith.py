"""The benchmark's yardstick: the card's published peaks, the operations
and bytes a step needs from its shapes, busy time as a union of intervals,
and percentiles.

Kept in the benchmark's own folder so that a change to the program cannot
move it. ``attention_bound`` and the peaks are copies of the ones in
``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``attention_bound``).
"""

from __future__ import annotations

import dataclasses
import math

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W
# power limit): bf16 on the tensor cores, fp32 outside them, HBM3.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BF16_BYTES = 2


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes a configuration file states, under short names."""
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int                    # the SwiGLU's width, of each expert where
    vocab: int                 # there are experts
    experts: int = 0           # 0: a dense FFN
    top_k: int = 0
    window: int = 0            # 0: full attention

    @classmethod
    def from_config(cls, c: dict) -> "Dims":
        return cls(layers=c["num_hidden_layers"], d=c["hidden_size"],
                   heads=c["num_attention_heads"],
                   kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
                   ff=c["intermediate_size"], vocab=c["vocab_size"],
                   experts=c.get("num_local_experts", 0),
                   top_k=c.get("num_experts_per_tok", 0),
                   window=c.get("sliding_window") or 0)

    @property
    def attn_params(self) -> int:
        """q, k, v and o projections of one layer."""
        return self.d * self.head_dim * (2 * self.heads + 2 * self.kv_heads)

    @property
    def ffn_params(self) -> int:
        """One layer's FFN weights: every expert and the router, or the
        dense SwiGLU."""
        if self.experts:
            return (self.experts * 3 * self.ff + self.experts) * self.d
        return 3 * self.d * self.ff

    @property
    def active_ffn_params(self) -> int:
        """The FFN weights one token multiplies by: its ``top_k`` experts
        and the router, or the dense SwiGLU."""
        if self.experts:
            return (self.top_k * 3 * self.ff + self.experts) * self.d
        return 3 * self.d * self.ff

    @property
    def weight_count(self) -> int:
        """Every parameter: layers (with their two norms), the embedding
        table, the output matrix and the final norm."""
        per_layer = self.attn_params + self.ffn_params + 2 * self.d
        return self.layers * per_layer + 2 * self.vocab * self.d + self.d

    @property
    def kv_bytes_per_token(self) -> int:
        """K and V of one position over every layer, in bf16."""
        return 2 * self.layers * self.kv_heads * self.head_dim * BF16_BYTES

    # The yardstick the per-layer readers take (the ``decoder`` family's
    # ``yardstick``): each the function of the same name below.

    def prefill_flops(self, prompt_lens) -> float:
        return prefill_flops(self, prompt_lens)

    def decode_step_bytes(self, batch: int, context: int) -> float:
        return decode_step_bytes(self, batch, context)

    def prefill_attention_bound(self, batch: int, plen: int) -> float:
        """Least time of a prefill's attention over ``batch`` prompts
        padded to ``plen``, every layer (``attention_bound``)."""
        shape = (batch, self.heads, self.kv_heads, plen, self.head_dim,
                 True, self.window)
        return self.layers * attention_bound(shape)["bound_s"]

    def decode_expert_bytes(self, batch: int) -> float | None:
        """``moe_arith.decode_expert_bytes``; None without experts."""
        from perfbench import moe_arith
        return moe_arith.decode_expert_bytes(self, batch) \
            if self.experts else None

    def prefill_expert_flops(self, tokens: int) -> float | None:
        """``moe_arith.prefill_expert_flops``; None without experts."""
        from perfbench import moe_arith
        return moe_arith.prefill_expert_flops(self, tokens) \
            if self.experts else None


def attended_pairs(n: int, window: int = 0) -> int:
    """(query, key) pairs a causal mask leaves over ``n`` positions; with a
    window each query sees at most its last ``window`` keys, itself
    included."""
    if window <= 0 or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def prefill_flops(dims: Dims, prompt_lens) -> float:
    """Model operations of a prefill over the real, unpadded prompts: two
    per matmul weight a token multiplies by, four per head dimension per
    attended (query, key) pair per head, and the unembedding of each
    prompt's last token."""
    per_token = 2.0 * dims.layers * (dims.attn_params +
                                     dims.active_ffn_params)
    total = 0.0
    for p in prompt_lens:
        total += per_token * p
        total += (4.0 * dims.head_dim * dims.heads * dims.layers *
                  attended_pairs(p, dims.window))
        total += 2.0 * dims.d * dims.vocab
    return total


def decode_step_bytes(dims: Dims, batch: int, context: int) -> float:
    """Bytes one decode step must move at ``batch`` sequences that each
    hold ``context`` cached positions: every weight read once (of the
    embedding table only the ``batch`` rows looked up; every expert, since
    a batch of tens of tokens leaves next to none unhit), the live KV read
    once and the new KV written once, all bf16."""
    table_rows = dims.vocab * dims.d
    weights = (dims.weight_count - table_rows + batch * dims.d) * BF16_BYTES
    kv = batch * (context + 1) * dims.kv_bytes_per_token
    return float(weights + kv)


def attention_bound(shape, dtype: str = "bfloat16") -> dict:
    """Least time for one flash attention call: q, k, v read once and o
    written once, against the products the mask leaves (4 * d FLOP per
    unmasked (query, key) pair per head). ``shape`` is (B, Hq, Hkv, S, d,
    causal, window). A copy of ``chip_smoke.attention_bound``, with the
    pairs counted in closed form rather than from a mask."""
    B, Hq, Hkv, S, d, causal, window = shape
    if not causal and window:
        raise ValueError("a bidirectional window is not counted")
    pairs = attended_pairs(S, window) if causal else S * S
    flops = 4.0 * B * Hq * d * pairs
    item = 2 if dtype == "bfloat16" else 4
    nbytes = float(item * (2 * B * Hq * S * d + 2 * B * Hkv * S * d))
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint, sorted intervals:
    time covered twice (a copy beside a kernel) counts once."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    clipped = [(max(s, lo), min(e, hi)) for s, e in intervals]
    return sum(e - s for s, e in union(clipped))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union((max(s, lo), min(e, hi)) for s, e in intervals):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks, as numpy's default method."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = (len(xs) - 1) * q / 100.0
    lo = math.floor(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)
