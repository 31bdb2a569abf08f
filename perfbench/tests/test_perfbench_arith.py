"""The yardstick's arithmetic against hand counts."""

import numpy as np
import pytest

from perfbench import arith
from perfbench.reference.weights import leaf_shapes

YI = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 4,
      "num_key_value_heads": 2, "head_dim": 2, "intermediate_size": 16,
      "vocab_size": 32}
MOE = dict(YI, num_local_experts=4, num_experts_per_tok=2)


def test_dims_count_every_weight_the_tree_holds():
    for c in (YI, MOE):
        d = arith.Dims.from_config(c)
        n = sum(int(np.prod(s)) for s in leaf_shapes(c).values())
        assert d.weight_count == n


def test_prefill_flops_by_hand():
    d = arith.Dims.from_config(YI)
    # per layer: q 8x4x2=64, k 8x2x2=32, v 32, o 64 -> 192; ffn 3x8x16=384
    per_token = 2 * 2 * (192 + 384)
    # 3 positions, causal: 6 pairs; 4 * head_dim 2 * heads 4 * 2 layers
    attn = 4 * 2 * 4 * 2 * 6
    unembed = 2 * 8 * 32
    assert arith.prefill_flops(d, [3]) == 3 * per_token + attn + unembed
    assert arith.prefill_flops(d, [3, 3]) == 2 * arith.prefill_flops(d, [3])


def test_prefill_flops_moe_counts_top_k_experts_and_router():
    d = arith.Dims.from_config(MOE)
    per_token = 2 * 2 * (192 + 2 * 3 * 8 * 16 + 8 * 4)
    attn = 4 * 2 * 4 * 2 * 1
    assert arith.prefill_flops(d, [1]) == per_token + attn + 2 * 8 * 32


def test_decode_step_bytes_by_hand():
    d = arith.Dims.from_config(YI)
    layer = 192 + 384 + 2 * 8
    weights = 2 * layer + 8 * 32 + 8 + 3 * 8     # out, final norm, 3 rows
    kv = 3 * (5 + 1) * 2 * 2 * 2 * 2 * 2     # B 3, 5 cached + 1 new; bf16
    assert arith.decode_step_bytes(d, 3, 5) == 2 * weights + kv


def test_decode_step_bytes_moe_reads_every_expert():
    d = arith.Dims.from_config(MOE)
    layer = 192 + 4 * 3 * 8 * 16 + 8 * 4 + 2 * 8
    weights = 2 * layer + 8 * 32 + 8 + 1 * 8
    kv = 1 * 1 * 2 * 2 * 2 * 2 * 2
    assert arith.decode_step_bytes(d, 1, 0) == 2 * weights + kv


@pytest.mark.parametrize("S,window", [(1, 0), (7, 0), (7, 3), (5, 9)])
def test_attended_pairs_against_a_mask(S, window):
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    mask = k <= q
    if window:
        mask &= k > q - window
    assert arith.attended_pairs(S, window) == int(mask.sum())


def test_attention_bound_matches_the_mask_count():
    shape = (2, 4, 2, 64, 16, True, 0)
    b = arith.attention_bound(shape)
    assert b["flops"] == 4.0 * 2 * 4 * 16 * (64 * 65 // 2)
    assert b["bytes"] == 2.0 * (2 * 2 * 4 * 64 * 16 + 2 * 2 * 2 * 64 * 16)
    assert b["bound_s"] == max(b["flops"] / arith.PEAK_FLOPS["bfloat16"],
                               b["bytes"] / arith.HBM_BYTES_PER_S)


def test_union_counts_overlap_once_and_idle_share_stays_non_negative():
    kernel, copy = (0.0, 0.6), (0.4, 1.0)
    assert arith.union([kernel, copy]) == [(0.0, 1.0)]
    busy = arith.covered([kernel, copy], 0.0, 1.0)
    assert busy == pytest.approx(1.0)
    assert 1.0 - busy / 1.0 >= -1e-12
    # summing durations, as a per-kernel sum does, would read 1.2 busy
    assert sum(e - s for s, e in (kernel, copy)) > 1.0


def test_covered_clips_to_the_window_and_gaps_complement_it():
    ivs = [(-1.0, 0.5), (0.7, 0.8), (0.75, 2.0)]
    assert arith.covered(ivs, 0.0, 1.0) == pytest.approx(0.8)
    gaps = arith.gaps(ivs, 0.0, 1.0)
    assert gaps == [(0.5, 0.7)]
    assert arith.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


@pytest.mark.parametrize("q", [0, 50, 95, 100])
def test_percentile_matches_numpy(q):
    xs = [5.0, 1.0, 3.0, 2.0, 8.0, 13.0, 21.0]
    assert arith.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
