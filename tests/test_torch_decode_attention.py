"""Dense GQA decode attention (K8, ``kernels/decode_attention``): the plain
version the CPU runs and the hand-written kernel the card runs.

On the CPU: the model's GQA decode (``attn_decode`` over a full cache, a
ring before and after it wraps, and ``attn_decode_cross``) against the JAX
reference's; the wrapper's CPU path against the moved plain
``decode_attention`` under the mask the decode step used to build; the
split plan; the shapes and dtypes the wrapper refuses.

On a card (``gpu``, skipped without one): K8 against the plain version at
the (G, d) the served models decode with, at live lengths 1, a ragged tile
edge and S, in fp32 and bf16; a ring cache before and after it wraps;
cross-attention; the split kernel and its combine at a batch small enough
to cut each sequence; a captured CUDA graph replayed at three positions
equal to eager calls; the launch count; the refusals on CUDA. Nothing in
the ``gpu`` cases imports JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_decode_attention.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.config.base import get_config
from repro_torch.kernels.decode_attention import (dense_decode_attention,
                                                  dense_decode_attention_ref)
from repro_torch.kernels.decode_attention import ops
from repro_torch.models import attention
from repro_torch.models.attention import decode_attention

# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


def _params(cfg, gen):
    d, Hq, Hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    shapes = {"w_q": (d, Hq, dh), "w_k": (d, Hkv, dh), "w_v": (d, Hkv, dh),
              "w_o": (Hq, dh, d)}
    return {k: torch.randn(s, generator=gen) * 0.3 for k, s in shapes.items()}


def _jax(tree):
    import jax.numpy as jnp
    return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


# (case, arch, cache length, position): a full cache, gemma3's ring (window
# 32 when reduced) before and after it wraps
SELF_CASES = [("full", "yi-9b", 24, 17, 0), ("ring_before_wrap", "gemma3-27b",
                                             32, 20, 32),
              ("ring_after_wrap", "gemma3-27b", 32, 45, 32)]


@pytest.mark.parametrize("case,arch,S,pos,window", SELF_CASES,
                         ids=[c[0] for c in SELF_CASES])
def test_attn_decode_matches_the_reference(case, arch, S, pos, window):
    from repro.config.base import get_config as jax_get_config
    from repro.models import attention as jax_attention
    cfg = get_config(arch).reduced(dtype="float32")
    jcfg = jax_get_config(arch).reduced(dtype="float32")
    gen = torch.Generator().manual_seed(7)
    p = _params(cfg, gen)
    B, Hkv, dh = 3, cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {k: torch.randn(B, S, Hkv, dh, generator=gen) for k in "kv"}
    x = torch.randn(B, 1, cfg.d_model, generator=gen)
    want, want_cache = jax_attention.attn_decode(
        _jax(p), _jax({"x": x})["x"], pos, _jax(cache), jcfg, window=window)
    got_cache = {k: v.clone() for k, v in cache.items()}
    got, _ = attention.attn_decode(p, x, torch.tensor([pos]), got_cache, cfg,
                                   window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for k in "kv":
        np.testing.assert_allclose(got_cache[k].numpy(),
                                   np.asarray(want_cache[k]), rtol=1e-6,
                                   atol=1e-6)


def test_attn_decode_cross_matches_the_reference():
    from repro.config.base import get_config as jax_get_config
    from repro.models import attention as jax_attention
    cfg = get_config("whisper-small").reduced(dtype="float32")
    jcfg = jax_get_config("whisper-small").reduced(dtype="float32")
    gen = torch.Generator().manual_seed(8)
    p = _params(cfg, gen)
    B, S = 2, 40
    kv = {k: torch.randn(B, S, cfg.num_kv_heads, cfg.resolved_head_dim,
                         generator=gen) for k in "kv"}
    x = torch.randn(B, 1, cfg.d_model, generator=gen)
    want = jax_attention.attn_decode_cross(_jax(p), _jax({"x": x})["x"],
                                           _jax(kv), jcfg)
    got = attention.attn_decode_cross(p, x, kv, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _qkv(B, Hq, Hkv, S, d, dtype, gen, device="cpu"):
    q = torch.randn(B, 1, Hq, d, generator=gen).to(dtype)
    k = torch.randn(B, S, Hkv, d, generator=gen).to(dtype)
    v = torch.randn(B, S, Hkv, d, generator=gen).to(dtype)
    return q.to(device), k.to(device), v.to(device)


def _old_mask(S, pos, window):
    """The mask ``attn_decode`` built before it called the wrapper."""
    valid = torch.arange(S) <= pos
    if window > 0:
        valid |= pos >= S
    return valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("pos,window", [(11, 0), (20, 32), (31, 32),
                                        (32, 32), (77, 32)],
                         ids=["full", "ring_before_wrap", "ring_last_slot",
                              "ring_wrapped", "ring_long_after"])
def test_cpu_path_is_the_plain_version_for_rings(pos, window, dtype):
    S = window or 24
    gen = torch.Generator().manual_seed(pos)
    q, k, v = _qkv(2, 8, 2, S, 16, dtype, gen)
    p = torch.tensor([pos])
    want = decode_attention(q, k, v, _old_mask(S, p, window))
    got = dense_decode_attention(q, k, v, p)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(dense_decode_attention_ref(q, k, v, p), want)


def test_cpu_path_is_the_plain_version_for_a_cross_cache():
    gen = torch.Generator().manual_seed(3)
    q, k, v = _qkv(2, 4, 4, 30, 16, torch.float32, gen)
    want = decode_attention(q, k, v, torch.ones(30, dtype=torch.bool))
    assert torch.equal(dense_decode_attention(q, k, v), want)


def test_cpu_path_casts_the_cache_to_q_dtype():
    """As the plain decode did: an fp32 cache under bf16 q is rounded to
    bf16 before it is widened."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = _qkv(2, 4, 2, 20, 16, torch.float32, gen)
    q = q.bfloat16()
    p = torch.tensor([13])
    want = decode_attention(q, k.bfloat16(), v.bfloat16(),
                            _old_mask(20, p, 0))
    assert torch.equal(dense_decode_attention(q, k, v, p), want)


def test_cpu_path_launches_nothing():
    before = dict(kernels.LAUNCHES)
    gen = torch.Generator().manual_seed(5)
    q, k, v = _qkv(1, 2, 1, 8, 16, torch.float32, gen)
    dense_decode_attention(q, k, v, torch.tensor([3]))
    assert kernels.LAUNCHES == before
    assert kernels.FAMILIES["decode_attention"] == ("decode_attention",)


@pytest.mark.parametrize("B,Hkv,S,sms", [(64, 4, 544, 132), (64, 8, 544, 132),
                                         (1, 1, 4096, 132), (2, 16, 48, 132),
                                         (3, 2, 1000, 132), (1, 4, 65, 132),
                                         (7, 1, 1, 132)])
def test_split_plan_covers_the_cache(B, Hkv, S, sms):
    split, per = ops.split_plan(B, Hkv, S, sms)
    assert split * per >= S > (split - 1) * per
    assert per >= min(S, ops.MIN_KEYS)
    assert split == 1 or B * Hkv * split <= ops.BLOCKS_PER_SM * sms
    if B * Hkv >= sms:         # yi-9b's and Mixtral's served batches
        assert split == 1


def _refusal(q, k, v, pos=None):
    with pytest.raises((ValueError, TypeError)):
        ops._check(q, k, v, pos)


def test_check_takes_the_served_shapes():
    for G, d in [(8, 128), (6, 128), (2, 128), (1, 64), (1, 112), (2, 16),
                 (16, 256)]:
        q, k, v = _qkv(2, 2 * G, 2, 40, d, torch.bfloat16,
                       torch.Generator().manual_seed(0))
        assert ops._check(q, k, v, torch.tensor([5])) == (2, 2 * G, 2, d, 40)


def test_check_refuses_what_the_kernel_cannot_take():
    gen = torch.Generator().manual_seed(0)
    q, k, v = _qkv(2, 34, 2, 40, 128, torch.bfloat16, gen)      # G = 17
    _refusal(q, k, v)
    for d in (12, 264):                                         # head dims
        _refusal(*_qkv(2, 4, 2, 40, d, torch.bfloat16, gen))
    q, k, v = _qkv(2, 4, 2, 40, 64, torch.float16, gen)         # dtypes
    _refusal(q, k, v)
    q, k, v = _qkv(2, 4, 2, 40, 64, torch.bfloat16, gen)
    _refusal(q, k.float(), v)                                   # mixed cache
    _refusal(q, k.float(), v.float())                           # q's dtype
    _refusal(q.float(), k, v)
    _refusal(q, k.to(torch.int8), v.to(torch.int8))
    _refusal(q, k, v, torch.tensor([5], dtype=torch.int32))     # pos dtype
    _refusal(q, k, v, torch.tensor([5, 6]))
    _refusal(q.transpose(0, 2).contiguous().transpose(0, 2), k, v)
    _refusal(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)
    _refusal(q, k, v[:1])                                       # shapes
    _refusal(q[:, :, :3], k, v)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

# fp32 against the plain version's fp32: only the order of the sums differs
# (the kernel sums keys in tiles and the plain version in a GEMM), a few
# ulps of each dot product; 2e-5, as K2/K3's fp32 cases.
TOL_FP32 = 2e-5
# bf16: both sides compute in fp32 from the same bf16 q, K and V (the
# products are exact) and round the output to bf16 once, so they may differ
# by one bf16 ulp where the fp32 results straddle a rounding boundary: 2**-8
# relative. A wrong tile or column is off by O(1).
TOL_BF16 = 2 ** -7
REL_L2_BF16 = 4e-3

# (name, Hq, Hkv, d, window) of the served models' decode
MODELS = [("yi-9b", 32, 4, 128, 0), ("mixtral-8x22b", 48, 8, 128, 0),
          ("gemma3-27b_local", 32, 16, 128, 1024),
          ("gemma3-27b_global", 32, 16, 128, 0), ("whisper-small", 12, 12, 64, 0),
          ("zamba2-7b", 32, 32, 112, 0), ("reduced", 4, 2, 16, 0)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=TOL_FP32, atol=TOL_FP32)
    else:
        torch.testing.assert_close(got, want, rtol=TOL_BF16, atol=TOL_BF16)
        rel = ((got - want).norm() / want.norm()).item()
        assert rel <= REL_L2_BF16, rel


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name,Hq,Hkv,d,window", MODELS,
                         ids=[m[0] for m in MODELS])
def test_kernel_matches_plain_at_the_served_shapes_on_card(name, Hq, Hkv, d,
                                                           window, dtype):
    """Live lengths 1, 65 (one past a 64-key tile), 100 (a ragged tile
    edge) and S; a ring (gemma3's local layers: the cache is the window)
    before and after it wraps."""
    dev = _card()
    gen = torch.Generator().manual_seed(11)
    B, S = 4, window or 160
    q, k, v = _qkv(B, Hq, Hkv, S, d, dtype, gen, dev)
    positions = [0, 64, 99, S - 1] + ([S + 37] if window else [])
    for pos in positions:
        p = torch.tensor([pos], device=dev)
        got = dense_decode_attention(q, k, v, p)
        want = dense_decode_attention_ref(q, k, v, p)
        _close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_matches_plain_for_cross_attention_on_card(dtype):
    """whisper-small's cross-attention: 1500 encoder frames, all live."""
    dev = _card()
    gen = torch.Generator().manual_seed(12)
    q, k, v = _qkv(2, 12, 12, 1500, 64, dtype, gen, dev)
    _close(dense_decode_attention(q, k, v),
           dense_decode_attention_ref(q, k, v), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("live", [1, 63, 64, 65, 1000, 2047, 2048])
def test_split_and_combine_on_card(live, dtype):
    """One sequence of 2048 keys over 4 kv heads is cut into many splits:
    the ranges past the live length are empty partials the combine
    skips."""
    dev = _card()
    split, _ = ops.split_plan(1, 4, 2048, ops._sm_count(dev.index or 0))
    assert split > 1
    gen = torch.Generator().manual_seed(live)
    q, k, v = _qkv(1, 32, 4, 2048, 128, dtype, gen, dev)
    p = torch.tensor([live - 1], device=dev)
    _close(dense_decode_attention(q, k, v, p),
           dense_decode_attention_ref(q, k, v, p), dtype)


@pytest.mark.gpu
def test_kernel_reads_the_cache_by_strides_on_card():
    """A layer's view of a stacked (L, B, S, Hkv, d) cache, as the decode
    step hands it over, and a cache of a longer sequence sliced to S."""
    dev = _card()
    gen = torch.Generator().manual_seed(13)
    stacked = torch.randn(3, 2, 96, 4, 128, generator=gen).bfloat16().to(dev)
    k, v = stacked[1], stacked[2, :, :80]
    q = torch.randn(2, 1, 32, 128, generator=gen).bfloat16().to(dev)
    p = torch.tensor([70], device=dev)
    _close(dense_decode_attention(q, k[:, :80], v, p),
           dense_decode_attention_ref(q, k[:, :80], v, p), torch.bfloat16)


@pytest.mark.gpu
def test_captured_graph_replays_at_three_positions_on_card():
    """The live length comes from the position tensor on the device: one
    capture serves every position, bit for bit the eager call's output."""
    dev = _card()
    gen = torch.Generator().manual_seed(15)
    q, k, v = _qkv(8, 32, 4, 544, 128, torch.bfloat16, gen, dev)
    pos = torch.tensor([0], device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dense_decode_attention(q, k, v, pos)          # warm-up, as DecodeGraph
    torch.cuda.current_stream().wait_stream(side)
    before = kernels.LAUNCHES["decode_attention"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dense_decode_attention(q, k, v, pos)
    assert kernels.LAUNCHES["decode_attention"] == before + 1   # at capture
    for at in (511, 3, 543):
        pos.fill_(at)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, dense_decode_attention(q, k, v, pos)), at
        _close(out, dense_decode_attention_ref(q, k, v, pos), torch.bfloat16)
    assert kernels.LAUNCHES["decode_attention"] == before + 4   # eager only


@pytest.mark.gpu
def test_kernel_counts_its_launches_on_card():
    dev = _card()
    q, k, v = _qkv(2, 8, 2, 64, 64, torch.bfloat16,
                   torch.Generator().manual_seed(16), dev)
    before = kernels.LAUNCHES["decode_attention"]
    dense_decode_attention(q, k, v, torch.tensor([9], device=dev))
    dense_decode_attention(q, k, v)
    assert kernels.LAUNCHES["decode_attention"] == before + 2


@pytest.mark.gpu
def test_wrapper_raises_on_what_the_kernel_cannot_take_on_card():
    """No fallback to the plain version on CUDA: an unsupported G, head dim
    or dtype raises, and so does a cache in another dtype than q's."""
    dev = _card()
    gen = torch.Generator().manual_seed(17)
    pos = torch.tensor([3], device=dev)
    for shape, dtype in (((2, 34, 2, 40, 128), torch.bfloat16),
                         ((2, 4, 2, 40, 12), torch.bfloat16),
                         ((2, 4, 2, 40, 64), torch.float16)):
        q, k, v = _qkv(*shape, dtype, gen, dev)
        with pytest.raises((ValueError, TypeError)):
            dense_decode_attention(q, k, v, pos)
    q, k, v = _qkv(2, 8, 2, 40, 64, torch.bfloat16, gen, dev)
    with pytest.raises(TypeError):
        dense_decode_attention(q, k.float(), v.float(), pos)
