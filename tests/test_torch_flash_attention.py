"""repro_torch flash attention vs the reference's Pallas kernel and its ref.

The same numpy inputs go to the reference (``repro.kernels.flash_attention``
in Pallas interpret mode, and ``flash_attention_ref``) and to the port. On
the CPU the port's op runs its plain version; the kernel itself is held
against the plain version by the ``gpu`` tests, on a card. The reference is
imported inside the tests that use it, so the ``gpu`` tests also run where
JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_flash_attention.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.ops import takes_head_dim

# tests/test_kernels.py's tolerances and sweep
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SWEEP = [
    (1, 2, 2, 128, 64, True, 0, 64),     # MHA causal
    (2, 4, 2, 128, 64, True, 0, 64),     # GQA
    (2, 8, 1, 128, 32, True, 0, 32),     # MQA
    (1, 2, 2, 128, 64, False, 0, 64),    # bidirectional
    (1, 2, 2, 256, 64, True, 64, 64),    # sliding window
    (1, 2, 2, 128, 128, True, 0, 128),   # MXU-aligned head dim
]
# head dims the kernel rounds up to an instantiation's: zamba2's attention
# (112) and one between the bf16 instantiations (80); 8, the least it takes
HEAD_DIMS = (8, 16, 32, 64, 80, 112, 128)


def _inputs(B, Hq, Hkv, S, d, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, S, d)), rng.normal(size=(B, Hkv, S, d)),
            rng.normal(size=(B, Hkv, S, d)))


def _jax(a, dtype):
    import jax.numpy as jnp
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,d,causal,window,blk", SWEEP)
def test_plain_matches_reference(dtype, B, Hq, Hkv, S, d, causal, window,
                                 blk):
    from repro.kernels.flash_attention import (flash_attention as jax_flash,
                                               flash_attention_ref as jax_ref)
    q, k, v = _inputs(B, Hq, Hkv, S, d)
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    kern = jax_flash(jq, jk, jv, causal=causal, window=window, q_blk=blk,
                     kv_blk=blk)
    ref = jax_ref(jq, jk, jv, causal=causal, window=window)
    out = flash_attention(*(_torch(a, dtype) for a in (q, k, v)),
                          causal=causal, window=window)
    assert out.dtype == getattr(torch, dtype)
    got = out.float().numpy()
    tol = TOL[dtype]
    for want in (kern, ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (_torch(a, "float32") for a in _inputs(2, 4, 2, 64, 16))
    kernels.reset_launches()
    out = flash_attention(q, k, v, causal=True)
    windowed = flash_attention(q, k, v, causal=True, window=16)
    assert kernels.LAUNCHES["flash_attention"] == 0
    assert kernels.LAUNCHES["flash_attention_windowed"] == 0
    torch.testing.assert_close(out, flash_attention_ref(q, k, v),
                               rtol=0, atol=0)
    torch.testing.assert_close(windowed, flash_attention_ref(q, k, v,
                                                             window=16),
                               rtol=0, atol=0)


@pytest.mark.parametrize("d,causal", [(112, True), (80, True),
                                      (112, False)])
def test_plain_matches_reference_at_other_head_dims(d, causal):
    """The plain version against the reference's Pallas kernel (interpret
    mode) at head dims that are no power of two, zamba2's 112 among them."""
    from repro.kernels.flash_attention import flash_attention as jax_flash
    q, k, v = _inputs(1, 4, 2, 128, d)
    kern = jax_flash(*(_jax(a, "float32") for a in (q, k, v)),
                     causal=causal, q_blk=64, kv_blk=64)
    out = flash_attention(*(_torch(a, "float32") for a in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern, np.float32),
                               rtol=TOL["float32"], atol=TOL["float32"])


def test_head_dim_rule():
    assert all(takes_head_dim(d) for d in HEAD_DIMS)
    assert not any(takes_head_dim(d) for d in (0, 4, 44, 100, 136, 256))


def test_mixed_devices_are_refused():
    q, k, v = (_torch(a, "float32") for a in _inputs(1, 2, 2, 8, 16))
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        flash_attention(q, k.to("meta"), v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,d,causal,window", [
    *(s[:7] for s in SWEEP),
    (1, 4, 2, 100, 16, True, 0),          # ragged edge, reduced head dim
    (4, 32, 4, 1024, 128, True, 0),       # yi-9b prefill
    (1, 4, 2, 200, 112, True, 0),         # zamba2's head dim
    (1, 4, 2, 200, 80, True, 64),         # no instantiation's head dim
    (1, 4, 4, 160, 112, False, 0),        # bidirectional (an encoder)
    (4, 12, 12, 1500, 64, False, 0),      # whisper-small's encoder
    (4, 64, 8, 1024, 128, True, 0),       # qwen2-vl-72b prefill
])
def test_kernel_matches_plain_on_card(dtype, B, Hq, Hkv, S, d, causal,
                                      window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (_torch(a, dtype, "cuda") for a in _inputs(B, Hq, Hkv, S, d))
    before = dict(kernels.LAUNCHES)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert kernels.LAUNCHES["flash_attention_windowed"] == \
        before["flash_attention_windowed"] + bool(window)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        # outputs near 0.05 at S=1024 make 2e-2 absolute loose for bf16:
        # both sides round one fp32 result, so they differ by an ulp or so
        o, r = out.float(), ref.float()
        assert ((o - r).norm() / r.norm()).item() <= 1e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
def test_kernel_reads_model_layout_in_place_on_card():
    """(B, S, H, d) tensors viewed as (B, H, S, d), as attn_forward passes
    them: the output comes back in q's (B, S, H, d) layout."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 96, H, 64, generator=g, device="cuda",
                           dtype=torch.bfloat16).transpose(1, 2)
               for H in (8, 2, 2))
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert out.stride() == q.stride()
    assert out.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(out.float(),
                               flash_attention_ref(q, k, v).float(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["float16", "head_dim_44", "head_dim_136",
                                  "strided_dim"])
def test_kernel_refuses_what_it_does_not_take_on_card(case):
    _card()
    shape, dtype = (1, 2, 64, 64), torch.float32
    if case == "float16":
        dtype = torch.float16
    if case.startswith("head_dim_"):
        shape = (1, 2, 64, int(case.split("_")[-1]))
    q = torch.randn(*shape, device="cuda", dtype=dtype)
    if case == "strided_dim":
        q = torch.randn(*shape[:3], 2 * shape[3], device="cuda")[..., ::2]
    before = kernels.LAUNCHES["flash_attention"]
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, q, q)
    assert kernels.LAUNCHES["flash_attention"] == before


def _model_layout(B, H, S, d, gen, pad=0, offset=0):
    """A bf16 (B, S, H, d) tensor viewed as (B, H, S, d), as attn_forward
    passes it; ``pad`` elements after each row of H * d and ``offset``
    elements before the first make strides and pointers that are not
    16-byte multiples."""
    buf = torch.randn(B, S, offset + H * d + pad, generator=gen,
                      device="cuda").to(torch.bfloat16)
    return buf[..., offset:offset + H * d].unflatten(-1, (H, d)) \
        .transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,S,d,causal,window", [
    (2, 16, 2, 256, 128, True, 0),       # GQA, 8 q heads per KV head
    (1, 8, 1, 300, 128, True, 0),        # S not a multiple of the q tile
    (1, 8, 2, 384, 64, True, 100),       # a window straddling KV tiles
    (1, 4, 4, 200, 128, False, 130),     # bidirectional, windowed
    *((1, 8, 2, 160, d, True, 0) for d in HEAD_DIMS),   # every head dim
    (1, 8, 2, 300, 112, True, 200),      # zamba2's head dim, windowed
    (2, 8, 8, 256, 80, False, 0),        # bidirectional, d between tiles
    (4, 12, 12, 1500, 64, False, 0),     # whisper-small's encoder
    (4, 64, 8, 1024, 128, True, 0),      # qwen2-vl-72b prefill
])
def test_tensor_core_kernel_bf16_on_card(B, Hq, Hkv, S, d, causal, window):
    """The bf16 kernel (wgmma) on the model's (B, S, H, d) layout against
    the plain version: the sweep's bf16 tolerance and relative L2 1e-2."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(S + d)
    q = _model_layout(B, Hq, S, d, g)
    k, v = (_model_layout(B, Hkv, S, d, g) for _ in range(2))
    before = dict(kernels.LAUNCHES)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert kernels.LAUNCHES["flash_attention_windowed"] == \
        before["flash_attention_windowed"] + bool(window)
    assert out.stride() == q.stride()
    o = out.float()
    r = flash_attention_ref(q, k, v, causal=causal, window=window).float()
    torch.testing.assert_close(o, r, rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])
    assert ((o - r).norm() / r.norm()).item() <= 1e-2


@pytest.mark.gpu
def test_tensor_core_kernel_mixed_layouts_on_card():
    """q contiguous (B, H, S, d), k and v (B, S, H, d) views: the copies
    take the three layouts together and agree all the same."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn(2, 8, 320, 128, generator=g, device="cuda").to(
        torch.bfloat16)
    k = _model_layout(2, 2, 320, 128, g)
    v = _model_layout(2, 2, 320, 128, g)
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    o, r = out.float(), flash_attention_ref(q, k, v).float()
    torch.testing.assert_close(o, r, rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])
    assert ((o - r).norm() / r.norm()).item() <= 1e-2


@pytest.mark.gpu
def test_tensor_core_kernel_unaligned_layout_on_card():
    """Row strides and a pointer that are not 16-byte multiples: the bf16
    kernel loads element by element and agrees all the same."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(7)
    q = _model_layout(2, 8, 200, 64, g, pad=4)
    k = _model_layout(2, 2, 200, 64, g, pad=4, offset=1)
    v = _model_layout(2, 2, 200, 64, g, offset=3)
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    o, r = out.float(), flash_attention_ref(q, k, v).float()
    torch.testing.assert_close(o, r, rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])
    assert ((o - r).norm() / r.norm()).item() <= 1e-2


def _attn_case(device, dtype="float32", d=112):
    """Reduced zamba2 attention weights (head dim ``d``) and an input, for
    ``attn_forward``."""
    import dataclasses
    from repro_torch.config.base import ParallelConfig, get_config
    from repro_torch.models.attention import attention_specs
    from repro_torch.models.context import MCtx
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(dtype=dtype),
                              head_dim=d)
    g = torch.Generator(device=device).manual_seed(5)
    p = init_params(attention_specs(cfg), g, device,
                    getattr(torch, dtype))
    x = torch.randn(2, 96, cfg.d_model, generator=g, device=device).to(
        getattr(torch, dtype))
    pos = torch.arange(96, device=device)[None].expand(2, 96)
    mctx = {k: MCtx(ParallelConfig(attention_kernel=k),
                    torch.device(device)) for k in ("eager", "kernel")}
    return cfg, p, x, pos, mctx


@pytest.mark.parametrize("causal", [False, True])
def test_attn_forward_threads_causal_as_reference(causal):
    """attn_forward(causal=...) on both paths (the kernel's plain version
    here) against the reference's attn_forward, at zamba2's head dim."""
    import jax
    from repro.config.base import get_config as jax_get_config
    from repro.models.attention import attn_forward as jax_attn_forward
    from repro_torch.models.attention import attn_forward
    cfg, p, x, pos, mctx = _attn_case("cpu")
    jcfg = jax_get_config("zamba2-7b").reduced(dtype="float32",
                                               head_dim=cfg.head_dim)
    want, _ = jax_attn_forward(jax.tree.map(lambda t: _jax(t.numpy(),
                                                           "float32"), p),
                               _jax(x.numpy(), "float32"),
                               _jax(pos.numpy(), "int32"), jcfg,
                               causal=causal, q_chunk=32)
    for path in ("eager", "kernel"):
        got, _ = attn_forward(p, x, pos, cfg, causal=causal, q_chunk=32,
                              mctx=mctx[path])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=path)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_attn_forward_reaches_kernel_with_causal_on_card(causal):
    """causal=False reaches K1 from attn_forward (one launch), at a head
    dim of 112, and agrees with the eager path on the same weights."""
    _card()
    from repro_torch.models.attention import attn_forward
    cfg, p, x, pos, mctx = _attn_case("cuda", "bfloat16")
    before = kernels.LAUNCHES["flash_attention"]
    got, _ = attn_forward(p, x, pos, cfg, causal=causal,
                          mctx=mctx["kernel"])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want, _ = attn_forward(p, x, pos, cfg, causal=causal,
                           mctx=mctx["eager"])
    o, r = got.float(), want.float()
    assert ((o - r).norm() / r.norm()).item() <= 1e-2


# --------------------------------------------------------------------------
# K1 as a custom op (the dry-run's fake, the mesh path's local heads)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (16, 16, True, 0), (16, 16, True, 5), (16, 16, False, 0),
    (16, 16, False, 4), (7, 9, True, 3)])
def test_k1_flop_formula_counts_attended_pairs(Sq, Skv, causal, window):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention.ops import attended_pairs
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    assert attended_pairs(Sq, Skv, causal, window) == int(mask.sum())
    with FakeTensorMode():
        q = torch.empty(2, 4, Sq, 32)
        k = torch.empty(2, 2, Skv, 32)
        with FlopCounterMode(display=False) as fc:
            out = flash_attention(q, k, k, causal=causal, window=window)
    assert tuple(out.shape) == (2, 4, Sq, 32)
    assert fc.get_total_flops() == 4 * 2 * 4 * 32 * int(mask.sum())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
def test_k1_fake_matches_real_shape_and_strides():
    _need_card()
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(2, 64, 8, 128, device="cuda",
                    dtype=torch.bfloat16).transpose(1, 2)
    k = torch.randn(2, 64, 2, 128, device="cuda",
                    dtype=torch.bfloat16).transpose(1, 2)
    real = flash_attention(q, k, k)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fq, fk = mode.from_tensor(q), mode.from_tensor(k)
        fake = flash_attention(fq, fk, fk)
    assert fake.shape == real.shape and fake.stride() == real.stride()
    assert fake.dtype == real.dtype


@pytest.mark.gpu
def test_k1_on_local_heads_and_counted_once_per_call():
    _need_card()
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.launch.mesh import local_process_group, make_host_mesh
    from repro_torch.models.sharding import distribute
    from torch.distributed.tensor import Shard
    q = torch.randn(2, 8, 128, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(2, 2, 128, 64, device="cuda", dtype=torch.bfloat16)
    with local_process_group("cuda"):
        mesh = make_host_mesh()
        dq = distribute(q, mesh, [Shard(0), Shard(1)])
        dk = distribute(k, mesh, [Shard(0), Shard(1)])
        kernels.reset_launches()
        out = flash_attention(dq.to_local(), dk.to_local(), dk.to_local())
        assert kernels.LAUNCHES["flash_attention"] == 1
    want = flash_attention_ref(q, k, k)
    err = (out.float() - want.float()).norm() / want.float().norm()
    assert err.item() < 1e-2
