"""RMS norm (K9, with its residual add) and rope (K10), ``kernels/norm_rope``:
the plain versions the CPU runs and the hand-written kernels the card runs.

On the CPU: the plain versions against the JAX reference's ``rmsnorm`` and
``apply_rope`` in fp32 and bf16; ``add_rmsnorm`` against ``x + a`` then
``rmsnorm``; rope over MLA's strided slice, a stride-0 decode position and
M-RoPE's (t, h, w) positions against the plain chain on contiguous
copies; the layer's dispatch by grad mode (the plain chain and today's
gradients where a gradient is recorded, the op where none is); each op's
fake against the op's output under ``FakeTensorMode``.

On a card (``gpu``, skipped without one): K9 and K10 against their plain
versions at the served widths (yi-9b, Mixtral, MLA's latents and rope
slice, whisper, an odd width), rope and the residual sum bit for bit and
the normed rows within one bf16 ulp; a decode block captured in a CUDA
graph replayed at two positions equal to eager steps; the launch counts
of a prefill and a decode; a profiled yi-shaped decode block without the
plain chains' aten kernels. Nothing in the ``gpu`` cases imports JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_norm_rope.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.config.base import get_config
from repro_torch.kernels import norm_rope
from repro_torch.kernels.norm_rope import ops
from repro_torch.models import layers
from repro_torch.models.layers import _rope_freqs, mrope_sections

ATOL = 1e-5                 # the reference's layer tests (fp32)
BF16_ULP = 2.0 ** -7        # one bf16 ulp, relative: XLA and torch may round
                            # the fp32 chain's last bit apart before the cast

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["float32", "bfloat16"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _close_ref(got: torch.Tensor, want, dtype) -> None:
    tol = ATOL if dtype == torch.float32 else BF16_ULP
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _jdtype(dtype):
    import jax.numpy as jnp
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n", [64, 768, 1000])
def test_rmsnorm_matches_the_reference(n, dtype):
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(2, 5, n)) * 3).astype(np.float32)
    w = rng.normal(size=(n,)).astype(np.float32)
    tx, tw = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    want = jlayers.rmsnorm(jnp.asarray(x, _jdtype(dtype)),
                           jnp.asarray(w, _jdtype(dtype)), 1e-6)
    for got in (norm_rope.rmsnorm(tx, tw, 1e-6),
                norm_rope.rmsnorm_ref(tx, tw, 1e-6),
                layers.rmsnorm(tx, tw, 1e-6)):
        assert got.dtype == dtype
        _close_ref(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("mrope", [False, True], ids=["rope", "mrope"])
def test_rope_matches_the_reference(mrope, dtype):
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, D, theta = 2, 7, 4, 2, 32, 1e6
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(500, 500 + S), (B, S)).astype(np.int64)
    if mrope:
        pos = np.stack([pos, pos // 3, pos % 5])
    tq, tk = torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype)
    got_q, got_k = layers.rope(tq, tk, torch.from_numpy(pos), theta, mrope)
    for got, x in ((got_q, q), (got_k, k)):
        assert got.dtype == dtype
        want = jlayers.apply_rope(jnp.asarray(x, _jdtype(dtype)),
                                  jnp.asarray(pos), theta, mrope)
        _close_ref(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_add_rmsnorm_is_the_add_then_the_norm(dtype):
    gen = torch.Generator().manual_seed(1)
    x, a = (torch.randn(3, 4, 96, generator=gen).to(dtype) for _ in range(2))
    w = torch.randn(96, generator=gen).to(dtype)
    s, h = norm_rope.add_rmsnorm(x, a, w, 1e-5)
    assert torch.equal(s, x + a)
    assert torch.equal(h, layers.rmsnorm(x + a, w, 1e-5))
    s2, h2 = layers.add_rmsnorm(x, a, w, 1e-5)
    assert torch.equal(s2, s) and torch.equal(h2, h)


def _rope_both(q, k, positions, theta=1e4, mrope=False):
    """The op and the plain chain on contiguous copies."""
    got = layers.rope(q, k, positions, theta, mrope)
    want = [layers.apply_rope(t.contiguous(), positions.contiguous(), theta,
                              mrope) for t in (q, k) if t is not None]
    return [g for g in got if g is not None], want


def test_rope_reads_a_strided_mla_slice_bit_for_bit():
    """MLA turns q[..., nope:] of its (B, S, H, nope + rope) heads and its
    (B, S, 1, rope) shared key."""
    gen = torch.Generator().manual_seed(2)
    heads = torch.randn(2, 5, 4, 48, generator=gen).bfloat16()
    k_rope = torch.randn(2, 5, 64, generator=gen).bfloat16()[:, :, None, :16]
    pos = torch.arange(5)[None].expand(2, 5)
    for q in (heads[..., 32:], k_rope):
        got, want = _rope_both(q, None, pos)
        assert got[0].is_contiguous() and torch.equal(got[0], want[0])


def test_rope_reads_a_stride_zero_decode_position():
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(3, 1, 4, 16, generator=gen)
    k = torch.randn(3, 1, 2, 16, generator=gen)
    pos = torch.tensor([537]).expand(3, 1)
    assert pos.stride() == (0, 1)
    got, want = _rope_both(q, k, pos)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got, want = _rope_both(q, k, pos.expand(3, 3, 1), mrope=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_rope_turns_mrope_axes_by_section():
    """Distinct (t, h, w) rows: each section of the frequencies turns with
    its own axis; equal rows give plain RoPE."""
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(2, 6, 4, 32, generator=gen)
    k = torch.randn(2, 6, 2, 32, generator=gen)
    t = torch.arange(6)[None].expand(2, 6)
    pos = torch.stack([t, t // 2, t % 3])
    got, want = _rope_both(q, k, pos, mrope=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    same = layers.rope(q, k, t.expand(3, 2, 6), 1e4, True)
    plain = layers.rope(q, k, t, 1e4, False)
    assert all(torch.equal(a, b) for a, b in zip(same, plain))
    assert not torch.equal(got[0], plain[0])


def _spy(monkeypatch):
    calls = []
    for name in ("rmsnorm", "add_rmsnorm", "rope"):
        real = getattr(norm_rope, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(norm_rope, name, spy)
    return calls


def test_grad_mode_keeps_the_plain_chain_and_its_gradients(monkeypatch):
    """A tensor that requires grad under grad mode: the plain chains, and
    gradients equal to the plain chain's; without a recorded gradient
    (inference, or no tensor that requires grad) the ops."""
    calls = _spy(monkeypatch)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 3, 32, generator=gen, requires_grad=True)
    a = torch.randn(2, 3, 32, generator=gen)
    w = torch.randn(32, generator=gen, requires_grad=True)
    q = torch.randn(2, 3, 4, 16, generator=gen, requires_grad=True)
    pos = torch.arange(3)[None].expand(2, 3)

    s, h = layers.add_rmsnorm(x, a, w, 1e-6)
    qr = layers.rope(q, None, pos, 1e4)[0]
    loss = (layers.rmsnorm(h, w) * 1.5).sum() + s.sum() + (qr * qr).sum()
    loss.backward()
    assert calls == []
    grads = [t.grad.clone() for t in (x, w, q)]

    for t in (x, w, q):
        t.grad = None
    s2 = x + a
    h2 = norm_rope.rmsnorm_ref(s2, w, 1e-6)
    qr2 = layers.apply_rope(q, pos, 1e4)
    loss2 = ((norm_rope.rmsnorm_ref(h2, w, 1e-6) * 1.5).sum() + s2.sum()
             + (qr2 * qr2).sum())
    loss2.backward()
    for g, t in zip(grads, (x, w, q)):
        assert torch.equal(g, t.grad)

    with torch.inference_mode():
        layers.add_rmsnorm(x, a, w)
        layers.rmsnorm(x, w)
        layers.rope(q, q, pos, 1e4)
    layers.rmsnorm(a, torch.ones(32))        # grad mode, nothing requires it
    assert calls == ["add_rmsnorm", "rmsnorm", "rope", "rmsnorm"]


def _fake_vs_real(fn, *args):
    from torch._subclasses.fake_tensor import FakeTensorMode
    real = fn(*args)
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
    with mode:
        fake = fn(*fake_args)
    real = real if isinstance(real, (list, tuple)) else [real]
    fake = fake if isinstance(fake, (list, tuple)) else [fake]
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        if r is None:
            assert f is None
            continue
        assert (f.shape, f.stride(), f.dtype) == (r.shape, r.stride(),
                                                  r.dtype)
        assert r.is_contiguous()


def test_fakes_give_the_kernels_shapes_and_strides():
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 3, 64, generator=gen).bfloat16()
    w = torch.randn(64, generator=gen)
    _fake_vs_real(norm_rope.rmsnorm, x, w, 1e-6)
    _fake_vs_real(norm_rope.add_rmsnorm, x, x * 2, w, 1e-6)
    heads = torch.randn(2, 3, 4, 48, generator=gen).bfloat16()
    k = torch.randn(2, 3, 1, 32, generator=gen).bfloat16()
    pos = torch.tensor([9]).expand(2, 3)
    freqs = _rope_freqs(16, 1e4, torch.device("cpu"))
    _fake_vs_real(norm_rope.rope, heads[..., 16:], k, pos, freqs, [])
    _fake_vs_real(norm_rope.rope, heads[..., 16:], None, pos, freqs, [])
    _fake_vs_real(norm_rope.rope, heads[..., 16:], None, pos.expand(3, 2, 3),
                  freqs, mrope_sections(16))


@pytest.mark.parametrize("n,size,vec,plan", [
    (4096, 2, True, (128, 2)),      # yi-9b: 512 chunks of 8
    (6144, 2, True, (192, 1)),      # Mixtral
    (512, 2, True, (32, 8)),        # MLA's kv latent: 64 chunks
    (1536, 2, True, (64, 4)),       # MLA's q latent
    (768, 4, True, (64, 4)),        # whisper, fp32: 192 chunks of 4
    (1000, 2, False, (128, 2)),     # an odd width: single elements
])
def test_norm_plan(n, size, vec, plan):
    tpr, rpb = ops.norm_plan(n, size, vec)
    assert (tpr, rpb) == plan
    chunks = n // (16 // size) if vec else n
    assert tpr % 32 == 0 and tpr * ops._chunks(vec) >= chunks
    assert tpr * rpb <= 1024


def test_ops_refuse_what_the_kernels_cannot_take():
    x = torch.randn(2, 8)
    with pytest.raises(ValueError):
        ops._check_norm(x, torch.ones(7), None)
    with pytest.raises(ValueError):
        ops._check_norm(x, torch.ones(8), torch.randn(2, 8).bfloat16())
    with pytest.raises(TypeError):
        ops._check_norm(x.half(), torch.ones(8), None)
    q = torch.randn(2, 3, 4, 16)
    freqs = torch.ones(8)
    pos = torch.zeros(2, 3, dtype=torch.long)
    with pytest.raises(ValueError):       # k of another sequence length
        ops._check_rope(q, torch.randn(2, 4, 1, 16), pos, freqs, [])
    with pytest.raises(TypeError):
        ops._check_rope(q, None, pos.float(), freqs, [])
    with pytest.raises(ValueError):       # M-RoPE wants (3, B, S)
        ops._check_rope(q, None, pos, freqs, [2, 3, 3])
    with pytest.raises(ValueError):
        ops._check_rope(q.transpose(-1, -2), None, pos, freqs, [])
    with pytest.raises(ValueError):
        ops.norm_plan(80000, 2, True)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

# (name, n) rows K9 norms in the served and zoo models
NORM_WIDTHS = [("yi-9b", 4096), ("mixtral-8x22b", 6144), ("mla_kv", 512),
               ("mla_q", 1536), ("whisper-small", 768), ("odd", 1000)]
# (name, Hq, Hkv, D, nope): heads K10 turns; MLA turns the last 64 of
# 192-wide query heads (a strided slice) and one shared 64-wide key
ROPE_SHAPES = [("yi-9b", 32, 4, 128, 0), ("mixtral-8x22b", 48, 8, 128, 0),
               ("mla", 16, 1, 64, 128), ("zamba2-7b", 32, 32, 112, 0),
               ("odd", 3, 1, 10, 0)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in bf16 ulps of want's magnitude."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2 ** -126)))
                     - 7)
    return int(((g - w).abs() / ulp).max().ceil().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name,n", NORM_WIDTHS, ids=[w[0] for w in NORM_WIDTHS])
def test_norm_kernel_matches_plain_on_card(name, n, dtype):
    """The sum of x + a bit for bit; the normed rows within one bf16 ulp in
    bf16 (the sum of squares is added in another order, so the scale can
    round apart in its last fp32 bit) and 1e-6 relative in fp32; 1000 rows
    and 3 (a decode-sized batch); weights in the activation dtype and in
    fp32."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(n)
    for rows in (1000, 3):
        x = (torch.randn(rows, n, generator=gen, device=dev) * 3).to(dtype)
        a = torch.randn(rows, n, generator=gen, device=dev).to(dtype)
        for w in (torch.randn(n, generator=gen, device=dev).to(dtype),
                  torch.randn(n, generator=gen, device=dev)):
            got = norm_rope.rmsnorm(x, w, 1e-5)
            want = norm_rope.rmsnorm_ref(x, w, 1e-5)
            s, h = norm_rope.add_rmsnorm(x, a, w, 1e-5)
            s_ref, h_ref = norm_rope.add_rmsnorm_ref(x, a, w, 1e-5)
            assert torch.equal(s, s_ref)
            for g, r in ((got, want), (h, h_ref)):
                assert g.dtype == dtype and g.shape == r.shape
                if dtype == torch.bfloat16:
                    assert _ulps(g, r) <= 1
                else:
                    torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name,Hq,Hkv,D,nope", ROPE_SHAPES,
                         ids=[r[0] for r in ROPE_SHAPES])
def test_rope_kernel_is_bit_equal_to_plain_on_card(name, Hq, Hkv, D, nope,
                                                   dtype):
    """A prefill (positions 0..S-1 over B rows), decode positions as the
    step expands them (stride 0, up to ~540 rad), and M-RoPE's three axes,
    bit for bit the plain chain."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(D + Hq)
    B, S = 3, 40
    heads = torch.randn(B, S, Hq, nope + D, generator=gen,
                        device=dev).to(dtype)
    q = heads[..., nope:]
    k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
    freqs = _rope_freqs(D // 2, 1e6, dev)
    t = torch.arange(S, device=dev)[None].expand(B, S)
    step = torch.tensor([537], device=dev)
    cases = [(q, k, t, []), (q[:, :1], k[:, :1], step.expand(B, 1), []),
             (q, k, torch.stack([t, t // 2, t % 5]), mrope_sections(D // 2)),
             (q, None, t, [])]
    for qq, kk, pos, secs in cases:
        got = norm_rope.rope(qq, kk, pos, freqs, secs)
        want = norm_rope.rope_ref(qq, kk, pos, freqs, secs)
        for g, w in zip(got, want):
            assert g.is_contiguous() and torch.equal(g, w), (name, secs)


def _reduced_yi(dev):
    from repro_torch.models.model import Model
    cfg = get_config("yi-9b").reduced(dtype="bfloat16")
    model = Model.create(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    return cfg, model


def _first_layer(tree):
    return {k: _first_layer(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


@pytest.mark.gpu
def test_decode_block_graph_replays_at_two_positions_on_card():
    """One reduced yi-9b decode block, K9, K10 and K8 inside, captured
    once and replayed at two positions: equal to eager steps, output and
    cache."""
    from repro_torch.models import decode as decode_mod
    dev = _card()
    cfg, model = _reduced_yi(dev)
    p = _first_layer(model.params["decoder"])
    B, S = 4, 64
    Hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(3)
    cache0 = {k: torch.randn(B, S, Hkv, dh, generator=gen,
                             device=dev).bfloat16() for k in "kv"}
    x = torch.randn(B, 1, cfg.d_model, generator=gen, device=dev).bfloat16()
    pos = torch.tensor([0], device=dev)

    def step(cache):
        return decode_mod._attn_block_dec(p, x, pos, cache, cfg, None,
                                          window=0)
    with torch.inference_mode():
        cache = {k: v.clone() for k, v in cache0.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(cache)                                  # warm-up
        torch.cuda.current_stream().wait_stream(side)
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step(cache)
        for name, n in (("rmsnorm", 1), ("add_rmsnorm", 1), ("rope", 1)):
            assert kernels.LAUNCHES[name] == before[name] + n   # at capture
        for at in (37, 50):
            pos.fill_(at)
            for k in "kv":
                cache[k].copy_(cache0[k])
            graph.replay()
            torch.cuda.synchronize()
            eager_cache = {k: v.clone() for k, v in cache0.items()}
            eager = step(eager_cache)
            assert torch.equal(out, eager), at
            for k in "kv":
                assert torch.equal(cache[k], eager_cache[k]), at


@pytest.mark.gpu
def test_prefill_and_decode_count_their_launches_on_card():
    """A reduced yi-9b on the card: a prefill launches one K9 for each
    block's first norm and one for the final norm, one add + norm and one
    K10 a block; a decode step the same."""
    dev = _card()
    cfg, model = _reduced_yi(dev)
    params, L = model.params, cfg.num_layers
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=dev)
    want = {"rmsnorm": L + 1, "add_rmsnorm": L, "rope": L}
    with torch.inference_mode():
        before = dict(kernels.LAUNCHES)
        logits, cache = model.prefill(params, {"tokens": tokens}, 32)
        assert {k: kernels.LAUNCHES[k] - before[k] for k in want} == want
        before = dict(kernels.LAUNCHES)
        model.decode(params, cache, logits.argmax(-1)[:, -1:],
                     torch.tensor([16], device=dev))
        assert {k: kernels.LAUNCHES[k] - before[k] for k in want} == want


# aten kernels of the plain chains: casts, square, mean, rsqrt, cos, sin,
# the rotation's products and its cat
PLAIN_CHAIN_KERNELS = ("at::native::reduce_kernel", "rsqrt_kernel",
                       "cos_kernel", "sin_kernel", "pow_tensor_scalar",
                       "CatArrayBatchedCopy")


@pytest.mark.gpu
def test_profiled_decode_block_launches_no_plain_chain_on_card():
    """A yi-9b-shaped decode block (d 4096, 32 / 4 heads of 128, bf16, 64
    sequences): K9 twice, K10 once, and none of the plain chains' aten
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode as decode_mod
    from repro_torch.models.attention import attention_specs
    from repro_torch.models.layers import mlp_specs, rmsnorm_spec
    dev = _card()
    cfg = get_config("yi-9b")
    d = cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(9)

    def leaf(spec):
        return (torch.randn(*spec.shape, generator=gen, device=dev)
                * 0.02).bfloat16()
    p = {"ln1": rmsnorm_spec(d), "attn": attention_specs(cfg),
         "ln2": rmsnorm_spec(d), "mlp": mlp_specs(d, cfg.d_ff)}
    p = {k: ({n: leaf(s) for n, s in v.items()} if isinstance(v, dict)
             else leaf(v)) for k, v in p.items()}
    B, S = 64, 544
    cache = {k: torch.zeros(B, S, cfg.num_kv_heads, cfg.resolved_head_dim,
                            device=dev, dtype=torch.bfloat16) for k in "kv"}
    x = torch.randn(B, 1, d, generator=gen, device=dev).bfloat16()
    pos = torch.tensor([300], device=dev)
    with torch.inference_mode():
        decode_mod._attn_block_dec(p, x, pos, cache, cfg, None, window=0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            decode_mod._attn_block_dec(p, x, pos, cache, cfg, None, window=0)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("rmsnorm_kernel" in n for n in names) == 2, names
    assert sum("rope_kernel" in n for n in names) == 1, names
    bad = [n for n in names if any(c in n for c in PLAIN_CHAIN_KERNELS)]
    assert not bad, bad
