"""repro_torch paged decode attention (fp and int8) vs the reference's.

The same numpy inputs go to the reference (``repro.kernels.
paged_attention``: the Pallas kernels in interpret mode, and the ``_ref``
versions) and to the port. On the CPU the port's ops run their plain
versions; the kernels themselves are held against the plain versions by the
``gpu`` tests, on a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_paged_attention.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_quant,
                                                 paged_attention_quant_ref,
                                                 paged_attention_ref)
from repro_torch.kernels.paged_attention.ops import (MAX_PER, block_pages,
                                                     split_plan)
from repro_torch.kernels.quant import quantize_pages, quantize_pages_ref

# tests/test_kernels.py's and tests/test_kv_quant.py's tolerances and sweeps
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FP_SWEEP = [(2, 4, 2, 64, 16, 4), (3, 4, 4, 32, 8, 8), (1, 8, 1, 128, 32, 2)]
QUANT_SWEEP = [*FP_SWEEP, (2, 16, 2, 128, 64, 3)]


def _inputs(B, Hq, Hkv, d, page, pps, seed=7, lens=None):
    rng = np.random.default_rng(seed)
    n_pages = B * pps + 4
    q = rng.normal(size=(B, Hq, d))
    kp = rng.normal(size=(n_pages, page, Hkv, d))
    vp = rng.normal(size=(n_pages, page, Hkv, d))
    bt = rng.permutation(n_pages)[:B * pps].reshape(B, pps).astype(np.int32)
    sl = rng.integers(1, pps * page + 1, B).astype(np.int32)
    if lens is not None:
        sl = np.asarray(lens, np.int32)
    return q, kp, vp, bt, sl


def _torch(a, dtype=None, device="cpu"):
    t = torch.from_numpy(np.asarray(a))
    return t.to(device=device,
                dtype=getattr(torch, dtype) if dtype else t.dtype)


def _jax(a, dtype=None):
    import jax.numpy as jnp
    return jnp.asarray(a, getattr(jnp, dtype) if dtype else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,d,page,pps", FP_SWEEP)
def test_plain_matches_reference(dtype, B, Hq, Hkv, d, page, pps):
    from repro.kernels.paged_attention import (
        paged_attention as jax_kernel, paged_attention_ref as jax_ref)
    q, kp, vp, bt, sl = _inputs(B, Hq, Hkv, d, page, pps)
    jargs = (*(_jax(a, dtype) for a in (q, kp, vp)), _jax(bt), _jax(sl))
    out = paged_attention(*(_torch(a, dtype) for a in (q, kp, vp)),
                          _torch(bt), _torch(sl))
    assert out.dtype == getattr(torch, dtype)
    for want in (jax_kernel(*jargs), jax_ref(*jargs)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,Hq,Hkv,d,page,pps", QUANT_SWEEP)
def test_quant_plain_matches_reference(B, Hq, Hkv, d, page, pps):
    """int8 pools from the port's quantize_pages (equal to the reference's
    quantize_pages_ref): exact against the reference's dequantize-then-
    attend, and within quantization error of the fp attention."""
    from repro.kernels.paged_attention import (
        paged_attention_quant as jax_kernel,
        paged_attention_quant_ref as jax_ref,
        paged_attention_ref as jax_fp_ref)
    q, kp, vp, bt, sl = _inputs(B, Hq, Hkv, d, page, pps)
    kq, ks = quantize_pages(_torch(kp, "float32"))
    vq, vs = quantize_pages(_torch(vp, "float32"))
    out = paged_attention_quant(_torch(q, "float32"), kq, vq, ks, vs,
                                _torch(bt), _torch(sl)).numpy()
    jargs = (_jax(q, "float32"), *(_jax(t.numpy()) for t in (kq, vq, ks, vs)),
             _jax(bt), _jax(sl))
    for want in (jax_kernel(*jargs), jax_ref(*jargs)):
        np.testing.assert_allclose(out, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    fp = jax_fp_ref(*(_jax(a, "float32") for a in (q, kp, vp)), _jax(bt),
                    _jax(sl))
    np.testing.assert_allclose(out, np.asarray(fp), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("lens", [[37, 0, 64], [0, 0, 0]])
@pytest.mark.parametrize("quant", [False, True])
def test_zero_length_rows_attend_to_exact_zeros(lens, quant):
    """A zero-length row's padded block-table entries alias live pages;
    both versions must mask them to exact zeros (tests/test_pager.py's
    zero-length cases), and agree with the reference elsewhere."""
    from repro.kernels.paged_attention import (
        paged_attention as jax_fp, paged_attention_quant as jax_q)
    q, kp, vp, bt, sl = _inputs(3, 8, 2, 64, 16, 4, lens=lens)
    tq, tbt, tsl = _torch(q, "float32"), _torch(bt), _torch(sl)
    if quant:
        kq, ks = quantize_pages(_torch(kp, "float32"))
        vq, vs = quantize_pages(_torch(vp, "float32"))
        out = paged_attention_quant(tq, kq, vq, ks, vs, tbt, tsl).numpy()
        want = jax_q(_jax(q, "float32"),
                     *(_jax(t.numpy()) for t in (kq, vq, ks, vs)),
                     _jax(bt), _jax(sl))
    else:
        out = paged_attention(tq, _torch(kp, "float32"),
                              _torch(vp, "float32"), tbt, tsl).numpy()
        want = jax_fp(*(_jax(a, "float32") for a in (q, kp, vp)),
                      _jax(bt), _jax(sl))
    assert np.isfinite(out).all()
    zero = np.asarray(lens) == 0
    np.testing.assert_array_equal(out[zero], np.zeros_like(out[zero]))
    np.testing.assert_allclose(out, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    q, kp, vp, bt, sl = (_torch(a) for a in _inputs(2, 4, 2, 64, 16, 4))
    q, kp, vp = q.float(), kp.float(), vp.float()
    kq, ks = quantize_pages_ref(kp)
    vq, vs = quantize_pages_ref(vp)
    kernels.reset_launches()
    out = paged_attention(q, kp, vp, bt, sl)
    out_q = paged_attention_quant(q, kq, vq, ks, vs, bt, sl)
    assert kernels.LAUNCHES["paged_attention"] == 0
    assert kernels.LAUNCHES["paged_attention_quant"] == 0
    assert torch.equal(out, paged_attention_ref(q, kp, vp, bt, sl))
    assert torch.equal(out_q, paged_attention_quant_ref(q, kq, vq, ks, vs,
                                                        bt, sl))


# (B, Hq, Hkv, d, page, pps, lens): the split kernel's edge cases: a
# zero-length row, rows shorter than one split (one position, exactly one
# page, one page and one position), pps not a multiple of the split count,
# one long sequence cut into many splits
SPLIT_CASES = [
    (3, 8, 2, 64, 16, 4, [37, 0, 64]),
    (8, 8, 4, 32, 16, 9, [150, 1, 16, 17, 0, 144, 90, 33]),
    (4, 8, 8, 32, 8, 23, [184, 9, 100, 1]),
    (1, 8, 2, 32, 16, 40, [637]),
]
# SM counts for the plan: an H100's, and small ones that give other splits
PLAN_SMS = [132, 3]


@pytest.mark.parametrize("sms", [132, 16, 3, 1])
@pytest.mark.parametrize("B,Hkv,pps", [(16, 4, 33), (1, 4, 128), (2, 2, 4),
                                        (8, 8, 23), (64, 8, 1), (1, 1, 1000)])
def test_split_plan_covers_every_valid_page_once(sms, B, Hkv, pps):
    """Every column a sequence uses lies in exactly one block's range, for
    any length; blocks past ceil(len / page) get nothing; the plan satisfies
    the kernel's split * per >= pps > (split - 1) * per and per <= MAX_PER,
    and launches no more blocks than fit on the card at once unless a block
    would take more than MAX_PER columns."""
    split, per = split_plan(B, Hkv, pps, sms)
    assert 1 <= split <= pps and split * per >= pps > (split - 1) * per
    assert per <= MAX_PER
    assert split == 1 or B * Hkv * split <= 3 * sms or \
        -(-pps // (split - 1)) > MAX_PER
    for n_used in range(pps + 1):
        cols = [c for s in range(split) for c in block_pages(s, per, n_used)]
        assert cols == list(range(n_used))
        for s in range(split):
            if s * per >= n_used:
                assert len(block_pages(s, per, n_used)) == 0


def _split_merge(q, kp, vp, bt, sl, sms, ks=None, vs=None):
    """The split kernel's partials and the combine kernel's merge, in plain
    fp32 PyTorch: block s of each (sequence, kv head) attends over its
    columns' positions below seq_len with a running max of its own, writing
    (m, l, acc) (int8 pages: s = scale_k * (q . k), scale_v folded into p
    after l sums it); the combine merges the partials by log-sum-exp,
    skipping those with l = 0."""
    B, Hq, d = q.shape
    _, page, Hkv, _ = kp.shape
    G, pps = Hq // Hkv, bt.shape[1]
    split, per = split_plan(B, Hkv, pps, sms)
    out = torch.zeros(B, Hq, d)
    for b in range(B):
        n = int(sl[b])
        n_used = min(pps, -(-n // page))
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G].float()
            parts = []
            for s in range(split):
                cols = block_pages(s, per, n_used)
                if len(cols) == 0:
                    continue
                pos = torch.arange(cols.start * page,
                                   min(n, cols.stop * page))
                pg = bt[b, pos // page].long()
                k = kp[pg, pos % page, h].float()
                v = vp[pg, pos % page, h].float()
                x = qg @ k.T
                if ks is not None:
                    x = x * ks[pg, h]
                x = x * d ** -0.5
                m = x.amax(-1)
                p = torch.exp(x - m[:, None])
                l = p.sum(-1)
                if vs is not None:
                    p = p * vs[pg, h]
                parts.append((m, l, p @ v))
            if not parts:
                continue
            M = torch.stack([m for m, _, _ in parts]).amax(0)
            L = sum(l * torch.exp(m - M) for m, l, _ in parts)
            A = sum(a * torch.exp(m - M)[:, None] for m, _, a in parts)
            out[b, h * G:(h + 1) * G] = A / L[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("B,Hq,Hkv,d,page,pps,lens",
                         [*((*s, None) for s in FP_SWEEP), *SPLIT_CASES])
def test_split_then_merge_matches_unsplit_and_reference(sms, quant, B, Hq,
                                                        Hkv, d, page, pps,
                                                        lens):
    """The kernels' split-then-merge, mirrored in plain PyTorch, equals the
    unsplit plain version and the JAX reference in fp32 (fp and int8
    pages), with zero-length rows exact zeros."""
    from repro.kernels.paged_attention import (
        paged_attention_quant_ref as jax_quant_ref,
        paged_attention_ref as jax_ref)
    q, kp, vp, bt, sl = _inputs(B, Hq, Hkv, d, page, pps, lens=lens)
    tq, tbt, tsl = _torch(q, "float32"), _torch(bt), _torch(sl)
    if quant:
        kq, ks = quantize_pages(_torch(kp, "float32"))
        vq, vs = quantize_pages(_torch(vp, "float32"))
        got = _split_merge(tq, kq, vq, tbt, tsl, sms, ks, vs)
        plain = paged_attention_quant_ref(tq, kq, vq, ks, vs, tbt, tsl)
        want = jax_quant_ref(_jax(q, "float32"),
                             *(_jax(t.numpy()) for t in (kq, vq, ks, vs)),
                             _jax(bt), _jax(sl))
    else:
        tk, tv = _torch(kp, "float32"), _torch(vp, "float32")
        got = _split_merge(tq, tk, tv, tbt, tsl, sms)
        plain = paged_attention_ref(tq, tk, tv, tbt, tsl)
        want = jax_ref(*(_jax(a, "float32") for a in (q, kp, vp)),
                       _jax(bt), _jax(sl))
    for ref in (plain.numpy(), np.asarray(want)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    zero = sl == 0
    assert torch.equal(got[zero], torch.zeros_like(got[zero]))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,d,page,pps,lens", [
    *((*s, None) for s in QUANT_SWEEP),
    *SPLIT_CASES,                                 # zero-length, short rows
    (16, 32, 4, 128, 64, 33, [2080] * 16),        # the pager shape
    # the pager shape with rows shorter than one split (4 pages)
    (16, 32, 4, 128, 64, 33, [2080] * 12 + [200, 64, 65, 1]),
    (1, 32, 4, 128, 64, 128, [128 * 64 - 17]),    # one long sequence
])
def test_kernels_match_plain_on_card(dtype, B, Hq, Hkv, d, page, pps, lens):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kp, vp, bt, sl = _inputs(B, Hq, Hkv, d, page, pps, lens=lens)
    q, kp, vp = (_torch(a, dtype, "cuda") for a in (q, kp, vp))
    bt, sl = _torch(bt, device="cuda"), _torch(sl, device="cuda")
    kq, ks = quantize_pages_ref(kp)
    vq, vs = quantize_pages_ref(vp)
    before = dict(kernels.LAUNCHES)
    outs = {"fp": (paged_attention(q, kp, vp, bt, sl),
                   paged_attention_ref(q, kp, vp, bt, sl)),
            "int8": (paged_attention_quant(q, kq, vq, ks, vs, bt, sl),
                     paged_attention_quant_ref(q, kq, vq, ks, vs, bt, sl))}
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_attention"] == \
        before["paged_attention"] + 1
    assert kernels.LAUNCHES["paged_attention_quant"] == \
        before["paged_attention_quant"] + 1
    tol = TOL[dtype]
    for out, ref in outs.values():
        assert out.dtype == q.dtype
        o, r = out.float(), ref.float()
        torch.testing.assert_close(o, r, rtol=tol, atol=tol)
        if dtype == "bfloat16":
            # both sides round one fp32 result to bf16: about an ulp apart
            assert ((o - r).norm() / r.norm()).item() <= 1e-2
        zero = sl == 0
        assert torch.equal(out[zero], torch.zeros_like(out[zero]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["float16", "head_dim_24", "strided_q",
                                  "int64_table"])
def test_kernel_refuses_what_it_does_not_take_on_card(case):
    _card()
    d = 24 if case == "head_dim_24" else 32
    dtype = torch.float16 if case == "float16" else torch.float32
    q = torch.randn(2, 4, d, device="cuda", dtype=dtype)
    kp = torch.randn(8, 16, 2, d, device="cuda", dtype=dtype)
    bt = torch.arange(8, device="cuda", dtype=torch.int32).reshape(2, 4)
    sl = torch.full((2,), 40, device="cuda", dtype=torch.int32)
    if case == "strided_q":
        q = torch.randn(2, 4, 2 * d, device="cuda")[..., ::2]
    if case == "int64_table":
        bt = bt.long()
    before = dict(kernels.LAUNCHES)
    with pytest.raises((TypeError, ValueError)):
        paged_attention(q, kp, kp, bt, sl)
    assert kernels.LAUNCHES == before
