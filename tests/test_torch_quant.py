"""repro_torch page quantize/dequantize vs the reference's.

The same numpy inputs go to the reference (``repro.kernels.quant``: the
Pallas kernels in interpret mode, and the ``_ref`` versions) and to the
port. On the CPU the port's ops run their plain versions; the kernels
themselves are held against the plain versions, bit for bit, by the ``gpu``
tests on a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_quant.py

The port divides by 127 exactly (IEEE division), as the reference's
``quantize_pages_ref`` does eagerly, so its int8 values and scales equal
that ref's bit for bit. Inside the reference's jitted Pallas kernel XLA
folds ``/ 127.0`` into a multiply by the reciprocal, so its scales can
differ from the ref's in the last bit and an int8 value lying on a
rounding tie can move by one; the reference's own tests allow exactly that
(``tests/test_kernels.py``, ``tests/test_kv_quant.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.quant import (dequantize_pages,
                                       dequantize_pages_ref,
                                       quantize_pages, quantize_pages_ref)

# tests/test_kv_quant.py's quantize_pages sweep
SHAPES = [(12, 8, 2, 16), (7, 16, 4, 32), (32, 16, 1, 128)]
DTYPES = ["float32", "bfloat16"]


def _pages(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape) * 3


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(np.asarray(a)).to(device=device,
                                              dtype=getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference(shape, dtype):
    import jax.numpy as jnp
    from repro.kernels.quant import (dequantize_pages as jax_deq,
                                     dequantize_pages_ref as jax_deq_ref,
                                     quantize_pages as jax_q,
                                     quantize_pages_ref as jax_q_ref)
    x = _pages(shape)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    q, s = quantize_pages(_torch(x, dtype))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == shape and tuple(s.shape) == (shape[0], shape[2])
    # bit for bit with the reference's eager ref
    qr, sr = jax_q_ref(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    # the reference's Pallas kernel: its own tie budget
    qk, sk = jax_q(jx)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(qk, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-6)
    # dequantize, in both output dtypes, on the same q and scales
    for out_dtype in DTYPES:
        got = dequantize_pages(q, s, out_dtype=getattr(torch, out_dtype))
        assert got.dtype == getattr(torch, out_dtype)
        for deq in (jax_deq, jax_deq_ref):
            want = deq(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                       getattr(jnp, out_dtype))
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


def test_blocks_are_per_page_head():
    """Scaling one (page, head) block must not disturb any other block's
    quantization (tests/test_kv_quant.py's independence check)."""
    x = np.asarray(_pages((4, 8, 2, 16), seed=1) / 3, np.float32)
    y = x.copy()
    y[2, :, 1, :] *= 100.0
    _, s0 = quantize_pages(torch.from_numpy(x))
    _, s1 = quantize_pages(torch.from_numpy(y))
    s0, s1 = s0.numpy(), s1.numpy()
    assert s1[2, 1] == pytest.approx(s0[2, 1] * 100.0, rel=1e-5)
    mask = np.ones_like(s0, bool)
    mask[2, 1] = False
    np.testing.assert_allclose(s1[mask], s0[mask], rtol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    x = _torch(_pages((4, 8, 2, 16)), "float32")
    kernels.reset_launches()
    q, s = quantize_pages(x)
    out = dequantize_pages(q, s)
    assert kernels.LAUNCHES["quantize_pages"] == 0
    assert kernels.LAUNCHES["dequantize_pages"] == 0
    qr, sr = quantize_pages_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(out, dequantize_pages_ref(qr, sr))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [*SHAPES, (536, 64, 4, 128),
                                   (178, 64, 4, 128)])
def test_kernels_match_plain_bitwise_on_card(shape, dtype):
    _card()
    x = _torch(_pages(shape), dtype, "cuda")
    before = dict(kernels.LAUNCHES)
    q, s = quantize_pages(x)
    out = dequantize_pages(q, s, out_dtype=x.dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quantize_pages"] == before["quantize_pages"] + 1
    assert kernels.LAUNCHES["dequantize_pages"] == \
        before["dequantize_pages"] + 1
    qr, sr = quantize_pages_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(out, dequantize_pages_ref(qr, sr, x.dtype))


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take_on_card():
    _card()
    before = dict(kernels.LAUNCHES)
    x = torch.randn(4, 8, 2, 32, device="cuda")
    with pytest.raises(TypeError):
        quantize_pages(x.half())
    with pytest.raises(ValueError):
        quantize_pages(x.transpose(1, 2))
    q, s = quantize_pages_ref(x)
    with pytest.raises(ValueError):
        dequantize_pages(q, s[:2])
    assert kernels.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,offset", [
    *((s, 0) for s in SHAPES), ((178, 64, 4, 128), 0),   # the 16-byte path
    ((12, 8, 2, 24), 0),                 # d % 16 != 0: the scalar path
    ((7, 16, 4, 32), 1),                 # q 1 byte off alignment: scalar
])
def test_dequantize_pages_paths_bitwise_on_card(shape, offset, dtype):
    """K5 bit for bit with its plain version on its 16-byte vector path
    and on its scalar path."""
    _card()
    qr, sr = quantize_pages_ref(_torch(_pages(shape), dtype, "cuda"))
    buf = torch.empty(qr.numel() + offset, dtype=torch.int8, device="cuda")
    q = buf[offset:].view(shape)
    q.copy_(qr)
    before = kernels.LAUNCHES["dequantize_pages"]
    out = dequantize_pages(q, sr, out_dtype=getattr(torch, dtype))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dequantize_pages"] == before + 1
    assert torch.equal(out, dequantize_pages_ref(qr, sr,
                                                 getattr(torch, dtype)))
