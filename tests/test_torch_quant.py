"""repro_torch page quantize/dequantize vs the reference's.

The same numpy inputs go to the reference (``repro.kernels.quant``: the
Pallas kernels in interpret mode, and the ``_ref`` versions) and to the
port. On the CPU the port's ops run their plain versions; the kernels
themselves are held against the plain versions, bit for bit, by the ``gpu``
tests on a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_quant.py

K4 has two paths, chosen by ``quantize_pages_plan`` from the shape, dtype
and address: the vector path, whose thread mapping and block reduction a
numpy model here holds against the reference, and the general path. The
``gpu`` tests run both.

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
from repro_torch.kernels.quant.ops import quantize_pages_plan

# tests/test_kv_quant.py's quantize_pages sweep
SHAPES = [(12, 8, 2, 16), (7, 16, 4, 32), (32, 16, 1, 128)]
DTYPES = ["float32", "bfloat16"]
# the pager's pool and its host-tier pages at yi-9b's KV geometry
PAGER_SHAPES = [(536, 64, 4, 128), (178, 64, 4, 128)]


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [*SHAPES, *PAGER_SHAPES])
def test_plan_takes_the_vector_path(shape, dtype):
    plan = quantize_pages_plan(shape, getattr(torch, dtype), 0x7f0000000100)
    vec = 8 if dtype == "bfloat16" else 4
    assert plan.path == "vector" and plan.vec == vec
    assert plan.chunks_per_row == shape[3] // vec
    assert plan.threads % 32 == 0 and plan.threads <= 256
    assert plan.chunks in (1, 2, 4, 8)
    assert plan.threads * plan.chunks * vec >= shape[1] * shape[3]
    if shape in PAGER_SHAPES and dtype == "bfloat16":
        # 256 threads hold 32 bf16 values each, as four 16-byte chunks
        assert (plan.threads, plan.chunks) == (256, 4)


@pytest.mark.parametrize("shape,dtype,address", [
    ((12, 8, 2, 12), "bfloat16", 0),     # d % 8 != 0 in bf16
    ((12, 8, 2, 6), "float32", 0),       # d % 4 != 0 in fp32
    ((536, 64, 4, 128), "bfloat16", 2),  # one bf16 off 16-byte alignment
    ((536, 64, 4, 128), "float32", 4),   # one fp32 off 16-byte alignment
    ((4, 256, 1, 128), "bfloat16", 0),   # more than 8 chunks a thread
    ((4, 128, 1, 128), "float32", 0),
])
def test_plan_takes_the_general_path(shape, dtype, address):
    assert quantize_pages_plan(shape, getattr(torch, dtype),
                               address).path == "general"


def _vector_model(x: np.ndarray, plan) -> tuple[np.ndarray, np.ndarray]:
    """The vector kernel on one pool, thread by thread: each (page, head)
    block's thread t gathers chunks t + k * threads, the block reduces the
    threads' absmax per warp of 32 and then across warps, and each thread
    stores the int8 values of its chunks where it loaded them. Asserts that
    the threads cover every element of the block exactly once."""
    n_pages, page, hkv, d = x.shape
    q = np.zeros(x.shape, np.int8)
    scales = np.zeros((n_pages, hkv), np.float32)
    n_chunks = page * plan.chunks_per_row
    chunks = np.arange(plan.threads)[:, None] + \
        plan.threads * np.arange(plan.chunks)[None, :]      # (thread, k)
    valid = chunks < n_chunks
    rows, cols = np.divmod(chunks, plan.chunks_per_row)
    # (thread, k, element): the offsets within a (page, head) block
    flat = (rows * d + cols * plan.vec)[..., None] + np.arange(plan.vec)
    covered = np.bincount(flat[valid].ravel(), minlength=page * d)
    assert (covered == 1).all()
    for pg in range(n_pages):
        for h in range(hkv):
            block = x[pg, :, h, :].reshape(-1)
            held = np.where(valid[..., None], block[np.where(
                valid[..., None], flat, 0)], np.float32(0))
            per_thread = np.abs(held).reshape(plan.threads, -1).max(axis=1)
            per_warp = per_thread.reshape(-1, 32).max(axis=1)
            s = np.maximum(per_warp.max(), np.float32(1e-12)) / \
                np.float32(127)
            scales[pg, h] = s
            qv = np.clip(np.rint(held / s), -127, 127).astype(np.int8)
            out = np.zeros(page * d, np.int8)
            out[flat[valid]] = qv[valid]
            q[pg, :, h, :] = out.reshape(page, d)
    return q, scales


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [*SHAPES, (3, 64, 4, 128),
                                   (5, 8, 3, 40)])
def test_vector_thread_mapping_reproduces_reference(shape, dtype):
    """A numpy model of the vector kernel's thread mapping and reduction
    equals quantize_pages_ref bit for bit (the port's and the JAX one)."""
    import jax.numpy as jnp
    from repro.kernels.quant import quantize_pages_ref as jax_q_ref
    plan = quantize_pages_plan(shape, getattr(torch, dtype), 0)
    assert plan.path == "vector"
    xt = _torch(_pages(shape, seed=3), dtype)
    q, s = _vector_model(xt.float().numpy(), plan)
    qr, sr = quantize_pages_ref(xt)
    np.testing.assert_array_equal(q, qr.numpy())
    np.testing.assert_array_equal(s, sr.numpy())
    jq, js = jax_q_ref(jnp.asarray(_pages(shape, seed=3),
                                   getattr(jnp, dtype)))
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(s, np.asarray(js))


def _edge_pool(case: str) -> np.ndarray:
    """A (4, 16, 2, 32) pool whose block (page 1, head 0) is an edge case:
    all zero; its absmax in its last row and last column; or, at a scale of
    exactly 2^-3 (absmax 127 / 8), every value on a rounding tie
    +-(k + 0.5) / 8, exact in bf16 too."""
    x = _pages((4, 16, 2, 32), seed=5)
    if case == "zero":
        x[1, :, 0, :] = 0.0
    elif case == "last":
        x[1, :, 0, :] = np.clip(x[1, :, 0, :], -4, 4)
        x[1, -1, 0, -1] = -9.75
    else:
        k = np.arange(16 * 32).reshape(16, 32) % 127
        sign = np.where(np.arange(16 * 32).reshape(16, 32) % 2, -1.0, 1.0)
        x[1, :, 0, :] = sign * (k + 0.5) / 8
        x[1, 3, 0, 5] = 127 / 8
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["zero", "last", "ties"])
def test_plain_edge_cases_match_reference(case, dtype):
    import jax.numpy as jnp
    from repro.kernels.quant import quantize_pages_ref as jax_q_ref
    x = _edge_pool(case)
    q, s = quantize_pages(_torch(x, dtype))
    jq, js = jax_q_ref(jnp.asarray(x, getattr(jnp, dtype)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    block, scale = q.numpy()[1, :, 0, :], s.numpy()[1, 0]
    if case == "zero":
        assert scale == np.float32(1e-12) / np.float32(127)
        assert (block == 0).all()
    elif case == "last":
        assert scale == np.float32(9.75) / np.float32(127)
        assert block[-1, -1] == -127
    else:
        assert scale == np.float32(2.0 ** -3)
        k = np.arange(16 * 32).reshape(16, 32) % 127
        want = np.where(k % 2 == 0, k, k + 1)     # half to even
        want = np.where(np.arange(16 * 32).reshape(16, 32) % 2, -want, want)
        want[3, 5] = 127
        np.testing.assert_array_equal(block, want)


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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,offset,path", [
    *((s, 0, "vector") for s in [*SHAPES, *PAGER_SHAPES]),
    ((536, 64, 4, 128), 1, "general"),   # one element off 16-byte alignment
    ((12, 8, 2, 12), 0, None),           # d % 8 != 0: general in bf16
    ((4, 256, 1, 128), 0, None),         # over 8 chunks a thread in bf16
])
def test_quantize_pages_paths_bitwise_on_card(shape, offset, path, dtype):
    """K4 bit for bit with its plain version on both paths, one launch a
    call."""
    _card()
    dt = getattr(torch, dtype)
    xr = _torch(_pages(shape, seed=7), dtype, "cuda")
    buf = torch.empty(xr.numel() + offset, dtype=dt, device="cuda")
    x = buf[offset:].view(shape)
    x.copy_(xr)
    plan = quantize_pages_plan(x.shape, x.dtype, x.data_ptr())
    if path is not None:
        assert plan.path == path
    before = kernels.LAUNCHES["quantize_pages"]
    q, s = quantize_pages(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quantize_pages"] == before + 1
    qr, sr = quantize_pages_ref(xr)
    assert torch.equal(q, qr) and torch.equal(s, sr)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["zero", "last", "ties"])
def test_quantize_pages_edge_cases_on_card(case, dtype):
    _card()
    x = _torch(_edge_pool(case), dtype, "cuda")
    q, s = quantize_pages(x)
    qr, sr = quantize_pages_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)


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
