"""repro_torch int8 compression (K6/K7 and core/compression) vs the reference.

The same numpy inputs go to the reference (``repro.kernels.quant``: the
Pallas kernels in interpret mode and the ``_ref`` versions;
``repro.core.compression``) and to the port. On the CPU the port's ops run
their plain versions; the kernels are held against the plain versions, bit
for bit, by the ``gpu`` tests on a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_compression.py

Tolerances. The port divides by 127 exactly (IEEE division), as the
reference's ``quantize_ref`` and ``quantize_int8`` do eagerly, so its int8
values and scales equal theirs bit for bit. Inside a jitted function
(the Pallas kernel, ``shard_map``, ``vmap``) XLA folds ``/ 127.0`` into a
multiply by the reciprocal, so a scale can differ in the last bit and an
int8 value on a rounding tie can move by one: the reference's own budget
(``tests/test_kernels.py``) of ties on fewer than 1e-3 (fp32) or 1e-2
(bf16) of the values and scales within ``rtol=1e-6``; a moved value
changes its dequantized value by one scale. Dequantizing is one fp32
multiply on both sides: bit for bit.

jax is imported inside the tests, so the ``gpu`` cases also run where jax
is not installed.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.core import compression as C
from repro_torch.kernels.quant import (dequantize, dequantize_ref, quantize,
                                       quantize_ref)

# tests/test_kernels.py's sweep (2048, 65536), one block, an odd count
NS = [256, 7 * 256, 256 * 8, 256 * 256]
DTYPES = ["float32", "bfloat16"]
TIES = {"float32": 1e-3, "bfloat16": 1e-2}


def _x(n, dtype, seed=3, scale=10.0):
    """rng.normal * scale, rounded to ``dtype``; returned as fp32 numpy
    (the values the reference's test feeds) and as a torch tensor of
    ``dtype``."""
    x = np.random.default_rng(seed).normal(size=(n,)) * scale
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t.float().numpy(), t


@pytest.fixture(scope="module")
def pod_group():
    """A one-rank gloo process group (the pod group of the tests)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _assert_q_close(q, qk, s, sk, dtype):
    """The reference's budget between an exact and a jitted quantizer."""
    diff = np.abs(np.asarray(q, np.int32) - np.asarray(qk, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < TIES[dtype]
    np.testing.assert_allclose(np.asarray(s), np.asarray(sk), rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_flat_plain_matches_reference(n, dtype):
    import jax.numpy as jnp
    from repro.kernels.quant import (dequantize as jax_deq,
                                     dequantize_ref as jax_deq_ref,
                                     quantize as jax_q,
                                     quantize_ref as jax_q_ref)
    xf, xt = _x(n, dtype)
    q, s = quantize(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == (n,) and tuple(s.shape) == (n // 256,)
    # bit for bit with the reference's eager ref
    qr, sr = jax_q_ref(jnp.asarray(xf))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    # the reference's Pallas kernel (interpret mode): its tie budget
    qk, sk = jax_q(jnp.asarray(xf))
    _assert_q_close(q.numpy(), qk, s.numpy(), sk, dtype)
    # dequantize on the same q and scales: bit for bit with both
    got = dequantize(q, s)
    assert got.dtype == torch.float32
    jq, js = jnp.asarray(q.numpy()), jnp.asarray(s.numpy())
    for deq in (jax_deq, jax_deq_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(deq(jq, js)))
    # the quantization error bound of the reference's test
    err = np.abs(xf - got.numpy()).reshape(-1, 256)
    assert (err <= s.numpy()[:, None] * 0.51 + 1e-5).all()


def test_cpu_tensors_take_the_plain_version():
    _, x = _x(2048, "float32")
    kernels.reset_launches()
    q, s = quantize(x)
    out = dequantize(q, s)
    assert kernels.LAUNCHES["quantize"] == 0
    assert kernels.LAUNCHES["dequantize"] == 0
    qr, sr = quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(out, dequantize_ref(qr, sr))


def test_flat_quantize_refuses_a_ragged_length():
    with pytest.raises(ValueError, match="N % 256"):
        quantize(torch.zeros(300))
    with pytest.raises(ValueError, match="N % 256"):
        quantize(torch.zeros(2, 256))


@pytest.mark.parametrize("shape,dtype", [((1000,), "float32"),
                                         ((2, 256), "float32"),
                                         ((3, 5, 40), "bfloat16")])
def test_quantize_int8_matches_reference(shape, dtype):
    import jax.numpy as jnp
    from repro.core import compression as R
    n = int(np.prod(shape))
    xf, xt = _x(n, dtype, seed=5, scale=2.0)
    xf, xt = xf.reshape(shape), xt.reshape(shape)
    q, s, shp = C.quantize_int8(xt)
    qr, sr, shpr = R.quantize_int8(jnp.asarray(xf))
    assert shp == tuple(shpr)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    got = C.dequantize_int8(q, s, shp)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        R.dequantize_int8(qr, sr, shpr)))
    np.testing.assert_array_equal(C.roundtrip_int8(xt).numpy(),
                                  np.asarray(R.roundtrip_int8(
                                      jnp.asarray(xf))))


def test_ef_compress_tree_matches_reference():
    """Three rounds of error-feedback compression with the residual carried
    over: compressed blocks, residuals and decompressed trees."""
    import jax
    import jax.numpy as jnp
    from repro.core import compression as R
    rng = np.random.default_rng(0)
    res_p = C.ef_init({"a": torch.zeros(300), "b": {"c": torch.zeros(256,
                                                                      2)}})
    res_r = R.ef_init({"a": jnp.zeros(300), "b": {"c": jnp.zeros((256,
                                                                  2))}})
    for _ in range(3):
        g = {"a": rng.normal(size=(300,)).astype(np.float32) * 1e-3,
             "b": {"c": rng.normal(size=(256, 2)).astype(np.float32)}}
        comp_p, res_p = C.ef_compress_tree(
            {"a": torch.from_numpy(g["a"]),
             "b": {"c": torch.from_numpy(g["b"]["c"])}}, res_p)
        comp_r, res_r = R.ef_compress_tree(jax.tree.map(jnp.asarray, g),
                                           res_r)
        for path in (("a",), ("b", "c")):
            cp, cr, rp, rr = comp_p, comp_r, res_p, res_r
            for k in path:
                cp, cr, rp, rr = cp[k], cr[k], rp[k], rr[k]
            np.testing.assert_array_equal(cp[0].numpy(), np.asarray(cr[0]))
            np.testing.assert_array_equal(cp[1].numpy(), np.asarray(cr[1]))
            assert cp[2] == tuple(cr[2])
            np.testing.assert_array_equal(rp.numpy(), np.asarray(rr))
        dec_p, dec_r = C.decompress_tree(comp_p), R.decompress_tree(comp_r)
        np.testing.assert_array_equal(dec_p["a"].numpy(),
                                      np.asarray(dec_r["a"]))
        np.testing.assert_array_equal(dec_p["b"]["c"].numpy(),
                                      np.asarray(dec_r["b"]["c"]))


@pytest.mark.parametrize("block", [256, 512, 2048])
def test_measured_rel_error_and_tradeoff_match_reference(block):
    """Reductions run in another order in the two packages: rtol 1e-5."""
    import jax.numpy as jnp
    from repro.core import compression as R
    xf, xt = _x(8192, "float32", seed=block, scale=0.3)
    assert C.measured_rel_error(xt, block) == pytest.approx(
        R.measured_rel_error(jnp.asarray(xf), block), rel=1e-5)
    assert C.expected_int8_rel_error(block) == pytest.approx(
        R.expected_int8_rel_error(block), rel=1e-12)
    assert C.kv_quant_tradeoff() == R.kv_quant_tradeoff()


@pytest.mark.parametrize("shape", [(512,), (3, 300)])
def test_compressed_pod_mean_one_rank_matches_reference(pod_group, shape):
    """One pod: the port over a one-rank gloo group, the reference inside
    ``shard_map`` on a (1,) pod mesh (jitted: the tie budget)."""
    from functools import partial
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core.compression import compressed_pod_mean
    from repro.launch.mesh import make_mesh, shard_map
    n = int(np.prod(shape))
    xf, xt = _x(n, "float32", seed=7, scale=1.0)
    xf, xt = xf.reshape(shape), xt.reshape(shape)
    got = C.compressed_pod_mean(xt, pod_group)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    fn = shard_map(partial(compressed_pod_mean, pod_axis="pod"),
                   mesh=make_mesh((1,), ("pod",)), in_specs=P(),
                   out_specs=P(), check_vma=False)
    want = np.asarray(fn(jnp.asarray(xf)))
    # exact against the port's own round trip; against the jitted
    # reference within one scale on at most 1e-3 of the values
    np.testing.assert_array_equal(got.numpy(),
                                  C.roundtrip_int8(xt).numpy())
    _, s, _ = C.quantize_int8(xt)
    s = np.repeat(s.numpy(), 256)[:n].reshape(shape)
    diff = np.abs(got.numpy() - want)
    assert (diff <= s * (1 + 1e-6)).all()
    assert (diff > 1e-6 * np.abs(want)).mean() < 1e-3


def test_n_pod_mean_matches_reference_vmap():
    """Three pods: the reference's ``compressed_pod_mean`` under
    ``jax.vmap(axis_name="pod")`` against the port's mean over the
    gathered blocks (``gathered_mean``, what ``compressed_pod_mean`` runs
    after its all-gathers)."""
    from functools import partial
    import jax
    import jax.numpy as jnp
    from repro.core.compression import compressed_pod_mean
    shape = (5, 100)
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(3, *shape)).astype(np.float32)
    want = np.asarray(jax.vmap(partial(compressed_pod_mean, pod_axis="pod"),
                               axis_name="pod")(jnp.asarray(xs)))
    qs, ss = zip(*(C.quantize_int8(torch.from_numpy(x))[:2] for x in xs))
    got = C.gathered_mean(torch.cat(qs), torch.cat(ss), 3, shape)
    assert tuple(got.shape) == shape
    for pod in range(3):
        # a jitted reference: a tie moves one pod's value by its scale,
        # which the mean divides by 3
        diff = np.abs(got.numpy() - want[pod])
        assert diff.max() <= max(s.max().item() for s in ss) / 3 + 1e-6
        assert (diff > 1e-6 * np.abs(want[pod]) + 1e-7).mean() < 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [*NS, 4096 * 11008])
def test_flat_kernels_match_plain_bitwise_on_card(n, dtype):
    _card()
    _, x = _x(n, dtype)
    x = x.cuda()
    before = dict(kernels.LAUNCHES)
    q, s = quantize(x)
    out = dequantize(q, s)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quantize"] == before["quantize"] + 1
    assert kernels.LAUNCHES["dequantize"] == before["dequantize"] + 1
    qr, sr = quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(out, dequantize_ref(qr, sr))


@pytest.mark.gpu
def test_flat_kernels_refuse_what_they_do_not_take_on_card():
    _card()
    before = dict(kernels.LAUNCHES)
    x = torch.randn(4096, device="cuda")
    with pytest.raises(TypeError):
        quantize(x.half())
    with pytest.raises(ValueError):
        quantize(x[1:257])                  # not 16-byte aligned
    with pytest.raises(ValueError):
        quantize(x, block=512)              # the kernel's block is 256
    q, s = quantize_ref(x)
    with pytest.raises(ValueError):
        dequantize(q, s[:3])
    assert kernels.LAUNCHES == before
