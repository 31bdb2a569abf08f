"""repro_torch.kernels.probes (P1-P4) against the reference's probe loops.

The reference runs HEIMDALL's probes as jitted JAX loops
(``repro/heimdall/micro.py``): ``micro_latency``'s pointer chase
(``jax.lax.fori_loop`` of ``p[idx]``), ``micro_cache_heatmap``'s sweep
(``acc + pp[acc % n]`` in int32), the tier sums, ``micro_atomics``'
``t.at[i].add(u)`` and ``micro_copy_engine``'s ``a * 1.0``. Those loop
bodies sit inside the benchmark functions, so the small jitted JAX
functions here repeat them, and the probes' plain versions (what the
wrappers run on the CPU) are held against them on numpy inputs from a
seed. A sweep over a large working set wraps int32, and one test proves
the chain it checks does.

The kernels are held against the plain versions by the ``gpu`` tests on a
card, on device memory and on pinned host memory:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_probes.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.probes import (pointer_chase, pointer_chase_ref,
                                        tier_copy, tier_copy_ref,
                                        tier_scatter_add,
                                        tier_scatter_add_ref, tier_sum,
                                        tier_sum_ref)
from repro_torch.kernels.probes.ref import wrap_int32

PROBES = ("pointer_chase", "tier_sum", "tier_scatter_add", "tier_copy")
# P2 against a float64 sum: fp32 partial sums in another order than any
# other implementation's
SUM_RTOL = 1e-5


def _perm(n, seed):
    return np.random.default_rng(seed).permutation(n).astype(np.int32)


def _jax_chase(p, steps):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chase(pp):
        return jax.lax.fori_loop(0, steps, lambda i, idx: pp[idx],
                                 jnp.int32(0))
    return int(chase(jnp.asarray(p)))


def _jax_sweep(p, steps):
    import jax
    import jax.numpy as jnp
    n = p.shape[0]

    @jax.jit
    def sweep(pp):
        return jax.lax.fori_loop(0, steps, lambda i, acc: acc + pp[acc % n],
                                 jnp.int32(0))
    return int(sweep(jnp.asarray(p)))


@pytest.mark.parametrize("n,steps,seed", [(1, 5, 0), (7, 30, 1),
                                          (1 << 10, 2048, 0),
                                          (1 << 16, 2048, 0)])
def test_chase_plain_matches_jax_loop(n, steps, seed):
    p = _perm(n, seed)
    got = pointer_chase(torch.from_numpy(p), steps)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == _jax_chase(p, steps)


@pytest.mark.parametrize("n,steps,seed", [(8192, 4096, 1), (65536, 4096, 1),
                                          (524288, 4096, 1), (5, 64, 2)])
def test_sweep_plain_matches_jax_loop(n, steps, seed):
    p = _perm(n, seed)
    got = pointer_chase(torch.from_numpy(p), steps, "sweep")
    assert int(got) == _jax_sweep(p, steps)


def test_sweep_that_wraps_int32_matches_jax_loop():
    """Values up to 4 M summed 4096 times pass 2^31: the chain must wrap,
    and a floor modulo must keep the index in range after it does."""
    n, steps = 1 << 22, 4096
    p = _perm(n, 1)
    acc, wrapped = 0, False
    for _ in range(steps):                   # the unwrapped chain, by hand
        raw = acc + int(p[acc % n])
        wrapped |= raw != wrap_int32(raw)
        acc = wrap_int32(raw)
    assert wrapped
    got = pointer_chase_ref(torch.from_numpy(p), steps, "sweep")
    assert got == acc == _jax_sweep(p, steps)


def test_chase_out_of_range_indices_follow_jax():
    """A chain through values outside [0, n): a negative index counts
    from the end and the rest clamp, as JAX's dynamic gather does."""
    p = np.array([3, -2, 9, -9, 1, 0], np.int32)
    for steps in range(1, 12):
        assert pointer_chase_ref(torch.from_numpy(p), steps) == \
            _jax_chase(p, steps)


@pytest.mark.parametrize("n", [1, 3, 4, 1023, 1 << 16])
def test_sum_plain_matches_jax(n):
    import jax.numpy as jnp
    x = np.random.default_rng(n).normal(size=n).astype(np.float32) * 100
    got = tier_sum(torch.from_numpy(x))
    want = float(jnp.asarray(x).sum())
    exact = float(x.astype(np.float64).sum())
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - exact) <= SUM_RTOL * max(abs(exact), 1.0)
    assert abs(want - exact) <= SUM_RTOL * max(abs(exact), 1.0)


@pytest.mark.parametrize("collide", [False, True])
def test_scatter_add_plain_matches_jax(collide):
    import jax
    import jax.numpy as jnp
    n = 1 << 10
    rng = np.random.default_rng(0)
    idx = (np.zeros(n, np.int32) if collide
           else rng.integers(0, n, n).astype(np.int32))
    u = rng.normal(size=n).astype(np.float32)
    t0 = rng.normal(size=n).astype(np.float32)
    want = np.asarray(jax.jit(lambda t, i, v: t.at[i].add(v))(
        jnp.asarray(t0), jnp.asarray(idx), jnp.asarray(u)))
    t = torch.from_numpy(t0.copy())
    out = tier_scatter_add(t, torch.from_numpy(idx), torch.from_numpy(u))
    assert out is t
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-4)


def test_scatter_add_counts_exactly_and_drops_as_jax():
    """Updates of 1.0 count exactly in either order; indices below -n or
    from n up are dropped, and -n..-1 count from the end, as JAX's
    ``.at[].add`` does."""
    import jax.numpy as jnp
    n = 8
    idx = np.array([0, 0, 7, -1, -8, 8, 100, -9, 3, 3, 3], np.int32)
    u = np.ones(idx.size, np.float32)
    want = np.asarray(jnp.zeros(n, jnp.float32).at[jnp.asarray(idx)].add(
        jnp.asarray(u)))
    got = tier_scatter_add(torch.zeros(n), torch.from_numpy(idx),
                           torch.from_numpy(u))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 5, 4096])
def test_copy_plain_matches_jax_bitwise(n):
    import jax.numpy as jnp
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    x[0] = -0.0
    want = np.asarray(jnp.asarray(x) * 1.0)
    out = torch.empty(n)
    got = tier_copy(torch.from_numpy(x), out)
    assert got is out
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_cpu_calls_run_plain_versions_and_count_nothing():
    before = dict(kernels.LAUNCHES)
    x = torch.arange(64, dtype=torch.float32)
    pointer_chase(torch.arange(4, dtype=torch.int32), 3)
    tier_sum(x)
    tier_scatter_add(torch.zeros(4), torch.zeros(2, dtype=torch.int32),
                     torch.ones(2))
    tier_copy(x, torch.empty(64))
    assert kernels.LAUNCHES == before


def test_probes_family_is_registered():
    assert kernels.FAMILIES["probes"] == PROBES
    assert all(k in kernels.LAUNCHES for k in PROBES)
    from repro_torch.kernels.probes import ops
    assert ops.LIBRARY == "probes"
    assert all(s.exists() and s.suffix == ".cu" for s in ops.SOURCES)


@pytest.mark.parametrize("call,exc,match", [
    (lambda: pointer_chase(torch.arange(4), 3), TypeError, "int32"),
    (lambda: pointer_chase(torch.zeros(0, dtype=torch.int32), 3),
     ValueError, "empty"),
    (lambda: pointer_chase(torch.arange(4, dtype=torch.int32), 3, "walk"),
     ValueError, "mode"),
    (lambda: pointer_chase(torch.arange(4, dtype=torch.int32), -1),
     ValueError, "steps"),
    (lambda: pointer_chase(torch.arange(4, dtype=torch.int32)[::2], 3),
     ValueError, "contiguous"),
    (lambda: tier_sum(torch.zeros(4, dtype=torch.float64)), TypeError,
     "float32"),
    (lambda: tier_sum(torch.zeros(2, 2)), ValueError, "1-D"),
    (lambda: tier_scatter_add(torch.zeros(4), torch.zeros(3, dtype=torch.int32),
                              torch.ones(2)), ValueError, "entries"),
    (lambda: tier_scatter_add(torch.zeros(0), torch.zeros(0, dtype=torch.int32),
                              torch.ones(0)), ValueError, "empty"),
    (lambda: tier_copy(torch.zeros(4), torch.empty(5)), ValueError,
     "elements"),
    (lambda: tier_sum(torch.zeros(4), device="meta"), ValueError,
     "cuda or the CPU"),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, exc, match):
    with pytest.raises(exc, match=match):
        call()


def test_plain_versions_run_on_the_device_given():
    x = torch.arange(10, dtype=torch.float32)
    assert tier_sum_ref(x, "cpu").device.type == "cpu"
    out = tier_copy_ref(x, torch.empty(10))
    assert torch.equal(out, x)
    assert torch.equal(tier_scatter_add_ref(torch.zeros(3),
                                            torch.tensor([0, 0, 2]),
                                            torch.ones(3)),
                       torch.tensor([2.0, 0.0, 1.0]))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _tier(t, tier):
    if tier == "hbm":
        return t.cuda()
    return t.pin_memory()


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["hbm", "host"])
@pytest.mark.parametrize("mode,n,steps", [
    ("chase", 1 << 16, 2048), ("chase", 7, 100), ("sweep", 1 << 13, 4096),
    ("sweep", 1 << 22, 4096)])                  # the last one wraps int32
def test_pointer_chase_kernel_matches_plain(tier, mode, n, steps):
    _card()
    p = torch.from_numpy(_perm(n, 1))
    before = kernels.LAUNCHES["pointer_chase"]
    got = pointer_chase(_tier(p, tier), steps, mode, device="cuda")
    assert got.device.type == "cuda"
    assert int(got) == pointer_chase_ref(p, steps, mode)
    assert kernels.LAUNCHES["pointer_chase"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["hbm", "host"])
@pytest.mark.parametrize("n,offset", [(1 << 23, 0), (1 << 16, 0),
                                      (1001, 0), (4096, 1)])
def test_tier_sum_kernel_matches_plain(tier, n, offset):
    _card()
    base = torch.arange(n + offset, dtype=torch.float32)
    x = _tier(base, tier)[offset:]           # offset: off 16-byte alignment
    before = kernels.LAUNCHES["tier_sum"]
    got = float(tier_sum(x, device="cuda"))
    exact = float(base[offset:].double().sum())
    assert abs(got - exact) <= SUM_RTOL * abs(exact)
    assert kernels.LAUNCHES["tier_sum"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["hbm", "host"])
@pytest.mark.parametrize("collide", [False, True])
def test_tier_scatter_add_kernel_counts_exactly(tier, collide):
    _card()
    n = 1 << 14
    idx = (np.zeros(n, np.int32) if collide else
           np.random.default_rng(0).integers(0, n, n).astype(np.int32))
    t = _tier(torch.zeros(n), tier)
    tier_scatter_add(t, torch.from_numpy(idx).cuda(),
                     torch.ones(n, device="cuda"))
    torch.cuda.synchronize()
    want = tier_scatter_add_ref(torch.zeros(n), torch.from_numpy(idx),
                                torch.ones(n))
    assert torch.equal(t.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["hbm", "host"])
@pytest.mark.parametrize("n,offset", [(1 << 21, 0), (1003, 0), (4096, 3)])
def test_tier_copy_kernel_matches_plain_bitwise(tier, n, offset):
    _card()
    base = torch.randn(n + offset)
    x = _tier(base, tier)[offset:]
    out = tier_copy(x, torch.empty(n, device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), base[offset:])


@pytest.mark.gpu
def test_kernels_refuse_pageable_host_memory():
    _card()
    with pytest.raises(ValueError, match="pinned"):
        tier_sum(torch.zeros(16), device="cuda")
    with pytest.raises(ValueError, match="pinned"):
        tier_copy(torch.zeros(16), torch.empty(16, device="cuda"))
