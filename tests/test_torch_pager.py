"""repro_torch PagedKVCache vs the reference's, on the CPU.

The same config and the same numpy appends go to the reference
(``repro.serving.pager``) and to the port (``device="cpu"``, plain versions
of the kernels). Allocation, block tables, attention, byte counts and the
prefetch plan are held equal to the reference's.

The reference's spill -> fetch raises under the installed jax (its fetch
gathers a host-memory pool with a device-memory index), so those paths are
held to what the reference's own tests state instead: the fp round trip is
exact, int8 host rows equal the reference's quantize-then-dequantize refs of
the pre-spill rows, nothing else moves, a fetch before any spill and a fetch
after a newer append are no-ops, and retier keeps the live values.
"""

import numpy as np
import pytest
import torch

from repro_torch.obs import Tracer
from repro_torch.serving.pager import PagedKVCache, PagerConfig, plan_prefetch

MiB = 1 << 20


def _cfg(**kw):
    base = dict(page_size=8, n_pages=32, kv_heads=2, head_dim=16,
                weights=(2, 1), dtype="float32")
    base.update(kw)
    return base


def _pair(**kw):
    """The reference's cache and the port's, on one config."""
    from repro.serving.pager import (PagedKVCache as RefCache,
                                     PagerConfig as RefConfig)
    return (RefCache(RefConfig(**_cfg(**kw))),
            PagedKVCache(PagerConfig(**_cfg(**kw)), device="cpu"))


def _append(pair, seq, k, v):
    import jax.numpy as jnp
    ref, port = pair
    ref.append(seq, jnp.asarray(k, jnp.float32), jnp.asarray(v, jnp.float32))
    port.append(seq, torch.from_numpy(np.asarray(k, np.float32)),
                torch.from_numpy(np.asarray(v, np.float32)))


def _filled(seed=0, lens=(20, 13, 0), **kw):
    """Both caches with the same interleaved token-by-token fill, so every
    sequence's pages are non-contiguous, and one zero-length sequence."""
    rng = np.random.default_rng(seed)
    pair = _pair(**kw)
    kv = {s: rng.normal(size=(n, 2, 16)) for s, n in enumerate(lens)}
    for c in pair:
        for s in kv:
            c.allocate(s)
    for t in range(max(lens)):
        for s, n in enumerate(lens):
            if t < n:
                _append(pair, s, kv[s][t:t + 1], kv[s][t:t + 1] * 0.5)
    return pair, rng


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("weights", [(1, 0), (2, 1)])
def test_cache_matches_reference(weights, kv_dtype):
    (ref, port), rng = _filled(weights=weights, kv_dtype=kv_dtype)
    seqs = [0, 1, 2]
    assert port.tables == ref.tables and port.lens == ref.lens
    assert list(port.free) == list(ref.free)
    np.testing.assert_array_equal(port.tier_of_page, ref.tier_of_page)
    np.testing.assert_array_equal(port.k_pool.numpy(), np.asarray(ref.k_pool))
    np.testing.assert_array_equal(port.v_pool.numpy(), np.asarray(ref.v_pool))
    for got, want in zip(port.block_table(seqs), ref.block_table(seqs)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = rng.normal(size=(3, 4, 16)).astype(np.float32)
    import jax.numpy as jnp
    want = np.asarray(ref.attend(jnp.asarray(q), seqs))
    got = port.attend(torch.from_numpy(q), seqs).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got[2], np.zeros_like(got[2]))
    got_q = port.attend_quant(torch.from_numpy(q), seqs).numpy()
    np.testing.assert_allclose(got_q, got, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(
        got_q, np.asarray(ref.attend_quant(jnp.asarray(q), seqs)),
        rtol=2e-5, atol=2e-5)
    for tier in ("hbm", "host"):
        assert port.page_bytes_for(tier) == ref.page_bytes_for(tier)
    assert port.host_page_bytes == ref.host_page_bytes
    assert port.host_pages(seqs) == ref.host_pages(seqs)
    assert port.occupancy == ref.occupancy


def test_block_table_cached_and_invalidated():
    (ref, port), _ = _filled(lens=(9,))
    bt1, l1 = port.block_table([0])
    bt2, l2 = port.block_table([0])
    assert bt1 is bt2 and l1 is l2           # cache hit, no rebuild
    _append((ref, port), 0, np.ones((1, 2, 16)), np.ones((1, 2, 16)))
    bt3, l3 = port.block_table([0])
    assert bt3 is not bt1 and int(l3[0]) == 10
    port.free_seq(0)
    port.allocate(0)
    bt4, _ = port.block_table([0])
    assert bt4.shape == (1, 1) and int(bt4[0, 0]) == 0
    assert port._quant_pools is None


def test_free_list_fifo_and_exhaustion_match_reference():
    pair = _pair(n_pages=8)
    for c in pair:
        c.allocate(0)
    _append(pair, 0, np.ones((24, 2, 16)), np.ones((24, 2, 16)))
    for c in pair:
        c.free_seq(0)
        c.allocate(1)
    _append(pair, 1, np.ones((8, 2, 16)), np.ones((8, 2, 16)))
    ref, port = pair
    assert port.tables == ref.tables == {1: [3]}
    assert list(port.free) == list(ref.free)
    port.allocate(2)
    with pytest.raises(MemoryError):
        port.append(2, torch.ones(64, 2, 16), torch.ones(64, 2, 16))


@pytest.mark.parametrize("system", [None, "gh200", "dual_socket_cxl"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_plan_prefetch_matches_reference(system, kv_dtype):
    from repro.fabric.contention import Flow as RefFlow
    from repro.fabric.systems import get_system as ref_system
    from repro_torch.fabric.contention import Flow
    from repro_torch.fabric.systems import get_system
    (ref, port), _ = _filled(lens=(40, 33, 17), kv_dtype=kv_dtype)
    seqs = [0, 1, 2]
    bg = {"port": (Flow("offload", "host", "hbm", nbytes=4 * MiB),),
          "ref": (RefFlow("offload", "host", "hbm", nbytes=4 * MiB),)}
    if system == "dual_socket_cxl":
        bg = {"port": (Flow("offload", "cxl", "local_dram", nbytes=MiB),),
              "ref": (RefFlow("offload", "cxl", "local_dram", nbytes=MiB),)}
    got = port.plan_prefetch(seqs, system=system and get_system(system),
                             background=bg["port"])
    want = ref.plan_prefetch(seqs, system=system and ref_system(system),
                             background=bg["ref"])
    assert got.order == want.order and got.order
    assert set(got.eta) == set(want.eta)
    for p in got.eta:
        assert got.eta[p] == pytest.approx(want.eta[p], rel=1e-12)
    assert got.total_time == pytest.approx(want.total_time, rel=1e-12)
    assert got.effective_bw == pytest.approx(want.effective_bw, rel=1e-12)
    assert got.ready_by(got.eta[got.order[1]]) == \
        want.ready_by(want.eta[want.order[1]])


def test_module_plan_prefetch_matches_reference():
    from repro.serving.pager import plan_prefetch as ref_plan
    for kw in ({}, {"compression": 2.0, "priority": 1}):
        got = plan_prefetch([9, 3, 27], page_bytes=MiB, **kw)
        want = ref_plan([9, 3, 27], page_bytes=MiB, **kw)
        assert got.order == want.order == (9, 3, 27)
        assert got.total_time == pytest.approx(want.total_time, rel=1e-12)
        for p in got.order:
            assert got.eta[p] == pytest.approx(want.eta[p], rel=1e-12)
    assert plan_prefetch([], page_bytes=MiB).total_time == 0.0


# -- spill and fetch (held to the reference's stated properties) ------------

def _spill_fetch(kv_dtype, seed=7):
    tr = Tracer()
    c = PagedKVCache(PagerConfig(**_cfg(kv_dtype=kv_dtype)), tracer=tr,
                     device="cpu")
    rng = np.random.default_rng(seed)
    for s in (0, 1):
        c.allocate(s)
        kv = torch.from_numpy(rng.normal(size=(20 + 4 * s, 2, 16))).float()
        c.append(s, kv, kv * 0.5)
    return c, tr


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_spill_fetch_roundtrip(kv_dtype):
    import jax.numpy as jnp
    from repro.kernels.quant import dequantize_pages_ref, quantize_pages_ref
    c, tr = _spill_fetch(kv_dtype)
    k_before, v_before = c.k_pool.clone(), c.v_pool.clone()
    host = c.tier_of_page == 1
    n_host = int(host.sum())
    assert n_host > 0
    assert c.spill_cold_pages() == n_host
    if kv_dtype == "int8":
        assert c.k_pool_host.dtype == torch.int8
        assert c.k_scales_host.shape == (32, 2)
    c.fetch_spilled()
    for before, after in ((k_before, c.k_pool), (v_before, c.v_pool)):
        before, after = before.numpy(), after.numpy()
        if kv_dtype is None:
            np.testing.assert_array_equal(after, before)
        else:
            q, s = quantize_pages_ref(jnp.asarray(before[host]))
            want = np.asarray(dequantize_pages_ref(q, s, jnp.float32))
            np.testing.assert_array_equal(after[host], want)
            np.testing.assert_array_equal(after[~host], before[~host])
    m = tr.metrics
    assert m.counter("pager.spill.pages", tier="host") == n_host
    assert m.counter("pager.fetch.pages", tier="host") == n_host
    assert m.counter("pager.spill.bytes", tier="host") == \
        n_host * c.host_page_bytes
    assert m.counter("pager.fetch.bytes", tier="host") == \
        n_host * c.host_page_bytes


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_fetch_before_spill_is_noop(kv_dtype):
    c, _ = _spill_fetch(kv_dtype)
    k_before, v_before = c.k_pool.clone(), c.v_pool.clone()
    c.fetch_spilled()                          # nothing spilled yet
    assert torch.equal(c.k_pool, k_before)
    assert torch.equal(c.v_pool, v_before)


@pytest.mark.parametrize("fetch_first", [False, True])
def test_append_after_spill_voids_the_shadow(fetch_first):
    """spill -> (fetch ->) append -> fetch must not clobber the freshly
    appended host-tier page with the older shadow."""
    c = PagedKVCache(PagerConfig(**_cfg()), device="cpu")
    c.allocate(0)
    k = torch.ones(16, 2, 16)
    c.append(0, k, k)                          # pages 0, 1 (both hbm-tier)
    c.spill_cold_pages()                       # shadow: host pages all zero
    if fetch_first:
        c.fetch_spilled()
    c.append(0, 2 * k, 2 * k)                  # page 2 (host-tier) holds 2s
    assert c.tier_of_page[2] == 1
    c.fetch_spilled()                          # stale shadow: must no-op
    assert torch.equal(c.k_pool[2], torch.full((8, 2, 16), 2.0))


@pytest.mark.parametrize("seed,n1,n2,do_append,new_weights", [
    (0, 17, 0, False, (1, 0)), (1, 30, 9, True, (1, 2)),
    (2, 5, 12, True, (3, 1)), (3, 24, 30, False, (2, 2)),
    (4, 1, 1, True, (1, 1))])
def test_retier_keeps_live_values(seed, n1, n2, do_append, new_weights):
    """tests/test_pager.py's value-preservation property: whatever
    interleave retier applies, the pool afterwards holds the live values;
    after spill-then-append the stale shadow is not resurrected."""
    rng = np.random.default_rng(seed)
    c = PagedKVCache(PagerConfig(**_cfg(n_pages=16)), device="cpu")
    c.allocate(0)
    kv1 = torch.from_numpy(rng.normal(size=(n1, 2, 16))).float()
    c.append(0, kv1, kv1)
    c.spill_cold_pages()
    if do_append and n2 > 0:
        kv2 = torch.from_numpy(rng.normal(size=(n2, 2, 16))).float()
        c.append(0, kv2, kv2 * 2.0)          # shadow is now stale
    k_live, v_live = c.k_pool.clone(), c.v_pool.clone()
    out = c.retier(new_weights)
    assert torch.equal(c.k_pool, k_live) and torch.equal(c.v_pool, v_live)
    assert not c._spilled
    assert c.cfg.weights == tuple(new_weights)
    np.testing.assert_array_equal(c._host_idx,
                                  np.nonzero(c.tier_of_page == 1)[0])
    assert out["weights"] == tuple(new_weights)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("priority", [None, 0, 2])
def test_plan_prefetch_priority_and_transfer_plan_match_reference(
        kv_dtype, priority):
    """``plan_prefetch(priority=)`` under a bulk stream: the same ETAs,
    the same events on the cache's tracer, and the transport plan riding
    along as ``transfer_plan`` (the drift sentinel replays it)."""
    from repro.fabric.contention import Flow as RefFlow
    from repro.obs import Tracer as RefTracer
    from repro_torch.fabric.contention import Flow
    (ref, port), _ = _filled(lens=(40, 33, 17), kv_dtype=kv_dtype)
    out = {}
    for side, cache, F, T in (("ref", ref, RefFlow, RefTracer),
                              ("port", port, Flow, Tracer)):
        tr = cache.tracer = T(clock=lambda: 0.0)
        bg = (F("offload", "host", "hbm", nbytes=4 * MiB),)
        plan = cache.plan_prefetch([0, 1, 2], background=bg,
                                   priority=priority)
        tp = plan.transfer_plan
        out[side] = (plan.order, plan.eta, plan.total_time,
                     plan.effective_bw, tp.wire_bytes, tp.logical_bytes,
                     tp.route.label, [tuple(e) for e in tr.events],
                     tr.metrics.to_json())
    assert out["port"] == out["ref"]
    assert out["port"][7]
