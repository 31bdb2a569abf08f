"""HEIMDALL microbenchmarks — one function per paper figure.

The port of the reference's ``repro/heimdall/micro.py``. Each returns
list[Row] with the reference's row names and derived keys. On the card
``hbm`` is device memory and ``host`` pinned host memory, which the probe
kernels (``repro_torch.kernels.probes``) read, add into and copy from
through its mapped device pointer, over PCIe: the counterpart of the
paper's processor loading and storing across a coherent link. Where the
reference chases pointers in ``lax.fori_loop``, one thread of P1 runs the
whole dependent chain, so a step's time is a load's latency and not a
launch's. Every function takes ``device`` (default ``cuda``; raises
without one); on ``device="cpu"`` both tiers live in RAM and the kernels'
plain versions run (the relative numbers then compress, as the
reference's do on its CPU container).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.heimdall.harness import (Row, TIERS, block_until_ready,
                                          on_streams, place, side_streams,
                                          time_fn)
from repro_torch.kernels.probes import (pointer_chase, tier_copy,
                                        tier_scatter_add, tier_sum)
from repro_torch.models.context import resolve_device

LFDS_HASH = 2654435761           # Knuth's multiplicative hash, as uint32


def _perm(n: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).permutation(n).astype(np.int32))


# -- Fig 4: load latency (pointer chase) ------------------------------------

def micro_latency(n_elems: int = 1 << 16, chase_len: int = 2048,
                  device=None) -> list:
    device = resolve_device(device)
    rows = []
    perm = _perm(n_elems, 0)
    for tier in TIERS:
        p = place(perm, tier, device)
        t = time_fn(lambda: pointer_chase(p, chase_len, device=device))
        ns = t / chase_len * 1e9
        rows.append(Row(f"micro_latency/{tier}", t * 1e6,
                        f"ns_per_access={ns:.1f}"))
    return rows


# -- Fig 5: bandwidth scaling with concurrency -------------------------------

def micro_bandwidth_scaling(mb: int = 32, device=None) -> list:
    """``streams`` buffers summed at once, each by P2 on a CUDA stream of
    its own."""
    device = resolve_device(device)
    rows = []
    n = mb * (1 << 20) // 4
    for tier in TIERS:
        for streams in (1, 2, 4, 8):
            xs = [place(torch.arange(n // streams, dtype=torch.float32),
                        tier, device) for _ in range(streams)]
            cuda_streams = side_streams(streams, device)

            def read_all():
                return on_streams([lambda a=a: tier_sum(a, device=device)
                                   for a in xs], cuda_streams)

            t = time_fn(read_all)
            bw = mb / (1 << 10) / t
            rows.append(Row(f"micro_bandwidth/{tier}/streams={streams}",
                            t * 1e6, f"GiB_s={bw:.2f}"))
    return rows


# -- Fig 6: loaded latency ----------------------------------------------------

def micro_loaded_latency(n_elems: int = 1 << 16, mb: int = 16,
                         device=None) -> list:
    """The chase (P1, 1024 steps) on one CUDA stream while P2 sums ``mb``
    MiB of the same tier on another: on one stream the "loaded" latency
    would be the unloaded one plus the sum's time."""
    device = resolve_device(device)
    rows = []
    perm = _perm(n_elems, 0)
    big = torch.arange(mb * (1 << 20) // 4, dtype=torch.float32)
    streams = side_streams(2, device)
    for tier in TIERS:
        p = place(perm, tier, device)
        x = place(big, tier, device)

        def chase_under_load():
            return on_streams([lambda: tier_sum(x, device=device),
                               lambda: pointer_chase(p, 1024,
                                                     device=device)],
                              streams)

        t = time_fn(chase_under_load)
        rows.append(Row(f"micro_loaded_latency/{tier}", t * 1e6,
                        f"ns_per_access_loaded={t/1024*1e9:.1f}"))
    return rows


# -- Fig 7: weighted interleave ------------------------------------------------

def micro_weighted_interleave(pages: int = 64, page_kb: int = 256,
                              device=None) -> list:
    from repro_torch.core.placement import interleave_pages
    device = resolve_device(device)
    rows = []
    n = page_kb * 256                     # f32 per page
    base = [torch.full((n,), float(i)) for i in range(pages)]
    for weights in ((1, 0), (0, 1), (2, 1), (4, 1), (1, 1)):
        assign = interleave_pages(pages, list(weights))
        placed = [place(b, TIERS[a], device) for b, a in zip(base, assign)]

        def read_all():
            return sum(tier_sum(a, device=device) for a in placed)

        t = time_fn(read_all)
        gib = pages * page_kb / (1 << 20)
        rows.append(Row(
            f"micro_interleave/w={weights[0]}:{weights[1]}", t * 1e6,
            f"GiB_s={gib/t:.2f}"))
    return rows


# -- Fig 8: flush/writeback ------------------------------------------------------

def micro_writeback(sizes_kb=(64, 1024, 16384), device=None) -> list:
    """Device memory written back to a pinned host buffer (a blocking copy
    by the copy engine)."""
    device = resolve_device(device)
    rows = []
    for kb in sizes_kb:
        x = place(torch.arange(kb * 256, dtype=torch.float32), "hbm", device)
        t = time_fn(lambda a: place(a, "host", device), x)
        lines = kb * 1024 // 64
        rows.append(Row(f"micro_writeback/{kb}KiB", t * 1e6,
                        f"ns_per_line={t/lines*1e9:.1f}"))
    return rows


# -- Fig 9: atomics / contention ---------------------------------------------------

def atomics_inputs(n_updates: int = 1 << 14) -> list:
    """``[(tier, collide, idx)]`` in the reference's order: every update to
    slot 0 (collide) or to slots drawn from a seeded generator (spread)."""
    rng = np.random.default_rng(0)
    out = []
    for tier, collide in (("hbm", False), ("hbm", True),
                          ("host", False), ("host", True)):
        idx = (np.zeros(n_updates, np.int32) if collide
               else rng.integers(0, n_updates, n_updates).astype(np.int32))
        out.append((tier, collide, idx))
    return out


def micro_atomics(n_updates: int = 1 << 14, device=None) -> list:
    """P3's atomics into a target on each tier. The target is updated in
    place (the reference's scatter returns a new array), so it keeps
    growing over the timed repetitions; only the time is reported."""
    device = resolve_device(device)
    rows = []
    for tier, collide, idx in atomics_inputs(n_updates):
        target = place(torch.zeros(n_updates, dtype=torch.float32), tier,
                       device)
        updates = torch.ones(n_updates, dtype=torch.float32, device=device)
        ii = torch.from_numpy(idx).to(device)
        t = time_fn(tier_scatter_add, target, ii, updates)
        rows.append(Row(
            f"micro_atomics/{tier}/{'collide' if collide else 'spread'}",
            t * 1e6, f"ns_per_update={t/n_updates*1e9:.2f}"))
    return rows


# -- Fig 11: cache-utilization heatmap (working set x stride) -----------------------

HEATMAP_WS_KB = (32, 256, 2048, 16384)
HEATMAP_STEPS = 4096


def micro_cache_heatmap(device=None) -> list:
    device = resolve_device(device)
    rows = []
    for ws_kb in HEATMAP_WS_KB:
        p = _perm(ws_kb * 256, 1).to(device)
        t = time_fn(lambda: pointer_chase(p, HEATMAP_STEPS, "sweep",
                                          device=device))
        rows.append(Row(f"micro_cache_heatmap/ws={ws_kb}KiB", t * 1e6,
                        f"ns_per_access={t/HEATMAP_STEPS*1e9:.1f}"))
    return rows


# -- Fig 16/19/20: prefetch + copy engine -------------------------------------------

def micro_prefetch(mb: int = 8, device=None) -> list:
    """Overlap benefit: sync fetch+compute vs async prefetched (§5.2 DSA).
    The overlapped arm streams the layers through ``StreamingParamServer``
    (``non_blocking`` copies on its copy stream, one layer ahead, joined by
    an event)."""
    from repro_torch.core.offload import StreamingParamServer
    device = resolve_device(device)
    rows = []
    n = mb * (1 << 20) // 4
    layers = [place(torch.arange(n, dtype=torch.float32) + i, "host",
                    device) for i in range(4)]

    def compute(x):
        return torch.tanh(x).sum()

    def run_sync():
        acc = 0.0
        for h in layers:
            d = place(h, "hbm", device)
            block_until_ready(d)             # serialized copy
            acc = acc + compute(d)
        return acc

    # one server (one copy stream) for every run: the allocator's pool is
    # per stream, so a server per run would allocate inside the timing
    srv = StreamingParamServer(layers, len(layers), lambda ls, i: ls[i],
                               device)

    def run_prefetch():
        acc = 0.0
        for i in range(len(layers)):
            acc = acc + compute(srv.get(i))
        return acc

    t_sync = time_fn(run_sync)
    t_pre = time_fn(run_prefetch)
    rows.append(Row("micro_prefetch/sync", t_sync * 1e6,
                    "mode=copy-then-compute"))
    rows.append(Row("micro_prefetch/overlap", t_pre * 1e6,
                    f"speedup={t_sync/max(t_pre,1e-9):.2f}x"))
    return rows


def micro_copy_engine(sizes_kb=(64, 1024, 8192), device=None) -> list:
    """Bulk copy (the copy engine) vs elementwise copy by the SMs (P4),
    both from pinned host memory into device memory (DSA vs memcpy, Fig
    19/20)."""
    device = resolve_device(device)
    rows = []
    for kb in sizes_kb:
        x = place(torch.arange(kb * 256, dtype=torch.float32), "host",
                  device)

        def bulk(a):
            return place(a, "hbm", device)

        def elementwise(a):
            return tier_copy(a, torch.empty(a.numel(), dtype=torch.float32,
                                            device=device))

        tb = time_fn(bulk, x)
        te = time_fn(elementwise, x)
        gib = kb / (1 << 20)
        rows.append(Row(f"micro_copy/bulk/{kb}KiB", tb * 1e6,
                        f"GiB_s={gib/tb:.2f}"))
        rows.append(Row(f"micro_copy/elementwise/{kb}KiB", te * 1e6,
                        f"GiB_s={gib/te:.2f}"))
    return rows


# -- Fig 10 / §3.7: lock-free data structures on tiers -----------------------

def lfds_queue_round(buf: torch.Tensor, head: int, vals: torch.Tensor):
    """Enqueue ``len(vals)`` rows then dequeue them (SPSC ring, linear
    access) on a copy of ``buf``: (new buffer, new head, dequeued sum)."""
    n = vals.shape[0]
    idx = (head + torch.arange(n, device=buf.device)) % buf.shape[0]
    buf = buf.index_put((idx,), vals)
    out = buf[idx]
    return buf, head + n, out.sum()


def lfds_slots(keys: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Open-hash slots of int64 ``keys`` (each below 2^32): the reference's
    uint32 product and modulo, computed in int64 and masked to 32 bits
    (PyTorch's uint32 has no multiply)."""
    return ((keys * LFDS_HASH) & 0xFFFFFFFF) % n_slots


def lfds_map_round(table: torch.Tensor, keys: torch.Tensor,
                   vals: torch.Tensor):
    """Update then get at hashed slots (random access) on a copy of
    ``table``: (new table, sum of the rows read back). Colliding keys
    write one slot; which of their rows lands there is undefined, as in
    the reference's scatter."""
    slots = lfds_slots(keys, table.shape[0])
    table = table.index_put((slots,), vals)
    got = table[slots]
    return table, got.sum()


def lfds_inputs(n_ops: int = 512, dim: int = 16):
    """(vals float32 (n_ops, dim), keys int64 (n_ops,)) from the
    reference's seeded generator, in its order."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(n_ops, dim)).astype(np.float32)
    keys = rng.integers(0, 1 << 30, n_ops).astype(np.int64)
    return vals, keys


def micro_lfds(n_ops: int = 512, n_elems: int = 1 << 12,
               dim: int = 16, device=None) -> list:
    """Queue (linear access, SPSC ring) and map (random access, open hash)
    ops on each tier — the paper's LFDS study. As in the reference, the
    structure is array-backed with functional updates; 'Same local' vs
    remote becomes hbm vs host placement (a host structure is fetched to
    the device for each round)."""
    device = resolve_device(device)
    rows = []
    v, k = lfds_inputs(n_ops, dim)
    vals = torch.from_numpy(v).to(device)
    keys = torch.from_numpy(k).to(device)
    for tier in TIERS:
        buf = place(torch.zeros((n_elems, dim), dtype=torch.float32), tier,
                    device)

        def q_op():
            b = place(buf, "hbm", device) if tier == "host" else buf
            return lfds_queue_round(b, 0, vals)

        def m_op():
            t = place(buf, "hbm", device) if tier == "host" else buf
            return lfds_map_round(t, keys, vals)

        tq = time_fn(q_op)
        tm = time_fn(m_op)
        rows.append(Row(f"micro_lfds/queue/{tier}", tq * 1e6,
                        f"ops_s={2*n_ops/tq:.0f}"))
        rows.append(Row(f"micro_lfds/map/{tier}", tm * 1e6,
                        f"ops_s={2*n_ops/tm:.0f}"))
    return rows


ALL_MICRO = [micro_latency, micro_bandwidth_scaling, micro_loaded_latency,
             micro_weighted_interleave, micro_writeback, micro_atomics,
             micro_cache_heatmap, micro_prefetch, micro_copy_engine,
             micro_lfds]
