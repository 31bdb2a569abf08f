"""Paged KV-cache manager with tier-interleaved page placement.

The port of the reference's ``repro/serving/pager.py``. vLLM-style paging
married to the paper's §3.4 weighted interleaving: the page pool is split
across memory tiers by ``repro_torch.core.placement.interleave_pages``
weights, the block table maps logical pages to pool slots, and the paged
attention kernel (``repro_torch.kernels.paged_attention``) follows the
table inside the kernel.

Pool layout: one pool per tier, ``(n_pages, page_size, Hkv, dh)``. The HBM
pools live on the cache's device (``cuda`` unless the caller asks for the
CPU); the host pools live in CPU memory, pinned when the device is a CUDA
card. HBM-tier pages are attended directly; host-tier pages are spilled to
and fetched from the host pool.

Quantized cold tier (``PagerConfig(kv_dtype="int8")``): host-tier pages are
stored as int8 with per-(page, kv_head) fp32 scales (the ``quantize_pages``
layout), so every byte crossing the host link is compressed ~2x.
``attend_quant`` runs the fused int8 paged attention kernel directly over
quantized pools (dequantized in registers, no fp copy).

Unlike the reference, pool writes are in place (``append`` scatters into
the pools, ``fetch_spilled`` scatters back into them), and the spill and
fetch keep every gather on the side of the link that holds the index:
``spill_cold_pages`` gathers the host-tier rows on the device (and
quantizes them there), then copies them across; ``fetch_spilled`` gathers
them on the CPU into pinned staging, copies them across once, dequantizes
on the device, then scatters them into the pool.

DMA QoS (``PagerConfig.prefetch_priority``/``prefetch_weight``): page
fetches are deadline-critical, so ``plan_prefetch`` issues them in a
high-priority fabric class by default.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.placement import interleave_pages
from repro_torch.heimdall.harness import host_empty
from repro_torch.models.context import resolve_device
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class PagerConfig:
    page_size: int = 64
    n_pages: int = 256
    kv_heads: int = 2
    head_dim: int = 32
    weights: tuple = (1, 0)          # (hbm, host) interleave weights
    dtype: str = "bfloat16"
    kv_dtype: Optional[str] = None   # "int8" -> quantized host tier
    # DMA QoS class of page fetches (fabric.contention.Flow semantics):
    # deadline-critical page DMAs ride the high-priority queue over bulk
    # best-effort streams (weight offload) by default.
    prefetch_priority: int = 1
    prefetch_weight: float = 1.0

    def __post_init__(self):
        if self.kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', "
                             f"got {self.kv_dtype!r}")
        if self.prefetch_weight <= 0:
            raise ValueError(f"prefetch_weight must be > 0, "
                             f"got {self.prefetch_weight}")


class PagedKVCache:
    """Per-layer paged KV store with tiered page pools."""

    TIERS = ("hbm", "host")

    def __init__(self, cfg: PagerConfig, tracer=NULL_TRACER, device=None):
        """A cache whose HBM pools live on ``device`` (default ``cuda``;
        raises if there is none)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        # Observability: spill/fetch/append spans plus hit/miss/bytes-moved
        # counters per tier; NULL_TRACER by default so the decode hot path
        # pays nothing when tracing is off.
        self.tracer = tracer
        shape = (cfg.n_pages, cfg.page_size, cfg.kv_heads, cfg.head_dim)
        dt = getattr(torch, cfg.dtype)
        self.tier_of_page = interleave_pages(cfg.n_pages, list(cfg.weights))
        self.k_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dt, device=self.device)
        # host-resident shadow for pages assigned to the host tier;
        # _host_idx is the gather/scatter index list spill/fetch move by
        # (only those rows, not a full-pool where-merge)
        self._set_host_rows(self.tier_of_page == 1)
        if self._host_mask.any():
            self._alloc_host_pools()
        self.free = collections.deque(range(cfg.n_pages))
        self.tables: dict[int, list[int]] = {}    # seq id -> page ids
        self.lens: dict[int, int] = {}
        # host shadow is only valid after spill_cold_pages populated it;
        # fetching before any spill would overwrite live HBM pages with the
        # zero-initialized shadow (silent KV corruption)
        self._spilled = False
        # block_table/seq_lens cache, keyed by the seq-id tuple; one decode
        # step calls attend once per layer, so rebuilding the padded table
        # per call is pure overhead — invalidated on any table change
        self._bt_cache: dict[tuple, tuple] = {}
        # quantized-pool cache for attend_quant, invalidated on pool writes
        self._quant_pools = None

    def _set_host_rows(self, mask: np.ndarray) -> None:
        """The host-tier rows, as a mask and as an index on each side of
        the link (the CPU index gathers and scatters host pools, the device
        index the HBM pools)."""
        self._host_mask = mask
        self._host_idx = np.nonzero(mask)[0]
        self._host_idx_cpu = torch.from_numpy(self._host_idx)
        self._host_idx_dev = self._host_idx_cpu.to(self.device)

    def _alloc_host_pools(self) -> None:
        c = self.cfg
        shape = (c.n_pages, c.page_size, c.kv_heads, c.head_dim)
        if c.kv_dtype == "int8":
            sshape = (c.n_pages, c.kv_heads)
            self.k_pool_host = self._host_zeros(shape, torch.int8)
            self.v_pool_host = self._host_zeros(shape, torch.int8)
            self.k_scales_host = self._host_zeros(sshape, torch.float32)
            self.v_scales_host = self._host_zeros(sshape, torch.float32)
        else:
            dt = getattr(torch, c.dtype)
            self.k_pool_host = self._host_zeros(shape, dt)
            self.v_pool_host = self._host_zeros(shape, dt)

    def _host_zeros(self, shape, dtype) -> torch.Tensor:
        return host_empty(shape, dtype, self.device).zero_()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- allocation --------------------------------------------------------
    def allocate(self, seq_id: int) -> None:
        self.tables[seq_id] = []
        self.lens[seq_id] = 0
        self._bt_cache.clear()

    def free_seq(self, seq_id: int) -> None:
        self.free.extend(self.tables.pop(seq_id, []))
        self.lens.pop(seq_id, None)
        self._bt_cache.clear()

    def _grow(self, seq_id: int, new_len: int) -> None:
        need = -(-new_len // self.cfg.page_size)
        table = self.tables[seq_id]
        while len(table) < need:
            if not self.free:
                raise MemoryError("page pool exhausted")
            table.append(self.free.popleft())

    # -- writes -------------------------------------------------------------
    def append(self, seq_id: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append T tokens of K/V: tensors (T, Hkv, dh).

        One batched scatter per pool (all T (page, offset) destinations at
        once), written into the pools in place.
        """
        T = k.shape[0]
        start = self.lens[seq_id]
        with self.tracer.span("pager.append", track=("pager", "writes"),
                              cat="pager", seq=seq_id, tokens=T):
            self._grow(seq_id, start + T)
            ps = self.cfg.page_size
            pos = np.arange(start, start + T)
            table = np.asarray(self.tables[seq_id], np.int64)
            pages = torch.from_numpy(table[pos // ps]).to(self.device)
            offs = torch.from_numpy(pos % ps).to(self.device)
            self.k_pool[pages, offs] = k.to(self.device, self.k_pool.dtype)
            self.v_pool[pages, offs] = v.to(self.device, self.v_pool.dtype)
        self.lens[seq_id] = start + T
        self._bt_cache.clear()
        self._quant_pools = None
        # the HBM pool is the live copy again; any host shadow is stale —
        # a fetch_spilled without a fresh spill must not clobber this write
        self._spilled = False
        if self.tracer.enabled:
            elem = getattr(torch, self.cfg.dtype).itemsize
            self.tracer.metrics.add("pager.append.tokens", T)
            self.tracer.metrics.add(
                "pager.bytes_written", tier="hbm",
                value=2 * T * self.cfg.kv_heads * self.cfg.head_dim * elem)

    # -- reads ---------------------------------------------------------------
    def block_table(self, seq_ids: list[int]) -> tuple:
        """Padded (B, max_pages) int32 block table + (B,) int32 seq lens on
        the cache's device (cached until the next append/allocate/
        free_seq)."""
        key = tuple(seq_ids)
        hit = self._bt_cache.get(key)
        if hit is not None:
            return hit
        # at least one page column so an all-fresh batch still yields a
        # valid (B, 1) table; padded entries are masked by seq_lens==0
        mx = max(1, max(len(self.tables[s]) for s in seq_ids))
        bt = np.zeros((len(seq_ids), mx), np.int32)
        for i, s in enumerate(seq_ids):
            pages = self.tables[s]
            bt[i, :len(pages)] = pages
            if len(pages) < mx:                  # pad with a valid page id
                bt[i, len(pages):] = pages[-1] if pages else 0
        lens = np.array([self.lens[s] for s in seq_ids], np.int32)
        out = (torch.from_numpy(bt).to(self.device),
               torch.from_numpy(lens).to(self.device))
        self._bt_cache[key] = out
        return out

    def _count_page_touches(self, seq_ids: list[int]) -> None:
        """Tier hit/miss counters for one attention call: an HBM-resident
        page is a hit (attended in place), a host-tier page is a miss (it
        must cross the contended link before the step can see it)."""
        hits = misses = 0
        for s in seq_ids:
            for p in self.tables[s]:
                if self.tier_of_page[p] == 1:
                    misses += 1
                else:
                    hits += 1
        self.tracer.metrics.add("pager.page_hits", hits, tier="hbm")
        self.tracer.metrics.add("pager.page_misses", misses, tier="host")

    def attend(self, q: torch.Tensor, seq_ids: list[int]) -> torch.Tensor:
        """Decode attention via the paged kernel. q: (B, Hq, dh)."""
        from repro_torch.kernels.paged_attention import paged_attention
        if self.tracer.enabled:
            self._count_page_touches(seq_ids)
        bt, lens = self.block_table(seq_ids)
        return paged_attention(q, self.k_pool, self.v_pool, bt, lens)

    def attend_quant(self, q: torch.Tensor,
                     seq_ids: list[int]) -> torch.Tensor:
        """Decode attention over int8 pools via the fused quant kernel.

        Quantizes the live pool per (page, kv_head) and attends without
        materializing an fp copy. The quantized pools are cached until the
        next pool write, so a decode loop pays the quantization once per
        appended step, not per call.
        """
        from repro_torch.kernels.paged_attention import paged_attention_quant
        from repro_torch.kernels.quant import quantize_pages
        if self.tracer.enabled:
            self._count_page_touches(seq_ids)
        bt, lens = self.block_table(seq_ids)
        if self._quant_pools is None:
            self._quant_pools = (quantize_pages(self.k_pool),
                                 quantize_pages(self.v_pool))
        (kq, ks), (vq, vs) = self._quant_pools
        return paged_attention_quant(q, kq, vq, ks, vs, bt, lens)

    # -- tier maintenance -----------------------------------------------------
    def _to_host(self, pairs) -> None:
        """For each (device rows, host pool) pair: copy the rows (one per
        host-tier page) across the link into pinned staging, then, after
        one stream sync, scatter them into the pool's host-tier rows."""
        stages = []
        for rows, host in pairs:
            stage = host_empty(rows.shape, rows.dtype, self.device)
            stages.append((stage.copy_(rows, non_blocking=True), host))
        self._sync()
        for stage, host in stages:
            host.index_copy_(0, self._host_idx_cpu, stage)

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """Gather the ``host`` pool's host-tier rows into pinned staging on
        the CPU and copy them across the link once."""
        idx = self._host_idx_cpu
        stage = host_empty((len(idx), *host.shape[1:]), host.dtype,
                           self.device)
        torch.index_select(host, 0, idx, out=stage)
        return stage.to(self.device, non_blocking=True)

    def spill_cold_pages(self) -> int:
        """Move host-tier-assigned pages' backing to host memory (the
        paper's cold-page demotion, TPP-style). With ``kv_dtype="int8"``
        the spilled pages are quantized on the way out, so the host link
        carries half the bytes. Returns pages spilled."""
        if not self._host_mask.any():
            return 0
        n_spilled = int(self._host_mask.sum())
        with self.tracer.span("pager.spill", track=("pager", "tiers"),
                              cat="pager", pages=n_spilled):
            # gather only the host-assigned rows, on the device — a
            # full-pool temporary would copy (and with int8, quantize)
            # every HBM page just to move a few cold ones
            idx = self._host_idx_dev
            k_cold = self.k_pool.index_select(0, idx)
            v_cold = self.v_pool.index_select(0, idx)
            if self.cfg.kv_dtype == "int8":
                from repro_torch.kernels.quant import quantize_pages
                kq, ks = quantize_pages(k_cold)
                vq, vs = quantize_pages(v_cold)
                self._to_host(((kq, self.k_pool_host),
                               (vq, self.v_pool_host),
                               (ks, self.k_scales_host),
                               (vs, self.v_scales_host)))
            else:
                self._to_host(((k_cold, self.k_pool_host),
                               (v_cold, self.v_pool_host)))
        self._spilled = True
        self.tracer.metrics.add("pager.spill.pages", n_spilled, tier="host")
        self.tracer.metrics.add("pager.spill.bytes",
                                n_spilled * self.host_page_bytes,
                                tier="host")
        return n_spilled

    def fetch_spilled(self) -> None:
        """Bring spilled pages back next to the HBM pool (sync fetch — the
        paper-faithful mode; overlap belongs to the serving loop). int8
        pages cross the link compressed and dequantize on the HBM side.

        No-op until ``spill_cold_pages`` has actually populated the host
        shadow: a spurious fetch must not overwrite live HBM pages with the
        zero-initialized shadow. The shadow is consumed by the fetch — it
        goes stale the moment the live pool is appended to, so a fresh
        spill is required before the next fetch.
        """
        if not self._spilled or not self._host_mask.any():
            return
        n_pages = int(self._host_mask.sum())
        with self.tracer.span("pager.fetch", track=("pager", "tiers"),
                              cat="pager", pages=n_pages):
            if self.cfg.kv_dtype == "int8":
                from repro_torch.kernels.quant import dequantize_pages
                kq = self._to_device(self.k_pool_host)
                vq = self._to_device(self.v_pool_host)
                ks = self._to_device(self.k_scales_host)
                vs = self._to_device(self.v_scales_host)
                k_h = dequantize_pages(kq, ks, out_dtype=self.k_pool.dtype)
                v_h = dequantize_pages(vq, vs, out_dtype=self.v_pool.dtype)
            else:
                k_h = self._to_device(self.k_pool_host)
                v_h = self._to_device(self.v_pool_host)
            self.k_pool.index_copy_(0, self._host_idx_dev, k_h)
            self.v_pool.index_copy_(0, self._host_idx_dev, v_h)
            self._sync()
        self._quant_pools = None
        self._spilled = False
        self.tracer.metrics.add("pager.fetch.pages", n_pages, tier="host")
        self.tracer.metrics.add("pager.fetch.bytes",
                                n_pages * self.host_page_bytes,
                                tier="host")

    def retier(self, weights) -> dict:
        """Re-interleave pages across tiers (the elastic replan's "act"
        step): apply a new ``interleave_pages`` assignment, migrating any
        spilled data back next to the HBM pool first so nothing is lost.

        Returns ``{"to_fast", "to_slow", "migrated", "weights"}``:
        ``to_fast``/``to_slow`` count pages whose tier assignment changed;
        ``migrated`` is True when spilled host data actually moved (a
        live-HBM pool relabels for free).
        """
        new_assign = interleave_pages(self.cfg.n_pages, list(weights))
        old = self.tier_of_page
        to_fast = int(((old == 1) & (new_assign == 0)).sum())
        to_slow = int(((old == 0) & (new_assign == 1)).sum())
        migrated = bool(self._spilled and to_fast)
        with self.tracer.span("pager.retier", track=("pager", "tiers"),
                              cat="pager", to_fast=to_fast,
                              to_slow=to_slow):
            if self._spilled:
                # restore the live HBM copy before relabeling: the host
                # shadow is only meaningful under the old assignment
                self.fetch_spilled()
            self.tier_of_page = new_assign
            self._set_host_rows(new_assign == 1)
            if self._host_mask.any() and not hasattr(self, "k_pool_host"):
                self._alloc_host_pools()
        self.cfg = dataclasses.replace(self.cfg, weights=tuple(weights))
        self._bt_cache.clear()
        self._quant_pools = None
        self._spilled = False
        if self.tracer.enabled:
            m = self.tracer.metrics
            m.add("pager.retier.pages_to_fast", to_fast)
            m.add("pager.retier.pages_to_slow", to_slow)
            if migrated:
                m.add("pager.retier.migrated_bytes",
                      to_fast * self.host_page_bytes, tier="host")
        return {"to_fast": to_fast, "to_slow": to_slow,
                "migrated": migrated, "weights": tuple(weights)}

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self.free) / self.cfg.n_pages

    # -- prefetch scheduling (fabric sim) -------------------------------------
    def page_bytes_for(self, tier: str) -> int:
        """Bytes one page fetch moves from this tier (K and V planes).

        Tier- and dtype-aware: the hot tier holds fp pages; with
        ``kv_dtype="int8"`` the host tier holds int8 pages plus one f32
        scale per (page, kv_head) per plane.
        """
        c = self.cfg
        elems = c.page_size * c.kv_heads * c.head_dim
        if tier == "host" and c.kv_dtype == "int8":
            return 2 * (elems + c.kv_heads * 4)     # int8 payload + scales
        return 2 * elems * getattr(torch, c.dtype).itemsize

    @property
    def page_bytes(self) -> int:
        """Bytes per uncompressed (hot-tier) page fetch."""
        return self.page_bytes_for("hbm")

    @property
    def host_page_bytes(self) -> int:
        """Bytes per page actually crossing the host link on fetch."""
        return self.page_bytes_for("host")

    def host_pages(self, seq_ids: list[int]) -> list[int]:
        """Host-tier-resident pages of these sequences, in attention order
        (the order the decode step will touch them)."""
        pages = []
        for s in seq_ids:
            pages.extend(p for p in self.tables[s]
                         if self.tier_of_page[p] == 1 and p not in pages)
        return pages

    def plan_prefetch(self, seq_ids: list[int], system=None,
                      background: tuple = (),
                      priority: Optional[int] = None) -> "PrefetchPlan":
        """Schedule host->HBM page prefetches through the fabric simulator.

        Pages are fetched one at a time over the host link (one DMA queue),
        each flow chained behind the previous, co-scheduled against any
        ``background`` fabric flows (e.g. a weight-offload stream on the
        same PCIe link). Returns per-page ETAs so the serving loop knows
        which pages will be resident by the time the step needs them.
        Quantized pages (kv_dtype="int8") move ~2x fewer bytes, so their
        ETAs land ~2x sooner on a bandwidth-bound link.

        Page fetches are issued in the pager's DMA QoS class
        (``PagerConfig.prefetch_priority``/``prefetch_weight``; the
        priority is overridable here).
        """
        src_tier = None
        if system is not None and getattr(system, "kv_tiers", None):
            src_tier = system.kv_tiers[1]     # the machine's own spill tier
        return plan_prefetch(
            self.host_pages(seq_ids), self.page_bytes,
            system=system, background=background,
            weight=self.cfg.prefetch_weight,
            priority=(self.cfg.prefetch_priority if priority is None
                      else priority),
            src_tier=src_tier,
            compression=self.page_bytes / self.host_page_bytes,
            tracer=self.tracer)


@dataclasses.dataclass(frozen=True)
class PrefetchPlan:
    """Fabric-simulated prefetch schedule for a set of host-tier pages: a
    thin page-id-keyed view over ``repro_torch.transport.TransferPlan``,
    which rides along as ``transfer_plan`` when one was built."""
    order: tuple                 # page ids in fetch order
    eta: dict                    # page id -> estimated arrival time (s)
    total_time: float            # when the last page lands (s)
    effective_bw: float          # contended link bandwidth used (bytes/s)
    transfer_plan: Optional[object] = None   # transport.TransferPlan

    def ready_by(self, deadline: float) -> list[int]:
        """Pages resident if the decode step fires at `deadline`."""
        return [p for p in self.order if self.eta[p] <= deadline]


def plan_prefetch(pages: list, page_bytes: int, system=None,
                  background: tuple = (), weight: float = 1.0,
                  priority: int = 0, src_tier: Optional[str] = None,
                  tracer=NULL_TRACER,
                  compression: float = 1.0) -> PrefetchPlan:
    """Build a PrefetchPlan via ``repro_torch.transport.plan_transfers``
    (one chained-DMA simulation on the fabric).

    ``system`` defaults to the TPU v5e preset (host_dram -> chip0 over
    PCIe), as the reference's does. ``src_tier`` names the spill tier pages
    are fetched from (default ``"host"``). ``background`` flows contend with
    the prefetch stream for shared links; ``weight``/``priority`` are the
    page flows' DMA QoS class.

    ``page_bytes`` is the *logical* page size; with ``compression`` > 1
    each page crosses the wire at ``page_bytes / compression``. Open-ended
    background flows (``nbytes == 0``) are materialized at the plan's total
    wire bytes.

    With no pages to fetch the plan is trivially empty — including on a
    system whose spill tier is unreachable (its effective bandwidth
    reports 0.0).
    """
    from repro_torch.fabric.systems import get_system
    from repro_torch.transport import PageTransfer, Route, plan_transfers

    system = system or get_system("tpu_v5e")
    try:
        route = Route.resolve(system, src_tier or "host", system.compute)
        transfers = tuple(
            PageTransfer(p, page_bytes, compression=compression,
                         weight=weight, priority=priority) for p in pages)
        plan = plan_transfers(route, transfers, background=background,
                              probe_weight=weight, probe_priority=priority,
                              tracer=tracer)
    except ValueError:
        # spill tier unreachable (hot-removed / dead link): only an empty
        # plan is schedulable — pages stranded there cannot be fetched
        if not pages:
            return PrefetchPlan((), {}, 0.0, 0.0)
        raise
    if tracer.enabled and pages:
        tracer.metrics.add("pager.prefetch.pages", len(pages))
        tracer.metrics.add("pager.prefetch.bytes", plan.wire_bytes,
                           tier="host")
    return PrefetchPlan(tuple(pages), dict(plan.eta), plan.total_time,
                        plan.effective_bw, plan)
