"""Closed-form performance model of the paper's measured curves.

The port's copy of the reference's ``repro/core/costmodel.py``.

Every formula here is a fit-shape of a HEIMDALL figure:

  * ``bandwidth_vs_concurrency``  — Fig 5 (thread-scaling saturation)
  * ``loaded_latency``            — Fig 6 (latency vs achieved bandwidth)
  * ``interleave_bandwidth``      — Fig 7 (weighted NUMA interleave)
  * ``optimal_interleave_weights``— Fig 7's optimum (w_i ∝ B_i; the paper's
                                    best 4:2:1-style ratios)
  * ``offload_throughput``        — Table 5 (tokens/s vs offload split:
                                    rises while KV space grows, falls once
                                    the link transfer dominates)
  * ``transfer_time``             — Table 6 (DIMM vs CXL link proportionality)

The placement engine and the beyond-paper auto-tuners consume these.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.tiers import MemoryTier, TierTopology


# --------------------------------------------------------------------------
# Microbenchmark curve shapes (Figs 5-7)
# --------------------------------------------------------------------------


def bandwidth_vs_concurrency(tier: MemoryTier, n_streams: int,
                             bytes_inflight: int = 64 * 1024) -> float:
    """Fig 5: achieved bandwidth with n concurrent access streams.

    Little's-law ramp (n * inflight / latency) saturating at the tier's
    peak — matches the paper's observed knee (e.g. ASIC-CXL saturating at
    ~9 threads, Pool-CXL ramping slower but higher).
    """
    ramp = n_streams * bytes_inflight / tier.latency
    return min(ramp, tier.read_bw)


def loaded_latency(tier: MemoryTier, achieved_bw: float) -> float:
    """Fig 6: access latency as a function of utilization (M/M/1-shaped).

    Near saturation latency blows up — the paper's CXL expanders hit
    1700-3300 ns at peak vs ~300 ns unloaded. The multi-flow generalization
    (aggregate utilization from several sharers over a routed link) is
    ``fabric.contention.loaded_latency_multi``; this single-flow form
    is the one-sharer special case.
    """
    from repro_torch.fabric.contention import loaded_latency_multi
    return loaded_latency_multi(tier.read_bw, tier.latency, [achieved_bw])


def interleave_bandwidth(tiers: Sequence[MemoryTier],
                         weights: Sequence[float]) -> float:
    """Fig 7: aggregate bandwidth of weighted round-robin page striping.

    A fraction w_i/Σw of traffic goes to tier i; the stripe completes at the
    pace of the most-overloaded tier: B = min_i (B_i * Σw / w_i).
    """
    total = sum(weights)
    if total <= 0:
        raise ValueError("weights must sum > 0")
    best = math.inf
    for t, w in zip(tiers, weights):
        if w > 0:
            best = min(best, t.read_bw * total / w)
    return 0.0 if best is math.inf else best


def optimal_interleave_weights(tiers: Sequence[MemoryTier],
                               max_weight: int = 8) -> list[int]:
    """Fig 7 optimum: weights proportional to tier bandwidth, small-integer
    rounded (the paper expresses these as e.g. 4:2:1)."""
    bws = [t.read_bw for t in tiers]
    top = max(bws)
    raw = [b / top * max_weight for b in bws]
    ws = [max(0, round(r)) for r in raw]
    if all(w == 0 for w in ws):
        ws[bws.index(top)] = 1
    g = math.gcd(*[w for w in ws if w > 0]) if any(ws) else 1
    return [w // max(1, g) for w in ws]


# --------------------------------------------------------------------------
# Offload model (Table 5/6)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OffloadPoint:
    offload_bytes: int
    resident_bytes: int
    kv_space: int
    max_batch: int
    t_compute: float
    t_transfer: float
    tokens_per_s: float
    bound: str                  # 'compute' | 'transfer' | 'capacity'


def offload_throughput(*, model_bytes: int, offload_bytes: int,
                       hbm_capacity: int, link_bw: float,
                       kv_bytes_per_seq: int, flops_per_token: float,
                       peak_flops: float, hbm_bw: float,
                       activation_bytes: int = 0,
                       overlap: float = 0.0,
                       max_concurrency: int = 256) -> OffloadPoint:
    """Table 5's throughput model for weight-offloaded decoding.

    ``overlap`` in [0,1] is the fraction of the transfer hidden behind
    compute (0 = paper-faithful synchronous copies — the paper measured
    >99% of time in memcpy; 1 = perfect double-buffered streaming, the
    beyond-paper mode). ``max_concurrency`` bounds the useful batch (the
    serving scheduler's limit) — past it, extra offload only adds transfer
    time, producing the paper's peak-then-decline curve.
    """
    resident = model_bytes - offload_bytes
    kv_space = hbm_capacity - resident - activation_bytes
    if kv_space <= 0:
        return OffloadPoint(offload_bytes, resident, 0, 0, 0.0, 0.0, 0.0,
                            "capacity")
    max_batch = max(0, min(kv_space // max(1, kv_bytes_per_seq),
                           max_concurrency))
    if max_batch == 0:
        return OffloadPoint(offload_bytes, resident, kv_space, 0, 0.0, 0.0,
                            0.0, "capacity")
    # One decode step: every token reads the resident weights from HBM and
    # the offloaded weights over the link (batched across the step).
    t_compute = max(max_batch * flops_per_token / peak_flops,
                    resident / hbm_bw)
    t_transfer = offload_bytes / link_bw
    # Overlap hides up to `overlap * t_transfer`, bounded by the compute time.
    hidden = min(overlap * t_transfer, t_compute)
    t_exposed = t_compute + t_transfer - hidden
    tps = max_batch / t_exposed
    bound = "transfer" if (t_transfer - hidden) > t_compute else "compute"
    return OffloadPoint(offload_bytes, resident, kv_space, max_batch,
                        t_compute, t_transfer, tps, bound)


def offload_sweep(*, model_bytes: int, hbm_capacity: int, link_bw: float,
                  kv_bytes_per_seq: int, flops_per_token: float,
                  peak_flops: float, hbm_bw: float, n_points: int = 16,
                  activation_bytes: int = 0, overlap: float = 0.0,
                  max_concurrency: int = 256) -> list[OffloadPoint]:
    """Sweep offload sizes like the paper's Table 5 (70/80/90/100 GiB)."""
    lo = max(0, model_bytes - hbm_capacity + activation_bytes
             + kv_bytes_per_seq)
    pts = []
    for i in range(n_points):
        ob = lo + (model_bytes - lo) * i // max(1, n_points - 1)
        pts.append(offload_throughput(
            model_bytes=model_bytes, offload_bytes=ob,
            hbm_capacity=hbm_capacity, link_bw=link_bw,
            kv_bytes_per_seq=kv_bytes_per_seq,
            flops_per_token=flops_per_token, peak_flops=peak_flops,
            hbm_bw=hbm_bw, activation_bytes=activation_bytes,
            overlap=overlap, max_concurrency=max_concurrency))
    return pts


def optimal_offload(**kw) -> OffloadPoint:
    """Table 5's peak: the offload split maximizing tokens/s."""
    return max(offload_sweep(**kw), key=lambda p: p.tokens_per_s)


def transfer_time(nbytes: int, topo, src: str, dst: str, *,
                  compression: float = 1.0) -> float:
    """Table 6: bulk transfer duration between two tiers.

    ``topo`` may be a ``TierTopology`` (point-to-point link, the original
    model) or anything with fabric routing — a ``fabric.System`` or
    ``FabricTopology`` — in which case the transfer is routed through the
    fabric graph: bottleneck bandwidth along the path plus the summed hop
    latency. Uncontended by construction; for co-running traffic see
    ``contended_transfer_time`` or ``repro_torch.fabric.sim``.

    ``compression`` > 1 models transfer-compressed payloads (e.g. int8 KV
    pages): ``nbytes`` stays the *logical* size, the wire carries
    ``nbytes / compression``. Use ``repro_torch.core.compression.
    int8_compression_factor`` for the quantized-KV value.
    """
    if compression <= 0:
        raise ValueError(f"compression must be > 0, got {compression}")
    if hasattr(topo, "route_bandwidth"):           # fabric-routed path
        from repro_torch.transport import Route
        return Route.resolve(topo, src, dst).transfer_time(
            nbytes, compression=compression)
    wire = nbytes / compression
    return wire / topo.link_bw(src, dst) + topo.link_latency(src, dst)


def contended_transfer_time(nbytes: int, system, src: str, dst: str,
                            background: Sequence = (), *,
                            compression: float = 1.0,
                            weight: float = 1.0,
                            priority: int = 0) -> float:
    """Transfer duration when background flows share links with it.

    ``system`` is a ``fabric.System``; ``background`` is a sequence of
    ``fabric.Flow`` (node- or tier-named endpoints are both accepted).
    Steady-state estimate: the max-min fair rate the transfer gets alongside
    the background, plus routed latency. For arrival/completion dynamics run
    ``fabric.sim.simulate`` directly. ``compression`` as in
    ``transfer_time`` — logical bytes in, compressed bytes on the wire.
    ``weight``/``priority`` are the transfer's DMA QoS class: a
    higher-priority transfer rides over bulk background on a shared link
    instead of splitting it; a starved (lower-priority) transfer gets
    ``inf`` — in steady state it never completes.
    """
    from repro_torch.transport import Route
    return Route.resolve(system, src, dst).contended_transfer_time(
        nbytes, background, compression=compression, weight=weight,
        priority=priority)
