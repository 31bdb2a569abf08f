"""Placement engine: weighted interleaving + training-state tiers.

The port's copy of the reference's ``repro/core/placement.py``:

1. **Page interleaving** (the paper's §3.4): ``interleave_pages`` assigns
   logical pages across tiers by weighted round-robin.
2. **Training-state placement** (§6.1.5 / Table 5):
   ``plan_training_placement`` decides which state groups (bf16 compute
   params, fp32 master, Adam mu/nu) live in device memory and which in
   pinned host memory, from a per-chip byte budget. Pure arithmetic, equal
   to the reference's; its default topology is the reference's
   ``tpu_v5e`` (16 GiB of HBM per chip).
3. **KV placement** (Fig 24 / §6.1.4): ``plan_kv_placement`` splits the KV
   cache between the fast and the spill tier, point to point on a
   ``TierTopology`` or contention-aware on a fabric ``System``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.core.costmodel import optimal_interleave_weights
from repro_torch.core.tiers import TierTopology


def interleave_pages(n_pages: int, weights: Sequence[int]) -> np.ndarray:
    """Assign page -> tier index by weighted round-robin.

    Matches the kernel's weighted-interleave semantics: in each round of
    sum(weights) pages, tier i receives weights[i] of them.
    """
    weights = list(weights)
    if any(w < 0 for w in weights) or sum(weights) == 0:
        raise ValueError(f"bad weights {weights}")
    pattern = []
    for tier_idx, w in enumerate(weights):
        pattern.extend([tier_idx] * w)
    reps = -(-n_pages // len(pattern))
    return np.tile(np.array(pattern, np.int32), reps)[:n_pages]


def interleave_counts(n_pages: int, weights: Sequence[int]) -> list[int]:
    a = interleave_pages(n_pages, weights)
    return [int((a == i).sum()) for i in range(len(weights))]


# --------------------------------------------------------------------------
# Training-state placement
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PlacementPlan:
    """Tier assignment per state group + byte accounting (per chip)."""
    kinds: dict                  # group -> memory kind ('device'/'pinned_host')
    bytes_per_chip: dict         # group -> bytes
    hbm_used: int
    host_used: int
    hbm_capacity: int
    host_capacity: int
    notes: list

    @property
    def fits(self) -> bool:
        return (self.hbm_used <= self.hbm_capacity
                and self.host_used <= self.host_capacity)

    def memory_kinds(self) -> dict:
        return dict(self.kinds)


def _per_chip_param_bytes(cfg: ModelConfig, n_chips: int) -> int:
    return int(cfg.num_params) * 4 // n_chips      # fp32 master


def plan_training_placement(cfg: ModelConfig, n_chips: int,
                            topo: Optional[TierTopology] = None,
                            activation_budget: int = 4 << 30,
                            policy: str = "auto") -> PlacementPlan:
    """Decide device/host placement of training state for one chip.

    policy: 'auto' (capacity-driven, the paper's recommendation),
            'never' (all HBM), 'always' (offload everything offloadable).
    """
    topo = topo or TierTopology.tpu_v5e()
    hbm = topo.tier("hbm").capacity
    host = topo.tier("host").capacity
    p32 = _per_chip_param_bytes(cfg, n_chips)
    groups = {
        "params": p32 // 2,       # bf16 compute copy
        "master": p32,            # fp32 master
        "mu": p32,                # Adam first moment (fp32)
        "nu": p32,                # Adam second moment (fp32)
    }
    kinds = {g: "device" for g in groups}
    notes = []
    if policy == "always":
        for g in ("master", "mu", "nu"):
            kinds[g] = "pinned_host"
        notes.append("policy=always: master+moments offloaded")
    elif policy == "auto":
        # Offload in paper-recommended order (coldest state first: nu, mu,
        # master) until the HBM budget (activations + compute params) fits.
        order = ("nu", "mu", "master")

        def hbm_used():
            return (activation_budget
                    + sum(b for g, b in groups.items()
                          if kinds[g] == "device"))
        for g in order:
            if hbm_used() > hbm:
                kinds[g] = "pinned_host"
                notes.append(f"offloaded {g} to host (HBM budget)")
    hbm_used = activation_budget + sum(
        b for g, b in groups.items() if kinds[g] == "device")
    host_used = sum(b for g, b in groups.items()
                    if kinds[g] == "pinned_host")
    if hbm_used > hbm:
        notes.append("WARNING: does not fit HBM even fully offloaded")
    return PlacementPlan(kinds=kinds, bytes_per_chip=groups,
                         hbm_used=int(hbm_used), host_used=int(host_used),
                         hbm_capacity=int(hbm), host_capacity=int(host),
                         notes=notes)


def plan_kv_placement(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
                      topo: Optional[TierTopology] = None,
                      system=None, background: Sequence = (),
                      kv_compression: float = 1.0,
                      flow_weight: float = 1.0,
                      flow_priority: int = 0) -> dict:
    """KV-cache tier split for serving (paper Fig 24 / §6.1.4).

    Returns {'weights': kind, 'kv': kind, 'kv_interleave': [w_fast, w_slow]}.
    Full fast-tier when it fits; otherwise weighted interleave of KV pages
    across the fast and spill tiers with cost-model-optimal weights.

    Contention-aware mode: pass a ``repro_torch.fabric.System`` (and optionally
    ``background`` fabric flows, tier- or node-named). The interleave
    weights are then computed from *contended* effective bandwidths — the
    max-min fair rate each tier path achieves alongside the background
    traffic — so a noisy neighbor on a shared CXL/PCIe link shifts pages
    toward the unaffected tier.

    ``kv_compression`` > 1 models transfer-compressed spill-tier pages
    (e.g. the pager's int8 cold tier): the slow link delivers that many
    *logical* bytes per wire byte, so its effective bandwidth scales up and
    the interleave shifts pages toward the cold tier — compressed pages
    make the spill tier cheaper to lean on.

    ``flow_weight``/``flow_priority`` are the KV traffic's DMA QoS class
    (see ``fabric.contention.Flow``): with the pager's page fetches riding
    at a higher priority than bulk background streams, the contended
    effective bandwidths — and therefore the interleave — recover toward
    the uncontended plan even under a noisy neighbor.
    """
    if kv_compression <= 0:
        raise ValueError(f"kv_compression must be > 0, got {kv_compression}")
    if system is not None:
        return _plan_kv_fabric(cfg, shape, n_chips, system, background,
                               kv_compression, flow_weight, flow_priority)
    topo = topo or TierTopology.tpu_v5e()
    hbm = topo.tier("hbm").capacity
    w_bytes = int(cfg.num_params) * 2 // n_chips
    kv_bytes = _kv_bytes_per_chip(cfg, shape, n_chips)
    if w_bytes + kv_bytes <= hbm * 0.9:
        return {"weights": "device", "kv": "device",
                "kv_interleave": [1, 0], "kv_compression": kv_compression}
    slow = topo.tier("host")
    slow = dataclasses.replace(slow,
                               read_bw=slow.read_bw * kv_compression,
                               write_bw=slow.write_bw * kv_compression)
    ws = optimal_interleave_weights([topo.tier("hbm"), slow])
    return {"weights": "device", "kv": "interleaved",
            "kv_interleave": ws, "kv_compression": kv_compression}


def contended_tier_bandwidths(system, background: Sequence = (), *,
                              weight: float = 1.0,
                              priority: int = 0) -> dict:
    """Effective read bandwidth of each mapped tier under background flows.

    Probes each compute->tier route with QoS-aware max-min fair sharing
    against the background (``weight``/``priority`` are the probe's DMA
    class); with no background this equals the routed bottleneck bandwidth
    ``TierTopology.from_fabric`` reports. Thin wrapper over
    ``repro_torch.transport.probe_tier_bandwidths`` (strict form: unknown tiers
    and dead routes raise; the elastic replanner uses the tolerant form).
    """
    from repro_torch.transport import probe_tier_bandwidths
    return probe_tier_bandwidths(system, background, weight=weight,
                                 priority=priority)


def _plan_kv_fabric(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
                    system, background: Sequence,
                    kv_compression: float = 1.0,
                    flow_weight: float = 1.0,
                    flow_priority: int = 0) -> dict:
    import dataclasses as _dc

    fast_node = system.tier_map[system.kv_tiers[0]] if system.kv_tiers \
        else next(iter(system.tier_map.values()))
    fast_kind = system.fabric.node(fast_node).memory_kind
    if system.kv_tiers is None:           # unified memory (MI300A): no spill
        return {"weights": fast_kind, "kv": fast_kind or "unified",
                "kv_interleave": [1, 0], "kv_tiers": None,
                "effective_bw": contended_tier_bandwidths(
                    system, background, weight=flow_weight,
                    priority=flow_priority)}
    fast, slow = system.kv_tiers
    topo = TierTopology.from_fabric(system)
    w_bytes = int(cfg.num_params) * 2 // n_chips
    kv_bytes = _kv_bytes_per_chip(cfg, shape, n_chips)
    eff = contended_tier_bandwidths(system, background, weight=flow_weight,
                                    priority=flow_priority)
    if w_bytes + kv_bytes <= topo.tier(fast).capacity * 0.9:
        return {"weights": fast_kind, "kv": fast_kind or fast,
                "kv_interleave": [1, 0], "kv_tiers": (fast, slow),
                "effective_bw": eff, "kv_compression": kv_compression}
    # compressed spill pages: the slow link carries kv_compression logical
    # bytes per wire byte, so its *logical* effective bandwidth scales up
    logical = dict(eff)
    logical[slow] = eff[slow] * kv_compression
    adjusted = [_dc.replace(topo.tier(t), read_bw=logical[t],
                            write_bw=logical[t])
                for t in (fast, slow)]
    # A fully starved probe (every tier path owned by higher-priority
    # background) has no bandwidth signal to split on — keep the fast tier.
    ws = optimal_interleave_weights(adjusted) \
        if any(logical[t] > 0 for t in (fast, slow)) else [1, 0]
    # Contention can drive the spill tier's share to zero (its effective
    # bandwidth is too small to be worth a page stripe) — that is a
    # fast-tier-only plan, not an interleave.
    kv = "interleaved" if ws[1] > 0 else (fast_kind or fast)
    return {"weights": fast_kind, "kv": kv,
            "kv_interleave": ws, "kv_tiers": (fast, slow),
            "effective_bw": eff, "kv_compression": kv_compression}


def _kv_bytes_per_chip(cfg: ModelConfig, shape: ShapeConfig,
                       n_chips: int) -> int:
    B, S = shape.global_batch, shape.seq_len
    if cfg.mla is not None:
        per_tok = cfg.num_layers * (cfg.mla.kv_lora_rank
                                    + cfg.mla.qk_rope_head_dim) * 2
    elif cfg.ssm_state:
        return cfg.num_layers * cfg.ssm_heads * cfg.ssm_head_dim \
            * cfg.ssm_state * 4 * B // n_chips
    else:
        eff_len = min(S, cfg.window) if cfg.window else S
        per_tok = (cfg.num_layers * 2 * cfg.num_kv_heads
                   * cfg.resolved_head_dim * 2)
        return per_tok * eff_len * B // n_chips
    return per_tok * S * B // n_chips
