"""Elastic scaling: re-plan the mesh, batch, and KV placement when the
resource set changes (node failure, pod add/remove, fabric degradation).

The port of the reference's ``repro/runtime/elastic.py`` (pure Python).
``plan_mesh`` chooses the largest valid (data, model) factorization under
the constraint set; ``replan`` keeps tokens-per-chip roughly constant by
rescaling the global batch (linear-scaling-rule note recorded for the
optimizer); ``make_elastic_mesh`` builds the decision's (data, model)
``DeviceMesh`` over the ranks of the default process group.

``replan_interleave`` is the serving-side counterpart: re-derive the KV
page interleave from the fabric *as it is now* — degraded links, removed
tiers, co-running traffic — so the pager can migrate pages to match
(``PagedKVCache.retier``). It is the "decide" step of the
sense->decide->act loop in ``repro_torch.runtime.degrade``.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Optional, Sequence

from repro_torch.config.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class ElasticDecision:
    mesh_shape: tuple
    global_batch: int
    note: str


def plan_mesh(n_devices: int, *, prefer_model: int = 16,
              min_model: int = 1) -> tuple[int, int]:
    """Largest (data, model) grid; model axis is a power of two dividing
    the device count (odd TP degrees don't map onto head/ff dims)."""
    model = min(prefer_model, n_devices)
    while model > min_model and (n_devices % model
                                 or (model & (model - 1))):
        model //= 2
    model = max(min_model, model)
    return max(1, n_devices // model), model


def replan(cfg: ModelConfig, shape: ShapeConfig, n_devices: int,
           prev_global_batch: Optional[int] = None) -> ElasticDecision:
    """Shrink/grow decision: new mesh + global batch for ``n_devices``.

    The batch is rounded down to a multiple of the new data axis (every
    data shard must hold at least one sequence), so a shrink keeps
    tokens-per-chip roughly constant instead of overloading survivors.
    """
    data, model = plan_mesh(n_devices)
    prev = prev_global_batch or shape.global_batch
    new_batch = max(data, (prev // data) * data)
    note = (f"replanned to ({data},{model}) for {n_devices} devices; "
            f"global_batch {prev} -> {new_batch} "
            "(scale LR linearly with batch if changed)")
    return ElasticDecision((data, model), new_batch, note)


def make_elastic_mesh(decision: ElasticDecision, device_type=None):
    from repro_torch.launch.mesh import DATA_AXIS, MODEL_AXIS, _make_mesh
    data, model = decision.mesh_shape
    return _make_mesh((data, model), (DATA_AXIS, MODEL_AXIS), device_type)


# --------------------------------------------------------------------------
# Serving-side replanning: KV interleave from the degraded fabric
# --------------------------------------------------------------------------


def degraded_tier_bandwidths(system, background: Sequence = (), *,
                             weight: float = 1.0,
                             priority: int = 0) -> dict:
    """Effective KV-tier bandwidths on the fabric as it is *now*.

    Like ``placement.contended_tier_bandwidths`` but tolerant of
    degradation: a tier whose node was hot-removed (or left unreachable by
    a dead link) reports 0.0 instead of raising — "this tier contributes
    nothing" is exactly the signal the replanner needs. Thin wrapper over
    ``repro_torch.transport.probe_tier_bandwidths(tolerant=True)``.
    """
    from repro_torch.transport import probe_tier_bandwidths

    if system.kv_tiers is None:
        return {}
    return probe_tier_bandwidths(system, background, weight=weight,
                                 priority=priority,
                                 tiers=system.kv_tiers, tolerant=True)


def replan_interleave(system, background: Sequence = (), *,
                      weight: float = 1.0, priority: int = 0,
                      compression: float = 1.0,
                      fast_budget_frac: Optional[float] = None,
                      max_weight: int = 8) -> list[int]:
    """Re-derive the (fast, spill) KV page interleave from the degraded
    fabric.

    Weights follow the cost-model optimum (w_i proportional to the tier's
    *effective* bandwidth under ``background`` at the given QoS class,
    with spill-tier bytes scaled by ``compression`` for quantized pages).
    A spill tier that is unreachable — hot-removed expander, dead link,
    fully starved by higher-priority traffic — gets weight 0: the plan is
    "evacuate".

    ``fast_budget_frac`` models capacity pressure: the fast tier can hold
    at most that fraction of pages, so even when bandwidth says
    "everything fast" the plan keeps a minimal spill stripe
    (``[floor(f/(1-f)), 1]``). A removed spill tier overrides the budget —
    losing the tier means losing the headroom, and the caller must deal
    with the overflow (that is what hot-removal costs).
    """
    from repro_torch.core.costmodel import optimal_interleave_weights

    if fast_budget_frac is not None and not (0.0 < fast_budget_frac <= 1.0):
        raise ValueError(f"fast_budget_frac must be in (0, 1], "
                         f"got {fast_budget_frac}")
    if system.kv_tiers is None:
        return [1, 0]
    fast, slow = system.kv_tiers
    eff = degraded_tier_bandwidths(system, background, weight=weight,
                                   priority=priority)
    bw_fast = eff.get(fast, 0.0)
    bw_slow = eff.get(slow, 0.0) * compression
    if bw_slow <= 0:
        return [1, 0]                         # evacuate the dead tier
    if bw_fast <= 0:
        return [0, 1]                         # fast path gone: all spill
    ws = optimal_interleave_weights(
        [SimpleNamespace(read_bw=bw_fast), SimpleNamespace(read_bw=bw_slow)],
        max_weight=max_weight)
    if fast_budget_frac is not None and fast_budget_frac < 1.0:
        total = ws[0] + ws[1]
        if ws[1] == 0 or ws[0] / total > fast_budget_frac:
            # capacity-clipped: largest fast share the budget allows,
            # expressed against a single spill stripe
            ws = [max(1, math.floor(fast_budget_frac
                                    / (1.0 - fast_budget_frac))), 1]
    return list(ws)
