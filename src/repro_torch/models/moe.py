"""Mixture-of-Experts FFN: capacity-based top-k routing with sort-based
dispatch (no (T, E, C) one-hot is ever built) that drops overflow tokens,
GShard-style.

On one card this is the arithmetic of the reference's expert-parallel body
(``_moe_ep_body``), which its one-device mesh runs with every collective
over a group of one: route all B * S tokens, fill each expert's ``C`` slots
in token order, run the experts, scatter-add the gated outputs back. Which
tokens drop is the reference's: a stable argsort of the flattened expert
ids, ties kept in (token, slot) order. The tensor-parallel body (experts
replicated, hidden dim sharded, dispatch in 8 chunks) is a mesh matter and
comes with the slice that ports the mesh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models.params import ParamSpec


# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------


def moe_specs(cfg: ModelConfig) -> dict:
    e = cfg.moe
    d = cfg.d_model
    ff = e.d_ff_expert or cfg.d_ff
    eaxes = ("experts", None, None)
    specs = {
        "router": ParamSpec((d, e.num_experts), (None, None),
                            init="small_normal"),
        "w_gate": ParamSpec((e.num_experts, d, ff), eaxes),
        "w_up": ParamSpec((e.num_experts, d, ff), eaxes),
        "w_down": ParamSpec((e.num_experts, ff, d), eaxes),
    }
    if e.num_shared_experts:
        ffs = ff * e.num_shared_experts
        specs["shared"] = {
            "w_gate": ParamSpec((d, ffs), ("embed", "mlp")),
            "w_up": ParamSpec((d, ffs), ("embed", "mlp")),
            "w_down": ParamSpec((ffs, d), ("mlp", "embed")),
        }
    return specs


# --------------------------------------------------------------------------
# Routing / dispatch helpers
# --------------------------------------------------------------------------


def _route(x: torch.Tensor, router_w: torch.Tensor, k: int):
    """x: (T, d) -> gates (T, k) f32, eids (T, k) int64, probs (T, E) f32.

    The top k come from a stable descending sort, so equal probabilities
    go to the lower expert index first, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order for ties)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = gates[:, :k], eids[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, eids, probs


def _aux_loss(probs: torch.Tensor, eids: torch.Tensor, E: int
              ) -> torch.Tensor:
    """Switch-style load-balancing loss."""
    T, k = eids.shape
    hits = F.one_hot(eids, E).float().sum(1)                    # (T, E)
    frac_tokens = hits.mean(0) / k
    frac_probs = probs.mean(0)
    return E * torch.sum(frac_tokens * frac_probs)


def _dispatch_indices(eids: torch.Tensor, E: int, C: int):
    """(se, st, pos, keep, order): each (token, slot) pair sorted by expert
    (stably), its expert, its token, its slot in the expert's buffer (C
    where it overflows: dropped) and whether it is kept."""
    T, k = eids.shape
    flat_e = eids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // k
    # counts per expert by index_add_: bincount would read the largest id
    # back to the host
    counts = torch.zeros(E, dtype=flat_e.dtype, device=flat_e.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=eids.device) - starts[se]
    keep = pos < C
    pos_safe = torch.where(keep, pos, C)
    return se, st, pos_safe, keep, order


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    c = int(math.ceil(T * k * cf / E))
    return max(4, -(-c // 4) * 4)            # round up to multiple of 4


def _expert_ffn(toks: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """toks: (E, C, d); weights (E, d, ff)/(E, ff, d); batched matmuls in
    the activation dtype."""
    dt = toks.dtype
    h = (F.silu(torch.bmm(toks, w_gate.to(dt)))
         * torch.bmm(toks, w_up.to(dt)))
    return torch.bmm(h, w_down.to(dt))


# --------------------------------------------------------------------------
# Public entry
# --------------------------------------------------------------------------


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, mctx=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (y, aux). Where ``mctx.stats`` is a dict, the
    number of (token, slot) pairs dropped for want of capacity is added to
    its ``"moe_dropped"`` (a device tensor, so the call does not sync)."""
    e = cfg.moe
    E = e.num_experts
    B, S, d = x.shape
    T = B * S
    x_tok = x.reshape(T, d)
    gates, eids, probs = _route(x_tok, p["router"], e.top_k)
    aux = _aux_loss(probs, eids, E)
    C = _capacity(T, e.top_k, E, e.capacity_factor)
    se, st, pos, keep, order = _dispatch_indices(eids, E, C)
    # dropped pairs all land in slot C, one past the expert's buffer, which
    # no expert reads (no boolean indexing, so no sync with the host)
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    buf[se, pos] = x_tok[st]
    out_buf = _expert_ffn(buf[:, :C], p["w_gate"], p["w_up"], p["w_down"])
    # and read zeros back from there, as the reference's fill
    vals = F.pad(out_buf, (0, 0, 0, 1))[se, pos]
    w = (gates.reshape(-1)[order] * keep).to(x.dtype)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    y.index_add_(0, st, vals * w[:, None])
    y = y.reshape(B, S, d)
    stats = getattr(mctx, "stats", None)
    if stats is not None:
        stats["moe_dropped"] = stats.get("moe_dropped", 0) + (~keep).sum()

    if e.num_shared_experts:
        sp = p["shared"]
        dt = x.dtype
        h = F.silu(x @ sp["w_gate"].to(dt)) * (x @ sp["w_up"].to(dt))
        y = y + h @ sp["w_down"].to(dt)
    return y, aux
