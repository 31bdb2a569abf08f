"""Model assembly: per-arch segment plans, specs, forward, loss.

Every architecture is a sequence of *segments* over stacked layer
parameters (leading ``[L, ...]`` dim), as in the reference; where the
reference scans over the stack, the port loops over the layer index. The
port runs ``"attn"`` segments of dense decoders (yi-9b); the other segment
kinds, MoE and MLA come with the slices that port those architectures.

Training (``loss_fn``) runs the same forward with ``collect=False`` (no
stacked K/V) and, under ``ParallelConfig.remat == "full"``, each block
inside ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.models.attention import attention_specs, attn_forward
from repro_torch.models.context import MCtx
from repro_torch.models.layers import (chunked_ce_loss, embed_tokens,
                                       embedding_specs, mlp_apply, mlp_specs,
                                       rmsnorm, rmsnorm_spec)
from repro_torch.models.params import stack_specs, torch_dtype


# --------------------------------------------------------------------------
# Segment plans
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Seg:
    name: str
    n: int             # stack length (layers)
    window: int = 0


def check_supported(cfg: ModelConfig) -> None:
    """Raise for an architecture the port does not run yet, naming what
    brings it. The model slices after the pager slice port these."""
    unported = {
        "hybrid (zamba) segments": cfg.family == "hybrid",
        "ssm (xlstm) segments": cfg.family == "ssm",
        "local/global (gemma) segments": cfg.attn_type == "local_global",
        "MoE layers": cfg.moe is not None,
        "MLA": cfg.mla is not None or cfg.attn_type == "mla",
        "M-RoPE": cfg.mrope,
        "encoder-decoder models": cfg.encoder_decoder,
    }
    missing = [what for what, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; the model "
            f"slices after the pager slice bring them")


def segment_plan(cfg: ModelConfig) -> list[Seg]:
    """The reference's plan for a dense decoder: one stack of attention
    blocks (sliding-window under ``attn_type="swa"``)."""
    check_supported(cfg)
    window = cfg.window if cfg.attn_type == "swa" else 0
    return [Seg("decoder", cfg.num_layers, window=window)]


# --------------------------------------------------------------------------
# Block specs
# --------------------------------------------------------------------------


def attn_block_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": rmsnorm_spec(d), "attn": attention_specs(cfg),
            "ln2": rmsnorm_spec(d), "mlp": mlp_specs(d, cfg.d_ff)}


def model_specs(cfg: ModelConfig) -> dict:
    """Full parameter spec tree for an architecture."""
    specs: dict[str, Any] = {"embed": embedding_specs(cfg),
                             "final_norm": rmsnorm_spec(cfg.d_model)}
    for seg in segment_plan(cfg):
        specs[seg.name] = stack_specs(attn_block_specs(cfg), seg.n)
    return specs


# --------------------------------------------------------------------------
# Block and segment applies (forward)
# --------------------------------------------------------------------------


def layer_views(p: dict, n: int) -> list[dict]:
    """Every layer of a stacked parameter (or cache) tree, as views: one
    ``unbind`` per leaf.

    Under autograd the backward of ``unbind`` is a single ``stack`` of the
    layers' gradients, where taking ``v[i]`` per layer would give every
    layer's backward a zero-filled gradient of the whole stacked leaf.
    """
    def split(v):
        return split_tree(v) if isinstance(v, dict) else torch.unbind(v)

    def split_tree(t):
        parts = {k: split(v) for k, v in t.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return split_tree(p)


def _attn_block_fwd(p, x, positions, cfg: ModelConfig, mctx: MCtx, *,
                    window: int, q_chunk: int = 512):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, kv = attn_forward(p["attn"], h, positions, cfg, window=window,
                         q_chunk=q_chunk, mctx=mctx)
    x = x + a
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_apply(p["mlp"], h2)
    return x, kv


def _to_ring(kv: dict, window: int, S: int) -> dict:
    """Convert full-length rope'd K/V into ring-cache layout (slot=pos%W)."""
    if window <= 0 or S <= window:
        return kv

    def conv(a):
        return torch.roll(a[:, S - window:], shifts=S % window, dims=1)
    return {k: conv(v) for k, v in kv.items()}


def seg_forward(p, x, positions, cfg: ModelConfig, mctx: MCtx, seg: Seg, *,
                collect: bool, remat: bool = False, q_chunk: int = 512):
    """Run one segment. Returns (x, caches): with ``collect`` the caches are
    stacked [L, ...], else None. ``remat`` recomputes each block in the
    backward pass instead of keeping its activations."""
    S = x.shape[1]
    kvs = []

    def block(x, lp):
        return _attn_block_fwd(lp, x, positions, cfg, mctx,
                               window=seg.window, q_chunk=q_chunk)[0]
    for lp in layer_views(p, seg.n):
        if collect:
            x, kv = _attn_block_fwd(lp, x, positions, cfg, mctx,
                                    window=seg.window, q_chunk=q_chunk)
            kvs.append(_to_ring(kv, seg.window, S))
        elif remat:
            x = checkpoint(block, x, lp, use_reentrant=False)
        else:
            x = block(x, lp)
    if not collect:
        return x, None
    return x, {k: torch.stack([kv[k] for kv in kvs]) for k in kvs[0]}


# --------------------------------------------------------------------------
# Top-level forward
# --------------------------------------------------------------------------


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def forward_hidden(params, cfg: ModelConfig, mctx: MCtx, batch: dict, *,
                   collect: bool = False, remat: bool = False,
                   q_chunk: int = 512):
    """Returns (hidden (B,S,d), caches). Decoder-only archs; with
    ``collect`` the caches are the rope'd k/v of every layer, else None per
    segment.

    Positions run ``arange(S)`` for every row and there is no padding mask,
    as in the reference.
    """
    plan = segment_plan(cfg)
    x = embed_tokens(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    caches = {}
    for seg in plan:
        x, c = seg_forward(params[seg.name], x, positions, cfg, mctx, seg,
                           collect=collect, remat=remat, q_chunk=q_chunk)
        caches[seg.name] = c
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, caches


def loss_fn(params, cfg: ModelConfig, mctx: MCtx, batch: dict,
            aux_coef: float = 0.001, q_chunk: int = 512):
    """Mean next-token cross-entropy of ``batch`` ({tokens, labels}) and
    its parts. Dense decoders carry no auxiliary loss (the reference's
    ``aux`` is 0 for them too)."""
    if mctx.parallel.attention_kernel == "kernel":
        raise ValueError("attention_kernel='kernel' has no backward pass "
                         "(neither has the reference's Pallas kernel); "
                         "training takes attention_kernel='eager'")
    remat = mctx.parallel.remat != "none"
    x, _ = forward_hidden(params, cfg, mctx, batch, remat=remat,
                          q_chunk=q_chunk)
    ce = chunked_ce_loss(x, params["embed"], batch["labels"],
                         cfg.tie_embeddings)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}
