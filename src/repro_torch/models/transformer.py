"""Model assembly: per-arch segment plans, specs, forward, loss.

Every architecture is a sequence of *segments* over stacked layer
parameters, as in the reference: a leading ``[L, ...]`` dim, and for a
heterogeneous pattern group-stacked ``[G, sub, ...]`` leaves (gemma3 5:1
local:global, zamba2 6 Mamba2 blocks + the shared attention block, xlstm
7 mLSTM + 1 sLSTM, deepseek 3 dense + 58 MoE layers). Where the reference
scans over a stack, the port loops over ``layer_views`` of it.

Training (``loss_fn``) runs the same forward with ``collect=False`` (no
stacked caches) and, under ``ParallelConfig.remat == "full"``, each block
inside ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``).
Each entry point (``forward_hidden``, ``encode``, ``encdec_forward``,
``loss_fn``) picks its path once by ``MCtx.mesh``: ``PLAIN``, the blocks
here on tensors on one device, or ``MESH``, the blocks of ``models/tp.py``
(attention, MLA, MoE, cross-attention) and ``models/tp_recurrent.py``
(Mamba2, mLSTM, sLSTM) on DTensors, with the reference's constraints at
block boundaries. ``seg_forward`` runs the blocks it is given and never
asks which path it is on.
qwen2-vl takes precomputed ``embeds`` in place of tokens and M-RoPE
``positions`` (3, B, S); whisper is an encoder-decoder
(``encdec_forward``): a bidirectional encoder over frame embeddings and a
decoder with cross-attention to it, both ungated and without rope, with
sinusoidal positions added to their inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.models import kvcache, tp, tp_recurrent
from repro_torch.models.attention import (attention_specs, attn_forward,
                                          mla_forward, mla_specs)
from repro_torch.models.context import MCtx
from repro_torch.models.layers import (add_rmsnorm, chunked_ce_loss,
                                       embed_tokens, embedding_specs,
                                       mlp_apply, mlp_specs, rmsnorm,
                                       rmsnorm_spec, sinusoidal_pos_emb)
from repro_torch.models.moe import moe_ffn, moe_specs, use_ep
from repro_torch.models.params import map_specs, stack_specs, torch_dtype
from repro_torch.models.ssm import ssm_forward, ssm_specs
from repro_torch.models.xlstm import (mlstm_forward, mlstm_specs,
                                      slstm_forward, slstm_specs)


# --------------------------------------------------------------------------
# Segment plans
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Seg:
    name: str
    kind: str          # attn | gemma | zamba | mamba | xlstm | xlstm_tail
    n: int             # stack length (layers or groups)
    sub: int = 0       # group size: gemma locals / zamba mambas / mlstms
    moe: bool = False
    window: int = 0


def segment_plan(cfg: ModelConfig) -> list[Seg]:
    """A decoder-only architecture's segments (whisper's encoder and
    decoder stacks are ``model_specs``' own)."""
    if cfg.family == "hybrid":                      # zamba2
        n_groups = cfg.num_layers // cfg.attn_every
        tail = cfg.num_layers - n_groups * cfg.attn_every
        segs = [Seg("groups", "zamba", n_groups, sub=cfg.attn_every)]
        if tail:
            segs.append(Seg("tail", "mamba", tail))
        return segs
    if cfg.family == "ssm":                         # xlstm
        n_groups = cfg.num_layers // cfg.slstm_every
        tail = cfg.num_layers - n_groups * cfg.slstm_every
        segs = [Seg("groups", "xlstm", n_groups, sub=cfg.slstm_every - 1)]
        if tail:
            segs.append(Seg("tail", "xlstm_tail", tail))
        return segs
    if cfg.attn_type == "local_global":             # gemma3
        g = cfg.local_global_ratio + 1
        n_groups = cfg.num_layers // g
        tail = cfg.num_layers - n_groups * g
        segs = [Seg("groups", "gemma", n_groups, sub=cfg.local_global_ratio,
                    window=cfg.window)]
        if tail:
            segs.append(Seg("tail", "attn", tail, window=cfg.window))
        return segs
    window = cfg.window if cfg.attn_type == "swa" else 0
    if cfg.moe is not None:
        segs = []
        fd = cfg.moe.first_dense_layers
        if fd:
            segs.append(Seg("dense", "attn", fd, window=window))
        segs.append(Seg("moe", "attn", cfg.num_layers - fd, moe=True,
                        window=window))
        return segs
    return [Seg("decoder", "attn", cfg.num_layers, window=window)]


# --------------------------------------------------------------------------
# Block specs
# --------------------------------------------------------------------------


def attn_block_specs(cfg: ModelConfig, moe: bool = False, ep: bool = True,
                     cross: bool = False, gated: bool = True) -> dict:
    """An attention block; ``cross`` adds cross-attention (``xattn``,
    ``ln_x``: whisper's decoder), ``gated=False`` the ungated MLP."""
    d = cfg.d_model
    specs: dict[str, Any] = {"ln1": rmsnorm_spec(d)}
    specs["attn"] = (mla_specs(cfg) if cfg.attn_type == "mla"
                     else attention_specs(cfg))
    if cross:
        specs["ln_x"] = rmsnorm_spec(d)
        specs["xattn"] = attention_specs(cfg)
    specs["ln2"] = rmsnorm_spec(d)
    if moe:
        specs["moe"] = moe_specs(cfg, ep)
    else:
        specs["mlp"] = mlp_specs(d, cfg.d_ff, gated=gated)
    return specs


def mamba_block_specs(cfg: ModelConfig) -> dict:
    return {"ln": rmsnorm_spec(cfg.d_model), "ssm": ssm_specs(cfg)}


def shared_attn_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": rmsnorm_spec(d), "attn": attention_specs(cfg),
            "ln2": rmsnorm_spec(d), "mlp": mlp_specs(d, cfg.d_ff)}


def mlstm_block_specs(cfg: ModelConfig) -> dict:
    return {"ln": rmsnorm_spec(cfg.d_model), "cell": mlstm_specs(cfg)}


def slstm_block_specs(cfg: ModelConfig) -> dict:
    return {"ln": rmsnorm_spec(cfg.d_model), "cell": slstm_specs(cfg)}


def seg_specs(cfg: ModelConfig, seg: Seg, ep: bool = True) -> dict:
    if seg.kind == "attn":
        return stack_specs(attn_block_specs(cfg, seg.moe, ep), seg.n)
    if seg.kind == "gemma":
        return stack_specs({
            "local": stack_specs(attn_block_specs(cfg), seg.sub),
            "global": attn_block_specs(cfg),
        }, seg.n)
    if seg.kind == "zamba":
        return stack_specs({
            "mamba": stack_specs(mamba_block_specs(cfg), seg.sub),
        }, seg.n)
    if seg.kind == "mamba":
        return stack_specs(mamba_block_specs(cfg), seg.n)
    if seg.kind == "xlstm":
        return stack_specs({
            "mlstm": stack_specs(mlstm_block_specs(cfg), seg.sub),
            "slstm": slstm_block_specs(cfg),
        }, seg.n)
    if seg.kind == "xlstm_tail":
        return stack_specs(mlstm_block_specs(cfg), seg.n)
    raise ValueError(seg.kind)


def model_specs(cfg: ModelConfig, mesh=None) -> dict:
    """Full parameter spec tree for an architecture; the MoE weights' axes
    follow ``use_ep`` on ``mesh`` (expert-parallel without one)."""
    ep = use_ep(cfg, mesh) if cfg.moe is not None else True
    specs: dict[str, Any] = {"embed": embedding_specs(cfg),
                             "final_norm": rmsnorm_spec(cfg.d_model)}
    if cfg.encoder_decoder:
        specs["encoder"] = stack_specs(attn_block_specs(cfg, gated=False),
                                       cfg.num_encoder_layers)
        specs["enc_norm"] = rmsnorm_spec(cfg.d_model)
        specs["decoder"] = stack_specs(
            attn_block_specs(cfg, cross=True, gated=False), cfg.num_layers)
        return specs
    for seg in segment_plan(cfg):
        specs[seg.name] = seg_specs(cfg, seg, ep)
    if cfg.family == "hybrid":
        specs["shared_attn"] = shared_attn_specs(cfg)
    return specs


# --------------------------------------------------------------------------
# Block applies (forward)
# --------------------------------------------------------------------------


def layer_views(p: dict, n: int) -> list[dict]:
    """Every layer of a stacked parameter (or cache) tree, as views: one
    ``unbind`` per leaf.

    Under autograd the backward of ``unbind`` is a single ``stack`` of the
    layers' gradients, where taking ``v[i]`` per layer would give every
    layer's backward a zero-filled gradient of the whole stacked leaf.
    """
    def split(v):
        if isinstance(v, dict):
            return split_tree(v)
        return tp.unbind(v) if isinstance(v, DTensor) else torch.unbind(v)

    def split_tree(t):
        parts = {k: split(v) for k, v in t.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return split_tree(p)


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _attn_block_fwd(p, x, positions, cfg: ModelConfig, mctx: MCtx, *,
                    window: int, moe: bool = False, causal: bool = True,
                    use_rope: bool = True, gated: bool = True,
                    kernel: Optional[bool] = None, q_chunk: int = 512):
    """Returns (x, kv, aux). ``kernel=False`` takes chunked attention
    whatever ``attention_kernel`` says (zamba2's shared block: the
    reference calls it without its mesh context)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, kv = mla_forward(p["attn"], h, positions, cfg, q_chunk=q_chunk)
    else:
        a, kv = attn_forward(p["attn"], h, positions, cfg, causal=causal,
                             window=window, use_rope=use_rope,
                             q_chunk=q_chunk,
                             mctx=None if kernel is False else mctx)
    x, h2 = add_rmsnorm(x, a, p["ln2"], cfg.norm_eps)
    if moe:
        f, aux = moe_ffn(p["moe"], h2, cfg, mctx)
    else:
        f, aux = mlp_apply(p["mlp"], h2, gated=gated), _zero_aux(x)
    return x + f, kv, aux


def _cross_block_fwd(p, x, enc_out, positions, cfg: ModelConfig,
                     mctx: MCtx, *, q_chunk: int = 512):
    """whisper's decoder block: causal self-attention, cross-attention to
    ``enc_out``, the ungated MLP, all without rope and chunked. Returns
    (x, {self, cross} K/V)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, kv = attn_forward(p["attn"], h, positions, cfg, causal=True,
                         use_rope=False, q_chunk=q_chunk)
    x = x + a
    hx = rmsnorm(x, p["ln_x"], cfg.norm_eps)
    cx, xkv = attn_forward(p["xattn"], hx, positions, cfg, causal=False,
                           use_rope=False, x_kv=enc_out, q_chunk=q_chunk)
    x = x + cx
    x = x + mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                      gated=False)
    return x, {"self": kv, "cross": xkv}


_CELL_FWD = {"mamba": ssm_forward, "mlstm": mlstm_forward,
             "slstm": slstm_forward}


def _recurrent_block_fwd(kind: str, p, x, cfg: ModelConfig, mctx: MCtx):
    """A residual block around a recurrent cell's forward (``kind``:
    mamba, mlstm or slstm). Returns (x, the cell's state)."""
    out, cache = _CELL_FWD[kind](p["ssm" if kind == "mamba" else "cell"],
                                 rmsnorm(x, p["ln"], cfg.norm_eps), cfg)
    return x + out, cache


@dataclasses.dataclass(frozen=True)
class Blocks:
    """One path's functions, in the mesh's signatures: ``PLAIN`` or
    ``MESH``, which an entry point picks once by ``MCtx.mesh``."""
    inputs: Callable      # (mctx, t, axes): a whole activation, placed
    embed: Callable       # (mctx, emb, tokens, dtype)
    norm: Callable        # (mctx, x, w, eps)
    attn: Callable        # the attention block: (x, kv, aux)
    recurrent: Callable   # (kind, p, x, cfg, mctx): (x, state)
    cross: Callable       # whisper's decoder block: (x, {self, cross})
    ce_loss: Callable     # (mctx, x, emb, labels, tied)


PLAIN = Blocks(
    inputs=lambda mctx, t, axes: t,
    embed=lambda mctx, emb, tokens, dtype: embed_tokens(emb, tokens, dtype),
    norm=lambda mctx, x, w, eps: rmsnorm(x, w, eps),
    attn=_attn_block_fwd, recurrent=_recurrent_block_fwd,
    cross=_cross_block_fwd,
    ce_loss=lambda mctx, x, emb, labels, tied: chunked_ce_loss(
        x, emb, labels, tied))
MESH = Blocks(inputs=tp.inputs, embed=tp.embed, norm=tp.rms_norm,
              attn=tp.attn_block_fwd, recurrent=tp_recurrent.block_fwd,
              cross=tp.cross_block_fwd, ce_loss=tp.ce_loss)


def _to_ring(kv: dict, window: int, S: int) -> dict:
    """Convert full-length rope'd K/V into ring-cache layout (slot=pos%W)."""
    if window <= 0 or S <= window:
        return kv

    def conv(a):
        return torch.roll(a[:, S - window:], shifts=S % window, dims=1)
    return {k: tp.map_local(conv, v) for k, v in kv.items()}


def _stack(trees: list):
    """Stack a list of same-structure trees leaf by leaf (a new leading
    dim)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], DTensor):
        return tp.stack(trees)
    return torch.stack(trees)


def _apply(fn, x, p, *, collect: bool, remat: bool):
    """``fn(p, x) -> (x, cache, aux)`` applied to one block: the cache is
    kept only with ``collect``; with ``remat`` (and no cache to keep) the
    block is recomputed in the backward pass instead of keeping its
    activations."""
    if collect:
        return fn(p, x)
    if remat:
        def kept(x_, p_):
            y, _, aux = fn(p_, x_)
            return y, aux
        x, aux = checkpoint(kept, x, p, use_reentrant=False)
        return x, None, aux
    x, _, aux = fn(p, x)
    return x, None, aux


def seg_forward(p, x, positions, cfg: ModelConfig, mctx: MCtx, seg: Seg,
                blocks: Blocks, *, collect: bool, remat: bool = False,
                shared_attn=None, q_chunk: int = 512):
    """Run one segment through ``blocks``' attention and recurrent blocks.
    Returns (x, caches, aux): with ``collect`` the caches are stacked like
    the segment's parameters ([n, ...], a group's inner stack [n, sub,
    ...]), else None; aux is the segment's summed MoE load-balancing loss
    (0 without MoE). ``remat`` recomputes each block in the backward pass
    instead of keeping its activations."""
    S = x.shape[1]
    aux = _zero_aux(x)

    def run(fn, x, p):
        return _apply(fn, x, p, collect=collect, remat=remat)

    def attn_blk(window, moe):
        def fn(lp, x):
            x, kv, a = blocks.attn(lp, x, positions, cfg, mctx,
                                   window=window, moe=moe, q_chunk=q_chunk)
            return x, (mctx.constrain_kv(_to_ring(kv, window, S))
                       if collect else None), a
        return fn

    def cell(kind):                  # a recurrent block: no MoE loss
        def fn(lp, x):
            return (*blocks.recurrent(kind, lp, x, cfg, mctx), None)
        return fn

    def shared_blk(sa, x):           # zamba2's shared attention block
        x, kv, _ = blocks.attn(sa, x, positions, cfg, mctx, window=0,
                               kernel=False, q_chunk=q_chunk)
        return x, mctx.constrain_kv(kv) if collect else None, None

    if seg.n == 0:                  # a plan may leave a segment empty
        caches = (_empty_caches(cfg, seg, x.shape[0], S, x.device)
                  if collect else None)
        return x, caches, aux

    caches = []
    for lp in layer_views(p, seg.n):
        if seg.kind == "attn":
            x, c, a = run(attn_blk(seg.window, seg.moe), x, lp)
            aux = aux + a
        elif seg.kind == "gemma":
            local = []
            for ll in layer_views(lp["local"], seg.sub):
                x, c, a = run(attn_blk(seg.window, False), x, ll)
                local.append(c)
            x, gc, a = run(attn_blk(0, False), x, lp["global"])
            c = {"local": _stack(local), "global": gc} if collect else None
        elif seg.kind == "zamba":
            mam = []
            for ll in layer_views(lp["mamba"], seg.sub):
                x, mc, _ = run(cell("mamba"), x, ll)
                mam.append(mc)
            x, kv, _ = run(shared_blk, x, shared_attn)
            c = {"mamba": _stack(mam), "attn": kv} if collect else None
        elif seg.kind == "mamba":
            x, c, _ = run(cell("mamba"), x, lp)
        elif seg.kind == "xlstm":
            ml = []
            for ll in layer_views(lp["mlstm"], seg.sub):
                x, mc, _ = run(cell("mlstm"), x, ll)
                ml.append(mc)
            x, sc, _ = run(cell("slstm"), x, lp["slstm"])
            c = {"mlstm": _stack(ml), "slstm": sc} if collect else None
        elif seg.kind == "xlstm_tail":
            x, c, _ = run(cell("mlstm"), x, lp)
        else:
            raise ValueError(seg.kind)
        caches.append(c)
    return x, (_stack(caches) if collect else None), aux


def _empty_caches(cfg: ModelConfig, seg: Seg, B: int, S: int, device):
    """The collected caches of a segment of no layers: empty stacks of the
    decode cache's shapes at length S."""
    return map_specs(lambda s: torch.zeros(s.shape,
                                           dtype=torch_dtype(s.dtype),
                                           device=device),
                     kvcache.seg_cache_specs(cfg, seg, B, S))


# --------------------------------------------------------------------------
# Top-level forward
# --------------------------------------------------------------------------


def _arange_positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _positions(cfg: ModelConfig, batch: dict, B: int, S: int, device
               ) -> torch.Tensor:
    """The batch's ``positions`` where it has them, else ``arange(S)`` for
    every row (M-RoPE: in all three axes)."""
    if "positions" in batch:
        return batch["positions"].to(device)
    pos = _arange_positions(B, S, device)
    if cfg.mrope:
        pos = pos[None].expand(3, B, S)
    return pos


def forward_hidden(params, cfg: ModelConfig, mctx: MCtx, batch: dict, *,
                   collect: bool = False, remat: bool = False,
                   q_chunk: int = 512):
    """Returns (hidden (B,S,d), caches, aux). Decoder-only archs; with
    ``collect`` the caches are every segment's stacked caches, else None
    per segment; aux is the MoE load-balancing loss summed over layers.

    ``batch`` holds ``tokens`` (B, S), or for a vision or audio frontend
    ``embeds`` (B, S, d), and optionally ``positions`` ((B, S), or (3, B,
    S) for M-RoPE); without them positions run ``arange(S)`` for every
    row. There is no padding mask, as in the reference.
    """
    blocks = MESH if mctx.mesh is not None else PLAIN
    dtype = torch_dtype(cfg.dtype)
    if cfg.frontend in ("vision", "audio") and "embeds" in batch:
        x = blocks.inputs(mctx, batch["embeds"].to(dtype),
                          ("act_batch", None, None))
    else:
        x = blocks.embed(mctx, params["embed"], batch["tokens"], dtype)
    B, S = x.shape[:2]
    positions = _positions(cfg, batch, B, S, x.device)
    x = mctx.constrain(x, ("act_batch", "act_seq", "act_embed"))
    caches: dict[str, Optional[Any]] = {}
    aux = _zero_aux(x)
    shared = params.get("shared_attn")
    for seg in segment_plan(cfg):
        x, c, a = seg_forward(params[seg.name], x, positions, cfg, mctx, seg,
                              blocks, collect=collect, remat=remat,
                              shared_attn=shared, q_chunk=q_chunk)
        x = mctx.constrain(x, ("act_batch", "act_seq", "act_embed"))
        caches[seg.name] = c
        aux = aux + a
    x = blocks.norm(mctx, x, params["final_norm"], cfg.norm_eps)
    return x, caches, aux


def _with_positions(x, pe: torch.Tensor, mctx: MCtx):
    """``x`` (B, S, d) plus fixed positions ``pe`` (S, d); on a mesh ``x``
    is placed with its sequence and width whole first (a partial sum
    reduced)."""
    x = mctx.constrain(x, ("act_batch", None, None))
    return tp.map_local(lambda t: t + pe, x)


def encode(params, cfg: ModelConfig, mctx: MCtx, frames: torch.Tensor, *,
           remat: bool = False, q_chunk: int = 512) -> torch.Tensor:
    """Whisper's encoder: ``frames`` (B, S_enc, d) plus sinusoidal
    positions through the bidirectional, ungated blocks without rope (the
    flash kernel's path under ``attention_kernel="kernel"``), then
    ``enc_norm``. On a mesh the output is whole in the sequence and width
    (the layout cross-attention's K/V projections read)."""
    blocks = MESH if mctx.mesh is not None else PLAIN
    dtype = torch_dtype(cfg.dtype)
    frames = blocks.inputs(mctx, frames.to(dtype), ("act_batch", None, None))
    B, S_enc = frames.shape[:2]
    dev = frames.device
    pe = sinusoidal_pos_emb(torch.arange(S_enc, device=dev),
                            cfg.d_model).to(dtype)
    x = _with_positions(frames, pe, mctx)
    pos = _arange_positions(B, S_enc, dev)

    def block(lp, x):
        return blocks.attn(lp, x, pos, cfg, mctx, window=0, causal=False,
                           use_rope=False, gated=False, q_chunk=q_chunk)
    for lp in layer_views(params["encoder"], cfg.num_encoder_layers):
        x, _, _ = _apply(block, x, lp, collect=False, remat=remat)
    return mctx.constrain(blocks.norm(mctx, x, params["enc_norm"],
                                      cfg.norm_eps),
                          ("act_batch", None, None))


def encdec_forward(params, cfg: ModelConfig, mctx: MCtx, batch: dict, *,
                   collect: bool = False, remat: bool = False,
                   q_chunk: int = 512):
    """Whisper-style encoder-decoder. batch: frames (B, S_enc, d), tokens
    (B, S_dec). Returns (hidden (B, S_dec, d), caches, aux 0): with
    ``collect`` the decoder's stacked {self, cross} K/V, else None. The
    decoder's attention takes chunked attention on every path, as the
    reference's (which calls it without its mesh context)."""
    blocks = MESH if mctx.mesh is not None else PLAIN
    enc_out = encode(params, cfg, mctx, batch["frames"], remat=remat,
                     q_chunk=q_chunk)
    dtype = torch_dtype(cfg.dtype)
    tokens = batch["tokens"]
    B, S_dec = tokens.shape
    dev = enc_out.device
    x = blocks.embed(mctx, params["embed"], tokens, dtype)
    x = _with_positions(x, sinusoidal_pos_emb(
        torch.arange(S_dec, device=dev), cfg.d_model).to(dtype), mctx)
    dec_pos = _arange_positions(B, S_dec, dev)
    zero = _zero_aux(x)

    def block(lp, x):
        x, kv = blocks.cross(lp, x, enc_out, dec_pos, cfg, mctx,
                             q_chunk=q_chunk)
        return x, kv, zero
    caches = []
    for lp in layer_views(params["decoder"], cfg.num_layers):
        x, c, _ = _apply(block, x, lp, collect=collect, remat=remat)
        caches.append(c)
    x = blocks.norm(mctx, x, params["final_norm"], cfg.norm_eps)
    return x, (_stack(caches) if collect else None), zero


def loss_fn(params, cfg: ModelConfig, mctx: MCtx, batch: dict,
            aux_coef: float = 0.001, q_chunk: int = 512):
    """Mean next-token cross-entropy of ``batch`` ({tokens, labels}; for
    whisper also frames, for a vision or audio frontend embeds in place of
    tokens) plus ``aux_coef`` times the MoE load-balancing loss, and its
    parts (aux is 0 without MoE, as in the reference)."""
    if mctx.parallel.attention_kernel == "kernel":
        raise ValueError("attention_kernel='kernel' has no backward pass "
                         "(neither has the reference's Pallas kernel); "
                         "training takes attention_kernel='eager'")
    blocks = MESH if mctx.mesh is not None else PLAIN
    remat = mctx.parallel.remat != "none"
    forward = encdec_forward if cfg.encoder_decoder else forward_hidden
    x, _, aux = forward(params, cfg, mctx, batch, remat=remat,
                        q_chunk=q_chunk)
    ce = blocks.ce_loss(mctx, x, params["embed"], batch["labels"],
                        cfg.tie_embeddings)
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}
