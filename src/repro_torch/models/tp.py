"""The mesh path: blocks that compute on local shards between the
reference's sharding constraints.

With ``MCtx.mesh`` set, weights are DTensors placed by the sharding rules
and activations are DTensors between blocks, redistributed by
``MCtx.constrain`` where the reference constrains them. Each block body
here runs on local tensors (``launch.mesh.shard_map``), Megatron-style:

* weights enter in their *compute layout*, the rules with FSDP, sequence
  parallelism and 2-D serving weights off (heads, kv heads where they
  divide, the MLP hidden dim and the vocabulary on ``model``); a weight
  stored another way (FSDP over ``data``, ``serve_2d_weights``) is
  redistributed to it at the block's entry, which is the FSDP gather;
* column-parallel projections (q, k, v, gate, up, the vocabulary) need no
  reduction; the row-parallel ones (the attention output, down) leave a
  partial sum over ``model``, returned as a ``Partial`` DTensor that the
  next constraint reduces (an all-reduce, or a reduce-scatter into the
  sequence-parallel layout);
* ops DTensor has no sharding strategy for on a sharded dim (the MoE
  dispatch's sorts, gathers and scatters; the flash kernel; the decode
  cache's in-place writes) only ever see local tensors.

The gradient of a replicated input of a body is summed over a mesh axis
(``Partial``) exactly when the body's work differs along that axis (some
input or output of the body is sharded or partial over it); otherwise every
rank along it computes the same gradient (``Replicate``).

Every arch runs on a mesh. Here: the attention archs' blocks, MLA
(deepseek-v3: the latents computed whole on every rank, the up-projections
and ``w_o`` on local heads; decode in the absorbed form against a
sequence-sharded latent cache), cross-attention and the ungated MLP
(whisper's encoder and decoder), and the MoE bodies; the recurrent cells
(Mamba2, mLSTM, sLSTM) are in ``models/tp_recurrent.py``. Where ``model``
does not divide the heads (whisper-small's 12 over 16) or the vocabulary
(51865), the weights stay whole on ``model`` and every rank computes every
head or every logit.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.config.base import ModelConfig, ParallelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.norm_rope.ref import rmsnorm_ref
from repro_torch.launch.mesh import DATA_AXIS, MODEL_AXIS, shard_map
from repro_torch.models import attention
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (NEG_INF, _gqa_ctx, _gqa_scores,
                                          chunked_attention,
                                          decode_attention)
from repro_torch.models.layers import apply_rope
from repro_torch.models.sharding import (distribute, logical_rules,
                                         placements_of, spec_for)

# all_gather_tensor's newer name, where the installed torch has it
_all_gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)

_COMPUTE = ParallelConfig(fsdp=False, seq_parallel=False,
                          serve_2d_weights=False)


# --------------------------------------------------------------------------
# Layouts
# --------------------------------------------------------------------------


def _names(mesh) -> list[str]:
    return list(mesh.mesh_dim_names)


def _pl(mctx, axes, shape, rules=None, partial=()) -> list:
    rules = mctx.rules if rules is None else rules
    return placements_of(spec_for(axes, rules, tuple(shape), mctx.mesh),
                         mctx.mesh, partial)


def act(mctx, axes, shape, partial=()) -> list:
    """Placements of an activation with logical ``axes``."""
    return _pl(mctx, axes, shape, partial=partial)


_COMPUTE_RULES: dict = {}


def _compute_rules(mctx) -> dict:
    key = tuple(mctx.mesh.mesh_dim_names)
    if key not in _COMPUTE_RULES:
        _COMPUTE_RULES[key] = logical_rules(mctx.mesh, _COMPUTE)
    return _COMPUTE_RULES[key]


def wpl(mctx, axes, shape) -> list:
    """A weight's (or a block-internal activation's) compute-layout
    placements."""
    return _pl(mctx, axes, shape, _compute_rules(mctx))


def _on_model(pl, mesh) -> bool:
    """Is a tensor with placements ``pl`` sharded over ``model``?"""
    names = _names(mesh)
    return (MODEL_AXIS in names
            and isinstance(pl[names.index(MODEL_AXIS)], Shard))


def _model_partial(mctx, pl) -> list:
    """``pl`` with ``model`` made Partial (a row-parallel output)."""
    names = _names(mctx.mesh)
    out = list(pl)
    if MODEL_AXIS in names:
        out[names.index(MODEL_AXIS)] = Partial()
    return out


def _shape(t) -> tuple:
    return tuple(t.shape)


def place(x: DTensor, pl) -> DTensor:
    """``x`` redistributed to ``pl`` (itself where it is placed so)."""
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(x.device_mesh, list(pl))


def body(mctx, f, ins, outs):
    """Run ``f`` on local shards: ``ins`` is [(tensor, placements or
    None)], ``outs`` the output placements (None: a plain output). Plain
    inputs with placements are whole values every rank holds (weights
    carried in, positions, tokens) and pass as this rank's shard of them."""
    mesh = mctx.mesh
    every = [pl for _, pl in ins if pl is not None] + [
        pl for pl in outs if pl is not None]
    varies = [any(not isinstance(pl[m], Replicate) for pl in every)
              for m in range(mesh.ndim)]
    tensors, placements, grads = [], [], []
    for t, pl in ins:
        if pl is not None and not isinstance(t, DTensor):
            t = distribute(t, mesh, pl)
        tensors.append(t)
        placements.append(pl)
        grads.append(None if pl is None else [
            Partial() if varies[m] and isinstance(p, Replicate) else p
            for m, p in enumerate(pl)])
    return shard_map(f, mesh=mesh, in_placements=placements,
                     out_placements=outs,
                     in_grad_placements=grads)(*tensors)


def coord(mctx, axis: str) -> int:
    names = _names(mctx.mesh)
    return mctx.mesh.get_coordinate()[names.index(axis)] if (
        axis in names) else 0


def _group(mctx, axis: str):
    return (mctx.mesh, _names(mctx.mesh).index(axis))


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over one mesh axis whose result every rank of the
    axis uses alike, so each input's gradient is the result's."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        return funcol.all_reduce(t, "sum", (mesh, dim))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOver(torch.autograd.Function):
    """All-gather (tiled on ``gather_dim``) over one mesh axis whose
    result every rank of the axis uses alike: the gradient of a rank's
    piece is its slice of the result's."""

    @staticmethod
    def forward(ctx, t, mesh, dim, gather_dim):
        ctx.n, ctx.i = mesh.size(dim), mesh.get_coordinate()[dim]
        ctx.gather_dim = gather_dim
        return _all_gather(t.contiguous(), gather_dim, (mesh, dim))

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.gather_dim)[ctx.i], None, None, None


class _ReduceOver(torch.autograd.Function):
    """All-reduce (sum) over one mesh axis whose result each rank uses
    for its own shard: each input's gradient is the sum of the results'."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.group = (mesh, dim)
        return funcol.all_reduce(t, "sum", (mesh, dim))

    @staticmethod
    def backward(ctx, g):
        return funcol.all_reduce(g, "sum", ctx.group), None, None


class _GatherScatter(torch.autograd.Function):
    """All-gather (tiled on ``gather_dim``) over one mesh axis whose result
    each rank uses for its own part of the work: the gradient of a rank's
    piece is its slice of the sum of the results' (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, mesh, dim, gather_dim):
        ctx.group, ctx.gather_dim = (mesh, dim), gather_dim
        return _all_gather(t.contiguous(), gather_dim, (mesh, dim))

    @staticmethod
    def backward(ctx, g):
        return funcol.reduce_scatter_tensor(g.contiguous(), "sum",
                                            ctx.gather_dim, ctx.group), \
            None, None, None


def sum_over(mctx, t, axis: str):
    if axis not in _names(mctx.mesh):
        return t
    return _SumOver.apply(t, mctx.mesh, _names(mctx.mesh).index(axis))


def reduce_over(mctx, t, axis: str):
    """``t`` summed over ``axis``, for a result each rank uses on its own
    shard (a norm's sum of squares over a split dim)."""
    if axis not in _names(mctx.mesh):
        return t
    return _ReduceOver.apply(t, mctx.mesh, _names(mctx.mesh).index(axis))


def gather_split(mctx, t, axis: str, dim: int):
    """``t``'s pieces over ``axis`` joined on ``dim``, for a result each
    rank uses for its own part of the work (a recurrence on every head
    whose output rows each rank projects its own columns of)."""
    if axis not in _names(mctx.mesh):
        return t
    return _GatherScatter.apply(t, mctx.mesh, _names(mctx.mesh).index(axis),
                                dim)


def gather_over(mctx, t, axis: str, dim: int):
    if axis not in _names(mctx.mesh):
        return t
    return _GatherOver.apply(t, mctx.mesh, _names(mctx.mesh).index(axis),
                             dim)


# --------------------------------------------------------------------------
# DTensor trees
# --------------------------------------------------------------------------


def _shift(pl, by: int) -> list:
    return [Shard(p.dim + by) if isinstance(p, Shard) else p for p in pl]


def unbind(t: DTensor) -> list:
    """Views of a DTensor along its (replicated) dim 0."""
    if any(isinstance(p, Shard) and p.dim == 0 for p in t.placements):
        raise ValueError("unbind along a sharded dim")
    pl = _shift(t.placements, -1)
    return [DTensor.from_local(v, t.device_mesh, pl, run_check=False)
            for v in torch.unbind(t.to_local())]


def stack(ts: list) -> DTensor:
    """Stack DTensors of one placement along a new dim 0."""
    pl = ts[0].placements
    return DTensor.from_local(torch.stack([t.to_local() for t in ts]),
                              ts[0].device_mesh, _shift(pl, 1),
                              run_check=False)


def map_local(fn, t):
    """``fn`` on the local tensor of a DTensor whose dims ``fn`` changes
    are not sharded; the result keeps the placements."""
    if not isinstance(t, DTensor):
        return fn(t)
    return DTensor.from_local(fn(t.to_local()), t.device_mesh,
                              t.placements, run_check=False)


def _d_free(mctx, x: DTensor) -> DTensor:
    """``x`` with its last (d) dim gathered where it is sharded."""
    last = x.dim() - 1
    pl = [Replicate() if isinstance(p, Shard) and p.dim == last else p
          for p in x.placements]
    return place(x, pl)


# --------------------------------------------------------------------------
# Token-wise pieces
# --------------------------------------------------------------------------


def rms_norm(mctx, x: DTensor, w, eps: float) -> DTensor:
    """rmsnorm on local tokens, in any layout with d whole: the plain
    chain, as the mesh's rope and split norms keep theirs."""
    x = _d_free(mctx, x)
    return body(mctx, lambda x_, w_: rmsnorm_ref(x_, w_, eps),
                [(x, x.placements), (w, wpl(mctx, (None,), _shape(w)))],
                [x.placements])


def add(x: DTensor, y: DTensor) -> DTensor:
    """The residual add, on local tensors of one layout."""
    if list(x.placements) != list(y.placements):
        raise ValueError(f"add of {x.placements} and {y.placements}")
    return DTensor.from_local(x.to_local() + y.to_local(), x.device_mesh,
                              x.placements, run_check=False)


def embed(mctx, emb: dict, tokens, dtype) -> DTensor:
    """Vocab-parallel lookup in ``emb["tok"]``: each rank reads its rows of
    the table and leaves zeros for the rest, a partial sum over
    ``model``."""
    tok_w = emb["tok"]
    V, d = tok_w.shape
    wp = wpl(mctx, ("vocab", "embed"), (V, d))
    tok_pl = _pl(mctx, ("act_batch", None), _shape(tokens))
    sharded = _on_model(wp, mctx.mesh)
    V_l = V // mctx.model_size if sharded else V
    v0 = coord(mctx, MODEL_AXIS) * V_l if sharded else 0

    def f(w, t):
        w = w.to(dtype)
        if not sharded:
            return w[t]
        ids = t.long() - v0
        hit = (ids >= 0) & (ids < V_l)
        return w[ids.clamp(0, V_l - 1)] * hit[..., None].to(dtype)
    out_pl = _model_partial(mctx, tok_pl) if sharded else list(tok_pl)
    return body(mctx, f, [(tok_w, wp), (tokens, tok_pl)], [out_pl])


def inputs(mctx, t, axes) -> DTensor:
    """A whole activation every rank holds (a frontend's embeds) as a
    DTensor in the layout of its logical axes."""
    return distribute(t, mctx.mesh, act(mctx, axes, _shape(t)))


def last_token(mctx, x: DTensor) -> DTensor:
    """x[:, -1:] of (B, S, d): where the sequence is sharded only its last
    shard's rank keeps its row (a partial sum, reduced here)."""
    seq_dims = _seq_dims(x)
    last = all(mctx.mesh.get_coordinate()[m] == mctx.mesh.size(m) - 1
               for m in seq_dims)
    out_pl = [Partial() if m in seq_dims else p
              for m, p in enumerate(x.placements)]

    def f(x_):
        r = x_[:, -1:]
        return r if last else torch.zeros_like(r)
    y = body(mctx, f, [(x, x.placements)], [out_pl])
    if not seq_dims:
        return y
    return y.redistribute(mctx.mesh, [Replicate() if m in seq_dims else p
                                      for m, p in enumerate(out_pl)])


def unembed(mctx, emb: dict, x: DTensor, tied: bool) -> DTensor:
    """Logits (B, S, V) vocab-sharded over ``model`` (act_vocab)."""
    x = place(x, act(mctx, ("act_batch", None, None), _shape(x)))
    w = emb["tok"] if tied else emb["out"]
    axes = ("vocab", "embed") if tied else ("embed", "vocab")
    wp = wpl(mctx, axes, _shape(w))
    sharded = _on_model(wp, mctx.mesh)
    out_pl = list(x.placements)
    if sharded:
        out_pl[_names(mctx.mesh).index(MODEL_AXIS)] = Shard(2)

    def f(x_, w_):
        return x_ @ (w_.T if tied else w_).to(x_.dtype)
    return body(mctx, f, [(x, x.placements), (w, wp)], [out_pl])


def ce_loss(mctx, x: DTensor, emb: dict, labels, tied: bool,
            chunk: int = 512):
    """Mean next-token cross-entropy with the vocabulary sharded over
    ``model`` (Megatron's vocab-parallel CE: each rank's logits for its
    rows, the max, the sum of exponentials and the picked logit reduced
    over ``model``), in the plain path's sequence chunks. Returns a plain
    scalar, the same on every rank."""
    x = place(x, act(mctx, ("act_batch", None, None), _shape(x)))
    B, S, _ = x.shape
    w = emb["tok"] if tied else emb["out"]
    axes = ("vocab", "embed") if tied else ("embed", "vocab")
    wp = wpl(mctx, axes, _shape(w))
    sharded = _on_model(wp, mctx.mesh)
    V = w.shape[0 if tied else 1]
    V_l = V // mctx.model_size if sharded else V
    v0 = coord(mctx, MODEL_AXIS) * V_l if sharded else 0
    lp = _pl(mctx, ("act_batch", None), _shape(labels))
    batch_axes = [a for a, p in zip(_names(mctx.mesh), x.placements)
                  if isinstance(p, Shard) and p.dim == 0]
    out_pl = [Partial() if a in batch_axes else Replicate()
              for a in _names(mctx.mesh)]

    def f(x_, w_, lab):
        wt = (w_.T if tied else w_)
        s_len = x_.shape[1]
        c = min(chunk, s_len)
        n, rem = s_len // c, s_len % c
        spans = [(i * c, (i + 1) * c) for i in range(n)]
        if rem:
            spans.append((n * c, s_len))
        total = torch.zeros((), dtype=torch.float32, device=x_.device)
        for a, b in spans:
            logits = (x_[:, a:b] @ wt.to(x_.dtype)).float()
            m = logits.detach().amax(-1)
            if sharded:
                m = funcol.all_reduce(m, "max", _group(mctx, MODEL_AXIS))
            se = torch.exp(logits - m[..., None]).sum(-1)
            ids = lab[:, a:b].long() - v0
            hit = (ids >= 0) & (ids < V_l)
            picked = torch.gather(logits, -1,
                                  ids.clamp(0, V_l - 1)[..., None])[..., 0]
            picked = picked * hit
            if sharded:
                se = sum_over(mctx, se, MODEL_AXIS)
                picked = sum_over(mctx, picked, MODEL_AXIS)
            total = total + torch.sum(m + torch.log(se) - picked)
        return total
    tot = body(mctx, f, [(x, x.placements), (w, wp), (labels, lp)],
               [out_pl])
    tot = tot.redistribute(mctx.mesh, [Replicate()] * mctx.mesh.ndim)
    return tot.to_local() / (B * S)


# --------------------------------------------------------------------------
# Attention and MLP blocks
# --------------------------------------------------------------------------


def _proj(mctx, x: DTensor, w, w_axes, b=None, b_axes=None) -> DTensor:
    """Column-parallel head projection: (B, S, d) x (d, H, dh) ->
    (B, S, H, dh), heads as the weight's compute layout has them."""
    x = place(x, act(mctx, ("act_batch", None, None), _shape(x)))
    wp = wpl(mctx, w_axes, _shape(w))
    out_pl = list(x.placements)
    if _on_model(wp, mctx.mesh):
        out_pl[_names(mctx.mesh).index(MODEL_AXIS)] = Shard(2)
    ins = [(x, x.placements), (w, wp)]
    if b is not None:
        ins.append((b, wpl(mctx, b_axes, _shape(b))))

    def f(x_, w_, *b_):
        d, H, dh = w_.shape
        y = (x_ @ w_.reshape(d, H * dh).to(x_.dtype)).unflatten(-1, (H, dh))
        return y + b_[0].to(y.dtype) if b_ else y
    return body(mctx, f, ins, [out_pl])


def _kv_span(Hq: int, Hkv: int, Hq_l: int, q0: int, Hkv_l: int, k0: int):
    """The kv heads (as a slice of the local ones) that local q heads
    q0 .. q0+Hq_l read under GQA."""
    G = Hq // Hkv
    lo, hi = q0 // G, (q0 + Hq_l - 1) // G + 1
    if (Hq_l % G and G % Hq_l) or lo < k0 or hi > k0 + Hkv_l:
        raise NotImplementedError(
            f"GQA: {Hq_l} local q heads of {Hq} do not meet whole kv "
            f"heads ({Hkv_l} local of {Hkv})")
    return lo - k0, hi - k0


def attn_forward(p: dict, h: DTensor, positions, cfg: ModelConfig, mctx, *,
                 causal: bool, window: int, use_rope: bool, q_chunk: int,
                 x_kv: DTensor | None = None, kernel: bool | None = None):
    """Self-attention on local heads, or cross-attention to ``x_kv``
    (whisper's decoder, without rope). Returns (a, kv): ``a`` the
    row-parallel output (partial over ``model`` where the heads are
    split), kv the rope'd k and v. ``kernel`` (default: the mesh context's
    ``attention_kernel``) takes the flash kernel where q and k are as
    long, as the plain path does."""
    hax = ("act_batch", None, "act_heads", None)
    src = h if x_kv is None else x_kv
    q = _proj(mctx, h, p["w_q"], ("embed", "heads", None),
              p.get("b_q"), ("heads", None))
    k = _proj(mctx, src, p["w_k"], ("embed", "kv_heads", None),
              p.get("b_k"), ("kv_heads", None))
    v = _proj(mctx, src, p["w_v"], ("embed", "kv_heads", None),
              p.get("b_v"), ("kv_heads", None))
    # pin heads to 'model' (TP), as the reference's attn_forward does
    q = mctx.constrain(q, hax)
    k = mctx.constrain(k, hax)
    v = mctx.constrain(v, hax)
    # the body takes heads as the weights' compute layout has them (the
    # same placements but under serve_2d_weights, whose act_heads is None)
    q, k, v = (place(t, wpl(mctx, hax, _shape(t))) for t in (q, k, v))
    Hq, Hkv = q.shape[2], k.shape[2]
    wo = p["w_o"]
    wop = wpl(mctx, ("heads", None, "embed"), _shape(wo))
    heads_sharded = _on_model(q.placements, mctx.mesh)
    if heads_sharded != _on_model(wop, mctx.mesh):
        raise NotImplementedError("q heads and w_o heads split differently")
    tp_n = mctx.model_size
    r = coord(mctx, MODEL_AXIS)
    Hq_l = Hq // tp_n if heads_sharded else Hq
    kv_sharded = _on_model(k.placements, mctx.mesh)
    Hkv_l = Hkv // tp_n if kv_sharded else Hkv
    k_lo, k_hi = _kv_span(Hq, Hkv, Hq_l, r * Hq_l if heads_sharded else 0,
                          Hkv_l, r * Hkv_l if kv_sharded else 0)
    pos_axes = (None, "act_batch", None) if cfg.mrope else ("act_batch",
                                                           None)
    pp = _pl(mctx, pos_axes, _shape(positions))
    out_pl = list(act(mctx, ("act_batch", None, None),
                      (h.shape[0], h.shape[1], wo.shape[-1])))
    if heads_sharded:
        out_pl = _model_partial(mctx, out_pl)
    if kernel is None:
        kernel = mctx.parallel.attention_kernel == "kernel"
    use_kernel = kernel and q.shape[1] == k.shape[1]

    def f(q_, k_, v_, pos, wo_):
        if use_rope:
            q_ = apply_rope(q_, pos, cfg.rope_theta, cfg.mrope)
            k_ = apply_rope(k_, pos, cfg.rope_theta, cfg.mrope)
        ks, vs = k_[:, :, k_lo:k_hi], v_[:, :, k_lo:k_hi]
        if use_kernel:
            ctx = flash_attention(q_.transpose(1, 2), ks.transpose(1, 2),
                                  vs.transpose(1, 2), causal=causal,
                                  window=window).transpose(1, 2)
        else:
            ctx = chunked_attention(q_, ks, vs, causal=causal,
                                    window=window, q_chunk=q_chunk)
        H, dh, d = wo_.shape
        out = ctx.flatten(-2) @ wo_.reshape(H * dh, d).to(ctx.dtype)
        return out, k_, v_
    a, k, v = body(mctx, f, [(q, q.placements), (k, k.placements),
                             (v, v.placements), (positions, pp), (wo, wop)],
                   [out_pl, k.placements, v.placements])
    return a, {"k": k, "v": v}


def mlp(mctx, p: dict, h: DTensor, gated: bool = True) -> DTensor:
    """Column- then row-parallel MLP, gated, or whisper's ungated gelu one
    with biases; the output is partial over ``model`` where the hidden dim
    is split (``b_down`` counted on the first rank of ``model`` only)."""
    h = place(h, act(mctx, ("act_batch", None, None), _shape(h)))
    axes = ({"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
             "w_down": ("mlp", "embed")} if gated else
            {"w_up": ("embed", "mlp"), "b_up": ("mlp",),
             "w_down": ("mlp", "embed"), "b_down": (None,)})
    ins = [(h, h.placements)] + [(p[n], wpl(mctx, a, _shape(p[n])))
                                 for n, a in axes.items()]
    sharded = _on_model(wpl(mctx, axes["w_down"], _shape(p["w_down"])),
                        mctx.mesh)
    out_pl = _model_partial(mctx, h.placements) if sharded else list(
        h.placements)
    # every rank uses b_down, so every rank's backward runs the same
    # collectives; only the first rank of 'model' adds it
    once = 1.0 if coord(mctx, MODEL_AXIS) == 0 or not sharded else 0.0

    def f(x, *ws):
        dt = x.dtype
        if gated:
            wg, wu, wd = ws
            return (F.silu(x @ wg.to(dt)) * (x @ wu.to(dt))) @ wd.to(dt)
        wu, bu, wd, bd = ws
        y = F.gelu(x @ wu.to(dt) + bu.to(dt), approximate="tanh") @ wd.to(dt)
        return y + bd.to(dt) * once
    return body(mctx, f, ins, [out_pl])


def attn_block_fwd(p, x: DTensor, positions, cfg: ModelConfig, mctx, *,
                   window: int, moe: bool = False, causal: bool = True,
                   use_rope: bool = True, gated: bool = True,
                   kernel: bool | None = None, q_chunk: int = 512):
    """The reference's ``_attn_block_fwd`` on the mesh: Megatron-SP, the
    sequence gathered at block entry (``sp_in``) and reduce-scattered back
    at exit (``sp_out``). Returns (x, kv, aux)."""
    sp_in = ("act_batch", None, None)
    sp_out = ("act_batch", "act_seq", "act_embed")
    h = rms_norm(mctx, x, p["ln1"], cfg.norm_eps)
    h = mctx.constrain(h, sp_in)
    if cfg.attn_type == "mla":
        a, kv = mla_forward(p["attn"], h, positions, cfg, mctx,
                            q_chunk=q_chunk)
    else:
        a, kv = attn_forward(p["attn"], h, positions, cfg, mctx,
                             causal=causal, window=window, use_rope=use_rope,
                             q_chunk=q_chunk, kernel=kernel)
    a = mctx.constrain(a, sp_out)
    x = add(mctx.constrain(x, sp_out), a)
    h2 = rms_norm(mctx, x, p["ln2"], cfg.norm_eps)
    if moe:
        f, aux = moe_ffn(p["moe"], h2, cfg, mctx)
    else:
        h2 = mctx.constrain(h2, sp_in)
        f = mlp(mctx, p["mlp"], h2, gated=gated)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    f = mctx.constrain(f, sp_out)
    return add(x, f), kv, aux


def cross_block_fwd(p, x: DTensor, enc_out: DTensor, positions,
                    cfg: ModelConfig, mctx, *, q_chunk: int = 512):
    """whisper's decoder block: causal self-attention, cross-attention to
    ``enc_out``, the ungated MLP, each pre-normed and added; both
    attentions chunked, as the reference's (called without its mesh
    context) are. Returns (x, {self, cross} K/V)."""
    sp_in = ("act_batch", None, None)
    sp_out = ("act_batch", "act_seq", "act_embed")

    def part(ln, fn):
        h = mctx.constrain(rms_norm(mctx, x, p[ln], cfg.norm_eps), sp_in)
        out, kv = fn(h)
        return add(mctx.constrain(x, sp_out), mctx.constrain(out, sp_out)), kv
    x, kv = part("ln1", lambda h: attn_forward(
        p["attn"], h, positions, cfg, mctx, causal=True, window=0,
        use_rope=False, q_chunk=q_chunk, kernel=False))
    x, xkv = part("ln_x", lambda h: attn_forward(
        p["xattn"], h, positions, cfg, mctx, causal=False, window=0,
        use_rope=False, q_chunk=q_chunk, x_kv=enc_out, kernel=False))
    x, _ = part("ln2", lambda h: (mlp(mctx, p["mlp"], h, gated=False), None))
    return x, {"self": kv, "cross": xkv}


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

_MLA_KEYS = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk",
             "w_uv", "w_o")


def _mla_weights(p: dict, cfg: ModelConfig, mctx):
    """MLA's weights in their compute layout (the up-projections and
    ``w_o`` on local heads, the down-projections and norms whole), and
    whether the heads are split over ``model``."""
    specs = attention.mla_specs(cfg)
    ins = [(p[k], wpl(mctx, specs[k].axes, specs[k].shape))
           for k in _MLA_KEYS]
    return ins, _on_model(ins[_MLA_KEYS.index("w_o")][1], mctx.mesh)


def mla_forward(p: dict, h: DTensor, positions, cfg: ModelConfig, mctx, *,
                q_chunk: int = 512):
    """MLA prefill on local heads: every rank computes the latents (ckv,
    k_rope) whole, then q, the up-projected K/V and ``w_o`` for its heads
    (the plain path's ``mla_forward`` on the local weights). Returns (a
    partial over ``model`` where the heads are split, the latents)."""
    h = place(h, act(mctx, ("act_batch", None, None), _shape(h)))
    ins, heads = _mla_weights(p, cfg, mctx)
    pp = _pl(mctx, ("act_batch", None), _shape(positions))
    B, S, d = h.shape
    out_pl = act(mctx, ("act_batch", None, None), (B, S, d))
    lat_pl = [list(out_pl)] * 2
    if heads:
        out_pl = _model_partial(mctx, out_pl)

    def f(x, pos, *ws):
        a, kv = attention.mla_forward(dict(zip(_MLA_KEYS, ws)), x, pos, cfg,
                                      q_chunk=q_chunk)
        return a, kv["ckv"], kv["k_rope"]
    a, ckv, k_rope = body(mctx, f, [(h, h.placements), (positions, pp)]
                          + ins, [out_pl] + lat_pl)
    return a, {"ckv": ckv, "k_rope": k_rope}


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------


def _seq_dims(t: DTensor, dim: int = 1) -> list[int]:
    return [m for m, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == dim]


def _chunks(mctx, cache: DTensor):
    """A cache's sequence split: (the mesh dims that shard it, how many
    chunks, this rank's first slot, its chunk's length)."""
    seq = _seq_dims(cache)
    crd = mctx.mesh.get_coordinate()
    S = cache.shape[1]
    n_chunks, chunk = 1, 0
    for m in seq:
        chunk = chunk * mctx.mesh.size(m) + crd[m]
        n_chunks *= mctx.mesh.size(m)
    if S % n_chunks:
        raise ValueError(f"cache length {S} does not split {n_chunks} ways")
    S_l = S // n_chunks
    return seq, n_chunks, chunk * S_l, S_l


def _same_batch(act_pl, cache_pl) -> None:
    """The batch's placement must agree between activations and cache."""
    bq = [isinstance(pl, Shard) and pl.dim == 0 for pl in act_pl]
    bc = [isinstance(pl, Shard) and pl.dim == 0 for pl in cache_pl]
    if bq != bc:
        raise NotImplementedError(f"cache batch placement {cache_pl} vs "
                                  f"activations {act_pl}")


def _combine(mctx, s, seq, ctx_of):
    """Flash-decoding over the mesh dims ``seq`` that split the keys: the
    softmax of fp32 scores ``s`` (..., S_l), masked, as (context, sum):
    ``ctx_of(e)`` of the exponentials against the global max, both summed
    over ``seq``."""
    m = s.amax(-1, keepdim=True)
    for md in seq:
        m = funcol.all_reduce(m, "max", (mctx.mesh, md))
    e = torch.exp(s - m)
    l_ = e.sum(-1, keepdim=True)
    o = ctx_of(e)
    for md in seq:
        l_ = funcol.all_reduce(l_, "sum", (mctx.mesh, md))
        o = funcol.all_reduce(o, "sum", (mctx.mesh, md))
    return o, l_


def _heads_out(mctx, ctx, wo_, q_sh: bool):
    """This rank's heads of a (B, 1, H, dv) context through the
    row-parallel ``w_o``."""
    if q_sh:
        H_l = ctx.shape[2] // mctx.model_size
        r = coord(mctx, MODEL_AXIS)
        ctx = ctx[:, :, r * H_l:(r + 1) * H_l]
    H, dh, d = wo_.shape
    return ctx.flatten(-2) @ wo_.reshape(H * dh, d).to(ctx.dtype)


def _gqa_chunk(mctx, q_, kc_, vc_, valid, seq, n_chunks, scale=None):
    """Decode attention of all heads' q (B, 1, Hq, dh) against this rank's
    chunk of a (B, S_l, Hkv, dh) cache; one chunk takes the plain path's
    arithmetic, more the flash-decoding combine. The mesh path keeps these
    plain einsums on every device: the dense decode attention kernel that
    the decode without a mesh calls is not used here, and no benchmark
    cell runs this path."""
    if n_chunks == 1:
        return decode_attention(q_, kc_.to(q_.dtype), vc_.to(q_.dtype),
                                valid, scale)
    B, _, Hq, dh = q_.shape
    Hkv = kc_.shape[2]
    G = Hq // Hkv
    qg = q_.reshape(B, 1, Hkv, G, dh)
    scale = dh ** -0.5 if scale is None else scale
    s = _gqa_scores(qg, kc_.to(q_.dtype)) * scale           # (B,Hkv,G,1,S_l)
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    o, l_ = _combine(mctx, s, seq, lambda e: _gqa_ctx(e, vc_.to(q_.dtype)))
    # o: (B,1,Hkv,G,dh); l_: (B,Hkv,G,1,1) -> (B,1,Hkv,G,1)
    return (o / l_.permute(0, 3, 1, 2, 4)).reshape(B, 1, Hq, dh).to(q_.dtype)


def attn_decode(p: dict, h: DTensor, pos: int, cache: dict,
                cfg: ModelConfig, mctx, *, window: int = 0,
                use_rope: bool = True):
    """One decode step against a sequence-sharded cache, flash-decoding
    style: q and the new k/v gathered to every head (a token's worth),
    the new k/v written into the rank that holds slot ``pos``, each rank's
    softmax pieces over its part of the sequence combined over the axes
    that shard it, then the local heads' row-parallel output (partial over
    ``model``). The cache's local tensors are written in place."""
    q = _proj(mctx, h, p["w_q"], ("embed", "heads", None),
              p.get("b_q"), ("heads", None))
    k_new = _proj(mctx, h, p["w_k"], ("embed", "kv_heads", None),
                  p.get("b_k"), ("kv_heads", None))
    v_new = _proj(mctx, h, p["w_v"], ("embed", "kv_heads", None),
                  p.get("b_v"), ("kv_heads", None))
    kc, vc = cache["k"], cache["v"]
    if not isinstance(kc, DTensor):
        raise TypeError("the mesh path's decode cache is a tree of DTensors "
                        "(Model.init_cache, or prefill's)")
    wo = p["w_o"]
    wop = wpl(mctx, ("heads", None, "embed"), _shape(wo))
    q_sh = _on_model(q.placements, mctx.mesh)
    kv_sh = _on_model(k_new.placements, mctx.mesh)
    seq, n_chunks, s0, S_l = _chunks(mctx, kc)
    S = kc.shape[1]
    slot = pos % S if window > 0 else pos
    out_pl = act(mctx, ("act_batch", None, None), _shape(h))
    if _on_model(wop, mctx.mesh):
        out_pl = _model_partial(mctx, out_pl)
    _same_batch(q.placements, kc.placements)

    def f(q_, kn, vn, kc_, vc_, wo_):
        B = q_.shape[0]
        if use_rope:
            positions = torch.full((B, 1), pos, device=q_.device)
            if cfg.mrope:
                positions = positions.expand(3, *positions.shape)
            q_ = apply_rope(q_, positions, cfg.rope_theta, cfg.mrope)
            kn = apply_rope(kn, positions, cfg.rope_theta, cfg.mrope)
        grp = _group(mctx, MODEL_AXIS) if (q_sh or kv_sh) else None
        if q_sh:
            q_ = _all_gather(q_.contiguous(), 2, grp)
        if kv_sh:
            kn = _all_gather(kn.contiguous(), 2, grp)
            vn = _all_gather(vn.contiguous(), 2, grp)
        if s0 <= slot < s0 + S_l:
            kc_[:, slot - s0] = kn[:, 0].to(kc_.dtype)
            vc_[:, slot - s0] = vn[:, 0].to(vc_.dtype)
        idx = s0 + torch.arange(S_l, device=q_.device)
        valid = idx <= pos
        if window > 0 and pos >= S:
            valid = torch.ones_like(valid)      # ring: all valid once wrapped
        ctx = _gqa_chunk(mctx, q_, kc_, vc_, valid, seq, n_chunks)
        return _heads_out(mctx, ctx, wo_, q_sh)
    a = body(mctx, f, [(q, q.placements), (k_new, k_new.placements),
                       (v_new, v_new.placements), (kc, kc.placements),
                       (vc, vc.placements), (wo, wop)], [out_pl])
    return a, cache


def attn_decode_cross(p: dict, h: DTensor, cross: dict, cfg: ModelConfig,
                      mctx) -> DTensor:
    """One decode step's cross-attention against the encoder's K/V, which
    prefill cached (read only): on local heads where the cache's kv heads
    are split or whole, flash-decoding over all heads where its sequence
    is split."""
    q = _proj(mctx, h, p["w_q"], ("embed", "heads", None),
              p.get("b_q"), ("heads", None))
    kc, vc = cross["k"], cross["v"]
    wo = p["w_o"]
    wop = wpl(mctx, ("heads", None, "embed"), _shape(wo))
    q_sh = _on_model(q.placements, mctx.mesh)
    seq, n_chunks, _, S_l = _chunks(mctx, kc)
    Hq, Hkv = q.shape[2], kc.shape[2]
    tp_n, r = mctx.model_size, coord(mctx, MODEL_AXIS)
    Hq_l = Hq // tp_n if q_sh else Hq
    out_pl = act(mctx, ("act_batch", None, None), _shape(h))
    if q_sh:
        out_pl = _model_partial(mctx, out_pl)
    _same_batch(q.placements, kc.placements)
    local = not seq                 # the whole sequence: local heads
    if local:
        Hkv_l = Hkv // tp_n if _on_model(kc.placements, mctx.mesh) else Hkv
        k_lo, k_hi = _kv_span(Hq, Hkv, Hq_l, r * Hq_l if q_sh else 0, Hkv_l,
                              r * Hkv_l if Hkv_l != Hkv else 0)

    def f(q_, kc_, vc_, wo_):
        valid = torch.ones(S_l, dtype=torch.bool, device=q_.device)
        if local:
            ctx = decode_attention(q_, kc_[:, :, k_lo:k_hi].to(q_.dtype),
                                   vc_[:, :, k_lo:k_hi].to(q_.dtype), valid)
            return _heads_out(mctx, ctx, wo_, False)
        if q_sh:
            q_ = _all_gather(q_.contiguous(), 2, _group(mctx, MODEL_AXIS))
        ctx = _gqa_chunk(mctx, q_, kc_, vc_, valid, seq, n_chunks)
        return _heads_out(mctx, ctx, wo_, q_sh)
    return body(mctx, f, [(q, q.placements), (kc, kc.placements),
                          (vc, vc.placements), (wo, wop)], [out_pl])


def mla_decode(p: dict, h: DTensor, pos: int, cache: dict, cfg: ModelConfig,
               mctx):
    """Absorbed-form MLA decode against a sequence-sharded latent cache:
    q and its absorbed nope part for the local heads, then gathered to
    every head; the new latents written into the rank that holds slot
    ``pos``; the latent context of every head over this rank's chunk,
    combined over the axes that split the sequence; the local heads'
    ``w_uv`` and row-parallel ``w_o``. One chunk runs the plain path's
    ``mla_decode`` on the local heads."""
    ckv, kr = cache["ckv"], cache["k_rope"]
    h = place(h, act(mctx, ("act_batch", None, None), _shape(h)))
    ins, heads = _mla_weights(p, cfg, mctx)
    seq, n_chunks, s0, S_l = _chunks(mctx, ckv)
    out_pl = act(mctx, ("act_batch", None, None), _shape(h))
    if heads:
        out_pl = _model_partial(mctx, out_pl)
    _same_batch(h.placements, ckv.placements)
    m = cfg.mla
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5

    def f(x, ckv_, kr_, *ws):
        lp = dict(zip(_MLA_KEYS, ws))
        if n_chunks == 1:
            pos_ = torch.full((1,), pos, dtype=torch.int64, device=x.device)
            out, _ = attention.mla_decode(lp, x, pos_, {"ckv": ckv_,
                                                        "k_rope": kr_}, cfg)
            return out
        B = x.shape[0]
        positions = torch.full((B, 1), pos, device=x.device)
        q_nope, q_rope = attention._mla_q(lp, x, positions, cfg)
        ckv_new, kr_new = attention._mla_latents(lp, x, positions, cfg)
        if s0 <= pos < s0 + S_l:
            ckv_[:, pos - s0] = ckv_new[:, 0].to(ckv_.dtype)
            kr_[:, pos - s0] = kr_new[:, 0].to(kr_.dtype)
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, lp["w_uk"].to(x.dtype))
        if heads:
            grp = _group(mctx, MODEL_AXIS)
            q_abs = _all_gather(q_abs.contiguous(), 2, grp)
            q_rope = _all_gather(q_rope.contiguous(), 2, grp)
        s = (torch.einsum("bshr,bkr->bhsk", q_abs.float(), ckv_.float())
             + torch.einsum("bshr,bkr->bhsk", q_rope.float(), kr_.float()))
        s = s * scale
        valid = s0 + torch.arange(S_l, device=x.device) <= pos
        s = torch.where(valid[None, None, None, :], s, NEG_INF)
        o, l_ = _combine(mctx, s, seq, lambda e: torch.einsum(
            "bhsk,bkr->bshr", e, ckv_.float()))
        ctx = o / l_.permute(0, 2, 1, 3)              # (B,1,H,r)
        if heads:
            H_l = ctx.shape[2] // mctx.model_size
            r = coord(mctx, MODEL_AXIS)
            ctx = ctx[:, :, r * H_l:(r + 1) * H_l]
        out_h = torch.einsum("bshr,rhv->bshv", ctx.to(x.dtype),
                             lp["w_uv"].to(x.dtype))
        return _heads_out(mctx, out_h, lp["w_o"], False)
    a = body(mctx, f, [(h, h.placements), (ckv, ckv.placements),
                       (kr, kr.placements)] + ins, [out_pl])
    return a, cache


def attn_block_dec(p, x: DTensor, pos: int, cache: dict, cfg: ModelConfig,
                   mctx, *, window: int, moe: bool = False) -> DTensor:
    dec = ("act_batch", None, "act_embed")
    cache = mctx.constrain_kv(cache)
    h = rms_norm(mctx, x, p["ln1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, cache = mla_decode(p["attn"], h, pos, cache, cfg, mctx)
    else:
        a, cache = attn_decode(p["attn"], h, pos, cache, cfg, mctx,
                               window=window)
    cache = mctx.constrain_kv(cache)
    x = add(mctx.constrain(x, dec), mctx.constrain(a, dec))
    h2 = rms_norm(mctx, x, p["ln2"], cfg.norm_eps)
    if moe:
        f, _ = moe_ffn(p["moe"], h2, cfg, mctx)
    else:
        f = mlp(mctx, p["mlp"], h2)
    return add(x, mctx.constrain(f, dec))


def cross_block_dec(p, x: DTensor, pos: int, cache: dict, cfg: ModelConfig,
                    mctx) -> DTensor:
    """One token through whisper's decoder block: self-attention against
    the self cache (no rope), cross-attention to the cached encoder K/V,
    the ungated MLP."""
    dec = ("act_batch", None, "act_embed")
    h = rms_norm(mctx, x, p["ln1"], cfg.norm_eps)
    # the self cache stays as its spec places it (``act_seq``): its local
    # tensors are what the step writes
    a, _ = attn_decode(p["attn"], h, pos, cache["self"], cfg, mctx,
                       use_rope=False)
    x = add(mctx.constrain(x, dec), mctx.constrain(a, dec))
    hx = rms_norm(mctx, x, p["ln_x"], cfg.norm_eps)
    x = add(x, mctx.constrain(attn_decode_cross(p["xattn"], hx,
                                                cache["cross"], cfg, mctx),
                              dec))
    f = mlp(mctx, p["mlp"], rms_norm(mctx, x, p["ln2"], cfg.norm_eps),
            gated=False)
    return add(x, mctx.constrain(f, dec))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


def moe_ffn(p: dict, x: DTensor, cfg: ModelConfig, mctx):
    """The reference's mesh ``moe_ffn``: the expert-parallel body where
    ``use_ep`` holds, else the tensor-parallel one. Returns (y in x's
    layout with d whole and batch on the batch axes, aux as a plain
    scalar). Both bodies route by softmax over every expert
    (``moe._capacity_only_softmax``)."""
    moe_lib._capacity_only_softmax(cfg)
    mesh = mctx.mesh
    names = _names(mesh)
    x_pl = act(mctx, ("act_batch", None, None), _shape(x))
    x = place(x, x_pl)
    n_all = mesh.size()
    aux_pl = [Partial()] * mesh.ndim
    whole = [Replicate()] * mesh.ndim          # the router, everywhere
    if moe_lib.use_ep(cfg, mesh):
        eax = ("experts", None, None)
        wps = [wpl(mctx, eax, _shape(p[n])) for n in
               ("w_gate", "w_up", "w_down")]
        group_axes = [a for a in (DATA_AXIS, MODEL_AXIS) if a in names]
        G = 1
        for a in group_axes:
            G *= mesh.size(names.index(a))
        grp = _flat_group(mctx, group_axes)
        tp_n = mctx.model_size
        j = coord(mctx, MODEL_AXIS)

        def f(x_, rw, wg, wu, wd):
            y, aux, dropped = moe_lib._moe_ep_body(
                x_, rw, wg, wu, wd, cfg=cfg, G=G, tp=tp_n, j=j,
                all_to_all=functools.partial(_all_to_all, group=grp),
                gather_tp=lambda t: gather_over(mctx, t, MODEL_AXIS, 0))
            _count_dropped(mctx, dropped)
            return y, aux
        y, aux = body(mctx, f, [(x, x_pl), (p["router"], whole)]
                      + [(p[n], pl) for n, pl in zip(
                          ("w_gate", "w_up", "w_down"), wps)],
                      [x_pl, aux_pl])
    else:
        wp_gu = wpl(mctx, (None, "embed", "mlp"), _shape(p["w_gate"]))
        wp_d = wpl(mctx, (None, "mlp", "embed"), _shape(p["w_down"]))
        out_pl = (_model_partial(mctx, x_pl) if _on_model(wp_gu, mesh)
                  else x_pl)

        def f(x_, rw, wg, wu, wd):
            y, aux, dropped = moe_lib._moe_tp_body(x_, rw, wg, wu, wd,
                                                   cfg=cfg, n_chunks=8)
            _count_dropped(mctx, dropped)
            return y, aux
        y, aux = body(mctx, f, [(x, x_pl), (p["router"], whole),
                                (p["w_gate"], wp_gu), (p["w_up"], wp_gu),
                                (p["w_down"], wp_d)],
                      [out_pl, aux_pl])
        # ff was model-sharded -> partial sums; the TP all-reduce
        y = place(y, x_pl)
    aux = place(aux, whole).to_local() / n_all
    if cfg.moe.num_shared_experts:
        y = add(y, place(mlp(mctx, p["shared"], x), x_pl))
    return y, aux


def _all_to_all(t, group):
    """Equal-split all-to-all; the autograd op only where a gradient is
    being recorded (it has no kernel under inference mode)."""
    if torch.is_grad_enabled():
        return funcol.all_to_all_single_autograd(t, None, None, group)
    return funcol.all_to_all_single(t, None, None, group)


def _count_dropped(mctx, dropped) -> None:
    stats = mctx.stats
    if stats is not None:
        stats["moe_dropped"] = stats.get("moe_dropped", 0) + dropped


def _flat_group(mctx, axes: list[str]):
    """The process group over several mesh axes (data-major). Made outside
    any dispatch mode: flattening a mesh computes on real tensors, which a
    trace under fake tensors (the dry-run) would otherwise take over."""
    mesh = mctx.mesh
    if len(axes) == 1:
        return (mesh, _names(mesh).index(axes[0]))
    with _disable_current_modes():
        if list(axes) == _names(mesh):
            return mesh._flatten("_".join(axes)).get_group()
        return mesh[tuple(axes)]._flatten("_".join(axes)).get_group()

