"""Mixture-of-Experts FFN: top-k routing with sort-based dispatch (no
(T, E, C) one-hot is ever built), in two forms.

* **Dropless** (``_dropless``), the serving path: ``Model.prefill`` and
  ``Model.decode`` set ``MCtx.dropless``, and every (token, slot) pair
  reaches its expert, as Mixtral and DeepSeek are served. The T * k pairs
  are sorted by expert (stably) and their rows gathered into one (T * k,
  d) buffer in expert order; the three projections run as grouped GEMMs
  over it (``torch._grouped_mm`` on CUDA, a loop over the experts on the
  CPU), each expert on its own rows between offsets that stay on the
  device. No capacity and no padded slot: its memory is T * k rows however
  skewed the routing, its shapes are static and it never reads back to the
  host, so a decode step that holds it can be captured as a CUDA graph.
* **Capacity** (``_routed``), the training step's and the mesh bodies':
  each expert has ``C = ceil(capacity_factor * T * k / E)`` slots, filled
  in token order, and the pairs that overflow are dropped, GShard-style,
  as the reference drops them.

The capacity form has two bodies, as in the reference, picked by
``use_ep`` on a mesh (``models/tp.moe_ffn``):

* **EP** (``_moe_ep_body``): experts sharded over ``(data, model)``; each
  rank routes its share of the tokens and sends each expert's slots to the
  rank that holds it by an ``all_to_all`` (equal splits: every expert has
  ``C`` slots). Used when ``num_experts % (data * model) == 0``.
* **TP** (``_moe_tp_body``): every rank holds all experts with the hidden
  dim sharded over ``model``; dispatch is local, in 8 chunks with a
  capacity per chunk, and the partial outputs are summed over ``model``.

Without a mesh and outside serving, ``moe_ffn`` is the EP body's
arithmetic over a group of one, which the reference's one-device mesh
runs: route all B * S tokens, fill each expert's ``C`` slots in token
order, run the experts, add the gated outputs back. Which tokens drop is
the reference's: a stable argsort of the flattened expert ids, ties kept in
(token, slot) order.

Both forms combine alike: each token's ``k`` gated outputs are added one
after another in ascending expert order, the order in which the
reference's scatter-add (``.at[st].add`` over the sorted pairs) meets them,
rounding after each add. It is a gather and ``k`` additions, not a
scatter-add: on CUDA ``index_add_`` adds through atomics in whatever order
they land, so two runs on the same inputs (and a mesh body beside the
plain path) differed in the last bits of a bf16 sum, which can flip a
greedy token.
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


# calls of each mesh body since the last reset (the dry-run records which
# body a cell reached)
BODY_CALLS = {"ep": 0, "tp": 0}

# the key of the dropless layers' counters in ``MCtx.stats``: an int64 (3,)
# tensor on the device, kept in place (so a captured decode step updates
# it on every replay): (token, slot) pairs routed, pairs dropped (0 unless
# an expert id falls outside every expert's rows), and the most pairs one
# expert took in one layer, the largest over the layers
COUNTS = "moe_counts"


def _axis_size(mesh, name: str) -> int:
    """A mesh axis's size (1 without a mesh or without the axis); ``mesh``
    as ``models.sharding.mesh_sizes`` takes it."""
    from repro_torch.models.sharding import mesh_sizes
    return 1 if mesh is None else mesh_sizes(mesh).get(name, 1)


def use_ep(cfg: ModelConfig, mesh) -> bool:
    e = cfg.moe
    group = _axis_size(mesh, "data") * _axis_size(mesh, "model")
    return e.num_experts % group == 0 and e.num_experts >= group


def moe_specs(cfg: ModelConfig, ep: bool = True) -> dict:
    e = cfg.moe
    d = cfg.d_model
    ff = e.d_ff_expert or cfg.d_ff
    waxes = (("experts", None, None) if ep else (None, "embed", "mlp"))
    daxes = (("experts", None, None) if ep else (None, "mlp", "embed"))
    specs = {
        "router": ParamSpec((d, e.num_experts), (None, None),
                            init="small_normal"),
        "w_gate": ParamSpec((e.num_experts, d, ff), waxes),
        "w_up": ParamSpec((e.num_experts, d, ff), waxes),
        "w_down": ParamSpec((e.num_experts, ff, d), daxes),
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


def _routed(x_tok: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig,
            C: int, experts):
    """Route ``x_tok`` (T, d), fill each expert's ``C`` slots, run
    ``experts`` on the contiguous (E, C, d) buffer, combine. Returns (y (T,
    d), aux, the (token, slot) pairs dropped)."""
    e = cfg.moe
    E, k = e.num_experts, e.top_k
    T, d = x_tok.shape
    gates, eids, probs = _route(x_tok, router_w, k)
    aux = _aux_loss(probs, eids, E)
    se, st, pos, keep, order = _dispatch_indices(eids, E, C)
    # each pair's row of the flat buffer: dropped pairs land in row E * C,
    # one past the experts' rows, which no expert reads and which reads
    # back as zeros (no boolean indexing, so no sync with the host)
    rows = torch.where(keep, se * C + pos, E * C)
    buf = torch.zeros((E * C + 1, d), dtype=x_tok.dtype, device=x_tok.device)
    buf[rows] = x_tok[st]
    out = experts(buf[:E * C].view(E, C, d)).reshape(E * C, d)
    out = F.pad(out, (0, 0, 0, 1))
    # back to (token, slot) order
    pair_rows = torch.empty_like(rows)
    pair_rows[order] = rows
    return _combine(out, pair_rows, gates, eids), aux, (~keep).sum()


def _combine(out: torch.Tensor, pair_rows: torch.Tensor,
             gates: torch.Tensor, eids: torch.Tensor) -> torch.Tensor:
    """(T, d): each token's ``k`` rows of ``out`` (``pair_rows``: the row
    of each (token, slot) pair, in (token, slot) order) times their gates,
    added one after another in ascending expert order."""
    T, k = eids.shape
    by_e = torch.argsort(eids, dim=1)
    rows = pair_rows.view(T, k).gather(1, by_e)
    w = gates.gather(1, by_e).to(out.dtype)
    y = out[rows[:, 0]] * w[:, :1]
    for s in range(1, k):
        y = y + out[rows[:, s]] * w[:, s:s + 1]
    return y


def _grouped_mm(a: torch.Tensor, w: torch.Tensor,
                ends: torch.Tensor) -> torch.Tensor:
    """a (N, n_in), its rows in expert order, times w (E, n_in, n_out):
    expert ``e`` multiplies rows ``ends[e - 1]:ends[e]`` (int32 offsets,
    ``ends[-1] == N``). On CUDA one grouped GEMM that reads the offsets on
    the device (``torch._grouped_mm``, which raises where it cannot run);
    on the CPU a loop over the experts."""
    w = w.to(a.dtype)
    if a.is_cuda:
        return torch._grouped_mm(a, w, offs=ends)
    out = a.new_empty((a.shape[0], w.shape[-1]))
    start = 0
    for e, end in enumerate(ends.tolist()):
        out[start:end] = a[start:end] @ w[e]
        start = end
    return out


def _count(stats: dict, ends: torch.Tensor, pairs: int) -> None:
    """Adds one layer's pairs to ``stats[COUNTS]`` in place (made on first
    use): routed, dropped, and the busiest expert's pairs (a maximum)."""
    buf = stats.get(COUNTS)
    if buf is None:
        buf = stats[COUNTS] = torch.zeros(3, dtype=torch.int64,
                                          device=ends.device)
    ends = ends.long()
    routed = ends[-1:]
    busiest = (ends - F.pad(ends[:-1], (1, 0))).max().view(1)
    buf[:2] += torch.cat([routed, pairs - routed])
    buf[2:] = torch.maximum(buf[2:], busiest)


def read_counts(stats: dict) -> dict | None:
    """``stats[COUNTS]`` read back to the host (a device sync) as
    {routed_pairs, dropped_pairs, busiest_pairs}; None before any count."""
    buf = stats.get(COUNTS)
    if buf is None:
        return None
    routed, dropped, busiest = buf.tolist()
    return {"routed_pairs": routed, "dropped_pairs": dropped,
            "busiest_pairs": busiest}


def zero_counts(stats: dict) -> None:
    """Starts ``stats[COUNTS]`` again from zero, in place."""
    buf = stats.get(COUNTS)
    if buf is not None:
        buf.zero_()


def _dropless(x_tok: torch.Tensor, p: dict, cfg: ModelConfig,
              stats: dict | None = None) -> torch.Tensor:
    """The serving layer on ``x_tok`` (T, d): route, run every (token,
    slot) pair through its expert, combine. The pairs are sorted by expert
    (stably, so an expert's rows keep token order) and their rows gathered
    into one (T * k, d) buffer; each expert's rows end at ``ends[e]``, a
    device tensor. Returns (T, d); counts into ``stats`` when given."""
    e = cfg.moe
    E, k = e.num_experts, e.top_k
    T = x_tok.shape[0]
    gates, eids, _ = _route(x_tok, p["router"], k)
    flat_e = eids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    ends = torch.searchsorted(
        flat_e[order], torch.arange(1, E + 1, device=x_tok.device),
        out_int32=True)
    rows = x_tok[order // k]
    h = F.silu(_grouped_mm(rows, p["w_gate"], ends), inplace=True)
    h.mul_(_grouped_mm(rows, p["w_up"], ends))
    out = _grouped_mm(h, p["w_down"], ends)
    del h
    pair_rows = torch.empty_like(order)
    pair_rows[order] = torch.arange(T * k, device=x_tok.device)
    if stats is not None:
        _count(stats, ends, T * k)
    return _combine(out, pair_rows, gates, eids)


def _moe_ep_body(x, router_w, w_gate, w_up, w_down, *, cfg: ModelConfig,
                 G: int, tp: int, j: int, all_to_all, gather_tp):
    """The expert-parallel body on one rank's shards: x (B, S, d) this
    rank's batch, the experts its ``E / G`` of them. The rank takes the
    ``j``-th of ``tp`` slices of its tokens, routes them, sends each
    expert's slots to its rank (``all_to_all`` of a (G * E_loc * C, d)
    tensor in equal splits), runs its experts on what arrives, sends the
    outputs back and combines; ``gather_tp`` joins the ``tp`` slices.
    Returns (y, aux, dropped)."""
    BODY_CALLS["ep"] += 1
    e = cfg.moe
    E = e.num_experts
    B, S, d = x.shape
    E_loc = E // G
    T_loc = B * S
    x_tok = x.reshape(T_loc, d)
    # split tokens over the model axis so routing/dispatch is TP-sharded
    T_pad = -(-T_loc // tp) * tp
    if T_pad != T_loc:
        x_tok = F.pad(x_tok, (0, 0, 0, T_pad - T_loc))
    T_chip = T_pad // tp
    x_my = x_tok[j * T_chip:(j + 1) * T_chip]
    C = _capacity(T_chip, e.top_k, E, e.capacity_factor)

    def experts(buf):
        send = buf.reshape(G * E_loc * C, d)
        recv = all_to_all(send).reshape(G, E_loc, C, d)
        toks = recv.transpose(0, 1).reshape(E_loc, G * C, d)
        out = _expert_ffn(toks, w_gate, w_up, w_down)
        back = out.reshape(E_loc, G, C, d).transpose(0, 1)
        return all_to_all(back.reshape(G * E_loc * C, d)).reshape(E, C, d)
    y_my, aux, dropped = _routed(x_my, router_w, cfg, C, experts)
    y = gather_tp(y_my)                                   # (T_pad, d)
    return y[:T_loc].reshape(B, S, d), aux, dropped


def _moe_tp_body(x, router_w, w_gate, w_up, w_down, *, cfg: ModelConfig,
                 n_chunks: int):
    """The tensor-parallel body on one rank's shards: every expert, this
    rank's slice of their hidden dim. Tokens are dispatched in
    ``n_chunks`` chunks (one if they do not divide), each with its own
    capacity; the output is this rank's partial sum over the hidden dim.
    Returns (y, aux averaged over the chunks, dropped)."""
    BODY_CALLS["tp"] += 1
    e = cfg.moe
    E = e.num_experts
    B, S, d = x.shape
    T_loc = B * S
    x_tok = x.reshape(T_loc, d)
    nc = n_chunks if T_loc % n_chunks == 0 else 1
    Tc = T_loc // nc
    C = _capacity(Tc, e.top_k, E, e.capacity_factor)

    def experts(buf):
        return _expert_ffn(buf, w_gate, w_up, w_down)
    ys, auxs, dropped = [], [], 0
    for c in range(nc):
        y, aux, dr = _routed(x_tok[c * Tc:(c + 1) * Tc], router_w, cfg, C,
                             experts)
        ys.append(y)
        auxs.append(aux)
        dropped = dropped + dr
    return (torch.cat(ys).reshape(B, S, d), torch.stack(auxs).mean(),
            dropped)


# --------------------------------------------------------------------------
# Public entry
# --------------------------------------------------------------------------


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, mctx=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d), plain tensors (the mesh's blocks call
    ``models/tp.moe_ffn``). Returns (y, aux). Where ``mctx.dropless`` is
    set (the serving roles), the dropless layer runs and aux is 0 (serving
    computes no loss); where ``mctx.stats`` is a dict, it counts into
    ``stats[COUNTS]``. Otherwise the capacity body runs, and the number of
    (token, slot) pairs it drops for want of capacity is added to
    ``stats["moe_dropped"]`` (a device tensor, so the call does not
    sync)."""
    e = cfg.moe
    B, S, d = x.shape
    T = B * S
    stats = getattr(mctx, "stats", None)
    if getattr(mctx, "dropless", False):
        y = _dropless(x.reshape(T, d), p, cfg, stats).reshape(B, S, d)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        C = _capacity(T, e.top_k, e.num_experts, e.capacity_factor)
        y, aux, dropped = _routed(
            x.reshape(T, d), p["router"], cfg, C,
            lambda buf: _expert_ffn(buf, p["w_gate"], p["w_up"],
                                    p["w_down"]))
        y = y.reshape(B, S, d)
        if stats is not None:
            stats["moe_dropped"] = stats.get("moe_dropped", 0) + dropped

    if e.num_shared_experts:
        sp = p["shared"]
        dt = x.dtype
        h = F.silu(x @ sp["w_gate"].to(dt)) * (x @ sp["w_up"].to(dt))
        y = y + h @ sp["w_down"].to(dt)
    return y, aux
