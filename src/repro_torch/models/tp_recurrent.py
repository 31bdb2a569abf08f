"""The mesh path's recurrent cells: Mamba2 (zamba2's blocks), mLSTM and
sLSTM (xLSTM), as bodies on local shards between the reference's
constraints, in the design of ``models/tp.py``.

Each cell runs the plain path's function (``models/ssm.py``,
``models/xlstm.py``) on this rank's weights, with the hooks those take:

* **Mamba2.** ``w_z``, ``w_x`` and ``conv_x`` are column-parallel over the
  inner width (whole SSD heads), ``w_dt``, ``dt_bias``, ``A_log`` and ``D``
  on the same heads, ``w_B``, ``w_C`` and their convolutions whole, ``w_out``
  row-parallel (a partial sum over ``model``). The state (B, H, P, N) and the
  conv tail of x are per local head.
* **mLSTM and sLSTM, heads split whole.** Where ``model`` divides the heads
  (the gates ``w_i``/``w_f`` and the sLSTM's recurrent ``r_*`` then shard
  too), every rank runs its own heads, as Mamba2 does.
* **mLSTM and sLSTM, a head split across ranks** (xlstm-350m's 4 heads
  over 16 ranks: each rank holds 64 of a head's 256 columns of ``w_q``,
  ``w_k``, ``w_v``, ``w_g`` and of the sLSTM's gate inputs, while ``w_i``,
  ``w_f`` and ``r_*`` stay whole). The memory of a head needs all its
  columns, so each rank computes its columns of the projections and
  *gathers them to whole heads* inside the body (``tp.gather_split``, whose
  backward reduce-scatters); every rank then runs the whole recurrence and
  norm, and projects only its own columns of the output through its rows of
  the row-parallel ``w_o`` / ``w_out`` (a partial sum over ``model``). The
  state is whole on every rank, as the cache rules place it.
* **The norm over the inner width** (``norm``, one rmsnorm over all heads)
  sees only this rank's columns where the heads are split whole: the sum of
  squares is summed over ``model`` (``tp.reduce_over``) before the scale,
  and the weight is sliced to the rank's columns. A per-shard norm would be
  a silent error.

A layout that splits the inner width but not the heads in whole (a Mamba2
whose head count ``model`` does not divide) runs whole heads on every rank.
On a one-rank mesh every body takes the plain function's arithmetic.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.config.base import ModelConfig
from repro_torch.launch.mesh import MODEL_AXIS
from repro_torch.models import kvcache, tp
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib

_SP_IN = ("act_batch", None, None)
_SP_OUT = ("act_batch", "act_seq", "act_embed")
_DEC = ("act_batch", None, "act_embed")


def _whole_model(pl, mctx) -> list:
    """``pl`` replicated over ``model``."""
    names = list(mctx.mesh.mesh_dim_names)
    out = list(pl)
    if MODEL_AXIS in names:
        out[names.index(MODEL_AXIS)] = Replicate()
    return out


def split_rmsnorm(mctx, y, w, eps: float, width: int):
    """rmsnorm over a last dim of ``width`` split across ``model``: ``y``
    holds this rank's columns, ``w`` the whole weight."""
    n = y.shape[-1]
    r = tp.coord(mctx, MODEL_AXIS)
    dtype = y.dtype
    y = y.float()
    ss = tp.reduce_over(mctx, torch.sum(torch.square(y), -1, keepdim=True),
                        MODEL_AXIS)
    y = y * torch.rsqrt(ss / width + eps)
    return (y * w[r * n:(r + 1) * n].float()).to(dtype)


class _Layout:
    """A cell's weights in their compute layout and how the cell splits:
    ``mode`` "heads" (whole heads on each rank), "gather" (a head's columns
    across ranks, gathered in the body) or "whole" (nothing on ``model``)."""

    def __init__(self, p: dict, specs: dict, mctx, inner: str, heads: str,
                 out: str, gathers: bool):
        self.keys = list(p)
        self.pl = {k: tp.wpl(mctx, specs[k].axes, specs[k].shape)
                   for k in self.keys}
        split_inner = tp._on_model(self.pl[inner], mctx.mesh)
        split_heads = tp._on_model(self.pl[heads], mctx.mesh)
        if split_inner and split_heads:
            self.mode = "heads"
        elif split_inner and gathers:
            self.mode = "gather"
        else:
            self.mode = "whole"
            self.pl = {k: _whole_model(v, mctx) for k, v in self.pl.items()}
        self.width = specs[inner].shape[-1]
        self.partial = tp._on_model(self.pl[out], mctx.mesh)
        self.split = mctx.model_size > 1

    def ins(self, p: dict) -> list:
        return [(p[k], self.pl[k]) for k in self.keys]

    def hooks(self, mctx, cfg: ModelConfig, lp: dict) -> dict:
        """The plain cell's hooks for this rank."""
        if not self.split:
            return {}
        if self.mode == "heads":
            return {"norm": lambda y: split_rmsnorm(mctx, y, lp["norm"],
                                                    cfg.norm_eps, self.width)}
        if self.mode == "gather":
            n = self.width // mctx.model_size
            r = tp.coord(mctx, MODEL_AXIS)
            return {"gather": lambda t: tp.gather_split(mctx, t, MODEL_AXIS,
                                                        t.dim() - 1),
                    "own": (r * n, (r + 1) * n)}
        return {}


def _cell(kind: str, p: dict, cfg: ModelConfig, mctx) -> tuple:
    """(the plain forward, decode, layout, cache specs' axes)."""
    if kind == "mamba":
        lay = _Layout(p, ssm_lib.ssm_specs(cfg), mctx, "w_x", "w_dt",
                      "w_out", gathers=False)
        return (ssm_lib.ssm_forward, ssm_lib.ssm_decode, lay,
                kvcache.ssm_cache_specs(cfg, 1))
    if kind == "mlstm":
        lay = _Layout(p, xlstm_lib.mlstm_specs(cfg), mctx, "w_q", "w_i",
                      "w_o", gathers=True)
        return (xlstm_lib.mlstm_forward, xlstm_lib.mlstm_decode, lay,
                kvcache.mlstm_cache_specs(cfg, 1))
    lay = _Layout(p, xlstm_lib.slstm_specs(cfg), mctx, "w_z", "r_z",
                  "w_out", gathers=True)
    return (xlstm_lib.slstm_forward, xlstm_lib.slstm_decode, lay,
            kvcache.slstm_cache_specs(cfg, 1))


def _state_pl(mctx, lay: _Layout, cspecs: dict, shapes: dict) -> dict:
    """Compute-layout placements of a cell's state leaves."""
    out = {}
    for k, s in cspecs.items():
        pl = tp.wpl(mctx, s.axes, shapes[k])
        out[k] = pl if lay.mode == "heads" else _whole_model(pl, mctx)
    return out


def _state_shapes(cspecs: dict, B: int) -> dict:
    return {k: (B,) + tuple(s.shape[1:]) for k, s in cspecs.items()}


def _out_pl(mctx, lay: _Layout, shape) -> list:
    pl = tp.act(mctx, _SP_IN, shape)
    return tp._model_partial(mctx, pl) if lay.partial else pl


def cell_forward(kind: str, p: dict, h: DTensor, cfg: ModelConfig, mctx):
    """A recurrent cell over the whole sequence on this rank's shards.
    Returns (out, partial over ``model`` where its output projection is
    split; the cell's final state, placed as the cache rules place it)."""
    h = tp.place(h, tp.act(mctx, _SP_IN, tuple(h.shape)))
    fwd, _, lay, cspecs = _cell(kind, p, cfg, mctx)
    shapes = _state_shapes(cspecs, h.shape[0])
    spl = _state_pl(mctx, lay, cspecs, shapes)
    keys = list(cspecs)

    def f(x, *ws):
        lp = dict(zip(lay.keys, ws))
        out, state = fwd(lp, x, cfg, **lay.hooks(mctx, cfg, lp))
        return (out, *(state[k] for k in keys))
    outs = tp.body(mctx, f, [(h, h.placements)] + lay.ins(p),
                   [_out_pl(mctx, lay, tuple(h.shape))]
                   + [spl[k] for k in keys])
    state = {k: tp.place(v, tp.act(mctx, cspecs[k].axes, shapes[k]))
             for k, v in zip(keys, outs[1:])}
    return outs[0], state


def cell_decode(kind: str, p: dict, h: DTensor, cache: dict,
                cfg: ModelConfig, mctx) -> DTensor:
    """One token through a recurrent cell; the new state is copied over
    ``cache`` (DTensors) in place."""
    h = tp.place(h, tp.act(mctx, _SP_IN, tuple(h.shape)))
    _, dec, lay, cspecs = _cell(kind, p, cfg, mctx)
    keys = list(cspecs)
    shapes = _state_shapes(cspecs, h.shape[0])
    spl = _state_pl(mctx, lay, cspecs, shapes)
    tp._same_batch(h.placements, cache[keys[0]].placements)

    def f(x, *args):
        st = dict(zip(keys, args[:len(keys)]))
        lp = dict(zip(lay.keys, args[len(keys):]))
        out, new = dec(lp, x, st, cfg, **lay.hooks(mctx, cfg, lp))
        return (out, *(new[k] for k in keys))
    outs = tp.body(mctx, f, [(h, h.placements)]
                   + [(cache[k], spl[k]) for k in keys] + lay.ins(p),
                   [_out_pl(mctx, lay, tuple(h.shape))]
                   + [spl[k] for k in keys])
    for k, new in zip(keys, outs[1:]):
        old = cache[k]
        old.to_local().copy_(tp.place(new, old.placements).to_local())
    return outs[0]


def block_fwd(kind: str, p: dict, x: DTensor, cfg: ModelConfig, mctx):
    """A residual block around a recurrent cell (``p``: ``ln`` and the
    cell, under ``ssm`` or ``cell``), Megatron-SP as the attention blocks:
    the sequence gathered at entry, the output reduce-scattered back.
    Returns (x, the cell's state)."""
    h = tp.rms_norm(mctx, x, p["ln"], cfg.norm_eps)
    h = mctx.constrain(h, _SP_IN)
    out, state = cell_forward(kind, p["ssm" if kind == "mamba" else "cell"],
                              h, cfg, mctx)
    x = tp.add(mctx.constrain(x, _SP_OUT), mctx.constrain(out, _SP_OUT))
    return x, state


def block_dec(kind: str, p: dict, x: DTensor, cache: dict, cfg: ModelConfig,
              mctx) -> DTensor:
    """One token through a recurrent block; ``cache`` is updated in
    place."""
    h = tp.rms_norm(mctx, x, p["ln"], cfg.norm_eps)
    out = cell_decode(kind, p["ssm" if kind == "mamba" else "cell"], h,
                      cache, cfg, mctx)
    return tp.add(mctx.constrain(x, _DEC), mctx.constrain(out, _DEC))
