"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, sequential).

mLSTM uses exponential gating with the paper's max-stabilizer m_t, computed
chunkwise: within a chunk the quadratic masked form, across chunks a
recurrent carry (C: (B,H,P,P), n: (B,H,P), m: (B,H)). The stabilizers are
the reference's, term for term. sLSTM is a genuine nonlinear recurrence
(block-diagonal recurrent weights R per head) and runs as a Python loop
over the tokens; its input projections, which do not depend on the
recurrence, are computed for the whole sequence before the loop. Both
loops are one autograd node each (``scan``), which the roofline walker
counts by trip count.

Blocks carry their own projections: xLSTM models have no separate FFN
(d_ff = 0). The cells take their head count from their weights, and three
hooks for the mesh path (``models/tp_recurrent.py``): ``gather`` joins a
projection's columns across ranks, ``own`` is the slice of the inner width
whose output rows this rank holds, ``norm`` replaces the rmsnorm over the
inner width.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models.kvcache import CONV_K
from repro_torch.models.layers import rmsnorm, rmsnorm_spec
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import _causal_conv
from repro_torch.roofline import hlo_walk

NEG = -1e30


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def mlstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H, P = cfg.num_heads, cfg.resolved_head_dim
    inner = H * P
    return {
        "w_q": ParamSpec((d, inner), ("embed", "heads")),
        "w_k": ParamSpec((d, inner), ("embed", "heads")),
        "w_v": ParamSpec((d, inner), ("embed", "heads")),
        "w_i": ParamSpec((d, H), ("embed", "heads"), init="small_normal"),
        "b_i": ParamSpec((H,), ("heads",), init="zeros"),
        "w_f": ParamSpec((d, H), ("embed", "heads"), init="small_normal"),
        "b_f": ParamSpec((H,), ("heads",), init="ones"),
        "w_g": ParamSpec((d, inner), ("embed", "heads")),
        "conv": ParamSpec((CONV_K, d), (None, None)),
        "norm": rmsnorm_spec(inner),
        "w_o": ParamSpec((inner, d), ("heads", "embed")),
    }


def _mlstm_gates(p: dict, xc: torch.Tensor):
    """Input-gate preactivation and log forget gate, fp32: (..., H)."""
    dt = xc.dtype
    i_raw = (xc @ p["w_i"].to(dt) + p["b_i"].to(dt)).float()
    logf = F.logsigmoid((xc @ p["w_f"].to(dt) + p["b_f"].to(dt)).float())
    return i_raw, logf


def _cols(t: torch.Tensor, gather) -> torch.Tensor:
    return t if gather is None else gather(t)


def _out(p: dict, h: torch.Tensor, w: str, cfg: ModelConfig, own, norm):
    """The normed cell output through its row-parallel projection ``w``."""
    h = rmsnorm(h, p["norm"], cfg.norm_eps) if norm is None else norm(h)
    if own is not None:
        h = h[..., own[0]:own[1]]
    return h @ p[w].to(h.dtype)


class _Scan(torch.autograd.Function):
    """A recurrence ``step(carry, x_t, params) -> (carry, y_t)`` over dim
    1 of ``xs`` as one autograd node: the forward keeps each step's
    carry; the backward runs through the steps in reverse, re-running each
    under autograd from its kept carry (the products autograd takes
    through the loop). Under the roofline walker (a fake-tensor trace) one
    step runs inside ``hlo_walk.trips(n)`` each way: the n steps, which
    issue the same ops on the same shapes, are counted, not issued."""

    @staticmethod
    def forward(ctx, step, nc: int, nx: int, *ts):
        carry, xs, ps = tuple(ts[:nc]), ts[nc:nc + nx], ts[nc + nx:]
        n = xs[0].shape[1]
        run = 1 if hlo_walk.walking() else n
        kept = [c.new_empty((c.shape[0], n, *c.shape[1:])) for c in carry]
        ys = None
        with hlo_walk.trips(n // run):
            for t in range(run):
                for k, c in zip(kept, carry):
                    k[:, t] = c
                carry, y = step(carry, [x[:, t] for x in xs], ps)
                if ys is None:
                    ys = y.new_empty((y.shape[0], n, *y.shape[1:]))
                ys[:, t] = y
        ctx.step, ctx.nc, ctx.nx = step, nc, nx
        ctx.save_for_backward(*xs, *ps, *kept)
        return (ys, *carry)

    @staticmethod
    def backward(ctx, g_ys, *g_last):
        saved, nc, nx = ctx.saved_tensors, ctx.nc, ctx.nx
        xs, ps, kept = saved[:nx], saved[nx:len(saved) - nc], saved[-nc:]
        n = xs[0].shape[1]
        run = 1 if hlo_walk.walking() else n
        g_carry = [torch.zeros_like(k[:, 0]) if g is None else g
                   for g, k in zip(g_last, kept)]
        g_xs = [torch.zeros_like(x) for x in xs]
        g_ps = [torch.zeros_like(x) for x in ps]
        with hlo_walk.trips(n // run):
            for t in reversed(range(n - run, n)):
                ins = [x.detach().requires_grad_() for x in (
                    *(k[:, t] for k in kept), *(x[:, t] for x in xs), *ps)]
                with torch.enable_grad():
                    carry, y = ctx.step(tuple(ins[:nc]), ins[nc:nc + nx],
                                        ins[nc + nx:])
                g_y = torch.zeros_like(y) if g_ys is None else g_ys[:, t]
                grads = torch.autograd.grad((*carry, y), ins, (*g_carry, g_y))
                g_carry = list(grads[:nc])
                for g_x, g in zip(g_xs, grads[nc:nc + nx]):
                    g_x[:, t] = g
                for g_p, g in zip(g_ps, grads[nc + nx:]):
                    g_p += g
        return (None, None, None, *g_carry, *g_xs, *g_ps)


def scan(step, carry: tuple, xs: tuple, params: tuple = ()):
    """``step`` over dim 1 of ``xs`` from ``carry`` (``_Scan``). Returns
    (the steps' outputs stacked on dim 1, the last carry)."""
    ys, *last = _Scan.apply(step, len(carry), len(xs), *carry, *xs,
                            *params)
    return ys, tuple(last)


def _mlstm_chunk_scan(q, k, v, i_raw, logf, chunk: int,
                      carry0: Optional[tuple] = None):
    """q,k,v: (B,S,H,P) fp32; i_raw/logf: (B,S,H).

    Returns (h: (B,S,H,P), carry=(C,n,m))."""
    B, S, H, P = q.shape
    Q = chunk if S % chunk == 0 else S
    nc = S // Q
    dev = q.device
    if carry0 is None:
        carry0 = (torch.zeros((B, H, P, P), dtype=torch.float32, device=dev),
                  torch.zeros((B, H, P), dtype=torch.float32, device=dev),
                  torch.full((B, H), NEG, dtype=torch.float32, device=dev))
    idx = torch.arange(Q, device=dev)
    causal = idx[:, None] >= idx[None, :]
    sc = P ** -0.5

    def chunk_step(carry, xs, _):
        (C0, n0, m0), (q_c, k_c, v_c, ir, lf) = carry, xs   # lf/ir (B,Q,H)
        b = torch.cumsum(lf, dim=1)                     # inclusive cum logf
        # intra weights: log a[i,j] = b_i - b_j + itilde_j   (j<=i)
        la = b[:, :, None, :] - b[:, None, :, :] + ir[:, None, :, :]
        la = torch.where(causal[None, :, :, None], la, NEG)  # (B,i,j,H)
        # inter decayed carry scale: log g_i = b_i + m0
        lg = b + m0[:, None, :]                         # (B,Q,H)
        m = torch.maximum(torch.amax(la, dim=2), lg)    # (B,Q,H)
        m = torch.clamp(m, min=NEG)
        w_intra = torch.exp(la - m[:, :, None, :])      # (B,i,j,H)
        qk = torch.einsum("bihp,bjhp->bijh", q_c, k_c) * sc
        qkw = qk * w_intra                              # step 1 of 2
        num = torch.einsum("bijh,bjhp->bihp", qkw, v_c)  # step 2 of 2
        den = qkw.sum(2)                                # (B,i,H)
        w_inter = torch.exp(lg - m)                     # (B,Q,H)
        qw = q_c * w_inter[..., None]
        num = num + torch.einsum("bihp,bhpd->bihd", qw, C0) * sc
        den = den + torch.einsum("bihp,bhp->bih", qw, n0) * sc
        h = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]
        # end-of-chunk carry
        bQ = b[:, -1]                                   # (B,H)
        m_new = torch.maximum(bQ + m0,
                              torch.amax(bQ[:, None] - b + ir, dim=1))
        scale0 = torch.exp(bQ + m0 - m_new)             # (B,H)
        wj = torch.exp(bQ[:, None] - b + ir - m_new[:, None])  # (B,Q,H)
        C0 = (C0 * scale0[..., None, None]
              + torch.einsum("bjhp,bjhd->bhpd", wj[..., None] * k_c, v_c))
        n0 = (n0 * scale0[..., None]
              + torch.einsum("bjh,bjhp->bhp", wj, k_c))
        return (C0, n0, m_new), h
    hs, carry = scan(chunk_step, tuple(carry0), tuple(
        t.unflatten(1, (nc, Q)) for t in (q, k, v, i_raw, logf)))
    return hs.reshape(B, S, H, P), carry


def mlstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 128, gather=None, own=None, norm=None
                  ) -> tuple[torch.Tensor, dict]:
    B, S, d = x.shape
    H, P = p["w_i"].shape[-1], cfg.resolved_head_dim
    dt = x.dtype
    xc = F.silu(_causal_conv(x, p["conv"])).to(dt)   # as in decode
    q = _cols(xc @ p["w_q"].to(dt), gather).reshape(B, S, H, P).float()
    k = _cols(xc @ p["w_k"].to(dt), gather).reshape(B, S, H, P).float()
    v = _cols(x @ p["w_v"].to(dt), gather).reshape(B, S, H, P).float()
    i_raw, logf = _mlstm_gates(p, xc)
    h, carry = _mlstm_chunk_scan(q, k, v, i_raw, logf, chunk)
    g = F.silu(_cols(x @ p["w_g"].to(dt), gather))
    h = h.reshape(B, S, H * P).to(dt) * g
    out = _out(p, h, "w_o", cfg, own, norm)
    conv_tail = x[:, -(CONV_K - 1):, :].float()
    return out, {"C": carry[0], "n": carry[1], "m": carry[2],
                 "conv": conv_tail}


def mlstm_decode(p: dict, x: torch.Tensor, cache: dict,
                 cfg: ModelConfig, gather=None, own=None, norm=None
                 ) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d). Exact recurrent step. Returns (out, new cache);
    ``cache`` is left as it is."""
    B = x.shape[0]
    H, P = p["w_i"].shape[-1], cfg.resolved_head_dim
    dt = x.dtype
    x0 = x[:, 0]
    win = torch.cat([cache["conv"], x0[:, None].float()], 1)
    xc = F.silu(torch.einsum("bkc,kc->bc", win, p["conv"].float())).to(dt)
    q = _cols(xc @ p["w_q"].to(dt), gather).reshape(B, H, P).float()
    k = _cols(xc @ p["w_k"].to(dt), gather).reshape(B, H, P).float()
    v = _cols(x0 @ p["w_v"].to(dt), gather).reshape(B, H, P).float()
    i_raw, logf = _mlstm_gates(p, xc)
    C0, n0, m0 = cache["C"], cache["n"], cache["m"]
    m1 = torch.maximum(logf + m0, i_raw)
    fp = torch.exp(logf + m0 - m1)
    ip = torch.exp(i_raw - m1)
    C1 = (C0 * fp[..., None, None]
          + ip[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n1 = n0 * fp[..., None] + ip[..., None] * k
    sc = P ** -0.5
    num = torch.einsum("bhp,bhpd->bhd", q, C1) * sc
    den = torch.einsum("bhp,bhp->bh", q, n1) * sc
    h = num / torch.maximum(den.abs(), torch.exp(-m1))[..., None]
    g = F.silu(_cols(x0 @ p["w_g"].to(dt), gather))
    h = h.reshape(B, H * P).to(dt) * g
    out = _out(p, h, "w_o", cfg, own, norm)[:, None]
    return out, {"C": C1, "n": n1, "m": m1, "conv": win[:, 1:]}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


def slstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H, P = cfg.num_heads, cfg.resolved_head_dim
    inner = H * P

    def wspec():
        return ParamSpec((d, inner), ("embed", "heads"))

    def rspec():
        return ParamSpec((H, P, P), ("heads", None, None),
                         init="small_normal")

    def bspec(init="zeros"):
        return ParamSpec((inner,), ("heads",), init=init)
    return {
        "w_z": wspec(), "r_z": rspec(), "b_z": bspec(),
        "w_i": wspec(), "r_i": rspec(), "b_i": bspec(),
        "w_f": wspec(), "r_f": rspec(), "b_f": bspec("ones"),
        "w_o": wspec(), "r_o": rspec(), "b_o": bspec(),
        "norm": rmsnorm_spec(inner),
        "w_out": ParamSpec((inner, d), ("heads", "embed")),
    }


def _slstm_inputs(p: dict, x32: torch.Tensor, P: int, gather=None) -> dict:
    """Each gate's input part W x + b, fp32, for x32 (..., d) ->
    (..., H, P)."""
    return {g: _cols(x32 @ p[f"w_{g}"].float() + p[f"b_{g}"].float(),
                     gather).unflatten(-1, (-1, P)) for g in GATES}


def _slstm_cell(r: list, carry: tuple, wx: list) -> tuple:
    """One sLSTM step. carry: (h, c, n, m), each (B,H,P); r: the z, i, f,
    o gates' recurrent matrices (H,P,P) in fp32; wx: their W x_t + b."""
    h0, c0, n0, m0 = carry
    z_, i_raw, f_, o_ = (w + torch.einsum("bhp,hpq->bhq", h0, rg)
                         for w, rg in zip(wx, r))
    z = torch.tanh(z_)
    logf = F.logsigmoid(f_)
    o = torch.sigmoid(o_)
    m1 = torch.maximum(logf + m0, i_raw)
    fp = torch.exp(logf + m0 - m1)
    ip = torch.exp(i_raw - m1)
    c1 = fp * c0 + ip * z
    n1 = fp * n0 + ip
    h1 = o * c1 / torch.clamp(n1, min=1.0)
    return (h1, c1, n1, m1)


def _slstm_r(p: dict) -> list:
    return [p[f"r_{g}"].float() for g in GATES]


def _slstm_step(carry, wx_t, r):
    carry = _slstm_cell(r, carry, wx_t)
    return carry, carry[0]


def slstm_init_state(B: int, H: int, P: int, device) -> tuple:
    z = torch.zeros((B, H, P), dtype=torch.float32, device=device)
    return (z, z, z, torch.full((B, H, P), NEG, dtype=torch.float32,
                                device=device))


def slstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, gather=None,
                  own=None, norm=None) -> tuple[torch.Tensor, dict]:
    B, S, d = x.shape
    H, P = p["r_z"].shape[0], cfg.resolved_head_dim
    dt = x.dtype
    wx = _slstm_inputs(p, x.float(), P, gather)         # (B,S,H,P) each
    hs, carry = scan(_slstm_step, slstm_init_state(B, H, P, x.device),
                     tuple(wx[g] for g in GATES), tuple(_slstm_r(p)))
    h = hs.reshape(B, S, H * P).to(dt)
    out = _out(p, h, "w_out", cfg, own, norm)
    return out, {"h": carry[0], "c": carry[1], "n": carry[2], "m": carry[3]}


def slstm_decode(p: dict, x: torch.Tensor, cache: dict,
                 cfg: ModelConfig, gather=None, own=None, norm=None
                 ) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d). Returns (out, new cache); ``cache`` is left as it
    is."""
    B = x.shape[0]
    H, P = p["r_z"].shape[0], cfg.resolved_head_dim
    dt = x.dtype
    carry = (cache["h"], cache["c"], cache["n"], cache["m"])
    wx = _slstm_inputs(p, x[:, 0].float(), P, gather)
    carry = _slstm_cell(_slstm_r(p), carry, [wx[g] for g in GATES])
    h = carry[0].reshape(B, H * P).to(dt)
    out = _out(p, h, "w_out", cfg, own, norm)[:, None]
    return out, {"h": carry[0], "c": carry[1], "n": carry[2], "m": carry[3]}
