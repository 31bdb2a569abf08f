"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, sequential).

mLSTM uses exponential gating with the paper's max-stabilizer m_t, computed
chunkwise: within a chunk the quadratic masked form, across chunks a
recurrent carry (C: (B,H,P,P), n: (B,H,P), m: (B,H)). The stabilizers are
the reference's, term for term. sLSTM is a genuine nonlinear recurrence
(block-diagonal recurrent weights R per head) and runs as a Python loop
over the tokens; its input projections, which do not depend on the
recurrence, are computed for the whole sequence before the loop.

Blocks carry their own projections: xLSTM models have no separate FFN
(d_ff = 0).
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
    C0, n0, m0 = carry0
    idx = torch.arange(Q, device=dev)
    causal = idx[:, None] >= idx[None, :]
    sc = P ** -0.5

    hs = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        q_c, k_c, v_c = q[:, sl], k[:, sl], v[:, sl]
        ir, lf = i_raw[:, sl], logf[:, sl]              # (B,Q,H)
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
        m0 = m_new
        hs.append(h)
    return torch.cat(hs, dim=1), (C0, n0, m0)


def mlstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 128) -> tuple[torch.Tensor, dict]:
    B, S, d = x.shape
    H, P = cfg.num_heads, cfg.resolved_head_dim
    dt = x.dtype
    xc = F.silu(_causal_conv(x, p["conv"])).to(dt)   # as in decode
    q = (xc @ p["w_q"].to(dt)).reshape(B, S, H, P).float()
    k = (xc @ p["w_k"].to(dt)).reshape(B, S, H, P).float()
    v = (x @ p["w_v"].to(dt)).reshape(B, S, H, P).float()
    i_raw, logf = _mlstm_gates(p, xc)
    h, carry = _mlstm_chunk_scan(q, k, v, i_raw, logf, chunk)
    g = F.silu(x @ p["w_g"].to(dt))
    h = h.reshape(B, S, H * P).to(dt) * g
    h = rmsnorm(h, p["norm"], cfg.norm_eps)
    out = h @ p["w_o"].to(dt)
    conv_tail = x[:, -(CONV_K - 1):, :].float()
    return out, {"C": carry[0], "n": carry[1], "m": carry[2],
                 "conv": conv_tail}


def mlstm_decode(p: dict, x: torch.Tensor, cache: dict,
                 cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d). Exact recurrent step. Returns (out, new cache);
    ``cache`` is left as it is."""
    B = x.shape[0]
    H, P = cfg.num_heads, cfg.resolved_head_dim
    dt = x.dtype
    x0 = x[:, 0]
    win = torch.cat([cache["conv"], x0[:, None].float()], 1)
    xc = F.silu(torch.einsum("bkc,kc->bc", win, p["conv"].float())).to(dt)
    q = (xc @ p["w_q"].to(dt)).reshape(B, H, P).float()
    k = (xc @ p["w_k"].to(dt)).reshape(B, H, P).float()
    v = (x0 @ p["w_v"].to(dt)).reshape(B, H, P).float()
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
    g = F.silu(x0 @ p["w_g"].to(dt))
    h = h.reshape(B, H * P).to(dt) * g
    h = rmsnorm(h, p["norm"], cfg.norm_eps)
    out = (h @ p["w_o"].to(dt))[:, None]
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


def _slstm_inputs(p: dict, x32: torch.Tensor, H: int, P: int) -> dict:
    """Each gate's input part W x + b, fp32, for x32 (..., d) ->
    (..., H, P)."""
    return {g: (x32 @ p[f"w_{g}"].float()).unflatten(-1, (H, P))
            + p[f"b_{g}"].float().reshape(H, P) for g in GATES}


def _slstm_step(p: dict, carry: tuple, wx: dict) -> tuple:
    """carry: (h, c, n, m), each (B,H,P). wx: each gate's W x_t + b."""
    h0, c0, n0, m0 = carry

    def gate(g):
        return wx[g] + torch.einsum("bhp,hpq->bhq", h0, p[f"r_{g}"].float())

    z = torch.tanh(gate("z"))
    i_raw = gate("i")
    logf = F.logsigmoid(gate("f"))
    o = torch.sigmoid(gate("o"))
    m1 = torch.maximum(logf + m0, i_raw)
    fp = torch.exp(logf + m0 - m1)
    ip = torch.exp(i_raw - m1)
    c1 = fp * c0 + ip * z
    n1 = fp * n0 + ip
    h1 = o * c1 / torch.clamp(n1, min=1.0)
    return (h1, c1, n1, m1)


def slstm_init_state(B: int, H: int, P: int, device) -> tuple:
    z = torch.zeros((B, H, P), dtype=torch.float32, device=device)
    return (z, z, z, torch.full((B, H, P), NEG, dtype=torch.float32,
                                device=device))


def slstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, dict]:
    B, S, d = x.shape
    H, P = cfg.num_heads, cfg.resolved_head_dim
    dt = x.dtype
    wx = _slstm_inputs(p, x.float(), H, P)              # (B,S,H,P) each
    carry = slstm_init_state(B, H, P, x.device)
    hs = []
    for t in range(S):
        carry = _slstm_step(p, carry, {g: wx[g][:, t] for g in GATES})
        hs.append(carry[0])
    h = torch.stack(hs, dim=1).reshape(B, S, H * P).to(dt)
    h = rmsnorm(h, p["norm"], cfg.norm_eps)
    out = h @ p["w_out"].to(dt)
    return out, {"h": carry[0], "c": carry[1], "n": carry[2], "m": carry[3]}


def slstm_decode(p: dict, x: torch.Tensor, cache: dict,
                 cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d). Returns (out, new cache); ``cache`` is left as it
    is."""
    B = x.shape[0]
    H, P = cfg.num_heads, cfg.resolved_head_dim
    dt = x.dtype
    carry = (cache["h"], cache["c"], cache["n"], cache["m"])
    carry = _slstm_step(p, carry, _slstm_inputs(p, x[:, 0].float(), H, P))
    h = carry[0].reshape(B, H * P).to(dt)
    h = rmsnorm(h, p["norm"], cfg.norm_eps)
    out = (h @ p["w_out"].to(dt))[:, None]
    return out, {"h": carry[0], "c": carry[1], "n": carry[2], "m": carry[3]}
