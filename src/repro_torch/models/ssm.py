"""Mamba2 (SSD) block — chunked scan formulation [arXiv:2405.21060].

Within a chunk the state-space recurrence is computed in its quadratic
(attention-like) form; across chunks a small recurrent carry
(B, heads, head_dim, state) propagates, so decode holds O(1) state instead
of a KV cache. The port loops over the chunks where the reference scans.

Head layout: inner = expand * d_model = ssm_heads * ssm_head_dim,
head-major; B/C are shared across heads (ngroups = 1). Every SSD product
is fp32, as in the reference; the three-operand contractions are done in
two explicit steps, so no (B, Q, Q, H, P) tensor is ever built (at
zamba2-7b's chunk of 512 with 112 heads of 64 that would be 30 GB).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models.kvcache import CONV_K
from repro_torch.models.layers import rmsnorm, rmsnorm_spec
from repro_torch.models.params import ParamSpec


def ssm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    if H * P != inner:
        raise ValueError(f"ssm_heads {H} x ssm_head_dim {P} != inner "
                         f"{inner}")
    return {
        "w_z": ParamSpec((d, inner), ("embed", "mlp")),
        "w_x": ParamSpec((d, inner), ("embed", "mlp")),
        "w_B": ParamSpec((d, N), ("embed", None)),
        "w_C": ParamSpec((d, N), ("embed", None)),
        "w_dt": ParamSpec((d, H), ("embed", "heads")),
        "dt_bias": ParamSpec((H,), ("heads",), init="zeros"),
        "A_log": ParamSpec((H,), ("heads",), init="zeros"),
        "D": ParamSpec((H,), ("heads",), init="ones"),
        "conv_x": ParamSpec((CONV_K, inner), (None, "mlp")),
        "conv_B": ParamSpec((CONV_K, N), (None, None)),
        "conv_C": ParamSpec((CONV_K, N), (None, None)),
        "norm": rmsnorm_spec(inner),
        "w_out": ParamSpec((inner, d), ("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, summed in fp32 (the decode step's conv is
    fp32; the reference sums in x's dtype, which in bf16 rounds each of the
    K partial sums). x: (B, S, C); w: (K, C). Returns fp32."""
    K = w.shape[0]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + x.shape[1]] * w[i].float()
    return out


def _ssd_chunked(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 log_a: torch.Tensor, dt: torch.Tensor, chunk: int,
                 carry0: Optional[torch.Tensor] = None):
    """SSD scan. xh: (B,S,H,P); Bm/Cm: (B,S,N); log_a/dt: (B,S,H) fp32.

    Returns (y: (B,S,H,P) fp32, final_state: (B,H,P,N) fp32).
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = chunk if S % chunk == 0 else S
    nc = S // Q
    dev = xh.device
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
             if carry0 is None else carry0)
    idx = torch.arange(Q, device=dev)
    causal = idx[:, None] >= idx[None, :]                # (Q, Q) j<=i

    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        x_q = xh[:, sl].float()
        B_q, C_q = Bm[:, sl].float(), Cm[:, sl].float()
        la_q, dt_q = log_a[:, sl], dt[:, sl]
        cum = torch.cumsum(la_q, dim=1)                  # (B,Q,H) inclusive
        # intra-chunk: scores[b,i,j,h] = (C_i.B_j) exp(cum_i - cum_j) dt_j
        cb = torch.einsum("bin,bjn->bij", C_q, B_q)      # (B,Q,Q)
        decay = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Q,Q,H) i,j
        decay = torch.where(causal[None, :, :, None], decay, -torch.inf)
        w = torch.exp(decay) * dt_q[:, None, :, :]       # (B,Q,Q,H)
        w = w * cb[..., None]                            # step 1 of 2
        y = torch.einsum("bijh,bjhp->bihp", w, x_q)      # step 2 of 2
        # inter-chunk: y += exp(cum_i) * (C_i . state)
        y = y + (torch.einsum("bin,bhpn->bihp", C_q, state)
                 * torch.exp(cum)[..., None])
        # state' = exp(cum_Q) state + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
        tail = torch.exp(cum[:, -1:, :] - cum) * dt_q    # (B,Q,H)
        inc = torch.einsum("bjhp,bjn->bhpn", tail[..., None] * x_q, B_q)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + inc
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _norm(p: dict, y: torch.Tensor, cfg: ModelConfig, norm) -> torch.Tensor:
    return rmsnorm(y, p["norm"], cfg.norm_eps) if norm is None else norm(y)


def ssm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 512, norm=None) -> tuple[torch.Tensor, dict]:
    """Train/prefill Mamba2 block. x: (B, S, d). Returns (out, cache). The
    heads are those of ``w_dt`` (a mesh rank's own); ``norm`` replaces the
    rmsnorm over the inner width (the mesh path's, over a split width)."""
    Bsz, S, d = x.shape
    H, P = p["w_dt"].shape[-1], cfg.ssm_head_dim
    dt_ = x.dtype
    z = x @ p["w_z"].to(dt_)
    xs_raw = x @ p["w_x"].to(dt_)
    B_raw = x @ p["w_B"].to(dt_)
    C_raw = x @ p["w_C"].to(dt_)
    dt_raw = x @ p["w_dt"].to(dt_)
    # the activation in fp32 and one rounding to x's dtype, as in decode
    xs = F.silu(_causal_conv(xs_raw, p["conv_x"])).to(dt_)
    Bm = F.silu(_causal_conv(B_raw, p["conv_B"])).to(dt_)
    Cm = F.silu(_causal_conv(C_raw, p["conv_C"])).to(dt_)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())    # (B,S,H)
    A = -torch.exp(p["A_log"].float())                        # (H,)
    log_a = A * dt                                            # (B,S,H)
    xh = xs.reshape(Bsz, S, H, P)
    y, state = _ssd_chunked(xh, Bm, Cm, log_a, dt, chunk)
    y = y.to(dt_) + xh * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(Bsz, S, H * P)
    y = y * F.silu(z)
    out = _norm(p, y, cfg, norm) @ p["w_out"].to(dt_)

    # conv cache: the last K-1 pre-activation channel inputs (the
    # reference computes the same products again for them)
    def tail(a):
        return a[:, -(CONV_K - 1):, :].float()
    cache = {"state": state, "conv_x": tail(xs_raw),
             "conv_B": tail(B_raw), "conv_C": tail(C_raw)}
    return out, cache


def ssm_decode(p: dict, x: torch.Tensor, cache: dict,
               cfg: ModelConfig, norm=None) -> tuple[torch.Tensor, dict]:
    """One-step SSD recurrence. x: (B, 1, d). Returns (out, new cache);
    ``cache`` is left as it is. Heads and ``norm`` as in ``ssm_forward``."""
    Bsz = x.shape[0]
    H, P = p["w_dt"].shape[-1], cfg.ssm_head_dim
    dt_ = x.dtype
    x0 = x[:, 0]
    z = x0 @ p["w_z"].to(dt_)
    xs_new = x0 @ p["w_x"].to(dt_)
    B_new = x0 @ p["w_B"].to(dt_)
    C_new = x0 @ p["w_C"].to(dt_)
    dt_raw = x0 @ p["w_dt"].to(dt_)

    def conv_step(hist, new, w):
        # hist: (B, K-1, C) fp32; new: (B, C)
        win = torch.cat([hist, new[:, None].float()], 1)
        out = torch.einsum("bkc,kc->bc", win, w.float())
        return F.silu(out).to(dt_), win[:, 1:]

    xs, conv_x = conv_step(cache["conv_x"], xs_new, p["conv_x"])
    Bm, conv_B = conv_step(cache["conv_B"], B_new, p["conv_B"])
    Cm, conv_C = conv_step(cache["conv_C"], C_new, p["conv_C"])
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())    # (B,H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(A * dt)                                     # (B,H)
    xh = xs.reshape(Bsz, H, P).float()
    state = (cache["state"] * a[..., None, None]
             + (dt[..., None] * xh)[..., None] * Bm.float()[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    y = y.to(dt_) + xh.to(dt_) * p["D"].to(dt_)[None, :, None]
    y = y.reshape(Bsz, H * P) * F.silu(z)
    out = (_norm(p, y, cfg, norm) @ p["w_out"].to(dt_))[:, None, :]
    return out, {"state": state, "conv_x": conv_x,
                 "conv_B": conv_B, "conv_C": conv_C}
