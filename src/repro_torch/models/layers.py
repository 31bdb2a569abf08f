"""Shared layer primitives: norms, rotary embeddings, MLPs, embeddings."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.config.base import ModelConfig, YaRNConfig, yarn_mscale
from repro_torch.kernels import norm_rope
from repro_torch.kernels.norm_rope.ref import (add_rmsnorm_ref, rmsnorm_ref,
                                               rope_ref)
from repro_torch.models.params import ParamSpec


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), (None,), init="ones")


def _records_grad(*ts: Optional[torch.Tensor]) -> bool:
    """Is a gradient being recorded through any of ``ts``? The norm and
    rope kernels have no backward: training (and remat's recompute) keeps
    the plain chains, serving (under ``torch.inference_mode``) takes the
    kernels."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Computed in fp32, cast back to x's dtype: K9 where no gradient is
    recorded (its plain version on the CPU), else the plain chain."""
    if _records_grad(x, w):
        return rmsnorm_ref(x, w, eps)
    return norm_rope.rmsnorm(x, w, eps)


def add_rmsnorm(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``s = x + a; (s, rmsnorm(s, w, eps))``, as one K9 launch where no
    gradient is recorded."""
    if _records_grad(x, a, w):
        return add_rmsnorm_ref(x, a, w, eps)
    return norm_rope.add_rmsnorm(x, a, w, eps)


# --------------------------------------------------------------------------
# Rotary position embeddings (incl. M-RoPE for qwen2-vl)
# --------------------------------------------------------------------------

MROPE_SECTIONS = (16, 24, 24)   # qwen2-vl split of head_dim/2 across (t, h, w)


_FREQS: dict = {}


def yarn_freqs(extra: np.ndarray, theta: float, yarn: YaRNConfig
               ) -> np.ndarray:
    """YaRN's inverse frequencies from RoPE's own (``extra``, fp32, one
    per pair of the rope's D columns), as DeepSeek-V3 builds them: those
    stretched ``factor`` times (``inter``) and ``extra``, blended by a
    ramp that runs from 0 at the ``low`` to 1 at the ``high`` correction
    dim, the dims where ``beta_fast`` and ``beta_slow`` rotations fit the
    original context: ``extra`` below ``low``, ``inter`` above ``high``."""
    D = 2 * len(extra)

    def correction_dim(rotations: float) -> float:
        return (D * math.log(yarn.original_max_position_embeddings
                             / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(correction_dim(yarn.beta_fast)), 0)
    high = min(math.ceil(correction_dim(yarn.beta_slow)), D - 1)
    inter = extra / np.float32(yarn.factor)
    ramp = np.clip((np.arange(len(extra), dtype=np.float32) - low)
                   / max(high - low, 1e-3), 0, 1).astype(np.float32)
    return inter * ramp + extra * (1 - ramp)


def _rope_freqs(dim_half: int, theta: float, device: torch.device,
                yarn: Optional[YaRNConfig] = None) -> torch.Tensor:
    """The reference's fp32 inverse frequencies (computed in numpy, as it
    computes them), YaRN's (``yarn_freqs``) where ``yarn`` is given,
    copied to ``device`` once: a copy from pageable host memory on every
    call would synchronize the stream twice per layer. A fake tensor (made
    under the dry-run's ``FakeTensorMode``) is not kept: it would leak
    into later real calls."""
    key = (dim_half, theta, device, yarn)
    if key not in _FREQS:
        freqs = 1.0 / (theta ** (np.arange(0, dim_half, dtype=np.float32)
                                 / dim_half))
        if yarn is not None:
            if yarn_mscale(yarn.factor, yarn.mscale) != yarn_mscale(
                    yarn.factor, yarn.mscale_all_dim):
                raise ValueError(
                    f"YaRN with mscale {yarn.mscale} != mscale_all_dim "
                    f"{yarn.mscale_all_dim} scales cos and sin, which the "
                    f"rope here does not")
            freqs = yarn_freqs(freqs, theta, yarn)
        t = torch.from_numpy(np.asarray(freqs, np.float32)).to(device)
        if isinstance(t, FakeTensor):
            return t
        _FREQS[key] = t
    return _FREQS[key]


def mrope_sections(half: int) -> list[int]:
    """``MROPE_SECTIONS`` rescaled to ``half`` frequencies in integer
    arithmetic, the last section taking the remainder (16 -> 2, 3, 3)."""
    total = sum(MROPE_SECTIONS)
    secs = [s * half // total for s in MROPE_SECTIONS]
    secs[-1] = half - sum(secs[:-1])
    return secs


def rope(q: torch.Tensor, k: Optional[torch.Tensor], positions: torch.Tensor,
         theta: float, mrope: bool = False,
         yarn: Optional[YaRNConfig] = None
         ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q (B, S, Hq, Dh) and k (B, S, Hkv, Dh), or None, turned at
    ``positions`` (B, S), or (3, B, S) with ``mrope``: split halves, not
    interleaved pairs; angles and the rotation in fp32, cast back to the
    inputs' dtype. One K10 launch for both where no gradient is recorded
    (its plain version on the CPU), else the plain chain. With M-RoPE each
    section of the frequencies turns with its own axis (t, h, w); the
    sections' frequencies are RoPE's, cut in three, so equal rows give
    RoPE. ``yarn`` takes YaRN's frequencies (``yarn_freqs``)."""
    half = q.shape[-1] // 2
    freqs = _rope_freqs(half, theta, positions.device, yarn)
    sections = mrope_sections(half) if mrope else []
    if _records_grad(q, k):
        out = rope_ref(q, k, positions, freqs, sections)
        return out[0], (out[1] if k is not None else None)
    return norm_rope.rope(q, k, positions, freqs, sections)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope: bool = False) -> torch.Tensor:
    """x (B, S, H, Dh) turned by the plain chain (``rope``'s plain
    version), on any device: the mesh path's rope."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, theta, positions.device)
    return rope_ref(x, None, positions, freqs,
                    mrope_sections(half) if mrope else [])[0]


def sinusoidal_pos_emb(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings, fp32. positions: (S,) ->
    (S, d): sines then cosines of ``d // 2`` log-spaced frequencies, the
    last of them 1e-4 (the divisor is ``half - 1``, as in the reference)."""
    half = d // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32)
                   / max(1, half - 1))
    ang = positions[:, None].float() * torch.from_numpy(
        np.asarray(freqs, np.float32)).to(positions.device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp_specs(d: int, d_ff: int, gated: bool = True) -> dict:
    """Gated (SwiGLU) MLP, or with ``gated=False`` whisper's gelu MLP with
    biases."""
    if gated:
        return {
            "w_gate": ParamSpec((d, d_ff), ("embed", "mlp")),
            "w_up": ParamSpec((d, d_ff), ("embed", "mlp")),
            "w_down": ParamSpec((d_ff, d), ("mlp", "embed")),
        }
    return {
        "w_up": ParamSpec((d, d_ff), ("embed", "mlp")),
        "b_up": ParamSpec((d_ff,), ("mlp",), init="zeros"),
        "w_down": ParamSpec((d_ff, d), ("mlp", "embed")),
        "b_down": ParamSpec((d,), (None,), init="zeros"),
    }


def mlp_apply(p: dict, x: torch.Tensor, gated: bool = True) -> torch.Tensor:
    """The MLP in the activation dtype, as the reference runs it; the
    ungated one takes gelu's tanh approximation, ``jax.nn.gelu``'s
    default."""
    dt = x.dtype
    if gated:
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return h @ p["w_down"].to(dt)
    h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


# --------------------------------------------------------------------------
# Embeddings / unembedding
# --------------------------------------------------------------------------


def embedding_specs(cfg: ModelConfig) -> dict:
    specs = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed"), init="small_normal")}
    if not cfg.tie_embeddings:
        specs["out"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"))
    return specs


def embed_tokens(p: dict, tokens: torch.Tensor, dtype: torch.dtype
                 ) -> torch.Tensor:
    # cast then gather, as the reference does: the backward then sums the
    # rows of repeated tokens in ``dtype`` (a no-op cast when the table is
    # already in ``dtype``, as in serving and training)
    return p["tok"].to(dtype)[tokens]


def unembed(p: dict, x: torch.Tensor, tied: bool) -> torch.Tensor:
    w = p["tok"].T if tied else p["out"]
    return x @ w.to(x.dtype)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def chunked_ce_loss(x: torch.Tensor, emb_params: dict, labels: torch.Tensor,
                    tied: bool, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy over (B, S, d) hidden states, in sequence chunks.

    The unembedding matmul happens per chunk, so the full (B, S, vocab)
    logits tensor is never built at once (the reference scans the chunks);
    logits are fp32, the sum over chunks runs in the reference's order.
    """
    B, S, d = x.shape
    chunk = min(chunk, S)
    n = S // chunk
    rem = S - n * chunk

    def one(x_c, labels_c):
        logits = unembed(emb_params, x_c, tied).float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels_c[..., None].long())[..., 0]
        return torch.sum(lse - picked)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + one(x[:, sl], labels[:, sl])
    if rem:
        total = total + one(x[:, n * chunk:], labels[:, n * chunk:])
    return total / (B * S)
