"""KV cache spec builders.

Caches are spec'd with the same ParamSpec machinery as weights. The port
has the attention caches so far:

  * full attention:   k/v (B, S, Hkv, dh)
  * ring (SWA):       k/v (B, W, Hkv, dh)        bounded by the window

MLA latent, SSM, xLSTM and cross-attention caches come with their slices.
"""

from __future__ import annotations

from repro_torch.config.base import ModelConfig
from repro_torch.models.params import ParamSpec


def _model_dt(cfg, shape, axes):
    return ParamSpec(shape, axes, init="zeros", dtype=cfg.dtype)


def attn_cache_specs(cfg: ModelConfig, B: int, S: int, seq_axis: str,
                     window: int = 0) -> dict:
    Hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    length = min(window, S) if window else S
    ax = ("act_batch", seq_axis, None, None)
    return {"k": _model_dt(cfg, (B, length, Hkv, dh), ax),
            "v": _model_dt(cfg, (B, length, Hkv, dh), ax)}
