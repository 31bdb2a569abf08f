"""KV/state cache spec builders.

Caches are spec'd with the same ParamSpec machinery as weights. Cache kinds:

  * full attention:   k/v (B, S, Hkv, dh)
  * ring (SWA):       k/v (B, W, Hkv, dh)        bounded by the window
  * MLA latent:       ckv (B, S, r), k_rope (B, S, rope)
  * SSD state:        state (B, H, P, N) + conv tails
  * mLSTM state:      C (B, H, P, P), n, m + conv tail
  * sLSTM state:      h/c/n/m (B, H, P)
  * cross attention:  k/v (B, S_enc, Hkv, dh)    the encoder's, read only

``seg_cache_specs`` gives one segment's stacked cache tree (the decode
cache, and the empty cache of a segment of no layers).
"""

from __future__ import annotations

from repro_torch.config.base import ModelConfig
from repro_torch.models.params import ParamSpec, stack_specs

CONV_K = 4        # the causal convolutions' width (Mamba2 and mLSTM)


def _f32(shape, axes):
    return ParamSpec(shape, axes, init="zeros", dtype="float32")


def _model_dt(cfg, shape, axes):
    return ParamSpec(shape, axes, init="zeros", dtype=cfg.dtype)


def attn_cache_specs(cfg: ModelConfig, B: int, S: int, seq_axis: str,
                     window: int = 0) -> dict:
    Hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    length = min(window, S) if window else S
    ax = ("act_batch", seq_axis, None, None)
    return {"k": _model_dt(cfg, (B, length, Hkv, dh), ax),
            "v": _model_dt(cfg, (B, length, Hkv, dh), ax)}


def mla_cache_specs(cfg: ModelConfig, B: int, S: int, seq_axis: str) -> dict:
    m = cfg.mla
    return {
        "ckv": _model_dt(cfg, (B, S, m.kv_lora_rank),
                         ("act_batch", seq_axis, None)),
        "k_rope": _model_dt(cfg, (B, S, m.qk_rope_head_dim),
                            ("act_batch", seq_axis, None)),
    }


def ssm_cache_specs(cfg: ModelConfig, B: int) -> dict:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    inner = cfg.ssm_expand * cfg.d_model
    return {
        "state": _f32((B, H, P, N), ("act_batch", "act_heads", None, None)),
        "conv_x": _f32((B, CONV_K - 1, inner),
                       ("act_batch", None, "act_heads")),
        "conv_B": _f32((B, CONV_K - 1, N), ("act_batch", None, None)),
        "conv_C": _f32((B, CONV_K - 1, N), ("act_batch", None, None)),
    }


def mlstm_cache_specs(cfg: ModelConfig, B: int) -> dict:
    H, P = cfg.num_heads, cfg.resolved_head_dim
    return {
        "C": _f32((B, H, P, P), ("act_batch", "act_heads", None, None)),
        "n": _f32((B, H, P), ("act_batch", "act_heads", None)),
        "m": _f32((B, H), ("act_batch", "act_heads")),
        "conv": _f32((B, CONV_K - 1, cfg.d_model),
                     ("act_batch", None, None)),
    }


def slstm_cache_specs(cfg: ModelConfig, B: int) -> dict:
    H, P = cfg.num_heads, cfg.resolved_head_dim
    ax = ("act_batch", "act_heads", None)
    return {"h": _f32((B, H, P), ax), "c": _f32((B, H, P), ax),
            "n": _f32((B, H, P), ax),
            "m": _f32((B, H, P), ax)}


def cross_cache_specs(cfg: ModelConfig, B: int, S_enc: int) -> dict:
    Hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    ax = ("act_batch", "act_seq", "kv_heads", None)
    return {"k": _model_dt(cfg, (B, S_enc, Hkv, dh), ax),
            "v": _model_dt(cfg, (B, S_enc, Hkv, dh), ax)}


def _attn_cache(cfg, B, S, seq_axis, window):
    if cfg.attn_type == "mla":
        return mla_cache_specs(cfg, B, S, seq_axis)
    return attn_cache_specs(cfg, B, S, seq_axis, window=window)


def seg_cache_specs(cfg: ModelConfig, seg, B: int, S: int,
                    seq_axis: str = "act_cache_seq") -> dict:
    """The stacked cache tree of one segment (``transformer.Seg``) for
    batch ``B`` and length ``S``: ``[n, ...]`` leaves, ``[n, sub, ...]``
    for a group's inner stack."""
    if seg.kind == "attn":
        return stack_specs(_attn_cache(cfg, B, S, seq_axis, seg.window),
                           seg.n)
    if seg.kind == "gemma":
        return stack_specs({
            "local": stack_specs(_attn_cache(cfg, B, S, seq_axis,
                                             seg.window), seg.sub),
            "global": _attn_cache(cfg, B, S, seq_axis, 0),
        }, seg.n)
    if seg.kind == "zamba":
        return stack_specs({
            "mamba": stack_specs(ssm_cache_specs(cfg, B), seg.sub),
            "attn": _attn_cache(cfg, B, S, seq_axis, 0),
        }, seg.n)
    if seg.kind == "mamba":
        return stack_specs(ssm_cache_specs(cfg, B), seg.n)
    if seg.kind == "xlstm":
        return stack_specs({
            "mlstm": stack_specs(mlstm_cache_specs(cfg, B), seg.sub),
            "slstm": slstm_cache_specs(cfg, B),
        }, seg.n)
    if seg.kind == "xlstm_tail":
        return stack_specs(mlstm_cache_specs(cfg, B), seg.n)
    raise ValueError(seg.kind)
