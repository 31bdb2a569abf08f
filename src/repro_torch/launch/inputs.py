"""input_specs() and make_batch(): stand-ins and concrete random batches
for every model input.

``input_specs`` gives fake tensors (no memory behind them) with the
reference's shapes, dtypes and placements on the mesh in ``mctx``: the
dry-run traces train, prefill and decode steps from them.

The port of the reference's ``repro/launch/inputs.make_batch``, with the
same numpy draws, so a batch for a seed equals the reference's (bf16 bit for
bit). Modality frontends are stubs: whisper takes precomputed frame
embeddings (``frames``), qwen2-vl precomputed patch embeddings (``embeds``)
with M-RoPE positions (3, B, S), all three axes ``arange(S)`` here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.models.context import MCtx, resolve_device
from repro_torch.models.params import abstract_leaf, torch_dtype
from repro_torch.models.sharding import named_sharding


def _sds(shape, dtype: str, mctx: MCtx, axes):
    return abstract_leaf(shape, torch_dtype(dtype), named_sharding(
        mctx.mesh, mctx.rules, axes, tuple(shape)))


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                mctx: MCtx) -> dict[str, Any]:
    """Fake batch tensors for (arch, shape) under the mesh in mctx."""
    B, S = shape.global_batch, shape.seq_len
    bax = ("act_batch", "act_seq")

    if shape.kind in ("train", "prefill"):
        batch: dict[str, Any] = {}
        if cfg.encoder_decoder:
            batch["frames"] = _sds((B, S, cfg.d_model), "bfloat16",
                                   mctx, (*bax, None))
            batch["tokens"] = _sds((B, S), "int32", mctx, bax)
        elif cfg.frontend == "vision":
            batch["embeds"] = _sds((B, S, cfg.d_model), "bfloat16",
                                   mctx, (*bax, None))
            batch["positions"] = _sds((3, B, S), "int32",
                                      mctx, (None, *bax))
        elif cfg.frontend == "audio":
            batch["embeds"] = _sds((B, S, cfg.d_model), "bfloat16",
                                   mctx, (*bax, None))
        else:
            batch["tokens"] = _sds((B, S), "int32", mctx, bax)
        if shape.kind == "train":
            batch["labels"] = _sds((B, S), "int32", mctx, bax)
        return batch

    # decode: one new token against a seq_len cache
    return {"tokens": _sds((B, 1), "int32", mctx, ("act_batch", None))}


def make_batch(cfg: ModelConfig, shape: ShapeConfig, rng=None,
               device=None) -> dict[str, Any]:
    """Random batch for (arch, shape) on ``device`` (default ``cuda``;
    raises without one), drawn from ``np.random.default_rng(rng or 0)``:
    int32 tokens, labels and positions, bf16 frames and embeds. A decode
    shape gives one new token per row."""
    device = resolve_device(device)
    rng = np.random.default_rng(0 if rng is None else rng)
    B, S = shape.global_batch, shape.seq_len

    def ints(high, size):
        return torch.from_numpy(
            rng.integers(0, high, size).astype(np.int32))

    def embeds():
        return torch.from_numpy(
            rng.normal(size=(B, S, cfg.d_model)).astype("float32")
        ).to(torch.bfloat16)
    out: dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.encoder_decoder:
            out["frames"] = embeds()
            out["tokens"] = ints(cfg.vocab_size, (B, S))
        elif cfg.frontend == "vision":
            out["embeds"] = embeds()
            out["positions"] = torch.arange(S, dtype=torch.int32)[
                None, None].expand(3, B, S)
        elif cfg.frontend == "audio":
            out["embeds"] = embeds()
        else:
            out["tokens"] = ints(cfg.vocab_size, (B, S))
        if shape.kind == "train":
            out["labels"] = ints(cfg.vocab_size, (B, S))
    else:
        out["tokens"] = ints(cfg.vocab_size, (B, 1))
    return {k: v.to(device) for k, v in out.items()}
