"""The ``decoder`` family: a llama-style dense decoder (Yi) or a
Mixtral-style sparse one, with grouped-query attention, RoPE, RMSNorm and
a SwiGLU FFN or top-k softmax-routed SwiGLU experts.

A configuration file names its family under ``"family"``; the harness
finds this module as ``perfbench/families/<family>.py`` and takes from it
all it knows of the model:

- ``port_config(c)``: the program's registered configuration with the
  file's overrides, held to the sizes the file states;
- ``leaf_shapes(c)`` and ``leaf_init(path, shape)``: the weight tree and
  each leaf's draw (``perfbench.reference.weights.draw`` makes it);
- ``reference(c, w, quant=None)``: the plain reference, an object with
  ``logits(seqs, want)``; ``quant="fp8"`` is the control's precision;
- ``control_engine(c, device, quant)``: the reference serving the cell in
  the program's place (``perfbench.control``);
- ``yardstick(c)``: the counts the per-layer readers take
  (``record["dims"]``): ``prefill_flops(prompt_lens)``,
  ``decode_step_bytes(batch, context)``, ``kv_bytes_per_token``,
  ``prefill_attention_bound(batch, plen)``, ``decode_expert_bytes(batch)``
  and ``prefill_expert_flops(tokens)``, the last two None without experts.

This module may import the program, lazily; the reference's code stays
under ``perfbench/reference/``, which imports nothing of it.
"""

from __future__ import annotations

import dataclasses

from perfbench import arith
from perfbench.reference.weights import leaf_init, leaf_shapes

__all__ = ["port_config", "leaf_shapes", "leaf_init", "reference",
           "control_engine", "yardstick"]


def port_config(c: dict):
    """The program's registered configuration with the file's overrides,
    held to the sizes the file states."""
    from repro_torch.config.base import get_config
    cfg = get_config(c["arch"])
    over = dict(c.get("overrides", {}))
    if "moe" in over:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    cfg = dataclasses.replace(cfg, **over)
    window = cfg.window if cfg.attn_type == "swa" else 0
    have = {"hidden_size": cfg.d_model, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.resolved_head_dim,
            "num_hidden_layers": cfg.num_layers, "vocab_size": cfg.vocab_size,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "tie_word_embeddings": cfg.tie_embeddings,
            "attention_bias": cfg.qkv_bias, "sliding_window": window or None,
            "torch_dtype": cfg.dtype}
    if cfg.moe is None:
        have["intermediate_size"] = cfg.d_ff
    else:
        have.update({"intermediate_size": cfg.moe.d_ff_expert,
                     "num_local_experts": cfg.moe.num_experts,
                     "num_experts_per_tok": cfg.moe.top_k})
    wrong = {k: (v, c.get(k)) for k, v in have.items() if c.get(k) != v}
    if wrong:
        raise ValueError(f"the program's {c['arch']} departs from the "
                         f"configuration file: {{key: (program, file)}} "
                         f"{wrong}")
    return cfg


def reference(c: dict, w: dict, quant: str | None = None):
    from perfbench.reference.model import Reference
    return Reference(c, w, quant=quant)


def control_engine(c: dict, device, quant: str | None):
    from perfbench.reference.engine import ReferenceEngine
    return ReferenceEngine(c, device, quant)


def yardstick(c: dict) -> arith.Dims:
    return arith.Dims.from_config(c)
