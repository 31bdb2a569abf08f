"""The ``deepseek`` family: DeepSeek-V3 (arXiv:2412.19437) at one chip's
expert-parallel share: multi-head latent attention with YaRN, leading
dense SwiGLU layers, then MoE layers that route over every routed expert
by the published sigmoid, group-limited router and compute the experts
held here, with a shared expert.

The harness finds this module as ``perfbench/families/<family>.py`` and
takes the six functions ``perfbench/families/decoder.py`` describes:
``port_config``, ``leaf_shapes``, ``leaf_init``, ``reference``,
``control_engine`` and ``yardstick``. The configuration file holds the
published keys (the catalog's ``config``); ``n_routed_experts`` counts the
experts held here and ``expert_share`` says which (``first``) of how many
the router scores (``routed_over``).

This module may import the program, lazily; the reference's code stays
under ``perfbench/reference/``, which imports nothing of it.
"""

from __future__ import annotations

import dataclasses

from perfbench import deepseek_arith
from perfbench.reference.deepseek import leaf_init, leaf_shapes

__all__ = ["port_config", "leaf_shapes", "leaf_init", "reference",
           "control_engine", "yardstick"]

# the MoEConfig fields this family sets beyond the registered ones
ROUTER_FIELDS = ("scoring_func", "n_group", "topk_group",
                 "routed_scaling_factor", "experts_held", "first_held")


def port_config(c: dict):
    """The program's registered configuration, with the file's
    ``overrides`` where it has them (``mla`` and ``moe`` as dicts of their
    fields; the CPU tests' tiny widths), then the file's router, share,
    YaRN and depth, held to every size the file states. A program without
    those fields is refused here, before anything is built."""
    from repro_torch.config import base
    cfg = base.get_config(c["arch"])
    over = dict(c.get("overrides", {}))
    for group in ("mla", "moe"):
        if group in over:
            over[group] = dataclasses.replace(getattr(cfg, group),
                                              **over[group])
    cfg = dataclasses.replace(cfg, **over)
    have = {f.name for f in dataclasses.fields(base.MoEConfig)}
    missing = [f for f in ROUTER_FIELDS if f not in have]
    if missing or not hasattr(base, "YaRNConfig"):
        raise SystemExit(
            f"perfbench: the program's MoEConfig lacks {missing} or its "
            f"config lacks YaRNConfig: it cannot serve {c['arch']} with the "
            f"published router, one chip's share of the experts and YaRN, "
            f"which this configuration states")
    y = c["rope_scaling"]
    if y.get("type") != "yarn":
        raise ValueError(f"rope_scaling of type {y.get('type')!r}; the "
                         f"program takes yarn")
    share = c["expert_share"]
    moe = dataclasses.replace(
        cfg.moe, first_dense_layers=c["first_k_dense_replace"],
        scoring_func=c["scoring_func"], n_group=c["n_group"],
        topk_group=c["topk_group"], routed_scaling_factor=c["routed_scaling_factor"],
        experts_held=c["n_routed_experts"], first_held=share["first"])
    cfg = dataclasses.replace(
        cfg, num_layers=c["num_hidden_layers"], norm_eps=c["rms_norm_eps"],
        moe=moe, rope_scaling=base.YaRNConfig(
            factor=y["factor"],
            original_max_position_embeddings=y[
                "original_max_position_embeddings"],
            beta_fast=y["beta_fast"], beta_slow=y["beta_slow"],
            mscale=y["mscale"], mscale_all_dim=y["mscale_all_dim"]))
    m, e = cfg.mla, cfg.moe
    have = {"hidden_size": cfg.d_model, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
            "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_embeddings,
            "attention_bias": cfg.qkv_bias, "torch_dtype": cfg.dtype,
            "q_lora_rank": m.q_lora_rank, "kv_lora_rank": m.kv_lora_rank,
            "qk_nope_head_dim": m.qk_nope_head_dim,
            "qk_rope_head_dim": m.qk_rope_head_dim,
            "v_head_dim": m.v_head_dim,
            "moe_intermediate_size": e.d_ff_expert,
            "n_shared_experts": e.num_shared_experts,
            "num_experts_per_tok": e.top_k, "moe_layer_freq": cfg.moe_every,
            "topk_method": "noaux_tc" if e.scoring_func == "sigmoid"
            else "greedy", "hidden_act": "silu",
            "norm_topk_prob": True}       # the program renormalizes
    wrong = {k: (v, c.get(k)) for k, v in have.items() if c.get(k) != v}
    if share["routed_over"] != e.num_experts:
        wrong["expert_share.routed_over"] = (e.num_experts,
                                             share["routed_over"])
    if wrong:
        raise ValueError(f"the program's {c['arch']} departs from the "
                         f"configuration file: {{key: (program, file)}} "
                         f"{wrong}")
    return cfg


def reference(c: dict, w: dict, quant: str | None = None):
    from perfbench.reference.deepseek import Reference
    return Reference(c, w, quant=quant)


def control_engine(c: dict, device, quant: str | None):
    from perfbench.reference.deepseek_engine import DeepSeekEngine
    return DeepSeekEngine(c, device, quant)


def yardstick(c: dict) -> deepseek_arith.Dims:
    return deepseek_arith.Dims.from_config(c)
