"""The DeepSeek-V3 configuration file at a tiny DeepSeek shape for runs
on the CPU: 16 routed experts in 4 groups of which 2 are kept, top 4, a
share of 4 of them, a shared expert, 1 dense and 2 MoE layers, MLA, and
YaRN at the published factor and context, whose ramp falls inside the
8-wide rope part (low 1, high 3); with the overrides that shrink the
program's registered deepseek-v3-671b to match."""

import json

from perfbench import run

CONFIG = run.HERE / "configs" / "deepseek-v3-ep32-7of61.json"
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 4, "q_lora_rank": 32, "kv_lora_rank": 16,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "intermediate_size": 128, "moe_intermediate_size": 32,
        "vocab_size": 256, "num_hidden_layers": 3,
        "first_k_dense_replace": 1, "n_group": 4, "topk_group": 2,
        "num_experts_per_tok": 4}


def tiny_config(first: int = 4, held: int = 4, dtype: str = "float32"
                ) -> dict:
    """The configuration file at TINY's widths, its share ``held``
    experts from ``first`` of 16, in ``dtype``."""
    c = json.loads(CONFIG.read_text())
    c.update(TINY, n_routed_experts=held, torch_dtype=dtype,
             expert_share={"first": first, "routed_over": 16})
    c["overrides"] = {
        "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "head_dim": 16,
        "d_ff": 128, "vocab_size": 256, "dtype": dtype,
        "mla": {"q_lora_rank": 32, "kv_lora_rank": 16,
                "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                "v_head_dim": 16},
        "moe": {"num_experts": 16, "top_k": 4, "d_ff_expert": 32}}
    return c
