"""DeepSeek-V3 671B [arXiv:2412.19437; hf]: MLA + 1 shared / 256 routed top-8 MoE.

First 3 layers are dense (d_ff=18432); remaining 58 are MoE with per-expert
d_ff=2048. MLA: q_lora 1536, kv_lora 512, qk 128+64 (nope+rope), v 128.
The MTP (multi-token prediction) head is not part of the backbone compute
here, as in the reference: the model runs the standard train/serve step.
"""

from repro_torch.config.base import (MLAConfig, ModelConfig, MoEConfig,
                                     register)


@register("deepseek-v3-671b")
def deepseek_v3_671b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=18432,                 # dense-layer FFN width
        vocab_size=129280,
        attn_type="mla",
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=256,
            top_k=8,
            num_shared_experts=1,
            d_ff_expert=2048,
            capacity_factor=1.25,
            first_dense_layers=3,
        ),
        rope_theta=1e4,
    )
