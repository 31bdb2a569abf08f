"""Mixtral-8x22B [arXiv:2401.04088; hf]: 8-expert top-2 MoE with SWA.

The assignment specifies sliding-window attention (per the Mixtral paper
lineage); window follows Mistral's 4096.
"""

from repro_torch.config.base import ModelConfig, MoEConfig, register


@register("mixtral-8x22b")
def mixtral_8x22b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32768,
        attn_type="swa",
        window=4096,
        moe=MoEConfig(
            num_experts=8,
            top_k=2,
            num_shared_experts=0,
            d_ff_expert=16384,
            capacity_factor=1.25,
        ),
        rope_theta=1e6,
    )
