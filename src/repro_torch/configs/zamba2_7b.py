"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + shared attention blocks.

81 Mamba2 layers with a (shared) full-attention block applied every 6 layers.
ssm_state=64; Mamba2 inner width = 2*d_model with 64-dim SSD heads.
"""

from repro_torch.config.base import ModelConfig, register


@register("zamba2-7b")
def zamba2_7b() -> ModelConfig:
    d_model = 3584
    expand = 2
    head_dim = 64
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=d_model,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,                # attention blocks: 32 heads x 112 = 3584
        d_ff=14336,
        vocab_size=32000,
        attn_type="full",
        attn_every=6,                # shared attention block every 6 mamba layers
        ssm_state=64,
        ssm_expand=expand,
        ssm_head_dim=head_dim,
        ssm_heads=expand * d_model // head_dim,   # 112 SSD heads
        rope_theta=1e4,
    )
