"""Gemma3-27B [hf:google/gemma-3 family]: 5:1 local:global attention, 128k ctx.

Local layers use a 1024-token sliding window; every 6th layer is global.
"""

from repro_torch.config.base import ModelConfig, register


@register("gemma3-27b")
def gemma3_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        attn_type="local_global",
        local_global_ratio=5,      # 5 local : 1 global
        window=1024,
        rope_theta=1e6,
    )
