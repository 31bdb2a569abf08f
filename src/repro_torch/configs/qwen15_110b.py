"""Qwen1.5-110B [hf:Qwen/Qwen1.5 family]: dense GQA decoder, QKV bias."""

from repro_torch.config.base import ModelConfig, register


@register("qwen1.5-110b")
def qwen15_110b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=49152,
        vocab_size=152064,
        attn_type="full",
        qkv_bias=True,
        rope_theta=1e6,
    )
