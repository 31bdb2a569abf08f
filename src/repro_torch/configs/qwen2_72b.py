"""Qwen2-72B [arXiv:2407.10671; hf]: dense GQA decoder with QKV bias."""

from repro_torch.config.base import ModelConfig, register


@register("qwen2-72b")
def qwen2_72b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        attn_type="full",
        qkv_bias=True,
        rope_theta=1e6,
    )
