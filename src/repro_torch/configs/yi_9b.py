"""Yi-9B [arXiv:2403.04652; hf]: llama-architecture dense GQA decoder."""

from repro_torch.config.base import ModelConfig, register


@register("yi-9b")
def yi_9b() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        attn_type="full",
        rope_theta=1e4,
    )
