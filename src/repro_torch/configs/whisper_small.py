"""Whisper-small [arXiv:2212.04356]: encoder-decoder transformer backbone.

The conv frontend is a stub: a batch carries precomputed frame embeddings
``frames`` of shape (batch, frames, d_model) (``launch.inputs.make_batch``,
``data.synthetic``).
"""

from repro_torch.config.base import ModelConfig, register


@register("whisper-small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,               # decoder layers
        num_encoder_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        attn_type="full",
        encoder_decoder=True,
        frontend="audio",
        rope_theta=1e4,
    )
