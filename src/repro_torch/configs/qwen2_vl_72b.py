"""Qwen2-VL-72B [arXiv:2409.12191; hf]: qwen2-72b backbone + M-RoPE.

The vision frontend is a stub: a batch may carry precomputed patch
embeddings ``embeds`` with ``positions`` (3, batch, S), M-RoPE's three
position axes (t, h, w); a batch of ``tokens`` alone takes equal rows.
"""

from repro_torch.config.base import ModelConfig, register


@register("qwen2-vl-72b")
def qwen2_vl_72b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        attn_type="full",
        qkv_bias=True,
        mrope=True,
        frontend="vision",
        rope_theta=1e6,
    )
