"""xLSTM-350M [arXiv:2405.04517]: sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM).

d_ff=0 per the assignment: xLSTM blocks carry their own up/down projections
(pre-up-projection mLSTM blocks), there is no separate FFN.
"""

from repro_torch.config.base import ModelConfig, register


@register("xlstm-350m")
def xlstm_350m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab_size=50304,
        attn_type="full",            # unused; blocks are recurrent
        slstm_every=8,               # 1 sLSTM per 8 blocks (7:1)
        ssm_expand=2,
        rope_theta=1e4,
    )
