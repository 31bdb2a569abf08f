"""Architecture registry. Importing this package registers the ported archs.

The seven decoder-only architectures of the reference are registered;
whisper (encoder-decoder) and qwen2-vl (M-RoPE) arrive with the slice that
ports them.
"""

from repro_torch.configs import (  # noqa: F401
    qwen2_72b,
    gemma3_27b,
    yi_9b,
    qwen15_110b,
    deepseek_v3_671b,
    mixtral_8x22b,
    zamba2_7b,
    xlstm_350m,
)

from repro_torch.config.base import get_config, list_archs  # noqa: F401
