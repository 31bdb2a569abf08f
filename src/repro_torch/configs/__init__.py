"""Architecture registry. Importing this package registers the ported archs.

All ten architectures of the reference are registered, in its order.
"""

from repro_torch.configs import (  # noqa: F401
    qwen2_72b,
    gemma3_27b,
    yi_9b,
    qwen15_110b,
    deepseek_v3_671b,
    mixtral_8x22b,
    whisper_small,
    zamba2_7b,
    qwen2_vl_72b,
    xlstm_350m,
)

from repro_torch.config.base import get_config, list_archs  # noqa: F401
