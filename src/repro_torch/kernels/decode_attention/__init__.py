from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    dense_decode_attention, dense_decode_attention_ref)
