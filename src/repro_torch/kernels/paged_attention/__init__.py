from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    paged_attention, paged_attention_quant, paged_attention_quant_ref,
    paged_attention_ref)
