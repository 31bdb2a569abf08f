from repro_torch.kernels.quant.ops import (  # noqa: F401
    dequantize_pages, dequantize_pages_ref, quantize_pages,
    quantize_pages_ref)
