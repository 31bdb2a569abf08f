from repro_torch.kernels.quant.ops import (  # noqa: F401
    dequantize, dequantize_pages, dequantize_pages_ref, dequantize_ref,
    quantize, quantize_pages, quantize_pages_ref, quantize_ref)
