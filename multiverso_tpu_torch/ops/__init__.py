"""The port's kernels and quantized-tensor ops."""
from multiverso_tpu_torch.ops.attention_kernels import flash_attention
from multiverso_tpu_torch.ops.quantization import (
    QuantizedTensor, dequantize, quantize, quantize_lm_params)

__all__ = ["QuantizedTensor", "dequantize", "flash_attention",
           "quantize", "quantize_lm_params"]
