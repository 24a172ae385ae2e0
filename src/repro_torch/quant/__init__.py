from repro_torch.quant.params import is_quantized, param_bytes, quantize_params
from repro_torch.quant.tensor import (QUANT_DTYPES, QuantTensor,
                                      canonical_dtype, dequantize_kv,
                                      dequantize_weight, is_quant_dtype,
                                      pack_int4, quantize_kv, quantize_tensor,
                                      quantize_weight, unpack_int4)

__all__ = ["QUANT_DTYPES", "QuantTensor", "canonical_dtype", "dequantize_kv",
           "dequantize_weight", "is_quant_dtype", "is_quantized",
           "pack_int4", "param_bytes", "quantize_kv", "quantize_params",
           "quantize_tensor", "quantize_weight", "unpack_int4"]
