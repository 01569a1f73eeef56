"""Attention ops: the dense routes, paged decode/extend, quantized storage.

Layout convention throughout: q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D]
(matches the reference custom op, reference: csrc/flash_attention_api.cpp:14-135).
`reference.attention_reference` is the numerics oracle the tests compare
every route against; no production path calls it.
"""

from flash_attention_cute.ops.reference import attention_reference
from flash_attention_cute.ops.attention import (
    cudnn_attention,
    flash_attention_varlen,
    xla_attention,
)
from flash_attention_cute.ops.paged_attention import (
    paged_attention_decode,
    paged_attention_extend,
)
from flash_attention_cute.ops.quantized import (
    QuantizedKV,
    dequantize_kv,
    quantize_kv,
)

__all__ = [
    "attention_reference",
    "cudnn_attention",
    "flash_attention_varlen",
    "xla_attention",
    "paged_attention_decode",
    "paged_attention_extend",
    "QuantizedKV",
    "quantize_kv",
    "dequantize_kv",
]
