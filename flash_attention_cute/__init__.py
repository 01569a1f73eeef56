"""flash_attention_cute — an attention-centric LLM inference engine in JAX.

A from-scratch JAX/Pallas framework with the capabilities of the CUDA
reference (izmttk/flash_attention_cute): a fused QK^T -> online-softmax -> PV
flash-attention forward kernel, shape-specialized dispatch, GQA/MQA with
decode-time q-head-group packing, and Llama / Qwen2 model integration —
extended with split-KV flash decoding, paged KV cache, quantized KV, and
multi-chip sharding, which the reference lists as roadmap TODOs.

Public API mirrors the reference's `flash_attention` package
(reference: flash_attention/flash_attention.py:46-53):

    from flash_attention_cute import flash_attn_func
    o = flash_attn_func(q, k, v, softmax_scale=None, causal=True)

with q/k/v laid out [batch, heads, seq, head_dim] exactly like the reference
custom op.
"""

import os

# XLA's Triton gemm emitter in the installed jaxlib miscompiles some bf16
# gemms of the full-width models on the H100: whole rows of a prefill come
# out NaN at some sequence lengths (128 and 129 tokens of Qwen2-7B widths),
# on every attention route; with cuBLAS gemms the same programs are finite
# and match (PERF.md). XLA reads XLA_FLAGS when its backend starts, so the
# flag is set here, before any device is used.
_GEMM_FLAG = "--xla_gpu_enable_triton_gemm"
if _GEMM_FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + f" {_GEMM_FLAG}=false"
    ).strip()

from flash_attention_cute.api import flash_attn_func, flash_attention_forward  # noqa: E402
from flash_attention_cute.ops.reference import attention_reference  # noqa: E402
from flash_attention_cute.ops.attention import flash_attention_varlen  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "flash_attn_func",
    "flash_attention_forward",
    "flash_attention_varlen",
    "attention_reference",
    "__version__",
]
