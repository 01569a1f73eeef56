"""Quantized KV cache storage: int8 / fp8 values with per-token scales.

Completes the reference's "quantized dtype kernels" roadmap item
(reference: README.md:22) for the cache: int8/fp8 halves (vs bf16) the
bytes each cached token holds. The paged decode kernel folds the scales
into its score and probability tiles (ops/paged_attention.py); the other
routes dequantize and take the dense path.

Scales are stored as [..., S] (f32); value layouts match the bf16 cache.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

INT8_MAX = 127.0
FP8_E4M3_MAX = 448.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuantizedKV:
    """Quantized tensor + per-token scales.

    values: int8 or float8_e4m3fn, same shape as the original [..., S, D]
    scales: float32 [..., S] such that original ~= values * scales[..., None]
    """

    values: jax.Array
    scales: jax.Array


def quantize_kv(x: jax.Array, dtype=jnp.int8) -> QuantizedKV:
    """Per-token (last-axis) symmetric quantization of [..., S, D]."""
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)  # [..., S]
    qmax = INT8_MAX if dtype == jnp.int8 else FP8_E4M3_MAX
    scales = jnp.where(amax == 0.0, 1.0, amax / qmax)
    scaled = x.astype(jnp.float32) / scales[..., None]
    if dtype == jnp.int8:
        values = jnp.round(scaled).astype(jnp.int8)
    else:
        values = scaled.astype(dtype)
    return QuantizedKV(values=values, scales=scales)


def dequantize_kv(q: QuantizedKV, dtype=jnp.float32) -> jax.Array:
    return (q.values.astype(jnp.float32) * q.scales[..., None]).astype(dtype)

