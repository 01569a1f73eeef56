"""Quantized KV storage: quantization roundtrip, scale layout, and
attention over dequantized caches.

Attention over a quantized cache is checked against the fp32 reference
over the *dequantized* cache (exact math), plus a looser check against the
unquantized cache (quantization error budget).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute import flash_attention_forward
from flash_attention_cute.ops.quantized import (
    FP8_E4M3_MAX,
    INT8_MAX,
    dequantize_kv,
    quantize_kv,
)
from flash_attention_cute.ops.reference import attention_reference

QDTYPES = pytest.mark.parametrize("qdtype", [jnp.int8, jnp.float8_e4m3fn],
                                  ids=["int8", "fp8"])


def make(key, b, hq, hkv, skv, d, dtype=jnp.float32):
    ks = jax.random.split(key, 3)
    q = jax.random.normal(ks[0], (b, hq, 1, d), jnp.float32).astype(dtype)
    kk = jax.random.normal(ks[1], (b, hkv, skv, d), jnp.float32)
    vv = jax.random.normal(ks[2], (b, hkv, skv, d), jnp.float32)
    return q, kk, vv


@QDTYPES
def test_quantize_roundtrip(qdtype):
    x = jax.random.normal(jax.random.key(0), (2, 4, 64, 32)) * 3.0
    qt = quantize_kv(x, qdtype)
    assert qt.values.dtype == qdtype
    back = dequantize_kv(qt)
    err = np.abs(np.asarray(back) - np.asarray(x)).max()
    amax = float(jnp.abs(x).max())
    # int8 symmetric: absolute error ~amax/127. fp8 e4m3: 3 mantissa bits,
    # relative error up to 2^-4 of the element magnitude.
    bound = amax / 64 if qdtype == jnp.int8 else amax / 14
    assert err < bound, (err, bound)


def test_quantize_zero_row_safe():
    x = jnp.zeros((1, 1, 8, 16))
    qt = quantize_kv(x)
    assert np.isfinite(np.asarray(qt.scales)).all()
    np.testing.assert_array_equal(np.asarray(dequantize_kv(qt)), 0.0)


@QDTYPES
def test_scales_are_per_token(qdtype):
    """One f32 scale per cached token ([..., S]), the layout the paged
    kernel folds into its score and probability tiles."""
    x = jax.random.normal(jax.random.key(1), (3, 2, 40, 16))
    qt = quantize_kv(x, qdtype)
    assert qt.values.shape == x.shape
    assert qt.scales.shape == x.shape[:-1] and qt.scales.dtype == jnp.float32


@QDTYPES
def test_values_stay_in_range(qdtype):
    """Each token's absmax maps onto the format's largest value."""
    x = jax.random.normal(jax.random.key(2), (2, 64, 32)) * 100.0
    qt = quantize_kv(x, qdtype)
    v = np.abs(np.asarray(qt.values, np.float32))
    top = INT8_MAX if qdtype == jnp.int8 else FP8_E4M3_MAX
    assert v.max() <= top
    np.testing.assert_allclose(v.max(axis=-1), top, rtol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_dequantize_dtype(dtype):
    qt = quantize_kv(jax.random.normal(jax.random.key(3), (4, 8, 16)))
    assert dequantize_kv(qt, dtype).dtype == dtype


@QDTYPES
def test_quant_decode_matches_dequant_reference(qdtype):
    """Decode over a dequantized cache == the oracle over the same values."""
    q, kk, vv = make(jax.random.key(1), 2, 8, 2, 512, 64)
    kq, vq = quantize_kv(kk, qdtype), quantize_kv(vv, qdtype)
    lens = jnp.array([300, 512], jnp.int32)
    got = flash_attention_forward(
        q, dequantize_kv(kq), dequantize_kv(vq), kv_length=lens
    )
    want = attention_reference(
        q, dequantize_kv(kq), dequantize_kv(vq), kv_length=lens
    )
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=2e-5, rtol=2e-2
    )


def test_quant_decode_close_to_fp32():
    """End-to-end quantization error stays small vs the unquantized cache."""
    q, kk, vv = make(jax.random.key(2), 1, 8, 2, 1024, 128)
    kq, vq = quantize_kv(kk), quantize_kv(vv)
    got = flash_attention_forward(q, dequantize_kv(kq), dequantize_kv(vq))
    want = attention_reference(q, kk, vv)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=5e-2, rtol=5e-2
    )
