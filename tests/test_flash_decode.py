"""Single-token decode over a contiguous cache vs the fp32 oracle.

Covers the reference's decode benchmark configs (seqlen_q=1, GQA,
reference: scripts/benchmark_kernel.py:180-188 + csrc/flash_attention_api.cpp:72-83)
plus KV-length masking, which the reference lists as a roadmap TODO
(reference: README.md:18-21). Decode takes the dense route with
`kv_length` (the stacked-cache path of models/transformer.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute import flash_attention_forward
from flash_attention_cute.models import forward, init_params
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.ops.reference import attention_reference


def make_qkv(key, b, hq, hkv, skv, d, dtype):
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, hq, 1, d), jnp.float32).astype(dtype)
    k = jax.random.normal(kk, (b, hkv, skv, d), jnp.float32).astype(dtype)
    v = jax.random.normal(kv, (b, hkv, skv, d), jnp.float32).astype(dtype)
    return q, k, v


def check(q, k, v, kv_length=None, **kw):
    out = flash_attention_forward(q, k, v, kv_length=kv_length, **kw)
    ref = attention_reference(q, k, v, causal=False, kv_length=kv_length,
                              **kw)
    assert out.shape == q.shape and out.dtype == q.dtype
    atol = 2e-2 if q.dtype == jnp.bfloat16 else 2e-5
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=atol, rtol=2e-2,
    )
    return out


@pytest.mark.parametrize(
    "hq,hkv",
    [(8, 8), (8, 2), (16, 2), (8, 1), (28, 4)],
    ids=["mha", "gqa4", "gqa8", "mqa", "gqa7"],
)
def test_gqa_packing(hq, hkv):
    q, k, v = make_qkv(jax.random.key(0), 2, hq, hkv, 512, 64, jnp.float32)
    check(q, k, v, kv_length=jnp.array([512, 300], jnp.int32))


@pytest.mark.parametrize("lengths", [[1], [17], [300], [512]])
def test_kv_length_masking(lengths):
    q, k, v = make_qkv(jax.random.key(3), 1, 8, 2, 512, 64, jnp.float32)
    check(q, k, v, kv_length=jnp.array(lengths, jnp.int32))


def test_per_batch_lengths():
    """Ragged lengths in one batch; a length-0 row emits exact zeros."""
    q, k, v = make_qkv(jax.random.key(4), 4, 8, 2, 768, 64, jnp.float32)
    lengths = jnp.array([0, 130, 511, 768], jnp.int32)
    out = check(q, k, v, kv_length=lengths)
    np.testing.assert_array_equal(np.asarray(out[0]), 0.0)


def test_bf16():
    q, k, v = make_qkv(jax.random.key(5), 2, 8, 2, 512, 128, jnp.bfloat16)
    check(q, k, v, kv_length=jnp.array([200, 512], jnp.int32))


def test_ragged_cache_capacity():
    """Cache capacity that is not a power of two."""
    q, k, v = make_qkv(jax.random.key(6), 1, 4, 4, 333, 64, jnp.float32)
    check(q, k, v, kv_length=jnp.array([333], jnp.int32))


@pytest.mark.parametrize("window", [1, 64])
def test_decode_windowed(window):
    q, k, v = make_qkv(jax.random.key(7), 2, 8, 2, 512, 64, jnp.float32)
    check(q, k, v, kv_length=jnp.array([400, 37], jnp.int32), window=window)


def test_decode_logit_softcap():
    q, k, v = make_qkv(jax.random.key(8), 2, 8, 2, 256, 64, jnp.float32)
    check(q, k, v, kv_length=jnp.array([256, 100], jnp.int32),
          logit_softcap=20.0)


def test_stacked_cache_layer_indexing():
    """Model-level decode over the stacked [L,B,Hkv,C,D] cache (each
    layer's slab sliced before the dense route) must reproduce the logits
    a full prefill computes for the same position."""
    from flash_attention_cute.runtime.generate import prefill

    cfg = tiny_test_config(num_layers=3, dtype=jnp.float32)
    params = init_params(cfg, jax.random.key(11))
    ids = jax.random.randint(jax.random.key(12), (2, 9), 0, cfg.vocab_size)
    _, cache = prefill(params, cfg, ids[:, :8], cache_capacity=16)
    got, _ = forward(params, cfg, ids[:, 8:], cache, mode="decode")
    want, _ = forward(params, cfg, ids, mode="prefill")
    np.testing.assert_allclose(np.asarray(got[:, 0]),
                               np.asarray(want[:, 8]), atol=2e-4, rtol=2e-2)


def test_quantized_stacked_cache_decode_matches_dequantized():
    """Decode over an int8 stacked cache dequantizes each layer's slab
    for the dense route: it must match decode over the same cache
    dequantized up front (the one new token is quantized on one side
    only, hence the loose bound)."""
    from flash_attention_cute.models.cache import KVCache
    from flash_attention_cute.ops.quantized import QuantizedKV, dequantize_kv
    from flash_attention_cute.runtime.generate import prefill

    cfg = tiny_test_config(num_layers=3, dtype=jnp.float32)
    params = init_params(cfg, jax.random.key(11))
    ids = jax.random.randint(jax.random.key(12), (2, 9), 0, cfg.vocab_size)
    _, qcache = prefill(params, cfg, ids[:, :8], cache_capacity=16,
                        cache_dtype=jnp.int8)
    dense = KVCache(
        k=dequantize_kv(QuantizedKV(qcache.k_values, qcache.k_scales)),
        v=dequantize_kv(QuantizedKV(qcache.v_values, qcache.v_scales)),
        lengths=qcache.lengths,
    )
    got, _ = forward(params, cfg, ids[:, 8:], qcache, mode="decode")
    want, _ = forward(params, cfg, ids[:, 8:], dense, mode="decode")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=3e-2, rtol=2e-2)
