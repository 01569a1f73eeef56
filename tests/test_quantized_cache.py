"""Model-level quantized KV cache (int8/fp8) through prefill + decode.

The kernel-level quantized op is covered by tests/test_quantized.py; here
the cache rides the full model: quantize-at-write, in-kernel dequant at
decode, dequant fallback for extend — generations must track the bf16/f32
cache closely (quantization noise only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models import forward, init_params
from flash_attention_cute.models.cache import KVCache, QuantizedKVCache
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.runtime.generate import greedy_generate, prefill


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    return cfg, params


@pytest.mark.parametrize("qdtype", [jnp.int8, jnp.float8_e4m3fn])
def test_quantized_cache_decode_tracks_dense(model, qdtype):
    cfg, params = model
    ids = jax.random.randint(jax.random.key(1), (2, 12), 0, cfg.vocab_size)

    dense = KVCache.create(cfg, batch=2, capacity=32)
    logits_d, dense = forward(params, cfg, ids, cache=dense, mode="prefill")

    quant = QuantizedKVCache.create(cfg, batch=2, capacity=32, dtype=qdtype)
    logits_q, quant = forward(params, cfg, ids, cache=quant, mode="prefill")
    # Prefill attention runs on the fresh (unquantized) K/V: identical.
    np.testing.assert_allclose(
        np.asarray(logits_q), np.asarray(logits_d), atol=1e-5, rtol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(quant.lengths), [12, 12])

    # int8 has 8 significant bits per token-scaled value; fp8_e4m3 only 4
    # (1+3 mantissa) -> proportionally larger logit deltas.
    atol = 0.15 if qdtype == jnp.int8 else 0.6
    tok = jnp.argmax(logits_d[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for _ in range(3):
        ld, dense = forward(params, cfg, tok, cache=dense, mode="decode")
        lq, quant = forward(params, cfg, tok, cache=quant, mode="decode")
        np.testing.assert_allclose(
            np.asarray(lq), np.asarray(ld), atol=atol, rtol=0.2
        )
        tok = jnp.argmax(ld[:, -1], axis=-1).astype(jnp.int32)[:, None]


def test_quantized_cache_extend_matches_sequential_decode(model):
    """Chunked extend quantizes each new token exactly like the decode
    loop does, so the two must agree tightly (the exact-oracle relation;
    agreement with the UNQUANTIZED forward is only up to quantization
    noise, which compounds across layers on random weights)."""
    cfg, params = model
    ids = jax.random.randint(jax.random.key(2), (2, 16), 0, cfg.vocab_size)

    quant = QuantizedKVCache.create(cfg, batch=2, capacity=32, dtype=jnp.int8)
    _, quant = forward(params, cfg, ids[:, :8], cache=quant, mode="prefill")
    logits_e, quant = forward(params, cfg, ids[:, 8:16], cache=quant, mode="extend")
    np.testing.assert_array_equal(np.asarray(quant.lengths), [16, 16])

    quant2 = QuantizedKVCache.create(cfg, batch=2, capacity=32, dtype=jnp.int8)
    _, quant2 = forward(params, cfg, ids[:, :8], cache=quant2, mode="prefill")
    for t in range(8, 16):
        logits_t, quant2 = forward(
            params, cfg, ids[:, t : t + 1], cache=quant2, mode="decode"
        )
        np.testing.assert_allclose(
            np.asarray(logits_e[:, t - 8]), np.asarray(logits_t[:, 0]),
            atol=1e-4, rtol=1e-3,
        )


def test_generate_with_quantized_cache(model):
    cfg, params = model
    ids = jax.random.randint(jax.random.key(3), (1, 10), 0, cfg.vocab_size)
    last, cache = prefill(
        params, cfg, ids, cache_capacity=24, cache_dtype=jnp.int8
    )
    assert isinstance(cache, QuantizedKVCache)
    out = greedy_generate(params, cfg, ids, max_new_tokens=6,
                          cache_capacity=24)
    assert out.shape == (1, 6)
