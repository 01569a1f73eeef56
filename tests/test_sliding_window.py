"""Sliding-window attention: routes + reference + model integration.

The reference repo *rejects* sliding windows
(reference: models/modeling_qwen2.py:261-269); this framework supports them
natively with HF/Qwen2 semantics: query at global position p attends keys n
with p - window < n <= p (window includes the current token).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute import flash_attention_forward
from flash_attention_cute.ops.reference import attention_reference


def make_qkv(key, b, hq, hkv, sq, skv, d, dtype=jnp.float32):
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, hq, sq, d), dtype=jnp.float32)
    k = jax.random.normal(kk, (b, hkv, skv, d), dtype=jnp.float32)
    v = jax.random.normal(kv, (b, hkv, skv, d), dtype=jnp.float32)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype)


def naive_windowed(q, k, v, window, causal=True):
    """Independent oracle: dense softmax with an explicit window mask."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hkv != hq:
        k = jnp.repeat(k, hq // hkv, axis=1)
        v = jnp.repeat(v, hq // hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * (d ** -0.5)
    rows = jnp.arange(sq)[:, None] + (skv - sq)  # global q positions
    cols = jnp.arange(skv)[None, :]
    ok = cols > rows - window
    if causal:
        ok &= cols <= rows
    s = jnp.where(ok[None, None], s, -jnp.inf)
    p = jax.nn.softmax(s, axis=-1)
    p = jnp.where(jnp.any(ok, axis=-1)[None, None, :, None], p, 0.0)
    return jnp.einsum("bhqk,bhkd->bhqd", p, v)


@pytest.mark.parametrize("window", [1, 32, 100, 1000])
def test_reference_windowed_vs_naive(window):
    q, k, v = make_qkv(jax.random.key(0), 1, 2, 2, 200, 200, 64)
    ref = attention_reference(q, k, v, causal=True, window=window)
    naive = naive_windowed(q, k, v, window)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(naive),
                               atol=2e-5, rtol=2e-2)


@pytest.mark.parametrize("sq,skv", [(256, 256), (128, 512), (333, 333)])
@pytest.mark.parametrize("window", [64, 200])
def test_fwd_kernel_windowed(sq, skv, window):
    q, k, v = make_qkv(jax.random.key(1), 2, 4, 2, sq, skv, 64)
    out = flash_attention_forward(q, k, v, causal=True, window=window)
    ref = attention_reference(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=2e-5, rtol=2e-2,
    )


def test_fwd_windowed_bf16_gqa7():
    """A window narrower than the sequence at Qwen2-7B's group 7, bf16."""
    q, k, v = make_qkv(jax.random.key(2), 1, 28, 4, 512, 512, 64,
                       jnp.bfloat16)
    out = flash_attention_forward(q, k, v, causal=True, window=96)
    ref = attention_reference(q, k, v, causal=True, window=96)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=2e-2, rtol=2e-2,
    )


@pytest.mark.parametrize("window", [64, 300])
@pytest.mark.parametrize("lengths", [[700, 100], [512, 1024]])
def test_decode_kernel_windowed(window, lengths):
    b = len(lengths)
    q, k, v = make_qkv(jax.random.key(3), b, 8, 2, 1, 1024, 64)
    kv_length = jnp.array(lengths, jnp.int32)
    out = flash_attention_forward(
        q, k, v, kv_length=kv_length, window=window,
    )
    ref = attention_reference(
        q, k, v, causal=False, kv_length=kv_length, window=window
    )
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=2e-5, rtol=2e-2,
    )


def test_qwen2_sliding_window_model():
    """Two-segment scan: full-attention layers below max_window_layers,
    windowed layers above; prefill+decode consistency vs dense forward."""
    from flash_attention_cute.models import forward, init_params
    from flash_attention_cute.models.cache import KVCache
    from flash_attention_cute.models.config import tiny_test_config

    cfg = tiny_test_config(
        num_layers=4,
        sliding_window=16,
        use_sliding_window=True,
        max_window_layers=2,
        attention_bias=True,
    )
    params = init_params(cfg, jax.random.key(0))
    ids = jax.random.randint(jax.random.key(1), (2, 48), 0, cfg.vocab_size)

    cache = KVCache.create(cfg, batch=2, capacity=64)
    logits, cache = forward(params, cfg, ids, cache=cache, mode="prefill")
    assert np.isfinite(np.asarray(logits)).all()

    # Decode one token; compare against re-running prefill on the extended
    # sequence (positions beyond the window must not influence the result).
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    step_logits, cache = forward(
        params, cfg, nxt[:, None], cache=cache, mode="decode"
    )
    ids2 = jnp.concatenate([ids, nxt[:, None]], axis=1)
    full_logits, _ = forward(params, cfg, ids2, mode="prefill")
    np.testing.assert_allclose(
        np.asarray(step_logits[:, 0]), np.asarray(full_logits[:, -1]),
        atol=2e-4, rtol=2e-2,
    )


def test_qwen2_config_accepts_sliding_window():
    """The reference raises on use_sliding_window
    (models/modeling_qwen2.py:261-269); we accept and record it."""
    from flash_attention_cute.models.qwen2 import qwen2_config_from_hf

    cfg = qwen2_config_from_hf(dict(
        vocab_size=1000, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        use_sliding_window=True, sliding_window=1024, max_window_layers=2,
    ))
    assert cfg.use_sliding_window and cfg.sliding_window == 1024
    assert cfg.max_window_layers == 2
