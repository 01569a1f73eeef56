"""Chunked prefill ("extend") through the dense route vs the fp32 oracle.

Covers the "extend" serving path: a chunk of S queries attending over a
fixed-capacity cache with per-sequence valid lengths and offsets —
capabilities beyond the reference repo (varlen/paged are open TODOs,
reference: README.md:18-21).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.api import flash_attention_forward
from flash_attention_cute.ops.reference import attention_reference


def make(key, b, hq, hkv, sq, cap, d, dtype=jnp.float32):
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, hq, sq, d), jnp.float32).astype(dtype)
    k = jax.random.normal(kk, (b, hkv, cap, d), jnp.float32).astype(dtype)
    v = jax.random.normal(kv, (b, hkv, cap, d), jnp.float32).astype(dtype)
    return q, k, v


def check(q, k, v, **kw):
    out = flash_attention_forward(q, k, v, **kw)
    ref = attention_reference(q, k, v, **kw)
    atol = 2e-2 if q.dtype == jnp.bfloat16 else 2e-5
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=atol, rtol=2e-2,
    )
    return out


def test_chunked_large_scores():
    """Activation-scale scores (tens of nats, like real layer inputs)
    stay exact vs the fp32 oracle."""
    ks = jax.random.split(jax.random.key(3), 3)
    b, hq, hkv, s, c, d = 1, 4, 2, 64, 512, 64
    q = jax.random.normal(ks[0], (b, hq, s, d)) * 6.0
    k = jax.random.normal(ks[1], (b, hkv, c, d)) * 6.0
    v = jax.random.normal(ks[2], (b, hkv, c, d))
    qo = jnp.array([300], jnp.int32)
    check(q, k, v, causal=True, kv_length=qo + s, q_offset=qo)


@pytest.mark.parametrize("offsets", [[0, 0], [100, 37], [250, 0]])
@pytest.mark.parametrize("sq", [64, 130])
def test_chunked_matches_reference(offsets, sq):
    b, hq, hkv, cap, d = len(offsets), 4, 2, 512, 64
    q, k, v = make(jax.random.key(0), b, hq, hkv, sq, cap, d)
    q_off = jnp.array(offsets, jnp.int32)
    check(q, k, v, causal=True, kv_length=q_off + sq, q_offset=q_off)


def test_chunked_equals_static_prefill_at_offset_zero():
    """offset=0, full-length chunk == ordinary causal prefill."""
    b, hq, hkv, s, d = 2, 4, 2, 256, 64
    q, k, v = make(jax.random.key(1), b, hq, hkv, s, s, d)
    out = flash_attention_forward(
        q, k, v, causal=True, q_offset=jnp.zeros((b,), jnp.int32),
        kv_length=jnp.full((b,), s, jnp.int32),
    )
    want = flash_attention_forward(q, k, v, causal=True)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(want), atol=1e-5, rtol=1e-5
    )


def test_chunked_windowed():
    b, hq, hkv, sq, cap, d = 2, 4, 2, 128, 512, 64
    q, k, v = make(jax.random.key(2), b, hq, hkv, sq, cap, d)
    q_off = jnp.array([200, 64], jnp.int32)
    check(q, k, v, causal=True, kv_length=q_off + sq, q_offset=q_off,
          window=80)


def test_chunked_noncausal_length_mask_only():
    b, hq, hkv, sq, cap, d = 2, 2, 2, 64, 256, 64
    q, k, v = make(jax.random.key(3), b, hq, hkv, sq, cap, d)
    check(q, k, v, causal=False, kv_length=jnp.array([100, 256], jnp.int32))


def test_api_derives_offset_from_kv_length():
    """kv_length without q_offset puts the chunk at the end of each row's
    valid prefix (q_offset = kv_length - Sq)."""
    b, hq, hkv, sq, cap, d = 2, 4, 2, 32, 128, 32
    q, k, v = make(jax.random.key(5), b, hq, hkv, sq, cap, d)
    kv_len = jnp.array([42, 96], jnp.int32)
    out = flash_attention_forward(q, k, v, causal=True, kv_length=kv_len)
    ref = attention_reference(
        q, k, v, causal=True, kv_length=kv_len, q_offset=kv_len - sq
    )
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=2e-5, rtol=2e-2,
    )


def test_chunked_logit_softcap():
    b, hq, hkv, sq, cap, d = 2, 4, 2, 64, 256, 64
    q, k, v = make(jax.random.key(6), b, hq, hkv, sq, cap, d)
    q_off = jnp.array([100, 0], jnp.int32)
    check(q, k, v, causal=True, kv_length=q_off + sq, q_offset=q_off,
          logit_softcap=25.0)


def test_chunked_inactive_rows_emit_zeros():
    """kv_length == 0 rows (inactive serving slots) see no key."""
    b, hq, hkv, sq, cap, d = 2, 4, 2, 16, 64, 32
    q, k, v = make(jax.random.key(7), b, hq, hkv, sq, cap, d)
    q_off = jnp.array([0, 10], jnp.int32)
    out = check(q, k, v, causal=True, q_offset=q_off,
                kv_length=jnp.array([0, 26], jnp.int32))
    np.testing.assert_array_equal(np.asarray(out[0]), 0.0)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (28, 4), (8, 1)],
                         ids=["mha", "gqa4", "gqa7", "mqa8"])
def test_chunked_gqa_groups_bf16(hq, hkv):
    q, k, v = make(jax.random.key(8), 2, hq, hkv, 48, 256, 64, jnp.bfloat16)
    q_off = jnp.array([150, 7], jnp.int32)
    check(q, k, v, causal=True, kv_length=q_off + 48, q_offset=q_off)
