"""Varlen (packed ragged batch) attention vs per-sequence reference loop.

The reference repo lists varlen as an open TODO (reference: README.md:18);
the oracle here runs each sequence separately through the fp32 XLA
reference and re-packs — exactly the semantics the segment-masked route
must match.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute import flash_attention_varlen
from flash_attention_cute.ops.reference import attention_reference


def pack(key, lens_q, lens_kv, hq, hkv, d):
    kq, kk, kv = jax.random.split(key, 3)
    tq, tkv = sum(lens_q), sum(lens_kv)
    q = jax.random.normal(kq, (tq, hq, d), jnp.float32)
    k = jax.random.normal(kk, (tkv, hkv, d), jnp.float32)
    v = jax.random.normal(kv, (tkv, hkv, d), jnp.float32)
    cu_q = jnp.asarray(np.concatenate([[0], np.cumsum(lens_q)]), jnp.int32)
    cu_kv = jnp.asarray(np.concatenate([[0], np.cumsum(lens_kv)]), jnp.int32)
    return q, k, v, cu_q, cu_kv


def oracle(q, k, v, cu_q, cu_kv, causal, window=None):
    outs = []
    for i in range(len(cu_q) - 1):
        qs = q[int(cu_q[i]):int(cu_q[i + 1])]
        ks = k[int(cu_kv[i]):int(cu_kv[i + 1])]
        vs = v[int(cu_kv[i]):int(cu_kv[i + 1])]
        # [S, H, D] -> [1, H, S, D]
        o = attention_reference(
            jnp.swapaxes(qs, 0, 1)[None],
            jnp.swapaxes(ks, 0, 1)[None],
            jnp.swapaxes(vs, 0, 1)[None],
            causal=causal, window=window,
        )
        outs.append(jnp.swapaxes(o[0], 0, 1))
    return jnp.concatenate(outs, axis=0)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_equal_lengths(causal):
    lens = [100, 37, 256, 1]
    q, k, v, cu_q, cu_kv = pack(jax.random.key(0), lens, lens, 4, 2, 64)
    out = flash_attention_varlen(
        q, k, v, cu_q, causal=causal,
    )
    want = oracle(q, k, v, cu_q, cu_kv, causal)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(want, np.float32),
        atol=2e-5, rtol=2e-2,
    )


def test_varlen_cross_lengths_bottom_right():
    """Sq != Skv per sequence: bottom-right alignment inside each sequence,
    including a fully-masked-rows case (q longer than kv)."""
    lens_q = [64, 200, 32]
    lens_kv = [128, 100, 32]
    q, k, v, cu_q, cu_kv = pack(
        jax.random.key(1), lens_q, lens_kv, 4, 4, 64
    )
    out = flash_attention_varlen(
        q, k, v, cu_q, cu_seqlens_kv=cu_kv, causal=True,
    )
    want = oracle(q, k, v, cu_q, cu_kv, True)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(want, np.float32),
        atol=2e-5, rtol=2e-2,
    )
    # Sequence 1 has q_len 200 > kv_len 100: first 100 rows exact zero.
    s1 = np.asarray(out[int(cu_q[1]):int(cu_q[1]) + 100])
    np.testing.assert_array_equal(s1, 0.0)


def test_varlen_windowed():
    lens = [300, 80]
    q, k, v, cu_q, cu_kv = pack(jax.random.key(2), lens, lens, 4, 2, 64)
    out = flash_attention_varlen(
        q, k, v, cu_q, causal=True, window=64,
    )
    want = oracle(q, k, v, cu_q, cu_kv, True, window=64)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(want, np.float32),
        atol=2e-5, rtol=2e-2,
    )


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (28, 4), (8, 1)],
                         ids=["mha", "gqa4", "gqa7", "mqa8"])
def test_varlen_gqa_groups(hq, hkv):
    lens = [130, 70, 56]
    q, k, v, cu_q, cu_kv = pack(jax.random.key(3), lens, lens, hq, hkv, 32)
    out = flash_attention_varlen(q, k, v, cu_q, causal=True)
    want = oracle(q, k, v, cu_q, cu_kv, True)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(want, np.float32),
        atol=2e-5, rtol=2e-2,
    )


def test_varlen_single_sequence_equals_dense():
    from flash_attention_cute import flash_attention_forward

    s, h, d = 256, 4, 64
    q, k, v, cu_q, _ = pack(jax.random.key(4), [s], [s], h, h, d)
    out = flash_attention_varlen(q, k, v, cu_q, causal=True)
    want = flash_attention_forward(
        jnp.swapaxes(q, 0, 1)[None], jnp.swapaxes(k, 0, 1)[None],
        jnp.swapaxes(v, 0, 1)[None], causal=True,
    )
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(jnp.swapaxes(want[0], 0, 1)),
        atol=1e-5, rtol=1e-5,
    )


def test_varlen_padding_tokens_emit_zeros():
    """Packed buffers padded past cu_seqlens[-1]: the padding rows attend
    nothing (zeros) and do not leak into real sequences."""
    lens = [50, 30]
    q, k, v, cu_q, cu_kv = pack(jax.random.key(5), lens + [20], lens + [20],
                                4, 2, 32)
    cu = cu_q[:-1]
    out = flash_attention_varlen(q, k, v, cu, causal=True)
    np.testing.assert_array_equal(np.asarray(out[80:]), 0.0)
    want = oracle(q[:80], k[:80], v[:80], cu, cu, True)
    np.testing.assert_allclose(
        np.asarray(out[:80], np.float32), np.asarray(want, np.float32),
        atol=2e-5, rtol=2e-2,
    )


def test_varlen_banded_unequal_lengths():
    """cu_seqlens_kv != cu_seqlens_q (kv longer than q — chunked-prefill
    packing): each q token sees its own sequence's whole kv prefix."""
    lens_q = [16] * 8
    lens_kv = [256] * 8
    q, k, v, cu_q, cu_kv = pack(
        jax.random.key(7), lens_q, lens_kv, 4, 2, 64
    )
    out = flash_attention_varlen(
        q, k, v, cu_q, cu_seqlens_kv=cu_kv, causal=True,
    )
    want = oracle(q, k, v, cu_q, cu_kv, True)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(want, np.float32),
        atol=2e-5, rtol=2e-2,
    )


def test_varlen_large_scores():
    """Activation-scale score magnitudes stay exact vs the oracle."""
    lens = [100, 37, 256, 90]
    q, k, v = pack(jax.random.key(8), lens, lens, 4, 2, 64)[:3]
    cu = jnp.asarray(np.concatenate([[0], np.cumsum(lens)]), jnp.int32)
    out = flash_attention_varlen(q * 6.0, k * 6.0, v, cu, causal=True)
    want = oracle(q * 6.0, k * 6.0, v, cu, cu, True)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(want, np.float32),
        atol=2e-4, rtol=2e-2,
    )


def test_varlen_logit_softcap():
    lens = [90, 40]
    q, k, v, cu_q, cu_kv = pack(jax.random.key(6), lens, lens, 4, 2, 64)
    out = flash_attention_varlen(q, k, v, cu_q, causal=True,
                                 logit_softcap=20.0)
    want = []
    for i in range(2):
        a, b = int(cu_q[i]), int(cu_q[i + 1])
        o = attention_reference(
            jnp.swapaxes(q[a:b], 0, 1)[None], jnp.swapaxes(k[a:b], 0, 1)[None],
            jnp.swapaxes(v[a:b], 0, 1)[None], causal=True, logit_softcap=20.0,
        )
        want.append(jnp.swapaxes(o[0], 0, 1))
    want = jnp.concatenate(want, axis=0)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(want, np.float32),
        atol=2e-5, rtol=2e-2,
    )
