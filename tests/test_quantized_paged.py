"""Quantized (int8 / fp8) paged attention vs the gathered-dequantized
dense oracle. Decode runs on both routes: the Triton kernel on the Pallas
interpreter (scales folded into its tiles) and the gather + dense route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.ops.paged_attention import (
    paged_attention_decode,
    paged_attention_extend,
)
from flash_attention_cute.ops.quantized import QuantizedKV, quantize_kv
from flash_attention_cute.ops.reference import attention_reference


def setup(key, b, hq, hkv, pages_per_seq, page_size, d, qdtype=jnp.int8):
    num_pages = b * pages_per_seq + 1
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, hq, 1, d), jnp.float32)
    k_dense = jax.random.normal(kk, (hkv, num_pages, page_size, d), jnp.float32)
    v_dense = jax.random.normal(kv, (hkv, num_pages, page_size, d), jnp.float32)
    kqz = quantize_kv(k_dense, qdtype)
    vqz = quantize_kv(v_dense, qdtype)
    tbl = jnp.arange(1, b * pages_per_seq + 1, dtype=jnp.int32).reshape(
        b, pages_per_seq
    )
    return q, kqz, vqz, tbl


def gather_dense(qz: QuantizedKV, tbl, page_size):
    """Dequantize + gather each sequence's pages into [B, Hkv, S, D]."""
    hkv, p, ps, d = qz.values.shape
    dense = qz.values.astype(jnp.float32) * qz.scales[..., None]
    flat = dense.reshape(hkv, p * ps, d)
    idx = (tbl * ps)[:, :, None] + jnp.arange(ps)[None, None, :]
    idx = idx.reshape(tbl.shape[0], -1)
    return jax.vmap(lambda f: flat[:, f])(idx)


ROUTES = pytest.mark.parametrize("interpret", [True, False],
                                 ids=["triton", "xla"])


@ROUTES
@pytest.mark.parametrize("lengths", [[40, 17], [64, 64], [33, 0]])
@pytest.mark.parametrize("qdtype", [jnp.int8, jnp.float8_e4m3fn])
def test_quant_paged_matches_oracle(lengths, qdtype, interpret):
    b, hq, hkv, pps, ps, d = len(lengths), 8, 2, 4, 16, 64
    q, kqz, vqz, tbl = setup(jax.random.key(0), b, hq, hkv, pps, ps, d, qdtype)
    lens = jnp.array(lengths, jnp.int32)

    out = paged_attention_decode(q, kqz, vqz, lens, tbl, interpret=interpret)
    kg = gather_dense(kqz, tbl, ps)
    vg = gather_dense(vqz, tbl, ps)
    ref = attention_reference(q, kg, vg, causal=False, kv_length=lens)
    # Rows with length 0 emit exact zeros.
    np.testing.assert_array_equal(
        np.asarray(out)[np.asarray(lens) == 0], 0.0)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=3e-3, rtol=2e-2,
    )


def setup_extend(key, b, hq, hkv, sq, pps, ps, d, qdtype=jnp.int8):
    num_pages = b * pps + 1
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, hq, sq, d), jnp.float32)
    k_dense = jax.random.normal(kk, (hkv, num_pages, ps, d), jnp.float32)
    v_dense = jax.random.normal(kv, (hkv, num_pages, ps, d), jnp.float32)
    kqz = quantize_kv(k_dense, qdtype)
    vqz = quantize_kv(v_dense, qdtype)
    tbl = jnp.arange(1, b * pps + 1, dtype=jnp.int32).reshape(b, pps)
    return q, kqz, vqz, tbl


@pytest.mark.parametrize("offsets", [[0, 0], [50, 17]])
@pytest.mark.parametrize("qdtype", [jnp.int8, jnp.float8_e4m3fn])
def test_quant_paged_extend_matches_oracle(offsets, qdtype):
    """Chunked prefill over quantized pages (round-1 NotImplementedError):
    per-row causality against the gathered-dequantized oracle."""
    b, hq, hkv, sq, pps, ps, d = len(offsets), 4, 2, 16, 16, 8, 64
    q, kqz, vqz, tbl = setup_extend(
        jax.random.key(2), b, hq, hkv, sq, pps, ps, d, qdtype
    )
    q_off = jnp.array(offsets, jnp.int32)
    kv_len = q_off + sq

    out = paged_attention_extend(
        q, kqz, vqz, q_off, kv_len, tbl,
    )
    kg = gather_dense(kqz, tbl, ps)
    vg = gather_dense(vqz, tbl, ps)
    ref = attention_reference(
        q, kg, vg, causal=True, kv_length=kv_len, q_offset=q_off
    )
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=3e-3, rtol=2e-2,
    )


def test_quant_paged_extend_windowed_and_inactive():
    """Sliding window composes with quantized extend; a kv_length == 0 slot
    emits zeros without stranding prefetch DMAs."""
    b, hq, hkv, sq, pps, ps, d = 3, 8, 2, 8, 16, 8, 64
    q, kqz, vqz, tbl = setup_extend(
        jax.random.key(3), b, hq, hkv, sq, pps, ps, d
    )
    window = 24
    q_off = jnp.array([60, 0, 4], jnp.int32)
    kv_len = jnp.array([60 + sq, 0, 4 + sq], jnp.int32)

    out = paged_attention_extend(
        q, kqz, vqz, q_off, kv_len, tbl, window=window,
    )
    np.testing.assert_array_equal(np.asarray(out[1]), 0.0)
    kg = gather_dense(kqz, tbl, ps)
    vg = gather_dense(vqz, tbl, ps)
    for s_ in (0, 2):
        ref = attention_reference(
            q[s_ : s_ + 1], kg[s_ : s_ + 1], vg[s_ : s_ + 1], causal=True,
            kv_length=kv_len[s_ : s_ + 1], q_offset=q_off[s_ : s_ + 1],
            window=window,
        )
        np.testing.assert_allclose(
            np.asarray(out[s_ : s_ + 1], np.float32),
            np.asarray(ref, np.float32), atol=3e-3, rtol=2e-2,
        )


@ROUTES
def test_quant_paged_windowed(interpret):
    b, hq, hkv, pps, ps, d = 2, 8, 2, 6, 16, 64
    q, kqz, vqz, tbl = setup(jax.random.key(4), b, hq, hkv, pps, ps, d)
    lens = jnp.array([90, 33], jnp.int32)
    window = 40
    out = paged_attention_decode(
        q, kqz, vqz, lens, tbl, window=window, interpret=interpret,
    )
    kg = gather_dense(kqz, tbl, ps)
    vg = gather_dense(vqz, tbl, ps)
    ref = attention_reference(
        q, kg, vg, causal=False, kv_length=lens, window=window
    )
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=3e-3, rtol=2e-2,
    )


@ROUTES
def test_quant_paged_decode_softcap(interpret):
    """Round-3: logit_softcap composes with int8 paged decode — compare
    against the dequantized oracle with the tanh cap applied to the
    scaled scores."""
    b, hq, hkv, pps, ps, d = 2, 8, 2, 4, 16, 64
    q, kqz, vqz, tbl = setup(jax.random.key(5), b, hq, hkv, pps, ps, d)
    lens = jnp.array([50, 23], jnp.int32)
    cap = 10.0

    out = paged_attention_decode(
        q, kqz, vqz, lens, tbl, logit_softcap=cap, interpret=interpret,
    )
    kg = gather_dense(kqz, tbl, ps)
    vg = gather_dense(vqz, tbl, ps)
    scale = d ** -0.5
    kf = jnp.repeat(kg, hq // hkv, 1)
    vf = jnp.repeat(vg, hq // hkv, 1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, kf) * scale
    s = jnp.tanh(s / cap) * cap
    cols = jnp.arange(kf.shape[2])[None, None, None, :]
    s = jnp.where(cols < lens[:, None, None, None], s, -jnp.inf)
    ref = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), vf)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=3e-3, rtol=2e-2,
    )


@ROUTES
@pytest.mark.parametrize("hq,hkv", [(28, 4), (8, 1)], ids=["gqa7", "mqa8"])
def test_quant_paged_gqa_groups_bf16(interpret, hq, hkv):
    """bf16 queries over int8 pages at GQA groups 7 and 8."""
    b, pps, ps, d = 2, 8, 16, 128
    q, kqz, vqz, tbl = setup(jax.random.key(1), b, hq, hkv, pps, ps, d)
    q = q.astype(jnp.bfloat16)
    lens = jnp.array([100, 29], jnp.int32)
    out = paged_attention_decode(q, kqz, vqz, lens, tbl, interpret=interpret)
    ref = attention_reference(
        q, gather_dense(kqz, tbl, ps).astype(q.dtype),
        gather_dense(vqz, tbl, ps).astype(q.dtype), kv_length=lens,
    )
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=3e-2, rtol=2e-2,
    )


def test_quant_paged_extend_large_chunk_gqa7():
    """A chunk longer than the prefix at GQA group 7."""
    b, hq, hkv, sq, pps, ps, d = 1, 28, 4, 96, 16, 8, 64
    q, kqz, vqz, tbl = setup_extend(
        jax.random.key(23), b, hq, hkv, sq, pps, ps, d
    )
    q_off = jnp.array([20], jnp.int32)
    kv_len = q_off + sq
    out = paged_attention_extend(q, kqz, vqz, q_off, kv_len, tbl)
    ref = attention_reference(
        q, gather_dense(kqz, tbl, ps), gather_dense(vqz, tbl, ps),
        causal=True, kv_length=kv_len, q_offset=q_off,
    )
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=3e-3, rtol=2e-2,
    )
