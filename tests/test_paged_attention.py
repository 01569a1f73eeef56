"""Paged decode (both routes) + paged cache vs the dense reference.

The oracle gathers each sequence's pages into a dense cache and runs the
fp32 reference — so these tests check both the in-place page reads and
the online softmax against ground truth. Every case runs on both routes:
"triton" is the Pallas kernel on the CPU interpreter, "xla" the gather +
dense route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.ops.paged_attention import (
    decode_tiling,
    paged_attention_decode,
)
from flash_attention_cute.ops.reference import attention_reference
from flash_attention_cute.runtime.paged_cache import (
    PageAllocator,
    PagedKVState,
    create_paged_state,
    paged_append_layer,
)


def build_paged(key, b, hkv, lengths, page_size, num_pages, pages_per_seq, d,
                dtype=jnp.float32, shuffle_seed=0):
    """Random paged cache with a scattered (shuffled) page assignment.

    Returns (k_pages, v_pages, page_table, dense_k, dense_v).
    """
    rng = np.random.RandomState(shuffle_seed)
    max_len = max(lengths)
    kk, kv = jax.random.split(key)
    dense_k = jax.random.normal(kk, (b, hkv, max_len, d), jnp.float32)
    dense_v = jax.random.normal(kv, (b, hkv, max_len, d), jnp.float32)

    k_pages = np.zeros((hkv, num_pages, page_size, d), np.float32)
    v_pages = np.zeros((hkv, num_pages, page_size, d), np.float32)
    table = np.zeros((b, pages_per_seq), np.int32)

    free = list(rng.permutation(np.arange(1, num_pages)))
    for bi, ln in enumerate(lengths):
        n_pages = -(-ln // page_size)
        for pi in range(n_pages):
            page = free.pop()
            table[bi, pi] = page
            lo = pi * page_size
            hi = min(lo + page_size, ln)
            k_pages[:, page, : hi - lo] = np.asarray(dense_k[bi, :, lo:hi])
            v_pages[:, page, : hi - lo] = np.asarray(dense_v[bi, :, lo:hi])

    return (
        jnp.asarray(k_pages, dtype),
        jnp.asarray(v_pages, dtype),
        jnp.asarray(table),
        dense_k.astype(dtype),
        dense_v.astype(dtype),
    )


ROUTES = pytest.mark.parametrize("interpret", [True, False],
                                 ids=["triton", "xla"])


def check_paged(b, hq, hkv, lengths, interpret, page_size=16, d=64,
                dtype=jnp.float32, pages_per_seq=None, **kw):
    max_len = max(max(lengths), 1)
    pages_per_seq = pages_per_seq or -(-max_len // page_size)
    num_pages = 1 + sum(-(-ln // page_size) for ln in lengths) + 3
    key = jax.random.key(hash((b, hq, max_len)) % (2**31))
    k_pages, v_pages, table, dense_k, dense_v = build_paged(
        key, b, hkv, [max(ln, 1) for ln in lengths], page_size, num_pages,
        pages_per_seq, d, dtype,
    )
    q = jax.random.normal(jax.random.key(7), (b, hq, 1, d), jnp.float32).astype(dtype)
    lens = jnp.asarray(lengths, jnp.int32)

    got = paged_attention_decode(
        q, k_pages, v_pages, lens, table, interpret=interpret, **kw
    )
    want = attention_reference(q, dense_k, dense_v, kv_length=lens, **kw)
    atol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        atol=atol, rtol=2e-2,
    )
    return got


@ROUTES
def test_basic_mha(interpret):
    check_paged(2, 4, 4, [64, 64], interpret)


@ROUTES
@pytest.mark.parametrize("hq,hkv", [(8, 2), (28, 4), (8, 1), (32, 4)],
                         ids=["gqa4", "gqa7", "mqa8", "gqa8"])
def test_gqa_packing(interpret, hq, hkv):
    check_paged(2, hq, hkv, [128, 96], interpret)


@ROUTES
def test_ragged_lengths_cross_page(interpret):
    # lengths that straddle page boundaries
    check_paged(3, 8, 2, [17, 33, 127], interpret, page_size=16)


@ROUTES
def test_length_one(interpret):
    check_paged(2, 8, 2, [1, 50], interpret)


@ROUTES
def test_multiple_compute_blocks(interpret):
    check_paged(2, 4, 4, [512, 300], interpret, page_size=32)


@ROUTES
def test_bf16(interpret):
    check_paged(2, 8, 2, [200, 333], interpret, page_size=16,
                dtype=jnp.bfloat16, d=128)


@ROUTES
@pytest.mark.parametrize("page_size", [16, 64, 128])
def test_page_sizes(interpret, page_size):
    check_paged(2, 28, 4, [300, 129], interpret, page_size=page_size)


@ROUTES
def test_oversized_pages_take_xla_route(interpret):
    """fp32 pages of 128 tokens at head_dim 256 overflow shared memory;
    the call falls back to the gather route and stays exact."""
    check_paged(2, 4, 2, [200, 129], interpret, page_size=128, d=256)


@ROUTES
def test_zero_length_sequence(interpret):
    """An empty slot (length 0, table row on the null page) must emit
    exact zeros, not NaN."""
    got = check_paged(3, 4, 2, [0, 64, 0], interpret, pages_per_seq=4)
    assert np.isfinite(np.asarray(got)).all()
    np.testing.assert_array_equal(np.asarray(got[0]), 0.0)
    np.testing.assert_array_equal(np.asarray(got[2]), 0.0)


@ROUTES
@pytest.mark.parametrize("window", [1, 50])
def test_paged_decode_windowed(interpret, window):
    """Sliding window over pages: only the last W tokens attend; the
    kernel starts each sequence at its window's first live page."""
    check_paged(3, 8, 2, [100, 37, 128], interpret, window=window)


@ROUTES
def test_paged_decode_logit_softcap(interpret):
    check_paged(2, 4, 2, [60, 17], interpret, logit_softcap=15.0)


@pytest.mark.parametrize(
    "batch,hkv,group,page_size,head_dim,pps,itemsize",
    [(1, 4, 7, 16, 128, 1024, 2), (32, 8, 4, 64, 128, 64, 2),
     (8, 8, 2, 128, 256, 128, 2), (4, 2, 24, 16, 64, 4, 2),
     (64, 8, 1, 128, 128, 2, 2), (4, 4, 7, 64, 128, 32, 4),
     (4, 4, 7, 128, 256, 32, 4)],
)
def test_decode_tiling_fits_hopper(batch, hkv, group, page_size, head_dim,
                                   pps, itemsize):
    """Tiles are powers of two, the GQA group pads to at least the
    16-row tensor-core tile, K/V tiles (double-buffered) fit a block's
    227 KB of shared memory, and splits never exceed the blocks. A shape
    whose single page overflows shared memory gets no tiling (the call
    takes the XLA route)."""
    t = decode_tiling(batch, hkv, group, page_size, head_dim, pps, itemsize)
    if t is None:
        assert 2 * page_size * head_dim * itemsize > 200 * 1024
        return
    bh, ppb, ks = t["block_h"], t["pages_per_block"], t["k_splits"]
    assert bh >= max(16, group) and bh & (bh - 1) == 0
    assert ppb & (ppb - 1) == 0
    block_k = ppb * page_size
    assert t["num_stages"] * 2 * block_k * head_dim * itemsize <= 227 * 1024
    assert 1 <= ks <= -(-pps // ppb)


def test_paged_append_roundtrip():
    """paged_append_layer scatter must reproduce the dense layout."""
    cfg_like = type("C", (), dict(num_layers=1, num_kv_heads=2, head_dim=32))
    b, hkv, ps, d = 2, 2, 16, 32
    state = create_paged_state(cfg_like, num_pages=8, page_size=ps, batch=b,
                               pages_per_seq=4, dtype=jnp.float32)
    table = jnp.array([[1, 2, 0, 0], [3, 4, 0, 0]], jnp.int32)

    k1 = jax.random.normal(jax.random.key(0), (b, hkv, 20, d))
    v1 = jax.random.normal(jax.random.key(1), (b, hkv, 20, d))
    kp, vp = paged_append_layer(
        state.k_pages[0], state.v_pages[0], k1, v1, table,
        jnp.zeros((b,), jnp.int32),
    )
    # token 0..15 -> first page, 16..19 -> second page
    np.testing.assert_allclose(np.asarray(kp[:, 1]), np.asarray(k1[0, :, :16]))
    np.testing.assert_allclose(np.asarray(kp[:, 2, :4]), np.asarray(k1[0, :, 16:20]))
    np.testing.assert_allclose(np.asarray(vp[:, 3]), np.asarray(v1[1, :, :16]))

    # decode-step append at offset 20
    k2 = jax.random.normal(jax.random.key(2), (b, hkv, 1, d))
    kp2, _ = paged_append_layer(kp, vp, k2, k2, table, jnp.full((b,), 20, jnp.int32))
    np.testing.assert_allclose(np.asarray(kp2[:, 2, 4]), np.asarray(k2[0, :, 0]))
    np.testing.assert_allclose(np.asarray(kp2[:, 4, 4]), np.asarray(k2[1, :, 0]))


def test_page_allocator():
    alloc = PageAllocator(num_pages=16, page_size=16, pages_per_seq=8)
    assert alloc.num_free == 15
    assert alloc.allocate(seq_id=1, cur_len=0, new_tokens=40)  # 3 pages
    assert alloc.num_free == 12
    assert alloc.allocate(seq_id=1, cur_len=40, new_tokens=8)  # same page
    assert alloc.num_free == 12
    assert alloc.allocate(seq_id=1, cur_len=48, new_tokens=1)  # new page
    assert alloc.num_free == 11
    row = alloc.table_row(1)
    assert (row[:4] > 0).all() and (row[4:] == 0).all()
    alloc.release(1)
    assert alloc.num_free == 15
    # OOM path
    assert not alloc.allocate(seq_id=2, cur_len=0, new_tokens=16 * 16)




@pytest.mark.gpu
def test_paged_decode_runs_triton_on_gpu(gpu_device):
    """On the card, decode compiles the Triton kernel (no interpreter) and
    matches the oracle at Qwen2-7B widths with ragged and empty rows."""
    lengths = [3000, 0, 17, 1024, 2047, 64, 1, 999]
    got = check_paged(8, 28, 4, lengths, False, page_size=64, d=128,
                      dtype=jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(got[1], np.float32), 0.0)
    q = jnp.zeros((8, 28, 1, 128), jnp.bfloat16)
    kv = jnp.zeros((4, 8 * 48 + 1, 64, 128), jnp.bfloat16)
    text = jax.jit(paged_attention_decode).lower(
        q, kv, kv, jnp.asarray(lengths, jnp.int32),
        jnp.zeros((8, 48), jnp.int32),
    ).as_text()
    assert "__gpu$xla.gpu.triton" in text and "stablehlo.while" not in text
