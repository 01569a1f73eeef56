"""Attention over a paged KV cache: decode and extend.

The cache lives in device memory as fixed-size pages scattered by a
per-sequence page table:

  q:            [B, Hq, S, D]
  k_pages:      [Hkv, num_pages, page_size, D], or a `QuantizedKV` whose
                values have that shape (int8 / fp8) and whose scales are
                [Hkv, num_pages, page_size] f32
  v_pages:      like k_pages
  lengths:      [B] int32 valid tokens per sequence (0 = empty slot, whose
                output is exact zeros)
  page_table:   [B, pages_per_seq] int32 physical page ids (padding
                entries must be valid ids, e.g. the null page 0; they are
                masked, never used)

Two routes, picked by `dispatch.select_routes`:

  * "triton" (decode on the GPU): a Pallas kernel on the Triton route that
    reads the pages in place through the page table. Each program takes
    one (sequence, KV head, KV split): it loads its own page ids, gathers
    `pages_per_block` pages per step, and runs an online softmax for the
    whole GQA group (padded to 16 rows, the smallest tensor-core tile).
    The splits' partial (o, m, l) are combined in XLA. It follows the
    design of JAX's library kernel
    `jax/experimental/pallas/ops/gpu/paged_attention.py` and adds sliding
    windows, in-kernel softmax scaling, fp32 partials and exact zeros for
    empty rows.
  * "xla": gather each row's pages into a contiguous [B, Hkv, S, D] copy,
    then the grouped XLA attention of ops/attention.py. Extend always
    takes it: a chunk of S queries amortises the gather S-fold.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from flash_attention_cute import dispatch
from flash_attention_cute.ops.attention import xla_attention
from flash_attention_cute.ops.quantized import QuantizedKV

# Programs the decode grid aims for: two per SM of an H100 (132 SMs), so
# short batches still fill the card through KV splits.
TARGET_PROGRAMS = 264
MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def decode_tiling(batch: int, hkv: int, group: int, page_size: int,
                  head_dim: int, pages_per_seq: int, itemsize: int = 2) -> dict:
    """Static tile choice of the Triton decode kernel for one shape.

    block_h: the GQA group padded to a power of two of at least 16 rows.
    pages_per_block: pages gathered per step, so that one K (or V) tile of
      `itemsize`-byte elements holds at most 32 KB and 128 tokens (a step
      never splits a page).
    num_stages: 2 (the next step's K/V load overlaps this step's math)
      when two copies of the K and V tiles fit a block's 227 KB of shared
      memory, else 1.
    k_splits: KV splits per (sequence, KV head), so that the grid has
      about TARGET_PROGRAMS programs.

    None when one page of K and V alone overflows shared memory (fp32
    pages of 128 tokens at head_dim 256): that call takes the XLA route.
    """
    tokens = min(128, 32768 // (head_dim * itemsize))
    ppb = max(1, min(tokens // page_size, _next_pow2(pages_per_seq)))
    tile_bytes = 2 * ppb * page_size * head_dim * itemsize  # K and V
    if tile_bytes > 200 * 1024:
        return None
    blocks = -(-pages_per_seq // ppb)
    k_splits = max(1, min(-(-TARGET_PROGRAMS // (batch * hkv)), blocks))
    return dict(
        block_h=max(16, _next_pow2(group)),
        pages_per_block=ppb,
        num_stages=2 if 2 * tile_bytes <= 200 * 1024 else 1,
        k_splits=k_splits,
    )


def _decode_kernel(
    lengths_ref,  # [1] this sequence's length
    table_ref,  # [pages_per_seq + pages_per_block] this sequence's pages
    q_ref,  # [block_h, D]
    k_ref,  # [P, page_size, D] this KV head's pages
    v_ref,
    *rest,  # (k_scales_ref, v_scales_ref,) o_ref, m_ref, l_ref
    sm_scale: float,
    window: int | None,
    logit_softcap: float | None,
    pages_per_block: int,
    k_splits: int,
    quantized: bool,
):
    if quantized:
        ks_ref, vs_ref, o_ref, m_ref, l_ref = rest
    else:
        o_ref, m_ref, l_ref = rest
    split = pl.program_id(2)
    block_h, d = q_ref.shape
    page_size = k_ref.shape[1]
    block_k = pages_per_block * page_size

    length = lengths_ref[0]
    n_pages = pl.cdiv(length, page_size)
    first_page = 0
    if window is not None:
        first_page = jnp.maximum(length - window, 0) // page_size
    # Live pages split evenly (in whole blocks) over the k_splits programs;
    # every page in [first_page, n_pages) holds at least one visible key.
    per_split = pl.cdiv(
        pl.cdiv(n_pages - first_page, k_splits), pages_per_block
    ) * pages_per_block
    lo = first_page + split * per_split
    hi = jnp.minimum(lo + per_split, n_pages)
    n_blocks = pl.cdiv(jnp.maximum(hi - lo, 0), pages_per_block)

    q = q_ref[...]
    precision = (
        jax.lax.Precision.HIGHEST if q.dtype == jnp.float32 else None
    )

    def body(i, carry):
        o, m, l = carry
        start = lo + i * pages_per_block
        pages = table_ref[pl.ds(start, pages_per_block)]
        k = k_ref[pages].reshape(block_k, d).astype(q.dtype)
        v = v_ref[pages].reshape(block_k, d).astype(q.dtype)
        s = pl.dot(q, k, trans_b=True, precision=precision) * sm_scale
        if quantized:
            ks = ks_ref[pages].reshape(1, block_k)
            s = s * ks
        if logit_softcap is not None:
            s = jnp.tanh(s / logit_softcap) * logit_softcap
        pos = start * page_size + jax.lax.broadcasted_iota(
            jnp.int32, (block_h, block_k), 1
        )
        visible = pos < length
        if window is not None:
            visible = visible & (pos >= length - window)
        s = jnp.where(visible, s, MASK_VALUE)
        m_next = jnp.maximum(m, s.max(axis=-1))
        alpha = jnp.exp(m - m_next)
        p = jnp.where(visible, jnp.exp(s - m_next[:, None]), 0.0)
        l_next = alpha * l + p.sum(axis=-1)
        if quantized:
            p = p * vs_ref[pages].reshape(1, block_k)
        o_next = alpha[:, None] * o + pl.dot(
            p.astype(v.dtype), v, precision=precision
        )
        return o_next, m_next, l_next

    o0 = jnp.zeros((block_h, d), jnp.float32)
    m0 = jnp.full((block_h,), -jnp.inf, jnp.float32)
    l0 = jnp.zeros((block_h,), jnp.float32)
    o, m, l = jax.lax.fori_loop(0, n_blocks, body, (o0, m0, l0))
    o_ref[...] = o
    m_ref[...] = m
    l_ref[...] = l


def _tiling_for(q, k_pages, page_table):
    kv = k_pages.values if isinstance(k_pages, QuantizedKV) else k_pages
    hkv, _, page_size, d = kv.shape
    # K/V tiles are held in the query's dtype once loaded.
    itemsize = max(kv.dtype.itemsize, q.dtype.itemsize)
    return decode_tiling(q.shape[0], hkv, q.shape[1] // hkv, page_size, d,
                         page_table.shape[1], itemsize)


def paged_decode_triton(q, k_pages, v_pages, lengths, page_table, sm_scale,
                        window, logit_softcap, interpret):
    """The Triton-route decode kernel plus the XLA combine of its splits
    (layouts: module docstring). The `paged_attention_decode` route when
    `select_routes` picks "triton" and the tiles fit (`decode_tiling`)."""
    quantized = isinstance(k_pages, QuantizedKV)
    kv = k_pages.values if quantized else k_pages
    b, hq, _, d = q.shape
    hkv, num_pages, page_size, _ = kv.shape
    g = hq // hkv
    pages_per_seq = page_table.shape[1]
    t = _tiling_for(q, k_pages, page_table)
    block_h, ppb, k_splits = t["block_h"], t["pages_per_block"], t["k_splits"]

    qp = q.reshape(b, hkv, g, d)
    if block_h != g:
        qp = jnp.pad(qp, ((0, 0), (0, 0), (0, block_h - g), (0, 0)))
    # A step may read up to pages_per_block entries past the last live
    # page: pad with the null page (its keys are masked).
    table = jnp.pad(page_table.astype(jnp.int32), ((0, 0), (0, ppb)))
    lengths = jnp.minimum(lengths.astype(jnp.int32), pages_per_seq * page_size)

    pages_spec = pl.BlockSpec(
        (None, num_pages, page_size, d), lambda i, h, s: (h, 0, 0, 0)
    )
    scales_spec = pl.BlockSpec(
        (None, num_pages, page_size), lambda i, h, s: (h, 0, 0)
    )
    in_specs = [
        pl.BlockSpec((1,), lambda i, h, s: (i,)),
        pl.BlockSpec((None, pages_per_seq + ppb), lambda i, h, s: (i, 0)),
        pl.BlockSpec((None, None, block_h, d), lambda i, h, s: (i, h, 0, 0)),
        pages_spec,
        pages_spec,
    ]
    args = [lengths, table, qp]
    if quantized:
        in_specs += [scales_spec, scales_spec]
        args += [k_pages.values, v_pages.values, k_pages.scales,
                 v_pages.scales]
    else:
        args += [k_pages, v_pages]
    part = (b, hkv, k_splits, block_h)
    o, m, l = pl.pallas_call(
        functools.partial(
            _decode_kernel,
            sm_scale=sm_scale,
            window=window,
            logit_softcap=logit_softcap,
            pages_per_block=ppb,
            k_splits=k_splits,
            quantized=quantized,
        ),
        grid=(b, hkv, k_splits),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec(
                (None, None, None, block_h, d), lambda i, h, s: (i, h, s, 0, 0)
            ),
            pl.BlockSpec((None, None, None, block_h), lambda i, h, s: (i, h, s, 0)),
            pl.BlockSpec((None, None, None, block_h), lambda i, h, s: (i, h, s, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct(part + (d,), jnp.float32),
            jax.ShapeDtypeStruct(part, jnp.float32),
            jax.ShapeDtypeStruct(part, jnp.float32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=4, num_stages=t["num_stages"]
        ),
        interpret=interpret,
        name="paged_attention_decode",
    )(*args)

    # Combine the splits' partials; splits with no keys carry m = -inf.
    m_max = m.max(axis=2, keepdims=True)
    w = jnp.exp(m - jnp.where(jnp.isfinite(m_max), m_max, 0.0))
    l_tot = (w * l).sum(axis=2)
    o_tot = (w[..., None] * o).sum(axis=2)
    inv = jnp.where(l_tot == 0.0, 0.0, 1.0 / jnp.where(l_tot == 0.0, 1.0, l_tot))
    out = o_tot * inv[..., None]
    return out[:, :, :g].reshape(b, hq, 1, d).astype(q.dtype)


def gather_pages(pages, page_table: jax.Array, dtype) -> jax.Array:
    """[Hkv, P, page_size, D] pages (or a QuantizedKV of them) -> each
    row's contiguous [B, Hkv, pages_per_seq * page_size, D] copy in
    `dtype`, dequantized on the way."""
    b, pps = page_table.shape
    if isinstance(pages, QuantizedKV):
        vals = jnp.moveaxis(pages.values[:, page_table], 1, 0)
        scl = jnp.moveaxis(pages.scales[:, page_table], 1, 0)
        x = vals.astype(jnp.float32) * scl[..., None]
    else:
        x = jnp.moveaxis(pages[:, page_table], 1, 0)
    hkv, _, ps, d = x.shape[1:]
    return x.reshape(b, hkv, pps * ps, d).astype(dtype)


@functools.partial(
    jax.jit,
    static_argnames=("sm_scale", "window", "logit_softcap", "interpret"),
)
def paged_attention_decode(
    q: jax.Array,
    k_pages,
    v_pages,
    lengths: jax.Array,
    page_table: jax.Array,
    sm_scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    interpret: bool = False,
) -> jax.Array:
    """Single-token decode over a paged KV cache (layouts: module
    docstring). q [B, Hq, 1, D] -> [B, Hq, 1, D] in q's dtype."""
    assert q.shape[2] == 1, q.shape
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if (dispatch.select_routes(interpret).paged_decode == "triton"
            and _tiling_for(q, k_pages, page_table) is not None):
        return paged_decode_triton(
            q, k_pages, v_pages, lengths, page_table, sm_scale, window,
            logit_softcap, bool(interpret),
        )
    return xla_attention(
        q,
        gather_pages(k_pages, page_table, q.dtype),
        gather_pages(v_pages, page_table, q.dtype),
        sm_scale, kv_length=lengths, window=window,
        logit_softcap=logit_softcap,
    )


@functools.partial(
    jax.jit, static_argnames=("sm_scale", "window", "logit_softcap")
)
def paged_attention_extend(
    q: jax.Array,
    k_pages,
    v_pages,
    q_offset: jax.Array,
    kv_length: jax.Array,
    page_table: jax.Array,
    sm_scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
) -> jax.Array:
    """Chunked prefill over a paged cache.

    q: [B, Hq, S, D], the chunk's queries at global rows q_offset..+S;
    their K/V are already in the pages. kv_length = q_offset + S for
    active rows, 0 for inactive slots (their output is zeros). Causality
    is `col <= q_offset + row`. Returns [B, Hq, S, D] in q's dtype.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return xla_attention(
        q,
        gather_pages(k_pages, page_table, q.dtype),
        gather_pages(v_pages, page_table, q.dtype),
        sm_scale, causal=True, kv_length=kv_length, q_offset=q_offset,
        window=window, logit_softcap=logit_softcap,
    )

