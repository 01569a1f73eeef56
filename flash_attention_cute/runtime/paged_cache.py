"""Paged KV cache: device-side page pool + functional append, host-side
page allocator.

The reference has no cache manager at all (HF DynamicCache does it,
reference: models/rope_attn_fwd.py:90-93); paged caching is its open
roadmap item (reference: README.md:21). Design follows serving practice:
the *allocator* (free-list, page-table assembly) runs on the host inside
the scheduler; the *data path* (token scatter into pages, attention over
pages) is jitted device code with static shapes.

Layouts (per layer slices feed ops/paged_attention.py):
  k_pages/v_pages: [L, Hkv, num_pages, page_size, D]
  page_table:      [B, pages_per_seq_max] int32 (padding = page 0, masked)
  lengths:         [B] int32
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PagedKVState:
    """Device-side paged cache state (a pytree; allocator lives separately)."""

    k_pages: jax.Array  # [L, Hkv, P, ps, D]
    v_pages: jax.Array
    page_table: jax.Array  # [B, pages_per_seq] int32
    lengths: jax.Array  # [B] int32

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[2]


def create_paged_state(
    cfg, num_pages: int, page_size: int, batch: int, pages_per_seq: int,
    dtype=None,
) -> PagedKVState:
    dtype = dtype or cfg.dtype
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    return PagedKVState(
        k_pages=jnp.zeros(shape, dtype),
        v_pages=jnp.zeros(shape, dtype),
        page_table=jnp.zeros((batch, pages_per_seq), jnp.int32),
        lengths=jnp.zeros((batch,), jnp.int32),
    )


def _scatter_indices(
    page_table: jax.Array,  # [B, pages_per_seq]
    lengths: jax.Array,  # [B] (lengths BEFORE the append)
    s: int,
    ps: int,
    total: int,  # p * ps — one-past-the-end of the flat pool
    active: jax.Array | None,  # [B] bool; False rows scatter nothing
) -> jax.Array:
    """Flat pool indices [B*S] for an append; rows that must not land
    anywhere are sent to `total`, which is out of range, and every scatter
    below uses mode='drop' so those updates are discarded (NOT wrapped —
    negative indices would wrap under jnp's .at semantics).

    Two classes of dropped rows:
      * positions past the page table (prompt padding beyond the allocated
        tail) — previously relied on take_along_axis's implicit OOB fill;
      * `active == False` slots — a slot mid chunked-admission has
        lengths == 0 while its page table already holds real pages, so an
        unmasked dummy scatter would corrupt the admitting prompt's
        position 0 on every decode round.
    """
    pos = lengths[:, None] + jnp.arange(s, dtype=jnp.int32)  # [B, S]
    page_slot = pos // ps
    n_slots = page_table.shape[1]
    page = jnp.take_along_axis(
        page_table, jnp.minimum(page_slot, n_slots - 1), axis=1
    )  # [B, S]
    flat_idx = page * ps + pos % ps
    drop = page_slot >= n_slots
    if active is not None:
        drop = jnp.logical_or(drop, jnp.logical_not(active)[:, None])
    return jnp.where(drop, total, flat_idx).reshape(-1)  # [B*S]


def _token_dus_targets(page_table, lengths, ps, active):
    """Per-row (page, offset, drop) for a single-token decode append."""
    n_slots = page_table.shape[1]
    page_slot = lengths // ps
    page = jnp.take_along_axis(
        page_table, jnp.minimum(page_slot, n_slots - 1)[:, None], axis=1
    )[:, 0]
    drop = page_slot >= n_slots
    if active is not None:
        drop = jnp.logical_or(drop, jnp.logical_not(active))
    return page, lengths % ps, drop


def _append_token_dus(pages, new_b, page, off, drop):
    """Decode (S=1) append via per-row dynamic_update_slice.

    An advanced-index scatter lowers to a serialized scatter op —
    measured 3x slower than windowed stores on the dense cache
    (benchmarks/layer_overhead.py). Dropped rows (past-table positions,
    inactive slots) read-modify-write their own target so ANY page
    table stays uncorrupted (unit tests build tables where page 0 is
    real, so redirecting drops to the null page is not safe here).

    pages: [Hkv, P, ps, ...]; new_b: [B, Hkv, ...] (token axis squeezed).
    """
    b = new_b.shape[0]
    hkv = pages.shape[0]
    tail = pages.shape[3:]
    for bi in range(b):
        idx = (0, page[bi], off[bi]) + (0,) * len(tail)
        val = new_b[bi].astype(pages.dtype).reshape((hkv, 1, 1) + tail)
        cur = jax.lax.dynamic_slice(pages, idx, (hkv, 1, 1) + tail)
        val = jnp.where(drop[bi], cur, val)
        pages = jax.lax.dynamic_update_slice(pages, val, idx)
    return pages


def paged_append_layer(
    k_pages_l: jax.Array,  # [Hkv, P, ps, D]
    v_pages_l: jax.Array,
    k_new: jax.Array,  # [B, Hkv, S, D]
    v_new: jax.Array,
    page_table: jax.Array,  # [B, pages_per_seq]
    lengths: jax.Array,  # [B] (lengths BEFORE the append)
    active: jax.Array | None = None,  # [B] bool; False => drop the row
) -> tuple[jax.Array, jax.Array]:
    """Scatter S new tokens per sequence into the page pool (one layer).

    Decode (S == 1, small batch) takes the per-row dus fast path; chunk
    appends (S > 1 spans page boundaries) keep the flat scatter."""
    hkv, p, ps, d = k_pages_l.shape
    b, _, s, _ = k_new.shape

    if s == 1 and b <= 32:
        page, off, drop = _token_dus_targets(page_table, lengths, ps,
                                             active)
        return (
            _append_token_dus(k_pages_l, k_new[:, :, 0], page, off, drop),
            _append_token_dus(v_pages_l, v_new[:, :, 0], page, off, drop),
        )

    flat_idx = _scatter_indices(page_table, lengths, s, ps, p * ps, active)

    def scatter(pages, new):
        flat = pages.reshape(hkv, p * ps, d)
        vals = new.astype(pages.dtype).transpose(1, 0, 2, 3).reshape(hkv, b * s, d)
        return flat.at[:, flat_idx].set(vals, mode="drop").reshape(hkv, p, ps, d)

    return scatter(k_pages_l, k_new), scatter(v_pages_l, v_new)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuantizedPagedKVState:
    """Paged cache with int8/fp8 values + per-token f32 scales (the
    reference's quantized-kernels AND paged-cache roadmap items combined,
    README.md:21-22): 2x the resident sequences per HBM byte.

    k_values/v_values: [L, Hkv, P, ps, D]; k_scales/v_scales: [L, Hkv, P, ps]
    """

    k_values: jax.Array
    k_scales: jax.Array
    v_values: jax.Array
    v_scales: jax.Array
    page_table: jax.Array  # [B, pages_per_seq] int32
    lengths: jax.Array  # [B] int32

    @property
    def page_size(self) -> int:
        return self.k_values.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k_values.shape[2]


def create_quantized_paged_state(
    cfg, num_pages: int, page_size: int, batch: int, pages_per_seq: int,
    dtype=jnp.int8,
) -> QuantizedPagedKVState:
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    sshape = shape[:-1]
    return QuantizedPagedKVState(
        k_values=jnp.zeros(shape, dtype),
        k_scales=jnp.ones(sshape, jnp.float32),
        v_values=jnp.zeros(shape, dtype),
        v_scales=jnp.ones(sshape, jnp.float32),
        page_table=jnp.zeros((batch, pages_per_seq), jnp.int32),
        lengths=jnp.zeros((batch,), jnp.int32),
    )


def paged_append_layer_quantized(
    kv_slab: tuple,  # (values [Hkv, P, ps, D], scales [Hkv, P, ps])
    new: jax.Array,  # [B, Hkv, S, D] (unquantized)
    page_table: jax.Array,
    lengths: jax.Array,
    active: jax.Array | None = None,  # [B] bool; False => drop the row
) -> tuple:
    """Quantize new tokens per token, scatter values+scales into pages."""
    from flash_attention_cute.ops.quantized import quantize_kv

    vals, scl = kv_slab
    hkv, p, ps, d = vals.shape
    b, _, s, _ = new.shape

    nq = quantize_kv(new, dtype=vals.dtype)  # values [B,Hkv,S,D], scales [B,Hkv,S]

    if s == 1 and b <= 32:  # decode fast path, as in paged_append_layer
        page, off, drop = _token_dus_targets(page_table, lengths, ps,
                                             active)
        return (
            _append_token_dus(vals, nq.values[:, :, 0], page, off, drop),
            _append_token_dus(scl, nq.scales[:, :, 0], page, off, drop),
        )

    flat_idx = _scatter_indices(page_table, lengths, s, ps, p * ps, active)

    vflat = vals.reshape(hkv, p * ps, d)
    nv = nq.values.transpose(1, 0, 2, 3).reshape(hkv, b * s, d)
    vals = vflat.at[:, flat_idx].set(nv, mode="drop").reshape(hkv, p, ps, d)

    sflat = scl.reshape(hkv, p * ps)
    nsc = nq.scales.transpose(1, 0, 2).reshape(hkv, b * s)
    scl = sflat.at[:, flat_idx].set(nsc, mode="drop").reshape(hkv, p, ps)
    return (vals, scl)


def copy_pool_page_prefix(pools, src, dst, rows):
    """Copy the first `rows` positions of page `src` into page `dst` in
    every pool array (partial-page prefix sharing). The clone is
    bit-identical to recomputing those rows — KV at position p is a pure
    function of tokens 0..p. Position axis = dim 3 ([L, H, P, ps, D]
    values / [L, H, P, ps] scales)."""
    out = []
    for a in pools:
        ps = a.shape[3]
        live = jnp.arange(ps) < rows
        mask = live.reshape((1, 1, ps) + (1,) * (a.ndim - 4))
        s = jax.lax.dynamic_index_in_dim(a, src, axis=2, keepdims=False)
        d = jax.lax.dynamic_index_in_dim(a, dst, axis=2, keepdims=False)
        out.append(
            jax.lax.dynamic_update_index_in_dim(
                a, jnp.where(mask, s, d), dst, axis=2
            )
        )
    return tuple(out)


def copy_pool_page_prefix_batch(pools, srcs, dsts, rows):
    """A whole admission wave's partial-page clones in one traced block.

    Each device call costs a host round trip, which can dwarf the copy
    itself, so a wave's clones go in one traced block. Callers either jit this directly (one dispatch per wave) or
    fold it into the admission extend forward (forward_paged
    partial_copy= — zero extra dispatches). Entries padded with
    rows == 0 mask to a dst self-write (no-op); real entries' dst pages
    are distinct private pages, so the unrolled loop has no write
    conflicts."""
    for i in range(srcs.shape[0]):
        pools = copy_pool_page_prefix(pools, srcs[i], dsts[i], rows[i])
    return pools


class PageAllocator:
    """Host-side free-list page allocator (scheduler component).

    Page 0 is reserved as the null page: page-table padding points at it so
    out-of-range entries stay valid page ids (attention masks them).
    """

    def __init__(self, num_pages: int, page_size: int, pages_per_seq: int):
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.free = list(range(num_pages - 1, 0, -1))  # page 0 reserved
        self.tables: dict[int, list[int]] = {}
        # Reference counts (prefix caching): a page is owned by every
        # sequence table that references it PLUS one count per cache pin.
        # The free list holds exactly the pages with refcount 0.
        self.refs: dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self.free)

    def pages_needed(self, cur_len: int, new_tokens: int) -> int:
        have = -(-cur_len // self.page_size) if cur_len else 0
        need = -(-(cur_len + new_tokens) // self.page_size)
        return max(0, need - have)

    def allocate(self, seq_id: int, cur_len: int, new_tokens: int) -> bool:
        """Reserve pages for new_tokens more tokens. False if OOM."""
        n = self.pages_needed(cur_len, new_tokens)
        if n > len(self.free):
            return False
        tbl = self.tables.setdefault(seq_id, [])
        if len(tbl) + n > self.pages_per_seq:
            return False
        for _ in range(n):
            p = self.free.pop()
            self.refs[p] = 1
            tbl.append(p)
        return True

    def share(self, seq_id: int, pages: list[int]) -> bool:
        """Append already-live pages (a cached prompt prefix) to seq_id's
        table, taking a reference on each. Pages must have refcount > 0 —
        free pages cannot be shared (their contents are unowned)."""
        tbl = self.tables.setdefault(seq_id, [])
        if len(tbl) + len(pages) > self.pages_per_seq:
            return False
        if any(self.refs.get(p, 0) <= 0 for p in pages):
            return False
        for p in pages:
            self.refs[p] += 1
            tbl.append(p)
        return True

    def take_free_page(self) -> int:
        """Pop a free page and hand it out PINNED (refcount 1, in no
        sequence table): the prefix cache's host-swap restore path uploads
        KV into it and owns it via the cache pin until eviction. Returns
        -1 when the pool is empty."""
        if not self.free:
            return -1
        p = self.free.pop()
        self.refs[p] = 1
        return p

    def pin(self, page: int) -> bool:
        """Take a cache reference on a live page (prefix-cache insert)."""
        if self.refs.get(page, 0) <= 0:
            return False
        self.refs[page] += 1
        return True

    def unpin(self, page: int) -> None:
        """Drop a cache reference; a page reaching refcount 0 is freed."""
        r = self.refs.get(page, 0) - 1
        self.refs[page] = r
        if r == 0:
            self.free.append(page)

    def refcount(self, page: int) -> int:
        return self.refs.get(page, 0)

    def release(self, seq_id: int) -> None:
        tbl = self.tables.pop(seq_id, [])
        for p in reversed(tbl):
            r = self.refs.get(p, 0) - 1
            self.refs[p] = r
            if r == 0:
                self.free.append(p)

    def table_row(self, seq_id: int) -> np.ndarray:
        """Padded page-table row for the device array."""
        row = np.zeros((self.pages_per_seq,), np.int32)
        tbl = self.tables.get(seq_id, [])
        row[: len(tbl)] = tbl
        return row
