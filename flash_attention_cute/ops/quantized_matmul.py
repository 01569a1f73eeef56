"""Weight-only quantized matmul: int8 per output channel, int4 per
128-row group.

Why: decode at small batch is weights-bandwidth-bound, so storing
projections in fewer bits cuts the bytes each step reads and the memory
the weights hold. The matmul is plain XLA: `(x @ values.astype(dtype)) *
scales` for int8 — exact to `x @ (v * s)` because `s` is constant along
the contraction axis — and a dequantize-then-dot for int4. GSPMD
partitions it like any dense matmul (values keep the PartitionSpec of the
bf16 weight they replace), so the same weights serve one card and a
tensor-parallel mesh.

The reference has no weight quantization (its README lists only
quantized *kernels* as a TODO, reference: README.md:22); this is a
"beyond" feature of the same kind as the int8 KV cache in
ops/quantized.py.

Padding contract: `values` may carry zero rows past the logical
contraction width (int4 always does: nibbles pack in blocks of
`_pack_block` rows) and zero columns past the logical output width;
`quantized_matmul` slices both back out, so padding is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

# Rows per int4 nibble-pack block: part of the stored int4 format.
BLOCK_K = 512


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuantizedWeight:
    """Per-output-channel symmetric int8 weight.

    values [..., K, N] int8; scales [..., N] f32. `in_dim` and `out` are
    the LOGICAL contraction/output widths (weights saved with padding
    carry zero values and unit scales there). Layer-stacked leaves
    carry a leading L axis on both fields and slice per layer under
    `lax.scan` like any pytree.
    """

    values: Any
    scales: Any
    in_dim: int = dataclasses.field(metadata=dict(static=True))
    out: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):  # duck-type the jnp.ndarray surface models probe
        return jnp.int8

    @property
    def shape(self):
        return self.values.shape[:-1] + (self.out,)


def quantize_weight(w: jax.Array) -> QuantizedWeight:
    """Quantize a [..., K, N] weight to int8 with per-N absmax scales.

    Layer-stacked weights ([L, K, N]) quantize one layer at a time via
    `lax.map`: the fp32 working copy is the single largest transient of
    device-side quantization (at fused full-width shapes, gate_up
    [8, 4096, 57344] fp32 alone is 7.5 GB); per layer it is bounded at
    one layer's fp32 slab."""
    if w.ndim > 2:
        lead = w.shape[:-2]
        mapped = jax.lax.map(
            quantize_weight,
            w.reshape((-1,) + w.shape[-2:]),
        )
        return QuantizedWeight(
            values=mapped.values.reshape(lead + mapped.values.shape[1:]),
            scales=mapped.scales.reshape(lead + mapped.scales.shape[1:]),
            in_dim=mapped.in_dim, out=mapped.out,
        )
    k, n = w.shape[-2], w.shape[-1]
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=-2)  # [..., N]
    scales = jnp.where(amax > 0, amax / 127.0, 1.0)
    q = jnp.round(wf / scales[..., None, :]).astype(jnp.int8)
    return QuantizedWeight(values=q, scales=scales, in_dim=k, out=n)


def dequantize_weight(qw: QuantizedWeight, dtype=jnp.float32) -> jax.Array:
    """The exact bf16/f32 weight the matmul's math is equivalent to
    (padding stripped) — the parity oracle for tests."""
    w = qw.values.astype(jnp.float32) * qw.scales[..., None, :]
    return w[..., : qw.in_dim, : qw.out].astype(dtype)


def quantized_matmul(x: jax.Array, qw) -> jax.Array:
    """x [..., K] @ qw -> [..., out] in x.dtype (fp32 accumulation).

    Accepts either an int8 `QuantizedWeight` or an int4
    `QuantizedWeight4` (dispatch on the leaf type, mirroring
    models/layers.dense). Padded K rows of `values` are zero, so slicing
    them off is exact and keeps x unpadded."""
    k = x.shape[-1]
    if isinstance(qw, QuantizedWeight4):
        w = _dequant4_padded(qw).astype(x.dtype)[..., :k, :]
        y = jnp.dot(x, w, preferred_element_type=jnp.float32)
        return y[..., : qw.out].astype(x.dtype)
    v = qw.values[..., :k, :].astype(x.dtype)
    y = jnp.dot(x, v, preferred_element_type=jnp.float32) * qw.scales
    return y[..., : qw.out].astype(x.dtype)


# ---------------------------------------------------------------------------
# Int4 grouped quantization (two weights per byte, 128-row K-group scales).
#
# A capacity feature: a quarter of the bf16 bytes at rest. Per-group
# scales (GROUP4=128 K rows) bound the absmax blast radius that makes
# per-channel int4 lossy.
# ---------------------------------------------------------------------------

GROUP4 = 128  # K rows per int4 scale group


def _pack_block(k_pad: int) -> int:
    """Rows per nibble-pack block of the stored int4 format (the low
    nibbles hold a block's first half of rows, the high nibbles its
    second half)."""
    return min(BLOCK_K, k_pad)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuantizedWeight4:
    """Group-wise symmetric int4 weight, nibble-packed.

    values [..., K_pad//2, N_pad] int8: within each pack block of
    `_pack_block(K_pad)` rows, the low nibbles hold the block's first
    half of rows and the high nibbles the second half. Nibbles are
    stored BIASED (u = q + 8, u in [0, 15]); see _unpack4. scales
    [..., K_pad//GROUP4, N] f32: absmax/7 per (K group, output
    channel); padded groups carry unit scales and zero values so padding
    is exact. Layer-stacked leaves slice under `lax.scan`
    like the int8 class."""

    values: Any
    scales: Any
    in_dim: int = dataclasses.field(metadata=dict(static=True))
    out: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return jnp.int4

    @property
    def shape(self):
        return self.values.shape[:-2] + (
            2 * self.values.shape[-2], self.out)


def quantize_weight_int4(w: jax.Array) -> QuantizedWeight4:
    """Quantize a [..., K, N] weight to packed int4 with per-(128-row
    K group, N channel) absmax scales.

    Layer-stacked weights map per layer for the same transient-memory
    bound as `quantize_weight` (the int4 path's fp32 + int32 working
    copies are even larger)."""
    if w.ndim > 2:
        lead = w.shape[:-2]
        mapped = jax.lax.map(
            quantize_weight_int4,
            w.reshape((-1,) + w.shape[-2:]),
        )
        return QuantizedWeight4(
            values=mapped.values.reshape(lead + mapped.values.shape[1:]),
            scales=mapped.scales.reshape(lead + mapped.scales.shape[1:]),
            in_dim=mapped.in_dim, out=mapped.out,
        )
    k, n = w.shape[-2], w.shape[-1]
    k_pad = _round_up(k, min(BLOCK_K, _round_up(k, 2 * GROUP4)))
    n_pad = n
    pad = [(0, 0)] * (w.ndim - 2) + [(0, k_pad - k), (0, 0)]
    wf = jnp.pad(w.astype(jnp.float32), pad)
    lead = wf.shape[:-2]
    grouped = wf.reshape(lead + (k_pad // GROUP4, GROUP4, n_pad))
    amax = jnp.max(jnp.abs(grouped), axis=-2)  # [..., G, N_pad]
    scales = jnp.where(amax > 0, amax / 7.0, 1.0)
    q = jnp.clip(jnp.round(grouped / scales[..., None, :]), -8, 7)
    q = q.astype(jnp.int32).reshape(lead + (k_pad, n_pad))
    bk = _pack_block(k_pad)
    qb = q.reshape(lead + (k_pad // bk, 2, bk // 2, n_pad))
    lo, hi = qb[..., 0, :, :] + 8, qb[..., 1, :, :] + 8  # biased u = q+8
    packed = jax.lax.bitcast_convert_type(
        (lo | (hi << 4)).astype(jnp.uint8), jnp.int8
    ).reshape(lead + (k_pad // 2, n_pad))
    return QuantizedWeight4(values=packed, scales=scales, in_dim=k, out=n)


def _unpack4(p: jax.Array):
    """int32 packed bytes -> (low, high) SIGNED nibble values, int32.

    Storage is BIASED (u = q + 8, u in [0, 15]). Checkpoints saved before
    the biased format hold signed nibbles and do not restore correctly —
    re-quantize.
    """
    lo = (p & 0xF) - 8
    hi = ((p >> 4) & 0xF) - 8
    return lo, hi


def _dequant4_padded(qw: QuantizedWeight4) -> jax.Array:
    """f32 [..., K_pad, N_pad] dense image (padding kept: zero rows,
    so downstream slicing is exact)."""
    k2, n_pad = qw.values.shape[-2], qw.values.shape[-1]
    k_pad = 2 * k2
    bk = _pack_block(k_pad)
    lead = qw.values.shape[:-2]
    p = qw.values.astype(jnp.int32).reshape(
        lead + (k_pad // bk, bk // 2, n_pad))
    lo, hi = _unpack4(p)
    q = jnp.concatenate([lo, hi], axis=-2).reshape(
        lead + (k_pad // GROUP4, GROUP4, n_pad))
    w = q.astype(jnp.float32) * qw.scales[..., None, :]
    return w.reshape(lead + (k_pad, n_pad))


def dequantize_weight4(qw: QuantizedWeight4, dtype=jnp.float32) -> jax.Array:
    """The exact dense weight the matmul's math reproduces (padding
    stripped) — the parity oracle for tests."""
    return _dequant4_padded(qw)[..., : qw.in_dim, : qw.out].astype(dtype)
