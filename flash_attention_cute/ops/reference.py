"""Pure-XLA reference attention: the numerics oracle.

The tests and `chip_smoke.py` compare every attention route against it
(reference: scripts/benchmark_kernel.py:15-44 `eager_attention`, fp32
upcast + GQA repeat_interleave + causal bias). No production path calls
it: it materializes the whole fp32 score tensor.

Causal semantics are **bottom-right aligned** like the reference CUDA kernel
(reference: csrc/mask.cuh:37-39): coordinate (m, n) is masked iff
`seqlen_q - m > seqlen_kv - n`, i.e. allowed iff `n <= m + (seqlen_kv - seqlen_q)`.
With seqlen_kv > seqlen_q (decode with cache) the last query row sees all keys.
Rows that end up fully masked (only possible when seqlen_q > seqlen_kv)
produce exactly 0 output (the reference's sum==0 -> scale 1.0 guard,
reference: csrc/flash_attention_template.cuh:516-528).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bottom_right_causal_mask(q_len: int, kv_len: int, dtype=jnp.bool_) -> jax.Array:
    """[q_len, kv_len] boolean mask, True where attention is ALLOWED."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (q_len, kv_len), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (q_len, kv_len), 1)
    offset = kv_len - q_len
    return (cols <= rows + offset).astype(dtype)


def attention_reference(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    softmax_scale: float | None = None,
    causal: bool = False,
    kv_length: jax.Array | None = None,
    q_offset: jax.Array | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """O = softmax(Q K^T * scale + mask) V computed in fp32, no tiling.

    Args:
      q: [B, Hq, Sq, D]
      k: [B, Hkv, Skv, D]   (Hq % Hkv == 0; GQA/MQA handled by head repetition)
      v: [B, Hkv, Skv, D]
      softmax_scale: defaults to D**-0.5 (reference: flash_attention.py:52)
      causal: bottom-right-aligned causal masking
      kv_length: optional [B] int32 valid KV lengths (positions >= length are
        masked) — used to test the length-aware decode kernels.
      q_offset: optional [B] int32 global position of q row 0 (chunked
        prefill into a partially-filled cache). When given with causal=True,
        causality is `col <= q_offset + row` instead of the shape-derived
        bottom-right offset.
      window: optional sliding-window size W — each query also masks keys
        more than W-1 positions behind it (HF/Qwen2 semantics: the window
        includes the current position; the reference repo *raises* on
        sliding windows, models/modeling_qwen2.py:261-269 — here it is
        supported natively).
      precision: lax matmul precision, HIGHEST by default: fp32 matmuls on
        the GPU otherwise run as TF32, which keeps about three digits.

    Returns [B, Hq, Sq, D] in q's dtype.
    """
    orig_dtype = q.dtype
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    assert hq % hkv == 0, (hq, hkv)
    if softmax_scale is None:
        softmax_scale = d ** -0.5

    qf = q.astype(jnp.float32)
    kf = k.astype(jnp.float32)
    vf = v.astype(jnp.float32)
    if hkv != hq:
        rep = hq // hkv
        kf = jnp.repeat(kf, rep, axis=1)
        vf = jnp.repeat(vf, rep, axis=1)

    scores = jnp.einsum(
        "bhqd,bhkd->bhqk", qf, kf, precision=precision
    ) * softmax_scale
    if logit_softcap is not None:
        # Gemma-style soft capping (applied pre-mask, like the models do).
        scores = jnp.tanh(scores / logit_softcap) * logit_softcap

    allowed = jnp.ones((b, 1, sq, skv), dtype=jnp.bool_)
    if causal:
        if q_offset is not None:
            rows = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sq, skv), 2)
            cols = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sq, skv), 3)
            allowed &= cols <= rows + q_offset.reshape(b, 1, 1, 1)
        else:
            allowed &= bottom_right_causal_mask(sq, skv)[None, None]
    if kv_length is not None:
        pos = jax.lax.broadcasted_iota(jnp.int32, (b, 1, 1, skv), 3)
        allowed &= pos < kv_length.reshape(b, 1, 1, 1)
    if window is not None:
        # Global position of q row r: q_offset + r, or length-derived.
        rows = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sq, skv), 2)
        cols = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sq, skv), 3)
        if q_offset is not None:
            base = q_offset.reshape(b, 1, 1, 1)
        elif kv_length is not None:
            base = kv_length.reshape(b, 1, 1, 1) - sq
        else:
            base = skv - sq
        q_pos = rows + base
        allowed &= cols > q_pos - window

    scores = jnp.where(allowed, scores, -jnp.inf)
    # Fully-masked rows: softmax of all -inf is NaN; define output as 0
    # (reference sum==0 guard, csrc/flash_attention_template.cuh:520-528).
    row_has_any = jnp.any(allowed, axis=-1, keepdims=True)
    probs = jax.nn.softmax(scores, axis=-1)
    probs = jnp.where(row_has_any, probs, 0.0)
    out = jnp.einsum("bhqk,bhkd->bhqd", probs, vf, precision=precision)
    return out.astype(orig_dtype)
