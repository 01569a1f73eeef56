"""Dense attention routes: cuDNN fused attention and grouped XLA attention.

Layout [B, H, S, D] throughout, like `flash_attn_func`. Masking semantics
match the oracle (ops/reference.py):

  * causality is bottom-right aligned (`col <= row + Skv - Sq`), or
    `col <= q_offset + row` when a per-row `q_offset` is given;
  * `kv_length` masks the cache tail (`col < kv_length`); with no
    `q_offset`, the queries sit at the end of the valid prefix
    (`q_offset = kv_length - Sq`);
  * `window` W keeps keys with `col > q_pos - W` (HF semantics: the window
    includes the current position);
  * a row with no visible key emits exact zeros.

`cudnn_attention` handles what cuDNN expresses (`cudnn_supports`).
Everything else takes `xla_attention`: bf16 operands with fp32
accumulation, the GQA group folded into the query axis (no KV head
repeat), and fp32 inputs at HIGHEST precision so no TF32 pass sneaks in.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def attention_mask(b, sq, skv, causal, kv_length, q_offset, window):
    """[B or 1, Sq, Skv] boolean mask, True where attention is allowed."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, sq, skv), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, sq, skv), 2)
    if q_offset is not None:
        base = q_offset.astype(jnp.int32).reshape(b, 1, 1)
    elif kv_length is not None:
        base = kv_length.astype(jnp.int32).reshape(b, 1, 1) - sq
    else:
        base = skv - sq
    q_pos = rows + base
    allowed = jnp.ones((1, sq, skv), jnp.bool_)
    if causal:
        allowed = allowed & (cols <= q_pos)
    if window is not None:
        allowed = allowed & (cols > q_pos - window)
    if kv_length is not None:
        allowed = allowed & (
            cols < kv_length.astype(jnp.int32).reshape(b, 1, 1)
        )
    return allowed


def masked_attention(q, k, v, allowed, sm_scale, logit_softcap=None):
    """Grouped-query softmax attention under a boolean mask `allowed`
    ([B or 1, Sq, Skv]). q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D]."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    precision = (
        jax.lax.Precision.HIGHEST if q.dtype == jnp.float32 else None
    )
    s = jnp.einsum(
        "bkgqd,bksd->bkgqs", q.reshape(b, hkv, g, sq, d), k,
        preferred_element_type=jnp.float32, precision=precision,
    ) * sm_scale
    if logit_softcap is not None:
        s = jnp.tanh(s / logit_softcap) * logit_softcap
    s = jnp.where(allowed[:, None, None], s, -jnp.inf)
    # Softmax is invariant to the shift, so the max carries no gradient;
    # rows with no visible key get shift 0 and sum 0, hence output 0.
    m = jax.lax.stop_gradient(jnp.max(s, axis=-1, keepdims=True))
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    p = jnp.exp(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    o = jnp.einsum(
        "bkgqs,bksd->bkgqd", p.astype(v.dtype), v,
        preferred_element_type=jnp.float32, precision=precision,
    )
    o = o * jnp.where(l == 0.0, 0.0, 1.0 / jnp.where(l == 0.0, 1.0, l))
    return o.reshape(b, hq, sq, d).astype(q.dtype)


def xla_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    sm_scale: float,
    causal: bool = False,
    kv_length: jax.Array | None = None,
    q_offset: jax.Array | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
) -> jax.Array:
    """Grouped-query attention in plain XLA (masks: module docstring)."""
    allowed = attention_mask(
        q.shape[0], q.shape[2], k.shape[2], causal, kv_length, q_offset,
        window,
    )
    return masked_attention(q, k, v, allowed, sm_scale, logit_softcap)


def cudnn_supports(
    q, k, causal, kv_length, q_offset, window, logit_softcap
) -> bool:
    """Whether cuDNN's fused attention expresses this call exactly: 16-bit
    inputs, no soft cap, no per-row lengths or offsets, head_dim <= 128,
    Sq == Skv when causal or windowed (cuDNN aligns its masks top-left,
    this repo bottom-right), and a window only under causality."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    return (
        q.dtype in (jnp.bfloat16, jnp.float16)
        and logit_softcap is None
        and kv_length is None
        and q_offset is None
        and (sq == skv or not (causal or window is not None))
        and (window is None or causal)
        and d % 8 == 0
        and d <= 128
    )


def cudnn_attention(
    q, k, v, sm_scale, causal=False, window=None, implementation="cudnn"
) -> jax.Array:
    """`jax.nn.dot_product_attention` in [B,H,S,D] layout. On the GPU,
    XLA hands `implementation="cudnn"` to cuDNN's fused kernel; the tests
    pass "xla" to check this argument mapping on the CPU."""
    t = lambda x: jnp.swapaxes(x, 1, 2)
    window_args = {}
    if window is not None:
        # (left, right): W-1 keys behind the query plus the query itself.
        window_args["local_window_size"] = (window - 1, 0)
    o = jax.nn.dot_product_attention(
        t(q), t(k), t(v), scale=sm_scale, is_causal=causal,
        implementation=implementation, **window_args,
    )
    return t(o)


def _segment_metadata(cu: jax.Array, total: int, pad_id: int):
    """cu_seqlens [N+1] -> (segment id, position in segment) per packed
    token; tokens past cu[-1] get `pad_id`, which matches nothing."""
    t = jnp.arange(total, dtype=jnp.int32)
    seg = jnp.searchsorted(cu[1:], t, side="right", method="compare_all")
    seg = seg.astype(jnp.int32)
    seg = jnp.minimum(seg, cu.shape[0] - 2)
    pos = t - cu[seg]
    return jnp.where(t < cu[-1], seg, pad_id), pos


def flash_attention_varlen(
    q: jax.Array,  # [Tq, Hq, D] packed tokens
    k: jax.Array,  # [Tkv, Hkv, D]
    v: jax.Array,
    cu_seqlens_q: jax.Array,  # [num_seqs + 1] int32
    cu_seqlens_kv: jax.Array | None = None,
    sm_scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    logit_softcap: float | None = None,
) -> jax.Array:
    """Varlen attention over packed ragged batches (flash-attn layout).

    Args:
      q: [total_q_tokens, Hq, D] — sequences concatenated along axis 0.
      k, v: [total_kv_tokens, Hkv, D].
      cu_seqlens_q / cu_seqlens_kv: exclusive-prefix-sum boundaries
        ([0, len_0, len_0+len_1, ...]); kv defaults to q's (self-attention
        packing).
      causal: per-sequence bottom-right-aligned causality
        (reference: csrc/mask.cuh:37-39).
      window: per-sequence sliding window (HF semantics).

    Returns: [total_q_tokens, Hq, D] in q's dtype; tokens past the last
    boundary emit zeros.
    """
    if cu_seqlens_kv is None:
        cu_seqlens_kv = cu_seqlens_q
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    cu_q = cu_seqlens_q.astype(jnp.int32)
    cu_kv = cu_seqlens_kv.astype(jnp.int32)
    seg_q, pos_q = _segment_metadata(cu_q, q.shape[0], -1)
    seg_kv, pos_kv = _segment_metadata(cu_kv, k.shape[0], -2)
    # Per-sequence bottom-right alignment: position p of a sequence's
    # queries sits at kv position p + (kv_len - q_len).
    offsets = (jnp.diff(cu_kv) - jnp.diff(cu_q)).astype(jnp.int32)
    q_pos = pos_q + offsets[jnp.maximum(seg_q, 0)]
    allowed = seg_q[:, None] == seg_kv[None, :]
    if causal:
        allowed &= pos_kv[None, :] <= q_pos[:, None]
    if window is not None:
        allowed &= pos_kv[None, :] > q_pos[:, None] - window
    t = lambda x: jnp.swapaxes(x, 0, 1)[None]
    out = masked_attention(
        t(q), t(k), t(v), allowed[None], sm_scale, logit_softcap
    )
    return jnp.swapaxes(out[0], 0, 1)
