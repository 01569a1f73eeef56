"""User-facing attention API.

`flash_attn_func(q, k, v, softmax_scale=None, causal=False)` mirrors the
reference's Python entry point (reference: flash_attention/flash_attention.py:46-53)
including the default-scale rule and the [B, H, S, D] layout. The route is
picked by `dispatch.select_routes`: cuDNN's fused attention on the GPU
wherever cuDNN expresses the call (`ops.attention.cudnn_supports`), and the
grouped XLA attention otherwise. Both are differentiable with `jax.grad`.
"""

from __future__ import annotations

import jax

from flash_attention_cute import dispatch
from flash_attention_cute.ops.attention import (
    cudnn_attention,
    cudnn_supports,
    xla_attention,
)


def flash_attention_forward(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    softmax_scale: float | None = None,
    causal: bool = False,
    kv_length: jax.Array | None = None,
    q_offset: jax.Array | None = None,
    window: int | None = None,
    *,
    logit_softcap: float | None = None,
    interpret: bool | None = None,
) -> jax.Array:
    """Dispatching attention forward. See `flash_attn_func`.

    `kv_length` ([B] int32) optionally marks the valid prefix of k/v — used by
    the decode path over a preallocated cache. `q_offset` ([B] int32) is the
    global position of q row 0 for chunked prefill (causality becomes
    `col <= q_offset + row`). `window` is the sliding-window size in
    HF/Qwen2 semantics (the reference raises on sliding windows,
    models/modeling_qwen2.py:261-269; here supported natively).
    `logit_softcap` applies Gemma-style tanh capping to the scaled scores.
    """
    dispatch.validate_inputs(q, k, v)
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    if dispatch.select_routes(interpret).dense == "cudnn" and cudnn_supports(
        q, k, causal, kv_length, q_offset, window, logit_softcap
    ):
        return cudnn_attention(q, k, v, softmax_scale, causal, window)
    return xla_attention(
        q, k, v, softmax_scale, causal=causal, kv_length=kv_length,
        q_offset=q_offset, window=window, logit_softcap=logit_softcap,
    )


def flash_attn_func(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    softmax_scale: float | None = None,
    causal: bool = False,
    **kwargs,
) -> jax.Array:
    """Drop-in analog of the reference `flash_attn_func`.

    Args:
      q: [batch, n_q_heads, q_seq_len, head_dim]
      k: [batch, n_kv_heads, kv_seq_len, head_dim]
      v: [batch, n_kv_heads, kv_seq_len, head_dim]
      softmax_scale: defaults to head_dim ** -0.5
      causal: bottom-right-aligned causal masking

    Returns: [batch, n_q_heads, q_seq_len, head_dim] in q's dtype.
    """
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    return flash_attention_forward(
        q, k, v, softmax_scale=softmax_scale, causal=causal, **kwargs
    )
