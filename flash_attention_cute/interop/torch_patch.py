"""Monkeypatch HF transformers attention onto this package's attention routes.

Drop-in equivalent of the reference's integration layer
(reference: models/rope_attn_fwd.py:66-120 `attention_forward`,
models/patch_llama.py:4-5 / models/patch_qwen2.py:4-5 `patch_attn`): QKV
projection, RoPE and KV-cache update stay in torch (exactly like the
reference, which keeps everything up to the kernel call in HF code), and
the attention core crosses into JAX where the dispatching API routes to
the fused prefill / split-KV decode Pallas kernels.

The bridge is zero-copy on CPU via dlpack where possible and otherwise a
host round-trip; it exists for *capability parity and validation* (run any
HF checkpoint against these routes without porting weights). The
first-class serving path remains the native JAX stack (models/ +
runtime/) — crossing frameworks per layer is not a performance plan.

Usage (mirrors the reference exactly):

    from flash_attention_cute.interop import patch_llama
    patch_llama()                      # patches LlamaAttention.forward
    model = AutoModelForCausalLM.from_pretrained(..., attn_implementation=None)
"""

from __future__ import annotations

import numpy as np


def _torch():
    import torch

    return torch


def _to_jax(t):
    import jax

    t = t.detach().contiguous()
    if t.dtype == _torch().bfloat16:
        # numpy has no bf16; dlpack handles it.
        try:
            return jax.dlpack.from_dlpack(t)
        except Exception:
            import jax.numpy as jnp

            return jnp.asarray(t.float().cpu().numpy()).astype(jnp.bfloat16)
    try:
        return jax.dlpack.from_dlpack(t)
    except Exception:
        import jax.numpy as jnp

        return jnp.asarray(t.cpu().numpy())


def _to_torch(a, like):
    torch = _torch()
    import jax.numpy as jnp

    if a.dtype == jnp.bfloat16:
        try:
            return torch.from_dlpack(a).to(like.device, like.dtype)
        except Exception:
            a = a.astype(jnp.float32)
    return torch.from_numpy(np.array(a)).to(like.device, like.dtype)


def _flash_attention_eager(q, k, v, softmax_scale, causal, window,
                           kv_length=None):
    """torch [B, H, S, D] -> torch [B, H, S, D] through the JAX kernels
    (reference: models/rope_attn_fwd.py:40-64 `_flash_attention_forward`).

    `kv_length` (torch int [B] or None) marks the valid kv prefix of a
    RIGHT-padded batch; with it, prefill causality is top-left aligned
    (row i is absolute position i — right padding keeps real tokens at the
    front, so bottom-right alignment would shift every row's bound)."""
    import jax.numpy as jnp

    from flash_attention_cute.api import flash_attention_forward

    qj, kj, vj = _to_jax(q), _to_jax(k), _to_jax(v)
    kwargs = {}
    if kv_length is not None:
        kwargs["kv_length"] = jnp.asarray(
            kv_length.cpu().numpy(), jnp.int32
        )
        if q.shape[2] > 1:
            kwargs["q_offset"] = jnp.zeros((q.shape[0],), jnp.int32)
    oj = flash_attention_forward(
        qj, kj, vj, softmax_scale=softmax_scale, causal=causal,
        window=window, **kwargs,
    )
    return _to_torch(oj, like=q)


_custom_op = None


def _get_custom_op():
    """Register `flash_attention_cute::forward` as a torch.library
    custom op with a fake (meta) kernel, so models patched onto the JAX
    kernels stay traceable under torch.compile / FakeTensor / meta devices
    (the reference's own pattern: torch.library.custom_op +
    `flash_attention_forward_fake`, reference:
    flash_attention/flash_attention.py:6, :40-43). Falls back to the plain
    eager function on torch builds without torch.library.custom_op."""
    global _custom_op
    if _custom_op is not None:
        return _custom_op
    torch = _torch()
    try:
        # Explicit schema: `from __future__ import annotations` makes the
        # function annotations strings, which infer_schema cannot resolve
        # without torch importable at module scope.
        @torch.library.custom_op(
            "flash_attention_cute::forward", mutates_args=(),
            schema=(
                "(Tensor q, Tensor k, Tensor v, float softmax_scale, "
                "bool causal, int window, Tensor? kv_length=None) -> Tensor"
            ),
        )
        def _op(q, k, v, softmax_scale, causal, window, kv_length=None):
            return _flash_attention_eager(
                q, k, v, softmax_scale, causal,
                None if window <= 0 else window, kv_length,
            ).contiguous()

        @_op.register_fake
        def _op_fake(q, k, v, softmax_scale, causal, window,
                     kv_length=None):
            # Freshly-allocated contiguous output (NOT empty_like: q is
            # often a transposed view and the real op returns contiguous —
            # inductor asserts the fake's strides match the real ones).
            return torch.empty(q.shape, dtype=q.dtype, device=q.device)

        def call(q, k, v, softmax_scale, causal, window, kv_length=None):
            return _op(
                q, k, v, softmax_scale, causal,
                0 if window is None else int(window), kv_length,
            )

        _custom_op = call
    except (AttributeError, RuntimeError):
        _custom_op = _flash_attention_eager
    return _custom_op


def _flash_attention_core(q, k, v, softmax_scale, causal, window,
                          kv_length=None):
    return _get_custom_op()(
        q, k, v, softmax_scale, causal, window, kv_length
    )


def _padding_kv_lengths(mask, skv, window):
    """Per-sequence valid kv length from an HF attention mask, or None.

    Returns None when the mask keeps every position (including the pure
    sliding-window exclusion the kernel already applies natively), an int
    [B] tensor for RIGHT-padded batches (each row a prefix of ones), and
    raises for left-padded / arbitrary masks — silently attending to
    padding tokens was the round-1 advisor finding; the reference forwards
    its mask to the flash call (reference: models/rope_attn_fwd.py)."""
    torch = _torch()
    if mask.dim() == 4:
        # Processed additive (float) or boolean [B, 1, Sq, Skv] mask: under
        # causal semantics the LAST query row sees every non-pad key, so
        # that row is the padding pattern.
        row = mask[:, 0, -1, :skv]
        if row.is_floating_point():
            valid = row > torch.finfo(row.dtype).min / 2
        else:
            valid = row.to(torch.bool)
    elif mask.dim() == 2:
        valid = mask[:, :skv].to(torch.bool)
    else:
        raise NotImplementedError(
            f"attention_mask of rank {mask.dim()} is not supported by the "
            "JAX interop path"
        )
    valid = valid.cpu()
    n = valid.shape[-1]
    lengths = valid.sum(-1)
    if bool((lengths >= n).all()):
        return None
    if bool((lengths == 0).any()):
        # A mask processor that fully masks padded QUERY rows makes the
        # probed last row all-False; treating that as length 0 would
        # silently zero the whole sequence's attention output. Fail loudly
        # like the left-padded case (round-2 advisor finding).
        raise NotImplementedError(
            "attention_mask marks an entire sequence invalid (inferred kv "
            "length 0); fully-masked query rows are not supported by the "
            "JAX interop path"
        )
    ar = torch.arange(n)
    if bool(((ar[None, :] < lengths[:, None]) == valid).all()):
        return lengths.to(torch.int32)
    if window is not None and mask.dim() == 4:
        # A sliding-window causal mask with no padding: last row keeps the
        # trailing `window` positions. The kernel applies the window
        # natively, so no length restriction is needed.
        if bool(((ar[None, :] >= n - int(window)) == valid).all()):
            return None
    raise NotImplementedError(
        "the JAX interop path supports unpadded or RIGHT-padded attention "
        "masks; left-padded or arbitrary masks would silently attend to "
        "padding tokens (use tokenizer.padding_side = 'right', or the "
        "native serving engine for generation)"
    )


def attention_forward(
    self,
    hidden_states,
    position_embeddings=None,
    attention_mask=None,
    past_key_value=None,
    past_key_values=None,  # transformers >= 4.56 spells it plural
    cache_position=None,
    position_ids=None,
    **kwargs,
):
    """Replacement for modern HF (>= 4.48-style) *Attention.forward
    (reference: models/rope_attn_fwd.py:66-120). Returns (attn_out, None).
    """
    torch = _torch()
    if past_key_value is None:
        past_key_value = past_key_values
    b, s, _ = hidden_states.shape
    cfg = self.config
    head_dim = getattr(
        self, "head_dim", cfg.hidden_size // cfg.num_attention_heads
    )
    num_kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)

    q = self.q_proj(hidden_states).view(b, s, -1, head_dim).transpose(1, 2)
    k = self.k_proj(hidden_states).view(b, s, num_kv, head_dim).transpose(1, 2)
    v = self.v_proj(hidden_states).view(b, s, num_kv, head_dim).transpose(1, 2)

    if position_embeddings is not None:
        cos, sin = position_embeddings
        # HF rotate-half convention (reference: rope_attn_fwd.py:8-38).
        def rot(x):
            half = x.shape[-1] // 2
            return torch.cat((-x[..., half:], x[..., :half]), dim=-1)

        cu, su = cos.unsqueeze(1), sin.unsqueeze(1)
        q = q * cu + rot(q) * su
        k = k * cu + rot(k) * su

    if past_key_value is not None:
        k, v = past_key_value.update(
            k, v, self.layer_idx, {"cache_position": cache_position}
        )

    # Sliding-window probe (reference: rope_attn_fwd.py:95-101) — unlike
    # the reference, a configured window is SUPPORTED, not rejected.
    window = None
    if getattr(cfg, "use_sliding_window", False) and getattr(
        cfg, "sliding_window", None
    ):
        if self.layer_idx >= getattr(cfg, "max_window_layers", 0):
            window = cfg.sliding_window

    kv_length = None
    if attention_mask is not None:
        kv_length = _padding_kv_lengths(attention_mask, k.shape[2], window)

    o = _flash_attention_core(
        q, k, v,
        softmax_scale=head_dim ** -0.5,
        causal=True,
        window=window,
        kv_length=kv_length,
    )

    o = o.transpose(1, 2).reshape(b, s, -1)
    return self.o_proj(o), None


def patch_llama() -> None:
    """LlamaAttention.forward = attention_forward
    (reference: models/patch_llama.py:4-5)."""
    from transformers.models.llama import modeling_llama

    modeling_llama.LlamaAttention.forward = attention_forward


def patch_qwen2() -> None:
    """Qwen2Attention.forward = attention_forward
    (reference: models/patch_qwen2.py:4-5)."""
    from transformers.models.qwen2 import modeling_qwen2

    modeling_qwen2.Qwen2Attention.forward = attention_forward
