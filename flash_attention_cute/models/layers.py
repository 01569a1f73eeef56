"""Transformer building blocks (functional, dtype-polymorphic).

JAX re-creations of the layers in the reference's vendored models:
  * RMSNorm       (reference: models/modeling_llama.py:55-72)
  * RoPE + scaling variants (reference: modeling_llama.py:75-151,
    rotate_half/apply at models/rope_attn_fwd.py:8-38)
  * SwiGLU MLP    (reference: modeling_llama.py:188-219, without the
    vestigial pretraining_tp slicing — tensor parallelism is real here and
    lives in parallel/, not in a local loop)
  * attention     (reference: models/rope_attn_fwd.py:66-120) calling the
    attention routes through the dispatching API.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from flash_attention_cute.models.config import ModelConfig


def rms_norm(x: jax.Array, weight: jax.Array, eps: float) -> jax.Array:
    """RMSNorm in fp32, cast back (reference: modeling_llama.py:60-66)."""
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    xf = xf * jax.lax.rsqrt(var + eps)
    return (xf * weight.astype(jnp.float32)).astype(dtype)


def rope_inv_freq(cfg: ModelConfig) -> jax.Array:
    """Inverse frequencies with scaling variants.

    default/linear/dynamic mirror the reference fork
    (reference: modeling_llama.py:75-151); llama3 implements the
    frequency-banded scaling used by Llama-3.x checkpoints. "dynamic" NTK is
    evaluated at max_position_embeddings (static shapes under jit; the
    reference recomputes per observed length, which would recompile per
    shape under jit — an explicit design change).
    """
    d = cfg.head_dim
    inv = 1.0 / (
        cfg.rope_theta
        ** (jnp.arange(0, d, 2, dtype=jnp.float32) / d)
    )
    sc = cfg.rope_scaling
    if sc is None or sc.rope_type == "default":
        return inv
    if sc.rope_type == "linear":
        return inv / sc.factor
    if sc.rope_type == "dynamic":
        seq = cfg.max_position_embeddings
        orig = sc.original_max_position_embeddings or seq
        alpha = (sc.factor * seq / orig) - (sc.factor - 1)
        base = cfg.rope_theta * alpha ** (d / (d - 2))
        return 1.0 / (base ** (jnp.arange(0, d, 2, dtype=jnp.float32) / d))
    if sc.rope_type == "llama3":
        low = sc.original_max_position_embeddings / sc.low_freq_factor
        high = sc.original_max_position_embeddings / sc.high_freq_factor
        wavelen = 2 * jnp.pi / inv
        smooth = (sc.original_max_position_embeddings / wavelen - sc.low_freq_factor) / (
            sc.high_freq_factor - sc.low_freq_factor
        )
        smooth = jnp.clip(smooth, 0.0, 1.0)
        scaled = (1 - smooth) * inv / sc.factor + smooth * inv
        return jnp.where(
            wavelen > low, inv / sc.factor, jnp.where(wavelen < high, inv, scaled)
        )
    raise ValueError(f"unknown rope_type {sc.rope_type}")


def rope_cos_sin(
    positions: jax.Array, inv_freq: jax.Array, dtype
) -> tuple[jax.Array, jax.Array]:
    """positions [B, S] -> cos/sin [B, S, D] (half-dim frequencies tiled)."""
    freqs = positions[..., None].astype(jnp.float32) * inv_freq  # [B, S, D/2]
    emb = jnp.concatenate([freqs, freqs], axis=-1)
    return jnp.cos(emb).astype(dtype), jnp.sin(emb).astype(dtype)


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x [B, H, S, D]; cos/sin [B, S, D]
    (reference: models/rope_attn_fwd.py:8-38 rotate_half convention)."""
    c = cos[:, None]
    s = sin[:, None]
    half = x.shape[-1] // 2
    rotated = jnp.concatenate([-x[..., half:], x[..., :half]], axis=-1)
    return x * c + rotated * s


def dense(x: jax.Array, w) -> jax.Array:
    """x @ w for either a plain array or an int8 QuantizedWeight
    (ops/quantized_matmul.py — weight-only quantization, per-out-channel
    scales; decode streams half the bytes)."""
    from flash_attention_cute.ops.quantized_matmul import (
        QuantizedWeight,
        QuantizedWeight4,
        quantized_matmul,
    )

    if isinstance(w, (QuantizedWeight, QuantizedWeight4)):
        return quantized_matmul(x, w)
    return jnp.dot(x, w)


def _maybe_lora(x, out, proj, lora_l, ids, scaling):
    if lora_l is None or proj not in lora_l:
        return out
    from flash_attention_cute.models.lora import lora_delta

    return out + lora_delta(x, lora_l[proj], ids, scaling)


def mlp(x: jax.Array, p: dict, activation: str = "silu",
        lora_l=None, lora_ids=None, lora_scaling=None) -> jax.Array:
    """Gated MLP: down(act(gate(x)) * up(x)) — SwiGLU for Llama/Qwen2,
    GeGLU (tanh-approximated gelu) for Gemma2. Optional per-row LoRA
    deltas on any of the three projections."""
    if "gate_up_proj" in p:  # fused pytree (models/fuse.py)
        gu = dense(x, p["gate_up_proj"])
        f = gu.shape[-1] // 2
        gate = _maybe_lora(x, gu[..., :f], "gate_proj",
                           lora_l, lora_ids, lora_scaling)
        up = _maybe_lora(x, gu[..., f:], "up_proj",
                         lora_l, lora_ids, lora_scaling)
    else:
        gate = _maybe_lora(x, dense(x, p["gate_proj"]), "gate_proj",
                           lora_l, lora_ids, lora_scaling)
        up = _maybe_lora(x, dense(x, p["up_proj"]), "up_proj",
                         lora_l, lora_ids, lora_scaling)
    if activation == "silu":
        act = jax.nn.silu(gate)
    elif activation == "gelu_tanh":
        act = jax.nn.gelu(gate, approximate=True)
    else:
        raise ValueError(f"unknown activation {activation!r}")
    h = act * up
    return _maybe_lora(h, dense(h, p["down_proj"]), "down_proj",
                       lora_l, lora_ids, lora_scaling)


def layer_tail(x: jax.Array, attn: jax.Array, lp: dict, cfg,
               lora_l=None, lora_ids=None, lora_scaling=None) -> jax.Array:
    """Residual tail shared by every layer body: attention output
    projection + MLP, with either the Llama structure or Gemma2's
    sandwich norms (post-attention and pre/post-feedforward RMSNorms;
    `post_ln` holds HF's post_attention_layernorm in both cases)."""
    a = attention_output(attn, lp, cfg, lora_l, lora_ids, lora_scaling)
    if cfg.sandwich_norms:
        x = x + rms_norm(a, lp["post_ln"], cfg.rms_norm_eps)
        h = rms_norm(x, lp["pre_ffw_ln"], cfg.rms_norm_eps)
        m = mlp(h, lp, cfg.hidden_activation, lora_l, lora_ids,
                lora_scaling)
        return x + rms_norm(m, lp["post_ffw_ln"], cfg.rms_norm_eps)
    x = x + a
    h = rms_norm(x, lp["post_ln"], cfg.rms_norm_eps)
    return x + mlp(h, lp, cfg.hidden_activation, lora_l, lora_ids,
                   lora_scaling)


def qkv_project(
    x: jax.Array, p: dict, cfg: ModelConfig,
    lora_l=None, lora_ids=None, lora_scaling=None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """x [B, S, E] -> q [B, Hq, S, D], k/v [B, Hkv, S, D].

    Fused pytrees (models/fuse.py) run ONE qkv matmul and split — same
    math per output column, one weight stream instead of three."""
    b, s, _ = x.shape
    if "qkv_proj" in p:
        hq = cfg.num_q_heads * cfg.head_dim
        hkv = cfg.num_kv_heads * cfg.head_dim
        qkv = dense(x, p["qkv_proj"])
        if cfg.attention_bias:
            qkv = qkv + p["qkv_bias"]
        q = qkv[..., :hq]
        k = qkv[..., hq:hq + hkv]
        v = qkv[..., hq + hkv:]
        q = _maybe_lora(x, q, "q_proj", lora_l, lora_ids, lora_scaling)
        k = _maybe_lora(x, k, "k_proj", lora_l, lora_ids, lora_scaling)
        v = _maybe_lora(x, v, "v_proj", lora_l, lora_ids, lora_scaling)
    else:
        q = _maybe_lora(x, dense(x, p["q_proj"]), "q_proj",
                        lora_l, lora_ids, lora_scaling)
        k = _maybe_lora(x, dense(x, p["k_proj"]), "k_proj",
                        lora_l, lora_ids, lora_scaling)
        v = _maybe_lora(x, dense(x, p["v_proj"]), "v_proj",
                        lora_l, lora_ids, lora_scaling)
        if cfg.attention_bias:
            q = q + p["q_bias"]
            k = k + p["k_bias"]
            v = v + p["v_bias"]
    q = q.reshape(b, s, cfg.num_q_heads, cfg.head_dim).transpose(0, 2, 1, 3)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(0, 2, 1, 3)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(0, 2, 1, 3)
    return q, k, v


def attention_output(
    attn: jax.Array, p: dict, cfg: ModelConfig,
    lora_l=None, lora_ids=None, lora_scaling=None,
) -> jax.Array:
    """attn [B, Hq, S, D] -> o_proj output [B, S, E]."""
    b, _, s, _ = attn.shape
    attn = attn.transpose(0, 2, 1, 3).reshape(b, s, cfg.num_q_heads * cfg.head_dim)
    return _maybe_lora(attn, dense(attn, p["o_proj"]), "o_proj",
                       lora_l, lora_ids, lora_scaling)
