"""Gemma 2 model family (third family, beyond the reference's two).

The reference integrates Llama and Qwen2 only (reference:
models/modeling_llama.py, models/modeling_qwen2.py) — Gemma 2 is the
family its open-roadmap features point at: tanh logit soft-capping (every
attention route takes `logit_softcap` for this), ALTERNATING sliding-
window / full-attention layers, GeGLU MLPs, sandwich RMSNorms around
both residual branches, (1+w) RMSNorm weights (folded at conversion),
sqrt(hidden)-scaled embeddings, a query_pre_attn_scalar attention scale
decoupled from head_dim, and a final-logit soft-cap. All of it is config
bits over the same functional trunk (`models/transformer.py`) and the
same paged serving path (`runtime/paged_forward.py`).
"""

from __future__ import annotations

import jax.numpy as jnp

from flash_attention_cute.models.config import ModelConfig


def gemma2_config_from_hf(hf_cfg, dtype=jnp.bfloat16) -> ModelConfig:
    """transformers.Gemma2Config -> ModelConfig."""
    window = getattr(hf_cfg, "sliding_window", None)
    # HF layer_types alternates sliding/full starting at layer 0; encode
    # it as a periodic per-layer window pattern.
    layer_types = getattr(hf_cfg, "layer_types", None)
    if layer_types is not None and len(layer_types) >= 2:
        period = (
            window if layer_types[0] == "sliding_attention" else None,
            window if layer_types[1] == "sliding_attention" else None,
        )
    else:
        period = (window, None)
    scalar = getattr(hf_cfg, "query_pre_attn_scalar", hf_cfg.head_dim)
    return ModelConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_q_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_key_value_heads,
        head_dim=hf_cfg.head_dim,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rms_norm_eps=hf_cfg.rms_norm_eps,
        rope_theta=hf_cfg.rope_theta,
        attention_bias=bool(getattr(hf_cfg, "attention_bias", False)),
        tie_word_embeddings=True,  # all Gemma 2 checkpoints tie
        logit_softcap=getattr(hf_cfg, "attn_logit_softcapping", None),
        final_logit_softcap=getattr(
            hf_cfg, "final_logit_softcapping", None
        ),
        hidden_activation="gelu_tanh",
        attention_scale=float(scalar) ** -0.5,
        sandwich_norms=True,
        scale_embeddings=True,
        rms_norm_plus_one=True,
        layer_window_pattern=period if window else None,
        dtype=dtype,
    )


def gemma2_9b_config(dtype=jnp.bfloat16) -> ModelConfig:
    """Gemma-2-9B shape (random-weight benchmarks)."""
    return ModelConfig(
        vocab_size=256000,
        hidden_size=3584,
        intermediate_size=14336,
        num_layers=42,
        num_q_heads=16,
        num_kv_heads=8,
        head_dim=256,
        max_position_embeddings=8192,
        rms_norm_eps=1e-6,
        rope_theta=10000.0,
        tie_word_embeddings=True,
        logit_softcap=50.0,
        final_logit_softcap=30.0,
        hidden_activation="gelu_tanh",
        attention_scale=256.0 ** -0.5,
        sandwich_norms=True,
        scale_embeddings=True,
        rms_norm_plus_one=True,
        layer_window_pattern=(4096, None),
        dtype=dtype,
    )
