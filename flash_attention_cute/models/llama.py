"""Llama family adapter.

Replaces the reference's vendored Llama fork + monkeypatcher
(reference: models/modeling_llama.py, models/patch_llama.py:4-5). Here the
"patch" is a config mapping: any HF LlamaConfig-compatible checkpoint runs
on the shared transformer core and attention routes.
"""

from __future__ import annotations

import jax.numpy as jnp

from flash_attention_cute.models.config import ModelConfig, RopeScaling


def llama_config_from_hf(hf_config, dtype=jnp.bfloat16) -> ModelConfig:
    """Map a transformers `LlamaConfig` (or dict) to ModelConfig."""
    get = (lambda k, d=None: getattr(hf_config, k, d)) if not isinstance(
        hf_config, dict
    ) else (lambda k, d=None: hf_config.get(k, d))

    head_dim = get("head_dim") or get("hidden_size") // get("num_attention_heads")
    rs = get("rope_scaling")
    rope_scaling = None
    if rs:
        rope_scaling = RopeScaling(
            rope_type=rs.get("rope_type", rs.get("type", "default")),
            factor=rs.get("factor", 1.0),
            low_freq_factor=rs.get("low_freq_factor", 1.0),
            high_freq_factor=rs.get("high_freq_factor", 4.0),
            original_max_position_embeddings=rs.get(
                "original_max_position_embeddings",
                get("max_position_embeddings", 8192),
            ),
        )
    return ModelConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_layers=get("num_hidden_layers"),
        num_q_heads=get("num_attention_heads"),
        num_kv_heads=get("num_key_value_heads", get("num_attention_heads")),
        head_dim=head_dim,
        max_position_embeddings=get("max_position_embeddings", 4096),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        attention_bias=bool(get("attention_bias", False)),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        dtype=dtype,
    )


def llama3_8b_config(dtype=jnp.bfloat16) -> ModelConfig:
    """Llama-3-8B shapes (BASELINE.json config #2)."""
    return ModelConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_q_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_position_embeddings=8192,
        rms_norm_eps=1e-5,
        rope_theta=500000.0,
        dtype=dtype,
    )


def llama2_7b_config(dtype=jnp.bfloat16) -> ModelConfig:
    """Llama-2-7B shapes (the reference's docstring example model,
    reference: scripts/benchmark_llm.py:184-197)."""
    return ModelConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_layers=32,
        num_q_heads=32,
        num_kv_heads=32,
        head_dim=128,
        max_position_embeddings=4096,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
        dtype=dtype,
    )
