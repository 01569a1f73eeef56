"""Qwen2 family adapter.

Replaces the reference's vendored Qwen2 fork + monkeypatcher
(reference: models/modeling_qwen2.py, models/patch_qwen2.py:4-5).
Architectural deltas vs Llama, all expressed as config:
  * QKV projection biases (reference: modeling_qwen2.py:211-214)
  * commonly tied word embeddings (small checkpoints)
  * sliding-window attention — the reference *raises* when a checkpoint
    enables it (reference: modeling_qwen2.py:261-269); here every
    attention route masks it (ops/attention.py, ops/paged_attention.py)
    with HF layer semantics (window on layers >= max_window_layers).
"""

from __future__ import annotations

import jax.numpy as jnp

from flash_attention_cute.models.config import ModelConfig


def qwen2_config_from_hf(hf_config, dtype=jnp.bfloat16) -> ModelConfig:
    get = (lambda k, d=None: getattr(hf_config, k, d)) if not isinstance(
        hf_config, dict
    ) else (lambda k, d=None: hf_config.get(k, d))

    head_dim = get("head_dim") or get("hidden_size") // get("num_attention_heads")
    return ModelConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_layers=get("num_hidden_layers"),
        num_q_heads=get("num_attention_heads"),
        num_kv_heads=get("num_key_value_heads", get("num_attention_heads")),
        head_dim=head_dim,
        max_position_embeddings=get("max_position_embeddings", 32768),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        rope_theta=get("rope_theta", 1000000.0),
        attention_bias=True,  # Qwen2 always has QKV bias
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        sliding_window=get("sliding_window"),
        use_sliding_window=bool(get("use_sliding_window", False)),
        max_window_layers=get("max_window_layers", 0) or 0,
        dtype=dtype,
    )


def qwen2_7b_config(dtype=jnp.bfloat16) -> ModelConfig:
    """Qwen2-7B shapes (BASELINE.json config #3: 28 q / 4 kv heads)."""
    return ModelConfig(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_q_heads=28,
        num_kv_heads=4,
        head_dim=128,
        max_position_embeddings=32768,
        rms_norm_eps=1e-6,
        rope_theta=1000000.0,
        attention_bias=True,
        dtype=dtype,
    )
