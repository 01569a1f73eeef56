"""Mistral model family (fourth family, beyond the reference's two).

Architecturally Llama with a UNIFORM sliding window on every layer
(the reference *raises* on sliding windows,
models/modeling_qwen2.py:261-269; here they are native) — pure config
over the shared trunk.
"""

from __future__ import annotations

import jax.numpy as jnp

from flash_attention_cute.models.config import ModelConfig


def mistral_config_from_hf(hf_cfg, dtype=jnp.bfloat16) -> ModelConfig:
    """transformers.MistralConfig -> ModelConfig."""
    window = getattr(hf_cfg, "sliding_window", None)
    head_dim = getattr(hf_cfg, "head_dim", None) or (
        hf_cfg.hidden_size // hf_cfg.num_attention_heads
    )
    return ModelConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_q_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_key_value_heads,
        head_dim=head_dim,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rms_norm_eps=hf_cfg.rms_norm_eps,
        rope_theta=hf_cfg.rope_theta,
        tie_word_embeddings=bool(
            getattr(hf_cfg, "tie_word_embeddings", False)
        ),
        # Every layer windowed (max_window_layers=0 suffix semantics).
        sliding_window=window,
        use_sliding_window=window is not None,
        max_window_layers=0,
        dtype=dtype,
    )


def mistral_7b_config(dtype=jnp.bfloat16) -> ModelConfig:
    """Mistral-7B-v0.1 shape (random-weight benchmarks)."""
    return ModelConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_q_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_position_embeddings=32768,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
        sliding_window=4096,
        use_sliding_window=True,
        max_window_layers=0,
        dtype=dtype,
    )
