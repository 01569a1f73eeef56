"""Named model-shape presets for benchmarks and tests.

The reference benches Llama-2-7B-like shapes and accepts any HF Llama/Qwen2
id (reference: scripts/benchmark_llm.py:184-197); these are the equivalent
built-in shapes, runnable with random weights when no checkpoint is local.
"""

from __future__ import annotations

import jax.numpy as jnp

from flash_attention_cute.models.llama import (
    llama2_7b_config,
    llama3_8b_config,
)
from flash_attention_cute.models.gemma2 import gemma2_9b_config
from flash_attention_cute.models.mistral import mistral_7b_config
from flash_attention_cute.models.qwen2 import qwen2_7b_config

def _tiny_config(dtype=jnp.bfloat16):
    from flash_attention_cute.models.config import tiny_test_config

    return tiny_test_config(dtype=dtype)


PRESETS = {
    "llama2-7b": llama2_7b_config,
    "llama3-8b": llama3_8b_config,
    "qwen2-7b": qwen2_7b_config,
    "gemma2-9b": gemma2_9b_config,
    "mistral-7b": mistral_7b_config,
    # CPU-runnable shape for smoke-testing the bench CLIs end to end.
    "tiny": _tiny_config,
}


def get_preset(name: str, dtype=jnp.bfloat16):
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name](dtype=dtype)
