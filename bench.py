"""Headline benchmark: causal attention TFLOP/s on the reference's default
kernel config (reference: scripts/benchmark_kernel.py:127-136 — B=16,
Hq=64, Hkv=8, Sq=Skv=1024, D=128, Llama-2-7B-like GQA, causal), bf16, on
one GPU.

Prints the device and the card's name and power limit, then exactly ONE
JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

`value` is the rate of the route `flash_attn_func` dispatches to (cuDNN's
fused attention on the GPU); `vs_baseline` is its speedup over the
grouped XLA attention route. Exits non-zero without a GPU.
"""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp


def main():
    from flash_attention_cute import flash_attn_func
    from flash_attention_cute.ops.attention import xla_attention
    from flash_attention_cute.utils.compile_cache import enable_compile_cache
    from flash_attention_cute.utils.profiling import (
        card_name_and_power_limit,
        require_gpu,
    )
    from flash_attention_cute.utils.timing import time_fn

    dev = require_gpu()
    enable_compile_cache()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    print(f"card: {card_name_and_power_limit()}")

    B, HQ, HKV, S, D = 16, 64, 8, 1024, 128
    ks = jax.random.split(jax.random.key(0), 3)
    q = jax.random.normal(ks[0], (B, HQ, S, D), jnp.bfloat16)
    k = jax.random.normal(ks[1], (B, HKV, S, D), jnp.bfloat16)
    v = jax.random.normal(ks[2], (B, HKV, S, D), jnp.bfloat16)

    routed = jax.jit(functools.partial(flash_attn_func, causal=True))
    plain = jax.jit(
        functools.partial(xla_attention, sm_scale=D ** -0.5, causal=True)
    )
    t_routed = time_fn(routed, (q, k, v), iters=20, repeats=5)
    t_plain = time_fn(plain, (q, k, v), iters=5, repeats=3)

    # Causal attention FLOPs: 2 matmuls x 2 flops x half the score matrix.
    flops = 4 * B * HQ * S * S * D * 0.5
    print(json.dumps({
        "metric": "flash_attn_fwd_bf16_causal_B16_H64_S1024_D128",
        "value": flops / t_routed / 1e12,
        "unit": "TFLOP/s",
        "vs_baseline": t_plain / t_routed,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    main()
