"""End-to-end generation throughput benchmark CLI.

JAX analog of the reference's wall-clock `model.generate()` bench
(reference: scripts/benchmark_llm_e2e.py:28-59): measures total tokens/s
for prefill + full decode through `runtime.generate`, the framework's
compiled generation loop. Needs a GPU.

Usage:
  python scripts/benchmark_llm_e2e.py --model llama3-8b --num-layers 8 \
      --batch 8 --prompt-len 1024 --max-new-tokens 256
"""

from __future__ import annotations

import pathlib
import sys

# Runnable as `python scripts/<name>.py` from anywhere, without installing.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import argparse
import dataclasses
import sys
import time

import jax
import jax.numpy as jnp


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="llama3-8b")
    p.add_argument("--hf", action="store_true")
    p.add_argument("--num-layers", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=1024)
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy (the reference benches greedy decode)")
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    from flash_attention_cute.utils.compile_cache import enable_compile_cache
    from flash_attention_cute.utils.profiling import (
        card_name_and_power_limit,
        require_gpu,
    )

    dev = require_gpu()
    enable_compile_cache()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    print(f"card: {card_name_and_power_limit()}")
    dtype = jnp.bfloat16 if a.dtype == "bf16" else jnp.float32

    from flash_attention_cute.models import init_params
    from flash_attention_cute.runtime.generate import generate
    from flash_attention_cute.runtime.sampling import SamplingParams

    if a.hf:
        from flash_attention_cute.models.convert import load_hf_model
        cfg, params = load_hf_model(a.model, dtype=dtype)
    else:
        from flash_attention_cute.models.presets import PRESETS
        if a.model not in PRESETS:
            sys.exit(f"unknown preset {a.model!r}; have {sorted(PRESETS)}")
        cfg = PRESETS[a.model](dtype=dtype)
        if a.num_layers:
            cfg = dataclasses.replace(cfg, num_layers=a.num_layers)
        params = init_params(cfg, jax.random.key(0))

    ids = jax.random.randint(
        jax.random.key(1), (a.batch, a.prompt_len), 0, cfg.vocab_size
    ).astype(jnp.int32)
    sampling = SamplingParams(temperature=a.temperature)

    def run():
        out = generate(
            params, cfg, ids, max_new_tokens=a.max_new_tokens,
            sampling=sampling,
        )
        return jax.block_until_ready(out)

    run()  # compile + warmup
    times = []
    for _ in range(a.trials):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    t = min(times)
    total_new = a.batch * a.max_new_tokens
    print(f"model={a.model} layers={cfg.num_layers} batch={a.batch} "
          f"prompt={a.prompt_len} new={a.max_new_tokens}")
    print(f"e2e generate: {t:8.3f} s   {total_new / t:10.1f} new tokens/s   "
          f"{(total_new + a.batch * a.prompt_len) / t:10.1f} total tokens/s")


if __name__ == "__main__":
    main()
