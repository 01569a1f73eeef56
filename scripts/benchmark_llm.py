"""Per-phase LLM throughput benchmark CLI (prefill + decode + sanity decode).

JAX analog of the reference's LLM benchmark
(reference: scripts/benchmark_llm.py): loads a model, runs the attention
stack with the custom kernels, reports prefill throughput (tokens/s) and
per-token decode throughput, then a greedy-decode sanity generation.

Differences by design (SURVEY.md §7): the model is the framework's own JAX
stack (models/transformer.py) rather than a patched HF torch model, the
decode loop is a single compiled lax.scan instead of a Python per-token
loop (reference: scripts/benchmark_llm.py:65-92), and timing brackets
warmed calls that end in `block_until_ready` (utils/timing.py) instead of
CUDA events. Timing needs a GPU.

Usage:
  # random weights at Llama-3-8B width, trimmed depth
  python scripts/benchmark_llm.py --model llama3-8b --num-layers 8 \
      --batch 8 --prompt-len 1024 --max-new-tokens 128
  # real weights from a local HF checkout
  python scripts/benchmark_llm.py --model /path/to/Llama-3-8B --hf \
      --prompt "Write a report on ..."
"""

from __future__ import annotations

import pathlib
import sys

# Runnable as `python scripts/<name>.py` from anywhere, without installing.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import argparse
import dataclasses
import functools
import sys
import time

import jax
import jax.numpy as jnp

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="llama3-8b",
                   help="preset name (llama2-7b | llama3-8b | qwen2-7b) or, "
                        "with --hf, a local HF checkpoint directory")
    p.add_argument("--hf", action="store_true",
                   help="load real weights via models/convert.py")
    p.add_argument("--num-layers", type=int, default=0,
                   help="override layer count (0 = preset's)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=1024)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--prompt", default=None,
                   help="real text prompt (requires --hf for a tokenizer); "
                        "otherwise random token ids are used")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--quantize-weights", action="store_true",
                   help="int8 weight-only quantization of every "
                        "projection (models/quantize.py)")
    p.add_argument("--weight-bits", type=int, choices=[8, 4], default=8,
                   help="with --quantize-weights: 8 = per-channel int8 "
                        "(near-lossless), 4 = 128-group int4 (half the "
                        "bytes again)")
    p.add_argument("--cache-dtype", choices=["model", "int8", "fp8"],
                   default="model",
                   help="KV cache storage dtype; int8/fp8 halve the "
                        "per-step KV stream (the other half of decode's "
                        "byte budget next to weights)")
    p.add_argument("--fuse-projections", action="store_true",
                   help="fold q/k/v and gate/up into single wide matmuls "
                        "(models/fuse.py): 7 -> 4 weight streams per "
                        "layer; composes with --quantize-weights")
    p.add_argument("--save-params", default=None, metavar="DIR",
                   help="after building (and optionally quantizing) the "
                        "params, persist them as an orbax checkpoint — "
                        "pairs with --load-params so repeated full-depth "
                        "runs skip the host init+quantize")
    p.add_argument("--load-params", default=None, metavar="DIR",
                   help="restore params (and the self-describing config) "
                        "from a checkpoint written by --save-params; "
                        "quantized pytrees restore as quantized")
    p.add_argument("--init-host", action="store_true",
                   help="with --quantize-weights: init + quantize on the "
                        "host CPU and ship only the quantized image to "
                        "the device (for models whose dense image "
                        "exceeds its memory)")
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
    from flash_attention_cute.runtime.generate import (
        decode_loop, greedy_generate, prefill,
    )

    tokenizer = None
    if a.load_params:
        from flash_attention_cute.models.checkpoint import (
            load_checkpoint,
        )
        t0 = time.perf_counter()
        cfg, params = load_checkpoint(a.load_params)
        # Orbax restores host arrays; pin them to the chip once so jit
        # calls don't re-transfer per dispatch.
        params = jax.device_put(params, jax.devices()[0])
        jax.block_until_ready(jax.tree.leaves(params)[0])
        print(f"checkpoint restore+upload: {time.perf_counter() - t0:.1f} s")
        if a.num_layers:
            sys.exit("--load-params is self-describing; drop --num-layers")
        a.quantize_weights = False  # already applied if the ckpt was quantized
    elif a.hf:
        from flash_attention_cute.models.convert import load_hf_model
        cfg, params = load_hf_model(a.model, dtype=dtype)
        try:
            import transformers
            tokenizer = transformers.AutoTokenizer.from_pretrained(a.model)
        except Exception as e:
            print(f"tokenizer unavailable ({e}); using random ids",
                  file=sys.stderr)
    else:
        from flash_attention_cute.models.presets import PRESETS
        if a.model not in PRESETS:
            sys.exit(f"unknown preset {a.model!r}; have {sorted(PRESETS)} "
                     "(pass --hf for a checkpoint path)")
        cfg = PRESETS[a.model](dtype=dtype)
        if a.num_layers:
            cfg = dataclasses.replace(cfg, num_layers=a.num_layers)
        if a.quantize_weights and a.init_host:
            params = None  # built below without a device-resident bf16 image
        else:
            params = init_params(cfg, jax.random.key(0))

    if a.prompt is not None and tokenizer is not None:
        ids = tokenizer(a.prompt, return_tensors="np")["input_ids"]
        ids = jnp.asarray(ids, jnp.int32)
        ids = jnp.broadcast_to(ids, (a.batch, ids.shape[1]))
    else:
        ids = jax.random.randint(
            jax.random.key(1), (a.batch, a.prompt_len), 0, cfg.vocab_size
        ).astype(jnp.int32)
    maybe_fuse = (lambda p: p)
    if a.fuse_projections and not a.load_params:
        from flash_attention_cute.models.fuse import fuse_projections
        maybe_fuse = fuse_projections
    if a.quantize_weights:
        from flash_attention_cute.models.quantize import (
            quantize_params, quantize_params_on_host,
        )
        if params is None:
            from flash_attention_cute.models.transformer import (
                init_params_host,
            )
            t0 = time.perf_counter()
            params = quantize_params_on_host(
                lambda: maybe_fuse(init_params_host(cfg, seed=0)),
                bits=a.weight_bits)
            print(f"host init+quantize+upload: "
                  f"{time.perf_counter() - t0:.1f} s")
        else:
            params = jax.block_until_ready(
                jax.jit(functools.partial(
                    quantize_params, bits=a.weight_bits))(
                    maybe_fuse(params)))
    elif not a.load_params:
        params = maybe_fuse(params)

    if a.save_params:
        from flash_attention_cute.models.checkpoint import (
            save_checkpoint,
        )
        save_checkpoint(a.save_params, params, cfg)
        print(f"params saved -> {a.save_params}")

    from flash_attention_cute.ops.quantized_matmul import (
        QuantizedWeight, QuantizedWeight4,
    )
    qleaf = params["layers"].get("q_proj")
    wtag = (" weights=int8" if isinstance(qleaf, QuantizedWeight)
            else " weights=int4" if isinstance(qleaf, QuantizedWeight4)
            else "")
    b, s = ids.shape
    capacity = s + a.max_new_tokens
    print(f"model={a.model} layers={cfg.num_layers} batch={b} "
          f"prompt={s} new={a.max_new_tokens} dtype={a.dtype}{wtag}"
          f"{'' if a.cache_dtype == 'model' else ' kv=' + a.cache_dtype}")

    # ---- prefill phase (reference: scripts/benchmark_llm.py:47-63) ----
    from flash_attention_cute.models import forward
    from flash_attention_cute.utils.timing import time_fn

    prefill_fn = jax.jit(
        lambda params, ids: forward(params, cfg, ids, mode="prefill")[0]
    )
    t_prefill = time_fn(prefill_fn, (params, ids), iters=1,
                        repeats=max(1, a.trials))
    print(f"prefill: {t_prefill * 1e3:9.2f} ms   "
          f"{b * s / t_prefill:10.0f} tokens/s")

    # ---- decode phase (reference: scripts/benchmark_llm.py:65-92) ----
    cache_dtype = {"model": None, "int8": jnp.int8,
                   "fp8": jnp.float8_e4m3fn}[a.cache_dtype]
    last_logits, cache0 = prefill(params, cfg, ids, cache_capacity=capacity,
                                  cache_dtype=cache_dtype)
    first = jnp.argmax(last_logits, axis=-1).astype(jnp.int32)
    n = a.max_new_tokens

    def run_decode():
        # decode_loop donates the cache; hand it a fresh copy each call.
        cache = jax.tree.map(jnp.copy, cache0)
        return decode_loop(params, cfg, first, cache, max_new_tokens=n)

    per_tok = time_fn(run_decode, (), iters=1,
                      repeats=max(1, a.trials)) / n
    print(f"decode:  {per_tok * 1e3:9.3f} ms/token   "
          f"{b / per_tok:10.0f} tokens/s   (batch {b}, includes the "
          f"cache copy)")

    # ---- greedy sanity generation (reference: benchmark_llm.py:95-118) ----
    out = greedy_generate(params, cfg, ids[:1, :64], max_new_tokens=32)
    out_ids = jax.device_get(out)[0]
    if tokenizer is not None:
        print("sample:", tokenizer.decode(out_ids))
    else:
        print("sample ids:", out_ids[:16].tolist(), "(random weights)")


if __name__ == "__main__":
    main()
