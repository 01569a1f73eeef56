"""Continuous-batching serving benchmark (the BASELINE north-star path).

Submits a mixed-length request stream to the ServingEngine (paged KV +
native C++ scheduler) and reports aggregate decode throughput, slot
occupancy, and scheduler stats. The reference has no serving stack to
compare against (its e2e story is HF generate,
reference: scripts/benchmark_llm_e2e.py); this measures ours.

Usage:
  python scripts/benchmark_serving.py --model llama3-8b --num-layers 4 \
      --slots 4 --requests 12 --page-size 128
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="llama3-8b")
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--min-prompt", type=int, default=64)
    p.add_argument("--max-prompt", type=int, default=512)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--page-size", type=int, default=128,
                   help="tokens per KV page")
    p.add_argument("--num-pages", type=int, default=0, help="0 = sized to fit")
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--decode-chunk", type=int, default=8,
                   help="tokens decoded per engine round in one jitted "
                        "scan; larger amortizes host round trips, "
                        "smaller tightens admission latency")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help=">0: chunked admission (bounds HOL blocking)")
    p.add_argument("--prefill-group", type=int, default=1,
                   help=">1: batch same-bucket admissions into one "
                        "prefill forward (fewer dispatches)")
    p.add_argument("--speculative", choices=["off", "self", "trim", "ngram"],
                   default="off",
                   help="engine-level speculative decoding: 'self' drafts "
                        "with the target itself (100%% acceptance — the "
                        "mechanism's upper bound), 'trim' with a "
                        "--draft-layers-deep copy (realistic draft cost; "
                        "acceptance is meaningless with random weights), "
                        "'ngram' draft-free prompt lookup")
    p.add_argument("--spec-gamma", type=int, default=4)
    p.add_argument("--spec-rounds", type=int, default=4,
                   help="draft/verify rounds folded into one device "
                        "program (the speculative analog of decode-chunk)")
    p.add_argument("--draft-layers", type=int, default=1)
    p.add_argument("--prefix-cache", action="store_true",
                   help="automatic prefix caching (shared-prompt KV "
                        "reuse); pair with --shared-prefix to give the "
                        "request stream a common system prompt")
    p.add_argument("--shared-prefix", type=int, default=0,
                   help="tokens of system prompt shared by ALL requests")
    p.add_argument("--quantize-weights", action="store_true",
                   help="int8 weight-only quantization of every "
                        "projection (models/quantize.py)")
    p.add_argument("--init-host", action="store_true",
                   help="with --quantize-weights: init + quantize on the "
                        "host CPU and ship only the quantized image (for "
                        "models whose dense image exceeds device memory)")
    p.add_argument("--weight-bits", type=int, choices=[8, 4], default=8,
                   help="with --quantize-weights: 8 = per-channel int8, "
                        "4 = 128-group int4 (capacity play)")
    p.add_argument("--fuse-projections", action="store_true",
                   help="fold q/k/v and gate/up into single wide matmuls "
                        "(models/fuse.py): 7 -> 4 weight streams per "
                        "layer; composes with --quantize-weights")
    p.add_argument("--kv-dtype", choices=["model", "int8", "fp8"],
                   default="model",
                   help="KV page-pool dtype (int8/fp8: quantized pages, "
                        "2x resident sequences per HBM byte)")
    p.add_argument("--load-params", default=None, metavar="DIR",
                   help="restore (cfg, params) from a checkpoint written "
                        "by benchmark_llm.py --save-params (quantized "
                        "pytrees restore as quantized); skips the "
                        "~20 min full-depth host init+quantize")
    return p.parse_args(argv)


def _pct(xs, q):
    xs = sorted(x for x in xs if x is not None)
    if not xs:
        return float("nan")
    i = min(len(xs) - 1, max(0, int(round(q / 100 * (len(xs) - 1)))))
    return xs[i]


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
    from flash_attention_cute.models.presets import PRESETS
    from flash_attention_cute.runtime.engine import ServingEngine

    if a.load_params:
        import time as _time
        from flash_attention_cute.models.checkpoint import (
            load_checkpoint,
        )
        t0 = _time.perf_counter()
        cfg, params = load_checkpoint(a.load_params)
        params = jax.device_put(params, jax.devices()[0])
        jax.block_until_ready(jax.tree.leaves(params)[0])
        print(f"checkpoint restore+upload: {_time.perf_counter()-t0:.1f} s")
    else:
        cfg = PRESETS[a.model](dtype=dtype)
        if a.num_layers:
            cfg = dataclasses.replace(cfg, num_layers=a.num_layers)
        maybe_fuse = (lambda p: p)
        if a.fuse_projections:
            from flash_attention_cute.models.fuse import (
                fuse_projections,
            )
            maybe_fuse = fuse_projections
        if a.quantize_weights:
            import functools
            from flash_attention_cute.models.quantize import (
                quantize_params, quantize_params_on_host,
            )
            if a.init_host:
                from flash_attention_cute.models.transformer import (
                    init_params_host,
                )
                params = quantize_params_on_host(
                    lambda: maybe_fuse(init_params_host(cfg, seed=0)),
                    bits=a.weight_bits)
            else:
                params = jax.block_until_ready(
                    jax.jit(functools.partial(quantize_params,
                                              bits=a.weight_bits))(
                        maybe_fuse(init_params(cfg, jax.random.key(0))))
                )
        else:
            params = maybe_fuse(init_params(cfg, jax.random.key(0)))

    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, a.shared_prefix).tolist()
    prompts = {
        rid: system + rng.integers(
            0, cfg.vocab_size, int(rng.integers(a.min_prompt, a.max_prompt + 1))
        ).tolist()
        for rid in range(a.requests)
    }

    kv_dtype = {"model": None, "int8": jnp.int8,
                "fp8": jnp.float8_e4m3fn}[a.kv_dtype]

    # Speculative scatters transiently touch up to gamma positions past
    # the accepted length (spec_engine pool-sizing rule).
    slack = a.spec_gamma if a.speculative != "off" else 0
    max_tokens = a.shared_prefix + a.max_prompt + a.max_new_tokens + slack
    pages_per_seq = -(-max_tokens // a.page_size)
    num_pages = a.num_pages or (a.slots * pages_per_seq + 1)

    if a.speculative != "off":
        from flash_attention_cute.runtime.spec_engine import (
            SpeculativeServingEngine,
        )

        spec_kw = dict(
            gamma=a.spec_gamma, rounds_per_call=a.spec_rounds,
            slots=a.slots, num_pages=num_pages,
            page_size=a.page_size, pages_per_seq=pages_per_seq,
            prefill_group=a.prefill_group,
            enable_prefix_cache=a.prefix_cache, kv_dtype=kv_dtype,
        )
        if a.speculative == "ngram":
            eng = SpeculativeServingEngine(params, cfg, ngram=2, **spec_kw)
        else:
            if a.speculative == "self":
                draft_cfg, draft_params = cfg, params
            else:
                draft_cfg = dataclasses.replace(
                    cfg, num_layers=a.draft_layers
                )
                draft_params = dict(
                    params,
                    layers=jax.tree.map(
                        lambda x: x[: a.draft_layers], params["layers"]
                    ),
                )
            eng = SpeculativeServingEngine(
                params, cfg, draft_params=draft_params,
                draft_cfg=draft_cfg, **spec_kw,
            )
    else:
        eng = ServingEngine(
            params, cfg, slots=a.slots, num_pages=num_pages,
            page_size=a.page_size, pages_per_seq=pages_per_seq,
            decode_chunk=a.decode_chunk, prefill_chunk=a.prefill_chunk,
            prefill_group=a.prefill_group,
            enable_prefix_cache=a.prefix_cache, kv_dtype=kv_dtype,
        )

    print(f"model={a.model} layers={cfg.num_layers} slots={a.slots} "
          f"requests={a.requests} pages={num_pages}x{a.page_size} "
          f"sched={'c++' if eng.native else 'python'}")

    # Warmup wave: populate the compile cache for every prompt bucket and
    # the decode chunk, so the measured wave is steady-state serving.
    # With the prefix cache on, wave 1 also populates the CACHE, which
    # changes the admission buckets every later wave sees (near-full
    # prefix hits -> short-suffix buckets wave 1 never compiled); a
    # second warmup wave runs against exactly the cache state the
    # measured wave will see and compiles those buckets.
    warm_waves = 2 if a.prefix_cache else 1
    t0 = time.perf_counter()
    for wave in range(warm_waves):
        for rid, p in prompts.items():
            eng.submit(rid + (wave + 1) * 1_000_000, p, a.max_new_tokens)
        eng.run()
    print(f"warmup (cold, incl. compiles): {time.perf_counter() - t0:7.2f} s")
    eng.stats = {k: 0 for k in eng.stats}
    eng.metrics.clear()

    for rid, p in prompts.items():
        eng.submit(rid, p, a.max_new_tokens)
    t0 = time.perf_counter()
    results = eng.run()
    wall = time.perf_counter() - t0
    # eng.run() returns ALL completed requests incl. the warmup wave.
    results = {rid: toks for rid, toks in results.items() if rid < 1_000_000}

    st = eng.stats
    total_new = st["tokens_generated"]
    total_prompt = sum(len(p) for p in prompts.values())
    print(f"finished {st['requests_finished']}/{a.requests} "
          f"(failed {st['requests_failed']}, preemptions {st['preemptions']}, "
          f"prefills {st['prefills']}, steps {st['steps']})")
    print(f"wall {wall:7.2f} s   "
          f"{total_new / wall:8.1f} new tokens/s   "
          f"{(total_new + total_prompt) / wall:8.1f} total tokens/s")
    # Dispatch receipts: host round trips per generated token.
    print(f"device dispatches {st['device_calls']}   "
          f"round-trips/token {st['device_calls'] / max(total_new, 1):.4f}  "
          f"(decode_chunk={a.decode_chunk})")
    if a.speculative != "off":
        verifies = st["spec_calls"] * a.spec_rounds
        print(f"spec: calls {st['spec_calls']}  accepted drafts "
              f"{st['accepted_drafts']}  new-tokens/verify-forward "
              f"{total_new / max(verifies, 1):.2f} (ceiling "
              f"{a.spec_gamma + 1})")
    if a.prefix_cache:
        print(f"prefix cache: hit tokens {st['prefix_hit_tokens']}  "
              f"evictions {st['prefix_evictions']}")
    ttfts = [m["ttft_s"] for m in eng.request_metrics]
    e2es = [m["e2e_s"] for m in eng.request_metrics]
    print(f"TTFT p50 {_pct(ttfts, 50)*1e3:8.1f} ms   "
          f"p95 {_pct(ttfts, 95)*1e3:8.1f} ms   "
          f"max {_pct(ttfts, 100)*1e3:8.1f} ms")
    print(f"e2e  p50 {_pct(e2es, 50)*1e3:8.1f} ms   "
          f"p95 {_pct(e2es, 95)*1e3:8.1f} ms   "
          f"max {_pct(e2es, 100)*1e3:8.1f} ms")
    assert len(results) + st["requests_failed"] == a.requests


if __name__ == "__main__":
    main()
