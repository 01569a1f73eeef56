"""Bring-up check of the serving path on the GPU.

    python chip_smoke.py [--seed N]     # one card
    python chip_smoke.py --four-cards   # tensor- and data-parallel serving

Phases (one card):
  1. Device check: JAX's devices, and the card's name and power limit from
     `nvidia-smi` (a child process that stays off JAX). Fails at once
     without a GPU.
  2. Every attention route and the weight-quantized matmul at real widths
     (Qwen2-7B: 28 q / 4 kv heads; Llama-3 / Mistral: 32 / 8; head_dim
     128), each against the fp32 HIGHEST-precision oracle and with a check
     that it took its GPU path; then the card-only tests (`pytest -m gpu`)
     in this process.
  3. Qwen2-7B at full published widths and depth, random bf16 weights from
     --seed: `greedy_generate` on 2 prompts, a 4-slot `ServingEngine`
     serving 8 requests (128-2048-token prompts, 32 new tokens each), and
     a prefix-cached engine whose 8 requests share a 512-token system
     prompt. Every emitted token is checked for greedy consistency against
     one dense prefill forward over prompt + output. After warm-up waves
     the counted wave must trace no new program.

With --four-cards only the multi-card serving paths run: a tensor-parallel
`ServingEngine` over a 4-way model mesh and a `DataParallelServingEngine`
over 4 one-card replicas, both checked against the one-card dense forward.

Exits non-zero on any failed check. The last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# Tolerances (max-abs error against the fp32 HIGHEST-precision oracle).
# bf16: outputs are convex combinations of V rows of size O(1); bf16 keeps
# 8 mantissa bits and the routes round probabilities (or, for the matmul,
# the output) to bf16, so a correct route stays below 3e-2 while an
# indexing or masking bug is O(1).
TOL_BF16 = 3e-2
# fp32 with the route's precision pinned to HIGHEST: exact up to summation
# order (~1e-6); a TF32 pass would show as ~1e-3 to 1e-2.
TOL_F32 = 1e-3
# Greedy consistency: an emitted token's logit (recomputed by one dense
# bf16 forward over prompt + output) may trail that row's maximum by at
# most this much. Correct bf16 routes differ in rounding only, which
# across 28 layers moves a logit by up to 0.24 on the H100 (the
# prefix-cached engine, whose cached prefix comes from other programs);
# the page, length and mask faults met during bring-up emitted tokens 6.5
# to 7.5 below the maximum of 152k random-weight logits.
GREEDY_EPS = 0.5

QWEN2 = (28, 4, 128)
LLAMA3 = (32, 8, 128)
TRITON_CALL = "__gpu$xla.gpu.triton"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def device_check(count: int):
    import jax

    devices = jax.devices()
    print(f"devices: {devices}")
    if devices[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devices[0].platform!r}); "
             "this check runs only on the card")
    if len(devices) < count:
        fail(f"needs {count} GPUs, JAX sees {len(devices)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"card (name, power limit): {card}")
    return devices


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


class Report:
    def __init__(self):
        self.failures: list[str] = []

    def check(self, name, got, want, tol, path_ok, path):
        import jax.numpy as jnp

        err = float(jnp.max(jnp.abs(
            jnp.asarray(got, jnp.float32) - jnp.asarray(want, jnp.float32)
        )))
        ok = err <= tol and bool(path_ok)
        print(f"  {name:<44} max_err {err:.3e} <= {tol:.0e}  "
              f"path: {path} {'ok' if path_ok else 'MISSING'}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(name)


def _lowered(fn, *args) -> str:
    import jax

    return jax.jit(fn).lower(*args).as_text()


def _compiled(fn, *args) -> str:
    import jax

    return jax.jit(fn).lower(*args).compile().as_text()


def kernel_checks(seed: int) -> list[str]:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flash_attention_cute import flash_attention_forward
    from flash_attention_cute.ops.attention import flash_attention_varlen
    from flash_attention_cute.ops.paged_attention import (
        gather_pages,
        paged_attention_decode,
        paged_attention_extend,
    )
    from flash_attention_cute.ops.quantized import quantize_kv
    from flash_attention_cute.ops.quantized_matmul import (
        dequantize_weight,
        dequantize_weight4,
        quantize_weight,
        quantize_weight_int4,
        quantized_matmul,
    )
    from flash_attention_cute.ops.reference import attention_reference

    rep = Report()
    keys = iter(jax.random.split(jax.random.key(seed), 64))
    rng = np.random.default_rng(seed)

    def normal(shape, dtype=jnp.bfloat16):
        return jax.random.normal(next(keys), shape, jnp.float32).astype(dtype)

    print("phase 2: attention routes and quantized matmul at real widths")
    for label, (hq, hkv, d) in (("qwen2-7b", QWEN2), ("llama3-8b", LLAMA3)):
        # Dense prefill, causal and windowed: cuDNN fused attention.
        s = 4096
        q, k, v = normal((1, hq, s, d)), normal((1, hkv, s, d)), normal((1, hkv, s, d))
        for window in (None, 1024):
            f = lambda q, k, v, w=window: flash_attention_forward(
                q, k, v, causal=True, window=w)
            rep.check(
                f"{label} prefill S{s} window={window}", jax.jit(f)(q, k, v),
                attention_reference(q, k, v, causal=True, window=window),
                TOL_BF16, "cudnn" in _compiled(f, q, k, v), "cuDNN fmha",
            )

        # Paged decode, ragged lengths up to 16k with an empty row: Triton.
        b, ps, cap = 8, 64, 16384
        pps = cap // ps
        lens = rng.integers(1, cap + 1, b).astype(np.int32)
        lens[0], lens[1] = 0, cap
        lens = jnp.asarray(lens)
        pages = b * pps + 1
        table = jnp.asarray(
            rng.permutation(np.arange(1, pages))[: b * pps].reshape(b, pps),
            jnp.int32,
        )
        kp, vp = normal((hkv, pages, ps, d)), normal((hkv, pages, ps, d))
        qd = normal((b, hq, 1, d))
        kg, vg = gather_pages(kp, table, qd.dtype), gather_pages(vp, table, qd.dtype)
        f = lambda q, k, v, l, t: paged_attention_decode(q, k, v, l, t)
        text = _lowered(f, qd, kp, vp, lens, table)
        triton = TRITON_CALL in text and "stablehlo.while" not in text
        got = jax.jit(f)(qd, kp, vp, lens, table)
        rep.check(f"{label} paged decode B{b} <=16k ps{ps}", got,
                  attention_reference(qd, kg, vg, kv_length=lens),
                  TOL_BF16, triton, "Triton kernel, no interpreter loop")
        if float(jnp.max(jnp.abs(got[0]))) != 0.0:
            rep.failures.append(f"{label} paged decode empty row not zero")
        for qdt in (jnp.int8, jnp.float8_e4m3fn):
            kq, vq = quantize_kv(kp, qdt), quantize_kv(vp, qdt)
            rep.check(
                f"{label} paged decode {jnp.dtype(qdt).name} pages",
                jax.jit(f)(qd, kq, vq, lens, table),
                attention_reference(qd, gather_pages(kq, table, qd.dtype),
                                    gather_pages(vq, table, qd.dtype),
                                    kv_length=lens),
                TOL_BF16, TRITON_CALL in _lowered(f, qd, kq, vq, lens, table),
                "Triton kernel, scales folded",
            )
        del kp, vp, kg, vg

        # Paged extend: a 512-token chunk over a ~3k prefix.
        b, ps, pps, chunk = 2, 64, 64, 512
        pages = b * pps + 1
        table = jnp.arange(1, pages, dtype=jnp.int32).reshape(b, pps)
        kp, vp = normal((hkv, pages, ps, d)), normal((hkv, pages, ps, d))
        qe = normal((b, hq, chunk, d))
        q_off = jnp.array([3000, 2600], jnp.int32)
        fe = lambda q, k, v, o, t: paged_attention_extend(q, k, v, o, o + chunk, t)
        rep.check(
            f"{label} paged extend {chunk} over 3k", jax.jit(fe)(qe, kp, vp, q_off, table),
            attention_reference(qe, gather_pages(kp, table, qe.dtype),
                                gather_pages(vp, table, qe.dtype), causal=True,
                                kv_length=q_off + chunk, q_offset=q_off),
            TOL_BF16, "stablehlo.while" not in _lowered(fe, qe, kp, vp, q_off, table),
            "gather + XLA",
        )
        del kp, vp

        # Stacked-cache decode and chunked prefill over a contiguous cache.
        cap = 4096
        kc, vc = normal((8, hkv, cap, d)), normal((8, hkv, cap, d))
        qs = normal((8, hq, 1, d))
        klen = jnp.asarray(rng.integers(1, cap + 1, 8), jnp.int32)
        fs = lambda q, k, v, l: flash_attention_forward(q, k, v, kv_length=l)
        rep.check(f"{label} stacked-cache decode B8 <=4k", jax.jit(fs)(qs, kc, vc, klen),
                  attention_reference(qs, kc, vc, kv_length=klen), TOL_BF16,
                  "stablehlo.while" not in _lowered(fs, qs, kc, vc, klen), "XLA")
        qc = normal((2, hq, 512, d))
        off = jnp.array([1000, 3500], jnp.int32)
        fc = lambda q, k, v, o: flash_attention_forward(
            q, k[:2], v[:2], causal=True, q_offset=o, kv_length=o + 512)
        rep.check(f"{label} chunked prefill 512 @ offset", jax.jit(fc)(qc, kc, vc, off),
                  attention_reference(qc, kc[:2], vc[:2], causal=True,
                                      q_offset=off, kv_length=off + 512),
                  TOL_BF16, "stablehlo.while" not in _lowered(fc, qc, kc, vc, off), "XLA")
        del kc, vc

        # Varlen packed prefill.
        seqs = [1000, 300, 2048, 50]
        cu = jnp.asarray(np.concatenate([[0], np.cumsum(seqs)]), jnp.int32)
        t = sum(seqs)
        qv, kv_, vv = normal((t, hq, d)), normal((t, hkv, d)), normal((t, hkv, d))
        fv = lambda q, k, v: flash_attention_varlen(q, k, v, cu, causal=True)
        want = []
        for i in range(len(seqs)):
            a, z = int(cu[i]), int(cu[i + 1])
            tr = lambda x: jnp.swapaxes(x[a:z], 0, 1)[None]
            want.append(jnp.swapaxes(attention_reference(
                tr(qv), tr(kv_), tr(vv), causal=True)[0], 0, 1))
        rep.check(f"{label} varlen {len(seqs)} seqs", jax.jit(fv)(qv, kv_, vv),
                  jnp.concatenate(want), TOL_BF16,
                  "stablehlo.while" not in _lowered(fv, qv, kv_, vv), "XLA")

    # fp32 with precision pinned (no TF32): the dense and the paged route.
    hq, hkv, d = QWEN2
    q, k, v = (normal((1, n, 1024, d), jnp.float32) for n in (hq, hkv, hkv))
    rep.check("fp32 prefill S1024 (HIGHEST)",
              jax.jit(lambda q, k, v: flash_attention_forward(q, k, v, causal=True))(q, k, v),
              attention_reference(q, k, v, causal=True), TOL_F32, True, "XLA")
    b, ps, pps = 4, 64, 32
    pages = b * pps + 1
    table = jnp.arange(1, pages, dtype=jnp.int32).reshape(b, pps)
    kp, vp = normal((hkv, pages, ps, d), jnp.float32), normal((hkv, pages, ps, d), jnp.float32)
    qd = normal((b, hq, 1, d), jnp.float32)
    lens = jnp.array([2048, 1, 700, 1500], jnp.int32)
    f = lambda q, k, v, l, t: paged_attention_decode(q, k, v, l, t)
    rep.check("fp32 paged decode (HIGHEST)", jax.jit(f)(qd, kp, vp, lens, table),
              attention_reference(qd, gather_pages(kp, table, qd.dtype),
                                  gather_pages(vp, table, qd.dtype), kv_length=lens),
              TOL_F32, TRITON_CALL in _lowered(f, qd, kp, vp, lens, table), "Triton kernel")

    # Weight-only quantized matmul at Qwen2-7B's MLP width.
    x = normal((8, 3584))
    w = normal((3584, 18944), jnp.float32) * 3584 ** -0.5
    hi = jax.lax.Precision.HIGHEST
    for label, qfn, dq in (("int8", quantize_weight, dequantize_weight),
                           ("int4", quantize_weight_int4, dequantize_weight4)):
        qw = jax.jit(qfn)(w)
        ref = jnp.dot(x.astype(jnp.float32),
                      dq(qw, jnp.bfloat16).astype(jnp.float32), precision=hi)
        f = lambda x, qw: quantized_matmul(x, qw)
        rep.check(f"{label} weight matmul 8x3584x18944", jax.jit(f)(x, qw), ref,
                  TOL_BF16, "stablehlo.while" not in _lowered(f, x, qw),
                  "XLA dequant-dot")
    return rep.failures


def run_gpu_tests() -> list[str]:
    """The card-only tests (`gpu` marker), in this process: a second JAX
    process could not get the card's memory."""
    import pathlib

    import pytest

    root = pathlib.Path(__file__).resolve().parent
    print("phase 2: card-only tests (pytest -m gpu)", flush=True)
    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
        "-W", "ignore::pytest.PytestAssertRewriteWarning",
        str(root / "tests"),
    ])
    return [] if rc == 0 else [f"pytest -m gpu exited {rc}"]


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------


class CompileCounter:
    """Counts new jit specializations (traces) while `counting` is set."""

    def __init__(self):
        import jax

        self.counting = False
        self.traces = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kw):
        if self.counting and event == "/jax/core/compile/jaxpr_trace_duration":
            self.traces += 1


class GreedyVerifier:
    """Recomputes logits for prompt + output with one dense prefill
    forward (the cuDNN route) on the params' device, padded to one
    length so that a single program serves every request."""

    def __init__(self, params, cfg, length: int):
        import jax
        import jax.numpy as jnp

        from flash_attention_cute.models import forward

        self.params = params
        self.length = length
        lm_head = params.get("lm_head")
        self.lm_head = params["embed"].T if lm_head is None else lm_head

        def logits_at(params, lm_head, ids, pos):
            h, _ = forward(params, cfg, ids, mode="prefill", return_hidden=True)
            return jnp.dot(h[0, pos], lm_head.astype(h.dtype),
                           preferred_element_type=jnp.float32)

        self.fn = jax.jit(logits_at)

    def max_gap(self, prompt, out) -> float:
        import jax.numpy as jnp
        import numpy as np

        seq = list(prompt) + list(out)
        assert len(seq) <= self.length, (len(seq), self.length)
        ids = np.zeros((1, self.length), np.int32)
        ids[0, : len(seq)] = seq
        pos = np.arange(len(prompt) - 1, len(seq) - 1, dtype=np.int32)
        logits = self.fn(self.params, self.lm_head, jnp.asarray(ids),
                         jnp.asarray(pos))
        chosen = jnp.take_along_axis(
            logits, jnp.asarray(out, jnp.int32)[:, None], axis=1)[:, 0]
        return float(jnp.max(jnp.max(logits, axis=1) - chosen))


def serve(engine, prompts, max_new, counter, waves, label):
    """Serve `prompts` `waves` times; the last wave is counted. Returns
    {rid: tokens} of the counted wave."""
    results = {}
    t0 = time.perf_counter()
    for wave in range(waves):
        counted = wave == waves - 1
        if counted and waves > 1:
            print(f"  {label}: warm-up waves {time.perf_counter() - t0:.1f} s "
                  "(compilation included)", flush=True)
            counter.counting, counter.traces = True, 0
        base = wave * 1_000_000
        for rid, p in prompts.items():
            engine.submit(base + rid, p, max_new)
        t1 = time.perf_counter()
        done = engine.run()
        wall = time.perf_counter() - t1
        counter.counting = False
        results = {rid - base: toks for rid, toks in done.items()
                   if base <= rid < base + 1_000_000}
    if engine.failed or len(results) != len(prompts):
        fail(f"{label}: served {len(results)}/{len(prompts)}, "
             f"failed {engine.failed}")
    new = sum(len(t) for t in results.values())
    if waves == 1:
        print(f"  {label}: one wave {wall:.2f} s (compilation included), "
              f"{new} new tokens", flush=True)
        return results, 0
    print(f"  {label}: counted wave {wall:.2f} s, {new} new tokens, "
          f"{new / wall:.1f} tokens/s (information only), "
          f"new traces {counter.traces}", flush=True)
    return results, counter.traces


def greedy_check(verifier, prompts, results, label) -> list[str]:
    gaps = {rid: verifier.max_gap(prompts[rid], toks)
            for rid, toks in results.items()}
    worst = max(gaps.values())
    ok = worst <= GREEDY_EPS
    print(f"  {label}: greedy consistency, worst logit gap {worst:.4f} "
          f"<= {GREEDY_EPS} over {len(gaps)} requests: "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return [] if ok else [f"{label} greedy gap {worst:.4f}"]


def engine_prompts(vocab: int, seed: int, lengths, prefix=()):
    import numpy as np

    rng = np.random.default_rng(seed)
    return {i: list(prefix) + rng.integers(0, vocab, n).tolist()
            for i, n in enumerate(lengths)}


PROMPT_LENS = (128, 2048, 300, 700, 1000, 1500, 1800, 200)
# Four cards: two prefill buckets (512, 2048) instead of five, since every
# replica of the data-parallel engine compiles its own programs.
FOUR_CARD_PROMPT_LENS = (300, 500, 400, 450, 1100, 2000, 1500, 1800)
MAX_NEW = 32
PAGE_SIZE = 64


def model_checks(cfg, params, seed: int, counter) -> list[str]:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flash_attention_cute.runtime.engine import ServingEngine
    from flash_attention_cute.runtime.generate import greedy_generate

    failures = []
    verifier = GreedyVerifier(params, cfg, 2560)
    print("phase 3: Qwen2-7B, full widths and depth, random bf16 weights",
          flush=True)

    # greedy_generate on 2 prompts.
    ids = jnp.asarray(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 128)), jnp.int32)
    t0 = time.perf_counter()
    out = np.asarray(greedy_generate(params, cfg, ids, 16))
    print(f"  greedy_generate: {time.perf_counter() - t0:.1f} s "
          "(compilation included)", flush=True)
    gen = {i: out[i].tolist() for i in range(2)}
    failures += greedy_check(
        verifier, {i: np.asarray(ids[i]).tolist() for i in range(2)}, gen,
        "greedy_generate")

    pps = -(-(max(PROMPT_LENS) + MAX_NEW) // PAGE_SIZE)
    pool = dict(slots=4, num_pages=4 * pps + 1, page_size=PAGE_SIZE,
                pages_per_seq=pps)

    prompts = engine_prompts(cfg.vocab_size, seed + 1, PROMPT_LENS)
    eng = ServingEngine(params, cfg, **pool)
    results, traces = serve(eng, prompts, MAX_NEW, counter, 2, "engine")
    if traces:
        failures.append(f"engine traced {traces} programs after warm-up")
    failures += greedy_check(verifier, prompts, results, "engine")
    print(f"  engine stats: {eng.stats}", flush=True)
    del eng

    system = np.random.default_rng(seed + 2).integers(
        0, cfg.vocab_size, 512).tolist()
    suffix = np.random.default_rng(seed + 3).integers(64, 400, 8)
    prompts = engine_prompts(cfg.vocab_size, seed + 4, suffix, system)
    eng = ServingEngine(params, cfg, enable_prefix_cache=True, **pool)
    # Wave 1 fills the prefix cache, which changes the buckets later waves
    # admit with; wave 2 compiles those, wave 3 is counted.
    results, traces = serve(eng, prompts, MAX_NEW, counter, 3,
                            "prefix-cached engine")
    if traces:
        failures.append(f"prefix engine traced {traces} programs after warm-up")
    if eng.stats["prefix_hit_tokens"] <= 0:
        failures.append("prefix engine served no prefix hits")
    failures += greedy_check(verifier, prompts, results, "prefix-cached engine")
    print(f"  prefix engine stats: {eng.stats}", flush=True)

    dev = jax.devices()[0]
    print(f"  peak bytes in use: {(dev.memory_stats() or {}).get('peak_bytes_in_use')}",
          flush=True)
    return failures


def decode_step_memory(cfg, params) -> None:
    """`memory_analysis()` of the engine's compiled decode step."""
    import jax.numpy as jnp

    from flash_attention_cute.runtime.paged_cache import create_paged_state
    from flash_attention_cute.runtime.paged_forward import forward_paged

    pps = -(-(max(PROMPT_LENS) + MAX_NEW) // PAGE_SIZE)
    state = create_paged_state(cfg, 4 * pps + 1, PAGE_SIZE, 4, pps)
    compiled = forward_paged.lower(
        params, cfg, jnp.zeros((4, 1), jnp.int32), state, mode="decode"
    ).compile()
    print(f"  decode step memory_analysis: {compiled.memory_analysis()}",
          flush=True)


def four_card_checks(cfg, params, seed: int, counter) -> list[str]:
    from flash_attention_cute.parallel.mesh import make_mesh
    from flash_attention_cute.runtime.dp_engine import (
        DataParallelServingEngine,
    )
    from flash_attention_cute.runtime.engine import ServingEngine

    failures = []
    verifier = GreedyVerifier(params, cfg, 2560)
    pps = -(-(max(FOUR_CARD_PROMPT_LENS) + MAX_NEW) // PAGE_SIZE)
    prompts = engine_prompts(cfg.vocab_size, seed + 1, FOUR_CARD_PROMPT_LENS)
    print("four cards: Qwen2-7B serving, checked against the one-card "
          "dense forward", flush=True)

    tp = ServingEngine(params, cfg, mesh=make_mesh(model=4), slots=4,
                       num_pages=4 * pps + 1, page_size=PAGE_SIZE,
                       pages_per_seq=pps)
    results, _ = serve(tp, prompts, MAX_NEW, counter, 1,
                       "tensor-parallel engine (model=4)")
    failures += greedy_check(verifier, prompts, results, "tensor-parallel")
    del tp

    dp = DataParallelServingEngine(
        params, cfg, mesh=make_mesh(data=4, model=1), slots=2,
        num_pages=2 * pps + 1, page_size=PAGE_SIZE, pages_per_seq=pps,
    )
    results, _ = serve(dp, prompts, MAX_NEW, counter, 1,
                       "data-parallel engine (data=4)")
    failures += greedy_check(verifier, prompts, results, "data-parallel")
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card serving paths")
    args = ap.parse_args(argv)

    # The package sets the XLA flags it needs; import it before JAX starts
    # its backend (device_check is the first device use).
    import flash_attention_cute  # noqa: F401

    devices = device_check(4 if args.four_cards else 1)

    import jax

    from flash_attention_cute.models import init_params
    from flash_attention_cute.models.qwen2 import qwen2_7b_config
    from flash_attention_cute.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    counter = CompileCounter()
    failures = []
    if not args.four_cards:
        failures += kernel_checks(args.seed)
        failures += run_gpu_tests()

    cfg = qwen2_7b_config()
    t0 = time.perf_counter()
    params = jax.block_until_ready(init_params(cfg, jax.random.key(args.seed)))
    print(f"Qwen2-7B params: {sum(x.size for x in jax.tree.leaves(params))} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.four_cards:
        failures += four_card_checks(cfg, params, args.seed, counter)
    else:
        failures += model_checks(cfg, params, args.seed, counter)
        decode_step_memory(cfg, params)

    if failures:
        fail("; ".join(failures))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main()
