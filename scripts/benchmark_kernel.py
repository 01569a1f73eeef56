"""Kernel correctness + throughput benchmark CLI.

JAX analog of the reference's kernel benchmark
(reference: scripts/benchmark_kernel.py:62-194): random QKV in [B, H, S, D],
the dispatched attention route (cuDNN on the GPU) timed against the plain
XLA route, accuracy reported as MSE + allclose. Timing needs a GPU.

Oracle mapping (reference -> here):
  * official flash-attn  -> grouped XLA attention in the compute dtype
    (same-precision performance baseline)
  * fp32 eager attention -> fp32 XLA reference with explicit bottom-right
    causal bias and GQA head repetition (numerics oracle,
    reference: scripts/benchmark_kernel.py:15-44)

Usage (reference config matrix, scripts/benchmark_kernel.py:174-194):
  # Llama-2-7B-like GQA prefill
  python scripts/benchmark_kernel.py --b 16 --nh 64 --nh-k 8 \
      --q-seq-len 1024 --k-seq-len 1024 --head-dim 128 --dtype bf16 --causal
  # decode
  python scripts/benchmark_kernel.py --b 16 --nh 64 --nh-k 8 \
      --q-seq-len 1 --k-seq-len 1024 --head-dim 128 --dtype bf16
  # MHA, head_dim 64, fp16
  python scripts/benchmark_kernel.py --b 8 --nh 32 --nh-k 32 \
      --q-seq-len 2048 --k-seq-len 2048 --head-dim 64 --dtype fp16 --causal
"""

from __future__ import annotations

import pathlib
import sys

# Runnable as `python scripts/<name>.py` from anywhere, without installing.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import argparse
import functools

import jax
import jax.numpy as jnp

from flash_attention_cute.api import flash_attention_forward
from flash_attention_cute.ops.attention import xla_attention
from flash_attention_cute.ops.reference import attention_reference
from flash_attention_cute.utils.compile_cache import enable_compile_cache
from flash_attention_cute.utils.profiling import (
    card_name_and_power_limit,
    require_gpu,
)
from flash_attention_cute.utils.timing import time_fn

DTYPES = {"bf16": jnp.bfloat16, "fp16": jnp.float16, "fp32": jnp.float32}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--b", type=int, default=16, help="batch size")
    p.add_argument("--nh", type=int, default=64, help="num q heads")
    p.add_argument("--nh-k", type=int, default=8, help="num kv heads")
    p.add_argument("--q-seq-len", type=int, default=1024)
    p.add_argument("--k-seq-len", type=int, default=1024)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--causal", action="store_true")
    p.add_argument("--window", type=int, default=0,
                   help="sliding-window size (0 = disabled)")
    p.add_argument("--iter", type=int, default=20,
                   help="timed calls per repeat")
    p.add_argument("--no-perf", action="store_true",
                   help="accuracy check only (runs without a GPU)")
    p.add_argument("--atol", type=float, default=None,
                   help="allclose tolerance vs fp32 oracle "
                        "(default: 2e-2 bf16, 1e-3 otherwise — the "
                        "reference uses 1e-3 for fp16)")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    enable_compile_cache()
    dtype = DTYPES[a.dtype]
    window = a.window if a.window > 0 else None

    ks = jax.random.split(jax.random.key(0), 3)
    q = jax.random.normal(
        ks[0], (a.b, a.nh, a.q_seq_len, a.head_dim), jnp.float32
    ).astype(dtype)
    k = jax.random.normal(
        ks[1], (a.b, a.nh_k, a.k_seq_len, a.head_dim), jnp.float32
    ).astype(dtype)
    v = jax.random.normal(
        ks[2], (a.b, a.nh_k, a.k_seq_len, a.head_dim), jnp.float32
    ).astype(dtype)

    custom = jax.jit(functools.partial(
        flash_attention_forward, causal=a.causal, window=window,
    ))
    plain = jax.jit(functools.partial(
        xla_attention, sm_scale=a.head_dim ** -0.5, causal=a.causal,
        window=window,
    ))

    # ---- accuracy (reference: scripts/benchmark_kernel.py:114-123) ----
    out = custom(q, k, v)
    ref32 = attention_reference(
        q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32),
        causal=a.causal, window=window,
    )
    out32 = out.astype(jnp.float32)
    mse = float(jnp.mean((out32 - ref32) ** 2))
    maxerr = float(jnp.max(jnp.abs(out32 - ref32)))
    atol = a.atol if a.atol is not None else (
        2e-2 if dtype == jnp.bfloat16 else 1e-3
    )
    ok = bool(jnp.allclose(out32, ref32, atol=atol))
    print(f"accuracy vs fp32 oracle: MSE={mse:.3e} max|err|={maxerr:.3e} "
          f"allclose(atol={atol:g})={'PASS' if ok else 'FAIL'}")

    if a.no_perf:
        sys.exit(0 if ok else 1)
    dev = require_gpu()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    print(f"card: {card_name_and_power_limit()}")

    # ---- perf ----
    # Exact useful-work FLOPs: 4*D per allowed (q, k) coordinate pair
    # (QK^T + PV, 2 flops each), honoring causal and window masks.
    sq, skv = a.q_seq_len, a.k_seq_len
    pairs = 0
    for m in range(sq):
        pos = m + (skv - sq)
        hi = min(pos, skv - 1) if a.causal else skv - 1
        lo = max(pos - window + 1, 0) if window else 0
        pairs += max(0, hi - lo + 1)
    flops = 4 * a.b * a.nh * a.head_dim * pairs

    def report(name, fn):
        t = time_fn(fn, (q, k, v), iters=a.iter)
        print(f"{name:>16}: {t * 1e3:8.3f} ms/iter   "
              f"{flops / t / 1e12:7.2f} TFLOP/s")
        return t

    t_custom = report("dispatched", custom)
    t_xla = report("xla", plain)
    print(f"speedup vs XLA route: {t_xla / t_custom:.2f}x")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
