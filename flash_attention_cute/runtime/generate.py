"""Fully-jitted generation loops.

Replaces the reference's Python-side per-token loops
(reference: scripts/benchmark_llm.py:65-92 decode loop, :95-118 greedy
`generate`) with a single compiled prefill program + a `lax.scan` decode
program — no host round-trip per token, so decode is bound by the
device, not by dispatch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from flash_attention_cute.models.cache import KVCache, QuantizedKVCache
from flash_attention_cute.models.config import ModelConfig
from flash_attention_cute.models.transformer import forward
from flash_attention_cute.runtime.sampling import SamplingParams, sample_token


def prefill(
    params: dict,
    cfg: ModelConfig,
    input_ids: jax.Array,
    cache_capacity: int,
    cache_dtype=None,
    interpret: bool | None = None,
    mesh=None,
) -> tuple[jax.Array, KVCache]:
    """Run the prompt through the model, returning (last_logits [B,V], cache).

    `cache_dtype=jnp.int8` (or `jnp.float8_e4m3fn`) selects the quantized
    KV cache: K/V quantize per token at write time and attention
    dequantizes the layer's slab on read — half (vs bf16) the cache bytes
    (reference roadmap item, README.md:22). With `mesh`, the fresh dense
    cache is sharded (KV heads on the model axis, batch on data) before
    the forward (params should already be sharded via `shard_params`).
    """
    b, s = input_ids.shape
    assert cache_capacity >= s, (cache_capacity, s)
    if cache_dtype is not None and jnp.dtype(cache_dtype).itemsize == 1:
        cache = QuantizedKVCache.create(
            cfg, batch=b, capacity=cache_capacity, dtype=cache_dtype
        )
    else:
        cache = KVCache.create(
            cfg, batch=b, capacity=cache_capacity, dtype=cache_dtype
        )
    if mesh is not None and isinstance(cache, KVCache):
        from flash_attention_cute.parallel.sharding import shard_cache

        cache = shard_cache(cache, mesh)
    logits, cache = forward(
        params, cfg, input_ids, cache=cache, mode="prefill",
        interpret=interpret, mesh=mesh,
    )
    return logits[:, -1], cache


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "max_new_tokens", "sampling", "eos_token_id", "interpret",
        "mesh",
    ),
    donate_argnames=("cache",),
)
def decode_loop(
    params: dict,
    cfg: ModelConfig,
    first_token: jax.Array,  # [B] int32
    cache: KVCache,
    max_new_tokens: int,
    sampling: SamplingParams = SamplingParams(),
    eos_token_id: int | None = None,
    key: jax.Array | None = None,
    interpret: bool | None = None,
    mesh=None,
) -> jax.Array:
    """Autoregressive decode under lax.scan. Returns [B, max_new_tokens].

    Sequences that hit EOS keep emitting EOS (done-masking), matching the
    'stop at EOS' semantics of HF generate without dynamic shapes.
    """
    b = first_token.shape[0]
    if key is None:
        key = jax.random.key(0)

    def step(carry, _):
        cache, tok, done, key = carry
        logits, cache = forward(
            params, cfg, tok[:, None], cache=cache, mode="decode",
            interpret=interpret, mesh=mesh,
        )
        key, sub = jax.random.split(key)
        nxt = sample_token(logits[:, 0], sub, sampling)
        if eos_token_id is not None:
            nxt = jnp.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        return (cache, nxt, done, key), nxt

    if eos_token_id is not None:
        # The caller-sampled first token may already be EOS.
        done0 = first_token == eos_token_id
    else:
        done0 = jnp.zeros((b,), jnp.bool_)
    (_, _, _, _), tokens = jax.lax.scan(
        step, (cache, first_token, done0, key), None, length=max_new_tokens
    )
    return tokens.T  # [B, T]


def generate(
    params: dict,
    cfg: ModelConfig,
    input_ids: jax.Array,
    max_new_tokens: int,
    cache_capacity: int | None = None,
    cache_dtype=None,
    sampling: SamplingParams = SamplingParams(),
    eos_token_id: int | None = None,
    key: jax.Array | None = None,
    interpret: bool | None = None,
    mesh=None,
) -> jax.Array:
    """Prefill + decode. Returns the generated ids [B, max_new_tokens]."""
    b, s = input_ids.shape
    if cache_capacity is None:
        cache_capacity = s + max_new_tokens
    last_logits, cache = prefill(
        params, cfg, input_ids, cache_capacity, cache_dtype=cache_dtype,
        interpret=interpret, mesh=mesh,
    )
    if key is None:
        key = jax.random.key(0)
    key, sub = jax.random.split(key)
    first = sample_token(last_logits, sub, sampling)
    if max_new_tokens == 1:
        return first[:, None]
    rest = decode_loop(
        params, cfg, first, cache, max_new_tokens - 1,
        sampling=sampling, eos_token_id=eos_token_id, key=key,
        interpret=interpret, mesh=mesh,
    )
    return jnp.concatenate([first[:, None], rest], axis=1)


def greedy_generate(params, cfg, input_ids, max_new_tokens, **kw):
    """Greedy decoding (the reference's `generate`,
    scripts/benchmark_llm.py:95-118)."""
    return generate(
        params, cfg, input_ids, max_new_tokens,
        sampling=SamplingParams(temperature=0.0), **kw,
    )
