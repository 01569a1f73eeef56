"""The shared transformer core (Llama / Qwen2 architecture family).

One functional forward replaces both vendored stacks
(reference: models/modeling_llama.py:598-746 `LlamaModel.forward` and
models/modeling_qwen2.py equivalents). Design choices:

  * Layers run under `lax.scan` over stacked parameters: one layer is traced
    once regardless of depth, and per-layer KV cache slices stream through
    scan xs/ys instead of indexed updates on the stacked cache.
  * The KV cache is fixed-capacity with explicit length scalars (see
    cache.py) so prefill and every decode step are exactly two compiled
    programs.
  * Attention modes are static:
      - mode="prefill": causal flash attention over the fresh K/V, then the
        cache is written (cheapest: no wasted compute on empty cache tail).
      - mode="decode":  seqlen 1; cache updated first, then attention over
        the layer's cache masked by lengths.
      - mode="extend":  chunked prefill into a partially filled cache.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp

from flash_attention_cute.api import flash_attention_forward
from flash_attention_cute.models.cache import KVCache, QuantizedKVCache
from flash_attention_cute.models.config import ModelConfig
from flash_attention_cute.models import layers as L


def _layer_forward(
    x: jax.Array,
    lp: dict,
    cfg: ModelConfig,
    cos: jax.Array,
    sin: jax.Array,
    k_cache_l,  # array | (values, scales) tuple (quantized) | None
    v_cache_l,
    interpret: bool | None,
    mesh=None,
    window: int | None = None,
    lora_l=None,  # layer slice of stacked multi-LoRA adapters
    lora_ids=None,  # [B] int32 adapter per row
    lora_scaling=None,
):
    """One PREFILL decoder layer (reference: modeling_llama.py:385-449).

    Attention runs over the fresh K/V; the (possibly quantized) cache slab
    is then overwritten from position 0. Decode/extend layers live in
    `_layer_forward_carry`. Returns (x_out, new_k_cache_l, new_v_cache_l).
    """
    if mesh is not None:
        from flash_attention_cute.parallel.sharding import sharded_attention
        attn_fn = functools.partial(sharded_attention, mesh)
    else:
        attn_fn = flash_attention_forward
    h = L.rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
    q, k, v = L.qkv_project(h, lp, cfg, lora_l, lora_ids, lora_scaling)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)

    attn = attn_fn(q, k, v, softmax_scale=cfg.attention_scale,
                   causal=True, window=window,
                   logit_softcap=cfg.logit_softcap, interpret=interpret)
    if k_cache_l is not None:
        if isinstance(k_cache_l, tuple):  # quantized (values, scales)
            from flash_attention_cute.ops.quantized import quantize_kv

            def write_q(slab, new):
                vals, scl = slab
                nq = quantize_kv(new, dtype=vals.dtype)
                vals = jax.lax.dynamic_update_slice(
                    vals, nq.values, (0, 0, 0, 0)
                )
                scl = jax.lax.dynamic_update_slice(scl, nq.scales, (0, 0, 0))
                return (vals, scl)

            k_cache_l = write_q(k_cache_l, k)
            v_cache_l = write_q(v_cache_l, v)
        else:
            k_cache_l = jax.lax.dynamic_update_slice(
                k_cache_l, k.astype(k_cache_l.dtype), (0, 0, 0, 0)
            )
            v_cache_l = jax.lax.dynamic_update_slice(
                v_cache_l, v.astype(v_cache_l.dtype), (0, 0, 0, 0)
            )

    x = L.layer_tail(x, attn, lp, cfg, lora_l, lora_ids, lora_scaling)
    return x, k_cache_l, v_cache_l


def _kv_write(buf, new, layer_idx, lengths):
    """Append new tokens into a stacked cache buffer at per-row offsets.

    buf:  [L, B, Hkv, C, D] values (or [L, B, Hkv, C] scales)
    new:  [B, Hkv, S, D]    (or [B, Hkv, S])

    Small batches unroll into per-row `dynamic_update_slice` windowed
    stores instead of one advanced-index scatter
    (`buf.at[l, bidx, hidx, pos].set`).
    Caller contract (unchanged): lengths + S <= capacity — a dus CLAMPS
    an out-of-range start where scatter would drop the rows, so overflow
    writes must never be issued at all.
    """
    b = new.shape[0]
    if b > 32:  # bound the unrolled-graph size; scatter amortizes there
        bidx = jnp.arange(b)[:, None, None]
        hidx = jnp.arange(new.shape[1])[None, :, None]
        pos = lengths[:, None, None] + jnp.arange(new.shape[2])[None, None, :]
        return buf.at[(layer_idx, bidx, hidx, pos)].set(new.astype(buf.dtype))
    for bi in range(b):
        idx = (layer_idx, bi, 0, lengths[bi]) + (0,) * (new.ndim - 3)
        buf = jax.lax.dynamic_update_slice(
            buf, new[bi][None, None].astype(buf.dtype), idx
        )
    return buf


def _layer_forward_carry(
    x: jax.Array,
    lp: dict,
    layer_idx: jax.Array,  # scalar int32 (traced)
    cfg: ModelConfig,
    cos: jax.Array,
    sin: jax.Array,
    ck: jax.Array,  # [L, B, Hkv, C, D] stacked cache (scan carry)
    cv: jax.Array,
    lengths: jax.Array,  # [B]
    mode: str,
    interpret: bool | None,
    mesh,
    window: int | None,
):
    """Decode/extend layer with the FULL stacked cache in the scan carry.

    The new tokens are written with a token-granular scatter (no layer
    slab re-materialized through scan ys), then the layer's cache slab
    is sliced (and dequantized, for a quantized cache) for the dense
    attention route.
    """
    if mesh is not None:
        from flash_attention_cute.parallel.sharding import sharded_attention
        attn_fn = functools.partial(sharded_attention, mesh)
    else:
        attn_fn = flash_attention_forward
    h = L.rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
    q, k, v = L.qkv_project(h, lp, cfg)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)

    b, hkv, s, _ = k.shape
    new_len = lengths + s
    quantized = isinstance(ck, tuple)

    if quantized:
        from flash_attention_cute.ops.quantized import (
            QuantizedKV,
            dequantize_kv,
            quantize_kv,
        )

        def scatter_q(c, new):
            vals, scl = c
            nq = quantize_kv(new, dtype=vals.dtype)
            vals = _kv_write(vals, nq.values, layer_idx, lengths)
            scl = _kv_write(scl, nq.scales, layer_idx, lengths)
            return (vals, scl)

        ck = scatter_q(ck, k)
        cv = scatter_q(cv, v)

        def slab(c):
            vals, scl = c
            return dequantize_kv(QuantizedKV(
                values=jax.lax.dynamic_index_in_dim(vals, layer_idx, 0, keepdims=False),
                scales=jax.lax.dynamic_index_in_dim(scl, layer_idx, 0, keepdims=False),
            ), q.dtype)
    else:
        ck = _kv_write(ck, k, layer_idx, lengths)
        cv = _kv_write(cv, v, layer_idx, lengths)

        def slab(c):
            return jax.lax.dynamic_index_in_dim(
                c, layer_idx, 0, keepdims=False
            ).astype(q.dtype)

    attn = attn_fn(
        q,
        slab(ck),
        slab(cv),
        softmax_scale=cfg.attention_scale,
        causal=(mode == "extend"),
        kv_length=new_len,
        q_offset=lengths if mode == "extend" else None,
        window=window,
        logit_softcap=cfg.logit_softcap,
        interpret=interpret,
    )

    x = L.layer_tail(x, attn, lp, cfg)
    return x, ck, cv


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "mode", "interpret", "return_hidden", "mesh"),
)
def forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: jax.Array,
    cache: KVCache | None = None,
    mode: str = "prefill",
    interpret: bool | None = None,
    return_hidden: bool = False,
    mesh=None,
    lora: dict | None = None,  # stacked multi-LoRA adapters
    # (models/lora.py) — PREFILL mode only on this dense path (training /
    # evaluation with per-row adapters; serving adapters live in the
    # paged engine)
    adapter_ids: jax.Array | None = None,  # [B] int32 adapter per row
) -> tuple[jax.Array, KVCache | None]:
    """Full causal-LM forward.

    Args:
      params: parameter pytree from init_params / convert.load_hf_params.
      input_ids: [B, S] int32.
      cache: optional KVCache; required for mode "decode"/"extend".
      mode: "prefill" | "decode" | "extend" (static).

    Returns (logits [B, S, vocab] fp32, updated cache or None).
    (reference: modeling_llama.py:781-872 LlamaForCausalLM.forward,
    logits upcast at :846-847.)
    """
    assert mode in ("prefill", "decode", "extend"), mode
    if mode != "prefill":
        assert cache is not None, f"mode={mode} requires a cache"
    if lora is not None:
        assert mode == "prefill", (
            "dense-path LoRA supports prefill only (fine-tuning/eval); "
            "serve adapters through the paged engine"
        )

    b, s = input_ids.shape
    if mode == "decode":
        assert s == 1, f"decode mode requires seqlen 1, got {s}"
    x = params["embed"][input_ids].astype(cfg.dtype)
    if cfg.scale_embeddings:  # Gemma: embeddings * sqrt(hidden), in-dtype
        x = x * jnp.asarray(cfg.hidden_size ** 0.5, cfg.dtype)

    if cache is None or mode == "prefill":
        positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
        lengths = None if cache is None else cache.lengths
    else:
        positions = cache.lengths[:, None] + jnp.arange(s, dtype=jnp.int32)
        lengths = cache.lengths

    inv_freq = L.rope_inv_freq(cfg)
    cos, sin = L.rope_cos_sin(positions, inv_freq, cfg.dtype)

    lp_stacked = params["layers"]

    lora_scaling = None if lora is None else lora["scaling"]

    def make_scan_body(window):
        def scan_body(x, xs_l):
            if lora is None:
                lp, k_l, v_l = xs_l
                lora_l = None
            else:
                lp, lora_l, k_l, v_l = xs_l
            x, new_k, new_v = _layer_forward(
                x, lp, cfg, cos, sin, k_l, v_l, interpret, mesh, window,
                lora_l, adapter_ids, lora_scaling,
            )
            if new_k is None:
                return x, None
            return x, (new_k, new_v)
        return scan_body

    # Per-layer window plan. Periodic patterns (Gemma2: alternating
    # sliding/full layers) scan over len(pattern)-layer bodies with static
    # windows; suffix semantics (Qwen2: layers >= max_window_layers are
    # windowed) stay (at most) two contiguous scan segments
    # (reference rejects sliding windows, models/modeling_qwen2.py:261-269).
    pattern = cfg.layer_window_pattern
    pn = len(pattern) if pattern is not None else 1

    def resh(tree):
        return jax.tree.map(
            lambda a: a.reshape(cfg.num_layers // pn, pn, *a.shape[1:]),
            tree,
        )

    def unresh(tree):
        return jax.tree.map(
            lambda a: a.reshape(cfg.num_layers, *a.shape[2:]), tree
        )

    if cfg.use_sliding_window and cfg.sliding_window:
        split = min(max(cfg.max_window_layers, 0), cfg.num_layers)
        segments = [(0, split, None), (split, cfg.num_layers, cfg.sliding_window)]
        segments = [(a, z, w) for (a, z, w) in segments if z > a]
    else:
        segments = [(0, cfg.num_layers, None)]

    def seg_slice(tree, a, z):
        return jax.tree.map(lambda arr: arr[a:z], tree)

    # Cache pytrees streamed through the scans: KVCache uses plain arrays,
    # QuantizedKVCache (values, scales) tuples — the layer code branches on
    # the tuple-ness.
    quant = isinstance(cache, QuantizedKVCache)
    if cache is not None:
        if quant:
            cache_k = (cache.k_values, cache.k_scales)
            cache_v = (cache.v_values, cache.v_scales)
        else:
            cache_k, cache_v = cache.k, cache.v

    def rebuild_cache(ck, cv):
        if quant:
            return QuantizedKVCache(
                k_values=ck[0], k_scales=ck[1],
                v_values=cv[0], v_scales=cv[1],
                lengths=cache.lengths + s,
            )
        return KVCache(k=ck, v=cv, lengths=cache.lengths + s)

    if cache is not None and mode != "prefill":
        # Decode/extend: the stacked cache rides the scan CARRY and new
        # tokens land via token-granular scatters (see _layer_forward_carry).
        def make_carry_body(window):
            def body(carry, xs_l):
                x, ck, cv = carry
                lp, l = xs_l
                x, ck, cv = _layer_forward_carry(
                    x, lp, l, cfg, cos, sin, ck, cv, lengths, mode,
                    interpret, mesh, window,
                )
                return (x, ck, cv), None
            return body

        carry = (x, cache_k, cache_v)
        if pattern is not None:
            def pbody(carry, xs_l):
                x, ck, cv = carry
                lp_slab, idx_slab = xs_l
                for j in range(pn):
                    lp_j = jax.tree.map(lambda a: a[j], lp_slab)
                    x, ck, cv = _layer_forward_carry(
                        x, lp_j, idx_slab[j], cfg, cos, sin, ck, cv,
                        lengths, mode, interpret, mesh, pattern[j],
                    )
                return (x, ck, cv), None

            idxs = jnp.arange(cfg.num_layers, dtype=jnp.int32)
            carry, _ = jax.lax.scan(
                pbody, carry, (resh(lp_stacked), idxs.reshape(-1, pn))
            )
        else:
            for (a, z, window) in segments:
                lp_seg = seg_slice(lp_stacked, a, z)
                idxs = jnp.arange(a, z, dtype=jnp.int32)
                carry, _ = jax.lax.scan(
                    make_carry_body(window), carry, (lp_seg, idxs)
                )
        x, ck, cv = carry
        new_cache = rebuild_cache(ck, cv)
    elif pattern is not None:
        def pick(tree, j):
            return (
                None if tree is None
                else jax.tree.map(lambda a: a[j], tree)
            )

        def pbody(x, xs_l):
            if lora is None:
                lp_slab, k_slab, v_slab = xs_l
                lora_slab = None
            else:
                lp_slab, lora_slab, k_slab, v_slab = xs_l
            nks, nvs = [], []
            for j in range(pn):
                x, nk, nv = _layer_forward(
                    x, pick(lp_slab, j), cfg, cos, sin,
                    pick(k_slab, j), pick(v_slab, j),
                    interpret, mesh, pattern[j],
                    pick(lora_slab, j), adapter_ids, lora_scaling,
                )
                nks.append(nk)
                nvs.append(nv)
            if nks[0] is None:
                return x, None
            stack = lambda lst: jax.tree.map(lambda *a: jnp.stack(a), *lst)
            return x, (stack(nks), stack(nvs))

        lx = None if lora is None else resh(lora["layers"])
        if cache is not None:
            xs = (
                (resh(lp_stacked), resh(cache_k), resh(cache_v))
                if lora is None else
                (resh(lp_stacked), lx, resh(cache_k), resh(cache_v))
            )
            x, (nk, nv) = jax.lax.scan(pbody, x, xs)
            new_cache = rebuild_cache(unresh(nk), unresh(nv))
        else:
            xs = (
                (resh(lp_stacked), None, None) if lora is None
                else (resh(lp_stacked), lx, None, None)
            )
            x, _ = jax.lax.scan(pbody, x, xs)
            new_cache = None
    else:
        new_ks, new_vs = [], []
        for (a, z, window) in segments:
            lp_seg = seg_slice(lp_stacked, a, z)
            lora_seg = (
                None if lora is None
                else seg_slice(lora["layers"], a, z)
            )
            if cache is not None:
                xs = (
                    lp_seg,
                    seg_slice(cache_k, a, z),
                    seg_slice(cache_v, a, z),
                ) if lora is None else (
                    lp_seg,
                    lora_seg,
                    seg_slice(cache_k, a, z),
                    seg_slice(cache_v, a, z),
                )
                x, (nk, nv) = jax.lax.scan(make_scan_body(window), x, xs)
                new_ks.append(nk)
                new_vs.append(nv)
            else:
                xs = (
                    (lp_seg, None, None) if lora is None
                    else (lp_seg, lora_seg, None, None)
                )
                x, _ = jax.lax.scan(make_scan_body(window), x, xs)

        if cache is not None:
            cat = lambda trees: (
                trees[0] if len(trees) == 1
                else jax.tree.map(lambda *xs: jnp.concatenate(xs), *trees)
            )
            new_cache = rebuild_cache(cat(new_ks), cat(new_vs))
        else:
            new_cache = None

    x = L.rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
    if return_hidden:
        return x, new_cache
    lm_head = params.get("lm_head")
    if lm_head is None:  # tied embeddings (Qwen2 small models, Gemma)
        lm_head = params["embed"].T
    if hasattr(lm_head, "values"):  # int8 QuantizedWeight
        logits = L.dense(x, lm_head).astype(jnp.float32)
    else:
        logits = jnp.dot(x, lm_head.astype(x.dtype)).astype(jnp.float32)
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = jnp.tanh(logits / c) * c
    return logits, new_cache


def init_params_host(cfg: ModelConfig, seed: int = 0) -> dict:
    """Random parameter pytree built with numpy on the HOST — same
    structure and scales as init_params, ~50x faster than threefry on a
    CPU core. For benchmark-scale models whose bf16 image exceeds HBM
    (quantize on the host with models/quantize.quantize_params_on_host
    and ship only the int8 image): an 8B-param threefry init measured
    ~43 min on one core; numpy PCG64 does it in ~1 min. Not
    reproducible against init_params (different generator) — use
    init_params wherever both sides of a parity test must see identical
    weights."""
    import numpy as _np

    rng = _np.random.default_rng(seed)
    e = cfg.hidden_size
    f = cfg.intermediate_size
    hq = cfg.num_q_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    lcount = cfg.num_layers

    def norm(shape, scale=None):
        scale = scale or (shape[0] ** -0.5)
        a = rng.standard_normal(shape, dtype=_np.float32) * scale
        return jnp.asarray(a, cfg.dtype)

    ones = lambda shape: jnp.ones(shape, cfg.dtype)
    layers = {
        "input_ln": ones((lcount, e)),
        "post_ln": ones((lcount, e)),
        "q_proj": norm((lcount, e, hq)),
        "k_proj": norm((lcount, e, hkv)),
        "v_proj": norm((lcount, e, hkv)),
        "o_proj": norm((lcount, hq, e)),
        "gate_proj": norm((lcount, e, f)),
        "up_proj": norm((lcount, e, f)),
        "down_proj": norm((lcount, f, e)),
    }
    if cfg.attention_bias:
        layers["q_bias"] = jnp.zeros((lcount, hq), cfg.dtype)
        layers["k_bias"] = jnp.zeros((lcount, hkv), cfg.dtype)
        layers["v_bias"] = jnp.zeros((lcount, hkv), cfg.dtype)
    if cfg.sandwich_norms:
        layers["pre_ffw_ln"] = ones((lcount, e))
        layers["post_ffw_ln"] = ones((lcount, e))
    params = {
        "embed": norm((cfg.vocab_size, e), scale=0.02),
        "layers": layers,
        "final_ln": ones((e,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = norm((e, cfg.vocab_size))
    return params


def init_params(cfg: ModelConfig, key: jax.Array) -> dict:
    """Random parameter pytree (for tests/benchmarks; real weights come from
    models/convert.py)."""
    e = cfg.hidden_size
    f = cfg.intermediate_size
    hq = cfg.num_q_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    lcount = cfg.num_layers
    keys = iter(jax.random.split(key, 16))

    def norm(k, shape, scale=None):
        scale = scale or (shape[0] ** -0.5)
        return (jax.random.normal(k, shape, jnp.float32) * scale).astype(cfg.dtype)

    layers = {
        "input_ln": jnp.ones((lcount, e), cfg.dtype),
        "post_ln": jnp.ones((lcount, e), cfg.dtype),
        "q_proj": norm(next(keys), (lcount, e, hq)),
        "k_proj": norm(next(keys), (lcount, e, hkv)),
        "v_proj": norm(next(keys), (lcount, e, hkv)),
        "o_proj": norm(next(keys), (lcount, hq, e)),
        "gate_proj": norm(next(keys), (lcount, e, f)),
        "up_proj": norm(next(keys), (lcount, e, f)),
        "down_proj": norm(next(keys), (lcount, f, e)),
    }
    if cfg.attention_bias:
        layers["q_bias"] = jnp.zeros((lcount, hq), cfg.dtype)
        layers["k_bias"] = jnp.zeros((lcount, hkv), cfg.dtype)
        layers["v_bias"] = jnp.zeros((lcount, hkv), cfg.dtype)
    if cfg.sandwich_norms:
        layers["pre_ffw_ln"] = jnp.ones((lcount, e), cfg.dtype)
        layers["post_ffw_ln"] = jnp.ones((lcount, e), cfg.dtype)

    params = {
        "embed": norm(next(keys), (cfg.vocab_size, e), scale=0.02),
        "layers": layers,
        "final_ln": jnp.ones((e,), cfg.dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = norm(next(keys), (e, cfg.vocab_size))
    return params
