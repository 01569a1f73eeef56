"""Model forward over a PAGED KV cache (the serving-engine data path).

Counterpart to models/transformer.py (contiguous cache) for the paged
serving engine: per layer, fresh K/V are scattered into the page pool
through the page table, and decode attention runs over the pages in
place (ops/paged_attention.py).
Everything the reference leaves to HF's DynamicCache + dense kernel
(reference: models/rope_attn_fwd.py:90-93) becomes explicit, static-shape
device code here; paged attention itself is the reference's open roadmap
item (reference: README.md:21).

Modes:
  prefill — a fresh request (lengths BEFORE call must be 0): causal flash
            attention over the chunk's own K/V (no prior context), then
            page scatter. Prompts are padded to a static bucket; padding
            tokens scatter into the reserved null page 0.
  decode  — one token per sequence: scatter, then paged attention over
            the advanced lengths.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from flash_attention_cute.api import flash_attention_forward
from flash_attention_cute.models import layers as L
from flash_attention_cute.models.config import ModelConfig
from flash_attention_cute.ops.paged_attention import (
    paged_attention_decode,
    paged_attention_extend,
)
from flash_attention_cute.runtime.paged_cache import (
    PagedKVState,
    QuantizedPagedKVState,
    copy_pool_page_prefix_batch,
    paged_append_layer,
    paged_append_layer_quantized,
)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "mode", "interpret", "mesh"),
    donate_argnames=("state",),
)
def forward_paged(
    params: dict,
    cfg: ModelConfig,
    input_ids: jax.Array,  # [B, S]
    state: PagedKVState,
    mode: str = "decode",
    valid_len: jax.Array | None = None,  # [B] real (unpadded) prompt lengths
    interpret: bool | None = None,
    mesh=None,
    lora: dict | None = None,  # stacked multi-LoRA adapters (models/lora.py)
    adapter_ids: jax.Array | None = None,  # [B] int32 adapter per row
    partial_copy: tuple | None = None,  # (srcs, dsts, rows) int32 [G]:
    # partial-page prefix clones applied to the pool BEFORE the forward,
    # inside this same compiled program, so an admission wave is one
    # device call (engine._prefill_group)
) -> tuple[jax.Array, PagedKVState]:
    """Returns (logits [B, S, V] fp32, updated state).

    In prefill mode, `valid_len` gives each sequence's true prompt length
    (input_ids is padded to a bucket); lengths advance by valid_len and
    padding K/V land in the null page. In decode mode S must be 1 and
    lengths advance by 1 for every ACTIVE (length > 0 at entry... callers
    mask inactive slots by passing length 0 and ignoring their logits).
    """
    assert mode in ("prefill", "decode", "extend"), mode
    if partial_copy is not None:
        import dataclasses as _dc

        fields = tuple(
            f.name for f in _dc.fields(state)
            if f.name not in ("page_table", "lengths")
        )
        pools = copy_pool_page_prefix_batch(
            tuple(getattr(state, f) for f in fields), *partial_copy
        )
        state = _dc.replace(state, **dict(zip(fields, pools)))
    b, s = input_ids.shape
    if mode == "decode":
        assert s == 1, s
    x = params["embed"][input_ids].astype(cfg.dtype)
    if cfg.scale_embeddings:  # Gemma: embeddings * sqrt(hidden), in-dtype
        x = x * jnp.asarray(cfg.hidden_size ** 0.5, cfg.dtype)

    lengths = state.lengths
    if mode == "prefill":
        positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
        if valid_len is None:
            valid_len = jnp.full((b,), s, jnp.int32)
    elif mode == "extend":
        # Chunked admission: rows sit at global positions lengths..+s; the
        # chunk attends the paged prefix + itself with per-row causality
        # (ops/paged_attention.paged_attention_extend).
        positions = lengths[:, None] + jnp.arange(s, dtype=jnp.int32)
        if valid_len is None:
            valid_len = jnp.full((b,), s, jnp.int32)
    else:
        positions = lengths[:, None] + jnp.arange(s, dtype=jnp.int32)
        # Only ACTIVE slots (length > 0 after their prefill) advance; empty
        # batch slots stay at 0 and the kernel emits zeros for them.
        valid_len = (lengths > 0).astype(jnp.int32)

    inv_freq = L.rope_inv_freq(cfg)
    cos, sin = L.rope_cos_sin(positions, inv_freq, cfg.dtype)

    quant = isinstance(state, QuantizedPagedKVState)

    # Slots that are not advancing this call (valid_len == 0 — empty slots
    # AND slots mid chunked-admission, whose page tables already hold real
    # pages) must scatter NOTHING: their rows are routed out of range and
    # dropped (paged_cache._scatter_indices). Prompt-padding positions past
    # the page table are dropped the same way.
    active = valid_len > 0

    lora_scaling = None if lora is None else lora["scaling"]

    def make_layer(window):
      def layer(x, xs_l):
        if lora is None:
            lp, k_slab, v_slab = xs_l
            lora_l = None
        else:
            lp, lora_l, k_slab, v_slab = xs_l
        h = L.rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = L.qkv_project(
            h, lp, cfg, lora_l, adapter_ids, lora_scaling
        )
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)

        if quant:
            k_slab = paged_append_layer_quantized(
                k_slab, k, state.page_table, lengths, active
            )
            v_slab = paged_append_layer_quantized(
                v_slab, v, state.page_table, lengths, active
            )
        else:
            k_slab, v_slab = paged_append_layer(
                k_slab, v_slab, k, v, state.page_table, lengths, active
            )

        if mode == "prefill":
            # Fresh request: no prior context, attention over the chunk
            # only; padded tail rows produce garbage that is discarded.
            if mesh is not None:
                from flash_attention_cute.parallel.sharding import (
                    sharded_attention,
                )

                attn = sharded_attention(
                    mesh, q, k, v, causal=True, window=window,
                    logit_softcap=cfg.logit_softcap,
                    softmax_scale=cfg.attention_scale, interpret=interpret,
                )
            else:
                attn = flash_attention_forward(
                    q, k, v, softmax_scale=cfg.attention_scale,
                    causal=True, window=window,
                    logit_softcap=cfg.logit_softcap, interpret=interpret,
                )
        else:
            if quant:
                from flash_attention_cute.ops.quantized import QuantizedKV

                as_pages = lambda slab: QuantizedKV(*slab)
            else:
                as_pages = lambda slab: slab.astype(q.dtype)
            if mode == "extend":
                def attend(q_, k_slab_, v_slab_, lens_, tbl_):
                    # lens_ = lengths + s (valid_len == s in extend), so
                    # the chunk's global start is lens_ - s — no closure
                    # over `lengths` (shard_map bodies may not close over
                    # arrays).
                    return paged_attention_extend(
                        q_, as_pages(k_slab_), as_pages(v_slab_),
                        lens_ - q_.shape[2], lens_, tbl_,
                        sm_scale=cfg.attention_scale, window=window,
                        logit_softcap=cfg.logit_softcap,
                    )
            else:
                def attend(q_, k_slab_, v_slab_, lens_, tbl_):
                    return paged_attention_decode(
                        q_, as_pages(k_slab_), as_pages(v_slab_), lens_,
                        tbl_, sm_scale=cfg.attention_scale, window=window,
                        logit_softcap=cfg.logit_softcap,
                        interpret=bool(interpret),
                    )

            if mesh is not None:
                # The Pallas kernel has no SPMD partitioning rules: shard
                # the paged attention explicitly — q heads and the KV-head
                # axis of the page pool ride 'model'; lengths/table
                # replicate.
                from jax.sharding import PartitionSpec as P

                slab_spec = jax.tree.map(lambda _: P("model"), k_slab)
                attn = jax.shard_map(
                    attend,
                    mesh=mesh,
                    in_specs=(
                        P(None, "model", None, None),
                        slab_spec, slab_spec, P(), P(),
                    ),
                    out_specs=P(None, "model", None, None),
                    check_vma=False,
                )(q, k_slab, v_slab, lengths + valid_len, state.page_table)
            else:
                attn = attend(
                    q, k_slab, v_slab, lengths + valid_len, state.page_table
                )

        x = L.layer_tail(
            x, attn, lp, cfg, lora_l, adapter_ids, lora_scaling
        )
        return x, (k_slab, v_slab)

      return layer

    if quant:
        kx, vx = (
            (state.k_values, state.k_scales),
            (state.v_values, state.v_scales),
        )
    else:
        kx, vx = state.k_pages, state.v_pages
    if lora is None:
        xs = (params["layers"], kx, vx)
    else:
        xs = (params["layers"], lora["layers"], kx, vx)

    # Sliding-window models: Qwen2 suffix semantics become two scan
    # segments; Gemma2's PERIODIC pattern (alternating sliding/full)
    # scans over len(pattern)-layer bodies with static windows.
    pattern = cfg.layer_window_pattern
    if cfg.use_sliding_window and cfg.sliding_window:
        split = min(max(cfg.max_window_layers, 0), cfg.num_layers)
        segments = [(0, split, None), (split, cfg.num_layers, cfg.sliding_window)]
        segments = [(a, z, w) for (a, z, w) in segments if z > a]
    else:
        segments = [(0, cfg.num_layers, None)]

    carry0 = x
    if pattern is not None:
        pn = len(pattern)
        resh = lambda t: jax.tree.map(
            lambda a: a.reshape(cfg.num_layers // pn, pn, *a.shape[1:]), t
        )
        bodies = [make_layer(w) for w in pattern]

        def pbody(carry, xs_l):
            nks, nvs = [], []
            for j in range(pn):
                xs_j = jax.tree.map(lambda a: a[j], xs_l)
                carry, (nk, nv) = bodies[j](carry, xs_j)
                nks.append(nk)
                nvs.append(nv)
            stack = lambda lst: jax.tree.map(lambda *a: jnp.stack(a), *lst)
            return carry, (stack(nks), stack(nvs))

        x, (new_k, new_v) = jax.lax.scan(pbody, carry0, resh(xs))
        unresh = lambda t: jax.tree.map(
            lambda a: a.reshape(cfg.num_layers, *a.shape[2:]), t
        )
        new_k, new_v = unresh(new_k), unresh(new_v)
    elif len(segments) == 1:
        x, (new_k, new_v) = jax.lax.scan(
            make_layer(segments[0][2]), carry0, xs
        )
    else:
        new_ks, new_vs = [], []
        carry = carry0
        for (a, z, w) in segments:
            xs_seg = jax.tree.map(lambda arr: arr[a:z], xs)
            carry, (nk, nv) = jax.lax.scan(make_layer(w), carry, xs_seg)
            new_ks.append(nk)
            new_vs.append(nv)
        x = carry
        cat = lambda trees: jax.tree.map(
            lambda *xs_: jnp.concatenate(xs_), *trees
        )
        new_k, new_v = cat(new_ks), cat(new_vs)

    x = L.rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
    lm_head = params.get("lm_head")
    if lm_head is None:
        lm_head = params["embed"].T
    if hasattr(lm_head, "values"):  # int8 QuantizedWeight
        logits = L.dense(x, lm_head).astype(jnp.float32)
    else:
        logits = jnp.dot(x, lm_head.astype(x.dtype)).astype(jnp.float32)
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = jnp.tanh(logits / cap) * cap

    if quant:
        new_state = QuantizedPagedKVState(
            k_values=new_k[0], k_scales=new_k[1],
            v_values=new_v[0], v_scales=new_v[1],
            page_table=state.page_table,
            lengths=lengths + valid_len,
        )
    else:
        new_state = PagedKVState(
            k_pages=new_k,
            v_pages=new_v,
            page_table=state.page_table,
            lengths=lengths + valid_len,
        )
    return logits, new_state
