"""Parameter / activation / KV-cache shardings and shard_map'd attention.

Tensor-parallel layout (Megatron-style, expressed as GSPMD annotations —
XLA inserts the psum after o_proj and down_proj automatically):

  q/k/v_proj [L, E, H*D]   -> shard output dim on 'model' (head-parallel)
  o_proj     [L, H*D, E]   -> shard input  dim on 'model'
  gate/up    [L, E, F]     -> shard F on 'model'
  down       [L, F, E]     -> shard F on 'model'
  lm_head    [E, V]        -> shard V on 'model' (vocab-parallel logits)
  KV cache   [L, B, Hkv, C, D] -> batch on 'data', KV heads on 'model'

GQA co-location: Q heads land on the same chip as their KV head whenever
mesh_model divides num_kv_heads (guide §14; SNIPPETS.md §1-2 pattern).

Attention runs under `shard_map` with the specs below (cuDNN and Pallas
calls have no SPMD partitioning rules); inside the shard, each card sees
its local heads/batch and runs the same route as on one card (zero
communication during attention).
"""

from __future__ import annotations

import dataclasses

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flash_attention_cute.api import flash_attention_forward
from flash_attention_cute.models.cache import KVCache
from flash_attention_cute.models.config import ModelConfig


def param_pspecs(cfg: ModelConfig, params: dict | None = None) -> dict:
    """PartitionSpec pytree matching transformer.init_params.

    Pass the actual `params` when any projection is an int8
    QuantizedWeight (models/quantize.py): its `values` keep the dense
    weight's spec and its `scales` drop the contraction axis (so
    out-sharded projections shard their scales, in-sharded ones
    replicate them)."""
    layers = {
        "input_ln": P(),
        "post_ln": P(),
        "q_proj": P(None, None, "model"),
        "k_proj": P(None, None, "model"),
        "v_proj": P(None, None, "model"),
        "o_proj": P(None, "model", None),
        "gate_proj": P(None, None, "model"),
        "up_proj": P(None, None, "model"),
        "down_proj": P(None, "model", None),
    }
    if cfg.attention_bias:
        layers["q_bias"] = P(None, "model")
        layers["k_bias"] = P(None, "model")
        layers["v_bias"] = P(None, "model")
    specs = {
        "embed": P(),
        "layers": layers,
        "final_ln": P(),
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = P(None, "model")
    if params is not None:
        from flash_attention_cute.ops.quantized_matmul import (
            QuantizedWeight,
            QuantizedWeight4,
        )

        if "qkv_proj" in params["layers"]:
            raise NotImplementedError(
                "fused projections (models/fuse.py) are single-chip: the "
                "q/k/v split boundaries don't align with N-sharded fused "
                "matmul shards; keep TP meshes on the unfused layout"
            )

        def expand(spec, leaf):
            if isinstance(leaf, QuantizedWeight4):
                raise NotImplementedError(
                    "int4 weights are single-card: nibbles pack in "
                    "512-row blocks that a contraction-axis shard would "
                    "split; use bits=8 on multi-card meshes"
                )
            if isinstance(leaf, QuantizedWeight):
                return QuantizedWeight(
                    values=spec,
                    scales=P(*(spec[:-2] + spec[-1:])),
                    in_dim=leaf.in_dim, out=leaf.out,
                )
            return spec

        specs = jax.tree.map(
            expand, specs, params,
            is_leaf=lambda x: isinstance(x, P),
        )
    return specs


def cache_pspecs() -> KVCache:
    """Specs for KVCache: [L, B, Hkv, C, D]."""
    return KVCache(
        k=P(None, "data", "model", None, None),
        v=P(None, "data", "model", None, None),
        lengths=P("data"),
    )


def _device_put_tree(tree, specs, mesh: Mesh):
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
        is_leaf=lambda x: x is None,
    )


def shard_params(params: dict, cfg: ModelConfig, mesh: Mesh) -> dict:
    return _device_put_tree(params, param_pspecs(cfg, params), mesh)


def shard_cache(cache: KVCache, mesh: Mesh) -> KVCache:
    specs = cache_pspecs()
    return dataclasses.replace(
        cache,
        k=jax.device_put(cache.k, NamedSharding(mesh, specs.k)),
        v=jax.device_put(cache.v, NamedSharding(mesh, specs.v)),
        lengths=jax.device_put(cache.lengths, NamedSharding(mesh, specs.lengths)),
    )


def sharded_attention(
    mesh: Mesh,
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    causal: bool = False,
    kv_length: jax.Array | None = None,
    q_offset: jax.Array | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    softmax_scale: float | None = None,
    interpret: bool | None = None,
) -> jax.Array:
    """Run the dispatching attention op under shard_map.

    q [B, Hq, S, D] sharded (data, model, -, -); k/v likewise on KV heads.
    Requires num_kv_heads % mesh.shape['model'] == 0 (GQA co-location) and
    batch % mesh.shape['data'] == 0.
    """
    shape = dict(mesh.shape)
    tp = shape["model"]
    # TP-only meshes (e.g. a DP replica's ('model',) submesh) have no data
    # axis: batch replicates.
    data_axis = "data" if "data" in shape else None
    dp = shape.get("data", 1)
    assert k.shape[1] % tp == 0, (
        f"num_kv_heads {k.shape[1]} not divisible by model axis {tp}; "
        "replicate KV heads instead (guide §14)"
    )
    assert q.shape[0] % dp == 0, (q.shape, dp)

    qkv_spec = P(data_axis, "model", None, None)
    len_spec = P(data_axis)

    args = [q, k, v]
    in_specs = [qkv_spec, qkv_spec, qkv_spec]
    has_len = kv_length is not None
    has_off = q_offset is not None
    if has_len:
        args.append(kv_length)
        in_specs.append(len_spec)
    if has_off:
        args.append(q_offset)
        in_specs.append(len_spec)

    def inner(q, k, v, *rest):
        it = iter(rest)
        kvl = next(it) if has_len else None
        qoff = next(it) if has_off else None
        return flash_attention_forward(
            q, k, v, softmax_scale=softmax_scale, causal=causal,
            kv_length=kvl, q_offset=qoff,
            window=window, logit_softcap=logit_softcap,
            interpret=interpret,
        )

    fn = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=qkv_spec,
        check_vma=False,
    )
    return fn(*args)
