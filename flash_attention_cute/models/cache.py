"""Dense KV cache as an explicit pytree.

Replaces the reference's reliance on HF `DynamicCache` (reference:
models/rope_attn_fwd.py:90-93 `past_key_value.update`, modeling_llama.py:666-669)
with a static-shape design: fixed-capacity, statically shaped buffers plus
per-sequence length scalars, so every decode step reuses one compiled
program (no shape-driven recompiles — the "dynamic shapes under jit" hard
part from SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KVCache:
    """Per-model KV cache.

    k, v: [num_layers, batch, num_kv_heads, capacity, head_dim]
    lengths: [batch] int32 — valid prefix length per sequence.
    """

    k: jax.Array
    v: jax.Array
    lengths: jax.Array

    @classmethod
    def create(cls, cfg, batch: int, capacity: int, dtype=None) -> "KVCache":
        dtype = dtype or cfg.dtype
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, capacity, cfg.head_dim)
        return cls(
            k=jnp.zeros(shape, dtype),
            v=jnp.zeros(shape, dtype),
            lengths=jnp.zeros((batch,), jnp.int32),
        )

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    def update_layer(
        self, layer: int, k_new: jax.Array, v_new: jax.Array
    ) -> "KVCache":
        """Append k_new/v_new [B, Hkv, S, D] at each sequence's offset.

        Lengths are advanced once by the model after the last layer (all
        layers share one length vector, like the reference's per-layer
        `Cache.update` sharing one `cache_position`).
        """
        def upd(buf_l, new_b, start):  # buf_l [Hkv, C, D], new_b [Hkv, S, D]
            return jax.lax.dynamic_update_slice(
                buf_l, new_b.astype(buf_l.dtype), (0, start, 0)
            )

        k_l = jax.vmap(upd)(self.k[layer], k_new, self.lengths)
        v_l = jax.vmap(upd)(self.v[layer], v_new, self.lengths)
        return dataclasses.replace(
            self,
            k=self.k.at[layer].set(k_l),
            v=self.v.at[layer].set(v_l),
        )

    def advance(self, num_tokens: int | jax.Array) -> "KVCache":
        return dataclasses.replace(self, lengths=self.lengths + num_tokens)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuantizedKVCache:
    """Quantized KV cache: int8/fp8 values + per-token f32 scales.

    Halves (vs bf16) the bytes the cache holds — the reference's
    "quantized dtype kernels" roadmap item (README.md:22) carried through
    to the model runtime. Values quantize per token at write time
    (symmetric, last-axis); decode dequantizes the layer's slab before the
    dense route (ops/quantized.py, models/transformer.py).

    k_values/v_values: [L, B, Hkv, C, D] int8 or float8_e4m3fn
    k_scales/v_scales: [L, B, Hkv, C] float32
    lengths: [B] int32
    """

    k_values: jax.Array
    k_scales: jax.Array
    v_values: jax.Array
    v_scales: jax.Array
    lengths: jax.Array

    @classmethod
    def create(
        cls, cfg, batch: int, capacity: int, dtype=jnp.int8
    ) -> "QuantizedKVCache":
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, capacity, cfg.head_dim)
        sshape = shape[:-1]
        return cls(
            k_values=jnp.zeros(shape, dtype),
            k_scales=jnp.ones(sshape, jnp.float32),
            v_values=jnp.zeros(shape, dtype),
            v_scales=jnp.ones(sshape, jnp.float32),
            lengths=jnp.zeros((batch,), jnp.int32),
        )

    @property
    def capacity(self) -> int:
        return self.k_values.shape[3]

    @property
    def batch(self) -> int:
        return self.k_values.shape[1]
