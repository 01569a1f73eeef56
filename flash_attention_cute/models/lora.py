"""Multi-LoRA adapters for batched serving (S-LoRA style).

Beyond the reference (single dense model): many low-rank adapters stay
resident next to ONE set of base weights, and every batch row picks its
own adapter — the engine serves heterogeneous fine-tunes concurrently
with no weight swapping. Adapters are stacked
[layer, adapter, ...] so they ride the layer scan exactly like base
params, and the per-row adapter gather + two thin einsums add
O(B*S*(E+O)*r) FLOPs per projection — negligible against the base
matmul for r << E.

Layout:
    lora = {
      "layers": {proj: {"a": [L, n, in, r], "b": [L, n, r, out]}, ...},
      "scaling": [n] f32,   # usually alpha / r per adapter
    }
Adapter id 0 is the NO-OP adapter by convention: `init_lora_params`
zero-initializes every B (standard LoRA init), so requests without an
adapter route through id 0 unchanged; real adapters are trained/loaded
into ids 1..n-1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from flash_attention_cute.models.config import ModelConfig

# Projection name -> (in_features, out_features) resolver.
def _proj_dims(cfg: ModelConfig, proj: str) -> tuple[int, int]:
    e = cfg.hidden_size
    f = cfg.intermediate_size
    hq = cfg.num_q_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    return {
        "q_proj": (e, hq),
        "k_proj": (e, hkv),
        "v_proj": (e, hkv),
        "o_proj": (hq, e),
        "gate_proj": (e, f),
        "up_proj": (e, f),
        "down_proj": (f, e),
    }[proj]


DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")


def init_lora_params(
    cfg: ModelConfig,
    num_adapters: int,
    rank: int,
    key: jax.Array,
    targets: tuple = DEFAULT_TARGETS,
    scaling: float = 1.0,
) -> dict:
    """Stacked adapters with standard LoRA init (A ~ N(0, 1/in), B = 0 —
    every freshly initialized adapter, including the reserved no-op id 0,
    is exactly the base model)."""
    layers = {}
    keys = jax.random.split(key, len(targets))
    for k_, proj in zip(keys, targets):
        din, dout = _proj_dims(cfg, proj)
        a = (
            jax.random.normal(
                k_, (cfg.num_layers, num_adapters, din, rank), jnp.float32
            )
            * (din ** -0.5)
        ).astype(cfg.dtype)
        b = jnp.zeros((cfg.num_layers, num_adapters, rank, dout), cfg.dtype)
        layers[proj] = {"a": a, "b": b}
    return {
        "layers": layers,
        "scaling": jnp.full((num_adapters,), scaling, jnp.float32),
    }


def lora_delta(
    x: jax.Array,  # [B, S, in]
    lora_proj_l: dict,  # {"a": [n, in, r], "b": [n, r, out]} (layer slice)
    ids: jax.Array,  # [B] int32 adapter per row
    scaling: jax.Array,  # [n] f32
) -> jax.Array:
    """Per-row adapter delta: scaling[id] * (x @ A[id]) @ B[id]."""
    aw = lora_proj_l["a"][ids]  # [B, in, r]
    bw = lora_proj_l["b"][ids]  # [B, r, out]
    xa = jnp.einsum("bse,ber->bsr", x, aw.astype(x.dtype))
    d = jnp.einsum("bsr,bro->bso", xa, bw.astype(x.dtype))
    return d * scaling[ids].astype(x.dtype)[:, None, None]


def merge_lora(params: dict, lora: dict, adapter: int) -> dict:
    """Fold ONE adapter into dense base weights (W' = W + s * A @ B) —
    the exactness oracle for multi-adapter serving tests, and a way to
    export a merged checkpoint."""
    s = float(lora["scaling"][adapter])
    layers = dict(params["layers"])
    for proj, ab in lora["layers"].items():
        a = jnp.asarray(ab["a"][:, adapter], jnp.float32)  # [L, in, r]
        b = jnp.asarray(ab["b"][:, adapter], jnp.float32)  # [L, r, out]
        delta = jnp.einsum("lir,lro->lio", a, b) * s
        layers[proj] = (
            layers[proj].astype(jnp.float32) + delta
        ).astype(params["layers"][proj].dtype)
    return dict(params, layers=layers)


def lora_params_from_peft(
    state_dicts: list,
    cfg: ModelConfig,
    scalings: list | None = None,
    dtype=None,
) -> dict:
    """Stack HF PEFT adapter checkpoints into the serving layout.

    `state_dicts[i]` is adapter i's PEFT state dict (keys like
    `base_model.model.model.layers.N.self_attn.q_proj.lora_A.weight`,
    A stored [r, in] and B [out, r] in torch convention). Adapter 0 is
    normally a zero dict (pass `{}`) so id 0 stays the no-op; missing
    projections in any adapter contribute zero delta for that adapter.
    `scalings[i]` defaults to 1.0 (pass alpha/r per adapter).
    """
    import re as _re

    from flash_attention_cute.models.convert import _to_np

    dtype = dtype or cfg.dtype
    pat = _re.compile(
        r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+_proj)\."
        r"lora_(A|B)\.(?:default\.)?weight$"
    )
    # Discover ranks/targets across all adapters.
    per_adapter: list[dict] = []
    targets: dict[str, int] = {}
    for sd in state_dicts:
        found: dict[tuple, any] = {}
        for k, v in sd.items():
            m = pat.search(k)
            if not m:
                continue
            layer, proj, ab = int(m.group(1)), m.group(2), m.group(3)
            w = _to_np(v)
            found[(layer, proj, ab)] = w
            if ab == "A":
                r = w.shape[0]
                targets[proj] = max(targets.get(proj, 0), r)
        per_adapter.append(found)
    if not targets:
        raise ValueError("no LoRA weights found in any state dict")

    n = len(state_dicts)
    layers = {}
    for proj, rank in targets.items():
        din, dout = _proj_dims(cfg, proj)
        a = np.zeros((cfg.num_layers, n, din, rank), np.float32)
        b = np.zeros((cfg.num_layers, n, rank, dout), np.float32)
        for i, found in enumerate(per_adapter):
            for layer in range(cfg.num_layers):
                wa = found.get((layer, proj, "A"))
                wb = found.get((layer, proj, "B"))
                if wa is not None:
                    a[layer, i, :, : wa.shape[0]] = wa.T  # [r,in]->[in,r]
                if wb is not None:
                    b[layer, i, : wb.shape[1], :] = wb.T  # [out,r]->[r,out]
        layers[proj] = {
            "a": jnp.asarray(a, dtype), "b": jnp.asarray(b, dtype)
        }
    if scalings is None:
        scalings = [1.0] * n
    return {
        "layers": layers,
        "scaling": jnp.asarray(scalings, jnp.float32),
    }
