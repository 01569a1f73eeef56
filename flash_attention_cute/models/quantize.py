"""Weight-only int8 quantization of a model parameter pytree.

`quantize_params` replaces every 2-D projection weight (q/k/v/o, the
three MLP mats, lm_head) with an `ops.quantized_matmul.QuantizedWeight`
— per-output-channel symmetric int8, near-lossless at W8 — and leaves
norms, biases, and the embedding table (a gather, not a matmul) in the
original dtype. `models.layers.dense` dispatches on the leaf type, so
the quantized pytree drops into `forward`, `runtime.generate`, and every
serving engine unchanged.

Why: decode at small batch streams the full weight set once per token,
so fewer weight bytes means less to read per step. The reference has no
weight quantization (reference: README.md:22 lists only quantized
kernels as a TODO).

Tied embeddings (`lm_head is None`) keep the logits matmul in the
embedding's dtype — the embedding must stay a gatherable array.

On tensor-parallel meshes GSPMD partitions the dequant+dot like any dense
matmul; `parallel.sharding.param_pspecs(..., params=)` expands the specs
for quantized leaves.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from flash_attention_cute.ops.quantized_matmul import (
    QuantizedWeight,
    QuantizedWeight4,
    dequantize_weight,
    dequantize_weight4,
    quantize_weight,
    quantize_weight_int4,
)

PROJ_KEYS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
    # fused layout (models/fuse.py) — per-channel/per-group scales are
    # invariant under the output-axis concat, so fuse-then-quantize
    # equals quantize-then-fuse columnwise
    "qkv_proj", "gate_up_proj",
)


def quantize_params(params: dict, bits: int = 8) -> dict:
    """New params pytree with projection weights quantized.

    bits=8: per-output-channel int8 (near-lossless, the decode-bandwidth
    choice). bits=4: 128-row-group int4 (half the bytes again — the
    capacity choice; expect visible quantization error, use evals not
    logits parity)."""
    assert bits in (8, 4), bits
    qf = quantize_weight if bits == 8 else quantize_weight_int4
    out = dict(params)
    layers = dict(params["layers"])
    for k in PROJ_KEYS:
        if k in layers:
            layers[k] = qf(layers[k])
    out["layers"] = layers
    if params.get("lm_head") is not None:
        out["lm_head"] = qf(params["lm_head"])
    return out


def quantize_params_on_host(init_fn, device=None, bits: int = 8) -> dict:
    """Init + quantize on the host CPU, then transfer the quantized image
    to `device`, so the dense pytree never materializes on the device
    (for models whose dense image exceeds its memory).
    `init_fn()` is called under the CPU default device (e.g.
    `lambda: init_params(cfg, key)` or a checkpoint loader); `device`
    defaults to the default backend's first device.
    """
    cpu = jax.local_devices(backend="cpu")[0]
    with jax.default_device(cpu):
        qp = quantize_params(init_fn(), bits=bits)
    if device is None:
        device = jax.devices()[0]
    return jax.device_put(qp, device)


def dequantize_params(params: dict, dtype=jnp.bfloat16) -> dict:
    """Exact dense-weight image of a quantized pytree (the parity oracle:
    forward(quantized) must match forward(dequantized) to matmul
    tolerance — this isolates matmul bugs from quantization error)."""
    def dq(v):
        if isinstance(v, QuantizedWeight4):
            return dequantize_weight4(v, dtype)
        if isinstance(v, QuantizedWeight):
            return dequantize_weight(v, dtype)
        return v

    out = dict(params)
    out["layers"] = {k: dq(v) for k, v in params["layers"].items()}
    if isinstance(params.get("lm_head"), (QuantizedWeight,
                                          QuantizedWeight4)):
        out["lm_head"] = dq(params["lm_head"])
    return out
