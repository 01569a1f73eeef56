"""Projection fusion (models/fuse.py): one qkv matmul + one gate_up
matmul must reproduce the unfused forward (same math per output column,
re-associated floats only), compose with quantization (fuse-then-
quantize == quantize-then-fuse columnwise), LoRA, QKV bias, and the
serving engine, and be rejected by TP pspecs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models import forward, init_params
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.models.fuse import fuse_projections, is_fused
from flash_attention_cute.models.quantize import (
    dequantize_params,
    quantize_params,
)


def test_fused_forward_matches_unfused():
    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    fp = fuse_projections(params)
    assert is_fused(fp) and not is_fused(params)
    assert "q_proj" not in fp["layers"] and "gate_proj" not in fp["layers"]
    ids = jax.random.randint(jax.random.key(1), (2, 24), 0, cfg.vocab_size)
    want, _ = forward(params, cfg, ids, mode="prefill", interpret=True)
    got, _ = forward(fp, cfg, ids, mode="prefill", interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-4, rtol=0)


def test_fused_decode_matches_unfused():
    from flash_attention_cute.models.cache import KVCache

    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    fp = fuse_projections(params)
    ids = jax.random.randint(jax.random.key(1), (2, 16), 0, cfg.vocab_size)
    outs = []
    for p in (params, fp):
        cache = KVCache.create(cfg, batch=2, capacity=32)
        _, cache = forward(p, cfg, ids, cache=cache, mode="prefill",
                           interpret=True)
        nxt = jax.random.randint(jax.random.key(2), (2, 1), 0,
                                 cfg.vocab_size)
        logits, _ = forward(p, cfg, nxt, mode="decode", cache=cache,
                            interpret=True)
        outs.append(np.asarray(logits))
    np.testing.assert_allclose(outs[1], outs[0], atol=2e-4, rtol=0)


def test_fused_qkv_bias():
    """Qwen2-style QKV bias rides the fused matmul as one fused bias."""
    cfg = dataclasses.replace(tiny_test_config(num_layers=2),
                              attention_bias=True)
    params = init_params(cfg, jax.random.key(0))
    bias = jax.random.normal(jax.random.key(3),
                             params["layers"]["q_bias"].shape) * 0.1
    params["layers"]["q_bias"] = bias.astype(cfg.dtype)
    fp = fuse_projections(params)
    assert "qkv_bias" in fp["layers"] and "q_bias" not in fp["layers"]
    ids = jax.random.randint(jax.random.key(1), (2, 12), 0, cfg.vocab_size)
    want, _ = forward(params, cfg, ids, mode="prefill", interpret=True)
    got, _ = forward(fp, cfg, ids, mode="prefill", interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_fuse_then_quantize_equals_columnwise_quantize(bits):
    """Per-channel (int8) and per-(K-group, channel) (int4) scales are
    invariant under output-axis concat: quantizing the fused weight must
    yield exactly the unfused weights' integer columns and scales."""
    from flash_attention_cute.ops.quantized_matmul import (
        quantize_weight,
        quantize_weight_int4,
    )

    cfg = tiny_test_config(num_layers=1)
    params = init_params(cfg, jax.random.key(0))
    qf = quantize_weight if bits == 8 else quantize_weight_int4
    fused = fuse_projections(params)
    qfused = qf(fused["layers"]["qkv_proj"][0])
    hq = cfg.num_q_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    for key, lo, hi in (("q_proj", 0, hq), ("k_proj", hq, hq + hkv),
                        ("v_proj", hq + hkv, hq + 2 * hkv)):
        qpart = qf(params["layers"][key][0])
        np.testing.assert_allclose(
            np.asarray(qfused.scales[..., lo:hi]),
            np.asarray(qpart.scales[..., : hi - lo]), rtol=1e-6)
        if bits == 8:
            np.testing.assert_array_equal(
                np.asarray(qfused.values[..., : qfused.in_dim, lo:hi]),
                np.asarray(qpart.values[..., : qpart.in_dim, : hi - lo]))


@pytest.mark.parametrize("bits", [8, 4])
def test_fused_quantized_forward_matches_dequant_oracle(bits):
    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    qp = quantize_params(fuse_projections(params), bits=bits)
    dq = dequantize_params(qp, jnp.float32)
    ids = jax.random.randint(jax.random.key(1), (2, 16), 0, cfg.vocab_size)
    lq, _ = forward(qp, cfg, ids, mode="prefill", interpret=True)
    ld, _ = forward(dq, cfg, ids, mode="prefill", interpret=True)
    np.testing.assert_allclose(np.asarray(lq), np.asarray(ld),
                               atol=5e-4, rtol=0)


def test_fused_lora_matches_unfused_lora():
    from flash_attention_cute.models.lora import init_lora_params

    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    lora = init_lora_params(cfg, num_adapters=2, rank=4,
                            key=jax.random.key(5), scaling=0.5,
                            targets=("q_proj", "up_proj"))
    for proj in ("q_proj", "up_proj"):
        b = lora["layers"][proj]["b"]
        lora["layers"][proj]["b"] = b.at[:, 1].set(
            (jax.random.normal(jax.random.key(6), b[:, 1].shape) * 0.05
             ).astype(b.dtype))
    ids = jax.random.randint(jax.random.key(1), (2, 12), 0, cfg.vocab_size)
    adapter = jnp.asarray([1, 0], jnp.int32)
    want, _ = forward(params, cfg, ids, mode="prefill", interpret=True,
                      lora=lora, adapter_ids=adapter)
    got, _ = forward(fuse_projections(params), cfg, ids, mode="prefill",
                     interpret=True, lora=lora, adapter_ids=adapter)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-4, rtol=0)


def test_fused_serving_engine_token_parity():
    from flash_attention_cute.runtime.engine import ServingEngine

    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    fp = fuse_projections(params)
    rng = np.random.default_rng(3)
    prompts = {
        1: rng.integers(0, cfg.vocab_size, 9).tolist(),
        2: rng.integers(0, cfg.vocab_size, 13).tolist(),
    }
    pool = dict(slots=2, num_pages=33, page_size=8, pages_per_seq=8,
                interpret=True)

    def run(p):
        eng = ServingEngine(p, cfg, **pool)
        for rid, pr in prompts.items():
            eng.submit(rid, pr, 5)
        return eng.run()

    assert run(fp) == run(params)


def test_fused_rejected_on_mesh():
    from flash_attention_cute.parallel.sharding import param_pspecs

    cfg = tiny_test_config(num_layers=1)
    fp = fuse_projections(init_params(cfg, jax.random.key(0)))
    with pytest.raises(NotImplementedError, match="unfused"):
        param_pspecs(cfg, fp)


def test_fuse_rejects_quantized_input():
    cfg = tiny_test_config(num_layers=1)
    qp = quantize_params(init_params(cfg, jax.random.key(0)))
    with pytest.raises(AssertionError, match="fuse before"):
        fuse_projections(qp)
