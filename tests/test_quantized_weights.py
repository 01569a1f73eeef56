"""Weight-only int8 quantization (ops/quantized_matmul.py +
models/quantize.py): the dequant-dot matmul must be exactly the
math of `x @ (values * scales)`, and a quantized parameter pytree must
drop into forward / generate / the serving engine / a TP mesh unchanged.

Parity protocol: quantized paths compare against the DEQUANTIZED-weights
oracle (same numbers, dense math) — this isolates packing/wiring bugs
from quantization error, which is weight-distribution-dependent and not
what these tests measure. The reference has no weight quantization
(reference: README.md:22 lists only quantized kernels as a TODO).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models import forward, init_params
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.models.quantize import (
    dequantize_params,
    quantize_params,
)
from flash_attention_cute.ops.quantized_matmul import (
    QuantizedWeight,
    dequantize_weight,
    quantize_weight,
    quantized_matmul,
)


# Activation dtypes: fp32 matches the dequantized oracle to summation
# order; bf16 adds one bf16 rounding of the output (2^-8 relative).
X_DTYPES = pytest.mark.parametrize(
    "x_dtype,atol,rtol",
    [(jnp.float32, 5e-4, 0), (jnp.bfloat16, 5e-2, 1e-2)],
    ids=["f32", "bf16"],
)


@X_DTYPES
@pytest.mark.parametrize(
    "t,k,n",
    [
        (8, 128, 256),     # aligned
        (3, 300, 520),     # odd widths, odd row count
        (1, 64, 130),      # decode-like single row, tiny dims
        (513, 1024, 384),  # many rows
    ],
)
def test_matmul_matches_dequant_oracle(x_dtype, atol, rtol, t, k, n):
    w = jax.random.normal(jax.random.key(0), (k, n), jnp.float32)
    x = jax.random.normal(jax.random.key(1), (t, k), jnp.float32)
    qw = quantize_weight(w)
    got = quantized_matmul(x.astype(x_dtype), qw)
    want = x.astype(x_dtype).astype(jnp.float32) @ dequantize_weight(qw)
    assert got.shape == (t, n) and got.dtype == x_dtype
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want),
                               atol=atol, rtol=rtol)


def test_int8_weights_carry_no_padding():
    """The XLA dequant-dot needs no tile padding: values keep the dense
    weight's [K, N], so no byte is stored or read for padding."""
    w = jax.random.normal(jax.random.key(0), (2, 300, 520), jnp.float32)
    qw = quantize_weight(w)
    assert qw.values.shape == (2, 300, 520)
    assert qw.scales.shape == (2, 520)


def test_padded_int8_weights_stay_exact():
    """Weights saved with zero-padded K rows / N columns and unit pad
    scales (older checkpoints) multiply exactly like unpadded ones."""
    w = jax.random.normal(jax.random.key(0), (300, 520), jnp.float32)
    x = jax.random.normal(jax.random.key(1), (5, 300), jnp.float32)
    qw = quantize_weight(w)
    padded = QuantizedWeight(
        values=jnp.pad(qw.values, ((0, 212), (0, 504))),
        scales=jnp.pad(qw.scales, (0, 504), constant_values=1.0),
        in_dim=300, out=520,
    )
    np.testing.assert_allclose(np.asarray(quantized_matmul(x, padded)),
                               np.asarray(quantized_matmul(x, qw)),
                               atol=1e-5, rtol=0)


def test_matmul_bf16_activations():
    w = jax.random.normal(jax.random.key(0), (256, 384), jnp.float32)
    x = jax.random.normal(jax.random.key(1), (16, 256), jnp.bfloat16)
    qw = quantize_weight(w)
    got = quantized_matmul(x, qw)
    want = (
        x.astype(jnp.float32) @ dequantize_weight(qw)
    ).astype(jnp.bfloat16)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        atol=0.15, rtol=0,
    )


def test_stacked_weight_slices_under_scan():
    """Layer-stacked QuantizedWeight leaves must slice per layer under
    lax.scan like any pytree (the transformer scans its layer stack)."""
    w = jax.random.normal(jax.random.key(0), (3, 64, 128), jnp.float32)
    qw = quantize_weight(w)
    x = jax.random.normal(jax.random.key(1), (2, 64), jnp.float32)

    def body(c, lw):
        return c, quantized_matmul(x, lw)

    _, ys = jax.lax.scan(body, 0, qw)
    for layer in range(3):
        want = x @ dequantize_weight(
            quantize_weight(w[layer])
        )
        np.testing.assert_allclose(np.asarray(ys[layer]), np.asarray(want),
                                   atol=2e-4, rtol=0)


def test_quantize_params_structure():
    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    qp = quantize_params(params)
    for k in ("q_proj", "o_proj", "down_proj"):
        assert isinstance(qp["layers"][k], QuantizedWeight)
        assert qp["layers"][k].values.dtype == jnp.int8
    # Norms, biases, embedding stay dense.
    assert not isinstance(qp["layers"]["input_ln"], QuantizedWeight)
    assert not isinstance(qp["embed"], QuantizedWeight)
    # Round trip restores shapes.
    dq = dequantize_params(qp, jnp.float32)
    assert dq["layers"]["q_proj"].shape == params["layers"]["q_proj"].shape


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_forward_matches_dequant_oracle(mode):
    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    qp = quantize_params(params)
    dq = dequantize_params(qp, jnp.float32)
    if mode == "prefill":
        ids = jax.random.randint(jax.random.key(1), (2, 24), 0,
                                 cfg.vocab_size)
        lq, _ = forward(qp, cfg, ids, mode="prefill", interpret=True)
        ld, _ = forward(dq, cfg, ids, mode="prefill", interpret=True)
    else:
        from flash_attention_cute.models.cache import KVCache

        ids = jax.random.randint(jax.random.key(1), (2, 16), 0,
                                 cfg.vocab_size)
        cq = KVCache.create(cfg, batch=2, capacity=32)
        cd = KVCache.create(cfg, batch=2, capacity=32)
        _, cache_q = forward(qp, cfg, ids, cache=cq, mode="prefill",
                             interpret=True)
        _, cache_d = forward(dq, cfg, ids, cache=cd, mode="prefill",
                             interpret=True)
        nxt = jax.random.randint(jax.random.key(2), (2, 1), 0,
                                 cfg.vocab_size)
        lq, _ = forward(qp, cfg, nxt, mode="decode", cache=cache_q,
                        interpret=True)
        ld, _ = forward(dq, cfg, nxt, mode="decode", cache=cache_d,
                        interpret=True)
    np.testing.assert_allclose(np.asarray(lq), np.asarray(ld),
                               atol=5e-4, rtol=0)


def test_serving_engine_quantized_weights():
    """Tokens from the engine running int8 weights must equal tokens from
    the same engine running the dequantized-dense image of those weights
    (identical numbers; only the matmul implementation differs)."""
    from flash_attention_cute.runtime.engine import ServingEngine

    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    qp = quantize_params(params)
    dq = dequantize_params(qp, jnp.float32)
    rng = np.random.default_rng(3)
    prompts = {
        1: rng.integers(0, cfg.vocab_size, 9).tolist(),
        2: rng.integers(0, cfg.vocab_size, 13).tolist(),
        3: rng.integers(0, cfg.vocab_size, 5).tolist(),
    }
    pool = dict(slots=2, num_pages=33, page_size=8, pages_per_seq=8,
                interpret=True)

    def run(p):
        eng = ServingEngine(p, cfg, **pool)
        for rid, pr in prompts.items():
            eng.submit(rid, pr, 5)
        return eng.run()

    assert run(qp) == run(dq)


def test_tied_embeddings_lm_head_stays_dense():
    import dataclasses

    cfg = dataclasses.replace(tiny_test_config(num_layers=1),
                              tie_word_embeddings=True)
    params = init_params(cfg, jax.random.key(0))
    assert "lm_head" not in params
    qp = quantize_params(params)
    ids = jax.random.randint(jax.random.key(1), (1, 8), 0, cfg.vocab_size)
    lq, _ = forward(qp, cfg, ids, mode="prefill", interpret=True)
    ld, _ = forward(dequantize_params(qp, jnp.float32), cfg, ids,
                    mode="prefill", interpret=True)
    np.testing.assert_allclose(np.asarray(lq), np.asarray(ld),
                               atol=5e-4, rtol=0)


def test_lora_composes_with_quantized_base():
    """LoRA deltas ride on top of the quantized dense output
    (layers._maybe_lora wraps layers.dense)."""
    from flash_attention_cute.models.lora import (
        init_lora_params,
        lora_delta,  # noqa: F401  (import guards the API exists)
    )

    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    qp = quantize_params(params)
    dq = dequantize_params(qp, jnp.float32)
    lora = init_lora_params(cfg, num_adapters=2, rank=4,
                            key=jax.random.key(5), scaling=0.5)
    qb = lora["layers"]["q_proj"]["b"]
    lora["layers"]["q_proj"]["b"] = qb.at[:, 1].set(
        (jax.random.normal(jax.random.key(6), qb[:, 1].shape) * 0.05
         ).astype(qb.dtype)
    )
    ids = jax.random.randint(jax.random.key(1), (2, 12), 0, cfg.vocab_size)
    adapter = jnp.asarray([1, 1], jnp.int32)
    lq, _ = forward(qp, cfg, ids, mode="prefill", interpret=True,
                    lora=lora, adapter_ids=adapter)
    ld, _ = forward(dq, cfg, ids, mode="prefill", interpret=True,
                    lora=lora, adapter_ids=adapter)
    np.testing.assert_allclose(np.asarray(lq), np.asarray(ld),
                               atol=5e-4, rtol=0)


def test_tp_mesh_quantized_xla_impl(mesh8):
    """Quantized params shard over the ('data','model') mesh
    via the expanded pspecs and reproduce the single-device quantized
    forward."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from flash_attention_cute.models.config import ModelConfig
    from flash_attention_cute.parallel.sharding import (
        param_pspecs,
        shard_params,
    )

    cfg = ModelConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_layers=2, num_q_heads=16, num_kv_heads=8, head_dim=32,
        max_position_embeddings=128, dtype=jnp.float32,
    )
    params = init_params(cfg, jax.random.key(0))
    qp = quantize_params(params)
    specs = param_pspecs(cfg, qp)
    assert specs["layers"]["q_proj"].values == P(None, None, "model")
    assert specs["layers"]["q_proj"].scales == P(None, "model")
    assert specs["layers"]["o_proj"].scales == P(None, None)

    want, _ = forward(qp, cfg,
                      jnp.zeros((2, 16), jnp.int32), mode="prefill",
                      interpret=True)
    with mesh8:
        sharded = shard_params(qp, cfg, mesh8)
        ids = jax.device_put(
            jnp.zeros((2, 16), jnp.int32),
            NamedSharding(mesh8, P("data", None)),
        )
        got, _ = forward(sharded, cfg, ids, mode="prefill",
                         interpret=True, mesh=mesh8)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=5e-4, rtol=0)


# ---------------------------------------------------------------------------
# Int4 (grouped, nibble-packed) — same parity protocol: compare against
# the DEQUANTIZED oracle so packing bugs are isolated from the (much
# larger) int4 quantization error.
# ---------------------------------------------------------------------------

from flash_attention_cute.ops.quantized_matmul import (  # noqa: E402
    GROUP4,
    QuantizedWeight4,
    dequantize_weight4,
    quantize_weight_int4,
)


def test_int4_pack_roundtrip_exact():
    """Quantize->dequantize must reproduce exactly values*scales (the
    nibble pack/unpack is lossless; only the rounding to 4 bits is not),
    including the block-local half ordering across multiple K blocks."""
    w = jax.random.normal(jax.random.key(0), (1024 + 256, 384),
                          jnp.float32)
    qw = quantize_weight_int4(w)
    assert qw.values.shape == (1536 // 2, 384)  # K 1280->1536 (BLOCK_K)
    assert qw.scales.shape[-2] == qw.values.shape[-2] * 2 // GROUP4
    dq = dequantize_weight4(qw)
    # Independent reconstruction: unpack nibbles by hand in numpy.
    vals = np.asarray(qw.values).astype(np.int32)
    k_pad = vals.shape[0] * 2
    bk = min(512, k_pad)
    blocks = vals.reshape(k_pad // bk, bk // 2, -1)
    # Biased storage (u = q + 8, ops/quantized_matmul._unpack4):
    # decode independently with numpy.
    lo = (blocks & 0xF) - 8
    hi = ((blocks >> 4) & 0xF) - 8
    q = np.concatenate([lo, hi], axis=1).reshape(k_pad, -1)
    scales = np.repeat(np.asarray(qw.scales), GROUP4, axis=0)
    want = (q * scales)[: w.shape[0], : w.shape[1]]
    np.testing.assert_array_equal(np.asarray(dq), want.astype(np.float32))
    # And the rounding error is bounded by half a step per element.
    step = scales[: w.shape[0], : w.shape[1]]
    assert np.all(np.abs(np.asarray(dq) - np.asarray(w)) <= 0.5 * step + 1e-6)


@X_DTYPES
@pytest.mark.parametrize(
    "t,k,n",
    [
        (8, 256, 256),     # aligned, one K block
        (3, 300, 520),     # K padded to the pack block, odd row count
        (1, 64, 130),      # decode-like single row, tiny dims
        (257, 1152, 384),  # multiple K blocks incl. a ragged 256 tail
    ],
)
def test_int4_matmul_matches_dequant_oracle(x_dtype, atol, rtol, t, k, n):
    w = jax.random.normal(jax.random.key(0), (k, n), jnp.float32)
    x = jax.random.normal(jax.random.key(1), (t, k), jnp.float32)
    qw = quantize_weight_int4(w)
    got = quantized_matmul(x.astype(x_dtype), qw)
    # int4 dequantizes to the activation dtype (one rounding per weight).
    want = (x.astype(x_dtype).astype(jnp.float32)
            @ dequantize_weight4(qw, x_dtype).astype(jnp.float32))
    assert got.shape == (t, n) and got.dtype == x_dtype
    assert qw.values.shape[-1] == n  # N is never padded
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want),
                               atol=atol, rtol=rtol)


def test_int4_groups_have_independent_scales():
    """A huge outlier in one 128-row K group must not destroy the
    resolution of other groups (the whole point of grouped scales)."""
    w = jax.random.normal(jax.random.key(0), (256, 128), jnp.float32)
    w = w.at[7, :].set(1000.0)  # blast group 0
    qw = quantize_weight_int4(w)
    dq = np.asarray(dequantize_weight4(qw))
    # Group 1 (rows 128..256) keeps fine resolution.
    err1 = np.abs(dq[128:] - np.asarray(w[128:]))
    assert err1.max() < 0.5  # ~absmax/7/2 of a unit-normal group
    # Per-channel int8-style scaling would have step ~1000/127 ≈ 7.9.


def test_int4_stacked_scan():
    w = jax.random.normal(jax.random.key(0), (3, 128, 128), jnp.float32)
    qw = quantize_weight_int4(w)
    x = jax.random.normal(jax.random.key(1), (2, 128), jnp.float32)

    def body(c, lw):
        return c, quantized_matmul(x, lw)

    _, ys = jax.lax.scan(body, 0, qw)
    for layer in range(3):
        want = x @ dequantize_weight4(quantize_weight_int4(w[layer]))
        np.testing.assert_allclose(np.asarray(ys[layer]),
                                   np.asarray(want), atol=5e-4, rtol=0)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_int4_forward_matches_dequant_oracle(mode):
    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    qp = quantize_params(params, bits=4)
    assert isinstance(qp["layers"]["q_proj"], QuantizedWeight4)
    dq = dequantize_params(qp, jnp.float32)
    if mode == "prefill":
        ids = jax.random.randint(jax.random.key(1), (2, 24), 0,
                                 cfg.vocab_size)
        lq, _ = forward(qp, cfg, ids, mode="prefill", interpret=True)
        ld, _ = forward(dq, cfg, ids, mode="prefill", interpret=True)
    else:
        from flash_attention_cute.models.cache import KVCache

        ids = jax.random.randint(jax.random.key(1), (2, 16), 0,
                                 cfg.vocab_size)
        cq = KVCache.create(cfg, batch=2, capacity=32)
        cd = KVCache.create(cfg, batch=2, capacity=32)
        _, cache_q = forward(qp, cfg, ids, cache=cq, mode="prefill",
                             interpret=True)
        _, cache_d = forward(dq, cfg, ids, cache=cd, mode="prefill",
                             interpret=True)
        nxt = jax.random.randint(jax.random.key(2), (2, 1), 0,
                                 cfg.vocab_size)
        lq, _ = forward(qp, cfg, nxt, mode="decode", cache=cache_q,
                        interpret=True)
        ld, _ = forward(dq, cfg, nxt, mode="decode", cache=cache_d,
                        interpret=True)
    np.testing.assert_allclose(np.asarray(lq), np.asarray(ld),
                               atol=5e-4, rtol=0)


def test_int4_serving_engine_token_parity():
    from flash_attention_cute.runtime.engine import ServingEngine

    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    qp = quantize_params(params, bits=4)
    dq = dequantize_params(qp, jnp.float32)
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

    assert run(qp) == run(dq)


def test_int4_rejected_on_mesh():
    from flash_attention_cute.parallel.sharding import param_pspecs

    cfg = tiny_test_config(num_layers=1)
    params = init_params(cfg, jax.random.key(0))
    qp = quantize_params(params, bits=4)
    with pytest.raises(NotImplementedError, match="single-card"):
        param_pspecs(cfg, qp)


def test_quantize_params_on_host():
    """Host-side init+quantize must produce the same int8 pytree as
    quantizing a device-resident dense image (models whose dense image
    exceeds device memory can ONLY take the host path)."""
    from flash_attention_cute.models.quantize import (
        quantize_params_on_host,
    )

    cfg = tiny_test_config(num_layers=2)
    qp_host = quantize_params_on_host(
        lambda: init_params(cfg, jax.random.key(0)))
    qp_dev = quantize_params(init_params(cfg, jax.random.key(0)))
    for k in ("q_proj", "down_proj"):
        np.testing.assert_array_equal(
            np.asarray(qp_host["layers"][k].values),
            np.asarray(qp_dev["layers"][k].values),
        )
        np.testing.assert_allclose(
            np.asarray(qp_host["layers"][k].scales),
            np.asarray(qp_dev["layers"][k].scales), rtol=1e-6,
        )
    # The transferred pytree serves a forward pass on the default device.
    logits, _ = forward(qp_host, cfg, jnp.zeros((1, 8), jnp.int32),
                        mode="prefill", interpret=True)
    assert logits.shape == (1, 8, cfg.vocab_size)
