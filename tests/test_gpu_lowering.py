"""The Triton paged-decode kernel lowers for CUDA at every preset's widths.

Lowering needs no card: `.lower(lowering_platforms=("cuda",))` runs the
Pallas-to-Triton lowering on the CPU host and emits the kernel as a
`__gpu$xla.gpu.triton` custom call. What the GPU's compiler says about the
kernel (shared memory, registers) shows only on the card: `chip_smoke.py`
compiles and checks it there.
"""

import jax
import jax.numpy as jnp
import pytest

from flash_attention_cute import dispatch
from flash_attention_cute.models.presets import PRESETS
from flash_attention_cute.ops.paged_attention import paged_decode_triton
from flash_attention_cute.ops.quantized import quantize_kv

TRITON_CALL = "__gpu$xla.gpu.triton"
FULL_WIDTH = ["llama2-7b", "llama3-8b", "qwen2-7b", "gemma2-9b", "mistral-7b"]


def lower_decode(cfg, page_size, kv_dtype=None, batch=8, tokens=4096):
    """StableHLO text of one decode call at `cfg`'s attention widths."""
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    pps = tokens // page_size
    pages = batch * pps + 1
    q = jax.ShapeDtypeStruct((batch, hq, 1, d), jnp.bfloat16)
    kv = jax.ShapeDtypeStruct((hkv, pages, page_size, d), jnp.bfloat16)
    lens = jax.ShapeDtypeStruct((batch,), jnp.int32)
    table = jax.ShapeDtypeStruct((batch, pps), jnp.int32)
    window = cfg.sliding_window if cfg.use_sliding_window else None
    if cfg.layer_window_pattern is not None:
        window = cfg.layer_window_pattern[0]

    def step(q, k, v, lens, table):
        if kv_dtype is not None:
            k, v = quantize_kv(k, kv_dtype), quantize_kv(v, kv_dtype)
        return paged_decode_triton(
            q, k, v, lens, table, d ** -0.5, window, cfg.logit_softcap,
            False,
        )

    lowered = jax.jit(step).trace(q, kv, kv, lens, table).lower(
        lowering_platforms=("cuda",)
    )
    return lowered.as_text()


@pytest.mark.parametrize("page_size", [16, 64, 128])
@pytest.mark.parametrize("preset", FULL_WIDTH)
def test_paged_decode_lowers_for_cuda(preset, page_size):
    text = lower_decode(PRESETS[preset](), page_size)
    assert text.count(TRITON_CALL) == 1


@pytest.mark.parametrize("kv_dtype", [jnp.int8, jnp.float8_e4m3fn],
                         ids=["int8", "fp8"])
def test_quantized_paged_decode_lowers_for_cuda(kv_dtype):
    text = lower_decode(PRESETS["qwen2-7b"](), 16, kv_dtype)
    assert text.count(TRITON_CALL) == 1


@pytest.mark.parametrize("kv_dtype", [None, jnp.int8], ids=["bf16", "int8"])
def test_engine_decode_step_lowers_with_triton(monkeypatch, kv_dtype):
    """The serving engine's whole decode step, with the GPU's routes,
    lowers for CUDA with the kernel inside the layer scan (one call site)
    and no interpreter loop in its place."""
    from flash_attention_cute.models import init_params
    from flash_attention_cute.models.config import tiny_test_config
    from flash_attention_cute.runtime.paged_cache import (
        create_paged_state,
        create_quantized_paged_state,
    )
    from flash_attention_cute.runtime.paged_forward import forward_paged

    gpu = dispatch.select_routes(platform="gpu")
    monkeypatch.setattr(dispatch, "select_routes",
                        lambda interpret=None, platform=None: gpu)
    cfg = tiny_test_config(num_layers=2, dtype=jnp.bfloat16)
    params = init_params(cfg, jax.random.key(0))
    if kv_dtype is None:
        state = create_paged_state(cfg, num_pages=17, page_size=16, batch=4,
                                   pages_per_seq=4)
    else:
        state = create_quantized_paged_state(
            cfg, num_pages=17, page_size=16, batch=4, pages_per_seq=4,
            dtype=kv_dtype,
        )
    ids = jnp.zeros((4, 1), jnp.int32)
    jax.clear_caches()
    try:
        text = forward_paged.trace(
            params, cfg, ids, state, mode="decode"
        ).lower(lowering_platforms=("cuda",)).as_text()
    finally:
        jax.clear_caches()
    assert text.count(TRITON_CALL) == 1
