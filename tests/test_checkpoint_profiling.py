"""Checkpoint round-trip (orbax) and roofline/profiling utilities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models import forward, init_params
from flash_attention_cute.models.config import tiny_test_config


def test_checkpoint_roundtrip(tmp_path):
    from flash_attention_cute.models.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    cfg = tiny_test_config()
    params = init_params(cfg, jax.random.key(0))
    save_checkpoint(tmp_path / "ck", params, cfg)

    cfg2, params2 = load_checkpoint(tmp_path / "ck")
    assert cfg2 == cfg
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        params, params2,
    )
    ids = jnp.ones((1, 8), jnp.int32)
    l1, _ = forward(params, cfg, ids, mode="prefill")
    l2, _ = forward(params2, cfg2, ids, mode="prefill")
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


def test_checkpoint_restore_with_shardings(tmp_path, mesh8):
    from jax.sharding import NamedSharding

    from flash_attention_cute.models.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from flash_attention_cute.parallel.sharding import param_pspecs

    cfg = tiny_test_config(num_q_heads=8, num_kv_heads=4)
    params = init_params(cfg, jax.random.key(1))
    save_checkpoint(tmp_path / "ck", params, cfg)

    shardings = jax.tree.map(
        lambda s: NamedSharding(mesh8, s), param_pspecs(cfg)
    )
    cfg2, params2 = load_checkpoint(tmp_path / "ck", shardings=shardings)
    q = params2["layers"]["q_proj"]
    assert q.sharding == shardings["layers"]["q_proj"]
    np.testing.assert_array_equal(
        np.asarray(q), np.asarray(params["layers"]["q_proj"])
    )


H100 = "NVIDIA H100 80GB HBM3"


def test_roofline_reports_bound():
    """XLA's cost analysis against the H100 row of the peak table (the
    CPU here has no row, so the table is named explicitly)."""
    from flash_attention_cute.utils.profiling import roofline

    def big_matmul(a, b):
        return a @ b

    a = jnp.zeros((1024, 1024), jnp.bfloat16)
    b = jnp.zeros((1024, 1024), jnp.bfloat16)
    r = roofline(big_matmul, a, b, device_kind=H100)
    assert r["flops"] > 0 and r["bytes"] > 0
    assert r["bound"] in ("compute", "memory")
    assert r["min_time_us"] > 0
    assert (r["peak_tflops"], r["peak_gbs"]) == (989.0, 3350.0)

    r2 = roofline(big_matmul, a, b, seconds=1e-3, device_kind=H100)
    assert 0 < r2["achieved_tflops"] < r2["peak_tflops"]


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_raises_on_unknown_device(kind):
    """A device missing from the peak table is an error, never a silent
    fallback to another device's peaks."""
    from flash_attention_cute.utils.profiling import device_peaks, roofline

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)
    if kind == "cpu":  # the device these tests run on
        with pytest.raises(KeyError):
            roofline(lambda a: a * 2, jnp.ones((8,)))


def test_compile_cache_uses_env_dir_and_sets_nothing(monkeypatch, tmp_path):
    import jax

    from flash_attention_cute.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_checkout_dir(monkeypatch):
    """Without the variable the cache sits at <checkout>/.jax_cache: a
    fixed path (the cache key includes it), never a temporary one."""
    import os

    import jax

    from flash_attention_cute.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(root, ".jax_cache")
        assert got == enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_trace_context(tmp_path):
    from flash_attention_cute.utils.profiling import annotate, trace

    with trace(str(tmp_path / "tr")):
        with annotate("phase"):
            jnp.ones((8, 8)).sum().block_until_ready()
    assert any((tmp_path / "tr").rglob("*"))


def test_checkpoint_gemma2_config_round_trip(tmp_path):
    """Configs with tuple fields (Gemma2's layer_window_pattern) must
    restore HASHABLE (they ride jit static args) and equal."""
    import jax

    from flash_attention_cute.models import init_params
    from flash_attention_cute.models.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from flash_attention_cute.models.config import tiny_test_config

    cfg = tiny_test_config(
        num_layers=2, layer_window_pattern=(8, None),
        sandwich_norms=True, hidden_activation="gelu_tanh",
        final_logit_softcap=30.0, scale_embeddings=True,
    )
    params = init_params(cfg, jax.random.key(0))
    save_checkpoint(tmp_path / "ck", params, cfg)
    cfg2, params2 = load_checkpoint(tmp_path / "ck")
    assert cfg2 == cfg
    hash(cfg2)  # must not raise (static-arg requirement)
    import numpy as np
    np.testing.assert_array_equal(
        np.asarray(params["layers"]["q_proj"]),
        np.asarray(params2["layers"]["q_proj"]),
    )


def test_checkpoint_lora_bank_round_trip(tmp_path):
    """A multi-LoRA adapter bank checkpoints like any pytree."""
    import jax
    import numpy as np

    from flash_attention_cute.models.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from flash_attention_cute.models.config import tiny_test_config
    from flash_attention_cute.models.lora import init_lora_params

    cfg = tiny_test_config(num_layers=2)
    lora = init_lora_params(cfg, num_adapters=3, rank=4,
                            key=jax.random.key(1))
    save_checkpoint(tmp_path / "lora", lora, cfg)
    _, lora2 = load_checkpoint(tmp_path / "lora")
    a, b = jax.tree_util.tree_leaves(lora), jax.tree_util.tree_leaves(lora2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("bits", [8, 4])
def test_checkpoint_quantized_round_trip(tmp_path, bits):
    """Quantized pytrees must round-trip bit-exactly: the dataclass
    statics (in_dim/out) live in quant.json because orbax restores raw
    pytrees. This is the 'quantize once, restore in one read' path."""
    from flash_attention_cute.models.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from flash_attention_cute.models.quantize import quantize_params
    from flash_attention_cute.ops.quantized_matmul import (
        QuantizedWeight,
        QuantizedWeight4,
    )

    cfg = tiny_test_config(num_layers=2)
    qp = quantize_params(init_params(cfg, jax.random.key(0)), bits=bits)
    save_checkpoint(tmp_path / "qck", qp, cfg)
    assert (tmp_path / "qck" / "quant.json").exists()
    cfg2, qp2 = load_checkpoint(tmp_path / "qck")
    cls = QuantizedWeight if bits == 8 else QuantizedWeight4
    for key in ("q_proj", "down_proj"):
        leaf, leaf2 = qp["layers"][key], qp2["layers"][key]
        assert isinstance(leaf2, cls)
        assert (leaf2.in_dim, leaf2.out) == (leaf.in_dim, leaf.out)
        np.testing.assert_array_equal(np.asarray(leaf2.values),
                                      np.asarray(leaf.values))
        np.testing.assert_array_equal(np.asarray(leaf2.scales),
                                      np.asarray(leaf.scales))
    ids = jnp.zeros((1, 8), jnp.int32)
    want, _ = forward(qp, cfg, ids, mode="prefill", interpret=True)
    got, _ = forward(qp2, cfg2, ids, mode="prefill", interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_checkpoint_dense_writes_no_quant_meta(tmp_path):
    from flash_attention_cute.models.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    cfg = tiny_test_config(num_layers=1)
    params = init_params(cfg, jax.random.key(0))
    save_checkpoint(tmp_path / "ck", params, cfg)
    assert not (tmp_path / "ck" / "quant.json").exists()
    _, params2 = load_checkpoint(tmp_path / "ck")
    np.testing.assert_array_equal(np.asarray(params2["layers"]["q_proj"]),
                                  np.asarray(params["layers"]["q_proj"]))
