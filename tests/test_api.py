"""`flash_attn_func` API contract tests and the route selection point.

Mirrors the reference's executable preconditions
(reference: csrc/flash_attention_api.cpp:17-59 TORCH_CHECKs) and the
dispatch routing (reference: flash_attention/flash_attention.py:6-43).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute import flash_attn_func
from flash_attention_cute.ops.reference import attention_reference


def make(b=1, hq=4, hkv=2, sq=128, skv=128, d=64, dtype=jnp.float32):
    ks = jax.random.split(jax.random.key(0), 3)
    return (
        jax.random.normal(ks[0], (b, hq, sq, d), jnp.float32).astype(dtype),
        jax.random.normal(ks[1], (b, hkv, skv, d), jnp.float32).astype(dtype),
        jax.random.normal(ks[2], (b, hkv, skv, d), jnp.float32).astype(dtype),
    )


def test_default_scale_is_rsqrt_d():
    q, k, v = make()
    got = flash_attn_func(q, k, v, causal=True, interpret=True)
    want = attention_reference(q, k, v, softmax_scale=64 ** -0.5, causal=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5, rtol=2e-2)


def test_decode_routing_matches_prefill_kernel():
    """seqlen_q == 1 (decode over a cache) must agree with the reference."""
    q, k, v = make(sq=1, skv=512)
    got = flash_attn_func(q, k, v, causal=True, interpret=True)
    want = attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5, rtol=2e-2)


def test_cpu_fallback_without_interpret():
    q, k, v = make()
    got = flash_attn_func(q, k, v, causal=True)  # the CPU's XLA route
    want = attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize(
    "bad",
    [
        "rank", "kv_mismatch", "batch", "head_dim", "gqa_divisible",
        "dtype_mix", "dtype_unsupported", "head_dim_too_big",
    ],
)
def test_validation_errors(bad):
    q, k, v = make()
    if bad == "rank":
        q = q[0]
    elif bad == "kv_mismatch":
        v = v[:, :, :64]
    elif bad == "batch":
        q = jnp.concatenate([q, q], axis=0)
    elif bad == "head_dim":
        q = q[..., :32]
    elif bad == "gqa_divisible":
        q = q[:, :3]
    elif bad == "dtype_mix":
        k = k.astype(jnp.bfloat16)
    elif bad == "dtype_unsupported":
        q, k, v = (x.astype(jnp.int8) for x in (q, k, v))
    elif bad == "head_dim_too_big":
        q, k, v = make(d=512)
    with pytest.raises(ValueError):
        flash_attn_func(q, k, v)


def test_jittable_and_meta_traceable():
    """The analog of the reference's fake/meta kernel registration
    (flash_attention/flash_attention.py:40-43): the op must trace under jit
    and eval_shape without executing."""
    q, k, v = make()
    fn = jax.jit(lambda q, k, v: flash_attn_func(q, k, v, causal=True))
    shape = jax.eval_shape(fn, q, k, v)
    assert shape.shape == q.shape and shape.dtype == q.dtype
    out = fn(q, k, v)
    assert out.shape == q.shape


def test_logit_softcap_through_api():
    import functools
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flash_attention_cute.api import flash_attention_forward
    from flash_attention_cute.ops.reference import attention_reference

    ks = jax.random.split(jax.random.key(0), 3)
    q = jax.random.normal(ks[0], (1, 4, 128, 64), jnp.float32)
    k = jax.random.normal(ks[1], (1, 2, 128, 64), jnp.float32)
    v = jax.random.normal(ks[2], (1, 2, 128, 64), jnp.float32)
    out = flash_attention_forward(
        q, k, v, causal=True, logit_softcap=20.0, interpret=True
    )
    ref = attention_reference(q, k, v, causal=True, logit_softcap=20.0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-2)
    # decode path (seq_q == 1)
    out1 = flash_attention_forward(
        q[:, :, :1], k, v, causal=True, logit_softcap=20.0, interpret=True
    )
    ref1 = attention_reference(
        q[:, :, :1], k, v, causal=False, logit_softcap=20.0
    )
    np.testing.assert_allclose(np.asarray(out1), np.asarray(ref1),
                               atol=2e-5, rtol=2e-2)


@pytest.mark.parametrize(
    "platform,interpret,want",
    [
        ("gpu", None, ("cudnn", "triton")),
        ("cpu", None, ("xla", "xla")),
        ("cpu", True, ("xla", "triton")),
        ("gpu", True, ("xla", "triton")),
    ],
)
def test_select_routes_by_platform(platform, interpret, want):
    from flash_attention_cute.dispatch import select_routes

    r = select_routes(interpret, platform=platform)
    assert (r.dense, r.paged_decode) == want


def test_select_routes_reads_running_platform():
    from flash_attention_cute.dispatch import select_routes

    assert select_routes() == select_routes(platform="cpu")


@pytest.mark.parametrize("platform", ["rocm", "METAL", "cuda"])
def test_select_routes_rejects_unknown_platform(platform):
    """No silent fallback: a platform without routes is an error."""
    from flash_attention_cute.dispatch import select_routes

    with pytest.raises(ValueError, match="no attention routes"):
        select_routes(platform=platform)


@pytest.mark.parametrize(
    "kw,want_cudnn",
    [(dict(causal=True), True), (dict(causal=True, logit_softcap=30.0), False),
     (dict(causal=True, kv_length=jnp.full((1,), 100, jnp.int32),
           q_offset=jnp.full((1,), -28, jnp.int32)), False)],
    ids=["plain", "softcap", "kv_length"],
)
def test_api_takes_cudnn_only_where_supported(monkeypatch, kw, want_cudnn):
    """With the GPU's routes, the API hands cuDNN exactly the calls it
    supports and everything else to the XLA route."""
    import flash_attention_cute.api as api
    from flash_attention_cute import dispatch

    gpu_routes = dispatch.select_routes(platform="gpu")
    monkeypatch.setattr(
        dispatch, "select_routes", lambda interpret=None: gpu_routes
    )
    calls = []
    real = api.cudnn_attention

    def fake_cudnn(q, k, v, scale, causal, window):
        calls.append(1)
        return real(q, k, v, scale, causal, window, implementation="xla")

    monkeypatch.setattr(api, "cudnn_attention", fake_cudnn)
    q, k, v = make(dtype=jnp.bfloat16)
    out = flash_attn_func(q, k, v, **kw)
    assert bool(calls) is want_cudnn
    ref = attention_reference(q, k, v, **kw)
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_no_production_path_sets_interpret():
    """`interpret` is the tests' switch for the Pallas interpreter; no
    production module, script or entry point may turn it on
    (dispatch.py, which defines what the switch selects, is exempt)."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parent.parent
    files = [
        *(f for f in (root / "flash_attention_cute").rglob("*.py")
          if f.name != "dispatch.py"),
        *(root / "scripts").glob("*.py"),
        root / "bench.py", root / "chip_smoke.py", root / "__graft_entry__.py",
    ]
    pat = re.compile(r"interpret\s*=\s*True|--interpret|interpret\s*=\s*not")
    hits = [
        f"{f.relative_to(root)}:{i}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if pat.search(line)
    ]
    assert not hits, hits


@pytest.mark.parametrize(
    "preset,want",
    [("", "--xla_gpu_enable_triton_gemm=false"),
     ("--xla_gpu_enable_triton_gemm=true", "--xla_gpu_enable_triton_gemm=true")],
    ids=["unset", "user_set"],
)
def test_import_turns_off_triton_gemm_unless_user_set(preset, want):
    """Importing the package turns XLA's Triton gemm emitter off (it
    miscompiles some full-width bf16 gemms on the H100) before JAX's
    backend starts, and leaves a flag the user set alone."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, XLA_FLAGS=preset, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import os, flash_attention_cute; print(os.environ['XLA_FLAGS'])"],
        cwd=root, env=env, capture_output=True, text=True, check=True,
    ).stdout.split()
    assert out == [want]
