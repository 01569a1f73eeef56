"""Dense (prefill) attention routes vs the fp32 HIGHEST-precision oracle.

Config matrix modeled on the reference's documented sweep
(reference: scripts/benchmark_kernel.py:174-194): MHA/GQA/MQA x causal x
dtype x head_dim, plus ragged and cross-seqlen (Sq != Skv)
bottom-right-causal cases the reference kernel supports
(csrc/mask.cuh:37-39). On the CPU `flash_attention_forward` takes the
grouped XLA route; the cuDNN route's argument mapping is checked through
`jax.nn.dot_product_attention(implementation="xla")`, and its HLO on the
card by the `gpu`-marked test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute import flash_attention_forward
from flash_attention_cute.ops.attention import cudnn_attention, cudnn_supports
from flash_attention_cute.ops.reference import attention_reference


def make_qkv(key, b, hq, hkv, sq, skv, d, dtype):
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, hq, sq, d), dtype=jnp.float32)
    k = jax.random.normal(kk, (b, hkv, skv, d), dtype=jnp.float32)
    v = jax.random.normal(kv, (b, hkv, skv, d), dtype=jnp.float32)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype)


def tol_for(dtype):
    # Reference accepts atol=1e-3 for fp16 vs an independent oracle
    # (scripts/benchmark_kernel.py:114-123); bf16 has 3 fewer mantissa
    # bits, and the route rounds probabilities to the input dtype before
    # the PV product.
    return {
        jnp.float32.dtype: 2e-5,
        jnp.float16.dtype: 2e-3,
        jnp.bfloat16.dtype: 2e-2,
    }[jnp.dtype(dtype)]


def check(out, ref, dtype):
    assert out.shape == ref.shape
    assert out.dtype == dtype
    np.testing.assert_allclose(
        np.asarray(out, np.float32),
        np.asarray(ref, np.float32),
        atol=tol_for(dtype),
        rtol=2e-2,
    )


def check_fwd(q, k, v, causal, **kw):
    out = flash_attention_forward(q, k, v, causal=causal, **kw)
    ref = attention_reference(q, k, v, causal=causal, **kw)
    check(out, ref, q.dtype)
    return out


GROUPS = pytest.mark.parametrize(
    "hq,hkv",
    # GQA groups 1 (MHA), 4, 8 (MQA) and Qwen2-7B's odd group 7.
    [(4, 4), (8, 2), (8, 1), (28, 4)],
    ids=["mha", "gqa4", "mqa8", "gqa7"],
)


@pytest.mark.parametrize("causal", [False, True])
@GROUPS
def test_head_configs(causal, hq, hkv):
    q, k, v = make_qkv(jax.random.key(0), 2, hq, hkv, 256, 256, 64, jnp.float32)
    check_fwd(q, k, v, causal)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16, jnp.float32])
def test_dtypes(dtype):
    q, k, v = make_qkv(jax.random.key(1), 1, 4, 2, 256, 256, 64, dtype)
    check_fwd(q, k, v, True)


@pytest.mark.parametrize("d", [64, 128, 96, 80, 192, 200, 256])
def test_head_dims(d):
    q, k, v = make_qkv(jax.random.key(2), 1, 4, 4, 128, 128, d, jnp.float32)
    check_fwd(q, k, v, True)


def test_fully_masked_rows_inside_visited_block():
    """Sq > Skv causal: the first Sq - Skv rows see no key and must emit
    exact zeros (the reference's sum==0 guard), not a uniform average."""
    q, k, v = make_qkv(jax.random.key(8), 1, 2, 2, 300, 100, 64, jnp.float32)
    out = check_fwd(q, k, v, True)
    np.testing.assert_array_equal(np.asarray(out[:, :, :200]), 0.0)


@pytest.mark.parametrize(
    "sq,skv",
    [(256, 512), (512, 256), (128, 1024), (384, 384)],
)
def test_cross_seqlen_bottom_right_causal(sq, skv):
    """Bottom-right alignment: with Skv > Sq the last q row sees all keys;
    with Sq > Skv the first (Sq - Skv) rows are fully masked -> zero output."""
    q, k, v = make_qkv(jax.random.key(3), 1, 2, 2, sq, skv, 64, jnp.float32)
    out = check_fwd(q, k, v, True)
    if sq > skv:
        np.testing.assert_array_equal(np.asarray(out[:, :, : sq - skv]), 0.0)


@pytest.mark.parametrize(
    "sq,skv",
    [(200, 200), (130, 390), (333, 77)],
)
def test_ragged_seqlens(sq, skv):
    """Sequence lengths that are not powers of two."""
    q, k, v = make_qkv(jax.random.key(4), 1, 2, 2, sq, skv, 64, jnp.float32)
    check_fwd(q, k, v, True)
    check_fwd(q, k, v, False)


def test_custom_scale():
    q, k, v = make_qkv(jax.random.key(5), 1, 2, 2, 128, 128, 64, jnp.float32)
    out = flash_attention_forward(q, k, v, softmax_scale=0.25)
    ref = attention_reference(q, k, v, softmax_scale=0.25)
    check(out, ref, q.dtype)


def test_llama2_7b_prefill_shape():
    """The reference's default benchmark config, scaled down in batch
    (reference: scripts/benchmark_kernel.py:127-136: B=16 Hq=64 Hkv=8 S=1024 D=128)."""
    q, k, v = make_qkv(jax.random.key(7), 1, 8, 2, 1024, 1024, 128, jnp.bfloat16)
    check_fwd(q, k, v, True)


@pytest.mark.parametrize("causal", [False, True])
def test_logit_softcap_matches_reference(causal):
    """Gemma-style tanh soft-capping of the scaled scores."""
    q, k, v = make_qkv(jax.random.key(10), 1, 4, 2, 256, 256, 64, jnp.float32)
    out = check_fwd(q, k, v, causal, logit_softcap=30.0)
    # Must differ from the uncapped result (cap actually does something).
    ref_uncapped = attention_reference(q, k, v, causal=causal)
    assert float(jnp.abs(out - ref_uncapped).max()) > 1e-4


def test_inactive_window_normalized_to_fast_path():
    """A window >= Skv can never bind (the largest query position is
    Skv-1), so it must give the unwindowed result; window = Skv - 1 does
    bind (the last row loses key 0)."""
    q, k, v = make_qkv(jax.random.key(37), 2, 8, 2, 512, 512, 64,
                       jnp.float32)
    out_w = flash_attention_forward(q, k, v, causal=True, window=512)
    out_none = flash_attention_forward(q, k, v, causal=True)
    np.testing.assert_array_equal(np.asarray(out_w), np.asarray(out_none))
    out_bind = flash_attention_forward(q, k, v, causal=True, window=511)
    assert not np.array_equal(np.asarray(out_bind), np.asarray(out_none))


@pytest.mark.parametrize(
    "causal,window", [(False, None), (True, None), (True, 64)],
    ids=["full", "causal", "window64"],
)
@GROUPS
def test_cudnn_route_argument_mapping(causal, window, hq, hkv):
    """The cuDNN route's layout transposes, GQA grouping, causal flag and
    window translation, run through jax.nn's XLA implementation on the
    CPU (cuDNN itself only lowers on the card)."""
    q, k, v = make_qkv(jax.random.key(11), 2, hq, hkv, 192, 192, 64,
                       jnp.bfloat16)
    out = cudnn_attention(q, k, v, 64 ** -0.5, causal=causal, window=window,
                          implementation="xla")
    ref = attention_reference(q, k, v, causal=causal, window=window)
    check(out, ref, q.dtype)


def _spec(*shape, dtype=jnp.bfloat16):
    return jax.ShapeDtypeStruct(shape, dtype)


_B, _K, _LEN = _spec(1, 4, 128, 64), _spec(1, 2, 128, 64), _spec(1, dtype=jnp.int32)


@pytest.mark.parametrize(
    "q,k,kw,expected",
    [
        (_B, _K, dict(causal=True), True),
        (_B, _K, dict(causal=False), True),
        (_B, _K, dict(causal=True, window=32), True),
        (_B, _K, dict(causal=False, window=32), False),
        (_spec(1, 4, 128, 64, dtype=jnp.float32),
         _spec(1, 2, 128, 64, dtype=jnp.float32), dict(causal=True), False),
        (_B, _K, dict(causal=True, logit_softcap=50.0), False),
        (_B, _K, dict(causal=True, kv_length=_LEN), False),
        (_B, _K, dict(causal=True, q_offset=_LEN), False),
        (_spec(1, 4, 64, 64), _K, dict(causal=True), False),
        (_spec(1, 4, 64, 64), _K, dict(causal=False), True),
        (_spec(1, 4, 128, 256), _spec(1, 2, 128, 256), dict(causal=True), False),
    ],
    ids=["causal", "full", "window", "window-noncausal", "fp32", "softcap",
         "kv_length", "q_offset", "sq<skv-causal", "sq<skv-full", "d256"],
)
def test_cudnn_supports(q, k, kw, expected):
    """cuDNN takes exactly the calls it expresses with this repo's
    bottom-right semantics; everything else falls back to XLA."""
    args = dict(causal=False, kv_length=None, q_offset=None, window=None,
                logit_softcap=None)
    args.update(kw)
    assert cudnn_supports(q, k, **args) is expected


@pytest.mark.gpu
def test_prefill_takes_cudnn_on_gpu(gpu_device):
    q, k, v = make_qkv(jax.random.key(12), 1, 28, 4, 512, 512, 128,
                       jnp.bfloat16)
    f = jax.jit(lambda q, k, v: flash_attention_forward(q, k, v, causal=True))
    assert "cudnn" in f.lower(q, k, v).compile().as_text()
    check(f(q, k, v), attention_reference(q, k, v, causal=True), q.dtype)
