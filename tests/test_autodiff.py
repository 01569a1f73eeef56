"""The gradient rule: `jax.grad` through the attention routes vs XLA
autodiff through the fp32 oracle.

No route carries a hand-written backward: the grouped XLA route is
differentiated by JAX itself (its softmax shift is a stop_gradient, which
the softmax's shift invariance makes exact), and cuDNN's fused attention
brings its own backward on the card. The reference is forward-only —
gradients are strictly beyond parity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute import flash_attention_forward
from flash_attention_cute.ops.attention import cudnn_attention
from flash_attention_cute.ops.reference import attention_reference


def make(key, b, hq, hkv, sq, skv, d):
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, hq, sq, d), jnp.float32)
    k = jax.random.normal(kk, (b, hkv, skv, d), jnp.float32)
    v = jax.random.normal(kv, (b, hkv, skv, d), jnp.float32)
    return q, k, v


def check_grads(f_route, f_ref, args, atol=2e-4, rtol=2e-3):
    g1 = jax.grad(f_route, argnums=(0, 1, 2))(*args)
    g2 = jax.grad(f_ref, argnums=(0, 1, 2))(*args)
    for a, b_ in zip(g1, g2):
        assert a.dtype == b_.dtype
        np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(b_, np.float32),
            atol=atol, rtol=rtol,
        )


def squared_loss(fn, **kw):
    return lambda q, k, v: jnp.sum(fn(q, k, v, **kw).astype(jnp.float32) ** 2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (28, 4), (8, 1)],
                         ids=["mha", "gqa4", "gqa7", "mqa8"])
def test_grads_match_reference_autodiff(causal, hq, hkv):
    args = make(jax.random.key(0), 2, hq, hkv, 128, 128, 32)
    check_grads(squared_loss(flash_attention_forward, causal=causal),
                squared_loss(attention_reference, causal=causal), args)


@pytest.mark.parametrize("window", [1, 48])
def test_windowed_grads(window):
    args = make(jax.random.key(1), 1, 4, 2, 160, 160, 32)
    check_grads(
        squared_loss(flash_attention_forward, causal=True, window=window),
        squared_loss(attention_reference, causal=True, window=window), args,
    )


@pytest.mark.parametrize("sq,skv", [(96, 256), (256, 96)])
def test_grads_cross_lengths(sq, skv):
    """Sq > Skv includes fully-masked rows: their output is a constant 0,
    so no gradient may flow (and none may be NaN)."""
    args = make(jax.random.key(2), 1, 4, 2, sq, skv, 32)
    check_grads(squared_loss(flash_attention_forward, causal=True),
                squared_loss(attention_reference, causal=True), args)


def test_grads_logit_softcap():
    args = make(jax.random.key(3), 1, 4, 2, 128, 128, 32)
    check_grads(
        squared_loss(flash_attention_forward, causal=True, logit_softcap=5.0),
        squared_loss(attention_reference, causal=True, logit_softcap=5.0),
        args,
    )


def test_grads_chunked_extend():
    """Grads through the extend form (per-row q_offset and kv_length)."""
    q, k, v = make(jax.random.key(4), 2, 4, 2, 32, 128, 32)
    kw = dict(causal=True, q_offset=jnp.array([40, 96], jnp.int32),
              kv_length=jnp.array([72, 128], jnp.int32))
    check_grads(squared_loss(flash_attention_forward, **kw),
                squared_loss(attention_reference, **kw), (q, k, v))


def test_grads_bf16():
    q, k, v = (x.astype(jnp.bfloat16)
               for x in make(jax.random.key(6), 1, 4, 2, 256, 256, 64))
    check_grads(
        lambda q, k, v: jnp.sum(flash_attention_forward(
            q, k, v, causal=True).astype(jnp.float32)),
        lambda q, k, v: jnp.sum(attention_reference(
            q, k, v, causal=True).astype(jnp.float32)),
        (q, k, v), atol=3e-2, rtol=3e-2,
    )


def test_cudnn_route_mapping_grads():
    """The cuDNN route's argument mapping differentiates like the oracle
    (through jax.nn's XLA implementation on the CPU)."""
    args = make(jax.random.key(5), 1, 8, 2, 128, 128, 32)
    check_grads(
        squared_loss(cudnn_attention, sm_scale=32 ** -0.5, causal=True,
                     window=40, implementation="xla"),
        squared_loss(attention_reference, causal=True, window=40), args,
    )


def test_model_forward_differentiable():
    """jax.grad through the FULL model forward on the dense route matches
    the same model differentiated through the oracle attention."""
    import flash_attention_cute.models.transformer as tr
    from flash_attention_cute.models import forward, init_params
    from flash_attention_cute.models.config import tiny_test_config

    cfg = tiny_test_config(num_layers=2, dtype=jnp.float32)
    params = init_params(cfg, jax.random.key(3))
    ids = jax.random.randint(jax.random.key(4), (2, 24), 0, cfg.vocab_size)

    def loss(p):
        logits, _ = forward(p, cfg, ids, mode="prefill")
        lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        return -jnp.mean(
            jnp.take_along_axis(lp, ids[:, 1:, None], axis=-1)
        )

    g_route = jax.grad(loss)(params)
    route = tr.flash_attention_forward
    tr.flash_attention_forward = (
        lambda q, k, v, interpret=None, **kw: attention_reference(
            q, k, v, **kw)
    )
    try:
        jax.clear_caches()
        g_ref = jax.grad(loss)(params)
    finally:
        tr.flash_attention_forward = route
        jax.clear_caches()
    for a, b in zip(jax.tree.leaves(g_route), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=5e-4, rtol=5e-3
        )
