"""Sequence-parallel attention (all-gather + ring) vs dense reference.

Runs on the virtual 8-device CPU mesh; XLA collectives are identical code
single- vs multi-host, so passing here validates the real-mesh path
(SURVEY.md §4 multi-host test strategy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from flash_attention_cute.ops.reference import attention_reference
from flash_attention_cute.parallel.sequence import (
    allgather_attention,
    ring_attention,
)


@pytest.fixture(scope="module")
def sp_mesh():
    return Mesh(np.array(jax.devices()).reshape(8), ("sp",))


def make(key, b, hq, hkv, s, d):
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, hq, s, d), jnp.float32)
    k = jax.random.normal(kk, (b, hkv, s, d), jnp.float32)
    v = jax.random.normal(kv, (b, hkv, s, d), jnp.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
def test_allgather_attention(sp_mesh, causal):
    q, k, v = make(jax.random.key(0), 2, 4, 2, 512, 64)
    out = allgather_attention(q, k, v, sp_mesh, causal=causal)
    ref = attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=2e-5, rtol=2e-2,
    )


def test_allgather_attention_windowed(sp_mesh):
    q, k, v = make(jax.random.key(1), 1, 4, 2, 512, 64)
    out = allgather_attention(q, k, v, sp_mesh, causal=True, window=100)
    ref = attention_reference(q, k, v, causal=True, window=100)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=2e-5, rtol=2e-2,
    )


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention(sp_mesh, causal):
    q, k, v = make(jax.random.key(2), 2, 4, 2, 512, 64)
    out = ring_attention(q, k, v, sp_mesh, causal=causal)
    ref = attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=2e-5, rtol=2e-2,
    )


def test_ring_matches_allgather(sp_mesh):
    q, k, v = make(jax.random.key(3), 1, 8, 8, 1024, 64)
    o1 = ring_attention(q, k, v, sp_mesh, causal=True)
    o2 = allgather_attention(q, k, v, sp_mesh, causal=True)
    np.testing.assert_allclose(
        np.asarray(o1, np.float32), np.asarray(o2, np.float32),
        atol=2e-5, rtol=2e-2,
    )


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(8, 1), (28, 4)], ids=["mqa8", "gqa7"])
def test_ring_attention_gqa_groups(sp_mesh, causal, hq, hkv):
    """The ring's XLA partials over GQA groups 8 and 7 (the KV heads are
    repeated once per shard, then rotated)."""
    q, k, v = make(jax.random.key(5), 1, hq, hkv, 256, 32)
    out = ring_attention(q, k, v, sp_mesh, causal=causal)
    ref = attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=2e-5, rtol=2e-2,
    )


def test_allgather_attention_bf16_gqa7(sp_mesh):
    """bf16 inputs at Qwen2-7B's group 7 through the dense route."""
    q, k, v = (x.astype(jnp.bfloat16)
               for x in make(jax.random.key(6), 1, 28, 4, 256, 64))
    out = allgather_attention(q, k, v, sp_mesh, causal=True)
    ref = attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=2e-2, rtol=2e-2,
    )
