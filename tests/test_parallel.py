"""Multi-chip sharding on an 8-virtual-device CPU mesh.

The reference has no distributed path at all (SURVEY.md §2.4); these tests
establish the scale-out contract: tensor/data-parallel forward and cached
generation produce the same numbers as single-device execution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from flash_attention_cute.models import KVCache, forward, init_params
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.parallel import (
    make_mesh,
    param_pspecs,
    shard_cache,
    shard_params,
    sharded_attention,
)
from flash_attention_cute.ops.reference import attention_reference


@pytest.fixture(scope="module")
def cfg():
    # num_kv_heads=4 divides the 4-way model axis (GQA co-location).
    return tiny_test_config(num_q_heads=8, num_kv_heads=4)


def test_mesh_construction():
    mesh = make_mesh(data=2, model=4)
    assert mesh.shape == {"data": 2, "model": 4}
    mesh_all_model = make_mesh()
    assert mesh_all_model.shape["model"] == len(jax.devices())


def test_sharded_attention_matches_reference(mesh8):
    ks = jax.random.split(jax.random.key(0), 3)
    q = jax.random.normal(ks[0], (4, 8, 64, 32))
    k = jax.random.normal(ks[1], (4, 4, 64, 32))
    v = jax.random.normal(ks[2], (4, 4, 64, 32))
    got = sharded_attention(mesh8, q, k, v, causal=True)
    want = attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_sharded_attention_with_lengths(mesh8):
    ks = jax.random.split(jax.random.key(1), 3)
    q = jax.random.normal(ks[0], (4, 8, 1, 32))
    k = jax.random.normal(ks[1], (4, 4, 128, 32))
    v = jax.random.normal(ks[2], (4, 4, 128, 32))
    lens = jnp.array([7, 60, 99, 128], jnp.int32)
    got = sharded_attention(mesh8, q, k, v, kv_length=lens)
    want = attention_reference(q, k, v, kv_length=lens)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_sharded_forward_matches_single_device(cfg, mesh8):
    params = init_params(cfg, jax.random.key(0))
    ids = jax.random.randint(jax.random.key(1), (2, 16), 0, cfg.vocab_size)

    want, _ = forward(params, cfg, ids, mode="prefill")

    sp = shard_params(params, cfg, mesh8)
    ids_sharded = jax.device_put(ids, NamedSharding(mesh8, P("data", None)))
    got, _ = forward(sp, cfg, ids_sharded, mode="prefill", mesh=mesh8)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4, rtol=1e-3)


def test_sharded_cached_decode_matches_single_device(cfg, mesh8):
    params = init_params(cfg, jax.random.key(0))
    ids = jax.random.randint(jax.random.key(2), (2, 12), 0, cfg.vocab_size)

    # single device
    cache = KVCache.create(cfg, batch=2, capacity=32)
    _, cache = forward(params, cfg, ids[:, :8], cache=cache, mode="prefill")
    want = []
    for t in range(8, 12):
        lg, cache = forward(params, cfg, ids[:, t:t+1], cache=cache, mode="decode")
        want.append(np.asarray(lg[:, 0]))

    # sharded
    sp = shard_params(params, cfg, mesh8)
    scache = shard_cache(KVCache.create(cfg, batch=2, capacity=32), mesh8)
    ids_s = jax.device_put(ids, NamedSharding(mesh8, P("data", None)))
    _, scache = forward(sp, cfg, ids_s[:, :8], cache=scache, mode="prefill", mesh=mesh8)
    for i, t in enumerate(range(8, 12)):
        lg, scache = forward(sp, cfg, ids_s[:, t:t+1], cache=scache, mode="decode", mesh=mesh8)
        np.testing.assert_allclose(np.asarray(lg[:, 0]), want[i], atol=1e-4, rtol=1e-3)


def test_param_pspecs_cover_tree(cfg):
    params = init_params(cfg, jax.random.key(0))
    specs = param_pspecs(cfg)
    # Every param leaf must have a spec leaf (tree structures match).
    jax.tree.map(lambda p, s: None, params, specs)


def test_speculative_generate_under_mesh(cfg, mesh8):
    """Speculative decoding composes with tensor/data sharding: sharded
    params + sharded caches, one jitted loop, exact vs unsharded greedy."""
    from flash_attention_cute.runtime.generate import greedy_generate
    from flash_attention_cute.runtime.speculative import (
        speculative_generate,
    )

    params = init_params(cfg, jax.random.key(30))
    dcfg = tiny_test_config(
        num_q_heads=8, num_kv_heads=4, num_layers=1
    )
    dparams = init_params(dcfg, jax.random.key(31))
    ids = jax.random.randint(jax.random.key(32), (2, 12), 0, 250)

    want = np.asarray(greedy_generate(params, cfg, ids, 10))

    sp = shard_params(params, cfg, mesh8)
    sdp = shard_params(dparams, dcfg, mesh8)
    ids_s = jax.device_put(ids, NamedSharding(mesh8, P("data", None)))
    got = np.asarray(
        speculative_generate(sp, cfg, sdp, dcfg, ids_s, 10, gamma=3,
                             mesh=mesh8)
    )
    np.testing.assert_array_equal(got, want)
