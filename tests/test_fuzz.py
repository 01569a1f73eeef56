"""Seeded random-config fuzz: kernels vs fp32 oracle across the envelope.

Random (shape, heads, blocks, causal, window, kv_length) combinations —
the cross-product corners the curated tests don't enumerate. Seeded, so
failures reproduce.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.api import flash_attention_forward
from flash_attention_cute.ops.reference import attention_reference

RNG = np.random.default_rng(20260816)


def rand_cfg(i):
    rng = np.random.default_rng(20260816 + i)
    hkv = int(rng.choice([1, 2, 4]))
    group = int(rng.choice([1, 2, 4]))
    d = int(rng.choice([32, 64, 80, 128]))
    sq = int(rng.integers(1, 400))
    skv = int(rng.integers(1, 400))
    causal = bool(rng.random() < 0.6)
    window = int(rng.integers(1, 300)) if (causal and rng.random() < 0.4) else None
    use_len = rng.random() < 0.3
    b = int(rng.choice([1, 2, 3]))
    return dict(
        b=b, hq=hkv * group, hkv=hkv, sq=sq, skv=skv, d=d,
        causal=causal, window=window, use_len=use_len, seed=i,
    )


@pytest.mark.parametrize("i", range(16))
def test_fuzz_config(i):
    c = rand_cfg(i)
    ks = jax.random.split(jax.random.key(c["seed"]), 3)
    q = jax.random.normal(ks[0], (c["b"], c["hq"], c["sq"], c["d"]), jnp.float32)
    k = jax.random.normal(ks[1], (c["b"], c["hkv"], c["skv"], c["d"]), jnp.float32)
    v = jax.random.normal(ks[2], (c["b"], c["hkv"], c["skv"], c["d"]), jnp.float32)

    kv_length = None
    q_offset = None
    if c["use_len"]:
        rng = np.random.default_rng(c["seed"])
        if c["sq"] == 1:
            kv_length = jnp.asarray(
                rng.integers(1, c["skv"] + 1, size=c["b"]), jnp.int32
            )
        elif c["sq"] <= c["skv"]:
            # chunked-prefill style: offset + sq <= skv
            off = rng.integers(0, c["skv"] - c["sq"] + 1, size=c["b"])
            q_offset = jnp.asarray(off, jnp.int32)
            kv_length = jnp.asarray(off + c["sq"], jnp.int32)

    out = flash_attention_forward(
        q, k, v, causal=c["causal"], window=c["window"],
        kv_length=kv_length, q_offset=q_offset, interpret=True,
    )
    ref = attention_reference(
        q, k, v,
        causal=c["causal"] and c["sq"] > 1,
        window=c["window"],
        kv_length=kv_length, q_offset=q_offset,
    )
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        atol=3e-5, rtol=3e-2, err_msg=str(c),
    )
