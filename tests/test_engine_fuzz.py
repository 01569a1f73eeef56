"""Composition fuzz: for ANY admission-side configuration (kv dtype,
chunked admission, prefix caching), every decode-side variation (plain /
model-draft speculative / prompt-lookup, decode chunking, spec round
folding, grouped prefill, priorities) must emit exactly what the plain
greedy engine emits under the SAME admission configuration.

Admission-side knobs change summation order / cache precision and can
legitimately flip near-tie argmaxes on random weights (the repo's
chunked-admission test documents this), so they are matched between the
baseline and the variant rather than fuzzed across; decode-side
variations carry a bit-exactness contract. Pairwise feature tests exist
elsewhere — this sweep guards the N-way interactions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models import init_params
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.runtime.engine import ServingEngine
from flash_attention_cute.runtime.spec_engine import (
    SpeculativeServingEngine,
)

POOL = dict(slots=2, num_pages=65, page_size=8, pages_per_seq=16)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(num_layers=2)
    return cfg, init_params(cfg, jax.random.key(0))


@pytest.fixture(scope="module")
def draft():
    cfg = tiny_test_config(num_layers=1, hidden_size=32,
                           intermediate_size=64)
    return cfg, init_params(cfg, jax.random.key(7))


@pytest.mark.parametrize("seed", [101, 202, 303, 404])
def test_random_composition_matches_plain(model, draft, seed):
    cfg, params = model
    dcfg, dparams = draft
    rng = np.random.default_rng(seed)

    # Request stream: mixed lengths incl. a shared prefix pair.
    system = rng.integers(0, cfg.vocab_size, 9).tolist()
    prompts = {
        0: system + rng.integers(0, cfg.vocab_size, 4).tolist(),
        1: system + rng.integers(0, cfg.vocab_size, 7).tolist(),
        2: rng.integers(0, cfg.vocab_size, int(rng.integers(3, 14))).tolist(),
    }
    n_new = {rid: int(rng.integers(4, 9)) for rid in prompts}
    prios = {rid: int(rng.integers(0, 3)) for rid in prompts}

    # Admission-side configuration: MATCHED between baseline and variant.
    quant = bool(rng.random() < 0.4)
    prefix = bool(rng.random() < 0.5)
    chunked = int(rng.choice([0, 8]))
    admission = dict(
        kv_dtype=jnp.int8 if quant else None,
        enable_prefix_cache=prefix,
        prefill_chunk=chunked,
    )
    base = ServingEngine(params, cfg, interpret=True, **POOL, **admission)
    for rid, p in prompts.items():
        base.submit(rid, p, n_new[rid], priority=prios[rid])
    want = base.run()
    assert not base.failed

    # Decode-side variation under the same admission config.
    engine_kind = rng.choice(["plain", "spec", "lookup"])
    kw = dict(
        POOL,
        interpret=True,
        prefill_group=int(rng.choice([1, 2])),
        **admission,
    )
    if engine_kind == "plain":
        kw["decode_chunk"] = int(rng.choice([1, 3, 8]))
        eng = ServingEngine(params, cfg, **kw)
    elif engine_kind == "spec":
        eng = SpeculativeServingEngine(
            params, cfg, draft_params=dparams, draft_cfg=dcfg,
            gamma=int(rng.choice([2, 3])),
            rounds_per_call=int(rng.choice([1, 2])), **kw,
        )
    else:
        eng = SpeculativeServingEngine(
            params, cfg, ngram=2, gamma=int(rng.choice([2, 3])),
            rounds_per_call=int(rng.choice([1, 2])), **kw,
        )
    for rid, p in prompts.items():
        eng.submit(rid, p, n_new[rid], priority=prios[rid])
    got = eng.run()
    assert got == want, (
        engine_kind, quant, prefix, chunked, got, want
    )
    assert not eng.failed
