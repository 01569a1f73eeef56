"""Prompt-lookup (n-gram) speculative decoding: draft-free proposals,
exact outputs.

The contract mirrors the model-draft path: proposals only control speed;
greedy output is bit-identical to `greedy_generate` whether or not the
lookup ever hits, and sampled output is rejection-sampled against a
one-hot proposal (marginal = the target's own filtered distribution).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.models.transformer import init_params
from flash_attention_cute.runtime.generate import greedy_generate
from flash_attention_cute.runtime.prompt_lookup import (
    ngram_propose,
    prompt_lookup_generate,
)


@pytest.fixture(scope="module")
def target():
    cfg = tiny_test_config(num_layers=2, dtype=jnp.float32)
    params = init_params(cfg, jax.random.key(0))
    return cfg, params


def test_ngram_propose_finds_most_recent_continuation():
    # Row 0: suffix (7, 8) occurred twice; most recent at positions 5-6,
    # continuation 41, 42, 43. Row 1: no match -> repeat last token.
    hist = jnp.asarray([
        [7, 8, 21, 22, 23, 7, 8, 41, 42, 43, 7, 8, 0, 0, 0, 0],
        [1, 2, 3, 4, 5, 6, 9, 9, 9, 9, 9, 9, 0, 0, 0, 0],
    ], jnp.int32)
    # Row 0: 12 valid tokens, last two are (7, 8).
    # Row 1: 6 valid tokens, suffix (5, 6) unseen before.
    hlen = jnp.asarray([12, 6], jnp.int32)
    drafts, matched = ngram_propose(hist, hlen, gamma=3, ngram=2)
    np.testing.assert_array_equal(np.asarray(drafts[0]), [41, 42, 43])
    assert bool(matched[0]) and not bool(matched[1])
    np.testing.assert_array_equal(np.asarray(drafts[1]), [6, 6, 6])


def test_ngram_propose_excludes_self_match():
    # The suffix must not match itself (j == hlen-1).
    hist = jnp.asarray([[3, 4, 3, 4, 0, 0, 0, 0]], jnp.int32)
    hlen = jnp.asarray([4], jnp.int32)
    drafts, matched = ngram_propose(hist, hlen, gamma=2, ngram=2)
    # Match at j=1 (positions 0-1), continuation = hist[2:4] = (3, 4).
    assert bool(matched[0])
    np.testing.assert_array_equal(np.asarray(drafts[0]), [3, 4])


@pytest.mark.parametrize("gamma,ngram", [(1, 1), (3, 2), (4, 3)])
def test_prompt_lookup_exact_vs_greedy(target, gamma, ngram):
    cfg, params = target
    ids = jax.random.randint(jax.random.key(7), (2, 14), 0, 64)
    want = greedy_generate(params, cfg, ids, 14, interpret=True)
    got = prompt_lookup_generate(
        params, cfg, ids, 14, gamma=gamma, ngram=ngram, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_prompt_lookup_repetitive_prompt_still_exact(target):
    """A highly repetitive prompt maximizes lookup hits (and wrong-draft
    rejections); output must stay greedy-exact."""
    cfg, params = target
    base = jax.random.randint(jax.random.key(9), (1, 6), 0, 32)
    ids = jnp.tile(base, (2, 4))  # [2, 24] period-6 repetition
    want = greedy_generate(params, cfg, ids, 12, interpret=True)
    got, stats = prompt_lookup_generate(
        params, cfg, ids, 12, gamma=4, ngram=2, interpret=True,
        return_stats=True,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert stats["rounds"] >= 1


def test_prompt_lookup_sampled_deterministic_low_temp(target):
    from flash_attention_cute.runtime.sampling import SamplingParams

    cfg, params = target
    ids = jax.random.randint(jax.random.key(11), (2, 10), 0, 64)
    sp = SamplingParams(temperature=0.9)
    a = prompt_lookup_generate(params, cfg, ids, 10, gamma=3,
                               interpret=True, sampling=sp, seed=3)
    b = prompt_lookup_generate(params, cfg, ids, 10, gamma=3,
                               interpret=True, sampling=sp, seed=3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    want = greedy_generate(params, cfg, ids, 10, interpret=True)
    low = prompt_lookup_generate(
        params, cfg, ids, 10, gamma=3, interpret=True,
        sampling=SamplingParams(temperature=1e-4), seed=1,
    )
    np.testing.assert_array_equal(np.asarray(low), np.asarray(want))


def test_prompt_lookup_eos(target):
    cfg, params = target
    ids = jax.random.randint(jax.random.key(13), (1, 8), 0, 64)
    free = np.asarray(greedy_generate(params, cfg, ids, 10,
                                      interpret=True))
    eos = int(free[0, 3])
    out = np.asarray(prompt_lookup_generate(
        params, cfg, ids, 10, gamma=3, eos_token_id=eos, interpret=True
    ))
    row = out[0].tolist()
    i = row.index(eos)
    assert row[: i + 1] == free[0, : i + 1].tolist()
    assert all(t == eos for t in row[i:])
