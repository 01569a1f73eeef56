"""Speculative decoding: exact greedy equivalence and acceptance behavior.

The core contract: `speculative_generate` must reproduce the target's
greedy chain token-for-token for ANY draft model — the draft only
changes how many rounds it takes. A same-model draft must accept at the
maximum rate; an unrelated random draft must still be exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.models.transformer import init_params
from flash_attention_cute.runtime.generate import greedy_generate
from flash_attention_cute.runtime.speculative import speculative_generate


@pytest.fixture(scope="module")
def target():
    cfg = tiny_test_config(num_layers=2, dtype=jnp.float32)
    params = init_params(cfg, jax.random.key(0))
    return cfg, params


@pytest.fixture(scope="module")
def draft():
    # Smaller and *independently* initialized: near-zero agreement with
    # the target, so acceptance exercises the n=0 bonus-only path.
    cfg = tiny_test_config(num_layers=1, dtype=jnp.float32)
    params = init_params(cfg, jax.random.key(99))
    return cfg, params


def prompt(b=2, s=12, seed=7):
    return jax.random.randint(jax.random.key(seed), (b, s), 0, 250)


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_exact_vs_greedy_random_draft(target, draft, gamma):
    cfg, params = target
    dcfg, dparams = draft
    ids = prompt()
    want = greedy_generate(params, cfg, ids, 16, interpret=True)
    got = speculative_generate(
        params, cfg, dparams, dcfg, ids, 16, gamma=gamma, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_self_draft_accepts_everything(target):
    cfg, params = target
    ids = prompt(seed=8)
    want = greedy_generate(params, cfg, ids, 16, interpret=True)
    got, stats = speculative_generate(
        params, cfg, params, cfg, ids, 16, gamma=3, interpret=True,
        return_stats=True,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # 15 post-first tokens at up to 4/round -> 4 rounds when everything
    # is accepted (a same-model draft agrees except for kernel-path
    # rounding ties, which fixed seeds make stable).
    assert stats["rounds"] <= 6, stats
    assert stats["accepted_drafts"] >= 8, stats


def test_eos_stops_and_pads(target, draft):
    cfg, params = target
    dcfg, dparams = draft
    ids = prompt(b=1, seed=9)
    ref = np.asarray(greedy_generate(params, cfg, ids, 16, interpret=True))
    # Choose a token the greedy chain actually emits mid-sequence as EOS,
    # so both paths must stop there and pad.
    eos = int(ref[0, 5])
    want = np.asarray(
        greedy_generate(params, cfg, ids, 16, eos_token_id=eos,
                        interpret=True)
    )
    got = np.asarray(
        speculative_generate(params, cfg, dparams, dcfg, ids, 16,
                             gamma=3, eos_token_id=eos, interpret=True)
    )
    np.testing.assert_array_equal(got, want)
    # And it genuinely padded: everything after the first EOS is EOS.
    pos = np.argmax(got[0] == eos)
    assert (got[0, pos:] == eos).all()


def test_max_new_tokens_one(target, draft):
    cfg, params = target
    dcfg, dparams = draft
    ids = prompt(b=1, seed=10)
    want = greedy_generate(params, cfg, ids, 1, interpret=True)
    got = speculative_generate(
        params, cfg, dparams, dcfg, ids, 1, gamma=2, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sliding_window_model_exact(target):
    """Speculative verify runs the windowed chunked kernel when the model
    config says so — outputs must still match greedy exactly."""
    cfg = tiny_test_config(
        num_layers=2, dtype=jnp.float32,
        sliding_window=8, use_sliding_window=True, max_window_layers=1,
    )
    params = init_params(cfg, jax.random.key(21))
    dcfg = tiny_test_config(num_layers=1, dtype=jnp.float32)
    dparams = init_params(dcfg, jax.random.key(22))
    ids = prompt(b=2, s=20, seed=23)
    want = greedy_generate(params, cfg, ids, 12, interpret=True)
    got = speculative_generate(
        params, cfg, dparams, dcfg, ids, 12, gamma=3, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_staggered_eos_freezes_rows(target, draft):
    """Rows hitting EOS in different rounds: finished rows freeze (cache
    lengths stop advancing) while the rest continue, and outputs still
    match greedy row-for-row."""
    cfg, params = target
    dcfg, dparams = draft
    ids = prompt(b=3, s=12, seed=24)
    ref = np.asarray(greedy_generate(params, cfg, ids, 20, interpret=True))
    # Pick an EOS that appears at different positions in different rows
    # (fall back to row 0's mid token — rows without it just run long).
    eos = int(ref[0, 7])
    want = np.asarray(
        greedy_generate(params, cfg, ids, 20, eos_token_id=eos,
                        interpret=True)
    )
    got = np.asarray(
        speculative_generate(params, cfg, dparams, dcfg, ids, 20,
                             gamma=4, eos_token_id=eos, interpret=True)
    )
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Rejection-sampling speculative decoding (temperature > 0)
# ---------------------------------------------------------------------------


def test_accept_and_emit_marginal_is_target_distribution():
    """The core speculative-sampling theorem, tested directly: for ANY
    proposal q, the emitted token at the round's first position has
    marginal distribution EXACTLY p_0 (the target's). Monte Carlo over
    the factored acceptance/residual helper."""
    from flash_attention_cute.runtime.speculative import (
        _accept_and_emit,
    )

    V, gamma, N = 8, 2, 60000
    kp, kq, kd, ku, kr = jax.random.split(jax.random.key(3), 5)
    p = jax.nn.softmax(jax.random.normal(kp, (gamma + 1, V)) * 1.5, axis=-1)
    q = jax.nn.softmax(jax.random.normal(kq, (gamma, V)) * 1.5, axis=-1)
    tprobs = jnp.broadcast_to(p, (N, gamma + 1, V))
    qprobs = jnp.broadcast_to(q, (N, gamma, V))
    drafts = jax.vmap(
        lambda k_: jax.random.categorical(k_, jnp.log(q), axis=-1)
    )(jax.random.split(kd, N)).astype(jnp.int32)  # [N, gamma] ~ q
    u = jax.random.uniform(ku, (N, gamma))
    n, e = _accept_and_emit(
        tprobs, qprobs, drafts, u, jax.random.split(kr, N)
    )
    hist = np.bincount(np.asarray(e[:, 0]), minlength=V) / N
    # Monte-Carlo tolerance: ~5 sigma at N=60k is well under 0.012.
    np.testing.assert_allclose(hist, np.asarray(p[0]), atol=0.012)
    # Both acceptance and rejection paths must actually occur.
    n = np.asarray(n)
    assert (n == 0).any() and (n > 0).any()


def test_sampled_speculative_deterministic_and_runs(target, draft):
    from flash_attention_cute.runtime.sampling import SamplingParams

    cfg, params = target
    dcfg, dparams = draft
    ids = prompt(seed=11)
    sp = SamplingParams(temperature=0.9, top_k=40)
    a = speculative_generate(
        params, cfg, dparams, dcfg, ids, 12, gamma=3, interpret=True,
        sampling=sp, seed=5,
    )
    b = speculative_generate(
        params, cfg, dparams, dcfg, ids, 12, gamma=3, interpret=True,
        sampling=sp, seed=5,
    )
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    c = speculative_generate(
        params, cfg, dparams, dcfg, ids, 12, gamma=3, interpret=True,
        sampling=sp, seed=6,
    )
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def test_sampled_speculative_low_temperature_matches_greedy(target, draft):
    """As temperature -> 0 the filtered distribution collapses to the
    argmax, so rejection-sampling output must equal the greedy chain."""
    from flash_attention_cute.runtime.sampling import SamplingParams

    cfg, params = target
    dcfg, dparams = draft
    ids = prompt(seed=13)
    want = greedy_generate(params, cfg, ids, 12, interpret=True)
    got = speculative_generate(
        params, cfg, dparams, dcfg, ids, 12, gamma=3, interpret=True,
        sampling=SamplingParams(temperature=1e-4), seed=1,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sampled_speculative_eos_freezes(target, draft):
    from flash_attention_cute.runtime.sampling import SamplingParams

    cfg, params = target
    dcfg, dparams = draft
    ids = prompt(b=2, seed=17)
    sp = SamplingParams(temperature=0.8)
    free = speculative_generate(
        params, cfg, dparams, dcfg, ids, 12, gamma=3, interpret=True,
        sampling=sp, seed=2,
    )
    eos = int(np.asarray(free)[0, 4])
    out = np.asarray(speculative_generate(
        params, cfg, dparams, dcfg, ids, 12, gamma=3, interpret=True,
        sampling=sp, seed=2, eos_token_id=eos,
    ))
    row = out[0].tolist()
    assert eos in row
    i = row.index(eos)
    # Everything after the first EOS is padding (the pad value is EOS).
    assert all(t == eos for t in row[i:])
    # The stream up to EOS is unchanged from the free-running run.
    np.testing.assert_array_equal(row[: i + 1], np.asarray(free)[0, : i + 1])
