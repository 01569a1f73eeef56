"""Guided decoding: per-request logit bias, min-token EOS suppression,
and stop sequences — across the plain, speculative, and prompt-lookup
engines (the reference has no serving layer at all; HF exposes these as
LogitsProcessors + StoppingCriteria in `generate`).
"""

import jax
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


def _prompt(cfg, n=9, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n
    ).tolist()


def _run_one(model, prompt, n_new, engine="plain", **submit_kw):
    cfg, params = model
    if engine == "plain":
        eng = ServingEngine(params, cfg, interpret=True, **POOL,
                            eos_token_id=submit_kw.pop("_eos", None))
    elif engine == "spec":
        dcfg = tiny_test_config(num_layers=1, hidden_size=32,
                                intermediate_size=64)
        eng = SpeculativeServingEngine(
            params, cfg, draft_params=init_params(dcfg, jax.random.key(7)),
            draft_cfg=dcfg, gamma=3, interpret=True, **POOL,
            eos_token_id=submit_kw.pop("_eos", None),
        )
    else:  # lookup
        eng = SpeculativeServingEngine(
            params, cfg, ngram=2, gamma=3, interpret=True, **POOL,
            eos_token_id=submit_kw.pop("_eos", None),
        )
    eng.submit(0, prompt, n_new, **submit_kw)
    return eng.run()[0], eng


@pytest.mark.parametrize("engine", ["plain", "spec", "lookup"])
def test_logit_bias_bans_tokens_consistently(model, engine):
    """Banning every token the unguided run emitted forces a different
    stream; the banned ids never appear; all engines agree exactly with
    the plain engine under the SAME bias."""
    cfg, _ = model
    prompt = _prompt(cfg)
    free, _ = _run_one(model, prompt, 8)
    ban = {int(t): float("-inf") for t in set(free[:4])}
    want, _ = _run_one(model, prompt, 8, logit_bias=ban)
    assert not set(want) & set(ban), (want, ban)
    got, _ = _run_one(model, prompt, 8, engine=engine, logit_bias=ban)
    assert got == want


def test_logit_bias_can_force_a_token(model):
    cfg, _ = model
    prompt = _prompt(cfg, seed=3)
    got, _ = _run_one(model, prompt, 5, logit_bias={17: float("inf")})
    assert got == [17] * 5


def test_min_new_tokens_defers_eos(model):
    """Pick the unguided stream's own 2nd token as EOS: without min the
    request stops at 2 tokens; with min_new_tokens=6 the EOS is banned
    until position 5 and the stream keeps the non-EOS prefix."""
    cfg, _ = model
    prompt = _prompt(cfg, seed=5)
    free, _ = _run_one(model, prompt, 10)
    eos = free[1]
    short, _ = _run_one(model, prompt, 10, _eos=eos)
    assert short[-1] == eos and len(short) == 2
    long_, eng = _run_one(model, prompt, 10, _eos=eos, min_new_tokens=6)
    assert len(long_) >= 6
    assert eos not in long_[:5]


@pytest.mark.parametrize("engine", ["plain", "spec"])
def test_stop_sequences_truncate(model, engine):
    """A stop sequence taken from the unguided stream finishes the
    request exactly at its end."""
    cfg, _ = model
    prompt = _prompt(cfg, seed=7)
    free, _ = _run_one(model, prompt, 10)
    stop = free[2:4]
    got, eng = _run_one(model, prompt, 10, engine=engine,
                        stop_sequences=[stop])
    assert got == free[:4], (got, free)
    assert not eng.failed


def test_guided_sampled_engine_runs(model):
    from flash_attention_cute.runtime.sampling import SamplingParams

    cfg, params = model
    prompt = _prompt(cfg, seed=9)
    eng = ServingEngine(params, cfg, interpret=True,
                        sampling=SamplingParams(temperature=0.8), **POOL)
    eng.submit(0, prompt, 6, logit_bias={5: float("-inf")})
    out = eng.run()[0]
    assert len(out) == 6 and 5 not in out


def _parity_dfa(vocab):
    """Two-state automaton: even states emit even token ids, odd states
    odd ids; every emission flips the state."""
    ids = np.arange(vocab)
    bias = np.full((2, vocab), -np.inf, np.float32)
    bias[0, ids % 2 == 0] = 0.0
    bias[1, ids % 2 == 1] = 0.0
    trans = np.zeros((2, vocab), np.int32)
    trans[0] = 1
    trans[1] = 0
    return {"bias": bias, "transitions": trans, "start": 0}


def test_dfa_constrained_decoding_matches_slow_reference(model):
    """DFA-constrained decode: the emitted stream follows the automaton
    and equals a dense-forward greedy walk applying the same per-state
    masks; chunk boundaries recompute the state correctly."""
    import jax.numpy as jnp

    from flash_attention_cute.models import forward

    cfg, params = model
    dfa = _parity_dfa(cfg.vocab_size)
    prompt = _prompt(cfg, seed=21)

    def run(chunk):
        eng = ServingEngine(params, cfg, interpret=True,
                            dfa=dfa, decode_chunk=chunk, **POOL)
        eng.submit(0, prompt, 8, constrain=True)
        return eng.run()[0]

    got = run(8)
    assert got == run(2)  # state recomputation across chunk boundaries

    # Slow reference: dense prefill each step, start-state masked.
    ids = list(prompt)
    state = 0
    want = []
    for _ in range(8):
        lg, _ = forward(params, cfg, jnp.asarray([ids], jnp.int32),
                        mode="prefill", interpret=True)
        masked = np.asarray(lg[0, -1]) + dfa["bias"][state]
        tok = int(np.argmax(masked))
        want.append(tok)
        state = int(dfa["transitions"][state, tok])
        ids.append(tok)
    assert got == want, (got, want)
    assert all(t % 2 == i % 2 for i, t in enumerate(got))


def test_dfa_unconstrained_rows_unaffected(model):
    cfg, params = model
    dfa = _parity_dfa(cfg.vocab_size)
    prompt = _prompt(cfg, seed=23)
    plain, _ = _run_one(model, prompt, 6)
    eng = ServingEngine(params, cfg, interpret=True, dfa=dfa, **POOL)
    eng.submit(0, prompt, 6)  # constrain NOT set
    assert eng.run()[0] == plain


@pytest.mark.parametrize("engine", ["spec", "lookup"])
def test_dfa_speculative_matches_plain(model, engine):
    """DFA x speculative: the in-scan automaton walk over the verify
    chunk makes constrained speculative serving exact vs the plain
    constrained engine, for both draft modes, across multiple rounds."""
    cfg, params = model
    dfa = _parity_dfa(cfg.vocab_size)
    prompt = _prompt(cfg, seed=29)

    plain = ServingEngine(params, cfg, interpret=True, dfa=dfa, **POOL)
    plain.submit(0, prompt, 8, constrain=True)
    plain.submit(1, _prompt(cfg, seed=30), 8)  # unconstrained neighbor
    want = plain.run()

    if engine == "spec":
        dcfg = tiny_test_config(num_layers=1, hidden_size=32,
                                intermediate_size=64)
        eng = SpeculativeServingEngine(
            params, cfg, draft_params=init_params(dcfg, jax.random.key(7)),
            draft_cfg=dcfg, gamma=3, rounds_per_call=2, dfa=dfa,
            interpret=True, **POOL,
        )
    else:
        eng = SpeculativeServingEngine(
            params, cfg, ngram=2, gamma=3, rounds_per_call=2, dfa=dfa,
            interpret=True, **POOL,
        )
    eng.submit(0, prompt, 8, constrain=True)
    eng.submit(1, _prompt(cfg, seed=30), 8)
    got = eng.run()
    assert got == want, (got, want)
    assert all(t % 2 == i % 2 for i, t in enumerate(got[0]))
