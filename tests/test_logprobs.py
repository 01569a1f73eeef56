"""Per-token logprobs through the serving engines (return_logprobs=True).

Definition under test: greedy -> log-softmax of the SHAPED logits (after
penalties/bias/DFA/min-tokens) at the emitted token; sampled ->
log-softmax of the actual filtered sampling distribution. Speculative
engines report the TARGET model's logprobs at every emitted position
(the vLLM convention), gathered from the verify logits along the
accepted prefix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models import forward, init_params
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.runtime.engine import ServingEngine


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    return cfg, params


def greedy_oracle_with_logprobs(params, cfg, prompt, n_tokens):
    ids = list(prompt)
    toks, lps = [], []
    for _ in range(n_tokens):
        logits, _ = forward(
            params, cfg, jnp.asarray([ids], jnp.int32), mode="prefill"
        )
        row = logits[0, -1]
        nxt = int(jnp.argmax(row))
        toks.append(nxt)
        lps.append(float(jax.nn.log_softmax(row)[nxt]))
        ids.append(nxt)
    return toks, lps


def test_engine_greedy_logprobs_match_oracle(model):
    cfg, params = model
    rng = np.random.default_rng(20)
    prompts = {0: rng.integers(0, cfg.vocab_size, 7).tolist(),
               1: rng.integers(0, cfg.vocab_size, 5).tolist()}
    eng = ServingEngine(
        params, cfg, slots=2, num_pages=33, page_size=8, pages_per_seq=8,
        interpret=True, return_logprobs=True,
    )
    for rid, p in prompts.items():
        eng.submit(rid, p, 6)
    results = eng.run()
    assert not eng.failed
    for rid, p in prompts.items():
        want_t, want_lp = greedy_oracle_with_logprobs(params, cfg, p, 6)
        assert results[rid] == want_t
        got_lp = eng.logprobs[rid]
        assert len(got_lp) == len(results[rid])
        np.testing.assert_allclose(got_lp, want_lp, atol=2e-3)


def test_engine_sampled_logprobs_are_sampling_distribution(model):
    """Sampled logprobs are from the filtered distribution: finite,
    <= 0, deterministic across identical runs, and at most the max
    filtered probability."""
    from flash_attention_cute.runtime.sampling import SamplingParams

    cfg, params = model
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, cfg.vocab_size, 6).tolist()

    def run():
        eng = ServingEngine(
            params, cfg, slots=1, num_pages=33, page_size=8,
            pages_per_seq=8, interpret=True, return_logprobs=True,
            sampling=SamplingParams(temperature=0.9, top_k=32), seed=5,
        )
        eng.submit(0, prompt, 7)
        out = eng.run()
        assert not eng.failed
        return out[0], eng.logprobs[0]

    t1, lp1 = run()
    t2, lp2 = run()
    assert t1 == t2 and lp1 == lp2
    assert len(lp1) == len(t1)
    assert all(np.isfinite(lp1)) and all(x <= 0.0 for x in lp1)


def test_spec_engine_logprobs_match_plain(model):
    """Greedy speculative logprobs (target verify logits at the accepted
    tokens) must match the plain engine's decode-path logprobs (same
    math, different kernels -> small numeric tolerance)."""
    from flash_attention_cute.runtime.spec_engine import (
        SpeculativeServingEngine,
    )

    cfg, params = model
    dcfg = tiny_test_config(num_layers=1)
    dparams = init_params(dcfg, jax.random.key(9))
    rng = np.random.default_rng(22)
    prompts = {0: rng.integers(0, cfg.vocab_size, 7).tolist(),
               1: rng.integers(0, cfg.vocab_size, 5).tolist()}

    plain = ServingEngine(
        params, cfg, slots=2, num_pages=65, page_size=8, pages_per_seq=8,
        interpret=True, return_logprobs=True,
    )
    spec = SpeculativeServingEngine(
        params, cfg, draft_params=dparams, draft_cfg=dcfg, gamma=3,
        slots=2, num_pages=65, page_size=8, pages_per_seq=8,
        interpret=True, return_logprobs=True,
    )
    for rid, p in prompts.items():
        plain.submit(rid, p, 8)
        spec.submit(rid, p, 8)
    want = plain.run()
    got = spec.run()
    assert got == want
    for rid in prompts:
        assert len(spec.logprobs[rid]) == len(got[rid])
        np.testing.assert_allclose(
            spec.logprobs[rid], plain.logprobs[rid], atol=2e-3
        )


def test_lookup_engine_logprobs_match_plain(model):
    from flash_attention_cute.runtime.spec_engine import (
        SpeculativeServingEngine,
    )

    cfg, params = model
    rng = np.random.default_rng(23)
    base = rng.integers(0, cfg.vocab_size, 4).tolist()
    prompts = {0: base + base + base,
               1: rng.integers(0, cfg.vocab_size, 6).tolist()}

    plain = ServingEngine(
        params, cfg, slots=2, num_pages=65, page_size=8, pages_per_seq=8,
        interpret=True, return_logprobs=True,
    )
    spec = SpeculativeServingEngine(
        params, cfg, ngram=2, gamma=3,
        slots=2, num_pages=65, page_size=8, pages_per_seq=8,
        interpret=True, return_logprobs=True,
    )
    for rid, p in prompts.items():
        plain.submit(rid, p, 8)
        spec.submit(rid, p, 8)
    want = plain.run()
    got = spec.run()
    assert got == want
    for rid in prompts:
        np.testing.assert_allclose(
            spec.logprobs[rid], plain.logprobs[rid], atol=2e-3
        )


def test_logprobs_truncate_with_eos_and_stops(model):
    cfg, params = model
    rng = np.random.default_rng(24)
    prompt = rng.integers(0, cfg.vocab_size, 6).tolist()
    # Find the greedy stream, then stop on its 4th token.
    ref, _ = greedy_oracle_with_logprobs(params, cfg, prompt, 8)
    eng = ServingEngine(
        params, cfg, slots=1, num_pages=33, page_size=8, pages_per_seq=8,
        interpret=True, return_logprobs=True,
    )
    eng.submit(0, prompt, 8, stop_sequences=[[ref[3]]])
    out = eng.run()
    assert out[0] == ref[:4]
    assert len(eng.logprobs[0]) == 4
