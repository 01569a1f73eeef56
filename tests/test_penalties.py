"""Sampling penalties (repetition / presence / frequency) through the
serving engines.

The reference is greedy-only (reference: scripts/benchmark_llm.py:86);
penalties are part of the standard serving-API surface (HF
RepetitionPenaltyLogitsProcessor semantics for repetition, OpenAI API
semantics for presence/frequency). The engines derive the count planes
from host request streams per device call (the `_dfa_arrays` pattern) and
advance them in-scan, so the invariants on trial here are: chunk-boundary
invariance, preemption-recompute replay, and speculative exactness (the
verify walks the draft prefix's counts like the DFA walk).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models import forward, init_params
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.runtime.engine import ServingEngine
from flash_attention_cute.runtime.sampling import apply_penalties


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    return cfg, params


@pytest.fixture(scope="module")
def draft(model):
    cfg, _ = model
    dcfg = tiny_test_config(num_layers=1)
    assert dcfg.vocab_size == cfg.vocab_size
    return dcfg, init_params(dcfg, jax.random.key(9))


def _pen_kwargs(rep=1.0, pres=0.0, freq=0.0):
    return dict(repetition_penalty=rep, presence_penalty=pres,
                frequency_penalty=freq)


def penalized_greedy_oracle(params, cfg, prompt, n_tokens,
                            rep=1.0, pres=0.0, freq=0.0):
    """Uncached greedy generation with penalties applied to each step's
    raw logits (same `apply_penalties` math the engines run on device)."""
    ids = list(prompt)
    out = []
    v = cfg.vocab_size
    for _ in range(n_tokens):
        logits, _ = forward(
            params, cfg, jnp.asarray([ids], jnp.int32), mode="prefill"
        )
        pc = np.zeros((v,), np.float32)
        np.add.at(pc, np.asarray(prompt, np.int64), 1.0)
        oc = np.zeros((v,), np.float32)
        if out:
            np.add.at(oc, np.asarray(out, np.int64), 1.0)
        lg = apply_penalties(
            logits[0, -1][None], jnp.asarray(pc)[None], jnp.asarray(oc)[None],
            jnp.asarray([rep], jnp.float32), jnp.asarray([pres], jnp.float32),
            jnp.asarray([freq], jnp.float32),
        )
        nxt = int(jnp.argmax(lg[0]))
        out.append(nxt)
        ids.append(nxt)
    return out


def test_repetition_matches_hf_processor():
    """apply_penalties with pres=freq=0 must reproduce HF's
    RepetitionPenaltyLogitsProcessor over the same seen-token set."""
    from transformers import RepetitionPenaltyLogitsProcessor
    import torch

    rng = np.random.default_rng(3)
    v = 64
    logits = rng.standard_normal((2, v)).astype(np.float32) * 2.0
    seen = [[1, 5, 5, 9, 30], [0, 2, 63]]
    penalty = 1.7
    proc = RepetitionPenaltyLogitsProcessor(penalty=penalty)
    # HF reads the seen set from input_ids (prompt + generated).
    pad = max(len(s) for s in seen)
    ids = torch.tensor([s + s[:1] * (pad - len(s)) for s in seen])
    want = proc(ids, torch.from_numpy(logits.copy())).numpy()

    pc = np.zeros((2, v), np.float32)
    for i, s in enumerate(seen):
        np.add.at(pc[i], np.asarray(s, np.int64), 1.0)
    got = np.asarray(apply_penalties(
        jnp.asarray(logits), jnp.asarray(pc), jnp.zeros((2, v), jnp.float32),
        jnp.full((2,), penalty, jnp.float32), jnp.zeros((2,), jnp.float32),
        jnp.zeros((2,), jnp.float32),
    ))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_presence_frequency_oracle():
    """OpenAI semantics: logit -= pres*1[count>0] + freq*count over OUTPUT
    tokens only; prompt-only tokens unaffected when rep is neutral."""
    rng = np.random.default_rng(4)
    v = 32
    logits = rng.standard_normal((v,)).astype(np.float32)
    prompt_tok, out_toks = 3, [7, 7, 7, 11]
    pc = np.zeros((v,), np.float32)
    pc[prompt_tok] = 1.0
    oc = np.zeros((v,), np.float32)
    np.add.at(oc, np.asarray(out_toks, np.int64), 1.0)
    pres, freq = 0.5, 0.25
    got = np.asarray(apply_penalties(
        jnp.asarray(logits)[None], jnp.asarray(pc)[None],
        jnp.asarray(oc)[None], jnp.ones((1,), jnp.float32),
        jnp.full((1,), pres, jnp.float32), jnp.full((1,), freq, jnp.float32),
    ))[0]
    want = logits.copy()
    want[7] -= pres + freq * 3
    want[11] -= pres + freq * 1
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[prompt_tok] == logits[prompt_tok]  # rep neutral


def test_engine_penalties_match_penalized_oracle(model):
    """Greedy engine serving with per-request penalties (mixed with a
    penalty-free request) matches the penalized dense oracle request for
    request — and the penalty-free request is untouched by its
    neighbors' penalties."""
    cfg, params = model
    rng = np.random.default_rng(10)
    prompts = {
        0: rng.integers(0, cfg.vocab_size, 7).tolist(),
        1: rng.integers(0, cfg.vocab_size, 5).tolist(),
        2: rng.integers(0, cfg.vocab_size, 9).tolist(),
    }
    pens = {
        0: _pen_kwargs(rep=1.6),
        1: _pen_kwargs(),  # neutral row riding a penalized batch
        2: _pen_kwargs(rep=1.2, pres=0.6, freq=0.3),
    }
    n_new = {0: 6, 1: 5, 2: 6}
    eng = ServingEngine(
        params, cfg, slots=2, num_pages=33, page_size=8, pages_per_seq=8,
        interpret=True,
    )
    for rid, p in prompts.items():
        eng.submit(rid, p, n_new[rid], **pens[rid])
    results = eng.run()
    assert not eng.failed
    for rid, p in prompts.items():
        want = penalized_greedy_oracle(
            params, cfg, p, n_new[rid],
            rep=pens[rid]["repetition_penalty"],
            pres=pens[rid]["presence_penalty"],
            freq=pens[rid]["frequency_penalty"],
        )
        assert results[rid] == want, (rid, results[rid], want)


def test_engine_penalties_chunk_invariance(model):
    """decode_chunk=1 rebuilds counts from host streams every token;
    decode_chunk=8 advances them in-scan. Outputs must be identical."""
    cfg, params = model
    rng = np.random.default_rng(11)
    prompts = {0: rng.integers(0, cfg.vocab_size, 6).tolist(),
               1: rng.integers(0, cfg.vocab_size, 8).tolist()}

    def run(chunk):
        eng = ServingEngine(
            params, cfg, slots=2, num_pages=33, page_size=8,
            pages_per_seq=8, interpret=True, decode_chunk=chunk,
        )
        for rid, p in prompts.items():
            eng.submit(rid, p, 9, **_pen_kwargs(rep=1.4, freq=0.2))
        out = eng.run()
        assert not eng.failed
        return out

    assert run(1) == run(8)


def test_engine_penalties_preemption_replay(model):
    """Preemption-recompute rebuilds the count planes from the replayed
    prompt; outputs must match the roomy-pool run exactly."""
    cfg, params = model
    rng = np.random.default_rng(12)
    prompts = {0: rng.integers(0, cfg.vocab_size, 9).tolist(),
               1: rng.integers(0, cfg.vocab_size, 9).tolist()}

    def run(num_pages):
        eng = ServingEngine(
            params, cfg, slots=2, num_pages=num_pages, page_size=8,
            pages_per_seq=8, interpret=True,
        )
        for rid, p in prompts.items():
            eng.submit(rid, p, 8, **_pen_kwargs(rep=1.5, pres=0.4))
        out = eng.run()
        assert sorted(out) == [0, 1], (out, eng.failed)
        return out, eng

    tight, et = run(6)
    roomy, er = run(33)
    assert et.stats["preemptions"] > 0
    assert er.stats["preemptions"] == 0
    assert tight == roomy


def test_spec_engine_penalties_match_plain(model, draft):
    """Greedy speculative serving under penalties is bit-exact vs the
    penalized plain engine for ANY draft: the verify penalizes position i
    with the entry counts advanced by draft tokens d_1..d_i."""
    from flash_attention_cute.runtime.spec_engine import (
        SpeculativeServingEngine,
    )

    cfg, params = model
    dcfg, dparams = draft
    rng = np.random.default_rng(13)
    prompts = {0: rng.integers(0, cfg.vocab_size, 7).tolist(),
               1: rng.integers(0, cfg.vocab_size, 5).tolist()}
    pens = {0: _pen_kwargs(rep=1.5, freq=0.3), 1: _pen_kwargs(pres=0.8)}

    plain = ServingEngine(
        params, cfg, slots=2, num_pages=65, page_size=8, pages_per_seq=8,
        interpret=True,
    )
    spec = SpeculativeServingEngine(
        params, cfg, draft_params=dparams, draft_cfg=dcfg, gamma=3,
        slots=2, num_pages=65, page_size=8, pages_per_seq=8,
        interpret=True,
    )
    for rid, p in prompts.items():
        plain.submit(rid, p, 8, **pens[rid])
        spec.submit(rid, p, 8, **pens[rid])
    want = plain.run()
    got = spec.run()
    assert not spec.failed
    assert got == want, (got, want)


def test_lookup_engine_penalties_match_plain(model):
    """Prompt-lookup (ngram) speculative serving under penalties matches
    the penalized plain engine too (one-hot proposals; penalized verify)."""
    from flash_attention_cute.runtime.spec_engine import (
        SpeculativeServingEngine,
    )

    cfg, params = model
    rng = np.random.default_rng(14)
    base = rng.integers(0, cfg.vocab_size, 4).tolist()
    # Repetitive prompts so n-gram lookup actually proposes.
    prompts = {0: base + base + base, 1: rng.integers(0, cfg.vocab_size, 6).tolist()}
    pens = {0: _pen_kwargs(rep=1.3, pres=0.5), 1: _pen_kwargs(freq=0.4)}

    plain = ServingEngine(
        params, cfg, slots=2, num_pages=65, page_size=8, pages_per_seq=8,
        interpret=True,
    )
    spec = SpeculativeServingEngine(
        params, cfg, ngram=2, gamma=3,
        slots=2, num_pages=65, page_size=8, pages_per_seq=8,
        interpret=True,
    )
    for rid, p in prompts.items():
        plain.submit(rid, p, 8, **pens[rid])
        spec.submit(rid, p, 8, **pens[rid])
    want = plain.run()
    got = spec.run()
    assert not spec.failed
    assert got == want, (got, want)


def test_spec_engine_sampled_penalties_deterministic(model, draft):
    """Rejection-sampling speculative serving with penalties: same seed =>
    identical streams (penalized target distributions are deterministic
    functions of the emitted history)."""
    from flash_attention_cute.runtime.sampling import SamplingParams
    from flash_attention_cute.runtime.spec_engine import (
        SpeculativeServingEngine,
    )

    cfg, params = model
    dcfg, dparams = draft
    rng = np.random.default_rng(15)
    prompt = rng.integers(0, cfg.vocab_size, 6).tolist()
    sp = SamplingParams(temperature=0.9, top_k=50)

    def run():
        eng = SpeculativeServingEngine(
            params, cfg, draft_params=dparams, draft_cfg=dcfg, gamma=3,
            slots=1, num_pages=65, page_size=8, pages_per_seq=8,
            interpret=True, sampling=sp, seed=3,
        )
        eng.submit(0, prompt, 8, **_pen_kwargs(rep=1.4, pres=0.3, freq=0.2))
        out = eng.run()
        assert not eng.failed
        return out

    assert run() == run()
