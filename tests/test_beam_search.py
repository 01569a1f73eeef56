"""Beam search: the compiled cached-decode implementation must match a
straightforward per-step reference (full forwards, numpy selection with
the same expansion/retire rules), degenerate to greedy at K=1, and
respect the length penalty.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.models.transformer import forward, init_params
from flash_attention_cute.runtime.beam_search import beam_generate
from flash_attention_cute.runtime.generate import greedy_generate


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(num_layers=2, vocab_size=64, dtype=jnp.float32)
    params = init_params(cfg, jax.random.key(0))
    return cfg, params


def _logprobs(params, cfg, ids):
    logits, _ = forward(
        params, cfg, jnp.asarray([ids], jnp.int32), mode="prefill",
        interpret=True,
    )
    return np.asarray(
        jax.nn.log_softmax(logits[0, -1].astype(jnp.float32))
    )


def reference_beam(params, cfg, prompt, t, k, eos, lp_pow=1.0):
    """Slow reference: expand every live beam with full prefill forwards,
    same rules as the compiled loop (top-2K, EOS retires, best-K live)."""
    lp0 = _logprobs(params, cfg, list(prompt))
    order = np.argsort(-lp0)[:k]
    live = [(list(prompt) + [int(tok)], float(lp0[tok])) for tok in order]
    fin = []

    def retire(seq, score, new_len):
        fin.append((seq, score / new_len ** lp_pow))

    for seq, score in list(live):
        if seq[-1] == eos:
            retire(seq, score, 1)
            live.remove((seq, score))
    for step in range(1, t):
        cands = []
        for seq, score in live:
            lp = _logprobs(params, cfg, seq)
            for tok in np.argsort(-lp)[: 2 * k]:
                cands.append((seq + [int(tok)], score + float(lp[tok])))
        cands.sort(key=lambda x: -x[1])
        cands = cands[: 2 * k]
        live = []
        for seq, score in cands:
            if seq[-1] == eos:
                retire(seq, score, step + 1)
            elif len(live) < k:
                live.append((seq, score))
        if fin and live:
            worst_fin = sorted(fin, key=lambda x: -x[1])[: k][-1][1] \
                if len(fin) >= k else -1e30
            best_live = max(s for _, s in live) / (step + 1) ** lp_pow
            if len(fin) >= k and best_live <= worst_fin:
                break
        if not live:
            break
    for seq, score in live:
        fin.append((seq, score / t ** lp_pow))
    best = max(fin, key=lambda x: x[1])
    new = best[0][len(prompt):]
    return new + [eos] * (t - len(new)), best[1]


def test_beam_k1_equals_greedy(model):
    cfg, params = model
    ids = jax.random.randint(jax.random.key(3), (2, 8), 0, cfg.vocab_size)
    want = greedy_generate(params, cfg, ids, 8, interpret=True)
    got = beam_generate(params, cfg, ids, 8, num_beams=1, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("lp_pow", [1.0, 0.6])
def test_beam_matches_reference(model, lp_pow):
    cfg, params = model
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, 7).tolist()
    # Choose EOS as a token the greedy stream actually reaches so
    # retirement paths execute.
    free = np.asarray(greedy_generate(
        params, cfg, jnp.asarray([prompt], jnp.int32), 8, interpret=True
    ))[0]
    eos = int(free[4])
    got, score = beam_generate(
        params, cfg, jnp.asarray([prompt], jnp.int32), 8, num_beams=3,
        eos_token_id=eos, length_penalty=lp_pow, interpret=True,
        return_scores=True,
    )
    want, want_score = reference_beam(
        params, cfg, prompt, 8, 3, eos, lp_pow
    )
    assert np.asarray(got)[0].tolist() == want, (got, want)
    np.testing.assert_allclose(float(score[0]), want_score, rtol=1e-4)


def test_beam_score_at_least_greedy(model):
    """The returned hypothesis's sum-logprob must be >= the greedy
    chain's (beam explores a superset)."""
    cfg, params = model
    ids = jax.random.randint(jax.random.key(9), (1, 6), 0, cfg.vocab_size)
    greedy = np.asarray(greedy_generate(params, cfg, ids, 6,
                                        interpret=True))[0]
    # Greedy chain's total logprob via teacher forcing.
    seq = np.concatenate([np.asarray(ids)[0], greedy])
    logits, _ = forward(params, cfg, jnp.asarray([seq], jnp.int32),
                        mode="prefill", interpret=True)
    lp = jax.nn.log_softmax(logits[0].astype(jnp.float32), axis=-1)
    s0 = ids.shape[1]
    g_score = float(sum(
        lp[s0 - 1 + i, int(greedy[i])] for i in range(6)
    ))
    _, score = beam_generate(params, cfg, ids, 6, num_beams=4,
                             interpret=True, return_scores=True)
    assert float(score[0]) >= g_score - 1e-4
