"""Engine-level speculative decoding: the SpeculativeServingEngine must
emit exactly what the plain greedy ServingEngine emits, for ANY draft
model, through admission, slot reuse, EOS, budgets, and preemption.

Composes runtime/spec_engine.py (draft/verify rounds over paged caches)
with the serving stack; the reference has neither a serving engine nor
speculative decoding (its decode is a per-token Python loop, reference:
scripts/benchmark_llm.py:65-92).
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
def target():
    cfg = tiny_test_config(num_layers=2)
    return cfg, init_params(cfg, jax.random.key(0))


@pytest.fixture(scope="module")
def draft():
    cfg = tiny_test_config(num_layers=1, hidden_size=32, intermediate_size=64)
    return cfg, init_params(cfg, jax.random.key(7))


def _requests(cfg, seed=0, n=3):
    rng = np.random.default_rng(seed)
    lens = [7, 12, 3, 9, 5][:n]
    return {
        100 + i: rng.integers(0, cfg.vocab_size, ln).tolist()
        for i, ln in enumerate(lens)
    }


def _run_plain(target, prompts, n_new, eos=None, **pool):
    cfg, params = target
    eng = ServingEngine(params, cfg, interpret=True, eos_token_id=eos,
                        **(POOL | pool))
    for rid, p in prompts.items():
        eng.submit(rid, p, n_new[rid])
    return eng.run(), eng


def _run_spec(target, draft, prompts, n_new, eos=None, gamma=3,
              rounds_per_call=1, **pool):
    cfg, params = target
    dcfg, dparams = draft
    eng = SpeculativeServingEngine(
        params, cfg, draft_params=dparams, draft_cfg=dcfg, gamma=gamma,
        rounds_per_call=rounds_per_call, interpret=True, eos_token_id=eos,
        **(POOL | pool),
    )
    for rid, p in prompts.items():
        eng.submit(rid, p, n_new[rid])
    return eng.run(), eng


def test_spec_engine_matches_plain_engine(target, draft):
    cfg, _ = target
    prompts = _requests(cfg)
    n_new = {rid: 6 + i for i, rid in enumerate(prompts)}
    want, _ = _run_plain(target, prompts, n_new)
    got, eng = _run_spec(target, draft, prompts, n_new)
    assert got == want
    assert not eng.failed
    assert eng.stats["spec_calls"] >= 1


def test_spec_engine_draft_invariance(target, draft):
    """The draft only controls SPEED: two different drafts (including the
    target itself) must emit identical tokens through the same verify
    kernel path."""
    cfg, params = target
    prompts = _requests(cfg, seed=3)
    n_new = {rid: 7 for rid in prompts}
    a, ea = _run_spec(target, draft, prompts, n_new)
    b, eb = _run_spec(target, target, prompts, n_new)  # self-draft
    assert a == b
    # Self-draft accepts every proposal (same model, same kernels).
    assert eb.stats["accepted_drafts"] >= ea.stats["accepted_drafts"]


def test_self_draft_accepts_all(target):
    cfg, _ = target
    prompts = _requests(cfg, seed=5, n=2)
    n_new = {rid: 8 for rid in prompts}
    got, eng = _run_spec(target, target, prompts, n_new, gamma=3)
    want, _ = _run_plain(target, prompts, n_new)
    assert got == want
    # Every round advances gamma+1 tokens when the draft IS the target:
    # accepted == gamma * (rounds where the row was alive). With 8 tokens
    # at gamma+1=4/round the engine needs ceil(7/4)=2 rounds per slot
    # (token 0 comes from prefill), so acceptance must dominate.
    assert eng.stats["accepted_drafts"] >= 6, eng.stats


def test_spec_engine_multi_round_call(target, draft):
    """rounds_per_call > 1 folds several draft/verify rounds into one
    device program; outputs and dispatch counts must both hold."""
    cfg, _ = target
    prompts = _requests(cfg, seed=9)
    n_new = {rid: 9 for rid in prompts}
    a, e1 = _run_spec(target, draft, prompts, n_new, rounds_per_call=1)
    b, e3 = _run_spec(target, draft, prompts, n_new, rounds_per_call=3)
    assert a == b
    assert e3.stats["spec_calls"] < e1.stats["spec_calls"]


def test_spec_engine_eos_mid_round(target, draft):
    """EOS emitted inside a round freezes the row exactly at EOS and the
    request finishes; other slots keep decoding."""
    cfg, params = target
    prompts = _requests(cfg, seed=11, n=2)
    n_new = {rid: 10 for rid in prompts}
    # Pick the EOS id from the plain run's token stream so it actually
    # triggers mid-generation for at least one request.
    plain, _ = _run_plain(target, prompts, n_new)
    rid0 = list(prompts)[0]
    eos = plain[rid0][3]
    want, _ = _run_plain(target, prompts, n_new, eos=eos)
    got, eng = _run_spec(target, draft, prompts, n_new, eos=eos)
    assert got == want
    assert got[rid0][-1] == eos and len(got[rid0]) <= 4 + 1


def test_spec_engine_budget_overshoot_trimmed(target, draft):
    """A round can accept past the request budget; the host must trim to
    max_new_tokens exactly."""
    cfg, _ = target
    prompts = _requests(cfg, seed=13, n=2)
    n_new = {rid: 5 for rid in prompts}
    want, _ = _run_plain(target, prompts, n_new)
    got, _ = _run_spec(target, draft, prompts, n_new, gamma=4,
                       rounds_per_call=2)
    assert got == want
    for rid in prompts:
        assert len(got[rid]) == 5


def test_spec_engine_preemption_recompute(target, draft):
    """A pool too small for both sequences' speculative high-water marks
    forces preemption; recompute must keep outputs identical to a roomy
    pool (greedy replay)."""
    cfg, _ = target
    prompts = _requests(cfg, seed=17, n=2)
    n_new = {rid: 8 for rid in prompts}
    roomy, er = _run_spec(target, draft, prompts, n_new)
    tight, et = _run_spec(target, draft, prompts, n_new, num_pages=6)
    assert roomy == tight
    assert et.stats["preemptions"] > 0, et.stats
    assert not et.failed


def test_spec_engine_chunked_admission_matches_plain_chunked(target, draft):
    """Chunked admission x speculative decode: with the SAME prefill
    chunking the target cache is written identically to the plain
    engine's, so outputs must match exactly (both waves of requests,
    interleaved admission and spec rounds)."""
    cfg, _ = target
    prompts = _requests(cfg, seed=21)
    # One long prompt so admission takes several chunk rounds while the
    # other slots speculate.
    rid_long = list(prompts)[0]
    prompts[rid_long] = prompts[rid_long] * 3
    n_new = {rid: 6 for rid in prompts}
    want, _ = _run_plain(target, prompts, n_new, prefill_chunk=8)
    got, eng = _run_spec(target, draft, prompts, n_new, prefill_chunk=8)
    assert got == want
    assert not eng.failed


def test_spec_engine_quantized_target_cache(target, draft):
    """int8-KV target cache x speculative: the draft pool stays bf16 and
    outputs must match the plain engine over the SAME quantized cache
    (both sides read identical int8 pages; the verify extend and the
    decode kernel dequantize the same values)."""
    import jax.numpy as jnp

    cfg, _ = target
    prompts = _requests(cfg, seed=29)
    n_new = {rid: 6 for rid in prompts}
    want, _ = _run_plain(target, prompts, n_new, kv_dtype=jnp.int8)
    got, eng = _run_spec(target, draft, prompts, n_new, kv_dtype=jnp.int8)
    assert got == want
    assert not eng.failed
    assert eng.stats["spec_calls"] >= 1


def test_spec_engine_sampled_deterministic_and_replay_stable(target, draft):
    """Rejection-sampling speculative serving: same seed => identical
    streams, and a preemption-forcing tight pool must REPLAY the same
    tokens (randomness is keyed by request seed + absolute position)."""
    from flash_attention_cute.runtime.sampling import SamplingParams

    cfg, _ = target
    prompts = _requests(cfg, seed=31, n=2)
    n_new = {rid: 8 for rid in prompts}
    # min_p rides filter_logits, so it must compose with the in-scan
    # draft/verify rejection sampling and with preemption replay too.
    sp = SamplingParams(temperature=0.9, top_k=50, min_p=0.02)
    a, ea = _run_spec(target, draft, prompts, n_new, sampling=sp)
    b, _ = _run_spec(target, draft, prompts, n_new, sampling=sp)
    assert a == b
    tight, et = _run_spec(target, draft, prompts, n_new, sampling=sp,
                          num_pages=6)
    assert tight == a, (tight, a)
    assert et.stats["preemptions"] > 0, et.stats


def test_spec_engine_sampled_low_temperature_matches_greedy(target, draft):
    from flash_attention_cute.runtime.sampling import SamplingParams

    cfg, _ = target
    prompts = _requests(cfg, seed=33, n=2)
    n_new = {rid: 6 for rid in prompts}
    want, _ = _run_plain(target, prompts, n_new)
    got, _ = _run_spec(target, draft, prompts, n_new,
                       sampling=SamplingParams(temperature=1e-4))
    assert got == want


def test_spec_engine_data_parallel_replicas(target, draft):
    """DP x speculative: SpeculativeServingEngine replicas behind the
    shared least-loaded queue ((data=2, model=2) CPU mesh) must emit
    exactly what single-replica speculative serving emits."""
    import jax as _jax
    from jax.sharding import Mesh

    from flash_attention_cute.runtime.dp_engine import (
        DataParallelServingEngine,
    )

    cfg, params = target
    dcfg, dparams = draft
    prompts = _requests(cfg, seed=23, n=4)
    n_new = {rid: 5 for rid in prompts}
    want, _ = _run_spec(target, draft, prompts, n_new)

    mesh = Mesh(
        np.array(_jax.devices()[:4]).reshape(2, 2), ("data", "model")
    )
    from flash_attention_cute.runtime.spec_engine import (
        SpeculativeServingEngine as SpecCls,
    )
    eng = DataParallelServingEngine(
        params, cfg, mesh=mesh, engine_cls=SpecCls,
        draft_params=dparams, draft_cfg=dcfg, gamma=3,
        interpret=True, **POOL,
    )
    for rid, p in prompts.items():
        eng.submit(rid, p, n_new[rid])
    got = eng.run()
    assert got == want, (got, want)
    assert not eng.failed
    assert all(e.stats["requests_finished"] > 0 for e in eng.replicas)


def test_spec_engine_sliding_window_model(draft):
    """A Qwen2-style sliding-window target served speculatively must
    match the plain engine exactly (the verify extends run the windowed
    paged kernel for the windowed layer segment)."""
    cfg = tiny_test_config(
        num_layers=2, sliding_window=8, use_sliding_window=True,
        max_window_layers=1,
    )
    params = init_params(cfg, jax.random.key(41))
    prompts = _requests(cfg, seed=41, n=2)
    prompts = {rid: p * 2 for rid, p in prompts.items()}  # exceed window
    n_new = {rid: 6 for rid in prompts}
    want, _ = _run_plain((cfg, params), prompts, n_new)
    got, eng = _run_spec((cfg, params), draft, prompts, n_new)
    assert got == want
    assert not eng.failed


def test_spec_engine_prompt_lookup_mode(target):
    """ngram > 0: draft-free prompt-lookup speculation in the engine —
    no draft pool at all, outputs exactly match the plain engine, and a
    repetitive prompt exercises real hit/reject traffic."""
    cfg, params = target
    rng = np.random.default_rng(37)
    base = rng.integers(0, cfg.vocab_size, 5).tolist()
    prompts = {
        300: base * 4,                                   # repetitive
        301: rng.integers(0, cfg.vocab_size, 9).tolist(),  # random
    }
    n_new = {300: 8, 301: 8}
    want, _ = _run_plain(target, prompts, n_new)
    eng = SpeculativeServingEngine(
        params, cfg, ngram=2, gamma=3, rounds_per_call=2,
        interpret=True, **POOL,
    )
    for rid, p in prompts.items():
        eng.submit(rid, p, n_new[rid])
    got = eng.run()
    assert got == want
    assert not eng.failed
    assert eng.d_state is None


def test_spec_engine_prompt_lookup_with_prefix_cache(target):
    """ngram mode composes with prefix caching (no draft pool to
    mirror)."""
    cfg, params = target
    rng = np.random.default_rng(39)
    system = rng.integers(0, cfg.vocab_size, 17).tolist()
    prompts = {
        400 + i: system + rng.integers(0, cfg.vocab_size, 4 + i).tolist()
        for i in range(3)
    }
    n_new = {rid: 6 for rid in prompts}
    want, _ = _run_plain(target, prompts, n_new)
    eng = SpeculativeServingEngine(
        params, cfg, ngram=2, gamma=3, interpret=True,
        enable_prefix_cache=True, **POOL,
    )
    for rid, p in prompts.items():
        eng.submit(rid, p, n_new[rid])
    got = eng.run()
    assert got == want
    assert eng.stats["prefix_hit_tokens"] >= 16
