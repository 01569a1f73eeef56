"""Generation runtime vs HF transformers `generate` (torch CPU oracle).

The reference's integration check is greedy generation through the patched
model (reference: scripts/benchmark_llm.py:95-118, benchmark_llm_e2e.py:42-47);
here the check is token-exact greedy parity with HF on a tiny model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models import llama_config_from_hf
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.models.convert import params_from_state_dict
from flash_attention_cute.models.transformer import init_params
from flash_attention_cute.runtime import generate, greedy_generate
from flash_attention_cute.runtime.sampling import SamplingParams, sample_token

transformers = pytest.importorskip("transformers")
torch = pytest.importorskip("torch")


@pytest.fixture(scope="module")
def tiny_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=128,
        hidden_size=64,
        intermediate_size=112,
        num_hidden_layers=3,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=256,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    with torch.device("cpu"):
        model = transformers.LlamaForCausalLM(cfg).eval()
    jcfg = llama_config_from_hf(cfg, dtype=jnp.float32)
    params = params_from_state_dict(model.state_dict(), jcfg)
    return model, jcfg, params


def test_greedy_matches_hf_generate(tiny_llama):
    model, jcfg, params = tiny_llama
    prompt = np.array([[5, 17, 88, 3, 9, 44, 2, 61]], np.int32)
    with torch.no_grad():
        want = model.generate(
            torch.from_numpy(prompt).long(),
            max_new_tokens=16, do_sample=False,
            pad_token_id=0,
        ).numpy()[:, prompt.shape[1]:]
    got = greedy_generate(params, jcfg, jnp.asarray(prompt), 16)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_greedy_matches_hf_generate_batched(tiny_llama):
    model, jcfg, params = tiny_llama
    prompt = np.array(
        [[5, 17, 88, 3, 9, 44, 2, 61], [7, 7, 19, 23, 101, 6, 90, 12]], np.int32
    )
    with torch.no_grad():
        want = model.generate(
            torch.from_numpy(prompt).long(), max_new_tokens=12,
            do_sample=False, pad_token_id=0,
        ).numpy()[:, prompt.shape[1]:]
    got = greedy_generate(params, jcfg, jnp.asarray(prompt), 12)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_eos_done_masking():
    cfg = tiny_test_config()
    params = init_params(cfg, jax.random.key(0))
    ids = jax.random.randint(jax.random.key(1), (2, 4), 0, cfg.vocab_size)
    out = generate(params, cfg, ids, 8, eos_token_id=3)
    out = np.asarray(out)
    for row in out:
        hits = np.where(row == 3)[0]
        if hits.size:
            # Everything after the first EOS must stay EOS.
            assert (row[hits[0]:] == 3).all()


def test_sampling_params_shapes():
    logits = jax.random.normal(jax.random.key(0), (4, 64))
    for sp in (
        SamplingParams(),
        SamplingParams(temperature=0.7),
        SamplingParams(temperature=0.7, top_k=8),
        SamplingParams(temperature=0.7, top_p=0.9),
        SamplingParams(temperature=1.3, top_k=16, top_p=0.95),
        SamplingParams(temperature=0.8, min_p=0.1),
        SamplingParams(temperature=1.1, top_k=16, top_p=0.95, min_p=0.05),
    ):
        tok = sample_token(logits, jax.random.key(1), sp)
        assert tok.shape == (4,) and tok.dtype == jnp.int32
        assert (np.asarray(tok) >= 0).all() and (np.asarray(tok) < 64).all()


def test_greedy_sampling_is_argmax():
    logits = jax.random.normal(jax.random.key(2), (3, 32))
    tok = sample_token(logits, None, SamplingParams(temperature=0.0))
    np.testing.assert_array_equal(np.asarray(tok), np.asarray(jnp.argmax(logits, -1)))


def test_top_k_restricts_support():
    key = jax.random.key(3)
    logits = jnp.tile(jnp.arange(32.0)[None], (2, 1))  # monotone
    for i in range(20):
        tok = sample_token(
            logits, jax.random.fold_in(key, i),
            SamplingParams(temperature=1.0, top_k=4),
        )
        assert (np.asarray(tok) >= 28).all()


def test_min_p_matches_probability_oracle():
    """min_p keeps exactly the tokens whose softmax probability is
    >= min_p * max probability (renormalization-invariant ratio), for
    any temperature, without sorting."""
    from flash_attention_cute.runtime.sampling import filter_logits

    rng = np.random.default_rng(7)
    logits = jnp.asarray(rng.standard_normal((5, 97)) * 3.0, jnp.float32)
    for temp, min_p in ((1.0, 0.1), (0.7, 0.25), (1.5, 0.02)):
        got = np.asarray(
            filter_logits(logits, SamplingParams(temperature=temp, min_p=min_p))
        )
        scaled = np.asarray(logits, np.float64) / temp
        p = np.exp(scaled - scaled.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        keep = p >= min_p * p.max(-1, keepdims=True)
        assert (np.isfinite(got) == keep).all()
        # Surviving logits pass through unchanged (just scaled).
        np.testing.assert_allclose(got[keep], scaled[keep].astype(np.float32),
                                   rtol=1e-6)


def test_min_p_composes_with_top_k():
    """After top-k masking, min_p measures ratios within the SURVIVING
    support (the argmax always survives top-k), so the combined filter is
    top-k-then-min-p — and sampling stays inside the intersection."""
    key = jax.random.key(11)
    logits = jnp.asarray([np.linspace(0.0, 8.0, 32)], jnp.float32)
    sp = SamplingParams(temperature=1.0, top_k=8, min_p=np.exp(-3.0) + 1e-6)
    # top_k=8 keeps ids 24..31; min_p then cuts ids whose logit is more
    # than 3.0 below the max (8.0): linspace step ~0.258, 3.0/0.258 ~ 11.6
    # -> ids 20.. survive the min_p cut alone; intersection = 24..31 minus
    # none (all within 3.0 of max? ids 24 has logit 6.19, gap 1.8 < 3) =>
    # support stays 24..31. Tighten min_p to cut inside the top-k set:
    sp = SamplingParams(temperature=1.0, top_k=8, min_p=float(np.exp(-1.0)))
    for i in range(30):
        tok = sample_token(logits, jax.random.fold_in(key, i), sp)
        # gap <= 1.0 nat from the max logit 8.0 => logit >= 7.0 => ids 28+
        assert (np.asarray(tok) >= 28).all()


def test_greedy_interpret_kernel_path_matches(tiny_llama):
    """greedy_generate with interpret=True drives the Pallas decode path
    (including the stacked-cache layer-indexed kernel); it must reproduce
    the XLA-reference path token for token."""
    model, jcfg, params = tiny_llama
    prompt = np.array([[5, 17, 88, 3, 9, 44, 2, 61]], np.int32)
    ref_path = greedy_generate(params, jcfg, jnp.asarray(prompt), 12)
    kernel_path = greedy_generate(
        params, jcfg, jnp.asarray(prompt), 12, interpret=True
    )
    np.testing.assert_array_equal(
        np.asarray(kernel_path), np.asarray(ref_path)
    )
