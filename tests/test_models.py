"""Model-stack parity vs HuggingFace transformers (torch CPU oracle).

The reference validates its model integration by running patched HF models
and eyeballing generations (reference: scripts/benchmark_llm.py:95-118); we
do it properly: tiny random-weight HF models' logits must match our JAX
stack bit-tolerantly in fp32, for both Llama and Qwen2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models import (
    KVCache,
    forward,
    init_params,
    llama_config_from_hf,
    qwen2_config_from_hf,
)
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.models.convert import params_from_state_dict

transformers = pytest.importorskip("transformers")
torch = pytest.importorskip("torch")


def tiny_hf_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=128,
        hidden_size=64,
        intermediate_size=112,
        num_hidden_layers=3,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=128,
        rms_norm_eps=1e-6,
        rope_theta=10000.0,
        attention_bias=False,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    with torch.device("cpu"):
        model = transformers.LlamaForCausalLM(cfg).eval()
    return cfg, model


def tiny_hf_qwen2():
    cfg = transformers.Qwen2Config(
        vocab_size=128,
        hidden_size=64,
        intermediate_size=112,
        num_hidden_layers=3,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=128,
        rms_norm_eps=1e-6,
        rope_theta=1000000.0,
        tie_word_embeddings=True,
        use_sliding_window=False,
    )
    torch.manual_seed(1)
    with torch.device("cpu"):
        model = transformers.Qwen2ForCausalLM(cfg).eval()
    return cfg, model


def hf_logits(model, ids_np):
    with torch.no_grad():
        return model(torch.from_numpy(ids_np)).logits.float().numpy()


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_logits_parity_with_hf(family):
    if family == "llama":
        hf_cfg, model = tiny_hf_llama()
        cfg = llama_config_from_hf(hf_cfg, dtype=jnp.float32)
    else:
        hf_cfg, model = tiny_hf_qwen2()
        cfg = qwen2_config_from_hf(hf_cfg, dtype=jnp.float32)

    params = params_from_state_dict(model.state_dict(), cfg)
    ids = np.array([[1, 5, 9, 2, 7, 3, 11, 4]], np.int32)

    want = hf_logits(model, ids)
    got, _ = forward(params, cfg, jnp.asarray(ids), mode="prefill")
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4, rtol=2e-3)


def test_prefill_then_decode_matches_full_forward():
    """KV-cached decoding must reproduce the uncached logits token by token
    (the invariant behind the reference's per-token decode loop,
    scripts/benchmark_llm.py:65-92)."""
    cfg = tiny_test_config()
    params = init_params(cfg, jax.random.key(0))
    ids = jax.random.randint(jax.random.key(1), (2, 12), 0, cfg.vocab_size)

    full_logits, _ = forward(params, cfg, ids, mode="prefill")

    cache = KVCache.create(cfg, batch=2, capacity=32)
    prefill_len = 8
    logits_p, cache = forward(
        params, cfg, ids[:, :prefill_len], cache=cache, mode="prefill"
    )
    np.testing.assert_allclose(
        np.asarray(logits_p), np.asarray(full_logits[:, :prefill_len]),
        atol=1e-4, rtol=1e-3,
    )

    for t in range(prefill_len, 12):
        logits_t, cache = forward(
            params, cfg, ids[:, t : t + 1], cache=cache, mode="decode"
        )
        np.testing.assert_allclose(
            np.asarray(logits_t[:, 0]), np.asarray(full_logits[:, t]),
            atol=1e-4, rtol=1e-3,
        )


def test_chunked_prefill_extend_matches_full_forward():
    cfg = tiny_test_config()
    params = init_params(cfg, jax.random.key(0))
    ids = jax.random.randint(jax.random.key(2), (2, 16), 0, cfg.vocab_size)

    full_logits, _ = forward(params, cfg, ids, mode="prefill")

    cache = KVCache.create(cfg, batch=2, capacity=32)
    _, cache = forward(params, cfg, ids[:, :8], cache=cache, mode="prefill")
    logits_e, cache = forward(params, cfg, ids[:, 8:16], cache=cache, mode="extend")
    np.testing.assert_allclose(
        np.asarray(logits_e), np.asarray(full_logits[:, 8:16]),
        atol=1e-4, rtol=1e-3,
    )
    np.testing.assert_array_equal(np.asarray(cache.lengths), [16, 16])


def test_qwen2_sliding_window_accepted():
    """The reference rejects sliding windows
    (models/modeling_qwen2.py:261-269); this framework supports them
    natively (see tests/test_sliding_window.py for kernel coverage)."""
    hf_cfg = {"use_sliding_window": True, "sliding_window": 512,
              "max_window_layers": 0, "hidden_size": 64,
              "num_attention_heads": 4, "vocab_size": 128,
              "intermediate_size": 112, "num_hidden_layers": 1}
    cfg = qwen2_config_from_hf(hf_cfg)
    assert cfg.use_sliding_window and cfg.sliding_window == 512


def test_rope_scaling_variants_run():
    for rs in (
        {"rope_type": "linear", "factor": 2.0},
        {"rope_type": "dynamic", "factor": 2.0,
         "original_max_position_embeddings": 128},
        {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
         "high_freq_factor": 4.0, "original_max_position_embeddings": 128},
    ):
        hf_cfg = dict(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2,
            num_key_value_heads=2, max_position_embeddings=256,
            rope_scaling=rs, tie_word_embeddings=False,
        )
        cfg = llama_config_from_hf(hf_cfg, dtype=jnp.float32)
        params = init_params(cfg, jax.random.key(3))
        ids = jnp.ones((1, 8), jnp.int32)
        logits, _ = forward(params, cfg, ids, mode="prefill")
        assert np.isfinite(np.asarray(logits)).all()


def test_llama3_rope_scaling_parity_with_hf():
    """The llama3 frequency-banded scaling must match HF's implementation."""
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64},
        tie_word_embeddings=False,
    )
    torch.manual_seed(2)
    with torch.device("cpu"):
        model = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg = llama_config_from_hf(hf_cfg, dtype=jnp.float32)
    params = params_from_state_dict(model.state_dict(), cfg)
    ids = np.array([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]], np.int32)
    want = hf_logits(model, ids)
    got, _ = forward(params, cfg, jnp.asarray(ids), mode="prefill")
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4, rtol=2e-3)


# ---------------------------------------------------------------------------
# Non-generative task heads (reference: models/modeling_llama.py:971,:1086,
# modeling_qwen2.py:926 — SequenceClassification / QuestionAnswering).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["llama", "qwen2"])
@pytest.mark.parametrize("padded", [False, True], ids=["nopad", "padded"])
def test_sequence_classification_parity_with_hf(family, padded):
    from flash_attention_cute.models.convert import (
        head_params_from_state_dict,
    )
    from flash_attention_cute.models.heads import (
        sequence_classification_forward,
    )

    num_labels = 3
    if family == "llama":
        hf_cfg, _ = tiny_hf_llama()
        hf_cfg.num_labels = num_labels
        hf_cfg.pad_token_id = 0 if padded else None
        torch.manual_seed(2)
        with torch.device("cpu"):
            model = transformers.LlamaForSequenceClassification(hf_cfg).eval()
        cfg = llama_config_from_hf(hf_cfg, dtype=jnp.float32)
    else:
        hf_cfg, _ = tiny_hf_qwen2()
        hf_cfg.num_labels = num_labels
        hf_cfg.pad_token_id = 0 if padded else None
        torch.manual_seed(3)
        with torch.device("cpu"):
            model = transformers.Qwen2ForSequenceClassification(hf_cfg).eval()
        cfg = qwen2_config_from_hf(hf_cfg, dtype=jnp.float32)

    params = head_params_from_state_dict(
        model.state_dict(), cfg, "sequence_classification"
    )
    rng = np.random.default_rng(4)
    # HF refuses batch > 1 without a pad token — match that envelope.
    b = 2 if padded else 1
    ids = rng.integers(1, 120, (b, 24)).astype(np.int64)
    if padded:
        ids[0, 17:] = 0  # right padding; row 1 stays full-length
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits.float().numpy()
    got = sequence_classification_forward(
        params, cfg, jnp.asarray(ids, jnp.int32),
        pad_token_id=hf_cfg.pad_token_id, interpret=True,
    )
    assert got.shape == (b, num_labels)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4, rtol=2e-3)


def test_question_answering_parity_with_hf():
    from flash_attention_cute.models.convert import (
        head_params_from_state_dict,
    )
    from flash_attention_cute.models.heads import (
        question_answering_forward,
    )

    hf_cfg, _ = tiny_hf_llama()
    torch.manual_seed(5)
    with torch.device("cpu"):
        model = transformers.LlamaForQuestionAnswering(hf_cfg).eval()
    cfg = llama_config_from_hf(hf_cfg, dtype=jnp.float32)
    params = head_params_from_state_dict(
        model.state_dict(), cfg, "question_answering"
    )
    rng = np.random.default_rng(6)
    ids = rng.integers(1, 120, (2, 24)).astype(np.int64)
    with torch.no_grad():
        out = model(torch.from_numpy(ids))
        want_start = out.start_logits.float().numpy()
        want_end = out.end_logits.float().numpy()
    start, end = question_answering_forward(
        params, cfg, jnp.asarray(ids, jnp.int32), interpret=True
    )
    np.testing.assert_allclose(np.asarray(start), want_start,
                               atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(np.asarray(end), want_end,
                               atol=2e-4, rtol=2e-3)


def test_token_classification_parity_with_hf():
    from flash_attention_cute.models.convert import (
        head_params_from_state_dict,
    )
    from flash_attention_cute.models.heads import (
        token_classification_forward,
    )

    hf_cfg, _ = tiny_hf_llama()
    hf_cfg.num_labels = 5
    hf_cfg.classifier_dropout = 0.0
    torch.manual_seed(7)
    with torch.device("cpu"):
        model = transformers.LlamaForTokenClassification(hf_cfg).eval()
    cfg = llama_config_from_hf(hf_cfg, dtype=jnp.float32)
    params = head_params_from_state_dict(
        model.state_dict(), cfg, "token_classification"
    )
    rng = np.random.default_rng(8)
    ids = rng.integers(1, 120, (2, 24)).astype(np.int64)
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits.float().numpy()
    got = token_classification_forward(
        params, cfg, jnp.asarray(ids, jnp.int32), interpret=True
    )
    assert got.shape == (2, 24, 5)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("pooling", ["mean", "last", "cls"])
def test_embedding_pooling_semantics(pooling):
    """Embedding pooling (beyond the reference): each recipe must equal a
    straight numpy pooling of the SAME trunk hidden states, with right-pad
    masking and L2 normalization."""
    from flash_attention_cute.models import forward, init_params
    from flash_attention_cute.models.config import tiny_test_config
    from flash_attention_cute.models.heads import (
        embedding_pooling_forward,
    )

    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(9))
    rng = np.random.default_rng(10)
    ids = rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    ids[0, 9:] = 0  # right padding; pad_token_id=0
    emb = embedding_pooling_forward(
        params, cfg, jnp.asarray(ids), pooling=pooling, pad_token_id=0,
        interpret=True,
    )
    hidden, _ = forward(
        params, cfg, jnp.asarray(ids), return_hidden=True, interpret=True
    )
    h = np.asarray(hidden, np.float32)
    valid = (ids != 0)
    if pooling == "mean":
        want = np.stack([
            h[b][valid[b]].mean(axis=0) for b in range(2)
        ])
    elif pooling == "last":
        want = np.stack([
            h[b][np.flatnonzero(valid[b])[-1]] for b in range(2)
        ])
    else:
        want = h[:, 0]
    want = want / np.linalg.norm(want, axis=-1, keepdims=True)
    assert emb.shape == (2, cfg.hidden_size)
    np.testing.assert_allclose(np.asarray(emb), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Gemma 2 (third model family, beyond the reference's Llama + Qwen2):
# alternating sliding/full layers, GeGLU, sandwich norms, (1+w) RMSNorm,
# scaled embeddings, query_pre_attn_scalar, attn + final logit softcaps.
# ---------------------------------------------------------------------------


def tiny_hf_gemma2(window=8):
    cfg = transformers.Gemma2Config(
        vocab_size=128,
        hidden_size=64,
        intermediate_size=112,
        num_hidden_layers=4,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        max_position_embeddings=128,
        rms_norm_eps=1e-6,
        rope_theta=10000.0,
        attention_bias=False,
        tie_word_embeddings=True,
        sliding_window=window,
        query_pre_attn_scalar=24,
        attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0,
        hidden_activation="gelu_pytorch_tanh",
        attn_implementation="eager",
    )
    torch.manual_seed(4)
    with torch.device("cpu"):
        model = transformers.Gemma2ForCausalLM(cfg).eval()
    return cfg, model


def test_gemma2_logits_parity_with_hf():
    from flash_attention_cute.models import forward
    from flash_attention_cute.models.gemma2 import gemma2_config_from_hf

    hf_cfg, model = tiny_hf_gemma2()
    cfg = gemma2_config_from_hf(hf_cfg, dtype=jnp.float32)
    assert cfg.layer_window_pattern == (8, None)
    assert cfg.sandwich_norms and cfg.scale_embeddings
    params = params_from_state_dict(model.state_dict(), cfg)

    rng = np.random.default_rng(20)
    # Long enough that the sliding window actually truncates attention.
    ids = rng.integers(0, 128, (2, 24)).astype(np.int64)
    want = hf_logits(model, ids)
    got, _ = forward(
        params, cfg, jnp.asarray(ids, jnp.int32), mode="prefill",
        interpret=True,
    )
    np.testing.assert_allclose(np.asarray(got), want, atol=3e-4, rtol=3e-3)


def test_gemma2_prefill_decode_matches_full_forward():
    """Cached decode through the ALTERNATING-window carry scan must match
    a fresh full prefill at every step (exercises the periodic pattern in
    the stacked-cache path)."""
    from flash_attention_cute.models import KVCache, forward
    from flash_attention_cute.models.gemma2 import gemma2_config_from_hf

    hf_cfg, model = tiny_hf_gemma2()
    cfg = gemma2_config_from_hf(hf_cfg, dtype=jnp.float32)
    params = params_from_state_dict(model.state_dict(), cfg)
    rng = np.random.default_rng(21)
    ids = rng.integers(0, 128, (1, 12)).astype(np.int32)

    cache = KVCache.create(cfg, batch=1, capacity=32)
    logits, cache = forward(
        params, cfg, jnp.asarray(ids), cache=cache, mode="prefill",
        interpret=True,
    )
    toks = list(ids[0])
    for step in range(4):
        nxt = int(jnp.argmax(logits[0, -1] if step == 0 else logits[0, 0]))
        toks.append(nxt)
        full, _ = forward(
            params, cfg, jnp.asarray([toks], jnp.int32), mode="prefill",
            interpret=True,
        )
        logits, cache = forward(
            params, cfg, jnp.asarray([[nxt]], jnp.int32), cache=cache,
            mode="decode", interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(logits[0, 0]), np.asarray(full[0, -1]),
            atol=2e-4, rtol=2e-3,
        )


def test_gemma2_serving_engine_exact():
    """Gemma2 through the PAGED serving path (alternating windows +
    softcaps + scaled embeddings in forward_paged) must match dense
    greedy generation."""
    from flash_attention_cute.models import forward
    from flash_attention_cute.models.gemma2 import gemma2_config_from_hf
    from flash_attention_cute.runtime.engine import ServingEngine

    hf_cfg, model = tiny_hf_gemma2()
    cfg = gemma2_config_from_hf(hf_cfg, dtype=jnp.float32)
    params = params_from_state_dict(model.state_dict(), cfg)
    rng = np.random.default_rng(22)
    prompts = {
        0: rng.integers(0, 128, 13).tolist(),
        1: rng.integers(0, 128, 6).tolist(),
    }

    eng = ServingEngine(
        params, cfg, slots=2, num_pages=33, page_size=8, pages_per_seq=8,
        interpret=True,
    )
    for rid, p in prompts.items():
        eng.submit(rid, p, 5)
    results = eng.run()
    assert not eng.failed
    for rid, p in prompts.items():
        ids = list(p)
        want = []
        for _ in range(5):
            lg, _ = forward(
                params, cfg, jnp.asarray([ids], jnp.int32),
                mode="prefill", interpret=True,
            )
            nxt = int(jnp.argmax(lg[0, -1]))
            want.append(nxt)
            ids.append(nxt)
        assert results[rid] == want, (rid, results[rid], want)


def test_mistral_logits_parity_with_hf():
    """Mistral (fourth family): Llama + uniform sliding window — logits
    parity vs transformers, window long AND short relative to the
    sequence."""
    from flash_attention_cute.models import forward
    from flash_attention_cute.models.mistral import (
        mistral_config_from_hf,
    )

    for window in (64, 8):  # inert window, then truncating window
        hf_cfg = transformers.MistralConfig(
            vocab_size=128,
            hidden_size=64,
            intermediate_size=112,
            num_hidden_layers=3,
            num_attention_heads=4,
            num_key_value_heads=2,
            max_position_embeddings=128,
            rms_norm_eps=1e-6,
            rope_theta=10000.0,
            sliding_window=window,
            attn_implementation="eager",
        )
        torch.manual_seed(8)
        with torch.device("cpu"):
            model = transformers.MistralForCausalLM(hf_cfg).eval()
        cfg = mistral_config_from_hf(hf_cfg, dtype=jnp.float32)
        assert cfg.use_sliding_window and cfg.max_window_layers == 0
        params = params_from_state_dict(model.state_dict(), cfg)
        rng = np.random.default_rng(24)
        ids = rng.integers(0, 128, (2, 24)).astype(np.int64)
        want = hf_logits(model, ids)
        got, _ = forward(
            params, cfg, jnp.asarray(ids, jnp.int32), mode="prefill",
            interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(got), want, atol=3e-4, rtol=3e-3,
            err_msg=f"window={window}",
        )
