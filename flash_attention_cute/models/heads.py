"""Non-generative task heads over the causal-LM trunk.

The reference vendors HF's SequenceClassification and QuestionAnswering
model classes wholesale (reference: models/modeling_llama.py:971 and
:1086, models/modeling_qwen2.py:926). Here they are thin functional
heads over the same trunk `transformer.forward(return_hidden=True)` —
the trunk (and thus every attention kernel, cache mode, and sharding)
is shared, and the heads reproduce HF's pooling semantics exactly:

* Sequence classification pools the hidden state of each row's LAST
  non-pad token: with no pad_token_id the last position; otherwise
  `argmax(input_ids == pad) - 1 (mod S)` — the HF trick where a row
  without padding wraps -1 to S-1.
* Question answering projects every position to (start, end) logits.

Weights convert via `models.convert.head_params_from_state_dict`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from flash_attention_cute.models.config import ModelConfig
from flash_attention_cute.models.transformer import forward


def sequence_classification_forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: jax.Array,
    pad_token_id: int | None = None,
    interpret: bool | None = None,
    mesh=None,
) -> jax.Array:
    """Pooled classification logits [B, num_labels] (fp32).

    Mirrors HF `LlamaForSequenceClassification.forward` pooling
    (reference: models/modeling_llama.py:1020-1040): per-position scores
    from the `score` head, then select each row's last non-pad position.
    """
    hidden, _ = forward(
        params, cfg, input_ids, return_hidden=True,
        interpret=interpret, mesh=mesh,
    )
    logits = jnp.dot(
        hidden, params["score"].astype(hidden.dtype)
    ).astype(jnp.float32)  # [B, S, num_labels]
    b, s = input_ids.shape
    if pad_token_id is None:
        idx = jnp.full((b,), s - 1, jnp.int32)
    else:
        is_pad = (input_ids == pad_token_id).astype(jnp.int32)
        idx = (jnp.argmax(is_pad, axis=-1).astype(jnp.int32) - 1) % s
    return logits[jnp.arange(b), idx]


def token_classification_forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: jax.Array,
    interpret: bool | None = None,
    mesh=None,
) -> jax.Array:
    """Per-position label logits [B, S, num_labels] (fp32).

    Mirrors HF `LlamaForTokenClassification.forward` (a bias-ful `score`
    Linear over every position; the classifier dropout is an inference
    no-op). Beyond the reference's two vendored heads — HF ships this
    head for the same families the reference patches.
    """
    hidden, _ = forward(
        params, cfg, input_ids, return_hidden=True,
        interpret=interpret, mesh=mesh,
    )
    return (
        jnp.dot(hidden, params["score"].astype(hidden.dtype))
        + params["score_bias"].astype(hidden.dtype)
    ).astype(jnp.float32)


def embedding_pooling_forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: jax.Array,
    pooling: str = "mean",  # "mean" | "last" | "cls"
    pad_token_id: int | None = None,
    normalize: bool = True,
    interpret: bool | None = None,
    mesh=None,
) -> jax.Array:
    """Sentence embeddings [B, hidden] (fp32) from the causal-LM trunk.

    Beyond the reference (no embedding models there): the standard
    decoder-as-embedder recipes — masked MEAN pooling over non-pad
    positions, LAST non-pad token (the e5/gte-Qwen2 recipe — the natural
    pooling for causal attention), or the first token ("cls") — with
    optional L2 normalization. Right padding assumed, matching the rest
    of the stack (the interop layer rejects left padding loudly).
    """
    assert pooling in ("mean", "last", "cls"), pooling
    hidden, _ = forward(
        params, cfg, input_ids, return_hidden=True,
        interpret=interpret, mesh=mesh,
    )
    hidden = hidden.astype(jnp.float32)
    b, s = input_ids.shape
    if pad_token_id is None:
        valid = jnp.ones((b, s), jnp.float32)
        last_idx = jnp.full((b,), s - 1, jnp.int32)
    else:
        valid = (input_ids != pad_token_id).astype(jnp.float32)
        is_pad = (input_ids == pad_token_id).astype(jnp.int32)
        last_idx = (jnp.argmax(is_pad, axis=-1).astype(jnp.int32) - 1) % s
    if pooling == "mean":
        denom = jnp.maximum(jnp.sum(valid, axis=1, keepdims=True), 1.0)
        emb = jnp.sum(hidden * valid[..., None], axis=1) / denom
    elif pooling == "last":
        emb = hidden[jnp.arange(b), last_idx]
    else:
        emb = hidden[:, 0]
    if normalize:
        emb = emb / jnp.maximum(
            jnp.linalg.norm(emb, axis=-1, keepdims=True), 1e-9
        )
    return emb


def question_answering_forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: jax.Array,
    interpret: bool | None = None,
    mesh=None,
) -> tuple[jax.Array, jax.Array]:
    """Extractive-QA (start_logits, end_logits), each [B, S] fp32.

    Mirrors HF `LlamaForQuestionAnswering.forward`
    (reference: models/modeling_llama.py:1123-1143): a bias-ful
    2-output projection over every position, split into span ends.
    """
    hidden, _ = forward(
        params, cfg, input_ids, return_hidden=True,
        interpret=interpret, mesh=mesh,
    )
    logits = (
        jnp.dot(hidden, params["qa_outputs"].astype(hidden.dtype))
        + params["qa_outputs_bias"].astype(hidden.dtype)
    ).astype(jnp.float32)  # [B, S, 2]
    return logits[..., 0], logits[..., 1]
