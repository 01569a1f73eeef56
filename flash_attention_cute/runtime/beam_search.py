"""Beam search over the cached decode path.

The reference reaches beam decoding only through HF `generate` on its
vendored torch models (reference: scripts/benchmark_llm_e2e.py); here it
is native and compiled: beams ride the batch axis (B*K rows through the
same decode kernels), per-step beam reordering is a cache gather, and
the whole loop is one `lax.while_loop` — no host round trips per step.

Semantics (classic sum-logprob beam search, HF-style length penalty):
  * step: expand each live beam by the top candidates of
    score + logprob; keep the best K non-EOS continuations as the new
    live set; EOS continuations retire into a per-row hypothesis set of
    size K scored as total_logprob / len(new_tokens)^length_penalty.
  * stop: when every row has K retired hypotheses whose worst retired
    score beats the best live beam's optimistic bound (scores only
    decrease with length for length_penalty <= 1... the bound used is
    the live score under the CURRENT length — the standard
    early_stopping=False heuristic), or at max_new_tokens.
  * return: each row's best hypothesis (best live beam when fewer than
    K retired), padded with EOS.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from flash_attention_cute.models.config import ModelConfig
from flash_attention_cute.models.transformer import forward
from flash_attention_cute.runtime.generate import prefill

NEG = -1e30


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "max_new_tokens", "num_beams", "eos_token_id",
        "length_penalty", "interpret", "mesh",
    ),
    donate_argnames=("cache",),
)
def _beam_loop(
    params,
    cfg: ModelConfig,
    cache,  # KVCache over B*K rows (prompt prefilled, replicated)
    first_scores: jax.Array,  # [B, K] initial beam scores (logprobs)
    first_tokens: jax.Array,  # [B, K] initial beam tokens
    max_new_tokens: int,
    num_beams: int,
    eos_token_id: int,
    length_penalty: float,
    interpret: bool | None,
    mesh=None,
):
    b, k = first_scores.shape
    t = max_new_tokens

    out = jnp.full((b, k, t), eos_token_id, jnp.int32)
    out = out.at[:, :, 0].set(first_tokens)
    scores = first_scores  # [B, K] live beam scores (sum logprob)
    # First-step EOS picks retire immediately.
    fin_tokens = jnp.full((b, k, t), eos_token_id, jnp.int32)
    fin_scores = jnp.full((b, k), NEG)
    first_eos = first_tokens == eos_token_id

    def retire(fin_tokens, fin_scores, cand_tokens, cand_scores, mask):
        """Merge masked candidate hypotheses ([B, K, T] / [B, K]) into the
        per-row retired set, keeping the best K overall."""
        cand_scores = jnp.where(mask, cand_scores, NEG)
        all_scores = jnp.concatenate([fin_scores, cand_scores], axis=1)
        all_tokens = jnp.concatenate([fin_tokens, cand_tokens], axis=1)
        top, idx = jax.lax.top_k(all_scores, k)
        gathered = jnp.take_along_axis(
            all_tokens, idx[:, :, None], axis=1
        )
        return gathered, top

    fin_tokens, fin_scores = retire(
        fin_tokens, fin_scores, out,
        scores / jnp.float32(1.0) ** length_penalty, first_eos,
    )
    scores = jnp.where(first_eos, NEG, scores)

    def cond(carry):
        (_, _, scores, _, fin_scores, step) = carry
        live_best = jnp.max(scores, axis=1)
        worst_fin = jnp.min(fin_scores, axis=1)
        # Optimistic live bound at current length (standard
        # early_stopping=False rule).
        denom = jnp.float32(step + 1) ** length_penalty
        undecided = live_best / denom > worst_fin
        return jnp.any(undecided) & (step < t)

    def body(carry):
        (cache, out, scores, fin_tokens, fin_scores, step) = carry
        last = jax.lax.dynamic_index_in_dim(
            out, jnp.maximum(step - 1, 0), 2, keepdims=False
        ).reshape(b * k)  # [B*K]
        logits, cache = forward(
            params, cfg, last[:, None], cache=cache, mode="decode",
            interpret=interpret, mesh=mesh,
        )
        lp = jax.nn.log_softmax(logits[:, 0].astype(jnp.float32), axis=-1)
        v = lp.shape[-1]
        cand = scores[:, :, None] + lp.reshape(b, k, v)  # [B, K, V]
        flat = cand.reshape(b, k * v)
        # 2K candidates cover the worst case of K EOS picks + K live.
        top, idx = jax.lax.top_k(flat, 2 * k)
        beam_idx = idx // v  # [B, 2K]
        tok = (idx % v).astype(jnp.int32)
        is_eos = tok == eos_token_id

        # Candidate token histories: parent beam's prefix + new token.
        parents = jnp.take_along_axis(
            out, beam_idx[:, :, None], axis=1
        )  # [B, 2K, T]
        cand_out = jax.vmap(
            lambda rows, toks: jax.vmap(
                lambda row, tk: row.at[step].set(tk)
            )(rows, toks)
        )(parents, tok)

        # Retire EOS candidates (hypothesis length = step + 1).
        denom = jnp.float32(step + 1) ** length_penalty
        fin_tokens, fin_scores = retire(
            fin_tokens, fin_scores, cand_out, top / denom, is_eos
        )

        # Keep the best K non-EOS candidates as the live set.
        live_rank = jnp.where(is_eos, NEG, top)
        ltop, lidx = jax.lax.top_k(live_rank, k)  # over 2K
        new_scores = ltop
        sel = jnp.take_along_axis(beam_idx, lidx, axis=1)  # [B, K] parent
        new_out = jnp.take_along_axis(
            cand_out, lidx[:, :, None], axis=1
        )

        # Reorder the KV cache to the surviving parents.
        flat_sel = (
            sel + jnp.arange(b, dtype=jnp.int32)[:, None] * k
        ).reshape(b * k)
        cache = dataclasses.replace(
            cache,
            k=cache.k[:, flat_sel],
            v=cache.v[:, flat_sel],
            lengths=cache.lengths[flat_sel] ,
        )
        return (cache, new_out, new_scores, fin_tokens, fin_scores,
                step + 1)

    init = (cache, out, scores, fin_tokens, fin_scores, jnp.int32(1))
    (_, out, scores, fin_tokens, fin_scores, _) = jax.lax.while_loop(
        cond, body, init
    )
    # Final selection: best retired hypothesis; fall back to the best
    # live beam (scored at full length) when it beats every retired one.
    denom = jnp.float32(t) ** length_penalty
    live_scores = scores / denom
    all_scores = jnp.concatenate([fin_scores, live_scores], axis=1)
    all_tokens = jnp.concatenate([fin_tokens, out], axis=1)
    best = jnp.argmax(all_scores, axis=1)
    seq = jnp.take_along_axis(
        all_tokens, best[:, None, None], axis=1
    )[:, 0]
    score = jnp.take_along_axis(all_scores, best[:, None], axis=1)[:, 0]
    return seq, score


def beam_generate(
    params: dict,
    cfg: ModelConfig,
    input_ids: jax.Array,
    max_new_tokens: int,
    num_beams: int = 4,
    eos_token_id: int | None = None,
    length_penalty: float = 1.0,
    cache_capacity: int | None = None,
    interpret: bool | None = None,
    mesh=None,
    return_scores: bool = False,
):
    """Compiled beam search. Returns [B, max_new_tokens] token ids
    (EOS-padded), optionally with per-row hypothesis scores
    (sum logprob / len^length_penalty). num_beams=1 degenerates to
    greedy decoding."""
    assert num_beams >= 1
    b, s = input_ids.shape
    k = num_beams
    if eos_token_id is None:
        # No EOS: hypotheses never retire; run to the budget and return
        # the best live beam. Encode as an unreachable token id.
        eos_token_id = cfg.vocab_size  # never produced by top_k over V
    if cache_capacity is None:
        cache_capacity = s + max_new_tokens + 1

    # Prefill once per row, then replicate rows to B*K beams.
    last_logits, cache = prefill(
        params, cfg, input_ids, cache_capacity, interpret=interpret,
        mesh=mesh,
    )
    lp = jax.nn.log_softmax(last_logits.astype(jnp.float32), axis=-1)
    first_scores, first_tokens = jax.lax.top_k(lp, k)  # [B, K]

    cache = dataclasses.replace(
        cache,
        k=jnp.repeat(cache.k, k, axis=1),
        v=jnp.repeat(cache.v, k, axis=1),
        lengths=jnp.repeat(cache.lengths, k, axis=0),
    )
    seq, score = _beam_loop(
        params, cfg, cache, first_scores,
        first_tokens.astype(jnp.int32), max_new_tokens, k,
        int(eos_token_id), float(length_penalty), interpret, mesh,
    )
    if return_scores:
        return seq, score
    return seq
