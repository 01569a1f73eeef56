"""Prompt-lookup (n-gram) speculative decoding — draft-free speculation.

Beyond the reference (per-token Python decode loop, reference:
scripts/benchmark_llm.py:65-92) and beyond the model-draft speculative
path (runtime/speculative.py): proposals come from matching the last
`ngram` generated tokens against the sequence's own history and copying
the continuation — no draft model, no draft cache, no extra forwards.
Wins on copy-heavy workloads (extraction, code edits, summarization with
quotes); on a miss the round still emits the target's bonus token, so
throughput never drops below one token per verify forward and outputs
remain EXACT (greedy) / distribution-exact (rejection sampling with a
one-hot proposal).

Device-side shape: the history ring is a fixed [B, cap] device buffer
updated in-scan; the n-gram match is a vectorized compare + argmax over
positions (no host round trips), and verification reuses the same
one-extend-per-round recurrence as the model-draft path.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from flash_attention_cute.models.config import ModelConfig
from flash_attention_cute.models.transformer import forward
from flash_attention_cute.runtime.generate import prefill
from flash_attention_cute.runtime.sampling import (
    SamplingParams,
    filter_logits,
)
from flash_attention_cute.runtime.speculative import (
    _accept_and_emit,
    _row_keys,
)


def ngram_propose(
    hist: jax.Array,  # [B, cap] int32 — tokens 0..hlen-1 valid
    hlen: jax.Array,  # [B] int32 — tokens valid in hist (incl. `cur`)
    gamma: int,
    ngram: int = 2,
) -> tuple[jax.Array, jax.Array]:
    """Most-recent n-gram continuation proposals.

    Matches the last `ngram` tokens of each row (hist[hlen-ngram:hlen])
    at every earlier position and proposes the `gamma` tokens following
    the MOST RECENT match. Returns (drafts [B, gamma], matched [B] bool);
    rows without a match propose their last token repeated (harmless —
    the verifier rejects wrong proposals for free).
    """
    b, cap = hist.shape
    pos = jnp.arange(cap, dtype=jnp.int32)[None, :]  # [1, cap]
    # Candidate match end positions j: hist[j-ngram+1 .. j] equals the
    # row's last ngram tokens, with the continuation starting at j+1
    # strictly before the suffix itself (j + 1 < hlen - ... the trivial
    # self-match at j == hlen-1 is excluded).
    ok = jnp.ones((b, cap), bool)
    for k in range(ngram):
        # suffix token at offset k from the end: hist[hlen-ngram+k]
        tgt = jnp.take_along_axis(
            hist, jnp.maximum(hlen[:, None] - ngram + k, 0), axis=1
        )  # [B, 1]
        idx = pos - (ngram - 1) + k  # position holding this suffix slot
        val = jnp.take_along_axis(
            hist, jnp.clip(idx, 0, cap - 1), axis=1
        )
        ok &= (val == tgt) & (idx >= 0)
    ok &= pos < (hlen[:, None] - 1)  # exclude the suffix's own match
    ok &= pos >= (ngram - 1)
    matched = jnp.any(ok, axis=1)
    # Most recent match: argmax over j * ok.
    j = jnp.max(jnp.where(ok, pos, -1), axis=1)  # [B], -1 = none
    start = jnp.where(matched, j + 1, 0)
    gidx = start[:, None] + jnp.arange(gamma, dtype=jnp.int32)[None, :]
    cont = jnp.take_along_axis(hist, jnp.clip(gidx, 0, cap - 1), axis=1)
    last = jnp.take_along_axis(
        hist, jnp.maximum(hlen[:, None] - 1, 0), axis=1
    )
    drafts = jnp.where(matched[:, None], cont, last)
    return drafts.astype(jnp.int32), matched


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "max_new_tokens", "gamma", "ngram", "eos_token_id",
        "interpret", "mesh", "sampling",
    ),
    donate_argnames=("t_cache", "hist"),
)
def _prompt_lookup_loop(
    params,
    cfg: ModelConfig,
    t_cache,
    hist: jax.Array,  # [B, cap] history buffer (prompt + cur scattered)
    hlen0: jax.Array,  # [B] valid history length (incl. cur)
    first_token: jax.Array,
    max_new_tokens: int,
    gamma: int,
    ngram: int,
    eos_token_id: int | None,
    interpret: bool | None,
    mesh=None,
    sampling: SamplingParams | None = None,
    seeds: jax.Array | None = None,
):
    b = first_token.shape[0]
    width = max_new_tokens + gamma + 1
    pad = eos_token_id if eos_token_id is not None else 0
    out = jnp.full((b, width), pad, jnp.int32)
    out = out.at[:, 0].set(first_token)
    out_pos = jnp.ones((b,), jnp.int32)
    iota = jnp.arange(gamma + 1, dtype=jnp.int32)

    if eos_token_id is not None:
        done0 = first_token == eos_token_id
    else:
        done0 = jnp.zeros((b,), jnp.bool_)

    def cond(carry):
        (_, _, _, done, _, out_pos, rounds, _) = carry
        alive = ~done & (out_pos < max_new_tokens)
        return jnp.any(alive) & (rounds < max_new_tokens)

    def body(carry):
        (t_cache, hist, hlen, done, out, out_pos, rounds,
         accepted_total) = carry
        alive = ~done & (out_pos < max_new_tokens)
        t_len = t_cache.lengths  # = hlen - 1 (cur not yet cached)
        cur = jnp.take_along_axis(
            hist, jnp.maximum(hlen[:, None] - 1, 0), axis=1
        )[:, 0].astype(jnp.int32)

        drafts, _ = ngram_propose(hist, hlen, gamma, ngram)

        # --- verify: one target extend over [cur, d_1..d_gamma] ---
        vchunk = jnp.concatenate([cur[:, None], drafts], axis=1)
        vlog, t_cache = forward(
            params, cfg, vchunk, cache=t_cache, mode="extend",
            interpret=interpret, mesh=mesh,
        )
        padded = jnp.concatenate([drafts, jnp.zeros((b, 1), jnp.int32)],
                                 axis=1)
        if sampling is None:
            tgt_pred = jnp.argmax(vlog, axis=-1).astype(jnp.int32)
            match = tgt_pred[:, :gamma] == drafts
            n = jnp.sum(jnp.cumprod(match.astype(jnp.int32), axis=1),
                        axis=1)
            bonus = jnp.take_along_axis(tgt_pred, n[:, None], axis=1)[:, 0]
            e = jnp.where(iota[None, :] == n[:, None], bonus[:, None],
                          padded)
        else:
            # A deterministic proposal is a one-hot q: accept d_i iff
            # u <= p_i(d_i); residual = norm(max(p - onehot(d), 0)).
            tprobs = jax.nn.softmax(filter_logits(vlog, sampling), axis=-1)
            qprobs = jax.nn.one_hot(
                drafts, vlog.shape[-1], dtype=tprobs.dtype
            )
            u = jax.vmap(lambda k_: jax.random.uniform(k_, (gamma,)))(
                _row_keys(seeds, out_pos, 1)
            )
            n, e = _accept_and_emit(
                tprobs, qprobs, drafts, u, _row_keys(seeds, out_pos, 2)
            )

        if eos_token_id is not None:
            is_eos = (e == eos_token_id) & (iota[None, :] <= n[:, None])
            has_eos = jnp.any(is_eos, axis=1)
            first_eos = jnp.argmax(is_eos, axis=1).astype(jnp.int32)
            n_eff = jnp.where(has_eos, first_eos, n)
            done_new = done | (alive & has_eos)
        else:
            n_eff = n
            done_new = done

        mask = (iota[None, :] <= n_eff[:, None]) & alive[:, None]

        def write_row(row, pos0, e_row, m_row):
            idx = pos0 + iota
            vals = jnp.where(m_row, e_row, row[jnp.clip(idx, 0,
                                                        row.shape[0] - 1)])
            return row.at[jnp.clip(idx, 0, row.shape[0] - 1)].set(vals)

        out = jax.vmap(write_row)(out, out_pos, e, mask)
        # History grows by the same emitted tokens (positions hlen..).
        hist = jax.vmap(write_row)(hist, hlen, e, mask)

        count = n_eff + 1
        out_pos = jnp.where(alive, out_pos + count, out_pos)
        hlen = jnp.where(alive, hlen + count, hlen)
        t_cache = dataclasses.replace(
            t_cache, lengths=jnp.where(alive, t_len + count, t_len)
        )
        accepted_total = accepted_total + jnp.sum(
            jnp.where(alive, n_eff, 0)
        )
        return (t_cache, hist, hlen, done_new, out, out_pos, rounds + 1,
                accepted_total)

    init = (t_cache, hist, hlen0, done0, out, out_pos, jnp.int32(0),
            jnp.int32(0))
    (_, _, _, _, out, _, rounds, accepted) = jax.lax.while_loop(
        cond, body, init
    )
    return out[:, :max_new_tokens], rounds, accepted


def prompt_lookup_generate(
    params: dict,
    cfg: ModelConfig,
    input_ids: jax.Array,
    max_new_tokens: int,
    gamma: int = 4,
    ngram: int = 2,
    eos_token_id: int | None = None,
    cache_capacity: int | None = None,
    interpret: bool | None = None,
    mesh=None,
    return_stats: bool = False,
    sampling: SamplingParams | None = None,
    seed: int = 0,
):
    """Draft-free speculative generation via prompt n-gram lookup.

    Greedy: bit-identical to `greedy_generate`. Sampled (temp > 0):
    rejection sampling against a one-hot proposal — every emitted
    token's marginal is exactly the target's filtered distribution.
    """
    assert gamma >= 1 and ngram >= 1
    if sampling is not None and sampling.temperature <= 0.0:
        sampling = None
    b, s = input_ids.shape
    if cache_capacity is None:
        cache_capacity = s + max_new_tokens + gamma + 2
    last_logits, t_cache = prefill(
        params, cfg, input_ids, cache_capacity, interpret=interpret,
        mesh=mesh,
    )
    seeds = (seed * 1_000_003 + jnp.arange(b, dtype=jnp.int32)) & 0x7FFFFFFF
    if sampling is None:
        first = jnp.argmax(last_logits, axis=-1).astype(jnp.int32)
    else:
        f0 = filter_logits(last_logits, sampling)
        first = jax.vmap(
            lambda k_, lg: jax.random.categorical(k_, lg)
        )(_row_keys(seeds, jnp.zeros((b,), jnp.int32), 2), f0).astype(
            jnp.int32
        )
    if max_new_tokens == 1:
        tokens = first[:, None]
        return (tokens, {"rounds": 0, "accepted_drafts": 0}) \
            if return_stats else tokens

    cap = s + max_new_tokens + gamma + 2
    hist = jnp.zeros((b, cap), jnp.int32)
    hist = hist.at[:, :s].set(input_ids.astype(jnp.int32))
    hist = hist.at[:, s].set(first)  # cur at index hlen-1
    hlen0 = jnp.full((b,), s + 1, jnp.int32)

    tokens, rounds, accepted = _prompt_lookup_loop(
        params, cfg, t_cache, hist, hlen0, first, max_new_tokens, gamma,
        ngram, eos_token_id, interpret, mesh, sampling=sampling,
        seeds=seeds,
    )
    if return_stats:
        return tokens, {
            "rounds": int(rounds), "accepted_drafts": int(accepted)
        }
    return tokens
