"""Speculative decoding (draft / verify): exact greedy outputs, and
rejection-sampling for temperature > 0 (every emitted token's marginal
is exactly the target's filtered sampling distribution, for any draft).

Beyond the reference (whose decode is a per-token Python loop,
reference: scripts/benchmark_llm.py:65-92): a small draft model proposes
`gamma` tokens per round; the target model scores all of them in ONE
chunked-extend forward (the same masked dense route that serves
chunked admission), accepts the longest matching prefix, and emits one
bonus token from its own argmax — every round advances 1..gamma+1
tokens for a single target forward. The output is bit-identical to
`greedy_generate` for ANY draft model; the draft only controls speed.

Design:
  * Per-row ragged acceptance rides the caches' [B] length scalars —
    rollback is `lengths = L + n + 1`, no data movement, and every
    phase (draft-extend / draft-decode / verify-extend) stays one
    compiled program at any fill level.
  * The generation loop is a single jitted `lax.while_loop`: no host
    round trip per round.
  * Each round the draft re-extends the 2-token chunk
    [previous_token, bonus]: rewriting an already-cached token's KV is
    idempotent, which uniformly covers the all-accepted case where the
    draft cache is missing the last draft token's KV.
  * Finished rows freeze their lengths (writes beyond a frozen row's
    valid prefix land in cache slack and stay invisible), so mixed
    completion never grows a finished row's cache.
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


def _row_keys(seeds: jax.Array, pos: jax.Array, stream: int) -> jax.Array:
    """Per-row PRNG keys from (request seed, absolute output position,
    stream id). Position-keyed randomness makes preemption-recompute and
    chunk-boundary replay draw the SAME values. Streams: 0 = draft
    proposal, 1 = acceptance uniform, 2 = residual/bonus sample."""
    def one(s, p):
        k = jax.random.fold_in(jax.random.key(0), s)
        k = jax.random.fold_in(k, p)
        return jax.random.fold_in(k, stream)

    return jax.vmap(one)(seeds, jnp.broadcast_to(pos, seeds.shape))


def _accept_and_emit(tprobs, qprobs, drafts, u, resid_keys):
    """Rejection-sampling acceptance (Leviathan/Chen speculative
    sampling): accept draft d_i with prob min(1, p_i(d_i)/q_i(d_i)); at
    the first rejection n, emit a sample from norm(max(p_n - q_n, 0));
    when all gamma drafts are accepted, emit the bonus from p_gamma. The
    emitted prefix's marginal distribution is EXACTLY p — the target's
    own sampling distribution — for any proposal q.

    tprobs [B, gamma+1, V] and qprobs [B, gamma, V] are the FILTERED
    (temperature/top-k/top-p) distributions; drafts [B, gamma] were
    sampled from qprobs; u [B, gamma] uniforms. Returns (n [B], e [B,
    gamma+1]) with e_i = d_{i+1} for i < n and e_n the round's final
    token; entries past n hold the (unused) draft padding."""
    b, gamma = drafts.shape
    iota = jnp.arange(gamma + 1, dtype=jnp.int32)
    p_d = jnp.take_along_axis(
        tprobs[:, :gamma], drafts[..., None], axis=2
    )[..., 0]
    q_d = jnp.take_along_axis(qprobs, drafts[..., None], axis=2)[..., 0]
    accept = u * q_d <= p_d
    n = jnp.sum(jnp.cumprod(accept.astype(jnp.int32), axis=1), axis=1)
    qext = jnp.concatenate(
        [qprobs, jnp.zeros_like(qprobs[:, :1])], axis=1
    )  # residual at n == gamma degenerates to the bonus draw from p_gamma
    p_n = jnp.take_along_axis(tprobs, n[:, None, None], axis=1)[:, 0]
    q_n = jnp.take_along_axis(qext, n[:, None, None], axis=1)[:, 0]
    res = jnp.maximum(p_n - q_n, 0.0)
    rs = jnp.sum(res, axis=-1, keepdims=True)
    # rs == 0 is impossible in exact arithmetic after a rejection; under
    # fp rounding fall back to p_n (noise-level deviation only).
    dist = jnp.where(rs > 0, res / jnp.maximum(rs, 1e-30), p_n)
    tok_n = jax.vmap(
        lambda d_, k_: jax.random.categorical(k_, jnp.log(d_))
    )(dist, resid_keys).astype(jnp.int32)
    padded = jnp.concatenate([drafts, jnp.zeros((b, 1), jnp.int32)], axis=1)
    e = jnp.where(iota[None, :] == n[:, None], tok_n[:, None], padded)
    return n, e


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "draft_cfg", "max_new_tokens", "gamma", "eos_token_id",
        "interpret", "mesh", "sampling",
    ),
    donate_argnames=("t_cache", "d_cache"),
)
def _speculative_loop(
    params,
    draft_params,
    cfg: ModelConfig,
    draft_cfg: ModelConfig,
    t_cache,
    d_cache,
    first_token: jax.Array,  # [B] int32 — target's first greedy token
    prev_token: jax.Array,  # [B] int32 — last prompt token
    max_new_tokens: int,
    gamma: int,
    eos_token_id: int | None,
    interpret: bool | None,
    mesh=None,
    sampling: SamplingParams | None = None,  # temp > 0: rejection sampling
    seeds: jax.Array | None = None,  # [B] int32 per-row sampling seeds
):
    b = first_token.shape[0]
    width = max_new_tokens + gamma + 1  # scatter slack: rounds overshoot
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
        (_, _, _, _, done, _, out_pos, rounds, _) = carry
        alive = ~done & (out_pos < max_new_tokens)
        return jnp.any(alive) & (rounds < max_new_tokens)

    def body(carry):
        (t_cache, d_cache, cur, prev, done, out, out_pos, rounds,
         accepted_total) = carry
        alive = ~done & (out_pos < max_new_tokens)
        t_len = t_cache.lengths  # L: tokens 0..L-1 cached; cur = token L
        d_len = d_cache.lengths  # L-1 by invariant

        # --- draft: 2-token extend [prev, cur], then gamma-1 decodes ---
        chunk2 = jnp.stack([prev, cur], axis=1)
        dlog, d_cache = forward(
            draft_params, draft_cfg, chunk2, cache=d_cache, mode="extend",
            interpret=interpret, mesh=mesh,
        )
        if sampling is None:
            d1 = jnp.argmax(dlog[:, 1], axis=-1).astype(jnp.int32)
        else:
            f1 = filter_logits(dlog[:, 1], sampling)  # [B, V]
            d1 = jax.vmap(
                lambda k_, lg: jax.random.categorical(k_, lg)
            )(_row_keys(seeds, out_pos, 0), f1).astype(jnp.int32)

        def draft_step(carry, i):
            d_cache, tok = carry
            lg, d_cache = forward(
                draft_params, draft_cfg, tok[:, None], cache=d_cache,
                mode="decode", interpret=interpret, mesh=mesh,
            )
            if sampling is None:
                nxt = jnp.argmax(lg[:, 0], axis=-1).astype(jnp.int32)
                return (d_cache, nxt), nxt
            fl = filter_logits(lg[:, 0], sampling)
            nxt = jax.vmap(
                lambda k_, lg_: jax.random.categorical(k_, lg_)
            )(_row_keys(seeds, out_pos + 1 + i, 0), fl).astype(jnp.int32)
            return (d_cache, nxt), (nxt, fl)

        (d_cache, _), rest = jax.lax.scan(
            draft_step, (d_cache, d1), jnp.arange(gamma - 1, dtype=jnp.int32)
        )
        if sampling is None:
            drafts = jnp.concatenate(
                [d1[:, None], rest.T.reshape(b, gamma - 1)], axis=1
            )  # [B, gamma] = d_1..d_gamma
        else:
            rest_tok, rest_fl = rest
            drafts = jnp.concatenate(
                [d1[:, None], rest_tok.T.reshape(b, gamma - 1)], axis=1
            )
            # Filtered proposal distributions for every draft position.
            qprobs = jax.nn.softmax(
                jnp.concatenate(
                    [f1[:, None], jnp.moveaxis(rest_fl, 0, 1)], axis=1
                ),
                axis=-1,
            )  # [B, gamma, V]

        # --- verify: one target extend over [cur, d_1..d_gamma] ---
        vchunk = jnp.concatenate([cur[:, None], drafts], axis=1)
        vlog, t_cache = forward(
            params, cfg, vchunk, cache=t_cache, mode="extend",
            interpret=interpret, mesh=mesh,
        )
        padded = jnp.concatenate(
            [drafts, jnp.zeros((b, 1), jnp.int32)], axis=1
        )
        if sampling is None:
            tgt_pred = jnp.argmax(vlog, axis=-1).astype(jnp.int32)  # [B,g+1]

            # Longest matching prefix: n in [0, gamma]; bonus at n.
            match = tgt_pred[:, :gamma] == drafts
            n = jnp.sum(jnp.cumprod(match.astype(jnp.int32), axis=1), axis=1)
            bonus = jnp.take_along_axis(tgt_pred, n[:, None], axis=1)[:, 0]

            # Emitted this round: e_i = d_{i+1} for i < n, e_n = bonus.
            e = jnp.where(
                iota[None, :] == n[:, None], bonus[:, None], padded
            )
        else:
            tprobs = jax.nn.softmax(filter_logits(vlog, sampling), axis=-1)
            u = jax.vmap(lambda k_: jax.random.uniform(k_, (gamma,)))(
                _row_keys(seeds, out_pos, 1)
            )
            n, e = _accept_and_emit(
                tprobs, qprobs, drafts, u, _row_keys(seeds, out_pos, 2)
            )

        # EOS truncation inside the round.
        if eos_token_id is not None:
            is_eos = (e == eos_token_id) & (iota[None, :] <= n[:, None])
            has_eos = jnp.any(is_eos, axis=1)
            first_eos = jnp.argmax(is_eos, axis=1).astype(jnp.int32)
            n_eff = jnp.where(has_eos, first_eos, n)
            done_new = done | (alive & has_eos)
        else:
            n_eff = n
            done_new = done

        # Scatter the emitted prefix into the output buffer. Blending
        # gathered values back for masked slots makes even clamped
        # out-of-bounds indices a no-op.
        mask = (iota[None, :] <= n_eff[:, None]) & alive[:, None]

        def write_row(row, pos0, e_row, m_row):
            idx = pos0 + iota
            vals = jnp.where(m_row, e_row, row[idx])
            return row.at[idx].set(vals)

        out = jax.vmap(write_row)(out, out_pos, e, mask)

        count = n_eff + 1
        out_pos = jnp.where(alive, out_pos + count, out_pos)
        # Rollback: target keeps cur..d_n (n+1 tokens), draft one fewer.
        new_L = t_len + count
        t_cache = dataclasses.replace(
            t_cache, lengths=jnp.where(alive, new_L, t_len)
        )
        d_cache = dataclasses.replace(
            d_cache, lengths=jnp.where(alive, new_L - 1, d_len)
        )
        # Next round: cur' = bonus-or-eos tail token; prev' = token before.
        last = jnp.take_along_axis(e, n_eff[:, None], axis=1)[:, 0]
        before = jnp.where(
            n_eff > 0,
            jnp.take_along_axis(
                padded, jnp.maximum(n_eff - 1, 0)[:, None], axis=1
            )[:, 0],
            cur,
        )
        cur = jnp.where(alive, last, cur)
        prev = jnp.where(alive, before, prev)
        accepted_total = accepted_total + jnp.sum(
            jnp.where(alive, n_eff, 0)
        )
        return (t_cache, d_cache, cur, prev, done_new, out, out_pos,
                rounds + 1, accepted_total)

    init = (t_cache, d_cache, first_token, prev_token, done0, out, out_pos,
            jnp.int32(0), jnp.int32(0))
    (_, _, _, _, _, out, _, rounds, accepted) = jax.lax.while_loop(
        cond, body, init
    )
    return out[:, :max_new_tokens], rounds, accepted


def speculative_generate(
    params: dict,
    cfg: ModelConfig,
    draft_params: dict,
    draft_cfg: ModelConfig,
    input_ids: jax.Array,
    max_new_tokens: int,
    gamma: int = 4,
    eos_token_id: int | None = None,
    cache_capacity: int | None = None,
    interpret: bool | None = None,
    mesh=None,
    return_stats: bool = False,
    sampling: SamplingParams | None = None,
    seed: int = 0,
):
    """Generation accelerated by a draft model.

    Greedy (sampling=None or temperature<=0): returns [B,
    max_new_tokens] token ids bit-identical to `greedy_generate(params,
    cfg, ...)` regardless of the draft.

    Sampled (temperature>0): REJECTION-SAMPLING speculative decoding —
    drafts are proposed from the draft's filtered distribution and
    accepted with prob min(1, p/q), so every emitted token's marginal is
    exactly the target's own (temperature/top-k/top-p filtered) sampling
    distribution for any draft; the draft only controls speed. All
    randomness is keyed by (seed, row, absolute position, stream), so a
    given seed replays the identical stream.

    With `return_stats=True` returns `(tokens, {"rounds",
    "accepted_drafts"})` (acceptance rate = accepted / (rounds*gamma)).
    """
    assert gamma >= 1, gamma
    assert cfg.vocab_size == draft_cfg.vocab_size, (
        "draft and target must share a vocabulary"
    )
    if sampling is not None and sampling.temperature <= 0.0:
        sampling = None
    b, s = input_ids.shape
    if cache_capacity is None:
        cache_capacity = s + max_new_tokens + gamma + 2
    last_logits, t_cache = prefill(
        params, cfg, input_ids, cache_capacity, interpret=interpret,
        mesh=mesh,
    )
    _, d_cache = prefill(
        draft_params, draft_cfg, input_ids, cache_capacity,
        interpret=interpret, mesh=mesh,
    )
    # Invariant: draft length = target length - 1 (the draft re-extends
    # the last cached token together with the bonus each round).
    d_cache = dataclasses.replace(d_cache, lengths=d_cache.lengths - 1)
    seeds = (seed * 1_000_003 + jnp.arange(b, dtype=jnp.int32)) & 0x7FFFFFFF
    if sampling is None:
        first = jnp.argmax(last_logits, axis=-1).astype(jnp.int32)
    else:
        # First token = output position 0, stream 2 (the "final token of
        # its round" stream — positions >= 1 come from the loop).
        f0 = filter_logits(last_logits, sampling)
        first = jax.vmap(
            lambda k_, lg: jax.random.categorical(k_, lg)
        )(_row_keys(seeds, jnp.zeros((b,), jnp.int32), 2), f0).astype(
            jnp.int32
        )
    if max_new_tokens == 1:
        tokens = first[:, None]
        return (tokens, {"rounds": 0, "accepted_drafts": 0}) if return_stats \
            else tokens
    tokens, rounds, accepted = _speculative_loop(
        params, draft_params, cfg, draft_cfg, t_cache, d_cache,
        first, input_ids[:, -1].astype(jnp.int32),
        max_new_tokens, gamma, eos_token_id, interpret, mesh,
        sampling=sampling, seeds=seeds,
    )
    if return_stats:
        return tokens, {
            "rounds": int(rounds), "accepted_drafts": int(accepted)
        }
    return tokens
