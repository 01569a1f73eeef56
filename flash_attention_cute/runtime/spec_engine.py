"""Engine-level speculative decoding over paged KV caches.

Composes `runtime/speculative.py`'s draft/verify recurrence with the
continuous-batching `ServingEngine` (runtime/engine.py): every decode
round, a small draft model proposes `gamma` tokens per slot from its own
paged cache, the target scores all of them in ONE paged-extend forward
(the same gather + dense route that serves chunked admission), and the
longest matching prefix plus one bonus token is accepted per slot —
1..gamma+1 tokens per slot per target forward, bit-identical to the
plain greedy engine for ANY draft model (the reference's decode is a
per-token Python loop, reference: scripts/benchmark_llm.py:65-92; it has
no serving engine and no speculative path at all).

Design:
  * The draft cache is a second page pool with the SAME page table as
    the target's (one host-side allocator drives both); per-slot ragged
    acceptance is a pure length-scalar update — no data movement, one
    compiled program at any fill level.
  * `rounds_per_call` spec rounds run inside one jitted `lax.scan`
    (multi-step scheduling): host round trips amortize across rounds
    exactly like the plain engine's `decode_chunk`.
  * Slots freeze in-scan at EOS or token budget via per-row done flags;
    frozen rows re-scatter idempotent KV inside the scan and their
    lengths are restored each round, so mixed completion never grows a
    finished row's cache.
  * Page coverage is reserved to the round-span high-water mark BEFORE
    the scan (the allocator's token count tracks *covered* positions,
    not emitted tokens); rejected drafts simply leave covered pages to
    be rewritten by the next round. Size pools for
    `prompt + max_new_tokens + gamma` tokens per sequence.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from flash_attention_cute.models.config import ModelConfig
from flash_attention_cute.runtime.engine import ServingEngine, _bucket
from flash_attention_cute.runtime.paged_cache import create_paged_state
from flash_attention_cute.runtime.paged_forward import forward_paged
from flash_attention_cute.runtime.sampling import (
    SamplingParams,
    apply_penalties,
    filter_logits,
)
from flash_attention_cute.runtime.prompt_lookup import ngram_propose
from flash_attention_cute.runtime.speculative import (
    _accept_and_emit,
    _row_keys,
)


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "draft_cfg", "gamma", "rounds", "eos_token_id", "interpret",
        "mesh", "sampling", "want_logprobs",
    ),
    donate_argnames=("t_state", "d_state"),
)
def _spec_rounds(
    params,
    draft_params,
    cfg: ModelConfig,
    draft_cfg: ModelConfig,
    t_state,
    d_state,
    cur: jax.Array,  # [slots] int32 — last emitted token (not yet cached)
    prev: jax.Array,  # [slots] int32 — token before `cur`
    active: jax.Array,  # [slots] bool — slot holds a decoding request
    budget: jax.Array,  # [slots] int32 — remaining token budget per slot
    gamma: int,
    rounds: int,
    eos_token_id: int | None,
    interpret: bool | None,
    mesh=None,
    sampling: SamplingParams | None = None,  # temp > 0: rejection sampling
    seeds: jax.Array | None = None,  # [slots] per-request sampling seeds
    positions0: jax.Array | None = None,  # [slots] generated-count at entry
    bias: jax.Array | None = None,  # [slots, V] guided-decoding logit bias
    min_tokens: jax.Array | None = None,  # [slots] EOS banned below this
    lora: dict | None = None,  # multi-LoRA adapters — applied to the
    # TARGET verify forward only (drafts stay base-model; proposals never
    # affect outputs, only acceptance)
    adapter_ids: jax.Array | None = None,

    dfa: dict | None = None,  # shared decoding automaton (structured
    # output): per-position masks walk the DRAFT prefix in-scan, so
    # acceptance is exact vs the constrained plain engine
    dfa_state0: jax.Array | None = None,  # [slots] entry states
    constrain: jax.Array | None = None,  # [slots] bool opt-in
    pen: dict | None = None,  # sampling penalties ({"prompt"/"out"
    # [slots, V] counts, "rep"/"pres"/"freq" [slots]}): verify logits at
    # position i are penalized with the entry counts advanced by draft
    # tokens d_1..d_i (the DFA-walk pattern), so acceptance is exact vs
    # the penalized plain engine; draft proposals are penalized the same
    # way (any proposal stays correct — this just raises acceptance);
    # accepted emissions advance the counts between rounds in-scan
    want_logprobs: bool = False,  # also return per-emitted-token TARGET
    # logprobs [slots, rounds*(gamma+1)] (greedy: log-softmax of the
    # shaped verify logits; sampled: of the filtered target distribution
    # — the residual-sampled bonus token reports its target logprob too,
    # the vLLM convention)
):
    """Run `rounds` draft/verify rounds for every active slot.

    Returns (out [slots, rounds*(gamma+1)], out_pos [slots], t_state,
    d_state, accepted_total). Cache invariant on entry and exit: the
    target cache holds tokens 0..L-1 with `cur` = token L; the draft
    cache holds 0..L-2 (lengths L-1). Rows that hit EOS or budget freeze:
    their lengths stop advancing and later rounds' scatters are
    idempotent rewrites inside already-covered pages.
    """
    slots = cur.shape[0]
    width = rounds * (gamma + 1)
    pad = eos_token_id if eos_token_id is not None else 0
    out = jnp.full((slots, width), pad, jnp.int32)
    out_lp = jnp.zeros((slots, width), jnp.float32)
    out_pos = jnp.zeros((slots,), jnp.int32)
    iota = jnp.arange(gamma + 1, dtype=jnp.int32)
    done0 = ~active

    # Extend-mode forwards scatter for EVERY row (no per-row masking), and
    # an inactive slot can hold a REAL page table mid chunked-admission —
    # its dummy scatters would corrupt the prompt KV at positions 0..gamma.
    # Route inactive rows to the null page for the scan's duration and
    # restore the real tables on return.
    t_tbl, d_tbl = t_state.page_table, d_state.page_table
    t_state = dataclasses.replace(
        t_state, page_table=jnp.where(active[:, None], t_tbl, 0)
    )
    d_state = dataclasses.replace(
        d_state, page_table=jnp.where(active[:, None], d_tbl, 0)
    )

    V = None if pen is None else pen["prompt"].shape[-1]

    def _pen1(lg, outc):
        """Penalize one [slots, V] logits row with output counts `outc`."""
        return apply_penalties(
            lg, pen["prompt"], outc, pen["rep"], pen["pres"], pen["freq"]
        )

    def body(carry, _):
        (t_state, d_state, cur, prev, done, out, out_lp, out_pos,
         accepted_total, dstate, out_counts) = carry
        alive = ~done & (out_pos < budget)
        t_len = t_state.lengths
        d_len = d_state.lengths

        # --- draft: 2-token extend [prev, cur], then gamma-1 decodes ---
        # Re-extending the already-cached `prev` is an idempotent page
        # rewrite; it uniformly covers the all-accepted case where the
        # draft cache is missing the last draft token's KV.
        abs_pos = None if sampling is None else positions0 + out_pos
        chunk2 = jnp.stack([prev, cur], axis=1)
        dlog, d_state = forward_paged(
            draft_params, draft_cfg, chunk2, d_state, mode="extend",
            interpret=interpret, mesh=mesh,
        )
        dl1 = dlog[:, 1] if pen is None else _pen1(dlog[:, 1], out_counts)
        if sampling is None:
            d1 = jnp.argmax(dl1, axis=-1).astype(jnp.int32)
        else:
            f1 = filter_logits(dl1, sampling)
            d1 = jax.vmap(
                lambda k_, lg: jax.random.categorical(k_, lg)
            )(_row_keys(seeds, abs_pos, 0), f1).astype(jnp.int32)

        def draft_step(carry, i):
            d_state, tok, dcounts = carry
            lg, d_state = forward_paged(
                draft_params, draft_cfg, tok[:, None], d_state,
                mode="decode", interpret=interpret, mesh=mesh,
            )
            lg0 = lg[:, 0] if pen is None else _pen1(lg[:, 0], dcounts)
            if sampling is None:
                nxt = jnp.argmax(lg0, axis=-1).astype(jnp.int32)
                res = nxt
            else:
                fl = filter_logits(lg0, sampling)
                nxt = jax.vmap(
                    lambda k_, lg_: jax.random.categorical(k_, lg_)
                )(_row_keys(seeds, abs_pos + 1 + i, 0), fl).astype(jnp.int32)
                res = (nxt, fl)
            if pen is not None:
                dcounts = dcounts.at[
                    jnp.arange(dcounts.shape[0]), nxt
                ].add(1.0)
            return (d_state, nxt, dcounts), res

        dcounts0 = (
            jnp.int32(0) if pen is None
            else out_counts.at[jnp.arange(slots), d1].add(1.0)
        )
        (d_state, _, _), rest = jax.lax.scan(
            draft_step, (d_state, d1, dcounts0),
            jnp.arange(gamma - 1, dtype=jnp.int32),
        )
        if sampling is None:
            drafts = jnp.concatenate(
                [d1[:, None], rest.T.reshape(slots, gamma - 1)], axis=1
            )  # [slots, gamma]
        else:
            rest_tok, rest_fl = rest
            drafts = jnp.concatenate(
                [d1[:, None], rest_tok.T.reshape(slots, gamma - 1)], axis=1
            )
            qprobs = jax.nn.softmax(
                jnp.concatenate(
                    [f1[:, None], jnp.moveaxis(rest_fl, 0, 1)], axis=1
                ),
                axis=-1,
            )  # [slots, gamma, V]

        # --- verify: one target paged-extend over [cur, d_1..d_gamma] ---
        vchunk = jnp.concatenate([cur[:, None], drafts], axis=1)
        vlog, t_state = forward_paged(
            params, cfg, vchunk, t_state, mode="extend",
            interpret=interpret, mesh=mesh, lora=lora,
            adapter_ids=adapter_ids,
        )
        if pen is not None:
            # Counts before verify position i = entry counts advanced by
            # draft tokens d_1..d_i — exactly what the penalized plain
            # engine sees while the drafts keep matching (the DFA-walk
            # argument), so greedy spec stays bit-exact and sampled spec
            # targets the penalized distributions.
            cum = jnp.cumsum(
                jax.nn.one_hot(drafts, V, dtype=jnp.float32), axis=1
            )  # [slots, gamma, V]
            vcounts = out_counts[:, None, :] + jnp.concatenate(
                [jnp.zeros_like(cum[:, :1]), cum], axis=1
            )  # [slots, gamma+1, V]
            vlog = apply_penalties(
                vlog, pen["prompt"][:, None, :], vcounts,
                pen["rep"][:, None], pen["pres"][:, None],
                pen["freq"][:, None],
            )
        if bias is not None:
            vlog = vlog + bias[:, None, :]
        if min_tokens is not None and eos_token_id is not None:
            # Emitted position of verify index i is positions0+out_pos+i.
            early = (
                (positions0 + out_pos)[:, None] + iota + 1
            ) < min_tokens[:, None]
            vlog = vlog.at[:, :, eos_token_id].add(
                jnp.where(early, -jnp.inf, 0.0)
            )
        if dfa is not None:
            # Walk the automaton along the DRAFT prefix: the state before
            # verify position i is the entry state advanced by d_1..d_i —
            # identical to what the plain constrained engine would see
            # while the drafts keep matching.
            def walk(st, d_col):
                nxt = jnp.where(
                    constrain, dfa["transitions"][st, d_col], st
                )
                return nxt, st
            st_last, st_seq = jax.lax.scan(walk, dstate, drafts.T)
            st_all = jnp.concatenate(
                [jnp.moveaxis(st_seq, 0, 1), st_last[:, None]], axis=1
            )  # [slots, gamma+1]
            vlog = vlog + jnp.where(
                constrain[:, None, None], dfa["bias"][st_all], 0.0
            )
        padded = jnp.concatenate(
            [drafts, jnp.zeros((slots, 1), jnp.int32)], axis=1
        )
        if sampling is None:
            tgt_pred = jnp.argmax(vlog, axis=-1).astype(jnp.int32)

            # Longest matching prefix n in [0, gamma]; bonus at n.
            match = tgt_pred[:, :gamma] == drafts
            n = jnp.sum(
                jnp.cumprod(match.astype(jnp.int32), axis=1), axis=1
            )
            bonus = jnp.take_along_axis(tgt_pred, n[:, None], axis=1)[:, 0]
            e = jnp.where(
                iota[None, :] == n[:, None], bonus[:, None], padded
            )
        else:
            tprobs = jax.nn.softmax(filter_logits(vlog, sampling), axis=-1)
            u = jax.vmap(lambda k_: jax.random.uniform(k_, (gamma,)))(
                _row_keys(seeds, abs_pos, 1)
            )
            n, e = _accept_and_emit(
                tprobs, qprobs, drafts, u, _row_keys(seeds, abs_pos, 2)
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
            vals = jnp.where(m_row, e_row, row[idx])
            return row.at[idx].set(vals)

        out = jax.vmap(write_row)(out, out_pos, e, mask)
        if want_logprobs:
            vlp = jax.nn.log_softmax(
                vlog if sampling is None else filter_logits(vlog, sampling),
                axis=-1,
            )
            lp_e = jnp.take_along_axis(vlp, e[..., None], axis=2)[..., 0]
            out_lp = jax.vmap(write_row)(
                out_lp, out_pos, lp_e.astype(jnp.float32), mask
            )

        count = n_eff + 1
        out_pos = jnp.where(alive, out_pos + count, out_pos)
        # Ragged acceptance = pure length-scalar rollback; frozen rows
        # restore their entry lengths (their in-round scatters become
        # invisible stale data inside covered pages).
        t_state = dataclasses.replace(
            t_state, lengths=jnp.where(alive, t_len + count, t_len)
        )
        d_state = dataclasses.replace(
            d_state, lengths=jnp.where(alive, t_len + count - 1, d_len)
        )
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
        if dfa is not None:
            def adv(st, i):
                tok = e[:, i]
                take = (iota[i] <= n_eff) & alive & constrain
                nxt = jnp.where(take, dfa["transitions"][st, tok], st)
                return nxt, None
            dstate, _ = jax.lax.scan(
                adv, dstate, jnp.arange(gamma + 1)
            )
        if pen is not None:
            out_counts = out_counts + jnp.sum(
                jax.nn.one_hot(e, V, dtype=jnp.float32)
                * mask[..., None],
                axis=1,
            )
        return (t_state, d_state, cur, prev, done_new, out, out_lp,
                out_pos, accepted_total, dstate, out_counts), None

    dstate0 = (
        dfa_state0 if dfa_state0 is not None else jnp.zeros_like(out_pos)
    )
    outc0 = pen["out"] if pen is not None else jnp.int32(0)
    init = (t_state, d_state, cur, prev, done0, out, out_lp, out_pos,
            jnp.int32(0), dstate0, outc0)
    (t_state, d_state, _, _, _, out, out_lp, out_pos, accepted, _, _), _ = (
        jax.lax.scan(body, init, None, length=rounds)
    )
    t_state = dataclasses.replace(t_state, page_table=t_tbl)
    d_state = dataclasses.replace(d_state, page_table=d_tbl)
    return out, out_lp, out_pos, t_state, d_state, accepted


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "gamma", "rounds", "ngram", "eos_token_id", "interpret",
        "mesh", "sampling", "want_logprobs",
    ),
    donate_argnames=("t_state",),
)
def _spec_rounds_lookup(
    params,
    cfg: ModelConfig,
    t_state,
    hist: jax.Array,  # [slots, cap] history (prompt + generated incl cur)
    hlen: jax.Array,  # [slots] valid history length
    active: jax.Array,
    budget: jax.Array,
    gamma: int,
    rounds: int,
    ngram: int,
    eos_token_id: int | None,
    interpret: bool | None,
    mesh=None,
    sampling=None,
    seeds: jax.Array | None = None,
    positions0: jax.Array | None = None,
    bias: jax.Array | None = None,
    min_tokens: jax.Array | None = None,
    lora: dict | None = None,
    adapter_ids: jax.Array | None = None,

    dfa: dict | None = None,  # shared decoding automaton (structured
    # output): per-position masks walk the DRAFT prefix in-scan, so
    # acceptance is exact vs the constrained plain engine
    dfa_state0: jax.Array | None = None,  # [slots] entry states
    constrain: jax.Array | None = None,  # [slots] bool opt-in
    pen: dict | None = None,  # sampling penalties — verify logits walk
    # the proposal prefix exactly as in _spec_rounds (n-gram proposals
    # themselves are history copies, not distributions: nothing to
    # penalize on the proposal side)
    want_logprobs: bool = False,  # also return per-emitted-token target
    # logprobs [slots, rounds*(gamma+1)] (same definition as _spec_rounds)
):
    """Draft-free (prompt-lookup) variant of _spec_rounds: proposals come
    from the history buffer's most recent n-gram continuation; no draft
    model, no draft pool — one verify extend per round is the ONLY
    forward. Cache invariant: t_state holds tokens 0..L-1 with the
    history's last token (hist[hlen-1]) = token L."""
    slots = hlen.shape[0]
    width = rounds * (gamma + 1)
    pad = eos_token_id if eos_token_id is not None else 0
    out = jnp.full((slots, width), pad, jnp.int32)
    out_lp = jnp.zeros((slots, width), jnp.float32)
    out_pos = jnp.zeros((slots,), jnp.int32)
    iota = jnp.arange(gamma + 1, dtype=jnp.int32)
    done0 = ~active

    # Inactive rows (incl. mid chunked-admission) must scatter into the
    # null page only — same hazard as _spec_rounds.
    t_tbl = t_state.page_table
    t_state = dataclasses.replace(
        t_state, page_table=jnp.where(active[:, None], t_tbl, 0)
    )

    V = None if pen is None else pen["prompt"].shape[-1]

    def body(carry, _):
        (t_state, hist, hlen, done, out, out_lp, out_pos, accepted_total,
         dstate, out_counts) = carry
        alive = ~done & (out_pos < budget)
        t_len = t_state.lengths
        cur = jnp.take_along_axis(
            hist, jnp.maximum(hlen[:, None] - 1, 0), axis=1
        )[:, 0].astype(jnp.int32)

        drafts, _ = ngram_propose(hist, hlen, gamma, ngram)

        vchunk = jnp.concatenate([cur[:, None], drafts], axis=1)
        vlog, t_state = forward_paged(
            params, cfg, vchunk, t_state, mode="extend",
            interpret=interpret, mesh=mesh, lora=lora,
            adapter_ids=adapter_ids,
        )
        if pen is not None:
            cum = jnp.cumsum(
                jax.nn.one_hot(drafts, V, dtype=jnp.float32), axis=1
            )
            vcounts = out_counts[:, None, :] + jnp.concatenate(
                [jnp.zeros_like(cum[:, :1]), cum], axis=1
            )
            vlog = apply_penalties(
                vlog, pen["prompt"][:, None, :], vcounts,
                pen["rep"][:, None], pen["pres"][:, None],
                pen["freq"][:, None],
            )
        if bias is not None:
            vlog = vlog + bias[:, None, :]
        if min_tokens is not None and eos_token_id is not None:
            early = (
                (positions0 + out_pos)[:, None] + iota + 1
            ) < min_tokens[:, None]
            vlog = vlog.at[:, :, eos_token_id].add(
                jnp.where(early, -jnp.inf, 0.0)
            )
        if dfa is not None:
            # Walk the automaton along the DRAFT prefix: the state before
            # verify position i is the entry state advanced by d_1..d_i —
            # identical to what the plain constrained engine would see
            # while the drafts keep matching.
            def walk(st, d_col):
                nxt = jnp.where(
                    constrain, dfa["transitions"][st, d_col], st
                )
                return nxt, st
            st_last, st_seq = jax.lax.scan(walk, dstate, drafts.T)
            st_all = jnp.concatenate(
                [jnp.moveaxis(st_seq, 0, 1), st_last[:, None]], axis=1
            )  # [slots, gamma+1]
            vlog = vlog + jnp.where(
                constrain[:, None, None], dfa["bias"][st_all], 0.0
            )
        padded = jnp.concatenate(
            [drafts, jnp.zeros((slots, 1), jnp.int32)], axis=1
        )
        if sampling is None:
            tgt_pred = jnp.argmax(vlog, axis=-1).astype(jnp.int32)
            match = tgt_pred[:, :gamma] == drafts
            n = jnp.sum(
                jnp.cumprod(match.astype(jnp.int32), axis=1), axis=1
            )
            bonus = jnp.take_along_axis(tgt_pred, n[:, None], axis=1)[:, 0]
            e = jnp.where(
                iota[None, :] == n[:, None], bonus[:, None], padded
            )
        else:
            abs_pos = positions0 + out_pos
            tprobs = jax.nn.softmax(filter_logits(vlog, sampling), axis=-1)
            qprobs = jax.nn.one_hot(
                drafts, vlog.shape[-1], dtype=tprobs.dtype
            )
            u = jax.vmap(lambda k_: jax.random.uniform(k_, (gamma,)))(
                _row_keys(seeds, abs_pos, 1)
            )
            n, e = _accept_and_emit(
                tprobs, qprobs, drafts, u, _row_keys(seeds, abs_pos, 2)
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
            idx = jnp.clip(pos0 + iota, 0, row.shape[0] - 1)
            vals = jnp.where(m_row, e_row, row[idx])
            return row.at[idx].set(vals)

        out = jax.vmap(write_row)(out, out_pos, e, mask)
        hist = jax.vmap(write_row)(hist, hlen, e, mask)
        if want_logprobs:
            vlp = jax.nn.log_softmax(
                vlog if sampling is None else filter_logits(vlog, sampling),
                axis=-1,
            )
            lp_e = jnp.take_along_axis(vlp, e[..., None], axis=2)[..., 0]
            out_lp = jax.vmap(write_row)(
                out_lp, out_pos, lp_e.astype(jnp.float32), mask
            )

        count = n_eff + 1
        out_pos = jnp.where(alive, out_pos + count, out_pos)
        hlen = jnp.where(alive, hlen + count, hlen)
        t_state = dataclasses.replace(
            t_state, lengths=jnp.where(alive, t_len + count, t_len)
        )
        accepted_total = accepted_total + jnp.sum(
            jnp.where(alive, n_eff, 0)
        )
        if dfa is not None:
            def adv(st, i):
                tok = e[:, i]
                take = (iota[i] <= n_eff) & alive & constrain
                nxt = jnp.where(take, dfa["transitions"][st, tok], st)
                return nxt, None
            dstate, _ = jax.lax.scan(
                adv, dstate, jnp.arange(gamma + 1)
            )
        if pen is not None:
            out_counts = out_counts + jnp.sum(
                jax.nn.one_hot(e, V, dtype=jnp.float32)
                * mask[..., None],
                axis=1,
            )
        return (t_state, hist, hlen, done_new, out, out_lp, out_pos,
                accepted_total, dstate, out_counts), None

    dstate0 = (
        dfa_state0 if dfa_state0 is not None else jnp.zeros_like(out_pos)
    )
    outc0 = pen["out"] if pen is not None else jnp.int32(0)
    init = (t_state, hist, hlen, done0, out, out_lp, out_pos, jnp.int32(0),
            dstate0, outc0)
    (t_state, _, _, _, out, out_lp, out_pos, accepted, _, _), _ = (
        jax.lax.scan(body, init, None, length=rounds)
    )
    t_state = dataclasses.replace(t_state, page_table=t_tbl)
    return out, out_lp, out_pos, t_state, accepted


class SpeculativeServingEngine(ServingEngine):
    """Continuous-batching engine whose decode phase is draft/verify.

    Greedy (sampling None / temp<=0): emitted tokens are bit-identical
    to the plain `ServingEngine` for any draft model (the draft only
    controls speed — acceptance rate x (gamma+1) tokens per target
    forward). Sampled (temp>0): REJECTION-SAMPLING speculative decoding —
    every emitted token's marginal is exactly the target's filtered
    sampling distribution; randomness is keyed by (request seed,
    absolute position, stream), so preemption-recompute replays the
    identical stream.

    Extra knobs over ServingEngine:
      draft_params/draft_cfg — the proposal model (same vocabulary).
      gamma                  — draft tokens proposed per round.
      rounds_per_call        — spec rounds folded into one device program
                               (the spec analog of decode_chunk).

    Pool sizing: reserve `prompt + max_new_tokens + gamma` tokens of page
    room per sequence (rejected-draft scatters transiently touch up to
    gamma positions past the accepted length).
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        draft_params=None,
        draft_cfg: ModelConfig | None = None,
        gamma: int = 4,
        rounds_per_call: int = 1,
        ngram: int = 0,  # >0: PROMPT-LOOKUP speculation (draft-free) —
        # proposals copy the continuation of the most recent ngram match
        # in the sequence's own history; no draft model or pool at all.
        **kwargs,
    ):
        super().__init__(params, cfg, **kwargs)
        assert gamma >= 1, gamma
        if ngram > 0:
            assert draft_params is None and draft_cfg is None, (
                "ngram (prompt-lookup) mode takes no draft model"
            )
        else:
            assert draft_params is not None and draft_cfg is not None, (
                "pass a draft model, or ngram > 0 for prompt lookup"
            )
            assert cfg.vocab_size == draft_cfg.vocab_size, (
                "draft and target must share a vocabulary"
            )
        self.ngram = ngram
        self.draft_cfg = draft_cfg
        self.gamma = gamma
        self.rounds_per_call = max(1, rounds_per_call)
        self.stats["spec_calls"] = 0
        self.stats["accepted_drafts"] = 0
        self.stats["draft_positions"] = 0
        # Covered (page-reserved) token count per slot; distinct from the
        # emitted length — rejected drafts leave covered positions to be
        # rewritten by later rounds.
        self._covered: dict[int, int] = {}
        # Draft-pool mirrors of the wave's partial-page clones (see
        # _apply_partial).
        self._pending_draft_partials: dict[int, tuple[int, int, int]] = {}

        if ngram > 0:
            self.d_state = None
            self.draft_params = None
            return
        # The draft pool shares the target's page table (same allocator,
        # same geometry); only the per-page payload differs. The draft
        # stays unquantized even over an int8/fp8 TARGET cache — it is
        # small by construction, and drafts never affect outputs anyway.
        if hasattr(self.state, "k_pages"):
            num_pages = self.state.k_pages.shape[2]
            d_dtype = self.state.k_pages.dtype
        else:  # QuantizedPagedKVState target
            num_pages = self.state.k_values.shape[2]
            d_dtype = cfg.dtype
        self.d_state = create_paged_state(
            draft_cfg,
            num_pages,
            self.page_size,
            batch=self.slots,
            pages_per_seq=self.pages_per_seq,
            dtype=d_dtype,
        )
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from flash_attention_cute.parallel.sharding import (
                param_pspecs,
            )

            assert draft_cfg.num_kv_heads % self.mesh.shape["model"] == 0
            self.draft_params = jax.tree.map(
                lambda x, s: jax.device_put(
                    x, NamedSharding(self.mesh, s)
                ),
                draft_params, param_pspecs(draft_cfg),
            )
            pool = lambda name: (
                P() if name in ("page_table", "lengths")
                else P(None, "model")
            )
            self.d_state = dataclasses.replace(
                self.d_state,
                **{
                    f.name: jax.device_put(
                        getattr(self.d_state, f.name),
                        NamedSharding(self.mesh, pool(f.name)),
                    )
                    for f in dataclasses.fields(self.d_state)
                },
            )
        else:
            self.draft_params = draft_params

    # ---- draft-state mirroring (called from the base-class internals) ----

    def _apply_partial(self, s: int, rid: int, shared: int) -> int:
        """Partial-page prefix sharing x speculative: queue the target's
        tail-row clone for the DRAFT pool too (same page ids — the draft
        pool rides the target's page table). Safe coverage: a stored
        partial ends at source position src_plen-2 (the plen-1 sharing
        cap), and the draft cache always holds KV through its owner's
        plen-2 (the one-token-behind invariant), so every cloned draft
        row is real. Group-admitted slots fold the clone into their
        draft-mirror extend (_prefill_group); chunk-walk slots flush in
        _admit before the chunk walk starts."""
        out = super()._apply_partial(s, rid, shared)
        info = self._pending_partials.get(s)
        if info is not None and self.d_state is not None:
            self._pending_draft_partials[s] = info
        return out

    def _admit(self):
        super()._admit()
        entries = list(self._pending_draft_partials.values())
        self._pending_draft_partials = {}
        if not entries or self.d_state is None:
            return
        g = len(entries)
        g_pad = 1 << (g - 1).bit_length()
        srcs = np.zeros((g_pad,), np.int32)
        dsts = np.zeros((g_pad,), np.int32)
        rows = np.zeros((g_pad,), np.int32)
        for i, (src, dst, r) in enumerate(entries):
            srcs[i], dsts[i], rows[i] = src, dst, r
        fields = tuple(
            f.name for f in dataclasses.fields(self.d_state)
            if f.name not in ("page_table", "lengths")
        )
        pools = tuple(getattr(self.d_state, f) for f in fields)
        new = self._partial_copy_fn(
            pools, jnp.asarray(srcs), jnp.asarray(dsts), jnp.asarray(rows)
        )
        self.d_state = dataclasses.replace(
            self.d_state, **dict(zip(fields, new))
        )
        self.stats["device_calls"] += 1

    def _sync_table(self, slot: int):
        super()._sync_table(slot)
        rid = self._slot_req[slot]
        if rid == -1 or self.d_state is None:
            return
        self.d_state = dataclasses.replace(
            self.d_state,
            page_table=self.d_state.page_table.at[slot].set(
                self.state.page_table[slot]
            ),
        )

    def _clear_table(self, slot: int):
        super()._clear_table(slot)
        if self.d_state is None:
            return
        self.d_state = dataclasses.replace(
            self.d_state,
            page_table=self.d_state.page_table.at[slot].set(0),
        )

    def _set_length(self, slot: int, value: int):
        super()._set_length(slot, value)
        if self.d_state is None:
            return
        # Draft invariant: one token behind the target (the round's
        # 2-token re-extend fills the gap).
        self.d_state = dataclasses.replace(
            self.d_state,
            lengths=self.d_state.lengths.at[slot].set(max(value - 1, 0)),
        )

    def _prefill_group(self, bucket: int, slots: list[int]):
        reqs = [self._requests[self._slot_req[s]] for s in slots]
        super()._prefill_group(bucket, slots)
        if self.d_state is None:  # prompt-lookup mode: no draft pool
            for i, s in enumerate(slots):
                self._covered[s] = len(reqs[i].prompt) + 1
            return
        # Mirror the prompts into the draft cache: one extra (small-model)
        # forward per admission group. With prefix caching the draft pool
        # rides the SAME shared pages (every admission mirrors the draft's
        # KV into them), so the mirror extends only the suffix too.
        shared_by_slot = (
            getattr(self, "_last_prefill_shared", {})
            if self.prefix_cache is not None else {}
        )
        g = len(slots)
        ids = np.zeros((g, bucket), np.int32)
        plens = np.zeros((g,), np.int32)
        shareds = np.zeros((g,), np.int32)
        for i, (s, req) in enumerate(zip(slots, reqs)):
            plens[i] = len(req.prompt)
            shareds[i] = shared_by_slot.get(s, 0)
            suffix = req.prompt[int(shareds[i]) :]
            ids[i, : len(suffix)] = suffix
        g_pad = 1 << (g - 1).bit_length()
        if g_pad != g:
            ids = np.pad(ids, ((0, g_pad - g), (0, 0)))
            plens_in = np.concatenate(
                [plens, np.ones((g_pad - g,), np.int32)]
            )
        else:
            plens_in = plens
        idxs = np.asarray(slots, np.int64)
        table = self.d_state.page_table[idxs]
        if g_pad != g:
            table = jnp.concatenate(
                [table, jnp.zeros((g_pad - g, table.shape[1]), jnp.int32)]
            )
        if self.prefix_cache is not None:
            sub_lens = np.concatenate(
                [shareds, np.zeros((g_pad - g,), np.int32)]
            ) if g_pad != g else shareds
            sub = dataclasses.replace(
                self.d_state,
                page_table=table,
                lengths=jnp.asarray(sub_lens),
            )
            # Fold this group's draft-pool tail clones into the same
            # draft extend program (mirrors the target-side fold in the
            # base _prefill_group — the extend below READS the cloned
            # rows, so they must land first, and a separate dispatch
            # would cost a round trip).
            partial_copy = None
            pending = [
                self._pending_draft_partials.pop(s, None) for s in slots
            ]
            if any(p is not None for p in pending):
                srcs = np.zeros((g_pad,), np.int32)
                dsts = np.zeros((g_pad,), np.int32)
                rows_ = np.zeros((g_pad,), np.int32)
                for i, p in enumerate(pending):
                    if p is not None:
                        srcs[i], dsts[i], rows_[i] = p
                partial_copy = (
                    jnp.asarray(srcs), jnp.asarray(dsts), jnp.asarray(rows_)
                )
            _, sub = forward_paged(
                self.draft_params, self.draft_cfg, jnp.asarray(ids), sub,
                mode="extend", interpret=self.interpret, mesh=self.mesh,
                partial_copy=partial_copy,
            )
        else:
            sub = dataclasses.replace(
                self.d_state,
                page_table=table,
                lengths=jnp.zeros((g_pad,), jnp.int32),
            )
            _, sub = forward_paged(
                self.draft_params, self.draft_cfg, jnp.asarray(ids), sub,
                mode="prefill", valid_len=jnp.asarray(plens_in),
                interpret=self.interpret, mesh=self.mesh,
            )
        self.stats["device_calls"] += 1
        pool_fields = {
            f.name for f in dataclasses.fields(self.d_state)
        } - {"page_table", "lengths"}
        self.d_state = dataclasses.replace(
            self.d_state,
            **{name: getattr(sub, name) for name in pool_fields},
            lengths=self.d_state.lengths.at[jnp.asarray(idxs)].set(
                jnp.asarray(plens - 1)
            ),
        )
        for i, s in enumerate(slots):
            # super() counted the sampled first token against the pages:
            # covered = prompt + 1.
            self._covered[s] = int(plens[i]) + 1

    def _advance_prefills(self):
        """Chunked admission x speculative: after the target's batched
        chunk extend, replay the same chunk into the draft cache (one
        extra small-model extend per round). Completion length/covered
        bookkeeping rides the overridden _set_length."""
        snapshot = dict(self._prefilling)
        super()._advance_prefills()
        if not snapshot or self.d_state is None:
            if self.d_state is None:
                for s in snapshot:
                    if (
                        s not in self._prefilling
                        and self._slot_req[s] != -1
                    ):
                        req = self._requests[self._slot_req[s]]
                        self._covered[s] = len(req.prompt) + 1
            return
        slots = sorted(snapshot)
        c = self.prefill_chunk
        g = len(slots)
        g_pad = 1 << (g - 1).bit_length()
        ids = np.zeros((g_pad, c), np.int32)
        progress = np.zeros((g_pad,), np.int32)
        for j, s in enumerate(slots):
            req = self._requests[self._slot_req[s]]
            p = snapshot[s]
            chunk_tokens = req.prompt[p : p + c]
            ids[j, : len(chunk_tokens)] = chunk_tokens
            progress[j] = p
        idxs = np.asarray(slots, np.int64)
        table = self.d_state.page_table[idxs]
        if g_pad != g:
            table = jnp.concatenate(
                [table, jnp.zeros((g_pad - g, table.shape[1]), jnp.int32)]
            )
        sub = dataclasses.replace(
            self.d_state,
            page_table=table,
            lengths=jnp.asarray(progress),
        )
        _, sub = forward_paged(
            self.draft_params, self.draft_cfg, jnp.asarray(ids), sub,
            mode="extend", interpret=self.interpret, mesh=self.mesh,
        )
        self.stats["device_calls"] += 1
        pool_fields = {
            f.name for f in dataclasses.fields(self.d_state)
        } - {"page_table", "lengths"}
        self.d_state = dataclasses.replace(
            self.d_state,
            **{name: getattr(sub, name) for name in pool_fields},
        )
        for s in slots:
            if s not in self._prefilling and self._slot_req[s] != -1:
                # Admission completed this round; super() counted the
                # sampled first token (covered = prompt + 1). The draft
                # length (prompt - 1) was already published by the
                # overridden _set_length.
                req = self._requests[self._slot_req[s]]
                self._covered[s] = len(req.prompt) + 1

    # ---- engine loop ----

    def step(self, max_chunk: int | None = None) -> bool:
        """One admission + speculative-decode round. False when idle.

        `max_chunk` is accepted for interface parity and ignored (round
        count is the engine's `rounds_per_call`)."""
        self.stats["steps"] += 1
        self._admit()
        self._finish_ready()
        self._advance_prefills()
        active = [
            s for s in range(self.slots)
            if self._slot_req[s] != -1 and s not in self._prefilling
        ]
        if not active:
            if self._prefilling:
                return True
            return self.sched.num_waiting > 0 and self._drain_unservable()

        rounds = self.rounds_per_call
        span = rounds * (self.gamma + 1)

        # Reserve page coverage for the scan's high-water mark BEFORE the
        # device call; preempt on page exhaustion (recompute semantics).
        for s in list(active):
            if self._slot_req[s] == -1:
                continue
            req = self._requests[self._slot_req[s]]
            plen = len(req.prompt)
            L = plen + len(req.generated) - 1
            target = min(L + span, plen + req.max_new_tokens + self.gamma)
            need = target - self._covered.get(s, 0)
            ok = True
            for _ in range(max(need, 0)):
                r = self._step_slot_evicting(s)
                if r == 1:
                    self._covered[s] = self._covered.get(s, 0) + 1
                    continue
                victim = self.sched.preempt_youngest()
                if victim != -1:
                    self.stats["preemptions"] += 1
                    self._evict(victim, requeue=True)
                    if victim != s and self.sched.step_slot(s) == 1:
                        self._covered[s] = self._covered.get(s, 0) + 1
                        continue
                    if victim != s:
                        self.stats["preemptions"] += 1
                        self.sched.release_slot(s, requeue=True)
                        self._evict(s, requeue=True)
                    ok = False
                    break
                else:
                    self.sched.release_slot(s, requeue=False)
                    self._evict(s, failed=True)
                    ok = False
                    break
            if ok:
                self._sync_table(s)

        active = [
            s for s in range(self.slots)
            if self._slot_req[s] != -1 and s not in self._prefilling
        ]
        if not active:
            return (self.sched.num_waiting > 0) or bool(self._requests)

        cur = np.zeros((self.slots,), np.int32)
        prev = np.zeros((self.slots,), np.int32)
        mask = np.zeros((self.slots,), bool)
        budget = np.zeros((self.slots,), np.int32)
        seeds = np.zeros((self.slots,), np.int32)
        pos0 = np.zeros((self.slots,), np.int32)
        for s in active:
            rid = self._slot_req[s]
            req = self._requests[rid]
            hist = req.prompt + req.generated
            cur[s] = hist[-1]
            prev[s] = hist[-2]
            mask[s] = True
            budget[s] = req.max_new_tokens - len(req.generated)
            seeds[s] = self._req_seed(rid)
            pos0[s] = len(req.generated)

        sampling = (
            self.sampling
            if self.sampling is not None and self.sampling.temperature > 0.0
            else None
        )
        if self.ngram > 0:
            # Prompt-lookup mode: ship each slot's token history (bucketed
            # to a power of two so compiles stay bounded); proposals and
            # history updates happen in-scan.
            span = rounds * (self.gamma + 1)
            max_hist = max(
                len(self._requests[self._slot_req[s]].prompt)
                + len(self._requests[self._slot_req[s]].generated)
                for s in active
            )
            cap = _bucket(max_hist + span)
            hist = np.zeros((self.slots, cap), np.int32)
            hlen = np.zeros((self.slots,), np.int32)
            for s in active:
                req = self._requests[self._slot_req[s]]
                h = req.prompt + req.generated
                hist[s, : len(h)] = h
                hlen[s] = len(h)
            gbias, gmins = self._guided_arrays(
                range(self.slots), by_slot=True
            )
            gds, gcm = self._dfa_arrays()
            gpen = self._penalty_arrays(range(self.slots), by_slot=True)
            out, out_lp, out_pos, self.state, accepted = _spec_rounds_lookup(
                self.params, self.cfg, self.state,
                jnp.asarray(hist), jnp.asarray(hlen),
                jnp.asarray(mask), jnp.asarray(budget),
                self.gamma, rounds, self.ngram,
                self.eos_token_id, self.interpret, self.mesh,
                sampling=sampling, seeds=jnp.asarray(seeds),
                positions0=jnp.asarray(pos0), bias=gbias, min_tokens=gmins,
                lora=self.lora, adapter_ids=self._adapter_ids(),
                dfa=self.dfa, dfa_state0=gds, constrain=gcm, pen=gpen,
                want_logprobs=self.return_logprobs,
            )
        else:
            gbias, gmins = self._guided_arrays(
                range(self.slots), by_slot=True
            )
            gds, gcm = self._dfa_arrays()
            gpen = self._penalty_arrays(range(self.slots), by_slot=True)
            (out, out_lp, out_pos, self.state, self.d_state,
             accepted) = _spec_rounds(
                self.params, self.draft_params, self.cfg, self.draft_cfg,
                self.state, self.d_state,
                jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(mask),
                jnp.asarray(budget), self.gamma, rounds,
                self.eos_token_id, self.interpret, self.mesh,
                sampling=sampling, seeds=jnp.asarray(seeds),
                positions0=jnp.asarray(pos0), bias=gbias, min_tokens=gmins,
                lora=self.lora, adapter_ids=self._adapter_ids(),
                dfa=self.dfa, dfa_state0=gds, constrain=gcm, pen=gpen,
                want_logprobs=self.return_logprobs,
            )
        self.stats["device_calls"] += 1
        self.stats["spec_calls"] += 1
        self.stats["accepted_drafts"] += int(accepted)
        out = np.asarray(out, np.int32)
        out_lp = (
            np.asarray(out_lp, np.float32) if self.return_logprobs else None
        )
        out_pos = np.asarray(out_pos, np.int32)

        for s in active:
            req = self._requests[self._slot_req[s]]
            n = int(min(out_pos[s], budget[s]))
            new = [int(t) for t in out[s, :n]]
            if self.eos_token_id is not None and self.eos_token_id in new:
                new = new[: new.index(self.eos_token_id) + 1]
                req.max_new_tokens = len(req.generated) + len(new)
            req.generated.extend(new)
            if out_lp is not None:
                req.logprobs.extend(
                    float(x) for x in out_lp[s, : len(new)]
                )
            self.stats["tokens_generated"] += len(new)
            # Acceptance-rate accounting: every alive round offered gamma
            # drafts; approximate offered = emitted rounds * gamma via the
            # per-slot round count is not recoverable host-side, so count
            # positions = emitted tokens (n) for the denominator's upper
            # bound instead.
            self.stats["draft_positions"] += n
        self._finish_ready()
        return bool(self._requests) or self.sched.num_waiting > 0
