"""Continuous-batching serving engine (paged KV, native scheduler).

The BASELINE north star the reference never reaches (its serving story is
HF `generate` over a DynamicCache, reference: scripts/benchmark_llm_e2e.py):
a slot-based engine where requests stream in and out of a fixed device
batch while decode keeps running — every device program has a static
shape:

  * batch slots:    fixed `slots`; a request occupies one slot for life.
  * page pool:      fixed `num_pages x page_size` per layer; page tables
                    assembled on the host, attention gathers pages on
                    device (ops/paged_attention.py).
  * prefill:        per-admission, prompt padded to a power-of-two bucket
                    (one compile per bucket, not per length).
  * decode:         ONE compiled step for the whole slot batch regardless
                    of which slots are live.
  * scheduling:     FCFS admission + decode-OOM preemption in native C++
                    (csrc/page_allocator.cpp via runtime/native.py), the
                    pure-Python allocator as fallback. Preemption uses
                    recompute semantics: the victim restarts from its
                    prompt (greedy decoding makes the retry identical).

Usage:
    eng = ServingEngine(params, cfg, slots=4, num_pages=129, page_size=16,
                        pages_per_seq=16)
    eng.submit(0, prompt_ids_list, max_new_tokens=32)
    results = eng.run()   # {req_id: [token, ...]}
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time

import jax
import jax.numpy as jnp
import numpy as np

from flash_attention_cute.models.config import ModelConfig
from flash_attention_cute.runtime.paged_cache import (
    copy_pool_page_prefix_batch,
    create_paged_state,
)
from flash_attention_cute.runtime.paged_forward import forward_paged


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "chunk", "sampling", "interpret", "mesh",
                     "eos_token_id", "want_logprobs"),
    donate_argnames=("state",),
)
def _decode_chunk(params, cfg, last, state, chunk, sampling, interpret,
                  seeds=None, positions=None, mesh=None, bias=None,
                  min_tokens=None, eos_token_id=None, lora=None,
                  adapter_ids=None, dfa=None, dfa_state=None,
                  constrain=None, pen=None, want_logprobs=False):
    """Decode `chunk` tokens for every slot in one compiled scan.

    Returns (tokens [chunk, slots], state). Inactive slots (length 0)
    produce garbage tokens the host discards; their lengths do not advance
    (forward_paged masks them).

    Sampling keys derive from per-slot request `seeds` folded with the
    absolute token `positions`, so a preempted-and-recomputed request
    replays the SAME samples (recompute semantics stay exact even with
    temperature > 0).

    Guided decoding: `bias` [slots, V] adds to every step's logits
    (+/-inf bans/forces tokens); `min_tokens` [slots] suppresses
    `eos_token_id` while the absolute position is below it; `dfa`
    ({"bias": [n_states, V] f32 (0 / -inf), "transitions": [n_states, V]
    int32}) constrains `constrain`-flagged rows to the automaton,
    advancing `dfa_state` per emitted token (structured output).

    Penalties: `pen` = {"prompt"/"out" [slots, V] f32 counts, "rep"/
    "pres"/"freq" [slots]} applies repetition/presence/frequency
    penalties to RAW logits each step; the output counts advance in-scan
    per emitted token. Entry counts derive from host request streams
    every call (the `_dfa_arrays` pattern), so chunk boundaries and
    preemption recompute stay exact; rows without penalties carry
    neutral (rep=1, pres=freq=0) values.
    """
    from flash_attention_cute.runtime.sampling import (
        apply_penalties,
        sample_token,
    )

    def body(carry, i):
        state, tok, dstate, outc = carry
        logits, state = forward_paged(
            params, cfg, tok[:, None], state, mode="decode",
            interpret=interpret, mesh=mesh, lora=lora,
            adapter_ids=adapter_ids,
        )
        if pen is not None:
            logits = apply_penalties(
                logits[:, 0], pen["prompt"], outc,
                pen["rep"], pen["pres"], pen["freq"],
            )[:, None, :]
        if bias is not None:
            logits = logits + bias[:, None, :]
        if dfa is not None:
            step_bias = dfa["bias"][dstate]  # [slots, V]
            logits = logits + jnp.where(
                constrain[:, None], step_bias, 0.0
            )[:, None, :]
        if min_tokens is not None and eos_token_id is not None:
            early = (positions + i + 1) < min_tokens  # [slots]
            logits = logits.at[:, :, eos_token_id].add(
                jnp.where(early, -jnp.inf, 0.0)[:, None]
            )
        if sampling is None or sampling.temperature <= 0.0:
            dist = logits[:, 0]  # greedy: log-softmax of the shaped logits
            nxt = jnp.argmax(dist, axis=-1).astype(jnp.int32)
        else:
            per_slot = jax.vmap(
                lambda s, p: jax.random.fold_in(
                    jax.random.fold_in(jax.random.key(0), s), p
                )
            )(seeds, positions + i)
            # filter_logits IS the distribution sample_token draws from;
            # sampling from it directly keeps the logprob definition (the
            # actual sampling distribution) aligned with the draw.
            from flash_attention_cute.runtime.sampling import (
                filter_logits,
            )

            dist = filter_logits(logits[:, 0], sampling)
            nxt = jax.vmap(
                lambda lg, k_: jax.random.categorical(k_, lg)
            )(dist, per_slot).astype(jnp.int32)
        if want_logprobs:
            lp = jnp.take_along_axis(
                jax.nn.log_softmax(dist, axis=-1), nxt[:, None], axis=1
            )[:, 0].astype(jnp.float32)
        else:
            lp = jnp.zeros_like(nxt, jnp.float32)
        if dfa is not None:
            dstate = jnp.where(
                constrain,
                dfa["transitions"][dstate, nxt],
                dstate,
            )
        if pen is not None:
            # Inactive slots' garbage tokens pollute only their own rows,
            # whose penalty params are neutral; entry counts rebuild from
            # host truth next call either way.
            outc = outc.at[jnp.arange(outc.shape[0]), nxt].add(1.0)
        return (state, nxt, dstate, outc), (nxt, lp)

    dstate0 = (
        dfa_state if dfa_state is not None
        else jnp.zeros_like(last)
    )
    outc0 = pen["out"] if pen is not None else jnp.int32(0)
    (state, _, _, _), (toks, lps) = jax.lax.scan(
        body, (state, last, dstate0, outc0), jnp.arange(chunk)
    )
    return toks, lps, state


@dataclasses.dataclass
class _Request:
    req_id: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    # Guided decoding (all optional): additive per-token logit bias
    # (+/-inf bans/forces), EOS suppression below a minimum emitted
    # count, and host-checked stop token sequences.
    logit_bias: dict | None = None
    min_new_tokens: int = 0
    stop_sequences: list | None = None
    adapter: int = 0  # LoRA adapter id (0 = base model)
    constrain: bool = False  # decode through the engine's shared DFA
    # Sampling penalties (neutral defaults; see sampling.apply_penalties):
    # repetition over prompt+output (HF semantics), presence/frequency
    # over output tokens (OpenAI semantics).
    rep_penalty: float = 1.0
    pres_penalty: float = 0.0
    freq_penalty: float = 0.0
    # Per-emitted-token log-probabilities (engine return_logprobs=True):
    # log-softmax of the shaped logits under greedy, of the actual
    # filtered sampling distribution under temperature > 0. Kept in
    # lockstep with `generated` through EOS/stop truncation and
    # preemption recompute.
    logprobs: list = dataclasses.field(default_factory=list)

    @property
    def has_penalties(self) -> bool:
        return (
            self.rep_penalty != 1.0
            or self.pres_penalty != 0.0
            or self.freq_penalty != 0.0
        )
    # Latency observability (BASELINE.json names p50 TTFT as a headline
    # metric): submit -> first token host-visible -> finished. Preemption
    # replay keeps the ORIGINAL first-token time (the user saw it once).
    submit_t: float = 0.0
    first_token_t: float | None = None
    finish_t: float | None = None


def _read_pool_page(pools, page):
    """Slice page `page` out of every pool array (page axis = dim 2)."""
    return tuple(
        jax.lax.dynamic_index_in_dim(a, page, axis=2, keepdims=False)
        for a in pools
    )


def _write_pool_page(pools, blobs, page):
    """Write one page's KV back into every pool array (donated in-place)."""
    return tuple(
        jax.lax.dynamic_update_index_in_dim(
            a, b.astype(a.dtype), page, axis=2
        )
        for a, b in zip(pools, blobs)
    )


# Partial-page clone helpers live in paged_cache (shared with
# forward_paged's folded-in form); imported at engine init.


def _bucket(n: int, lo: int = 16) -> int:
    return max(lo, 1 << math.ceil(math.log2(max(n, 1))))


class ServingEngine:
    """Host-side serving loop over the paged device state."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        slots: int,
        num_pages: int,
        page_size: int,
        pages_per_seq: int,
        dtype=None,
        kv_dtype=None,  # jnp.int8 / jnp.float8_e4m3fn => quantized pages
        sampling=None,  # SamplingParams | None (None/temp<=0 => greedy)
        seed: int = 0,
        mesh=None,  # jax.sharding.Mesh with a 'model' axis => TP serving
        prefill_group: int = 1,  # >1: batch same-bucket admissions into one
        # prefill program (wins under bursty arrivals; costs one compile per
        # (bucket, pow2-group) and wasted compute on underfull groups)
        prefill_chunk: int = 0,  # >0: CHUNKED admission — prompts prefill
        # prefill_chunk tokens per engine round, interleaved with decode
        # rounds of the other slots (bounds head-of-line blocking by long
        # prompts; dense pages only). 0 = whole-prompt admission.
        eos_token_id: int | None = None,  # finish a request early at EOS
        dfa: dict | None = None,  # shared decoding automaton for
        # structured output: {"bias": [n_states, V] f32 (0 allowed /
        # -inf banned), "transitions": [n_states, V] int32, "start": int}.
        # Requests opt in with submit(constrain=True); states advance per
        # emitted token and are tracked HOST-side (recompute-stable).
        lora_params: dict | None = None,  # stacked multi-LoRA adapters
        # (models/lora.py): every request picks its own adapter id at
        # submit(); id 0 is the no-op adapter by convention
        enable_prefix_cache: bool = False,  # reuse page-aligned shared
        # prompt prefixes across requests: admission prefills only the
        # unseen suffix through the paged-extend forward; page lifetime is
        # refcounted in the (native or Python) allocator and the content
        # map is an exact-key LRU (runtime/prefix_cache.py)
        host_swap_tokens: int = 0,  # >0 (with enable_prefix_cache): host-
        # RAM second tier of that many tokens — prefix blocks evicted
        # under pool pressure spill their KV to host numpy instead of
        # being dropped, and a later prompt sharing them restores each
        # block with ONE host->device page upload instead of recomputing
        # its prefill (runtime/prefix_cache.py::HostSwapTier)
        decode_chunk: int = 8,  # tokens decoded per engine round in ONE
        # jitted scan: larger chunks amortize host round trips at the cost
        # of admission latency for requests arriving mid-chunk and bounded
        # EOS overshoot.
        return_logprobs: bool = False,  # collect per-token logprobs of
        # every emitted token (greedy: log-softmax of the shaped logits;
        # sampled: of the actual filtered sampling distribution) into
        # `engine.logprobs[req_id]`, in lockstep with the token streams
        # through EOS/stop truncation and preemption recompute
        interpret: bool | None = None,
    ):
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.sampling = sampling
        self.seed = seed
        self.mesh = mesh
        self.prefill_group = max(1, prefill_group)
        self.prefill_chunk = max(0, prefill_chunk)
        self.decode_chunk = max(1, decode_chunk)
        self.return_logprobs = return_logprobs
        self.eos_token_id = eos_token_id
        self.interpret = interpret
        self.enable_prefix_cache = enable_prefix_cache
        self.lora = lora_params
        if dfa is not None:
            self.dfa = {
                "bias": jnp.asarray(dfa["bias"], jnp.float32),
                "transitions": jnp.asarray(dfa["transitions"], jnp.int32),
            }
            self.dfa_start = int(dfa.get("start", 0))
        else:
            self.dfa = None
            self.dfa_start = 0
        self._prefilling: dict[int, int] = {}  # slot -> tokens scattered
        # Prefix caching: tokens of each waiting/admitting request served
        # from the cache (granted to the scheduler this round), and the
        # per-slot shared-token count consumed by the admission forward.
        self._granted: dict[int, int] = {}
        self._admit_shared: dict[int, int] = {}
        # Partial-page tail grants: rid -> (src_page, rows) matched at the
        # last grant pass; consumed (copied) at admission. _last_partial
        # records this round's applied copies per slot so subclasses with
        # mirrored pools (speculative draft) can replay them.
        self._granted_partial: dict[int, tuple] = {}
        self._last_partial: dict[int, tuple] = {}
        # Clones deferred within one admission wave, keyed by slot:
        # group-admitted slots fold theirs into the admission extend
        # forward (forward_paged partial_copy=, zero extra dispatches);
        # chunk-walk slots flush as one batched dispatch
        # (_flush_partials).
        self._pending_partials: dict[int, tuple[int, int, int]] = {}
        if kv_dtype is not None and jnp.dtype(kv_dtype).itemsize == 1:
            from flash_attention_cute.runtime.paged_cache import (
                create_quantized_paged_state,
            )

            self.state = create_quantized_paged_state(
                cfg, num_pages, page_size, batch=slots,
                pages_per_seq=pages_per_seq, dtype=kv_dtype,
            )
        else:
            self.state = create_paged_state(
                cfg, num_pages, page_size, batch=slots,
                pages_per_seq=pages_per_seq, dtype=dtype,
            )

        if mesh is not None:
            # Tensor-parallel serving: KV heads of the page pool and the
            # weights shard over 'model'; per-slot metadata replicates.
            if dict(mesh.shape).get("data", 1) != 1:
                raise ValueError(
                    "ServingEngine is a single TP replica (its pool and "
                    "slot metadata replicate over any data axis); for a "
                    "mesh with data > 1 use "
                    "runtime.dp_engine.DataParallelServingEngine — one "
                    "engine per data shard behind a shared admission queue"
                )
            from jax.sharding import NamedSharding, PartitionSpec as P

            from flash_attention_cute.parallel.sharding import (
                param_pspecs,
            )

            assert cfg.num_kv_heads % mesh.shape["model"] == 0
            self.params = jax.tree.map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                params, param_pspecs(cfg),
            )

            def pool_spec(name, arr):
                if name in ("page_table", "lengths"):
                    return P()
                return P(None, "model")  # [L, Hkv, ...]

            self.state = dataclasses.replace(
                self.state,
                **{
                    f.name: jax.device_put(
                        getattr(self.state, f.name),
                        NamedSharding(
                            mesh, pool_spec(f.name, getattr(self.state, f.name))
                        ),
                    )
                    for f in dataclasses.fields(self.state)
                },
            )

        try:
            from flash_attention_cute.runtime.native import NativeScheduler
            self.sched = NativeScheduler(
                num_pages, page_size, pages_per_seq, slots
            )
            self.native = True
        except (RuntimeError, OSError, ImportError):
            self.sched = _PyScheduler(
                num_pages, page_size, pages_per_seq, slots
            )
            self.native = False

        if enable_prefix_cache:
            from flash_attention_cute.runtime.prefix_cache import (
                HostSwapTier,
                PrefixCache,
            )

            # Pool arrays carry the page axis at dim 2 in every state
            # flavor (k/v values and, quantized, their scale planes).
            self._pool_fields = tuple(
                f.name
                for f in dataclasses.fields(self.state)
                if f.name not in ("page_table", "lengths")
            )
            # Partial-page tail sharing: clone the shared rows into the
            # new request's first private page (donated in-place).
            self._partial_copy_fn = jax.jit(
                copy_pool_page_prefix_batch, donate_argnums=0
            )
            swap = None
            if host_swap_tokens > 0:
                swap = HostSwapTier(host_swap_tokens, page_size)
                self._page_read_fn = jax.jit(_read_pool_page)
                # Donation keeps the upload in place — without it every
                # restored block would copy the whole multi-GB pool.
                self._page_write_fn = jax.jit(
                    _write_pool_page, donate_argnums=0
                )
            self.prefix_cache = PrefixCache(
                self.sched,
                page_size,
                swap=swap,
                read_page=self._read_page if swap is not None else None,
                write_page=self._write_page if swap is not None else None,
            )
        else:
            self.prefix_cache = None

        self._requests: dict[int, _Request] = {}
        self._slot_req: list[int] = [-1] * slots
        self._done: dict[int, list[int]] = {}
        # req_id -> per-token logprobs of finished requests (when
        # return_logprobs; parallel to the _done token lists).
        self.logprobs: dict[int, list[float]] = {}
        self._failed: list[int] = []
        # Observability counters (SURVEY.md §5 metrics; the reference's
        # equivalent is print statements in its benches).
        self.stats = {
            "steps": 0,
            "prefills": 0,
            "preemptions": 0,
            "tokens_generated": 0,
            "requests_finished": 0,
            "requests_failed": 0,
            # Dispatch accounting: every jitted device program launched
            # (prefill / extend / decode scan); device_calls /
            # tokens_generated counts host round trips per generated token.
            "device_calls": 0,
            # Prefix caching: prompt tokens served from cached pages
            # (never recomputed), and cache entries evicted under pool
            # pressure.
            "prefix_hit_tokens": 0,
            "prefix_evictions": 0,
            # Host-swap tier traffic (pages snapshotted out / restored in;
            # each is one device round trip).
            "swap_out_pages": 0,
            "swap_in_pages": 0,
        }
        # Completed per-request latency records (see request_metrics).
        self.metrics: list[dict] = []

    # ---- public API ----

    def submit(
        self,
        req_id: int,
        prompt: list[int],
        max_new_tokens: int,
        *,
        logit_bias: dict | None = None,  # token id -> additive bias
        min_new_tokens: int = 0,  # EOS banned before this many tokens
        # (the EOS itself counts: min_new_tokens=3 allows EOS at output
        # position 2)
        stop_sequences: list | None = None,  # list of token-id lists; the
        # request finishes when its generated stream ends with one
        # (host-checked per engine round, like EOS-inside-chunk)
        adapter: int = 0,  # LoRA adapter id (requires lora_params)
        priority: int = 0,  # higher admits sooner and preempts later
        # (FIFO within a priority class; 0 = default)
        constrain: bool = False,  # decode through the engine DFA
        repetition_penalty: float = 1.0,  # HF semantics: seen (prompt or
        # output) tokens' logits are divided by this when positive,
        # multiplied when negative; 1.0 disables
        presence_penalty: float = 0.0,  # OpenAI semantics: subtracted
        # once from every token already emitted by this request
        frequency_penalty: float = 0.0,  # OpenAI semantics: subtracted
        # per occurrence in this request's output
    ):
        assert req_id >= 0 and req_id not in self._requests
        assert len(prompt) >= 1
        assert repetition_penalty > 0.0, repetition_penalty
        if constrain:
            assert self.dfa is not None, "engine built without a dfa"
        if adapter != 0:
            assert self.lora is not None, "engine built without lora_params"
            assert 0 <= adapter < self.lora["scaling"].shape[0], adapter
        self._requests[req_id] = _Request(
            req_id, list(prompt), max_new_tokens,
            submit_t=time.monotonic(),
            logit_bias=dict(logit_bias) if logit_bias else None,
            min_new_tokens=min_new_tokens,
            stop_sequences=(
                [list(s) for s in stop_sequences] if stop_sequences else None
            ),
            adapter=adapter,
            constrain=constrain,
            rep_penalty=float(repetition_penalty),
            pres_penalty=float(presence_penalty),
            freq_penalty=float(frequency_penalty),
        )
        self.sched.submit(req_id, len(prompt), max_new_tokens, priority)

    def run(self, max_steps: int = 100000) -> dict[int, list[int]]:
        """Drive until all submitted requests finish. Returns generations."""
        drained = False
        for _ in range(max_steps):
            if not self.step():
                drained = True
                break
        # Only when step() returned False with requests still queued are
        # those requests truly unservable at this pool size — surface them
        # as failed rather than dropping them silently. When the loop ends
        # because max_steps ran out, the remaining requests are merely
        # unfinished, not unservable: leave them queued.
        if drained:
            for rid, req in list(self._requests.items()):
                if rid not in dict(
                    (self._slot_req[s], s) for s in range(self.slots)
                ):
                    self._failed.append(rid)
                    self.stats["requests_failed"] += 1
                    del self._requests[rid]
        return dict(self._done)

    @property
    def failed(self) -> list[int]:
        return list(self._failed)

    @property
    def request_metrics(self) -> list[dict]:
        """Per-finished-request latency records: req_id, prompt_len,
        new_tokens, ttft_s (submit -> first token host-visible), e2e_s
        (submit -> finished). BASELINE.json's p50-TTFT metric is a
        percentile over the ttft_s column."""
        return list(self.metrics)

    # ---- engine loop ----

    def step(self, max_chunk: int | None = None) -> bool:
        """One admission + decode round. False when nothing is in flight.

        Decodes up to `max_chunk` (default: the engine's `decode_chunk`)
        tokens per round inside ONE jitted scan
        (multi-step scheduling): host<->device round trips amortize across
        the chunk. The
        chunk is capped so no active request finishes mid-chunk; page room
        for the whole chunk is reserved up front (preempting on exhaustion,
        with bounded over-reservation when the pool runs dry mid-reserve).
        """
        if max_chunk is None:
            max_chunk = self.decode_chunk
        self.stats["steps"] += 1
        self._admit()
        self._finish_ready()  # e.g. EOS as the very first prefill token
        # Advance ALL chunked admissions one chunk per round in a single
        # extend forward, interleaved with the decode phase below.
        self._advance_prefills()
        active = [
            s for s in range(self.slots)
            if self._slot_req[s] != -1 and s not in self._prefilling
        ]
        if not active:
            if self._prefilling:
                return True
            return self.sched.num_waiting > 0 and self._drain_unservable()

        chunk = min(
            [max_chunk]
            + [
                self._requests[self._slot_req[s]].max_new_tokens
                - len(self._requests[self._slot_req[s]].generated)
                for s in active
            ]
        )
        chunk = max(chunk, 1)

        # Reserve `chunk` tokens of page room per active slot BEFORE the
        # device scan; preempt on page exhaustion.
        for s in list(active):
            if self._slot_req[s] == -1:
                continue
            ok = True
            for _ in range(chunk):
                r = self._step_slot_evicting(s)
                if r == 1:
                    continue
                victim = self.sched.preempt_youngest()
                if victim != -1:
                    self.stats["preemptions"] += 1
                    self._evict(victim, requeue=True)
                    if victim != s and self.sched.step_slot(s) == 1:
                        continue
                    # s itself was the victim, or it is still starved: it
                    # MUST leave the batch this round — a resident slot
                    # decodes the full chunk, and tokens without reserved
                    # pages would scatter into the null page and be lost.
                    if victim != s:
                        self.stats["preemptions"] += 1
                        self.sched.release_slot(s, requeue=True)
                        self._evict(s, requeue=True)
                    ok = False
                    break
                else:
                    # Unservable at this pool size: fail the request.
                    rid = self._slot_req[s]
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

        # One compiled multi-token decode scan over ALL slots.
        last = np.zeros((self.slots,), np.int32)
        seeds = np.zeros((self.slots,), np.int32)
        positions = np.zeros((self.slots,), np.int32)
        for s in active:
            rid = self._slot_req[s]
            req = self._requests[rid]
            hist = req.prompt + req.generated
            last[s] = hist[-1]
            seeds[s] = self._req_seed(rid)
            positions[s] = len(req.generated)
        bias, mins = self._guided_arrays(range(self.slots), by_slot=True)
        dfa_state, constrain = self._dfa_arrays()
        pen = self._penalty_arrays(range(self.slots), by_slot=True)
        tokens, lps, self.state = _decode_chunk(
            self.params, self.cfg, jnp.asarray(last), self.state,
            chunk, self.sampling, self.interpret,
            seeds=jnp.asarray(seeds), positions=jnp.asarray(positions),
            mesh=self.mesh, bias=bias, min_tokens=mins,
            eos_token_id=self.eos_token_id if mins is not None else None,
            lora=self.lora, adapter_ids=self._adapter_ids(),
            dfa=self.dfa, dfa_state=dfa_state, constrain=constrain,
            pen=pen, want_logprobs=self.return_logprobs,
        )
        self.stats["device_calls"] += 1
        tokens = np.asarray(tokens, np.int32)  # [chunk, slots]
        lps = np.asarray(lps, np.float32) if self.return_logprobs else None

        for s in active:
            rid = self._slot_req[s]
            req = self._requests[rid]
            new = [int(t) for t in tokens[:, s]]
            if self.eos_token_id is not None and self.eos_token_id in new:
                # EOS inside the chunk: keep it, drop the speculative tail
                # (its page room frees with the slot release).
                new = new[: new.index(self.eos_token_id) + 1]
                req.max_new_tokens = len(req.generated) + len(new)
            req.generated.extend(new)
            if lps is not None:
                req.logprobs.extend(float(x) for x in lps[: len(new), s])
            self.stats["tokens_generated"] += len(new)
        self._finish_ready()
        return bool(self._requests) or self.sched.num_waiting > 0

    def _finish_ready(self):
        for s in range(self.slots):
            rid = self._slot_req[s]
            if rid == -1:
                continue
            req = self._requests[rid]
            self._check_stops(req)
            done = len(req.generated) >= req.max_new_tokens
            if self.eos_token_id is not None and req.generated:
                done = done or req.generated[-1] == self.eos_token_id
            if done:
                self.sched.release_slot(s, requeue=False)
                self._done[rid] = req.generated
                if self.return_logprobs:
                    self.logprobs[rid] = req.logprobs[: len(req.generated)]
                self.stats["requests_finished"] += 1
                req.finish_t = time.monotonic()
                self.metrics.append({
                    "req_id": rid,
                    "prompt_len": len(req.prompt),
                    "new_tokens": len(req.generated),
                    "ttft_s": (
                        None if req.first_token_t is None
                        else req.first_token_t - req.submit_t
                    ),
                    "e2e_s": req.finish_t - req.submit_t,
                })
                del self._requests[rid]
                self._slot_req[s] = -1
                self._set_length(s, 0)
                self._clear_table(s)

    # ---- internals ----

    def _read_page(self, page: int):
        """Snapshot one pool page to host numpy (swap-out)."""
        pools = tuple(getattr(self.state, f) for f in self._pool_fields)
        self.stats["device_calls"] += 1
        return jax.device_get(self._page_read_fn(pools, jnp.int32(page)))

    def _write_page(self, page: int, blob):
        """Upload a swapped-out page's KV into pool page `page`."""
        pools = tuple(getattr(self.state, f) for f in self._pool_fields)
        new = self._page_write_fn(
            pools, tuple(jnp.asarray(b) for b in blob), jnp.int32(page)
        )
        self.state = dataclasses.replace(
            self.state, **dict(zip(self._pool_fields, new))
        )
        self.stats["device_calls"] += 1

    def _grant_prefixes(self, restore: bool = True):
        """Re-derive cache grants for every waiting request immediately
        before an admission attempt (grants are advisory; deriving them
        here means eviction can never leave a stale grant dangling).

        With a host-swap tier, a chain that runs past the device entries
        continues from host RAM: each consecutive swapped block is
        restored into a fresh pinned page, bounded so the request's own
        prompt suffix still fits in the remaining free pages (restoring
        must never starve the admission it serves). `restore=False` is
        used inside the page-starved eviction retry loop, where restoring
        would immediately re-take the page eviction just freed."""
        in_slots = set(self._slot_req)
        for rid, req in self._requests.items():
            if rid in in_slots:
                continue
            pages = self.prefix_cache.lookup(
                req.prompt, namespace=req.adapter
            )
            swap = self.prefix_cache.swap
            if restore and swap is not None and len(swap):
                ps = self.page_size
                suffix = len(req.prompt) - len(pages) * ps
                budget = (
                    self.sched.num_free_pages - -(-suffix // ps) - 1
                )
                pages += self.prefix_cache.restore(
                    req.prompt, req.adapter, len(pages), budget
                )
                self.stats["swap_in_pages"] = self.prefix_cache.swap_in_pages
            self.sched.grant_prefix(rid, pages)
            self._granted[rid] = len(pages) * self.page_size
            partial = self.prefix_cache.lookup_partial(
                req.prompt, req.adapter, len(pages)
            )
            if partial is not None:
                self._granted_partial[rid] = partial
            else:
                self._granted_partial.pop(rid, None)

    def _sched_admit(self) -> int:
        if self.prefix_cache is None:
            return self.sched.admit()
        self._grant_prefixes()
        n = self.sched.admit()
        # Page-starved admission with cached-but-idle pages: evict LRU
        # entries and retry while ANY free slot remains unfilled (not
        # just when nothing was admitted) — a partially-admitted wave
        # staggers the rest into later engine rounds, and each straggler
        # wave costs an extra extend + decode-scan round trip.
        free = sum(1 for r in self._slot_req if r == -1)
        while (
            n < free and self.sched.num_waiting > 0
            and len(self.prefix_cache)
        ):
            self.prefix_cache.evict(1)
            self.stats["prefix_evictions"] += 1
            self.stats["swap_out_pages"] = self.prefix_cache.swap_out_pages
            self._grant_prefixes(restore=False)
            n += self.sched.admit()
        return n

    def _step_slot_evicting(self, s: int) -> int:
        """step_slot with cache-eviction retry before the caller falls
        back to preemption: idle cached pages go first."""
        r = self.sched.step_slot(s)
        if r == 1 or self.prefix_cache is None:
            return r
        while len(self.prefix_cache):
            self.prefix_cache.evict(1)
            self.stats["prefix_evictions"] += 1
            self.stats["swap_out_pages"] = self.prefix_cache.swap_out_pages
            r = self.sched.step_slot(s)
            if r == 1:
                return r
        return r

    def _apply_partial(self, s: int, rid: int, shared: int) -> int:
        """Consume a tail-page grant: clone the shared rows of the cached
        tail page into this slot's first private page (the page right
        after the granted full blocks), extending `shared` mid-page. The
        clone is bit-identical to recomputing those rows (KV at position
        p is a pure function of tokens 0..p), so the suffix forward that
        follows sees exactly the state a full prefill would have built.

        The device copy is DEFERRED: entries accumulate per admission
        wave and `_flush_partials` issues them as one batched dispatch
        instead of one per slot."""
        partial = self._granted_partial.pop(rid, None)
        if partial is None:
            return shared
        src, rows = partial
        row = self.sched.table_row(rid)
        full = shared // self.page_size
        dst = int(row[full])
        if dst <= 0 or dst == src:
            return shared
        self._pending_partials[s] = (src, dst, rows)
        self._last_partial[s] = (src, dst, rows)
        return shared + rows

    def _flush_partials(self):
        """Issue the still-pending partial-page clones (chunk-walk slots;
        group-admitted slots fold theirs into their extend forward) as
        ONE batched device call, padded to a power of two (one compile
        per pow2 wave size). Must run before any forward that reads the
        cloned rows — _admit calls it ahead of _advance_prefills'
        chunk walk."""
        if not self._pending_partials:
            return
        entries = list(self._pending_partials.values())
        self._pending_partials = {}
        g = len(entries)
        g_pad = 1 << (g - 1).bit_length()
        srcs = np.zeros((g_pad,), np.int32)
        dsts = np.zeros((g_pad,), np.int32)
        rows = np.zeros((g_pad,), np.int32)
        for i, (src, dst, r) in enumerate(entries):
            srcs[i], dsts[i], rows[i] = src, dst, r
        pools = tuple(getattr(self.state, f) for f in self._pool_fields)
        new = self._partial_copy_fn(
            pools, jnp.asarray(srcs), jnp.asarray(dsts), jnp.asarray(rows)
        )
        self.state = dataclasses.replace(
            self.state, **dict(zip(self._pool_fields, new))
        )
        self.stats["device_calls"] += 1

    def _admit(self):
        before = {s: self.sched.slot_id(s) for s in range(self.slots)}
        self._last_partial = {}
        if self._sched_admit() == 0:
            return
        # Batch same-bucket admissions into one prefill program: a burst of
        # arrivals costs one forward instead of one per request.
        groups: dict[int, list[int]] = {}
        for s in range(self.slots):
            rid = self.sched.slot_id(s)
            if rid != -1 and before[s] == -1:
                self._slot_req[s] = rid
                shared = (
                    self._granted.get(rid, 0)
                    if self.prefix_cache is not None else 0
                )
                if self.prefix_cache is not None:
                    shared = self._apply_partial(s, rid, shared)
                if self.prefill_chunk > 0:
                    # Chunked admission: mark the slot; chunks advance one
                    # per engine round (interleaved with decode). A cached
                    # prefix simply starts the chunk walk at `shared`.
                    req = self._requests[rid]
                    self.stats["prefills"] += 1
                    req.generated = []
                    req.logprobs = []
                    self._prefilling[s] = shared
                    self.stats["prefix_hit_tokens"] += shared
                    self._sync_table(s)
                    self._set_length(s, 0)
                    continue
                self._admit_shared[s] = shared
                b = _bucket(len(self._requests[rid].prompt) - shared)
                groups.setdefault(b, []).append(s)
        # CROSS-bucket grouping (round 3): chunks are cut from the
        # bucket-descending order and padded to the chunk's max bucket —
        # shorter prompts ride along as padded rows (valid_len already
        # masks them), so a mixed-length arrival burst still costs
        # ceil(n / prefill_group) forwards instead of one per bucket.
        # Sorting descending keeps the padding waste minimal; with
        # prefill_group == 1 this degenerates to exactly the old
        # one-bucket-per-call behavior.
        step = self.prefill_group
        flat = [
            (bucket, s)
            for bucket in sorted(groups, reverse=True)
            for s in groups[bucket]
        ]
        for i in range(0, len(flat), step):
            chunk = flat[i : i + step]
            self._prefill_group(chunk[0][0], [s for _, s in chunk])
        # Chunk-walk slots' tail-page clones (group-admitted slots folded
        # theirs into their extend forward above): one batched dispatch.
        self._flush_partials()

    def _prefill_group(self, bucket: int, slots: list[int]):
        # Recompute semantics after preemption: greedy decoding replays the
        # same tokens, so restarting from the prompt alone is equivalent
        # (sampling uses per-(request, position) keys — also replay-stable).
        g = len(slots)
        reqs = [self._requests[self._slot_req[s]] for s in slots]
        ids = np.zeros((g, bucket), np.int32)
        plens = np.zeros((g,), np.int32)
        shareds = np.zeros((g,), np.int32)
        for i, (s, req) in enumerate(zip(slots, reqs)):
            self.stats["prefills"] += 1
            req.generated = []
            req.logprobs = []
            plens[i] = len(req.prompt)
            shareds[i] = self._admit_shared.pop(s, 0)
            suffix = req.prompt[int(shareds[i]) :]
            ids[i, : len(suffix)] = suffix
            self.stats["prefix_hit_tokens"] += int(shareds[i])
        # Subclasses mirroring this admission (speculative draft pools)
        # need the same shared-prefix offsets.
        self._last_prefill_shared = {
            s: int(shareds[i]) for i, s in enumerate(slots)
        }
        for s in slots:
            self._sync_table(s)
            self._set_length(s, 0)

        # Pad the group to a power of two: one compile per (bucket, pow2)
        # instead of per exact group size. Dummy rows carry an all-zeros
        # page-table row, so their scatters land in the null page.
        g_pad = 1 << (g - 1).bit_length()
        if g_pad != g:
            ids = np.pad(ids, ((0, g_pad - g), (0, 0)))
            plens_in = np.concatenate(
                [plens, np.ones((g_pad - g,), np.int32)]
            )
        else:
            plens_in = plens

        # Fancy-indexed gathers always copy, so donation of `sub` cannot
        # delete the engine's full-batch metadata arrays.
        idxs = np.asarray(slots, np.int64)
        table = self.state.page_table[idxs]
        if g_pad != g:
            table = jnp.concatenate(
                [table, jnp.zeros((g_pad - g, table.shape[1]), jnp.int32)]
            )
        if self.lora is None:
            sub_ids = None
        else:
            sub_ids = jnp.asarray(
                [
                    self._requests[self._slot_req[s]].adapter
                    for s in slots
                ]
                + [0] * (g_pad - g),
                jnp.int32,
            )
        if self.prefix_cache is not None:
            # Suffix-only admission: the chunk sits at global positions
            # shared..shared+bucket-1 and attends the cached prefix pages
            # plus itself (the paged extend route); rows without a
            # cached prefix have shared == 0, which is exactly prefill.
            sub_lens = np.concatenate(
                [shareds, np.zeros((g_pad - g,), np.int32)]
            ) if g_pad != g else shareds
            sub = dataclasses.replace(
                self.state,
                page_table=table,
                lengths=jnp.asarray(sub_lens),
            )
            # Fold this group's partial-page tail clones into the SAME
            # compiled program (a pre-attention pool clone inside
            # forward_paged) instead of a separate copy dispatch per
            # wave.
            partial_copy = None
            pending = [self._pending_partials.pop(s, None) for s in slots]
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
            logits, sub = forward_paged(
                self.params, self.cfg, jnp.asarray(ids), sub, mode="extend",
                interpret=self.interpret, mesh=self.mesh,
                lora=self.lora, adapter_ids=sub_ids,
                partial_copy=partial_copy,
            )
        else:
            sub = dataclasses.replace(
                self.state,
                page_table=table,
                lengths=jnp.zeros((g_pad,), jnp.int32),
            )
            logits, sub = forward_paged(
                self.params, self.cfg, jnp.asarray(ids), sub, mode="prefill",
                valid_len=jnp.asarray(plens_in),
                interpret=self.interpret, mesh=self.mesh,
                lora=self.lora, adapter_ids=sub_ids,
            )
        self.stats["device_calls"] += 1
        # Merge back every pool field (k/v pages or quantized values+scales);
        # per-slot metadata stays with the engine's full-batch arrays.
        pool_fields = {
            f.name for f in dataclasses.fields(self.state)
        } - {"page_table", "lengths"}
        self.state = dataclasses.replace(
            self.state,
            **{name: getattr(sub, name) for name in pool_fields},
            lengths=self.state.lengths.at[jnp.asarray(idxs)].set(
                jnp.asarray(plens)
            ),
        )
        # Select + sample on DEVICE; fetch only [g] token ids (full-vocab
        # logits are half a megabyte per row).
        last_logits = logits[jnp.arange(g), plens - 1 - shareds]  # [g, V]
        if any(
            r.logit_bias or r.min_new_tokens > 0 or r.constrain
            or r.has_penalties
            for r in reqs
        ):
            rows = []
            for i, r in enumerate(reqs):
                rows.append(
                    self._shape_logits(
                        last_logits[i : i + 1], r, 0, self.eos_token_id
                    )[0]
                )
            last_logits = jnp.stack(rows)
        if self.sampling is not None and self.sampling.temperature > 0.0:
            from flash_attention_cute.runtime.sampling import (
                filter_logits,
            )

            keys = [
                jax.random.fold_in(
                    jax.random.fold_in(
                        jax.random.key(0), self._req_seed(req.req_id)
                    ),
                    0,
                )
                for req in reqs
            ]
            dist = filter_logits(last_logits[:g], self.sampling)
            firsts = np.asarray(
                jax.vmap(jax.random.categorical)(jnp.stack(keys), dist),
                np.int32,
            )
        else:
            dist = last_logits[:g]
            firsts = np.asarray(jnp.argmax(dist, axis=-1), np.int32)
        if self.return_logprobs:
            first_lps = np.asarray(jnp.take_along_axis(
                jax.nn.log_softmax(dist, axis=-1),
                jnp.asarray(firsts)[:, None], axis=1,
            )[:, 0], np.float32)
        now = time.monotonic()
        for i, (s, req) in enumerate(zip(slots, reqs)):
            req.generated.append(int(firsts[i]))
            if self.return_logprobs:
                req.logprobs.append(float(first_lps[i]))
            if req.first_token_t is None:
                req.first_token_t = now
            self.stats["tokens_generated"] += 1
            # Count the sampled token against the budget/pages.
            self.sched.step_slot(s)
            self._sync_table(s)
        if self.prefix_cache is not None:
            for req in reqs:
                self.prefix_cache.insert(
                    req.prompt, self.sched.table_row(req.req_id),
                    namespace=req.adapter,
                )

    def _advance_prefills(self):
        """Scatter + attend ONE prompt chunk for EVERY chunk-admitting slot
        in a single extend forward (batched over slots).

        Each main-state length stays 0 until that slot's whole prompt is in
        (so decode rounds mask it); progress lives host-side and flows into
        the extend forward via a sub-state whose rows are the admitting
        slots, padded to a power-of-two row count (one compile per pow2
        group, not per slot count). Prompts are padded to a chunk multiple:
        padded rows scatter K/V at positions > plen, which per-row
        causality keeps invisible to real rows and which decode overwrites
        before ever reading. Batching matters because per-slot dispatch is
        the dominant cost of serial admission (N prefilling slots used to
        cost N device round trips per round).
        """
        slots = sorted(self._prefilling)
        if not slots:
            return
        c = self.prefill_chunk
        g = len(slots)
        g_pad = 1 << (g - 1).bit_length()

        ids = np.zeros((g_pad, c), np.int32)
        progress = np.zeros((g_pad,), np.int32)
        for j, s in enumerate(slots):
            req = self._requests[self._slot_req[s]]
            p = self._prefilling[s]
            chunk_tokens = req.prompt[p : p + c]
            ids[j, : len(chunk_tokens)] = chunk_tokens
            progress[j] = p

        # Fancy-indexed gathers copy, so donating `sub` cannot delete the
        # engine's full-batch metadata arrays. Dummy pad rows carry the
        # all-zeros table: their scatters land in the null page.
        idxs = np.asarray(slots, np.int64)
        table = self.state.page_table[idxs]
        if g_pad != g:
            table = jnp.concatenate(
                [table, jnp.zeros((g_pad - g, table.shape[1]), jnp.int32)]
            )
        sub = dataclasses.replace(
            self.state,
            page_table=table,
            lengths=jnp.asarray(progress),
        )
        logits, sub = forward_paged(
            self.params, self.cfg, jnp.asarray(ids), sub, mode="extend",
            interpret=self.interpret, mesh=self.mesh,
            lora=self.lora,
            adapter_ids=(
                None if self.lora is None
                else jnp.asarray(
                    [
                        self._requests[self._slot_req[s]].adapter
                        for s in slots
                    ]
                    + [0] * (g_pad - g),
                    jnp.int32,
                )
            ),
        )
        self.stats["device_calls"] += 1
        pool_fields = {
            f.name for f in dataclasses.fields(self.state)
        } - {"page_table", "lengths"}
        self.state = dataclasses.replace(
            self.state,
            **{name: getattr(sub, name) for name in pool_fields},
        )

        for j, s in enumerate(slots):
            rid = self._slot_req[s]
            req = self._requests[rid]
            p = self._prefilling[s] + c
            plen = len(req.prompt)
            if p < plen:
                self._prefilling[s] = p
                continue
            # Admission complete: publish the real length, sample token 0.
            # (p - c is the chunk's start position — with a cached prefix
            # the walk starts at `shared`, not 0, so the last real token's
            # in-chunk index is plen-1-(p-c), not (plen-1) % c.)
            del self._prefilling[s]
            self._set_length(s, plen)
            last_logits = logits[j : j + 1, plen - 1 - (p - c)]
            if (req.logit_bias or req.min_new_tokens > 0 or req.constrain
                    or req.has_penalties):
                last_logits = self._shape_logits(
                    last_logits, req, 0, self.eos_token_id
                )
            if self.sampling is not None and self.sampling.temperature > 0.0:
                from flash_attention_cute.runtime.sampling import (
                    filter_logits,
                )

                key = jax.random.fold_in(
                    jax.random.fold_in(
                        jax.random.key(0), self._req_seed(rid)
                    ),
                    0,
                )
                dist = filter_logits(last_logits, self.sampling)
                first = int(jax.random.categorical(key, dist[0]))
            else:
                dist = last_logits
                first = int(jnp.argmax(dist[0]))
            req.generated.append(first)
            if self.return_logprobs:
                req.logprobs.append(float(
                    jax.nn.log_softmax(dist[0])[first]
                ))
            if req.first_token_t is None:
                req.first_token_t = time.monotonic()
            self.stats["tokens_generated"] += 1
            self.sched.step_slot(s)
            self._sync_table(s)
            if self.prefix_cache is not None:
                self.prefix_cache.insert(
                    req.prompt, self.sched.table_row(rid),
                    namespace=req.adapter,
                )

    def _adapter_ids(self, slots=None):
        """Per-row adapter ids for a forward ([all slots] by default);
        None when the engine has no LoRA adapters loaded."""
        if self.lora is None:
            return None
        rows = range(self.slots) if slots is None else slots
        ids = [
            (
                self._requests[self._slot_req[s]].adapter
                if 0 <= s < self.slots and self._slot_req[s] != -1
                else 0
            )
            for s in rows
        ]
        return jnp.asarray(ids, jnp.int32)

    def _dfa_arrays(self):
        """Per-slot (automaton state, constrained?) device inputs derived
        from each request's generated stream — host-side derivation makes
        chunk boundaries and preemption recompute exact."""
        if self.dfa is None:
            return None, None
        ds = np.zeros((self.slots,), np.int32)
        cm = np.zeros((self.slots,), bool)
        trans = np.asarray(self.dfa["transitions"])
        for s in range(self.slots):
            rid = self._slot_req[s]
            if rid == -1 or not self._requests[rid].constrain:
                continue
            cm[s] = True
            st = self.dfa_start
            for tok in self._requests[rid].generated:
                st = int(trans[st, tok])
            ds[s] = st
        return jnp.asarray(ds), jnp.asarray(cm)

    def _guided_arrays(self, slots_or_rids, by_slot: bool):
        """Per-row (bias [n, V] | None, min_tokens [n] | None) device
        inputs for guided decoding; None when no listed request uses the
        feature (keeps the unguided compile signature)."""
        rids = [
            (self._slot_req[s] if by_slot else s) for s in slots_or_rids
        ]
        reqs = [self._requests.get(r) for r in rids]
        any_bias = any(r is not None and r.logit_bias for r in reqs)
        any_min = any(r is not None and r.min_new_tokens > 0 for r in reqs)
        bias = None
        if any_bias:
            v = self.cfg.vocab_size
            b = np.zeros((len(reqs), v), np.float32)
            for i, r in enumerate(reqs):
                if r is not None and r.logit_bias:
                    for tok, val in r.logit_bias.items():
                        b[i, int(tok)] = val
            bias = jnp.asarray(b)
        mins = None
        if any_min and self.eos_token_id is not None:
            mins = jnp.asarray(
                [0 if r is None else r.min_new_tokens for r in reqs],
                jnp.int32,
            )
        return bias, mins

    def _penalty_arrays(self, slots_or_rids, by_slot: bool):
        """Per-row penalty inputs for a decode/verify scan: {"prompt"/"out"
        [n, V] f32 token-count planes, "rep"/"pres"/"freq" [n]} — or None
        when no listed request uses penalties (keeps the penalty-free
        compile signature). Counts derive from the host request streams,
        so chunk boundaries and preemption recompute stay exact (the
        `_dfa_arrays` pattern); penalty-free rows carry neutral values."""
        rids = [
            (self._slot_req[s] if by_slot else s) for s in slots_or_rids
        ]
        reqs = [self._requests.get(r) for r in rids]
        if not any(r is not None and r.has_penalties for r in reqs):
            return None
        v = self.cfg.vocab_size
        n = len(reqs)
        prompt = np.zeros((n, v), np.float32)
        out = np.zeros((n, v), np.float32)
        rep = np.ones((n,), np.float32)
        pres = np.zeros((n,), np.float32)
        freq = np.zeros((n,), np.float32)
        for i, r in enumerate(reqs):
            if r is None or not r.has_penalties:
                continue
            np.add.at(prompt[i], np.asarray(r.prompt, np.int64), 1.0)
            if r.generated:
                np.add.at(out[i], np.asarray(r.generated, np.int64), 1.0)
            rep[i], pres[i], freq[i] = (
                r.rep_penalty, r.pres_penalty, r.freq_penalty
            )
        return {
            "prompt": jnp.asarray(prompt), "out": jnp.asarray(out),
            "rep": jnp.asarray(rep), "pres": jnp.asarray(pres),
            "freq": jnp.asarray(freq),
        }

    def _shape_logits(self, last_logits, req, position: int, eos_token_id):
        """Apply a single request's guided-decoding shaping to a [1, V]
        logits row (admission-time token sampling)."""
        if req.has_penalties:
            from flash_attention_cute.runtime.sampling import (
                apply_penalties,
            )

            v = last_logits.shape[-1]
            pc = np.zeros((v,), np.float32)
            np.add.at(pc, np.asarray(req.prompt, np.int64), 1.0)
            oc = np.zeros((v,), np.float32)
            if req.generated:
                np.add.at(oc, np.asarray(req.generated, np.int64), 1.0)
            last_logits = apply_penalties(
                last_logits, jnp.asarray(pc)[None], jnp.asarray(oc)[None],
                jnp.asarray([req.rep_penalty], jnp.float32),
                jnp.asarray([req.pres_penalty], jnp.float32),
                jnp.asarray([req.freq_penalty], jnp.float32),
            )
        if req.logit_bias:
            idx = jnp.asarray(
                [int(t) for t in req.logit_bias], jnp.int32
            )
            vals = jnp.asarray(
                [float(v) for v in req.logit_bias.values()], jnp.float32
            )
            last_logits = last_logits.at[0, idx].add(vals)
        if (
            eos_token_id is not None
            and position + 1 < req.min_new_tokens
        ):
            last_logits = last_logits.at[0, eos_token_id].set(-jnp.inf)
        if req.constrain and self.dfa is not None:
            # Token 0 is emitted from the DFA start state (the prompt
            # does not advance the automaton).
            last_logits = last_logits + self.dfa["bias"][self.dfa_start]
        return last_logits

    def _check_stops(self, req) -> None:
        """Truncate `generated` at the first completed stop sequence and
        pin the budget there (idempotent; mirrors EOS-inside-chunk)."""
        if not req.stop_sequences:
            return
        g = req.generated
        best = None
        for stop in req.stop_sequences:
            ln = len(stop)
            if ln == 0:
                continue
            for end in range(ln, len(g) + 1):
                if g[end - ln : end] == stop:
                    best = end if best is None else min(best, end)
                    break
        if best is not None:
            del g[best:]
            del req.logprobs[best:]
            req.max_new_tokens = len(g)

    def _req_seed(self, rid: int) -> int:
        """Per-request sampling seed: stable across preemption-recompute so
        a replayed request samples the identical token stream."""
        return (self.seed * 1_000_003 + rid) & 0x7FFFFFFF

    def _sync_table(self, slot: int):
        rid = self._slot_req[slot]
        if rid == -1:
            return
        row = np.asarray(self.sched.table_row(rid), np.int32)
        self.state = dataclasses.replace(
            self.state,
            page_table=self.state.page_table.at[slot].set(jnp.asarray(row)),
        )

    def _set_length(self, slot: int, value: int):
        self.state = dataclasses.replace(
            self.state,
            lengths=self.state.lengths.at[slot].set(value),
        )

    def _clear_table(self, slot: int):
        """Point a freed slot's page-table row at the null page: the
        inactive-slot dummy scatter in forward_paged must never land in a
        page that has been handed to another request."""
        self.state = dataclasses.replace(
            self.state,
            page_table=self.state.page_table.at[slot].set(0),
        )

    def _evict(self, slot: int, requeue: bool = False, failed: bool = False):
        rid = self._slot_req[slot]
        if rid == -1:
            return
        if failed:
            self._failed.append(rid)
            self.stats["requests_failed"] += 1
            del self._requests[rid]
        self._prefilling.pop(slot, None)
        self._slot_req[slot] = -1
        self._set_length(slot, 0)
        self._clear_table(slot)

    def _drain_unservable(self) -> bool:
        """No slot active but requests wait: if admission is gated/starved
        forever (prompt larger than the whole pool), fail them."""
        if self._sched_admit() > 0:
            for s in range(self.slots):
                rid = self.sched.slot_id(s)
                if rid != -1 and self._slot_req[s] == -1:
                    self._slot_req[s] = rid
                    req = self._requests[rid]
                    self._prefill_group(_bucket(len(req.prompt)), [s])
            return True
        # Nothing admissible with an empty batch -> unservable requests.
        return False


class _PyScheduler:
    """Pure-Python fallback mirroring csrc/page_allocator.cpp::Scheduler."""

    def __init__(self, num_pages, page_size, pages_per_seq, slots):
        from flash_attention_cute.runtime.paged_cache import PageAllocator

        self.alloc = PageAllocator(num_pages, page_size, pages_per_seq)
        self.slots = slots
        # (id, plen, max_new, priority, seq); admission picks highest
        # priority then FIFO — mirrors csrc/page_allocator.cpp.
        self.waiting: list[tuple] = []
        self.running: dict[int, list] = {}  # slot -> [id,plen,max,gen,pri,seq]
        self.next_seq = 0
        self.stalled = False
        self.pages_per_seq = pages_per_seq
        self.page_size = self.alloc.page_size
        # Prefix-cache grants: rid -> cached prefix pages to share at
        # admission. Advisory and consumed per admission attempt — the
        # engine re-grants from the live cache before every admit().
        self.grants: dict[int, list[int]] = {}

    def submit(self, rid, plen, max_new, priority=0):
        self.waiting.append((rid, plen, max_new, priority, self.next_seq))
        self.next_seq += 1

    def grant_prefix(self, rid, pages):
        self.grants[rid] = list(pages)

    def _next_waiting(self):
        best = -1
        for i, (_, _, _, pri, seq) in enumerate(self.waiting):
            if best == -1 or (pri, -seq) > (
                self.waiting[best][3], -self.waiting[best][4]
            ):
                best = i
        return best

    def admit(self):
        if self.stalled:
            return 0
        n = 0
        for s in range(self.slots):
            if not self.waiting or s in self.running:
                continue
            widx = self._next_waiting()
            rid, plen, max_new, pri, seq = self.waiting[widx]
            pages = self.grants.pop(rid, [])
            granted = len(pages) * self.page_size
            assert granted <= max(plen - 1, 0), (granted, plen)
            if pages and not self.alloc.share(rid, pages):
                self.alloc.release(rid)
                break
            if not self.alloc.allocate(rid, granted, plen - granted):
                self.alloc.release(rid)  # undo the shared prefix
                break
            self.waiting.pop(widx)
            self.running[s] = [rid, plen, max_new, 0, pri, seq]
            n += 1
        return n

    def pin_page(self, page):
        return self.alloc.pin(page)

    def unpin_page(self, page):
        self.alloc.unpin(page)

    def page_refcount(self, page):
        return self.alloc.refcount(page)

    def take_free_page(self):
        return self.alloc.take_free_page()

    def step_slot(self, s):
        if s not in self.running:
            return -1
        rid, plen, max_new, gen = self.running[s][:4]
        if not self.alloc.allocate(rid, plen + gen, 1):
            self.stalled = True
            return 0
        self.stalled = False
        self.running[s][3] += 1
        return 1

    def finished(self, s):
        return s in self.running and self.running[s][3] >= self.running[s][2]

    def release_slot(self, s, requeue=False):
        if s not in self.running:
            return
        rid, plen, max_new, _, pri, seq = self.running.pop(s)
        self.alloc.release(rid)
        if requeue:
            # Original seq preserved: the victim keeps its FIFO standing
            # within its priority class on re-admission.
            self.waiting.insert(0, (rid, plen, max_new, pri, seq))
        else:
            self.stalled = False

    def preempt_youngest(self):
        """Lowest priority first, youngest arrival within it."""
        if len(self.running) <= 1:
            return -1
        victim = -1
        for s in sorted(self.running, reverse=True):
            if victim == -1 or (
                self.running[s][4], -self.running[s][5]
            ) < (self.running[victim][4], -self.running[victim][5]):
                victim = s
        self.release_slot(victim, requeue=True)
        return victim

    def slot_id(self, s):
        return self.running[s][0] if s in self.running else -1

    def slot_generated(self, s):
        return self.running[s][3] if s in self.running else -1

    @property
    def num_waiting(self):
        return len(self.waiting)

    @property
    def num_free_pages(self):
        return self.alloc.num_free

    def table_row(self, rid):
        return self.alloc.table_row(rid)
