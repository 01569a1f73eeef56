"""Automatic prefix caching: shared-prompt KV reuse across requests.

Exactness contract: enabling the cache must never change any output —
admission merely skips recomputing KV for page-aligned prefixes that are
byte-identical (causal attention + absolute positions make KV a pure
function of the token prefix). Page lifetime rides allocator refcounts
(tests/test_native_runtime.py covers backend lockstep); these tests cover
the engine behavior: hits, sharing, eviction, and composition with
chunked admission, quantized pools, and speculative serving.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models import init_params
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.runtime.engine import ServingEngine

POOL = dict(slots=2, num_pages=65, page_size=8, pages_per_seq=16)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(num_layers=2)
    return cfg, init_params(cfg, jax.random.key(0))


def _shared_prompts(cfg, n=4, sys_len=17, seed=0):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, sys_len).tolist()
    return {
        100 + i: system + rng.integers(0, cfg.vocab_size, 4 + i).tolist()
        for i in range(n)
    }


def _run(model, prompts, n_new, **kw):
    cfg, params = model
    eng = ServingEngine(params, cfg, interpret=True, **(POOL | kw))
    for rid, p in prompts.items():
        eng.submit(rid, p, n_new)
    return eng.run(), eng


def test_prefix_cache_exact_and_hits(model):
    cfg, _ = model
    prompts = _shared_prompts(cfg)
    want, _ = _run(model, prompts, 5)
    got, eng = _run(model, prompts, 5, enable_prefix_cache=True)
    assert got == want
    # 17-token shared prefix = 2 full 8-token blocks; every request after
    # the first admission wave hits them.
    assert eng.stats["prefix_hit_tokens"] >= 16
    assert not eng.failed


def test_prefix_cache_pages_physically_shared(model):
    """Two same-prefix requests decoding CONCURRENTLY must point their
    leading page-table entries at the SAME physical pages."""
    cfg, params = model
    prompts = _shared_prompts(cfg, n=3)
    eng = ServingEngine(params, cfg, interpret=True,
                        enable_prefix_cache=True, decode_chunk=2, **POOL)
    rids = list(prompts)
    # Admit the first alone so its blocks enter the cache, then the rest
    # (small decode chunks keep both requests live mid-flight).
    eng.submit(rids[0], prompts[rids[0]], 20)
    eng.step()
    eng.submit(rids[1], prompts[rids[1]], 20)
    eng.step()
    slots = {eng._slot_req[s]: s for s in range(eng.slots)}
    assert rids[0] in slots and rids[1] in slots
    t0 = np.asarray(eng.state.page_table[slots[rids[0]]])
    t1 = np.asarray(eng.state.page_table[slots[rids[1]]])
    np.testing.assert_array_equal(t0[:2], t1[:2])  # 2 shared blocks
    assert (t0[:2] > 0).all()
    assert t0[2] != t1[2]  # private suffix pages differ
    results = eng.run()
    # Outputs still match the uncached engine.
    want, _ = _run(model, {r: prompts[r] for r in rids[:2]}, 20,
                   decode_chunk=2)
    assert {r: results[r] for r in rids[:2]} == want


def test_prefix_cache_survives_owner_completion(model):
    """The caching request finishes and its slot releases while a sharing
    request still decodes on those pages; outputs stay exact (refcounts
    keep the pages alive)."""
    cfg, params = model
    prompts = _shared_prompts(cfg, n=2)
    rids = list(prompts)
    n_new = {rids[0]: 2, rids[1]: 12}  # owner finishes early
    cfgp = dict(POOL)
    eng = ServingEngine(params, cfg, interpret=True,
                        enable_prefix_cache=True, **cfgp)
    for rid in rids:
        eng.submit(rid, prompts[rid], n_new[rid])
    got = eng.run()
    base = ServingEngine(params, cfg, interpret=True, **cfgp)
    for rid in rids:
        base.submit(rid, prompts[rid], n_new[rid])
    want = base.run()
    assert got == want


def test_prefix_cache_eviction_under_pressure(model):
    """A pool too small to hold the cache + live sequences must evict LRU
    entries rather than fail admissions; outputs stay exact."""
    cfg, _ = model
    # DISTINCT prompts: every admission inserts new blocks, so the cache
    # fills with entries nobody shares and must give them back under
    # pool pressure.
    rng = np.random.default_rng(3)
    prompts = {
        200 + i: rng.integers(0, cfg.vocab_size, 21 + i).tolist()
        for i in range(6)
    }
    want, _ = _run(model, prompts, 6)
    got, eng = _run(model, prompts, 6, enable_prefix_cache=True,
                    num_pages=13)
    assert got == want
    assert eng.stats["prefix_evictions"] > 0, eng.stats
    assert not eng.failed


def test_prefix_cache_chunked_admission(model):
    """Chunked admission starts its chunk walk at the cached-prefix
    offset; outputs match the uncached chunked engine."""
    cfg, _ = model
    prompts = _shared_prompts(cfg, n=3, sys_len=21, seed=5)
    want, _ = _run(model, prompts, 6, prefill_chunk=8)
    got, eng = _run(model, prompts, 6, prefill_chunk=8,
                    enable_prefix_cache=True)
    assert got == want
    assert eng.stats["prefix_hit_tokens"] >= 16


def test_prefix_cache_quantized_pool(model):
    """int8 pages share identically (values + scales ride the same page
    indices)."""
    cfg, _ = model
    prompts = _shared_prompts(cfg, n=3, seed=7)
    want, _ = _run(model, prompts, 5, kv_dtype=jnp.int8)
    got, eng = _run(model, prompts, 5, kv_dtype=jnp.int8,
                    enable_prefix_cache=True)
    assert got == want
    assert eng.stats["prefix_hit_tokens"] >= 16


def test_prefix_cache_speculative_engine(model):
    """Speculative serving over cached prefixes: the draft pool rides the
    same shared pages (its KV was mirrored at first admission), outputs
    stay exact vs the plain engine."""
    from flash_attention_cute.runtime.spec_engine import (
        SpeculativeServingEngine,
    )

    cfg, params = model
    dcfg = tiny_test_config(num_layers=1, hidden_size=32,
                            intermediate_size=64)
    dparams = init_params(dcfg, jax.random.key(7))
    prompts = _shared_prompts(cfg, n=3, seed=9)
    want, _ = _run(model, prompts, 6)

    eng = SpeculativeServingEngine(
        params, cfg, draft_params=dparams, draft_cfg=dcfg, gamma=3,
        interpret=True, enable_prefix_cache=True, **POOL,
    )
    for rid, p in prompts.items():
        eng.submit(rid, p, 6)
    got = eng.run()
    assert got == want
    assert eng.stats["prefix_hit_tokens"] >= 16
    assert not eng.failed


def test_prefix_cache_helps_preemption_recompute(model):
    """A preempted request re-admits through its own cached prefix (the
    recompute skips the cached blocks) and outputs stay exact."""
    cfg, _ = model
    prompts = _shared_prompts(cfg, n=2, sys_len=17, seed=11)
    want, _ = _run(model, prompts, 10)
    got, eng = _run(model, prompts, 10, enable_prefix_cache=True,
                    num_pages=11)
    assert got == want
    assert not eng.failed


def test_host_swap_tier_lru_unit():
    from flash_attention_cute.runtime.prefix_cache import HostSwapTier

    t = HostSwapTier(capacity_tokens=24, page_size=8)  # 3 entries
    for i in range(5):
        t.put((i,), i * 10)
    assert len(t) == 3
    assert t.take((0,)) is None and t.take((1,)) is None  # LRU-dropped
    assert t.take((4,)) == 40
    assert t.take((4,)) is None  # take pops: single owner per blob


def test_host_swap_restore_exact_and_counted(model):
    """Evicted prefix blocks restore from host RAM: after a full cache
    spill, a same-prefix request is served via swap-in page uploads (no
    prefill recompute) and outputs stay exact."""
    cfg, params = model
    prompts = _shared_prompts(cfg, n=4, sys_len=17, seed=13)
    rids = list(prompts)
    want, _ = _run(model, prompts, 5)

    eng = ServingEngine(params, cfg, interpret=True,
                        enable_prefix_cache=True,
                        host_swap_tokens=1024, **POOL)
    got = {}
    for rid in rids[:2]:  # first wave populates the cache
        eng.submit(rid, prompts[rid], 5)
    got.update(eng.run())
    n = len(eng.prefix_cache)
    assert n >= 2
    eng.prefix_cache.evict(n)  # spill EVERYTHING to the host tier
    assert eng.prefix_cache.swap_out_pages >= 2
    assert len(eng.prefix_cache) == 0
    for rid in rids[2:]:  # second wave shares the same 2-block prefix
        eng.submit(rid, prompts[rid], 5)
    got.update(eng.run())
    assert got == want
    assert eng.stats["swap_in_pages"] >= 2
    assert eng.stats["prefix_hit_tokens"] >= 16


def test_host_swap_quantized_pool(model):
    """Swap blobs carry the int8 values AND their scale planes."""
    cfg, params = model
    prompts = _shared_prompts(cfg, n=4, sys_len=17, seed=17)
    rids = list(prompts)
    want, _ = _run(model, prompts, 5, kv_dtype=jnp.int8)

    eng = ServingEngine(params, cfg, interpret=True, kv_dtype=jnp.int8,
                        enable_prefix_cache=True,
                        host_swap_tokens=1024, **POOL)
    got = {}
    for rid in rids[:2]:
        eng.submit(rid, prompts[rid], 5)
    got.update(eng.run())
    eng.prefix_cache.evict(len(eng.prefix_cache))
    for rid in rids[2:]:
        eng.submit(rid, prompts[rid], 5)
    got.update(eng.run())
    assert got == want
    assert eng.stats["swap_in_pages"] >= 2


def test_host_swap_under_pool_pressure_terminates(model):
    """Page-starved admission with a swap tier must not thrash (the
    eviction retry loop re-derives grants WITHOUT restoring — otherwise a
    restore would re-take the page eviction just freed): distinct prompts
    over a tiny pool terminate with exact outputs."""
    cfg, _ = model
    rng = np.random.default_rng(19)
    prompts = {
        300 + i: rng.integers(0, cfg.vocab_size, 21 + i).tolist()
        for i in range(6)
    }
    want, _ = _run(model, prompts, 6)
    got, eng = _run(model, prompts, 6, enable_prefix_cache=True,
                    host_swap_tokens=512, num_pages=13)
    assert got == want
    assert eng.stats["prefix_evictions"] > 0
    assert eng.stats["swap_out_pages"] > 0
    assert not eng.failed


class _FakeSched:
    def __init__(self):
        self.refs = {}

    def pin_page(self, p):
        self.refs[p] = self.refs.get(p, 0) + 1
        return True

    def unpin_page(self, p):
        self.refs[p] -= 1


def test_partial_lookup_divergence_unit():
    from flash_attention_cute.runtime.prefix_cache import PrefixCache

    pc = PrefixCache(_FakeSched(), page_size=8)
    prompt_a = list(range(21))  # 2 full blocks + tail rows (16..19)
    row = np.arange(1, 17)
    pc.insert(prompt_a, row)
    assert len(pc.partials) == 3  # one trie edge per block boundary
    # Same 2 full blocks, first 2 tail tokens match, then divergence.
    prompt_b = list(range(18)) + [99, 98, 97]
    assert len(pc.lookup(prompt_b)) == 2
    page, r = pc.lookup_partial(prompt_b, 0, 2)
    assert page == int(row[2]) and r == 2
    # Fully divergent tail: no partial.
    prompt_c = list(range(16)) + [50, 51, 52, 53]
    assert pc.lookup_partial(prompt_c, 0, 2) is None
    # Tail rows are capped at the owner's plen-1: identical prompt can
    # share at most its own r=4 recorded rows.
    page, r = pc.lookup_partial(prompt_a, 0, 2)
    assert (page, r) == (int(row[2]), 4)


def test_partial_page_sharing_exact_and_counted(model):
    """21-token shared prefix = 2 full 8-token blocks + 5 tail rows; with
    partial sharing every later request shares all 21 tokens (32 would be
    the full-blocks-only ceiling for two second-wave requests)."""
    cfg, _ = model
    prompts = _shared_prompts(cfg, n=4, sys_len=21, seed=23)
    want, _ = _run(model, prompts, 5)
    got, eng = _run(model, prompts, 5, enable_prefix_cache=True)
    assert got == want
    assert len(eng.prefix_cache.partials) >= 1
    assert eng.stats["prefix_hit_tokens"] >= 2 * 21
    assert not eng.failed


def test_partial_page_sharing_chunked_admission(model):
    cfg, _ = model
    prompts = _shared_prompts(cfg, n=3, sys_len=21, seed=29)
    want, _ = _run(model, prompts, 6, prefill_chunk=8)
    got, eng = _run(model, prompts, 6, prefill_chunk=8,
                    enable_prefix_cache=True)
    assert got == want
    assert eng.stats["prefix_hit_tokens"] >= 21


def test_partial_page_sharing_quantized_pool(model):
    """The tail-row clone copies int8 values AND scale planes."""
    cfg, _ = model
    prompts = _shared_prompts(cfg, n=3, sys_len=21, seed=31)
    want, _ = _run(model, prompts, 5, kv_dtype=jnp.int8)
    got, eng = _run(model, prompts, 5, kv_dtype=jnp.int8,
                    enable_prefix_cache=True)
    assert got == want
    assert eng.stats["prefix_hit_tokens"] >= 21


def test_partial_page_sharing_speculative_engine(model):
    """The draft pool receives the same tail-row clone (same page ids),
    so speculative verify stays exact over mid-page shared prefixes."""
    from flash_attention_cute.runtime.spec_engine import (
        SpeculativeServingEngine,
    )

    cfg, params = model
    dcfg = tiny_test_config(num_layers=1, hidden_size=32,
                            intermediate_size=64)
    dparams = init_params(dcfg, jax.random.key(7))
    prompts = _shared_prompts(cfg, n=3, sys_len=21, seed=37)
    want, _ = _run(model, prompts, 6)

    eng = SpeculativeServingEngine(
        params, cfg, draft_params=dparams, draft_cfg=dcfg, gamma=3,
        interpret=True, enable_prefix_cache=True, **POOL,
    )
    for rid, p in prompts.items():
        eng.submit(rid, p, 6)
    got = eng.run()
    assert got == want
    assert eng.stats["prefix_hit_tokens"] >= 21
    assert not eng.failed
