"""Automatic prefix caching: shared-prompt KV reuse across requests.

Beyond the reference (whose cache story is HF DynamicCache per request,
reference: models/rope_attn_fwd.py:90-93): requests whose prompts share a
page-aligned token prefix reuse the SAME physical KV pages — admission
prefills only the unseen suffix (one paged-extend forward over the cached
prefix), so repeated system prompts / few-shot preambles cost their KV
once per pool lifetime instead of once per request.

Split of responsibilities:
  * the ALLOCATOR (csrc/page_allocator.cpp + the Python lockstep twin)
    owns page lifetime via reference counts — a page is owned by every
    sequence table referencing it plus one count per cache pin; the free
    list holds exactly the refcount-0 pages;
  * this module owns the content map: an exact-key (structural prefix
    equality — no hash-collision wrong-KV risk) LRU from page-aligned
    token-block chains to page ids, holding one pin per entry;
  * the ENGINE grants lookups to the scheduler immediately before every
    admission (grants are advisory and re-derived each round, so eviction
    can never dangle), admits suffix-only, and inserts the new prompt's
    blocks once its admission completes.

Safety of sharing: KV at position p depends only on tokens 0..p (causal
attention, absolute RoPE positions), so identical aligned prefixes have
bit-identical KV; writers never touch shared blocks because a request's
first written position is >= its shared-prefix length (the engine caps
sharing at prompt_len - 1 so every admission re-extends at least one
token — an idempotent rewrite when it lands inside a shared page).
"""

from __future__ import annotations

from collections import OrderedDict


class HostSwapTier:
    """Host-RAM second tier for evicted prefix blocks (vLLM-style CPU
    swap, sized in tokens). Eviction from the device-page LRU spills the
    page's KV (all layers, host numpy) here instead of dropping it; a
    later lookup that runs past the device chain restores blocks into
    fresh pages — one host->device upload per block instead of
    recomputing the prefill.

    Pure host data structure: an LRU of chain-key -> opaque KV blob (the
    engine owns the page<->blob serialization). Capacity is in tokens so
    sizing is dtype-agnostic at this layer."""

    def __init__(self, capacity_tokens: int, page_size: int):
        self.page_size = page_size
        self.max_entries = max(1, capacity_tokens // page_size)
        self.entries: OrderedDict[tuple, object] = OrderedDict()

    def __len__(self) -> int:
        return len(self.entries)

    def put(self, key: tuple, blob) -> None:
        if key in self.entries:
            self.entries.move_to_end(key)
            self.entries[key] = blob
            return
        while len(self.entries) >= self.max_entries:
            self.entries.popitem(last=False)
        self.entries[key] = blob

    def take(self, key: tuple):
        """Pop and return the blob for key (None on miss). Popping (not
        peeking) keeps exactly one owner per blob: once restored to a
        device page the device LRU owns it again, and a later eviction
        re-spills the CURRENT bytes (identical — shared pages are
        immutable — so no coherence hazard either way)."""
        return self.entries.pop(key, None)


class PrefixCache:
    """Exact-key LRU over page-aligned prompt blocks.

    Entries map a block-chain key (structurally, the whole token prefix)
    to the page id holding that block's KV; each entry holds one
    scheduler pin. `sched` must expose pin_page/unpin_page (both the
    native and Python schedulers do).
    """

    def __init__(self, sched, page_size: int, max_entries: int = 0,
                 swap: HostSwapTier | None = None, read_page=None,
                 write_page=None, max_partials: int = 64):
        self.sched = sched
        self.page_size = page_size
        self.max_entries = max_entries  # 0 = bounded by the pool itself
        self.entries: OrderedDict[tuple, int] = OrderedDict()
        self.hit_tokens = 0
        self.lookup_tokens = 0
        # Host-swap tier (optional): read_page(page) -> blob snapshots a
        # device page to host; write_page(page, blob) uploads one back.
        self.swap = swap
        self._read_page = read_page
        self._write_page = write_page
        self.swap_out_pages = 0
        self.swap_in_pages = 0
        # Partial-page tails: chain-key -> (tail tokens, page). A prompt
        # whose divergence point sits MID-page shares the tail page's
        # common rows by COPY (the engine clones them into the new
        # request's first private page — shared pages are never aliased
        # mid-page, because the owner keeps appending to its tail page).
        # One tail per chain key (most recent wins), device-only (never
        # swapped), own small LRU.
        self.max_partials = max_partials
        self.partials: OrderedDict[tuple, tuple] = OrderedDict()

    def __len__(self) -> int:
        """Evictable entries (full blocks + tail partials) — the engine's
        page-starved retry loops key on this reaching zero."""
        return len(self.entries) + len(self.partials)

    def _chain(self, prompt: list[int], namespace: int = 0):
        """Yield (key, block_index) for each shareable full block: block k
        is shareable iff (k+1)*ps <= len(prompt) - 1 (always leave at
        least one suffix token for the admission forward to produce the
        first-token logits from). `namespace` partitions the cache — KV
        depends on the adapter under multi-LoRA serving, so each adapter
        id keys its own chains (no cross-adapter sharing, ever)."""
        key = (namespace,)
        ps = self.page_size
        for k in range((len(prompt) - 1) // ps):
            key = (key, tuple(prompt[k * ps : (k + 1) * ps]))
            yield key, k

    def _chain_key(self, prompt: list[int], k: int, namespace: int):
        """Chain key covering the first k full blocks of prompt."""
        key = (namespace,)
        ps = self.page_size
        for i in range(k):
            key = (key, tuple(prompt[i * ps : (i + 1) * ps]))
        return key

    def lookup(self, prompt: list[int], namespace: int = 0) -> list[int]:
        """Longest cached page chain for this prompt (LRU-refreshed)."""
        pages: list[int] = []
        for key, _ in self._chain(prompt, namespace):
            page = self.entries.get(key)
            if page is None:
                break
            self.entries.move_to_end(key)
            pages.append(page)
        self.lookup_tokens += (len(prompt) - 1) // self.page_size * \
            self.page_size
        self.hit_tokens += len(pages) * self.page_size
        return pages

    def insert(self, prompt: list[int], table_row, namespace: int = 0
               ) -> int:
        """Register a freshly admitted prompt's blocks. `table_row` is the
        request's page table (block k's KV lives in table_row[k]).
        Returns the number of new entries pinned."""
        added = 0
        for key, k in self._chain(prompt, namespace):
            if key in self.entries:
                self.entries.move_to_end(key)
                continue
            page = int(table_row[k])
            if page <= 0:  # null page — nothing real to share
                continue
            if self.max_entries and len(self.entries) >= self.max_entries:
                self.evict(1)
            if self.sched.pin_page(page):
                self.entries[key] = page
                added += 1
        self._insert_partial(prompt, table_row, namespace)
        return added

    def _insert_partial(self, prompt, table_row, namespace) -> None:
        """Record one trie edge per block boundary: after k full blocks,
        the (tokens, page) of block k — so a later prompt diverging INSIDE
        block k (at any boundary, not just the inserting prompt's last
        one) can share the common leading rows by copy. Tokens cap at the
        plen-1 sharing rule."""
        ps = self.page_size
        cap = len(prompt) - 1
        for k in range(cap // ps + 1):
            lo, hi = k * ps, min((k + 1) * ps, cap)
            if hi <= lo:
                break
            page = int(table_row[k])
            if page <= 0:
                continue
            key = self._chain_key(prompt, k, namespace)
            part = tuple(prompt[lo:hi])
            old = self.partials.get(key)
            if old is not None and old == (part, page):
                self.partials.move_to_end(key)
                continue
            if not self.sched.pin_page(page):
                continue
            old = self.partials.pop(key, None)
            if old is not None:
                self.sched.unpin_page(old[1])
            self.partials[key] = (part, page)
            while len(self.partials) > self.max_partials:
                _, (_, p_old) = self.partials.popitem(last=False)
                self.sched.unpin_page(p_old)

    def lookup_partial(self, prompt: list[int], namespace: int, have: int
                       ) -> tuple[int, int] | None:
        """(page, rows) of the tail-page entry continuing a `have`-block
        chain match, where rows = the common-prefix length between the
        stored tail tokens and this prompt's — None when nothing usable.
        The caller COPIES those rows into the request's own first private
        page (never aliases: the stored page's owner may keep appending
        to it past the recorded rows)."""
        ps = self.page_size
        entry = self.partials.get(self._chain_key(prompt, have, namespace))
        if entry is None:
            return None
        tokens, page = entry
        lim = min(len(tokens), (len(prompt) - 1) - have * ps)
        r = 0
        for a, b in zip(tokens[:lim], prompt[have * ps : have * ps + lim]):
            if a != b:
                break
            r += 1
        if r <= 0:
            return None
        self.partials.move_to_end(
            self._chain_key(prompt, have, namespace)
        )
        self.hit_tokens += r
        return page, r

    def restore(self, prompt: list[int], namespace: int, have: int,
                max_pages: int) -> list[int]:
        """Continue a device-chain lookup from the host-swap tier: for up
        to max_pages consecutive blocks past block index `have`, pop the
        blob, take a fresh PINNED page from the allocator, upload the KV,
        and re-insert the block into the device LRU. Returns the restored
        page ids (chain order) — the caller appends them to lookup()'s
        grant. Stops at the first swap miss or when the pool/budget runs
        out (a partial restore is still a valid shorter chain)."""
        if self.swap is None or max_pages <= 0:
            return []
        pages: list[int] = []
        restored = 0
        for key, k in self._chain(prompt, namespace):
            if k < have:
                continue
            if key in self.entries:
                # Back on the device tier already (another request's
                # insert landed it); treat as a device hit, keep walking.
                self.entries.move_to_end(key)
                pages.append(self.entries[key])
                continue
            if restored >= max_pages:
                break
            blob = self.swap.take(key)
            if blob is None:
                break
            page = self.sched.take_free_page()
            if page <= 0:
                self.swap.put(key, blob)  # no room — keep it host-side
                break
            self._write_page(page, blob)
            self.entries[key] = page  # take_free_page already pinned it
            self.swap_in_pages += 1
            self.hit_tokens += self.page_size
            restored += 1
            pages.append(page)
        return pages

    def evict(self, n: int) -> int:
        """Unpin the n least-recently-used entries. A page still
        referenced by live requests stays allocated (only its cache pin
        drops); a page nobody uses returns to the free list. With a swap
        tier, the page's KV is snapshotted to host RAM first (the bytes
        stay valid during the snapshot: the pin is only dropped after —
        and shared pages are never written in place anyway)."""
        done = 0
        # Tail-page entries go first: they save at most page_size-1 tokens
        # each and are never swapped (device-only by design).
        while self.partials and done < n:
            _, (_, page) = self.partials.popitem(last=False)
            self.sched.unpin_page(page)
            done += 1
        while self.entries and done < n:
            key, page = self.entries.popitem(last=False)
            if self.swap is not None:
                self.swap.put(key, self._read_page(page))
                self.swap_out_pages += 1
            self.sched.unpin_page(page)
            done += 1
        return done
