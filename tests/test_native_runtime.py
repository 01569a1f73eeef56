"""Native (C++) runtime components vs the pure-Python reference.

The native tier (csrc/page_allocator.cpp + ctypes loader runtime/native.py)
must stay in lockstep with runtime/paged_cache.py::PageAllocator — same
free-list order, same OOM behavior, same page-table rows — so either can
serve the engine. The scheduler's FCFS + preemption policy is exercised
directly.
"""

import numpy as np
import pytest

from flash_attention_cute.runtime.paged_cache import PageAllocator

native = pytest.importorskip("flash_attention_cute.runtime.native")

if native.load() is None:
    pytest.skip("native library unavailable", allow_module_level=True)


def test_allocator_lockstep_with_python():
    py = PageAllocator(num_pages=16, page_size=8, pages_per_seq=6)
    cc = native.NativePageAllocator(16, 8, 6)

    rng = np.random.default_rng(0)
    live = []
    for step in range(200):
        if live and rng.random() < 0.3:
            sid = live.pop(rng.integers(len(live)))
            py.release(sid)
            cc.release(sid)
        else:
            sid = step
            cur = int(rng.integers(0, 40))
            new = int(rng.integers(1, 30))
            ok_py = py.allocate(sid, cur, new)
            ok_cc = cc.allocate(sid, cur, new)
            assert ok_py == ok_cc, (step, cur, new)
            if ok_py:
                live.append(sid)
        assert py.num_free == cc.num_free, step
        for sid in live:
            np.testing.assert_array_equal(py.table_row(sid), cc.table_row(sid))


def test_allocator_pages_needed():
    cc = native.NativePageAllocator(64, 16, 32)
    py = PageAllocator(64, 16, 32)
    for cur in (0, 1, 15, 16, 17, 100):
        for new in (1, 15, 16, 33):
            assert cc.pages_needed(cur, new) == py.pages_needed(cur, new)


def test_scheduler_fcfs_admission_and_completion():
    # 15 usable pages (page 0 reserved), page_size 4, 2 slots.
    s = native.NativeScheduler(16, 4, 8, slots=2)
    s.submit(100, prompt_len=8, max_new_tokens=3)   # 2 pages
    s.submit(101, prompt_len=4, max_new_tokens=2)   # 1 page
    s.submit(102, prompt_len=4, max_new_tokens=1)   # waits for a slot
    assert s.admit() == 2
    assert s.slot_id(0) == 100 and s.slot_id(1) == 101
    assert s.num_waiting == 1

    done = {}
    for _ in range(10):
        for slot in range(2):
            if s.slot_id(slot) == -1:
                continue
            r = s.step_slot(slot)
            assert r == 1
            if s.finished(slot):
                done[s.slot_id(slot)] = s.slot_generated(slot)
                s.release_slot(slot, requeue=False)
        s.admit()
        if len(done) == 3:
            break
    assert done == {100: 3, 101: 2, 102: 1}
    assert s.num_waiting == 0


def test_scheduler_preemption_on_page_exhaustion():
    # 3 usable pages, page_size 4: two requests of 1 page each admit; their
    # decode growth exhausts pages; youngest must be preempted and later
    # finish after the older one releases.
    s = native.NativeScheduler(4, 4, 4, slots=2)
    s.submit(1, prompt_len=4, max_new_tokens=6)  # 1 page, grows to 3
    s.submit(2, prompt_len=4, max_new_tokens=6)
    assert s.admit() == 2

    finished = []
    for _ in range(50):
        for slot in range(2):
            if s.slot_id(slot) == -1:
                continue
            r = s.step_slot(slot)
            if r == 0:  # decode OOM -> preempt the youngest
                victim = s.preempt_youngest()
                assert victim != -1
                continue
            if s.finished(slot):
                finished.append(s.slot_id(slot))
                s.release_slot(slot, requeue=False)
        s.admit()
        if len(finished) == 2:
            break
    assert sorted(finished) == [1, 2]
    # all pages back in the pool
    assert s.num_free_pages == 3


def test_make_page_allocator_prefers_native():
    a = native.make_page_allocator(8, 4, 4)
    assert isinstance(a, native.NativePageAllocator)


def test_scheduler_lockstep_with_python():
    """Random-driven parity: the C++ scheduler and the Python fallback
    must make IDENTICAL decisions (admission, step results, preemption
    victims, slot assignments) for the same request stream."""
    from flash_attention_cute.runtime.engine import _PyScheduler

    def mk():
        return (
            native.NativeScheduler(12, 4, 8, slots=3),
            _PyScheduler(12, 4, 8, slots=3),
        )

    cc, py = mk()
    rng = np.random.default_rng(7)
    next_id = 0
    for step in range(300):
        op = rng.random()
        if op < 0.25:
            plen = int(rng.integers(1, 20))
            mnew = int(rng.integers(1, 10))
            cc.submit(next_id, plen, mnew)
            py.submit(next_id, plen, mnew)
            next_id += 1
        elif op < 0.45:
            assert cc.admit() == py.admit()
        elif op < 0.85:
            s = int(rng.integers(0, 3))
            assert cc.step_slot(s) == py.step_slot(s), step
        elif op < 0.95:
            assert cc.preempt_youngest() == py.preempt_youngest(), step
        else:
            s = int(rng.integers(0, 3))
            assert cc.finished(s) == py.finished(s)
            if cc.finished(s):
                cc.release_slot(s, requeue=False)
                py.release_slot(s, requeue=False)
        assert cc.num_waiting == py.num_waiting, step
        assert cc.num_free_pages == py.num_free_pages, step
        for s in range(3):
            assert cc.slot_id(s) == py.slot_id(s), (step, s)
            assert cc.slot_generated(s) == py.slot_generated(s), (step, s)


def test_refcount_share_pin_semantics():
    """Prefix-cache allocator primitives: shared pages survive their
    original owner's release; a cache pin keeps a page alive with no
    owners; unpinning the last reference frees it (both backends)."""
    for alloc in (PageAllocator(16, 8, 6),
                  native.NativePageAllocator(16, 8, 6)):
        assert alloc.allocate(1, 0, 16)  # 2 pages
        pages = [int(p) for p in alloc.table_row(1)[:2]]
        assert alloc.share(2, pages)
        assert not alloc.share(3, [15])  # free page: not shareable
        free_before = alloc.num_free
        alloc.release(1)
        assert alloc.num_free == free_before  # still owned by 2
        assert alloc.pin(pages[0])
        alloc.release(2)
        assert alloc.num_free == free_before + 1  # page[1] freed
        assert alloc.refcount(pages[0]) == 1  # the pin
        alloc.unpin(pages[0])
        assert alloc.num_free == free_before + 2
        assert alloc.refcount(pages[0]) == 0
        assert not alloc.pin(pages[0])  # free pages cannot be pinned
        # take_free_page (host-swap restore): hands out a pinned table-less
        # page; unpin returns it.
        free_now = alloc.num_free
        p = alloc.take_free_page()
        assert p > 0 and alloc.refcount(p) == 1
        assert alloc.num_free == free_now - 1
        alloc.unpin(p)
        assert alloc.num_free == free_now


def test_scheduler_lockstep_with_prefix_grants():
    """Random-driven parity including the prefix-cache operations: grants
    consumed at admission, shared pages refcounted identically, pins and
    evictions keeping both backends' free lists in lockstep."""
    from flash_attention_cute.runtime.engine import _PyScheduler

    cc = native.NativeScheduler(14, 4, 8, slots=3)
    py = _PyScheduler(14, 4, 8, slots=3)
    rng = np.random.default_rng(11)
    next_id = 0
    pinned: list[int] = []
    for step in range(400):
        op = rng.random()
        if op < 0.22:
            plen = int(rng.integers(2, 20))
            mnew = int(rng.integers(1, 8))
            cc.submit(next_id, plen, mnew)
            py.submit(next_id, plen, mnew)
            # Sometimes grant a (valid-by-construction) cached prefix:
            # pages currently pinned, prefix strictly under plen-1.
            if pinned and rng.random() < 0.6:
                max_blocks = min(len(pinned), (plen - 1) // 4)
                k = int(rng.integers(0, max_blocks + 1))
                if k:
                    grant = pinned[:k]
                    cc.grant_prefix(next_id, grant)
                    py.grant_prefix(next_id, grant)
            next_id += 1
        elif op < 0.42:
            assert cc.admit() == py.admit()
        elif op < 0.62:
            s = int(rng.integers(0, 3))
            assert cc.step_slot(s) == py.step_slot(s)
        elif op < 0.72:
            s = int(rng.integers(0, 3))
            rq = bool(rng.random() < 0.5)
            if cc.slot_id(s) != -1:
                # Pin one of the slot's pages before releasing sometimes
                # (the prefix cache does exactly this at admission).
                row = cc.table_row(cc.slot_id(s))
                live = [int(p) for p in row if p > 0]
                if live and rng.random() < 0.5:
                    p0 = live[0]
                    assert cc.pin_page(p0) == py.pin_page(p0)
                    if cc.page_refcount(p0) > 0:
                        pinned.append(p0)
            assert cc.slot_id(s) == py.slot_id(s)
            cc.release_slot(s, requeue=rq)
            py.release_slot(s, requeue=rq)
        elif op < 0.80 and pinned:
            p0 = pinned.pop(int(rng.integers(0, len(pinned))))
            cc.unpin_page(p0)
            py.unpin_page(p0)
        elif op < 0.86:
            # Host-swap restore primitive: both backends must hand out the
            # same free page, pre-pinned.
            a, b = cc.take_free_page(), py.take_free_page()
            assert a == b, step
            if a > 0:
                assert cc.page_refcount(a) == py.page_refcount(a) == 1
                pinned.append(a)
        else:
            assert cc.preempt_youngest() == py.preempt_youngest()
        assert cc.num_free_pages == py.num_free_pages, step
        assert cc.num_waiting == py.num_waiting, step
        for s in range(3):
            assert cc.slot_id(s) == py.slot_id(s), step
            sid = cc.slot_id(s)
            if sid != -1:
                np.testing.assert_array_equal(
                    cc.table_row(sid), py.table_row(sid), err_msg=str(step)
                )
        for p0 in pinned:
            assert cc.page_refcount(p0) == py.page_refcount(p0), step


def test_priority_scheduling_lockstep_and_semantics():
    """Priority classes: admission picks highest-priority-then-FIFO,
    preemption evicts lowest-priority-then-youngest — identically in
    both backends."""
    from flash_attention_cute.runtime.engine import _PyScheduler

    for mk in (lambda: native.NativeScheduler(32, 4, 8, slots=2),
               lambda: _PyScheduler(32, 4, 8, slots=2)):
        s = mk()
        s.submit(1, 4, 2)                 # priority 0
        s.submit(2, 4, 2)                 # priority 0
        s.submit(3, 4, 2, 5)              # priority 5, arrives last
        assert s.admit() == 2
        # Highest priority admitted first despite arriving last.
        ids = {s.slot_id(0), s.slot_id(1)}
        assert 3 in ids and 1 in ids, ids
        # Preemption victims: lowest priority goes first.
        v = s.preempt_youngest()
        assert s.slot_id(v) == -1
        live = {s.slot_id(t) for t in range(2)} - {-1}
        assert live == {3}

    # Random-driven parity with priorities in the stream.
    cc = native.NativeScheduler(14, 4, 8, slots=3)
    py = _PyScheduler(14, 4, 8, slots=3)
    rng = np.random.default_rng(23)
    nid = 0
    for step in range(300):
        op = rng.random()
        if op < 0.3:
            plen = int(rng.integers(2, 16))
            mnew = int(rng.integers(1, 6))
            pri = int(rng.integers(0, 3))
            cc.submit(nid, plen, mnew, pri)
            py.submit(nid, plen, mnew, pri)
            nid += 1
        elif op < 0.55:
            assert cc.admit() == py.admit(), step
        elif op < 0.75:
            t = int(rng.integers(0, 3))
            assert cc.step_slot(t) == py.step_slot(t), step
        elif op < 0.85:
            t = int(rng.integers(0, 3))
            rq = bool(rng.random() < 0.5)
            assert cc.slot_id(t) == py.slot_id(t)
            cc.release_slot(t, requeue=rq)
            py.release_slot(t, requeue=rq)
        else:
            assert cc.preempt_youngest() == py.preempt_youngest(), step
        assert cc.num_free_pages == py.num_free_pages, step
        for t in range(3):
            assert cc.slot_id(t) == py.slot_id(t), step
