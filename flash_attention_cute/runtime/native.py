"""Import-time build + ctypes loader for the native runtime library.

The analog of the reference's JIT C++ extension loader
(reference: flash_attention/load_cpp_extention.py:23-53): compile the
native source on first import, cache the shared object, expose the API.
Differences by design: the compute kernels here are compiled by XLA (and
Pallas), so the native library carries only host-side serving-loop components
(page allocator + continuous-batching scheduler, csrc/page_allocator.cpp),
and the binding is a C ABI over ctypes instead of pybind11 (no build-time
Python dependency at all).

Environment knobs:
  FACT_NATIVE=0        disable (pure-Python fallbacks are used)
  FACT_NATIVE_CXX=...  compiler (default g++)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys
import tempfile

_SRC = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "page_allocator.cpp"


def _build_cached(src: pathlib.Path) -> pathlib.Path | None:
    """Compile src to a content-addressed .so in `.native_build/` at the
    root of the checkout (listed in .gitignore)."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    cache_root = src.parents[2] / ".native_build"
    so_path = cache_root / f"{src.stem}-{digest}.so"
    if so_path.exists():
        return so_path
    cache_root.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("FACT_NATIVE_CXX", "g++")
    with tempfile.TemporaryDirectory(dir=cache_root) as td:
        tmp = pathlib.Path(td) / so_path.name
        cmd = [
            cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
            str(src), "-o", str(tmp),
        ]
        try:
            subprocess.run(
                cmd, check=True, capture_output=True, timeout=120
            )
        except (subprocess.SubprocessError, OSError) as e:
            print(
                f"flash_attention_cute: native build failed ({e}); "
                "using pure-Python runtime",
                file=sys.stderr,
            )
            return None
        os.replace(tmp, so_path)  # atomic publish
    return so_path


_lib = None


def load() -> ctypes.CDLL | None:
    """Build (once) and load the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("FACT_NATIVE", "1") == "0":
        return None
    so = _build_cached(_SRC)
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))

    c_void = ctypes.c_void_p
    c_int = ctypes.c_int
    c_i64 = ctypes.c_int64
    c_i32p = ctypes.POINTER(ctypes.c_int32)

    sigs = {
        "pa_create": ([c_int, c_int, c_int], c_void),
        "pa_destroy": ([c_void], None),
        "pa_num_free": ([c_void], c_int),
        "pa_pages_needed": ([c_void, c_int, c_int], c_int),
        "pa_allocate": ([c_void, c_i64, c_int, c_int], c_int),
        "pa_release": ([c_void, c_i64], None),
        "pa_table_row": ([c_void, c_i64, c_i32p, c_int], c_int),
        "sched_create": ([c_int, c_int, c_int, c_int], c_void),
        "sched_destroy": ([c_void], None),
        "sched_submit": ([c_void, c_i64, c_int, c_int], None),
        "sched_submit_priority": ([c_void, c_i64, c_int, c_int, c_int],
                                  None),
        "sched_admit": ([c_void], c_int),
        "sched_step_slot": ([c_void, c_int], c_int),
        "sched_finished": ([c_void, c_int], c_int),
        "sched_release_slot": ([c_void, c_int, c_int], None),
        "sched_preempt_youngest": ([c_void], c_int),
        "sched_slot_id": ([c_void, c_int], c_i64),
        "sched_slot_generated": ([c_void, c_int], c_int),
        "sched_num_waiting": ([c_void], c_int),
        "sched_table_row": ([c_void, c_i64, c_i32p, c_int], c_int),
        "sched_num_free_pages": ([c_void], c_int),
        "sched_grant_prefix": ([c_void, c_i64, c_i32p, c_int], None),
        "sched_pin_page": ([c_void, ctypes.c_int32], c_int),
        "sched_unpin_page": ([c_void, ctypes.c_int32], None),
        "sched_page_refcount": ([c_void, ctypes.c_int32], c_int),
        "sched_take_free_page": ([c_void], c_int),
        "pa_take_free_page": ([c_void], c_int),
        "pa_share": ([c_void, c_i64, c_i32p, c_int], c_int),
        "pa_pin": ([c_void, ctypes.c_int32], c_int),
        "pa_unpin": ([c_void, ctypes.c_int32], None),
        "pa_refcount": ([c_void, ctypes.c_int32], c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


class NativePageAllocator:
    """ctypes facade matching runtime.paged_cache.PageAllocator's API."""

    def __init__(self, num_pages: int, page_size: int, pages_per_seq: int):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self._h = self._lib.pa_create(num_pages, page_size, pages_per_seq)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.pa_destroy(h)

    @property
    def num_free(self) -> int:
        return self._lib.pa_num_free(self._h)

    def pages_needed(self, cur_len: int, new_tokens: int) -> int:
        return self._lib.pa_pages_needed(self._h, cur_len, new_tokens)

    def allocate(self, seq_id: int, cur_len: int, new_tokens: int) -> bool:
        return bool(self._lib.pa_allocate(self._h, seq_id, cur_len, new_tokens))

    def release(self, seq_id: int) -> None:
        self._lib.pa_release(self._h, seq_id)

    def share(self, seq_id: int, pages) -> bool:
        import numpy as np

        arr = np.asarray(list(pages), np.int32)
        return bool(self._lib.pa_share(
            self._h, seq_id,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(arr),
        ))

    def take_free_page(self) -> int:
        return self._lib.pa_take_free_page(self._h)

    def pin(self, page: int) -> bool:
        return bool(self._lib.pa_pin(self._h, page))

    def unpin(self, page: int) -> None:
        self._lib.pa_unpin(self._h, page)

    def refcount(self, page: int) -> int:
        return self._lib.pa_refcount(self._h, page)

    def table_row(self, seq_id: int):
        import numpy as np

        out = np.zeros((self.pages_per_seq,), np.int32)
        self._lib.pa_table_row(
            self._h, seq_id,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.pages_per_seq,
        )
        return out


class NativeScheduler:
    """Continuous-batching scheduler (FCFS + decode-OOM preemption)."""

    def __init__(self, num_pages: int, page_size: int, pages_per_seq: int,
                 slots: int):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self.slots = slots
        self.pages_per_seq = pages_per_seq
        self._h = self._lib.sched_create(
            num_pages, page_size, pages_per_seq, slots
        )

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.sched_destroy(h)

    def submit(self, req_id: int, prompt_len: int, max_new_tokens: int,
               priority: int = 0):
        self._lib.sched_submit_priority(
            self._h, req_id, prompt_len, max_new_tokens, priority
        )

    def admit(self) -> int:
        return self._lib.sched_admit(self._h)

    def step_slot(self, slot: int) -> int:
        return self._lib.sched_step_slot(self._h, slot)

    def finished(self, slot: int) -> bool:
        return bool(self._lib.sched_finished(self._h, slot))

    def release_slot(self, slot: int, requeue: bool = False):
        self._lib.sched_release_slot(self._h, slot, int(requeue))

    def preempt_youngest(self) -> int:
        return self._lib.sched_preempt_youngest(self._h)

    def slot_id(self, slot: int) -> int:
        return self._lib.sched_slot_id(self._h, slot)

    def slot_generated(self, slot: int) -> int:
        return self._lib.sched_slot_generated(self._h, slot)

    @property
    def num_waiting(self) -> int:
        return self._lib.sched_num_waiting(self._h)

    def grant_prefix(self, rid: int, pages) -> None:
        import numpy as np

        arr = np.asarray(list(pages), np.int32)
        self._lib.sched_grant_prefix(
            self._h, rid,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(arr),
        )

    def pin_page(self, page: int) -> bool:
        return bool(self._lib.sched_pin_page(self._h, page))

    def unpin_page(self, page: int) -> None:
        self._lib.sched_unpin_page(self._h, page)

    def page_refcount(self, page: int) -> int:
        return self._lib.sched_page_refcount(self._h, page)

    def take_free_page(self) -> int:
        return self._lib.sched_take_free_page(self._h)

    @property
    def num_free_pages(self) -> int:
        return self._lib.sched_num_free_pages(self._h)

    def table_row(self, seq_id: int):
        import numpy as np

        out = np.zeros((self.pages_per_seq,), np.int32)
        self._lib.sched_table_row(
            self._h, seq_id,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.pages_per_seq,
        )
        return out


def make_page_allocator(num_pages: int, page_size: int, pages_per_seq: int):
    """Native allocator when buildable, Python fallback otherwise."""
    try:
        return NativePageAllocator(num_pages, page_size, pages_per_seq)
    except (RuntimeError, OSError):
        from flash_attention_cute.runtime.paged_cache import PageAllocator

        return PageAllocator(num_pages, page_size, pages_per_seq)
