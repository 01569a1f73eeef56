"""Shared utilities: timing, profiling, the compile cache."""

from flash_attention_cute.utils.timing import time_fn  # noqa: F401
