"""Inference runtime: generation loops, sampling, batching.

The reference's runtime is the manual prefill + per-token decode loop in
its benchmark scripts (reference: scripts/benchmark_llm.py:47-92,
:95-118 `generate`); here it is a first-class, fully-jitted subsystem.
"""

from flash_attention_cute.runtime.generate import (
    generate,
    greedy_generate,
    prefill,
)
from flash_attention_cute.runtime.sampling import sample_token
from flash_attention_cute.runtime.speculative import speculative_generate
from flash_attention_cute.runtime.engine import ServingEngine
from flash_attention_cute.runtime.dp_engine import (
    DataParallelServingEngine,
)
from flash_attention_cute.runtime.spec_engine import (
    SpeculativeServingEngine,
)
from flash_attention_cute.runtime.beam_search import beam_generate
from flash_attention_cute.runtime.dfa_compile import compile_regex_dfa
from flash_attention_cute.runtime.prefix_cache import (
    HostSwapTier,
    PrefixCache,
)
from flash_attention_cute.runtime.multihost import (
    EngineWorker,
    MultiHostRouter,
)
from flash_attention_cute.runtime.prompt_lookup import (
    prompt_lookup_generate,
)

__all__ = [
    "generate", "greedy_generate", "prefill", "sample_token",
    "speculative_generate", "prompt_lookup_generate", "beam_generate",
    "ServingEngine", "DataParallelServingEngine", "compile_regex_dfa",
    "SpeculativeServingEngine", "PrefixCache", "HostSwapTier",
    "MultiHostRouter", "EngineWorker",
]
