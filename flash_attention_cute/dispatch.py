"""Route selection and input validation for the attention ops.

`select_routes` is the one place that decides which implementation each
attention op takes. It reads the platform JAX runs on:

  * ``gpu``: dense attention goes to cuDNN's fused attention (through
    `jax.nn.dot_product_attention`) wherever cuDNN can express the call,
    and paged decode runs the Pallas kernel on the Triton route
    (ops/paged_attention.py);
  * ``cpu``: every op takes its plain XLA route.

`interpret=True` is the test suite's way to run the Pallas kernel on the
CPU interpreter. No production path sets it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Routes:
    """The implementation each attention op takes.

    dense:        "cudnn" | "xla" — prefill, extend, stacked-cache decode;
                  "cudnn" falls back to "xla" per call where cuDNN cannot
                  express it (ops/attention.py `cudnn_supports`).
    paged_decode: "triton" | "xla" — single-token decode over KV pages.
    """

    dense: str
    paged_decode: str


_PLATFORM_ROUTES = {
    "gpu": Routes(dense="cudnn", paged_decode="triton"),
    "cpu": Routes(dense="xla", paged_decode="xla"),
}


def select_routes(
    interpret: bool | None = None, platform: str | None = None
) -> Routes:
    """Routes for `platform` (default: the platform of `jax.devices()[0]`).

    With `interpret=True` the paged-decode kernel runs on the Pallas
    interpreter and dense attention takes the XLA route, so the CPU tests
    reach the same kernel code the GPU compiles.
    """
    if interpret:
        return Routes(dense="xla", paged_decode="triton")
    if platform is None:
        platform = jax.devices()[0].platform
    try:
        return _PLATFORM_ROUTES[platform]
    except KeyError:
        raise ValueError(
            f"no attention routes for platform {platform!r}; "
            f"supported: {sorted(_PLATFORM_ROUTES)}"
        ) from None


def validate_inputs(q, k, v) -> None:
    """Precondition checks mirroring the reference's TORCH_CHECK battery
    (reference: csrc/flash_attention_api.cpp:17-59), minus the stride checks
    that have no meaning for XLA arrays.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q/k/v must be rank-4 [B, H, S, D]; got {q.shape}, {k.shape}, {v.shape}"
        )
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes differ: {k.shape} vs {v.shape}")
    if q.shape[0] != k.shape[0]:
        raise ValueError(f"batch mismatch: {q.shape[0]} vs {k.shape[0]}")
    if q.shape[3] != k.shape[3]:
        raise ValueError(f"head_dim mismatch: {q.shape[3]} vs {k.shape[3]}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"num q heads ({q.shape[1]}) must be a multiple of num kv heads "
            f"({k.shape[1]})"
        )
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in (jnp.bfloat16, jnp.float16, jnp.float32):
        raise ValueError(
            f"unsupported dtype {q.dtype}; need bf16/f16/f32 "
            "(reference supports fp16/bf16, csrc/flash_attention_api.cpp:27-31)"
        )
    if q.shape[3] > 256:
        raise ValueError(
            f"head_dim {q.shape[3]} > 256 unsupported "
            "(reference caps at 128, csrc/flash_attention_api.cpp:47-49)"
        )
