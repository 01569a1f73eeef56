"""Tracing / profiling helpers (SURVEY.md §5).

The reference's only profiling enablers are nvcc -lineinfo + NVTX linkage
for Nsight (reference: flash_attention/load_cpp_extention.py:37,
csrc/CMakeLists.txt:32-48) and CUDA-event timers in the benches. The JAX
equivalents here:

  * `trace(dir)` — context manager around jax.profiler: produces an xplane
    trace viewable in TensorBoard / Perfetto (the Nsight analog; Pallas
    kernels appear under their `name=` labels).
  * `annotate(name)` — TraceAnnotation for host-side phases.
  * `roofline(fn, *args)` — compiles fn, pulls XLA's cost analysis and the
    device's peak numbers, prints FLOP/s / bandwidth utilization — the
    per-kernel roofline the reference leaves to Nsight Compute.
"""

from __future__ import annotations

import contextlib

import jax

# Published peaks per device, keyed by `device_kind` as JAX reports it:
# (dense bf16 TFLOP/s, HBM GB/s). Source: NVIDIA H100 data sheet, SXM
# part, dense rates without sparsity, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
}


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace("traces/decode"):` — xplane trace for
    TensorBoard/Perfetto, written under `log_dir`."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Host-side phase annotation visible in the trace timeline."""
    return jax.profiler.TraceAnnotation(name)


def device_peaks(device_kind: str | None = None) -> tuple[float, float]:
    """(bf16 TFLOP/s, GB/s) of `device_kind` (default: the first device).
    A device missing from `PEAKS` is an error, not a default."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def roofline(fn, *args, seconds: float | None = None,
             device_kind: str | None = None, **kwargs) -> dict:
    """Static roofline for one jitted call against `device_kind`'s peaks
    (default: the device it runs on).

    Returns {flops, bytes, intensity, peak_tflops, peak_gbs,
    bound, min_time_us[, achieved_tflops, tc_util, achieved_gbs]}.
    `seconds` (measured runtime) adds achieved numbers.
    """
    lowered = jax.jit(fn).lower(*args, **kwargs)
    cost = lowered.compile().cost_analysis()
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    peak_tflops, peak_gbs = device_peaks(device_kind)

    t_compute = flops / (peak_tflops * 1e12)
    t_memory = bytes_accessed / (peak_gbs * 1e9)
    out = {
        "flops": flops,
        "bytes": bytes_accessed,
        "intensity": flops / max(bytes_accessed, 1.0),
        "peak_tflops": peak_tflops,
        "peak_gbs": peak_gbs,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "min_time_us": max(t_compute, t_memory) * 1e6,
    }
    if seconds is not None:
        out["achieved_tflops"] = flops / seconds / 1e12
        out["tc_util"] = out["achieved_tflops"] / peak_tflops
        out["achieved_gbs"] = bytes_accessed / seconds / 1e9
    return out


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the cards of this
    host, read by a child process that stays off JAX. A card set below
    its maximum power limit runs slower under load, so every measurement
    reports this line beside its numbers."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU: a measurement that finds no
    card fails instead of falling back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this measurement runs only on the card"
        )
    return dev
