"""Test harness configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding is
exercised without cards (XLA collectives are the same code on one host or
many). Attention takes its plain XLA routes on the CPU; tests that pass
`interpret=True` run the Pallas paged-decode kernel on the Pallas
interpreter. Tests that need a card carry the `gpu` marker and skip here
(see `gpu_device`).

Must run before any jax import, hence module-level env mutation in conftest.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def mesh8():
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devices = np.array(jax.devices()).reshape(2, 4)
    return Mesh(devices, axis_names=("data", "model"))


@pytest.fixture
def gpu_device():
    """The first device, for tests marked `gpu`; skips the test when JAX
    runs on no GPU. Decided here, at run time, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_mmap_growth():
    """Every XLA CPU executable holds several mmaps and jit caches never
    drop them; a full-suite process crosses vm.max_map_count (65530)
    after ~150 tests and the NEXT compile segfaults inside
    backend_compile (reproduced deterministically; maps grow ~70/test).
    Clearing the compiled-function caches at module boundaries keeps the
    map count bounded at the cost of cross-module recompiles."""
    jax.clear_caches()
    yield
