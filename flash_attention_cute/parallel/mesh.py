"""Device mesh construction."""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(
    data: int | None = None,
    model: int | None = None,
    devices=None,
) -> Mesh:
    """Build a ('data', 'model') mesh over the available devices.

    Defaults: all devices on the model axis (tensor parallelism first —
    attention heads and MLP columns shard without collectives inside
    attention; see guide §14 head-parallel sharding).
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    assert data * model == n, (data, model, n)
    dev_array = np.array(devices).reshape(data, model)
    return Mesh(dev_array, axis_names=("data", "model"))


def init_distributed(**kwargs) -> None:
    """Multi-host bring-up: `jax.distributed.initialize`.

    The distributed-communication backend the reference lacks entirely
    (SURVEY.md §2.4: no init_process_group/NCCL anywhere). On GPU hosts
    pass `coordinator_address`, `num_processes` and `process_id`
    explicitly: nothing in the environment describes the cluster.
    Idempotent.
    """
    import jax

    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def host_local_mesh_info(mesh: Mesh) -> dict:
    """Which mesh coordinates this host owns (debug/observability)."""
    import jax

    local = set(d.id for d in jax.local_devices())
    coords = [
        tuple(int(c) for c in idx)
        for idx, d in np.ndenumerate(mesh.devices)
        if d.id in local
    ]
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_coords": coords,
    }
