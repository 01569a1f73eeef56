"""Data-parallel serving: one TP replica per 'data' slice of the mesh.

The round-1 engine was TP-only (`ServingEngine` asserts the mesh has no
data axis): weights, page pool and slot metadata are replicated or
model-sharded, so a data axis had nothing to shard. The DP design for
serving is therefore *replica parallelism* — the standard production
layout (the reference has no serving stack at all; its model-parallel
story is HF `device_map="auto"`, reference: scripts/benchmark_llm.py:136):

  * the ('data', 'model') mesh is split into `data` independent TP
    submeshes (one row of devices each);
  * each replica runs a full `ServingEngine` (own page pool, own
    scheduler, own compiled programs) over its submesh;
  * a SHARED admission queue routes each incoming request to the replica
    with the least outstanding work (prompt + budget tokens), so load
    balances across replicas while each request's tokens stay on one
    replica (no cross-replica KV traffic).

Throughput scales with `data`; per-request latency matches the TP engine.
"""

from __future__ import annotations

import numpy as np

from flash_attention_cute.runtime.engine import ServingEngine


class DataParallelServingEngine:
    """Shared-queue, least-loaded routing over per-data-shard TP engines.

    Accepts the same keyword arguments as `ServingEngine` (slots,
    num_pages, ... are PER REPLICA) plus the full ('data', 'model') mesh.
    A mesh without a data axis (or data == 1) degenerates to a single
    TP engine.
    """

    def __init__(
        self, params, cfg, *, mesh, engine_cls=ServingEngine,
        **engine_kwargs,
    ):
        from jax.sharding import Mesh

        shape = dict(mesh.shape)
        data = shape.get("data", 1)
        assert "model" in shape, mesh.shape
        self.replicas: list[ServingEngine] = []
        # mesh.devices is [data, model]; each row is one replica's TP mesh.
        # engine_cls lets replicas be any ServingEngine subclass (e.g.
        # SpeculativeServingEngine — pass its draft_params/draft_cfg/gamma
        # through engine_kwargs).
        devices = np.asarray(mesh.devices).reshape(data, shape["model"])
        for i in range(data):
            sub = Mesh(devices[i], ("model",))
            self.replicas.append(
                engine_cls(params, cfg, mesh=sub, **engine_kwargs)
            )
        self._route: dict[int, int] = {}  # req_id -> replica index
        self._load = [0] * data  # outstanding tokens (prompt + budget)
        self._charge: dict[int, int] = {}  # req_id -> tokens charged

    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    def submit(self, req_id: int, prompt: list[int], max_new_tokens: int,
               **request_kwargs):
        """Route to the least-loaded replica. Per-request options
        (logit_bias, penalties, adapter, priority, ...) forward verbatim
        to the chosen replica's submit."""
        assert req_id not in self._route
        i = int(np.argmin(self._load))
        charge = len(prompt) + max_new_tokens
        self._route[req_id] = i
        self._charge[req_id] = charge
        self._load[i] += charge
        self.replicas[i].submit(req_id, prompt, max_new_tokens,
                                **request_kwargs)

    def step(self) -> bool:
        """One round: every replica advances one scheduling step."""
        busy = False
        for eng in self.replicas:
            busy |= eng.step()
        return busy

    def _settle(self, req_ids) -> None:
        """Credit completed/failed requests with their FULL charged weight
        (prompt + budget) so the least-loaded counter returns to zero —
        crediting only generated tokens drifted upward forever and skewed
        routing in long sessions."""
        for rid in req_ids:
            i = self._route.get(rid)
            charge = self._charge.pop(rid, None)
            if i is not None and charge is not None:
                self._load[i] = max(0, self._load[i] - charge)

    def run(self, max_steps: int = 100000) -> dict[int, list[int]]:
        """Drive all replicas to completion, INTERLEAVED: each sweep steps
        every replica once (round-robin), so replicas make concurrent
        progress instead of draining serially."""
        for _ in range(max_steps):
            if not self.step():
                break
        results: dict[int, list[int]] = {}
        for eng in self.replicas:
            # One final no-op step inside run() performs the per-engine
            # drain bookkeeping (unservable -> failed) and returns _done.
            results.update(eng.run(max_steps=1))
        self._settle(list(results.keys()) + self.failed)
        return results

    @property
    def failed(self) -> list[int]:
        out: list[int] = []
        for eng in self.replicas:
            out.extend(eng.failed)
        return out

    @property
    def logprobs(self) -> dict[int, list[float]]:
        """Finished requests' per-token logprobs (replicas built with
        return_logprobs=True), merged across replicas."""
        out: dict[int, list[float]] = {}
        for eng in self.replicas:
            out.update(eng.logprobs)
        return out

    @property
    def request_metrics(self) -> list[dict]:
        out: list[dict] = []
        for eng in self.replicas:
            out.extend(eng.request_metrics)
        return out

    @property
    def stats(self) -> dict:
        keys = self.replicas[0].stats.keys()
        return {
            k: sum(eng.stats[k] for eng in self.replicas) for k in keys
        }
