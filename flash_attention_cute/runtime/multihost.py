"""Multi-host serving: request routing across per-host engines over TCP.

The scale-out layer ABOVE single-process serving (the reference has no
serving stack at all — its multi-GPU story ends at HF `device_map`,
reference: scripts/benchmark_llm.py:136). Production layout:

  * each HOST process owns one engine (any `ServingEngine` flavor —
    TP over its local mesh, speculative, quantized) with its own page
    pool, scheduler, and prefix cache (+ host-swap tier);
  * a front-end `MultiHostRouter` holds one socket per host and routes
    each request WHOLE — a request's KV never crosses hosts; only token
    ids and results do (the cheap direction: ~10 bytes/token vs ~100 KB
    of KV per token at 8B scale);
  * routing is PREFIX-AFFINE with least-loaded spill: a stable hash of
    the prompt's first page-aligned block picks the home host, so
    same-system-prompt requests land where that prefix's KV is already
    cached, and a host running hot (load > spill_factor x mean) sheds
    new arrivals to the least-loaded host instead (a prefix recompute
    is cheaper than queueing behind a hot host).

Transport is newline-delimited JSON over TCP — one router connection per
worker, strictly request/reply, so the protocol works unchanged across
localhost (tests) or across hosts. Stepping is
router-driven: each `run()` sweep sends one `step` to every host and
collects newly finished requests, so hosts make concurrent progress and
the router observes it deterministically (the cross-process analog of
`DataParallelServingEngine.run`'s interleaved sweeps).

Worker CLI: one process per card, each with its card as the only one it
sees (`--gpu i` sets CUDA_VISIBLE_DEVICES before JAX starts, so no two
workers reserve memory on the same card):
    python -m flash_attention_cute.runtime.multihost --port 0 --gpu 0 \
        --checkpoint /path/to/orbax   # or --tiny-layers 2 for self-test
It prints `LISTENING <port>` on stdout once bound.
"""

from __future__ import annotations

import hashlib
import json
import socket


# ---------------------------------------------------------------------------
# Wire protocol: one JSON object per line, strict request/reply.
#   submit: {"op":"submit","rid":int,"prompt":[int],"max_new":int}
#   step:   {"op":"step"} -> {"busy":bool,"done":{rid:[int]},"failed":[rid]}
#   drain:  {"op":"drain"} -> {"done":...,"failed":...,"stats":{...}}
#   stats:  {"op":"stats"} -> {"stats":{...}}
#   shutdown: {"op":"shutdown"} -> {"ok":true}, then the worker exits.
# ---------------------------------------------------------------------------


def _send(sock: socket.socket, obj: dict) -> None:
    sock.sendall((json.dumps(obj) + "\n").encode())


class _LineReader:
    """Buffered newline-framed reader over a socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def readline(self) -> dict | None:
        while b"\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                return None
            self.buf += chunk
        line, self.buf = self.buf.split(b"\n", 1)
        return json.loads(line)


def stable_block_hash(block: tuple, n: int) -> int:
    """Deterministic host index for a token block (process-independent —
    Python's builtin hash() is seed-randomized and would break affinity
    across router restarts)."""
    digest = hashlib.sha256(
        ",".join(map(str, block)).encode()
    ).digest()
    return int.from_bytes(digest[:8], "big") % n


class EngineWorker:
    """Serves one engine over one router connection (one per host)."""

    def __init__(self, engine, port: int = 0, host: str = "127.0.0.1"):
        self.engine = engine
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        self._reported: set[int] = set()

    def _new_results(self) -> dict:
        done = {
            rid: toks
            for rid, toks in self.engine._done.items()
            if rid not in self._reported
        }
        failed = [
            rid for rid in self.engine.failed if rid not in self._reported
        ]
        self._reported.update(done)
        self._reported.update(failed)
        return {"done": done, "failed": failed}

    def serve(self) -> None:
        """Accept the router and reply until shutdown/EOF (blocking)."""
        conn, _ = self._listener.accept()
        reader = _LineReader(conn)
        try:
            while True:
                msg = reader.readline()
                if msg is None:
                    return
                op = msg["op"]
                if op == "submit":
                    self.engine.submit(
                        int(msg["rid"]),
                        [int(t) for t in msg["prompt"]],
                        int(msg["max_new"]),
                    )
                    _send(conn, {"ok": True})
                elif op == "step":
                    busy = self.engine.step()
                    _send(conn, {"busy": bool(busy)} | self._new_results())
                elif op == "drain":
                    self.engine.run()
                    _send(
                        conn,
                        self._new_results()
                        | {"stats": dict(self.engine.stats)},
                    )
                elif op == "stats":
                    _send(conn, {"stats": dict(self.engine.stats)})
                elif op == "shutdown":
                    _send(conn, {"ok": True})
                    return
                else:
                    _send(conn, {"error": f"unknown op {op!r}"})
        finally:
            conn.close()
            self._listener.close()


class MultiHostRouter:
    """Front-end: prefix-affine, load-spilling routing over host sockets.

    `addrs` is a list of (host, port). The router mirrors the
    single-process engine API (submit / run / failed / stats) so callers
    swap a `ServingEngine` for a pod without code changes.
    """

    def __init__(
        self,
        addrs: list[tuple[str, int]],
        page_size: int = 8,
        spill_factor: float = 2.0,
        connect_timeout: float = 30.0,
    ):
        assert addrs
        self.page_size = page_size
        self.spill_factor = spill_factor
        self.socks = [
            socket.create_connection(a, timeout=connect_timeout)
            for a in addrs
        ]
        for s in self.socks:
            s.settimeout(None)  # replies gate on engine steps, not RTT
        self.readers = [_LineReader(s) for s in self.socks]
        self._load = [0] * len(addrs)  # outstanding prompt+budget tokens
        self._charge: dict[int, int] = {}
        self._route: dict[int, int] = {}
        self.results: dict[int, list[int]] = {}
        self.failed: list[int] = []

    # -- routing policy (pure; unit-testable without sockets) --

    def pick_host(self, prompt: list[int]) -> int:
        n = len(self.socks)
        if n == 1:
            return 0
        coldest = min(range(n), key=lambda i: self._load[i])
        if len(prompt) < self.page_size + 1:
            # No shareable block (sharing is capped at plen-1 tokens, the
            # same rule as PrefixCache._chain) — nothing to be affine to.
            return coldest
        home = stable_block_hash(tuple(prompt[: self.page_size]), n)
        mean = sum(self._load) / n
        if self._load[home] > self.spill_factor * (mean + 1):
            return coldest
        return home

    # -- engine-shaped API --

    def submit(self, rid: int, prompt: list[int], max_new: int) -> int:
        assert rid not in self._route
        i = self.pick_host(prompt)
        self._route[rid] = i
        self._charge[rid] = len(prompt) + max_new
        self._load[i] += self._charge[rid]
        _send(
            self.socks[i],
            {"op": "submit", "rid": rid, "prompt": prompt,
             "max_new": max_new},
        )
        assert self.readers[i].readline()["ok"]
        return i

    def _settle(self, reply: dict) -> None:
        for rid_s, toks in reply.get("done", {}).items():
            rid = int(rid_s)  # JSON object keys arrive as strings
            self.results[rid] = [int(t) for t in toks]
            self._credit(rid)
        for rid in reply.get("failed", []):
            self.failed.append(int(rid))
            self._credit(int(rid))

    def _credit(self, rid: int) -> None:
        i = self._route.get(rid)
        charge = self._charge.pop(rid, None)
        if i is not None and charge is not None:
            self._load[i] = max(0, self._load[i] - charge)

    def step(self) -> bool:
        """One interleaved sweep: every host advances one engine step."""
        busy = False
        for sock, reader in zip(self.socks, self.readers):
            _send(sock, {"op": "step"})
            reply = reader.readline()
            busy |= reply["busy"]
            self._settle(reply)
        return busy

    def run(self, max_steps: int = 100000) -> dict[int, list[int]]:
        for _ in range(max_steps):
            if not self.step():
                break
        self.host_stats = []
        for sock, reader in zip(self.socks, self.readers):
            _send(sock, {"op": "drain"})
            reply = reader.readline()
            self._settle(reply)
            self.host_stats.append(reply["stats"])
        return dict(self.results)

    @property
    def stats(self) -> dict:
        out: dict = {}
        for st in getattr(self, "host_stats", []):
            for k, v in st.items():
                out[k] = out.get(k, 0) + v
        return out

    def shutdown(self) -> None:
        for sock, reader in zip(self.socks, self.readers):
            try:
                _send(sock, {"op": "shutdown"})
                reader.readline()
            except OSError:
                pass
            sock.close()


def _worker_main(argv: list[str] | None = None) -> None:
    """CLI: build an engine (orbax checkpoint or tiny self-test model)
    and serve it. `--gpu` and `--cpu` take effect before JAX starts."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--checkpoint", help="orbax checkpoint dir")
    ap.add_argument("--tiny-layers", type=int, default=0,
                    help="serve a tiny random-weight model (tests)")
    ap.add_argument("--tiny-seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--num-pages", type=int, default=129)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages-per-seq", type=int, default=16)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--host-swap-tokens", type=int, default=0)
    ap.add_argument("--gpu", type=int, default=None,
                    help="the one card this worker uses")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import os

    if args.gpu is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = str(args.gpu)
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from flash_attention_cute.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from flash_attention_cute.runtime.engine import ServingEngine

    if args.checkpoint:
        from flash_attention_cute.models.checkpoint import load_checkpoint

        cfg, params = load_checkpoint(args.checkpoint)
    else:
        assert args.tiny_layers > 0, "--checkpoint or --tiny-layers"
        from flash_attention_cute.models import init_params
        from flash_attention_cute.models.config import tiny_test_config

        cfg = tiny_test_config(num_layers=args.tiny_layers)
        params = init_params(cfg, jax.random.key(args.tiny_seed))

    engine = ServingEngine(
        params, cfg, slots=args.slots, num_pages=args.num_pages,
        page_size=args.page_size, pages_per_seq=args.pages_per_seq,
        enable_prefix_cache=args.prefix_cache,
        host_swap_tokens=args.host_swap_tokens,
    )
    worker = EngineWorker(engine, port=args.port)
    print(f"LISTENING {worker.port}", flush=True)
    worker.serve()


if __name__ == "__main__":
    _worker_main()
