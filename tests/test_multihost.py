"""Multi-host serving router over real worker processes.

The scale-out claim ("request routing across worker processes, per-worker
page pools") is exercised for real here: two SEPARATE Python processes
each serve a ServingEngine over TCP, and the router in this process
drives them interleaved. Exactness contract: routing must never change
any output — each request runs whole on one host, so results match a
single local engine serving the same requests.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from flash_attention_cute.models import init_params
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.runtime.engine import ServingEngine
from flash_attention_cute.runtime.multihost import (
    MultiHostRouter,
    stable_block_hash,
)

POOL = ["--slots", "2", "--num-pages", "65", "--page-size", "8",
        "--pages-per-seq", "16"]


def _policy_router(n, page_size=8, spill_factor=2.0):
    """Socket-free router instance for pure routing-policy tests."""
    r = MultiHostRouter.__new__(MultiHostRouter)
    r.page_size = page_size
    r.spill_factor = spill_factor
    r.socks = [None] * n
    r._load = [0] * n
    return r


def test_prefix_affinity_and_spill_policy():
    r = _policy_router(4)
    block = list(range(8))
    home = stable_block_hash(tuple(block), 4)
    # Same first block -> same host, regardless of suffix.
    assert r.pick_host(block + [9, 9]) == home
    assert r.pick_host(block + [7]) == home
    # Short prompts (no shareable block: sharing caps at plen-1) go to
    # the least-loaded host.
    r._load = [5, 0, 5, 5]
    assert r.pick_host(list(range(8))) == 1
    # A hot home host sheds to the coldest one.
    r._load = [0, 0, 0, 0]
    r._load[home] = 1000
    r._load[(home + 1) % 4] = 10
    got = r.pick_host(block + [9, 9])
    assert got != home
    assert got == min(range(4), key=lambda i: r._load[i])


def _spawn_worker(seed=0):
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "flash_attention_cute.runtime.multihost",
         "--cpu", "--tiny-layers", "2",
         "--tiny-seed", str(seed), "--port", "0", "--prefix-cache",
         "--host-swap-tokens", "512", *POOL],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        text=True,
    )
    line = proc.stdout.readline().strip()
    assert line.startswith("LISTENING "), line
    return proc, int(line.split()[1])


def test_multihost_router_two_processes():
    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))

    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, 17).tolist()
    prompts = {
        100 + i: system + rng.integers(0, cfg.vocab_size, 4 + i).tolist()
        for i in range(4)
    }
    # Two short, distinct prompts (below one block): routed least-loaded.
    prompts[200] = rng.integers(0, cfg.vocab_size, 6).tolist()
    prompts[201] = rng.integers(0, cfg.vocab_size, 7).tolist()

    # Local oracle: one engine, same tiny model (seed 0), same pool.
    oracle = ServingEngine(params, cfg, slots=2,
                           num_pages=65, page_size=8, pages_per_seq=16)
    for rid, p in prompts.items():
        oracle.submit(rid, p, 5)
    want = oracle.run()

    procs = []
    router = None
    try:
        workers = [_spawn_worker(), _spawn_worker()]
        procs = [w[0] for w in workers]
        router = MultiHostRouter(
            [("127.0.0.1", w[1]) for w in workers], page_size=8,
        )
        for rid, p in prompts.items():
            router.submit(rid, p, 5)
        got = router.run()
        assert got == want
        assert not router.failed
        # Affinity: the four shared-prefix requests landed on ONE host...
        shared_hosts = {router._route[100 + i] for i in range(4)}
        assert len(shared_hosts) == 1
        home = shared_hosts.pop()
        # ...and that host reused the prefix pages across them.
        assert router.host_stats[home]["prefix_hit_tokens"] >= 16
        # The short prompts went least-loaded, i.e. to the OTHER host —
        # both hosts did real work.
        assert router._route[200] != home
        assert router._route[201] != home
        assert all(st["tokens_generated"] > 0 for st in router.host_stats)
    finally:
        if router is not None:
            router.shutdown()
        for p in procs:
            p.wait(timeout=30)
