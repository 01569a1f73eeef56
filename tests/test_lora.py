"""Multi-LoRA serving: many adapters resident beside one base model,
every batch row picking its own — each request's output must EXACTLY
match a plain engine running the merged dense weights of its adapter
(W' = W + s * A @ B), including the reserved no-op adapter 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_cute.models import init_params
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.models.lora import (
    init_lora_params,
    lora_delta,
    merge_lora,
)
from flash_attention_cute.runtime.engine import ServingEngine

POOL = dict(slots=3, num_pages=65, page_size=8, pages_per_seq=16)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config(num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    lora = init_lora_params(cfg, num_adapters=3, rank=4,
                            key=jax.random.key(1), scaling=0.5)
    # Give adapters 1 and 2 real (distinct) B matrices; adapter 0 stays
    # the zero-B no-op.
    def set_b(lora, adapter, seed):
        layers = {}
        for proj, ab in lora["layers"].items():
            b = ab["b"]
            nb = jax.random.normal(
                jax.random.fold_in(jax.random.key(seed), hash(proj) % 97),
                b[:, adapter].shape, jnp.float32,
            ) * 0.05
            layers[proj] = {
                "a": ab["a"],
                "b": b.at[:, adapter].set(nb.astype(b.dtype)),
            }
        return dict(lora, layers=layers)

    lora = set_b(lora, 1, seed=11)
    lora = set_b(lora, 2, seed=12)
    return cfg, params, lora


def _oracle(cfg, params, prompt, n_new):
    eng = ServingEngine(params, cfg, interpret=True, **POOL)
    eng.submit(0, prompt, n_new)
    return eng.run()[0]


def test_lora_delta_math(setup):
    cfg, params, lora = setup
    x = jax.random.normal(jax.random.key(5), (2, 3, cfg.hidden_size),
                          jnp.float32)
    l0 = jax.tree.map(lambda a: a[0], lora["layers"]["q_proj"])
    ids = jnp.asarray([0, 2], jnp.int32)
    d = lora_delta(x, l0, ids, lora["scaling"])
    assert float(jnp.abs(d[0]).max()) == 0.0  # no-op adapter
    want = (
        x[1] @ np.asarray(l0["a"][2], np.float32)
        @ np.asarray(l0["b"][2], np.float32)
    ) * 0.5
    np.testing.assert_allclose(np.asarray(d[1]), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_multi_adapter_batch_matches_merged_oracles(setup):
    """Three concurrent requests on adapters 0/1/2: each output equals a
    plain engine running that adapter merged into dense weights."""
    cfg, params, lora = setup
    rng = np.random.default_rng(0)
    prompts = {a: rng.integers(0, cfg.vocab_size, 7 + a).tolist()
               for a in range(3)}

    eng = ServingEngine(params, cfg, interpret=True, lora_params=lora,
                        **POOL)
    for a, p in prompts.items():
        eng.submit(a, p, 6, adapter=a)
    got = eng.run()
    assert not eng.failed

    for a, p in prompts.items():
        merged = merge_lora(params, lora, a) if a else params
        want = _oracle(cfg, merged, p, 6)
        assert got[a] == want, (a, got[a], want)
    # The adapters actually change behavior (and differ from each other).
    assert got[1] != got[0] and got[2] != got[1]


def test_lora_chunked_admission(setup):
    """Adapter deltas apply during chunked admission extends too."""
    cfg, params, lora = setup
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, 21).tolist()
    eng = ServingEngine(params, cfg, interpret=True, lora_params=lora,
                        prefill_chunk=8, **POOL)
    eng.submit(0, prompt, 6, adapter=2)
    got = eng.run()[0]
    want = _oracle(cfg, merge_lora(params, lora, 2), prompt, 6)
    assert got == want


def test_lora_rejects_unbuilt_compositions(setup):
    cfg, params, _ = setup
    eng = ServingEngine(params, cfg, interpret=True, **POOL)
    with pytest.raises(AssertionError):
        eng.submit(0, [1, 2, 3], 4, adapter=1)  # no lora loaded


def test_lora_prefix_cache_namespaced(setup):
    """LoRA x prefix cache: adapter id namespaces the cache — the SAME
    prompt on two adapters never shares KV pages, and each request still
    matches its merged-dense oracle; a same-adapter repeat DOES hit."""
    cfg, params, lora = setup
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, cfg.vocab_size, 19).tolist()

    eng = ServingEngine(params, cfg, interpret=True, lora_params=lora,
                        enable_prefix_cache=True, **POOL)
    eng.submit(0, prompt, 5, adapter=1)
    eng.run()
    hits_before = eng.stats["prefix_hit_tokens"]
    eng.submit(1, prompt, 5, adapter=2)  # other adapter: MUST miss
    eng.run()
    assert eng.stats["prefix_hit_tokens"] == hits_before
    eng.submit(2, prompt, 5, adapter=1)  # same adapter: hits
    eng.submit(3, prompt, 5, adapter=2)
    got = eng.run()
    assert eng.stats["prefix_hit_tokens"] >= hits_before + 32

    for rid, a in ((2, 1), (3, 2)):
        want = _oracle(cfg, merge_lora(params, lora, a), prompt, 5)
        assert got[rid] == want, (rid, got[rid], want)


def test_lora_speculative_serving(setup):
    """LoRA x speculative: adapters ride the verify forward (drafts stay
    base-model — proposals only affect speed), so outputs must match the
    plain LoRA engine exactly, per concurrent adapter."""
    from flash_attention_cute.runtime.spec_engine import (
        SpeculativeServingEngine,
    )

    cfg, params, lora = setup
    rng = np.random.default_rng(9)
    prompts = {a: rng.integers(0, cfg.vocab_size, 6 + a).tolist()
               for a in range(3)}

    plain = ServingEngine(params, cfg, interpret=True, lora_params=lora,
                          **POOL)
    for a, p in prompts.items():
        plain.submit(a, p, 6, adapter=a)
    want = plain.run()

    eng = SpeculativeServingEngine(
        params, cfg, ngram=2, gamma=3, interpret=True, lora_params=lora,
        **POOL,
    )
    for a, p in prompts.items():
        eng.submit(a, p, 6, adapter=a)
    got = eng.run()
    assert got == want
    assert not eng.failed


def test_peft_conversion_roundtrip(setup):
    """A synthetic PEFT-style state dict converts into the stacked layout
    and serves identically to the same adapter built directly."""
    from flash_attention_cute.models.lora import lora_params_from_peft

    cfg, params, lora = setup
    rng = np.random.default_rng(7)
    r = 4
    sd = {}
    for proj in ("q_proj", "v_proj"):
        din = cfg.hidden_size
        dout = (cfg.num_q_heads if proj == "q_proj"
                else cfg.num_kv_heads) * cfg.head_dim
        for layer in range(cfg.num_layers):
            sd[f"base_model.model.model.layers.{layer}.self_attn."
               f"{proj}.lora_A.weight"] = rng.normal(
                   0, 0.1, (r, din)).astype(np.float32)
            sd[f"base_model.model.model.layers.{layer}.self_attn."
               f"{proj}.lora_B.weight"] = rng.normal(
                   0, 0.1, (dout, r)).astype(np.float32)
    conv = lora_params_from_peft([{}, sd], cfg, scalings=[1.0, 2.0],
                                 dtype=jnp.float32)
    assert set(conv["layers"]) == {"q_proj", "v_proj"}
    assert conv["layers"]["q_proj"]["a"].shape[:2] == (cfg.num_layers, 2)
    # Adapter 0 (empty dict) is the no-op.
    assert float(jnp.abs(conv["layers"]["q_proj"]["b"][:, 0]).max()) == 0.0

    prompt = rng.integers(0, cfg.vocab_size, 8).tolist()
    eng = ServingEngine(params, cfg, interpret=True, lora_params=conv,
                        **POOL)
    eng.submit(0, prompt, 5, adapter=1)
    eng.submit(1, prompt, 5)  # no-op adapter: base-model output
    got = eng.run()
    want1 = _oracle(cfg, merge_lora(params, conv, 1), prompt, 5)
    want0 = _oracle(cfg, params, prompt, 5)
    assert got[0] == want1
    assert got[1] == want0


def test_lora_dense_forward_matches_merged(setup):
    """Dense-path LoRA (prefill) equals the merged-weights forward."""
    from flash_attention_cute.models import forward

    cfg, params, lora = setup
    ids = jnp.asarray(
        np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 10)),
        jnp.int32,
    )
    aid = jnp.asarray([1, 2], jnp.int32)
    got, _ = forward(params, cfg, ids, mode="prefill", interpret=True,
                     lora=lora, adapter_ids=aid)
    for row, a in enumerate((1, 2)):
        want, _ = forward(merge_lora(params, lora, a), cfg,
                          ids[row : row + 1], mode="prefill",
                          interpret=True)
        np.testing.assert_allclose(
            np.asarray(got[row]), np.asarray(want[0]),
            atol=2e-4, rtol=2e-3,
        )


def test_lora_finetuning_step_trains_adapter_only(setup):
    """LoRA fine-tuning through the kernels: jax.grad w.r.t. the adapter
    params only; a few adamw steps reduce the LM loss and the base
    weights never change."""
    import optax

    from flash_attention_cute.models import forward

    cfg, params, lora = setup
    rng = np.random.default_rng(17)
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 12)), jnp.int32)
    aid = jnp.ones((4,), jnp.int32)  # all rows train adapter 1

    def loss_fn(lora_p):
        # The CPU's XLA attention route; jax.grad differentiates every
        # dense route (tests/test_autodiff.py).
        logits, _ = forward(params, cfg, ids, mode="prefill",
                            lora=lora_p, adapter_ids=aid)
        lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(lp, ids[:, 1:, None], axis=-1)
        return jnp.mean(nll)

    tx = optax.adamw(3e-2)
    opt = tx.init(lora)
    losses = []
    lp_cur = lora
    for _ in range(5):
        loss, grads = jax.value_and_grad(loss_fn)(lp_cur)
        losses.append(float(loss))
        # Gradients flow into A and B of the trained adapter.
        gq = grads["layers"]["q_proj"]
        assert float(jnp.abs(gq["a"][:, 1]).max()) > 0
        assert float(jnp.abs(gq["b"][:, 1]).max()) > 0
        updates, opt = tx.update(grads, opt, lp_cur)
        lp_cur = optax.apply_updates(lp_cur, updates)
    assert losses[-1] < losses[0], losses
