"""End-to-end validation of the REAL-checkpoint path (round-1 verdict #4).

No HF weights are downloadable in this environment (zero egress), so the
verdict's prescribed fallback runs instead: an HF-format Llama checkpoint
at REAL Llama-3-8B width (4096 hidden, 32q/8kv heads, D=128, 14336 FFN,
128256 vocab; depth trimmed, 4 layers by default) is materialized on disk
with `save_pretrained`, then driven through the ENTIRE production path:

  HF checkpoint dir -> models/convert.load_hf_model -> on-device greedy
  generation (runtime/generate.py) -> logits parity vs the fp32 torch CPU
  forward of the SAME checkpoint -> orbax save/load round trip
  (models/checkpoint.py) -> bit-identical params after restore.

This is the reference's integration proof (generate from a real
Llama-2-7b-chat checkpoint, reference: scripts/benchmark_llm.py:95-118)
re-created byte-format-faithfully under the no-network constraint.

Usage: PYTHONPATH=. python scripts/validate_real_checkpoint.py [--layers 4]
(needs torch and transformers installed)
"""

import argparse
import os
import shutil
import time


def build_hf_checkpoint(path: str, num_layers: int):
    """Materialize a real HF-format Llama checkpoint at 8B width."""
    import torch
    import transformers

    if os.path.isdir(path) and os.path.exists(
        os.path.join(path, "config.json")
    ):
        print(f"checkpoint already at {path}")
        return
    cfg = transformers.LlamaConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=num_layers,
        num_attention_heads=32,
        num_key_value_heads=8,
        max_position_embeddings=8192,
        rope_theta=500000.0,
        rms_norm_eps=1e-5,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    t0 = time.time()
    with torch.device("cpu"):
        model = transformers.LlamaForCausalLM(cfg)
    model = model.to(torch.bfloat16)
    print(f"init {sum(p.numel() for p in model.parameters())/1e9:.2f}B params "
          f"in {time.time()-t0:.0f}s")
    model.save_pretrained(path, safe_serialization=True)
    print(f"saved HF checkpoint to {path} "
          f"({sum(f.stat().st_size for f in os.scandir(path))/2**30:.1f} GiB)")
    del model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--path", default="/tmp/llama3_8bw_hf")
    ap.add_argument("--orbax", default="/tmp/llama3_8bw_orbax")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    import numpy as np

    build_hf_checkpoint(args.path, args.layers)

    # ---- the production loading path ----
    import jax
    import jax.numpy as jnp

    from flash_attention_cute.models.convert import load_hf_model

    print("backend:", jax.devices())
    t0 = time.time()
    cfg, params = load_hf_model(args.path, dtype=jnp.bfloat16)
    print(f"load_hf_model: {time.time()-t0:.0f}s, cfg layers={cfg.num_layers} "
          f"hidden={cfg.hidden_size} vocab={cfg.vocab_size}")
    assert cfg.hidden_size == 4096 and cfg.num_q_heads == 32

    # ---- on-device forward + logits parity vs torch CPU fp32 ----
    prompt = np.array([[128000, 9906, 1917, 11, 420, 374, 264, 1296]],
                      np.int32)  # arbitrary real-vocab ids

    from flash_attention_cute.models import forward

    logits, _ = forward(params, cfg, jnp.asarray(prompt), mode="prefill")
    logits = np.asarray(logits, np.float32)  # [1, S, V]

    import torch
    import transformers

    t0 = time.time()
    with torch.device("cpu"):
        tmodel = transformers.AutoModelForCausalLM.from_pretrained(
            args.path, torch_dtype=torch.float32
        ).eval()
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(prompt).long()).logits.numpy()
    print(f"torch fp32 forward: {time.time()-t0:.0f}s")

    scale = np.abs(tlogits).max()
    err = np.abs(logits - tlogits).max() / scale
    argmax_agree = (logits.argmax(-1) == tlogits.argmax(-1)).mean()
    print(f"logits: rel err {err:.3e}, argmax agreement {argmax_agree:.2%}")
    # A wrong weight layout gives O(1) rel err; correct conversion lands at
    # bf16 rounding level. Argmax agreement is reported but only loosely
    # asserted: RANDOM weights give near-tied logits over a 128k vocab, so
    # bf16-vs-fp32 rounding legitimately flips ties (with trained weights
    # the margin makes argmax stable).
    assert err < 3e-2, err  # bf16 model vs fp32 torch
    assert argmax_agree >= 0.5, argmax_agree

    del tmodel

    # ---- on-device greedy generation (sanity + throughput) ----
    from flash_attention_cute.runtime.generate import greedy_generate

    t0 = time.time()
    out = greedy_generate(params, cfg, jnp.asarray(prompt), 32,
                          cache_capacity=128)
    out = np.asarray(out)
    dt = time.time() - t0
    print(f"greedy 32 tokens (compile+run): {dt:.1f}s; ids={out[0][:8].tolist()}...")
    t0 = time.time()
    out2 = np.asarray(
        greedy_generate(params, cfg, jnp.asarray(prompt), 32,
                        cache_capacity=128)
    )
    dt = time.time() - t0
    assert (out == out2).all()  # generation is deterministic
    print(f"warm decode: {dt*1000/32:.1f} ms/token "
          f"({32/dt:.0f} tok/s, batch 1, {cfg.num_layers} layers)")
    # Token 0 must be the argmax of the model's own prefill logits (ties
    # against the fp32 torch argmax are legitimate with random weights).
    assert out[0, 0] == logits[0, -1].argmax(), (
        out[0, 0], logits[0, -1].argmax()
    )

    # ---- orbax save / reload round trip ----
    from flash_attention_cute.models.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    if os.path.isdir(args.orbax):
        shutil.rmtree(args.orbax)
    t0 = time.time()
    save_checkpoint(args.orbax, params, cfg)
    print(f"orbax save: {time.time()-t0:.0f}s")
    t0 = time.time()
    cfg2, params2 = load_checkpoint(args.orbax)
    print(f"orbax load: {time.time()-t0:.0f}s")
    assert cfg2 == cfg
    mismatch = jax.tree.map(
        lambda a, b: bool(jnp.any(a != b)), params, params2
    )
    assert not any(jax.tree.leaves(mismatch)), "restore not bit-identical"
    print("orbax round trip: bit-identical OK")

    if not args.keep:
        shutil.rmtree(args.path, ignore_errors=True)
        shutil.rmtree(args.orbax, ignore_errors=True)
    print("REAL-CHECKPOINT VALIDATION OK")


if __name__ == "__main__":
    main()
