"""Checkpoint save / resume (orbax-backed, sharding-aware).

The reference has NO checkpointing — weights come exclusively from HF
`from_pretrained` (reference: scripts/benchmark_llm.py:142-147) and no
state survives a process. Here, converted/sharded parameter pytrees (and
optionally the serving KV state) persist via orbax, so a multi-host
deployment restores without re-running the HF torch conversion, and each
process restores its own shards directly (SURVEY.md §5 checkpoint/resume).

Layout on disk:  <dir>/params/...  (orbax PyTree checkpoint)
                 <dir>/config.json (ModelConfig, for self-describing loads)
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp

from flash_attention_cute.models.config import ModelConfig, RopeScaling


def _cfg_to_json(cfg: ModelConfig) -> str:
    d = dataclasses.asdict(cfg)
    d["dtype"] = jnp.dtype(cfg.dtype).name
    return json.dumps(d, indent=1)


def _cfg_from_json(s: str) -> ModelConfig:
    d = json.loads(s)
    d["dtype"] = jnp.dtype(d["dtype"])
    if d.get("rope_scaling"):
        d["rope_scaling"] = RopeScaling(**d["rope_scaling"])
    if d.get("layer_window_pattern") is not None:
        # JSON round-trips tuples as lists; the config must stay hashable
        # (it rides jit static args).
        d["layer_window_pattern"] = tuple(d["layer_window_pattern"])
    return ModelConfig(**d)


def _pack_quant(tree):
    """Replace quantized-weight dataclass nodes with plain array dicts,
    returning (packed_tree, meta). Orbax restores RAW pytrees — a
    registered dataclass and its static fields (in_dim/out) do not
    survive an untyped restore — so the arrays are stored as plain
    leaves and the statics in `quant.json`, keyed by tree path. This is
    what makes "quantize once, save, restore in one read" work."""
    from flash_attention_cute.ops.quantized_matmul import (
        QuantizedWeight,
        QuantizedWeight4,
    )

    meta = {}

    def walk(node, path):
        if isinstance(node, (QuantizedWeight, QuantizedWeight4)):
            meta[path] = {
                "bits": 4 if isinstance(node, QuantizedWeight4) else 8,
                "in_dim": node.in_dim, "out": node.out,
            }
            return {"values": node.values, "scales": node.scales}
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        return node

    return walk(tree, ""), meta


def _unpack_quant(tree, meta):
    from flash_attention_cute.ops.quantized_matmul import (
        QuantizedWeight,
        QuantizedWeight4,
    )

    def walk(node, path):
        if path in meta:
            m = meta[path]
            cls = QuantizedWeight4 if m["bits"] == 4 else QuantizedWeight
            return cls(values=node["values"], scales=node["scales"],
                       in_dim=m["in_dim"], out=m["out"])
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        return node

    return walk(tree, "")


def save_checkpoint(path, params: dict, cfg: ModelConfig) -> None:
    """Write params + config; safe to call from every host (orbax
    coordinates multi-host writes of sharded arrays). Quantized
    parameter pytrees (models/quantize.py, int8 or int4) are supported:
    their static fields persist in `quant.json`."""
    import orbax.checkpoint as ocp

    path = pathlib.Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    packed, quant_meta = _pack_quant(params)
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path / "params", packed, force=True)
    if quant_meta:
        (path / "quant.json").write_text(json.dumps(quant_meta, indent=1))
    (path / "config.json").write_text(_cfg_to_json(cfg))


def load_checkpoint(
    path,
    shardings=None,
) -> tuple[ModelConfig, dict]:
    """Restore (cfg, params). `shardings` (optional pytree of
    jax.sharding.Sharding matching the params) restores each array
    directly onto its mesh placement — no host-memory staging of the full
    model on every process."""
    import orbax.checkpoint as ocp

    path = pathlib.Path(path).absolute()
    cfg = _cfg_from_json((path / "config.json").read_text())
    with ocp.PyTreeCheckpointer() as ckptr:
        if shardings is not None:
            # Shardings for quantized leaves arrive as QuantizedWeight
            # nodes of Sharding fields (parallel.sharding.param_pspecs
            # expands them that way); pack to match the stored layout.
            restore_args = jax.tree.map(
                lambda s: ocp.ArrayRestoreArgs(sharding=s),
                _pack_quant(shardings)[0],
            )
            params = ckptr.restore(
                path / "params",
                args=ocp.args.PyTreeRestore(
                    restore_args=restore_args
                ),
            )
        else:
            params = ckptr.restore(path / "params")
    quant_file = path / "quant.json"
    if quant_file.exists():
        params = _unpack_quant(params, json.loads(quant_file.read_text()))
    return cfg, params


def save_hf_as_checkpoint(hf_path, out_path, dtype=jnp.bfloat16):
    """One-time conversion: HF torch checkpoint -> native orbax checkpoint
    (the resume path then never needs torch again)."""
    from flash_attention_cute.models.convert import load_hf_model

    cfg, params = load_hf_model(hf_path, dtype=dtype)
    save_checkpoint(out_path, params, cfg)
    return cfg
