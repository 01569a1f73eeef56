"""HF checkpoint -> JAX parameter conversion.

The reference loads weights through HF `from_pretrained`
(reference: scripts/benchmark_llm.py:142-147); here the equivalent is an
explicit converter from an HF torch state dict (or a transformers model /
local checkpoint dir) into the stacked-layer pytree `transformer.forward`
consumes. Linear weights are transposed once at load time ([out,in] ->
[in,out]) so the forward pass is plain `x @ W` with no per-step transposes.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np

from flash_attention_cute.models.config import ModelConfig


def _to_np(t) -> np.ndarray:
    """torch tensor / np array -> np.ndarray (fp32 staging)."""
    if hasattr(t, "detach"):
        t = t.detach()
        if t.dtype.__str__() == "torch.bfloat16":
            t = t.float()
        t = t.cpu().numpy()
    return np.asarray(t)


_PREFIX = re.compile(r"^(model\.|transformer\.)")


def _normalize_key(k: str) -> str:
    return _PREFIX.sub("", k)


def params_from_state_dict(
    state_dict: dict, cfg: ModelConfig, with_lm_head: bool = True
) -> dict:
    """Convert an HF Llama/Qwen2-style state dict to the stacked pytree.

    Accepts both `model.layers.N....` and `layers.N....` key styles and
    torch tensors or numpy arrays as values. `with_lm_head=False` converts
    a trunk-only checkpoint (classification/QA checkpoints carry a task
    head instead of lm_head — see `head_params_from_state_dict`).
    """
    sd = {_normalize_key(k): v for k, v in state_dict.items()}
    dt = cfg.dtype

    def get(k):
        if k not in sd:
            raise KeyError(f"missing weight {k!r}; have e.g. {list(sd)[:5]}")
        return _to_np(sd[k])

    def linear(k):  # [out, in] -> [in, out]
        return jnp.asarray(get(k).T, dt)

    def stack(fmt, conv):
        return jnp.stack([conv(fmt.format(i)) for i in range(cfg.num_layers)])

    def norm_w(k):
        w = get(k).astype(np.float32)
        if cfg.rms_norm_plus_one:
            # Gemma RMSNorm computes x * (1 + w); folding the +1 into the
            # stored weight keeps the model code identical across families.
            w = w + 1.0
        return jnp.asarray(w, dt)

    layers = {
        "input_ln": stack("layers.{}.input_layernorm.weight", norm_w),
        "post_ln": stack("layers.{}.post_attention_layernorm.weight",
                         norm_w),
        "q_proj": stack("layers.{}.self_attn.q_proj.weight", linear),
        "k_proj": stack("layers.{}.self_attn.k_proj.weight", linear),
        "v_proj": stack("layers.{}.self_attn.v_proj.weight", linear),
        "o_proj": stack("layers.{}.self_attn.o_proj.weight", linear),
        "gate_proj": stack("layers.{}.mlp.gate_proj.weight", linear),
        "up_proj": stack("layers.{}.mlp.up_proj.weight", linear),
        "down_proj": stack("layers.{}.mlp.down_proj.weight", linear),
    }
    if cfg.attention_bias:
        for name in ("q", "k", "v"):
            layers[f"{name}_bias"] = stack(
                "layers.{}.self_attn." + name + "_proj.bias",
                lambda k: jnp.asarray(get(k), dt),
            )
    if cfg.sandwich_norms:  # Gemma2 pre/post-feedforward norms
        layers["pre_ffw_ln"] = stack(
            "layers.{}.pre_feedforward_layernorm.weight", norm_w
        )
        layers["post_ffw_ln"] = stack(
            "layers.{}.post_feedforward_layernorm.weight", norm_w
        )

    params = {
        "embed": jnp.asarray(get("embed_tokens.weight"), dt),
        "layers": layers,
        "final_ln": norm_w("norm.weight"),
    }
    if with_lm_head and not cfg.tie_word_embeddings:
        # lm_head lives outside the model.* prefix in HF checkpoints.
        head = sd.get("lm_head.weight")
        if head is None:
            raise KeyError("lm_head.weight missing and embeddings not tied")
        params["lm_head"] = jnp.asarray(_to_np(head).T, dt)
    return params


def head_params_from_state_dict(
    state_dict: dict, cfg: ModelConfig, head: str
) -> dict:
    """Convert an HF task-head checkpoint (trunk + head, no lm_head).

    `head` is "sequence_classification" (HF `score.weight`, no bias —
    reference: models/modeling_llama.py:971, modeling_qwen2.py:926),
    "token_classification" (HF `score.{weight,bias}`), or
    "question_answering" (HF `qa_outputs.{weight,bias}`, out_features=2 —
    reference: models/modeling_llama.py:1086).
    """
    params = params_from_state_dict(state_dict, cfg, with_lm_head=False)
    sd = {_normalize_key(k): v for k, v in state_dict.items()}
    dt = cfg.dtype
    if head == "sequence_classification":
        params["score"] = jnp.asarray(_to_np(sd["score.weight"]).T, dt)
    elif head == "token_classification":
        # HF `LlamaForTokenClassification`: bias-ful `score` Linear.
        params["score"] = jnp.asarray(_to_np(sd["score.weight"]).T, dt)
        params["score_bias"] = jnp.asarray(_to_np(sd["score.bias"]), dt)
    elif head == "question_answering":
        params["qa_outputs"] = jnp.asarray(
            _to_np(sd["qa_outputs.weight"]).T, dt
        )
        params["qa_outputs_bias"] = jnp.asarray(
            _to_np(sd["qa_outputs.bias"]), dt
        )
    else:
        raise ValueError(f"unknown head {head!r}")
    return params


def load_hf_model(model_name_or_path: str, dtype=jnp.bfloat16):
    """Load config + weights from a local HF checkout via transformers.

    Returns (cfg, params). Network access is not assumed — pass a local
    directory (the reference equally assumes a resolvable HF model id,
    scripts/benchmark_llm.py:142-147).
    """
    import transformers

    hf_cfg = transformers.AutoConfig.from_pretrained(model_name_or_path)
    model_type = getattr(hf_cfg, "model_type", "llama")
    if model_type == "qwen2":
        from flash_attention_cute.models.qwen2 import qwen2_config_from_hf
        cfg = qwen2_config_from_hf(hf_cfg, dtype=dtype)
    elif model_type == "mistral":
        from flash_attention_cute.models.mistral import (
            mistral_config_from_hf,
        )
        cfg = mistral_config_from_hf(hf_cfg, dtype=dtype)
    elif model_type == "gemma2":
        from flash_attention_cute.models.gemma2 import (
            gemma2_config_from_hf,
        )
        cfg = gemma2_config_from_hf(hf_cfg, dtype=dtype)
    else:
        from flash_attention_cute.models.llama import llama_config_from_hf
        cfg = llama_config_from_hf(hf_cfg, dtype=dtype)

    import torch

    with torch.device("cpu"):
        model = transformers.AutoModelForCausalLM.from_pretrained(
            model_name_or_path, torch_dtype=torch.float32
        )
    params = params_from_state_dict(model.state_dict(), cfg)
    del model
    return cfg, params
