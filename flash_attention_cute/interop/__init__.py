"""PyTorch/HuggingFace interop: monkeypatch HF attention onto the JAX kernels.

The analog of the reference's L4 patchers (reference: models/patch_llama.py,
models/patch_qwen2.py, models/rope_attn_fwd.py)."""

from flash_attention_cute.interop.torch_patch import (  # noqa: F401
    attention_forward,
    patch_llama,
    patch_qwen2,
)
