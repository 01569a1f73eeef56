"""JAX model stacks wired to the attention routes.

Replaces the reference's vendored HF forks (reference: models/modeling_llama.py,
models/modeling_qwen2.py, ~2,300 LoC of near-duplicate torch code) with one
functional transformer core shared by both families, plus thin config
adapters. Weight loading converts HF checkpoints (models/convert.py).
"""

from flash_attention_cute.models.config import ModelConfig
from flash_attention_cute.models.cache import KVCache
from flash_attention_cute.models.transformer import (
    forward,
    init_params,
)
from flash_attention_cute.models.llama import llama_config_from_hf
from flash_attention_cute.models.gemma2 import gemma2_config_from_hf
from flash_attention_cute.models.mistral import mistral_config_from_hf
from flash_attention_cute.models.qwen2 import qwen2_config_from_hf
from flash_attention_cute.models.heads import (
    embedding_pooling_forward,
    question_answering_forward,
    sequence_classification_forward,
    token_classification_forward,
)

__all__ = [
    "ModelConfig",
    "KVCache",
    "forward",
    "init_params",
    "llama_config_from_hf",
    "qwen2_config_from_hf",
    "gemma2_config_from_hf",
    "mistral_config_from_hf",
    "question_answering_forward",
    "sequence_classification_forward",
    "token_classification_forward",
    "embedding_pooling_forward",
]
