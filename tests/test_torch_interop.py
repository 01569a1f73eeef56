"""HF torch models patched onto the JAX attention (interop layer).

Validates the reference's integration contract (reference:
models/patch_llama.py, models/rope_attn_fwd.py) end to end: a patched HF
model must reproduce the unpatched model's logits and greedy generation.
"""

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
torch = pytest.importorskip("torch")

from flash_attention_cute.interop import torch_patch


@pytest.fixture
def patched_llama():
    from transformers.models.llama import modeling_llama

    orig = modeling_llama.LlamaAttention.forward
    torch_patch.patch_llama()
    yield
    modeling_llama.LlamaAttention.forward = orig


@pytest.fixture
def patched_qwen2():
    from transformers.models.qwen2 import modeling_qwen2

    orig = modeling_qwen2.Qwen2Attention.forward
    torch_patch.patch_qwen2()
    yield
    modeling_qwen2.Qwen2Attention.forward = orig


def tiny_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, attn_implementation="eager",
    )
    torch.manual_seed(0)
    with torch.device("cpu"):
        return transformers.LlamaForCausalLM(cfg).eval()


def tiny_qwen2():
    cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, attn_implementation="eager",
    )
    torch.manual_seed(1)
    with torch.device("cpu"):
        return transformers.Qwen2ForCausalLM(cfg).eval()


def test_patched_llama_logits_match(patched_llama):
    model = tiny_llama()
    ids = torch.tensor([[1, 5, 9, 2, 7, 3, 11, 4]])
    with torch.no_grad():
        got = model(ids).logits.float().numpy()

    from transformers.models.llama import modeling_llama
    orig_fwd = modeling_llama.LlamaAttention.forward
    modeling_llama.LlamaAttention.forward = (
        test_patched_llama_logits_match._orig
    )
    try:
        with torch.no_grad():
            want = model(ids).logits.float().numpy()
    finally:
        modeling_llama.LlamaAttention.forward = orig_fwd
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_patched_qwen2_generate_matches(patched_qwen2):
    model = tiny_qwen2()
    ids = torch.tensor([[3, 1, 4, 1, 5, 9]])
    with torch.no_grad():
        got = model.generate(
            ids, max_new_tokens=8, do_sample=False,
            pad_token_id=0,
        ).numpy()

    from transformers.models.qwen2 import modeling_qwen2
    orig_fwd = modeling_qwen2.Qwen2Attention.forward
    modeling_qwen2.Qwen2Attention.forward = (
        test_patched_qwen2_generate_matches._orig
    )
    try:
        with torch.no_grad():
            want = model.generate(
                ids, max_new_tokens=8, do_sample=False,
                pad_token_id=0,
            ).numpy()
    finally:
        modeling_qwen2.Qwen2Attention.forward = orig_fwd
    np.testing.assert_array_equal(got, want)


def test_patched_llama_right_padded_batch(patched_llama):
    """A right-padded batch (2-D attention_mask) must mask padding keys —
    regression for the round-1 advisor finding that the mask was silently
    ignored. Oracle: the unpatched eager model with the same mask."""
    model = tiny_llama()
    ids = torch.tensor([
        [1, 5, 9, 2, 7, 3, 11, 4],
        [6, 2, 8, 3, 0, 0, 0, 0],  # 4 real tokens + right padding
    ])
    mask = torch.tensor([
        [1, 1, 1, 1, 1, 1, 1, 1],
        [1, 1, 1, 1, 0, 0, 0, 0],
    ])
    with torch.no_grad():
        got = model(ids, attention_mask=mask).logits.float().numpy()

    from transformers.models.llama import modeling_llama
    orig_fwd = modeling_llama.LlamaAttention.forward
    modeling_llama.LlamaAttention.forward = (
        test_patched_llama_logits_match._orig
    )
    try:
        with torch.no_grad():
            want = model(ids, attention_mask=mask).logits.float().numpy()
    finally:
        modeling_llama.LlamaAttention.forward = orig_fwd
    # Compare only real (non-pad) rows; pad rows are garbage both ways.
    np.testing.assert_allclose(got[0], want[0], atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(got[1, :4], want[1, :4], atol=2e-4, rtol=2e-3)


def test_patched_llama_left_padding_rejected(patched_llama):
    """Left padding cannot be expressed as a valid-prefix length: the
    interop path must refuse loudly instead of attending to padding."""
    model = tiny_llama()
    ids = torch.tensor([[0, 0, 0, 6, 2, 8, 3, 9]])
    mask = torch.tensor([[0, 0, 0, 1, 1, 1, 1, 1]])
    with pytest.raises(NotImplementedError):
        with torch.no_grad():
            model(ids, attention_mask=mask)


def test_zero_length_mask_rejected():
    """A 4-D mask whose probed last query row is all-False (e.g. a mask
    processor that fully masks padded query rows) must raise, not silently
    return zeros for the whole sequence (round-2 advisor finding)."""
    from flash_attention_cute.interop.torch_patch import (
        _padding_kv_lengths,
    )

    skv = 8
    # Row 0: normal right-padded prefix (5 valid). Row 1: everything
    # masked in the last query row -> inferred length 0.
    neg = torch.finfo(torch.float32).min
    mask = torch.zeros(2, 1, skv, skv)
    mask[0, 0, :, 5:] = neg
    mask[1, 0, -1, :] = neg
    with pytest.raises(NotImplementedError, match="length 0"):
        _padding_kv_lengths(mask, skv, None)


def test_custom_op_fake_kernel_traces():
    """The attention core is a torch.library custom op with a fake kernel
    (reference: flash_attention/flash_attention.py:40-43): under
    FakeTensorMode the op must produce a correctly-shaped fake tensor
    WITHOUT crossing into JAX — the property torch.compile and meta-device
    loading rely on."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from flash_attention_cute.interop.torch_patch import _get_custom_op

    op = _get_custom_op()
    with FakeTensorMode():
        q = torch.empty(1, 4, 8, 64)
        k = torch.empty(1, 2, 8, 64)
        v = torch.empty(1, 2, 8, 64)
        o = op(q, k, v, 0.125, True, 0)
        assert o.shape == q.shape and o.dtype == q.dtype


def test_patched_llama_torch_compile(patched_llama):
    """A patched model must run under torch.compile (the custom op's fake
    kernel makes the graph traceable; the real kernel runs via the JAX
    bridge at execution time)."""
    model = tiny_llama()
    ids = torch.tensor([[1, 5, 9, 2, 7, 3, 11, 4]])
    with torch.no_grad():
        want = model(ids).logits.float().numpy()
    compiled = torch.compile(model, dynamic=False)
    with torch.no_grad():
        got = compiled(ids).logits.float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def _stash_originals():
    from transformers.models.llama import modeling_llama
    from transformers.models.qwen2 import modeling_qwen2

    test_patched_llama_logits_match._orig = modeling_llama.LlamaAttention.forward
    test_patched_qwen2_generate_matches._orig = (
        modeling_qwen2.Qwen2Attention.forward
    )


_stash_originals()
