"""Attention ops (counterpart of ``deepspeed_tpu/ops/attention.py``).

:func:`attention_reference` is the plain dense attention; :func:`attention`
goes through the flash autograd function (``ops/flash_attention.py``) on
both devices: on a CPU tensor its forward and backward take their plain
versions, on a CUDA tensor they launch the flash kernels, which take any
sequence length — there is no dense fallback on the card. The JAX entry
point's mask, bias and dropout have no caller on the GPT-2 serving and
training paths; sequence-parallel dispatch comes with the multi-GPU slice.
"""

import torch

from deepspeed_tpu_torch.ops.flash_attention import flash_attention


def attention_reference(q, k, v, mask=None, causal=True, softmax_scale=None):
    """Plain attention: q, k, v ``[batch, heads, seq, head_dim]``; ``mask``
    a boolean broadcastable to ``[batch, heads, q, k]`` (True = visible).

    Softmax in fp32 whatever the input dtype; the probabilities are
    rounded to q's dtype before P·V."""
    q_len, head_dim = q.shape[-2], q.shape[-1]
    k_len = k.shape[-2]
    scale = softmax_scale if softmax_scale is not None else head_dim ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    neg = torch.finfo(torch.float32).min
    if causal:
        causal_mask = torch.tril(torch.ones((q_len, k_len), dtype=torch.bool,
                                            device=q.device),
                                 diagonal=k_len - q_len)
        logits = logits.masked_fill(~causal_mask, neg)
    if mask is not None:
        logits = logits.masked_fill(~mask, neg)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def attention(q, k, v, causal=True, softmax_scale=None):
    """Attention entry point (q, k, v ``[B, H, T, D]``), differentiable:
    flash attention, whose wrappers take their plain versions on the CPU
    and launch the kernels (or raise) on any other device."""
    return flash_attention(q, k, v, causal=causal,
                           softmax_scale=softmax_scale)[0]
