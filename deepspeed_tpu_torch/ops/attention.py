"""Attention ops (counterpart of ``deepspeed_tpu/ops/attention.py``).

:func:`attention_reference` is the plain dense attention;
:func:`attention` is the dispatching entry point with the JAX signature's
``mask`` and ``use_flash``. Without a mask it goes through the flash
autograd function (``ops/flash_attention.py``), causal or not, on both
devices: on a CPU tensor its forward and backward take their plain
versions, on a CUDA tensor they launch the flash kernels, which take any
sequence length. With a mask (BERT's padding mask) it takes the plain
masked attention, as the JAX entry point does on its masked path. The JAX
entry point's bias and dropout have no caller on the ported paths (the
plain attention takes a bias, for ``SparseSelfAttention``'s relative
position bias); sequence-parallel dispatch comes with the multi-GPU
slice.
"""

import torch

from deepspeed_tpu_torch.ops.flash_attention import flash_attention


def attention_reference(q, k, v, mask=None, causal=True, softmax_scale=None,
                        bias=None):
    """Plain attention: q, k, v ``[batch, heads, seq, head_dim]``; ``mask``
    a boolean broadcastable to ``[batch, heads, q, k]`` (True = visible);
    ``bias`` an additive logits bias broadcastable to the same (a
    relative-position bias).

    Softmax in fp32 whatever the input dtype; the probabilities are
    rounded to q's dtype before P·V."""
    q_len, head_dim = q.shape[-2], q.shape[-1]
    k_len = k.shape[-2]
    scale = softmax_scale if softmax_scale is not None else head_dim ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
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


def attention(q, k, v, mask=None, causal=True, softmax_scale=None,
              use_flash=None):
    """Attention entry point (q, k, v ``[B, H, T, D]``), differentiable.
    ``mask`` (bool, broadcastable to ``[B, H, Tq, Tk]``, True = visible)
    or ``use_flash=False`` take :func:`attention_reference`; otherwise
    flash attention, whose wrappers take their plain versions on the CPU
    and launch the kernels (or raise) on any other device."""
    if mask is not None or use_flash is False:
        return attention_reference(q, k, v, mask=mask, causal=causal,
                                   softmax_scale=softmax_scale)
    return flash_attention(q, k, v, causal=causal,
                           softmax_scale=softmax_scale)[0]
