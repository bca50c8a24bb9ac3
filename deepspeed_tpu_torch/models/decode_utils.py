"""Decode position math shared by the port's decoders (counterpart of
``deepspeed_tpu/models/decode_utils.py``).

The left-padding convention: positions start at 0 at each row's first
real token, the padded prefix occupies cache slots ``[0, pad)``, and the
decode-step mask combines the causal bound, the per-row pad exclusion
and an optional sliding window. Every function works on torch tensors on
the caller's device; only the mask check reads the mask on the host.
"""

import numpy as np
import torch


def validate_left_padded_mask(input_ids, attention_mask):
    """The user-facing mask contract of ``InferenceEngine.generate``:
    promote 1-D, require the same shape as ``input_ids``, require LEFT
    padding (non-decreasing rows) with at least one real token per row,
    and collapse an all-real mask to ``None`` (the unpadded path).
    Returns the validated ``[B, T]`` int32 mask on ``input_ids``' device,
    or ``None``."""
    attention_mask = torch.as_tensor(attention_mask).to(
        device=input_ids.device, dtype=torch.int32)
    if attention_mask.dim() == 1:
        attention_mask = attention_mask[None]
    if tuple(attention_mask.shape) != tuple(input_ids.shape):
        # a mis-shaped mask broadcasts through every position/validity
        # computation and generates garbage with no error
        raise ValueError(
            f"attention_mask shape {tuple(attention_mask.shape)} must "
            f"match input_ids shape {tuple(input_ids.shape)}")
    host_mask = attention_mask.cpu().numpy()
    if not (np.diff(host_mask, axis=1) >= 0).all():
        # right padding would mask REAL cache slots and sample from a
        # pad position: wrong output, no error
        raise ValueError(
            "attention_mask must be LEFT-padded (non-decreasing "
            "along the sequence): pad tokens go before the prompt")
    if not host_mask[:, -1].all():
        # an all-pad row softmaxes over nothing and the first token
        # samples from the masked last position
        raise ValueError(
            "attention_mask has a row whose final position is "
            "padding — every prompt needs at least one real token, "
            "and left padding puts it last")
    if host_mask.all():
        # an equal-length batch: keep the unpadded path
        return None
    return attention_mask


def row_positions(attention_mask):
    """``[B, T]`` per-row positions for LEFT-padded prompts: 0 at each
    row's first real token (pads clip to 0; their outputs are masked)."""
    return torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)


def pad_lengths(attention_mask, T: int):
    """``[B]`` int32 padded-prefix lengths (left padding occupies
    ``[0, pad)``)."""
    return (T - attention_mask.sum(dim=1)).to(torch.int32)


def decode_positions(idx, T: int, pad):
    """``[B, T]`` per-row positions for a padded decode step: absolute
    cache slot minus the row's padded prefix (clipped at 0). ``idx`` is
    an int or a 0-d tensor on ``pad``'s device."""
    t = torch.arange(T, device=pad.device)
    return torch.clamp((idx + t)[None] - pad[:, None], min=0)


def cache_attn_mask(S: int, idx, T: int, pad=None, window: int = 0):
    """Decode-step attention mask over the ``[B?, 1, T, S]`` cache window:
    key slot <= query slot, plus, when ``pad`` (``[B]``) is given, the
    per-row padded-prefix exclusion (key slot >= pad), plus an optional
    sliding window (key slot > query slot - window). ``idx`` is an int or
    0-d tensor (one shared cache index: ``generate()``'s batch advances in
    lockstep) or a ``[B]`` tensor of per-row valid lengths (paged serving
    slots)."""
    idx = torch.as_tensor(idx)
    if pad is not None:
        idx = idx.to(pad.device)
    key_pos = torch.arange(S, device=idx.device)
    t = torch.arange(T, device=idx.device)
    if idx.dim() == 1:
        # ragged rows: query t of row b sits at slot idx[b] + t
        q_pos = idx[:, None] + t[None]                        # [B, T]
        mask = key_pos[None, None, :] <= q_pos[:, :, None]    # [B, T, S]
        if window:
            mask = mask & (key_pos[None, None, :]
                           > q_pos[:, :, None] - window)
        if pad is not None:
            mask = mask & (key_pos[None, None, :] >= pad[:, None, None])
        return mask[:, None]                                  # [B,1,T,S]
    q_pos = idx + t
    mask = key_pos[None, :] <= q_pos[:, None]                 # [T, S]
    if window:
        mask = mask & (key_pos[None, :] > q_pos[:, None] - window)
    if pad is None:
        return mask[None, None]                               # [1,1,T,S]
    mask = mask[None] & (key_pos[None, None, :] >= pad[:, None, None])
    return mask[:, None]                                      # [B,1,T,S]


def paged_positions(lengths, T: int):
    """``[B, T]`` absolute cache positions for a paged step: row b's input
    token t lands at logical slot ``lengths[b] + t``."""
    return lengths[:, None] + torch.arange(T, device=lengths.device,
                                           dtype=lengths.dtype)[None]


def paged_write_rows(block_tables, positions, num_valid, block_size: int):
    """``[B, T]`` flattened pool rows for a paged step's KV writes.

    Real tokens (``t < num_valid[b]``) map through the row's block table:
    ``table[b, pos // bs] * bs + pos % bs``. The padded tail of a bucketed
    prefill (and idle serving slots, ``num_valid == 0``) routes to the
    reserved garbage block 0 instead — pads must never overwrite another
    sequence's blocks, and clamping them onto real rows would corrupt
    this sequence's own prefix."""
    T = positions.shape[1]
    mb = block_tables.shape[-1]
    blk = torch.clamp(positions // block_size, 0, mb - 1)
    off = positions % block_size
    rows = torch.gather(block_tables, 1, blk.long()) * block_size + off
    valid = torch.arange(T, device=positions.device)[None] \
        < num_valid[:, None]
    return torch.where(valid, rows, off)
