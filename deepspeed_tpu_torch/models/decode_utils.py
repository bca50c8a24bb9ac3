"""Decode position math of the paged KV cache (counterpart of
``deepspeed_tpu/models/decode_utils.py:71-121``).

The left-padding helpers of that module serve padded ``generate()``, which
comes with the padded-generate slice; ``cache_attn_mask`` here takes no
pad or window for the same reason.
"""

import torch


def cache_attn_mask(S: int, idx, T: int):
    """Decode-step attention mask over the ``[B?, 1, T, S]`` cache window:
    key slot <= query slot. ``idx`` is an int or 0-d tensor (one shared
    cache index) or a ``[B]`` tensor of per-row valid lengths (paged
    serving slots)."""
    idx = torch.as_tensor(idx)
    key_pos = torch.arange(S, device=idx.device)
    t = torch.arange(T, device=idx.device)
    if idx.dim() == 1:
        q_pos = idx[:, None] + t[None]                        # [B, T]
        return (key_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    q_pos = idx + t
    return (key_pos[None, :] <= q_pos[:, None])[None, None]   # [1,1,T,S]


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
