"""Paged KV-cache block manager (counterpart of
``deepspeed_tpu/serving/blocks.py``).

The device-side cache is a shared pool of ``num_blocks`` fixed-size
blocks per layer (``[num_blocks, block_size, H, D]``); this class owns
the host-side accounting: which pool blocks belong to which sequence,
expressed as a per-sequence *block table* (logical block j of sequence s
lives in pool block ``table[j]``). A finished sequence's blocks return to
the free list immediately.

Block 0 is the reserved garbage sink (``GARBAGE_BLOCK``): it is never
allocated, table rows pad with it, and bucketed-prefill pad tokens (and
idle decode slots) scatter their KV writes into it.

The JAX manager's refcounted sharing, evictable tier, copy-on-write and
speculative window serve the prefix cache and speculative decoding; they
come with the serving fast-path slice.

Host-only: no torch imports.
"""

from typing import Dict, List

import numpy as np

from deepspeed_tpu_torch.serving.config import blocks_for_tokens

# mirror of ops.decode_attention.GARBAGE_BLOCK without importing torch
GARBAGE_BLOCK = 0


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block {GARBAGE_BLOCK} is the "
                f"reserved garbage sink), got {num_blocks}")
        if block_size <= 0 or max_blocks_per_seq <= 0:
            raise ValueError("block_size and max_blocks_per_seq must be > 0")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        # LIFO free list: recently-freed blocks are re-handed first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._owned: Dict[str, List[int]] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return (self.num_blocks - 1) - self.num_free

    def blocks_needed(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` cache slots (at least one)."""
        return blocks_for_tokens(n_tokens, self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.num_free >= self.blocks_needed(n_tokens)

    def allocate(self, seq_id: str, n_tokens: int) -> np.ndarray:
        """Allocate blocks covering ``n_tokens`` and return the sequence's
        ``[max_blocks_per_seq]`` int32 block table (unused tail = garbage
        block). Raises on double allocation or exhaustion — admission
        control must check :meth:`can_allocate` first."""
        if seq_id in self._owned:
            raise ValueError(f"sequence {seq_id!r} already owns blocks")
        need = self.blocks_needed(n_tokens)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"{n_tokens} tokens need {need} blocks > "
                f"max_blocks_per_seq {self.max_blocks_per_seq}")
        if need > self.num_free:
            raise RuntimeError(
                f"cache pool exhausted: {need} blocks needed, "
                f"{self.num_free} free")
        blocks = [self._free.pop() for _ in range(need)]
        self._owned[seq_id] = blocks
        table = np.full((self.max_blocks_per_seq,), GARBAGE_BLOCK, np.int32)
        table[:need] = blocks
        return table

    def release(self, seq_id: str) -> int:
        """Return a finished sequence's blocks to the free list; returns
        how many were released. Unknown ids are a no-op (a shed request
        never owned blocks)."""
        blocks = self._owned.pop(seq_id, None)
        if not blocks:
            return 0
        self._free.extend(reversed(blocks))
        return len(blocks)

    def owned(self, seq_id: str) -> List[int]:
        return list(self._owned.get(seq_id, ()))
