"""Paged KV-cache block manager: refcounted pool with copy-on-write
(copy of ``deepspeed_tpu/serving/blocks.py``).

The device-side cache is a shared pool of ``num_blocks`` fixed-size
blocks per layer (``[num_blocks, block_size, H, D]``); this class owns
the host-side accounting: which pool blocks belong to which sequence,
expressed as a per-sequence *block table* (logical block j of sequence s
lives in pool block ``table[j]``). Sequences of different lengths share
the one allocation, and a finished sequence's blocks return to the free
list immediately — the next admission reuses them without touching the
device. Under tensor parallelism each rank's pools hold its heads of
every block (``[num_blocks, block_size, H / tp, D]``) and every rank
keeps this accounting alike, so one block table addresses every rank's
pool.

Block 0 is the reserved garbage sink (``GARBAGE_BLOCK``): it is never
allocated, table rows pad with it, and bucketed-prefill pad tokens (and
idle decode slots) scatter their KV writes into it.

Prefix sharing (the serving fast path's substrate) adds three ideas on
top of the plain free list, all invisible until a prefix cache drives
them:

- **refcounts** — a physical block may appear in several sequences'
  block tables at once (a shared system prompt prefilled exactly once).
  ``release()`` decrements instead of freeing; the block's storage is
  reclaimed only when the last holder lets go.
- **cached / evictable blocks** — a block the prefix cache indexes
  outlives its last owner: at refcount zero it parks on an LRU
  *evictable* list (its KV bytes intact, ready to be re-shared) instead
  of the free list, and is recycled lazily only when an allocation
  finds the free list empty. ``num_free`` counts both tiers — evictable
  blocks are reclaimable without touching any live sequence.
- **copy-on-write** — a partially-filled cached block can be mapped
  into a new sequence only as a private copy (appending in place would
  corrupt every other reader). ``allocate(cow_src=...)`` pins the
  source until the engine confirms the device-side copy with
  :meth:`cow_done`, so an interleaved allocation can never evict the
  source mid-copy.

Host-only: no torch imports — the scheduler/policy tier runs in
milliseconds anywhere.
"""

from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence

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
        # LIFO free list: recently-freed blocks are re-handed first (their
        # pool pages are the likeliest still resident)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._owned: Dict[str, List[int]] = {}
        # physical block -> number of live holders (owning sequences plus
        # at most one pending-COW pin per admitting sequence)
        self._ref: Dict[int, int] = {}
        # blocks the prefix cache indexes (their KV must stay immutable
        # and their storage outlives the owning sequence)
        self._cached = set()
        # cached blocks at refcount zero, oldest-touched first — the LRU
        # eviction ladder. Values unused; OrderedDict for move_to_end.
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        # seq -> pinned COW source block (held until cow_done/release)
        self._cow_pending: Dict[str, int] = {}
        # seq -> owned-block count BEFORE its open speculative window
        # (speculate() grants extra blocks past it; commit/drop return
        # the uncommitted tail to the free list without copies)
        self._spec_base: Dict[str, int] = {}
        # notification hook: called with the block id when an evictable
        # block is recycled, so the prefix cache can drop its trie entry
        self.on_evict = None
        self.evictions = 0

    # ------------------------------------------------------------------
    @property
    def num_free(self) -> int:
        """Blocks an allocation can claim without touching a live
        sequence: the free list plus the evictable (cached, refcount-0)
        tier."""
        return len(self._free) + len(self._evictable)

    @property
    def num_allocated(self) -> int:
        return (self.num_blocks - 1) - self.num_free

    @property
    def num_cached(self) -> int:
        """Blocks the prefix cache currently indexes (live or
        evictable)."""
        return len(self._cached)

    def ref_count(self, block: int) -> int:
        return self._ref.get(int(block), 0)

    def is_shared(self, block: int) -> bool:
        return self.ref_count(block) > 1

    def blocks_needed(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` cache slots (at least one: every
        sequence owns a block from its first token) — the one shared
        block-count formula (``config.blocks_for_tokens``)."""
        return blocks_for_tokens(n_tokens, self.block_size)

    def can_allocate(self, n_blocks: int) -> bool:
        return self.num_free >= int(n_blocks)

    def can_allocate_shared(self, n_tokens: int,
                            shared: Sequence[int] = (),
                            cow_src: Optional[int] = None) -> bool:
        """Whether an admission with ``shared`` prefix blocks (mapped in
        by refcount, consuming nothing) and an optional COW source can
        take its remaining fresh blocks. Shared/source blocks currently
        parked on the evictable list stop being reclaimable the moment
        they are pinned, so they are discounted from the budget."""
        fresh = self.blocks_needed(n_tokens) - len(shared)
        pinned = [b for b in shared if b in self._evictable]
        if cow_src is not None and cow_src in self._evictable:
            pinned.append(cow_src)
        return self.num_free - len(pinned) >= fresh

    # ------------------------------------------------------------------
    def _take(self) -> int:
        """Claim one physical block: the free list first, else recycle
        the least-recently-used evictable block (notifying the prefix
        cache so its trie entry dies with the bytes)."""
        if self._free:
            return self._free.pop()
        if self._evictable:
            block, _ = self._evictable.popitem(last=False)
            self._cached.discard(block)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(block)
            return block
        raise RuntimeError("cache pool exhausted")

    def _pin(self, block: int):
        """Add one reference to a cached block (a new sequence maps it
        into its table, or a COW copy is pending from it)."""
        block = int(block)
        if block in self._evictable:
            del self._evictable[block]
        self._ref[block] = self._ref.get(block, 0) + 1

    def _unref(self, block: int):
        ref = self._ref.get(block, 0) - 1
        if ref > 0:
            self._ref[block] = ref
            return
        self._ref.pop(block, None)
        if block in self._cached:
            # the prefix cache still indexes it: park on the LRU tier
            # (most-recently-released = last out)
            self._evictable[block] = None
            self._evictable.move_to_end(block)
        else:
            self._free.append(block)

    # ------------------------------------------------------------------
    def allocate(self, seq_id: str, n_tokens: int,
                 shared: Sequence[int] = (),
                 cow_src: Optional[int] = None) -> np.ndarray:
        """Allocate blocks covering ``n_tokens`` and return the sequence's
        ``[max_blocks_per_seq]`` int32 block table (unused tail = garbage
        block).

        ``shared`` maps already-cached full prefix blocks read-only into
        the front of the table (refcount++, no storage consumed);
        ``cow_src`` names a cached partially-filled block whose contents
        the first fresh block must receive a device-side copy of before
        any append — the source is pinned until :meth:`cow_done` (or
        release) so a concurrent allocation cannot evict it mid-copy.

        Raises on double allocation or exhaustion — admission control
        must check :meth:`can_allocate_shared` first.
        """
        if seq_id in self._owned:
            raise ValueError(f"sequence {seq_id!r} already owns blocks")
        need = self.blocks_needed(n_tokens)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"{n_tokens} tokens need {need} blocks > "
                f"max_blocks_per_seq {self.max_blocks_per_seq}")
        if not self.can_allocate_shared(n_tokens, shared, cow_src):
            raise RuntimeError(
                f"cache pool exhausted: {need - len(shared)} fresh blocks "
                f"needed, {self.num_free} reclaimable")
        if len(shared) >= need:
            raise ValueError(
                f"shared prefix ({len(shared)} blocks) must leave at least "
                f"one fresh block of the {need} needed")
        # pin shared + COW source FIRST: fresh takes below may evict, and
        # they must never evict a block this admission is about to read
        for b in shared:
            self._pin(b)
        if cow_src is not None:
            self._pin(cow_src)
            self._cow_pending[seq_id] = int(cow_src)
        fresh = [self._take() for _ in range(need - len(shared))]
        for b in fresh:
            self._ref[b] = self._ref.get(b, 0) + 1
        blocks = [int(b) for b in shared] + fresh
        self._owned[seq_id] = blocks
        table = np.full((self.max_blocks_per_seq,), GARBAGE_BLOCK, np.int32)
        table[:need] = blocks
        return table

    def cow_done(self, seq_id: str):
        """The engine finished the device-side block copy: drop the
        pending pin on the COW source (it may become evictable again)."""
        src = self._cow_pending.pop(seq_id, None)
        if src is not None:
            self._unref(src)

    # ------------------------------------------------------------------
    # speculative window (draft-and-verify decoding)
    # ------------------------------------------------------------------
    def speculate(self, seq_id: str, n_tokens: int) -> List[int]:
        """Open (or extend) ``seq_id``'s speculative write window: its
        block set grows to cover ``n_tokens`` cache rows so a verify
        step can scatter up to ``k`` draft tokens past the committed
        length. Blocks the sequence already owns are reused in place
        (the worst-case admission reservation usually covers the whole
        window — then this is pure ledger work); only coverage past them
        takes fresh blocks, and those are the window's droppable tail.
        Returns the freshly granted blocks (often ``[]``).

        Re-speculating with a window still open is legal and keeps the
        ORIGINAL base — a verify dispatch that died between draft and
        commit (chaos, failover) must be able to retry from the same
        committed state without leaking its first grant.
        """
        blocks = self._owned.get(seq_id)
        if blocks is None:
            raise ValueError(f"sequence {seq_id!r} owns no blocks to "
                             "speculate past")
        need = self.blocks_needed(n_tokens)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"speculative window of {n_tokens} tokens needs {need} "
                f"blocks > max_blocks_per_seq {self.max_blocks_per_seq}")
        self._spec_base.setdefault(seq_id, len(blocks))
        extra = need - len(blocks)
        if extra <= 0:
            return []
        if self.num_free < extra:
            raise RuntimeError(
                f"cache pool exhausted: speculative window needs {extra} "
                f"fresh blocks, {self.num_free} reclaimable")
        fresh = [self._take() for _ in range(extra)]
        for b in fresh:
            self._ref[b] = self._ref.get(b, 0) + 1
        blocks.extend(fresh)
        return fresh

    def commit_speculative(self, seq_id: str, n_tokens: int) -> int:
        """Close the speculative window, keeping blocks that cover the
        accepted prefix's ``n_tokens`` cache rows: they simply fold into
        the sequence's owned set (their KV bytes are already in place —
        no copies), while granted blocks past the commit point return to
        the free list. Returns how many blocks were dropped. No open
        window is a no-op (a pure-ledger window never granted blocks).
        """
        base = self._spec_base.pop(seq_id, None)
        if base is None:
            return 0
        blocks = self._owned.get(seq_id)
        if not blocks:
            return 0
        keep = max(base, self.blocks_needed(n_tokens))
        dropped = blocks[keep:]
        del blocks[keep:]
        for b in reversed(dropped):
            self._unref(b)
        return len(dropped)

    def drop_speculative(self, seq_id: str) -> int:
        """Reject the whole window: every granted block returns to the
        free list, the owned set is exactly as before ``speculate()``."""
        return self.commit_speculative(seq_id, 0)

    def speculating(self, seq_id: str) -> bool:
        return seq_id in self._spec_base

    # ------------------------------------------------------------------
    def release(self, seq_id: str) -> int:
        """Drop a finished sequence's references; returns how many table
        entries were released. A block's storage is reclaimed only at
        refcount zero — shared prefix blocks survive their co-owners, and
        cached blocks park on the evictable LRU instead of the free list.
        Unknown ids are a no-op (a shed request never owned blocks)."""
        self.cow_done(seq_id)
        self._spec_base.pop(seq_id, None)
        blocks = self._owned.pop(seq_id, None)
        if not blocks:
            return 0
        for b in reversed(blocks):
            self._unref(b)
        return len(blocks)

    def owned(self, seq_id: str) -> List[int]:
        return list(self._owned.get(seq_id, ()))

    # ------------------------------------------------------------------
    # prefix-cache surface
    # ------------------------------------------------------------------
    def mark_cached(self, block: int):
        """Register a block as indexed by the prefix cache: from now on
        its storage survives its last owner (evictable LRU, not the free
        list) until :meth:`drop_cached` or LRU recycling."""
        block = int(block)
        if block == GARBAGE_BLOCK:
            raise ValueError("the garbage block can never be cached")
        self._cached.add(block)

    def drop_cached(self, block: int):
        """The prefix cache stopped indexing a block (subtree pruned):
        if it was parked evictable it returns to the free list now; a
        live owner keeps it alive as a plain private block."""
        block = int(block)
        self._cached.discard(block)
        if block in self._evictable:
            del self._evictable[block]
            self._free.append(block)

    def touch(self, blocks: Iterable[int]):
        """LRU hit: matched blocks move to the most-recently-used end of
        the evictable ladder (live blocks are untouched — they are not
        eviction candidates)."""
        for b in blocks:
            b = int(b)
            if b in self._evictable:
                self._evictable.move_to_end(b)
