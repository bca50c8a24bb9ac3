"""Radix prefix cache over paged KV blocks (copy of
``deepspeed_tpu/serving/prefix_cache.py``).

A trie keyed on token-id *block chunks* (one edge = ``block_size``
token ids = one immutable, fully-written pool block). On admission the
scheduler asks :meth:`match` for the longest cached prefix of the new
prompt; the matched blocks are mapped read-only into the sequence's
block table (a refcount bump in :class:`BlockManager` — zero device
work) and prefill runs only on the unmatched tail. After a prompt's
prefill completes the engine calls :meth:`insert` so the next request
with the same system prompt hits.

Two sharing granularities:

- **full blocks** — an interior/leaf trie node per fully-written block.
  These are immutable by construction (paged writes only ever append at
  positions past the owner's prompt, i.e. into later blocks), so any
  number of sequences may read them concurrently.
- **one partial tail per node** — a prompt whose length is not a block
  multiple leaves its last block partially filled; that block is
  registered as a *tail* (token tuple -> block) under the node its full
  prefix reaches. A matching request may reuse those rows too, but only
  through **copy-on-write**: the block will be appended to, so
  :meth:`match` hands it back as ``cow_src`` and the engine copies it
  into the sequence's own fresh block before any write.

The match is capped at ``len(prompt) - 1`` tokens: at least one tail
token must run through the model to produce the first sampled logits.

Eviction is owned by the :class:`BlockManager`: cached blocks at
refcount zero sit on its LRU evictable ladder, and when an allocation
recycles one the manager's ``on_evict`` hook lands here —
:meth:`_drop_block` removes the trie entry and prunes the orphaned
subtree (a chain with a hole in it can never be matched again, so its
blocks go straight back to the free list).

Host-only: no torch imports — matching is pure token-tuple dict walks,
microseconds per admit.
"""

from typing import Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.serving.blocks import GARBAGE_BLOCK, BlockManager


class _Node:
    __slots__ = ("parent", "chunk", "block", "children", "tails")

    def __init__(self, parent: Optional["_Node"],
                 chunk: Optional[Tuple[int, ...]], block: Optional[int]):
        self.parent = parent
        self.chunk = chunk               # the edge from parent (token tuple)
        self.block = block               # physical pool block (None = root)
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.tails: Dict[Tuple[int, ...], int] = {}  # partial-block entries


class PrefixCache:
    """Longest-cached-prefix index for the serving admission path."""

    def __init__(self, blocks: BlockManager):
        self.blocks = blocks
        self.block_size = blocks.block_size
        self._root = _Node(None, None, None)
        # physical block -> its trie location, for O(1) eviction:
        # ("node", node) for full blocks, ("tail", node, tokens) for tails
        self._by_block: Dict[int, tuple] = {}
        self.stats = {"lookups": 0, "hits": 0, "hit_tokens": 0,
                      "inserted_blocks": 0, "evicted_blocks": 0}
        blocks.on_evict = self._drop_block

    def __len__(self) -> int:
        return len(self._by_block)

    # ------------------------------------------------------------------
    def match(self, prompt: Sequence[int]
              ) -> Tuple[List[int], Optional[int], int]:
        """Longest cached prefix of ``prompt``, capped at
        ``len(prompt) - 1`` tokens.

        Returns ``(shared_blocks, cow_src, matched_tokens)``:
        ``shared_blocks`` are full blocks to map read-only (in logical
        order), ``cow_src`` is an optional partial tail block whose
        first ``matched_tokens - len(shared_blocks) * block_size`` rows
        are valid and must be copied before use, and ``matched_tokens``
        is the total prefix length already present in the pool.
        """
        bs = self.block_size
        usable = len(prompt) - 1
        self.stats["lookups"] += 1
        node, shared, pos = self._root, [], 0
        while pos + bs <= usable:
            child = node.children.get(tuple(int(t) for t in
                                            prompt[pos:pos + bs]))
            if child is None:
                break
            shared.append(child.block)
            node = child
            pos += bs
        cow_src, tail_len = None, 0
        for toks, blk in node.tails.items():
            n = len(toks)
            if (n > tail_len and pos + n <= usable
                    and tuple(int(t) for t in prompt[pos:pos + n]) == toks):
                cow_src, tail_len = blk, n
        matched = pos + tail_len
        if matched:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += matched
            self.blocks.touch(shared + ([cow_src] if cow_src is not None
                                        else []))
        return shared, cow_src, matched

    # ------------------------------------------------------------------
    def insert(self, prompt: Sequence[int], table) -> int:
        """Index a just-prefilled prompt's blocks; returns how many new
        blocks were registered. Chunks already cached keep their
        existing physical block (the sequence's own duplicate stays a
        plain private block); the partial last block, if any, registers
        as a COW tail."""
        bs = self.block_size
        node, pos, i, added = self._root, 0, 0, 0
        while pos + bs <= len(prompt):
            chunk = tuple(int(t) for t in prompt[pos:pos + bs])
            child = node.children.get(chunk)
            if child is None:
                blk = int(table[i])
                if blk == GARBAGE_BLOCK or blk in self._by_block:
                    # a table should never pad inside the prompt span and
                    # one physical block indexes at most one trie entry;
                    # either way there is nothing safe to register past
                    # this point
                    return added
                child = _Node(node, chunk, blk)
                node.children[chunk] = child
                self._by_block[blk] = ("node", child)
                self.blocks.mark_cached(blk)
                added += 1
            node = child
            pos += bs
            i += 1
        tail = tuple(int(t) for t in prompt[pos:])
        if 0 < len(tail) < bs and tail not in node.tails:
            blk = int(table[i])
            if blk != GARBAGE_BLOCK and blk not in self._by_block:
                node.tails[tail] = blk
                self._by_block[blk] = ("tail", node, tail)
                self.blocks.mark_cached(blk)
                added += 1
        self.stats["inserted_blocks"] += added
        return added

    # ------------------------------------------------------------------
    def _drop_block(self, block: int):
        """BlockManager recycled a cached block (LRU eviction): remove
        its trie entry, and prune the orphaned subtree — a descendant
        chain with a missing link can never be matched, so its blocks'
        storage returns to the free list immediately."""
        entry = self._by_block.pop(int(block), None)
        self.stats["evicted_blocks"] += 1
        if entry is None:
            return
        if entry[0] == "tail":
            _, node, toks = entry
            node.tails.pop(toks, None)
            return
        node = entry[1]
        if node.parent is not None:
            node.parent.children.pop(node.chunk, None)
        self._prune(node)

    def _prune(self, node: _Node):
        """Drop a detached subtree's cache registrations (the evicted
        root's own block is already recycled by the manager)."""
        stack = list(node.children.values())
        for toks, blk in node.tails.items():
            self._release_entry(blk)
        node.tails.clear()
        node.children.clear()
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self._release_entry(n.block)
            for blk in n.tails.values():
                self._release_entry(blk)
            n.children.clear()
            n.tails.clear()

    def _release_entry(self, block: int):
        if self._by_block.pop(int(block), None) is not None:
            self.blocks.drop_cached(int(block))
