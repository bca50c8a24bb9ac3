"""Block-sparsity layout zoo (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``).

A config maps ``seq_len`` to a ``[num_heads, num_blocks, num_blocks]`` 0/1
layout where entry ``(h, i, j)`` says whether query block ``i`` of head
``h`` may attend key block ``j`` (the reference's Dense/Fixed/Variable/
BigBird/BSLongformer/LocalSlidingWindow configs). The layouts drive the
masked plain path of :mod:`sparse_self_attention` and the block lists of
the block-sparse kernels (:mod:`block_sparse_kernel`).

The module is numpy only and a copy of the JAX package's, so every layout
is equal to the JAX one bit for bit, the random modes' draws from
``np.random.default_rng(0)`` included.
"""

from typing import List, Optional

import numpy as np


def sparsity_config_from_dict(d, num_heads: int):
    """DS-config ``sparse_attention`` section → SparsityConfig instance
    (reference parses the same keys in runtime/config.py:269-451:
    ``{"mode": "fixed"|"variable"|"bigbird"|"bslongformer"|"dense"|
    "local", ...mode-specific params}``)."""
    d = dict(d or {})
    mode = d.pop("mode", "fixed")
    d.pop("num_heads", None)  # the model's head count wins
    registry = {
        "dense": DenseSparsityConfig,
        "fixed": FixedSparsityConfig,
        "variable": VariableSparsityConfig,
        "bigbird": BigBirdSparsityConfig,
        "bslongformer": BSLongformerSparsityConfig,
        "local": LocalSlidingWindowSparsityConfig,
    }
    if mode not in registry:
        raise ValueError(f"unknown sparse_attention mode {mode!r}; "
                         f"have {sorted(registry)}")
    return registry[mode](num_heads=num_heads, **d)


class SparsityConfig:
    """Base config (reference ``sparsity_config.py:9``)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"sequence length {seq_len} must be divisible by block size "
                f"{self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), np.int64)

    def propagate_first_head(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def expand_mask(self, layout: np.ndarray, seq_len: Optional[int] = None
                    ) -> np.ndarray:
        """[H, nb, nb] block layout → [H, S, S] boolean token mask."""
        b = self.block
        return np.kron(layout, np.ones((b, b), np.int64))[:, :seq_len,
                                                          :seq_len].astype(bool)


class DenseSparsityConfig(SparsityConfig):
    """All-ones layout; the debugging/identity pattern (reference ``:63``)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


def _causal(layout: np.ndarray) -> np.ndarray:
    return np.tril(layout)


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer 'fixed' pattern (reference ``:94``): local windows
    of ``num_local_blocks`` plus per-window global representative blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be divisible by "
                f"num_global_blocks {num_global_blocks}")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal global attention requires bidirectional mode")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "multiple global patterns require different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"num_different_global_patterns "
                f"{num_different_global_patterns} exceeds "
                f"{num_local_blocks // num_global_blocks}")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        row = np.arange(nb)
        same_window = (row[:, None] // self.num_local_blocks) == \
                      (row[None, :] // self.num_local_blocks)
        for h in range(self.num_layout_heads):
            # local windows
            local = same_window.copy()
            if self.attention == "unidirectional":
                local &= row[None, :] <= row[:, None]
            layout[h][local] = 1
            # global representative blocks: last num_global_blocks of each
            # window by default; heads rotate backwards through the window
            # when multiple patterns are requested
            offset = self.num_local_blocks - (
                1 + h % self.num_different_global_patterns
            ) * self.num_global_blocks
            full_end = nb - (nb % self.num_local_blocks)
            starts = list(range(offset, full_end, self.num_local_blocks))
            if full_end < nb:  # short trailing window
                starts.append(min(full_end + offset, nb - self.num_global_blocks))
            for s in starts:
                cols = slice(s, s + self.num_global_blocks)
                first_row = 0 if self.attention == "bidirectional" else s
                layout[h, first_row:, cols] = 1
                if self.horizontal_global_attention:
                    layout[h, cols, :] = 1
        return self.propagate_first_head(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local-window sizes + global/random blocks (reference ``:243``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 rng: Optional[np.random.Generator] = None):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal global attention requires bidirectional mode")
        if num_random_blocks > 0 and not different_layout_per_head:
            # reference requires per-head layouts for random sparsity
            self.num_layout_heads = num_heads
            self.different_layout_per_head = True
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError("global start/end index lists differ in length")
            for s, e in zip(self.global_block_indices, global_block_end_indices):
                if s >= e:
                    raise ValueError(f"global block start {s} >= end {e}")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self._rng = rng or np.random.default_rng(0)

    def _windows(self, nb: int):
        """Yield (start, end) of consecutive local windows: the given sizes
        first, then the last size repeated (reference semantics)."""
        start = 0
        i = 0
        while start < nb:
            size = self.local_window_blocks[min(i, len(self.local_window_blocks) - 1)]
            yield start, min(start + size, nb)
            start += size
            i += 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        for h in range(self.num_layout_heads):
            for s, e in self._windows(nb):
                for r in range(s, e):
                    cols_end = (r + 1) if self.attention == "unidirectional" else e
                    layout[h, r, s:cols_end] = 1
            if self.num_random_blocks:
                for r in range(nb):
                    hi = nb if self.attention == "bidirectional" else r + 1
                    cols = self._rng.choice(hi, size=min(self.num_random_blocks, hi),
                                            replace=False)
                    layout[h, r, cols] = 1
            if self.global_block_end_indices is None:
                for idx in self.global_block_indices:
                    if idx < nb:
                        layout[h, :, idx] = 1
                        if self.horizontal_global_attention:
                            layout[h, idx, :] = 1
            else:
                for s, e in zip(self.global_block_indices,
                                self.global_block_end_indices):
                    if s < nb:
                        e = min(e, nb)
                        layout[h, :, s:e] = 1
                        if self.horizontal_global_attention:
                            layout[h, s:e, :] = 1
            if self.attention == "unidirectional":
                layout[h] = _causal(layout[h])
        return self.propagate_first_head(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding window + global ITC blocks (reference ``:421``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 rng: Optional[np.random.Generator] = None):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self._rng = rng or np.random.default_rng(0)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        for name, need in (("random", self.num_random_blocks),
                           ("sliding window", self.num_sliding_window_blocks),
                           ("global", self.num_global_blocks)):
            if nb < need:
                raise ValueError(
                    f"number of {name} blocks, {need}, must be <= total "
                    f"blocks in a row, {nb}")
        row = np.arange(nb)
        w = self.num_sliding_window_blocks // 2
        sliding = np.abs(row[:, None] - row[None, :]) <= w
        for h in range(self.num_layout_heads):
            for r in range(nb):
                hi = nb if self.attention == "bidirectional" else r + 1
                cols = self._rng.choice(hi, size=min(self.num_random_blocks, hi),
                                        replace=False)
                layout[h, r, cols] = 1
            layout[h][sliding] = 1
            g = self.num_global_blocks
            layout[h, :g, :] = 1
            layout[h, :, :g] = 1
            if self.attention == "unidirectional":
                layout[h] = _causal(layout[h])
        return self.propagate_first_head(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + global indices (reference ``:559``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError("global start/end index lists differ in length")
            for s, e in zip(self.global_block_indices, global_block_end_indices):
                if s >= e:
                    raise ValueError(f"global block start {s} >= end {e}")

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError(
                f"number of sliding window blocks, "
                f"{self.num_sliding_window_blocks}, must be <= total blocks "
                f"in a row, {nb}")
        row = np.arange(nb)
        w = self.num_sliding_window_blocks // 2
        sliding = np.abs(row[:, None] - row[None, :]) <= w
        for h in range(self.num_layout_heads):
            layout[h][sliding] = 1
            if self.global_block_end_indices is None:
                for idx in self.global_block_indices:
                    if idx < nb:
                        layout[h, idx, :] = 1
                        layout[h, :, idx] = 1
            else:
                for s, e in zip(self.global_block_indices,
                                self.global_block_end_indices):
                    if s < nb:
                        e = min(e, nb)
                        layout[h, s:e, :] = 1
                        layout[h, :, s:e] = 1
            if self.attention == "unidirectional":
                layout[h] = _causal(layout[h])
        return self.propagate_first_head(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding-window attention (reference ``:700`` region)."""

    def __init__(self, num_heads, block=16,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        row = np.arange(nb)
        w = self.num_sliding_window_blocks // 2
        sliding = np.abs(row[:, None] - row[None, :]) <= w
        layout[0][sliding] = 1
        if self.attention == "unidirectional":
            layout[0] = _causal(layout[0])
        return self.propagate_first_head(layout)
