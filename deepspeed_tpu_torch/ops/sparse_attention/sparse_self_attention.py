"""Sparse self-attention over a block layout (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

:class:`SparseSelfAttention` routes the pure-layout case (no relative
position bias, no key-padding mask, no attention mask, block >= 128: the
JAX module's ``_use_kernel`` rule) to :func:`~deepspeed_tpu_torch.ops.
sparse_attention.block_sparse_kernel.block_sparse_attention`, whose
wrappers launch the block-sparse kernels on the card and take their plain
versions on the CPU. Every other case takes the plain masked attention
(``ops.attention.attention_reference``) with the layout expanded to a
token mask, as the JAX module does on its masked path.

:class:`SparseAttentionUtils` mirrors the reference's HF-patching helpers:
pad/unpad to the block size, extend the position table, and patch a
model (the port's BERT family) onto block-sparse attention with a longer
position window.
"""

import dataclasses
import inspect
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.attention import attention_reference
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import (
    block_sparse_attention)

# the block size from which the JAX module launches its kernel (``:81-82``)
KERNEL_MIN_BLOCK = 128


def _keep(mask, mode):
    """Boolean keep-mask of a runtime mask: "mul" keeps non-zeros; "add"
    keeps additive values above -1e4 (or non-zeros of an integer mask)."""
    mask = torch.as_tensor(mask)
    if mode == "mul" or not mask.is_floating_point():
        return mask != 0
    return mask > -1e4


class SparseSelfAttention:
    """q/k/v: ``[batch, heads, seq, head_dim]`` → context, attending only
    where the block layout allows.

    ``key_padding_mask_mode``/``attn_mask_mode``: "add" (additive logits
    mask) or "mul" (multiplicative 0/1) — reference surface kept.

    ``heads``: ``(start, stop)``, the heads this instance attends (a
    tensor-parallel rank's ``[r·H/tp, (r+1)·H/tp)``; q/k/v then hold
    ``stop - start`` heads). The layout is drawn at all of the config's
    ``num_heads``, from the same generator state as a whole model's, and
    these rows are taken: drawn at fewer heads, the random modes
    (``bigbird``, ``variable``) and ``different_layout_per_head`` would
    give another pattern.
    """

    def __init__(self, sparsity_config: Optional[sc.SparsityConfig] = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul",
                 max_seq_length: int = 2048,
                 heads: Optional[Tuple[int, int]] = None):
        self.sparsity_config = (sparsity_config
                                or sc.FixedSparsityConfig(num_heads=4))
        all_heads = self.sparsity_config.num_heads
        self.heads = tuple(heads) if heads is not None else (0, all_heads)
        if not 0 <= self.heads[0] < self.heads[1] <= all_heads:
            raise ValueError(f"heads {self.heads} outside the layout's "
                             f"{all_heads}")
        if key_padding_mask_mode not in ("add", "mul"):
            raise ValueError("key_padding_mask_mode must be 'add' or 'mul'")
        if attn_mask_mode not in ("add", "mul"):
            raise ValueError("attn_mask_mode must be 'add' or 'mul'")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        self._mask_cache = {}
        self._layout_cache = {}

    def _layout(self, seq_len: int) -> np.ndarray:
        """Block layout drawn ONCE per seq_len at all heads, and this
        instance's rows of it: the random modes advance a stateful
        generator in ``make_layout``, so a shared instance must not redraw
        per call — the kernel path, the masked path and every layer see
        one pattern."""
        if seq_len not in self._layout_cache:
            start, stop = self.heads
            self._layout_cache[seq_len] = np.ascontiguousarray(
                self.sparsity_config.make_layout(seq_len)[start:stop])
        return self._layout_cache[seq_len]

    def _layout_mask(self, seq_len: int, device) -> torch.Tensor:
        """``[H, S, S]`` bool token mask of the layout, cached per device."""
        key = (seq_len, str(device))
        if key not in self._mask_cache:
            mask = self.sparsity_config.expand_mask(self._layout(seq_len),
                                                    seq_len)
            self._mask_cache[key] = torch.from_numpy(mask).to(device)
        return self._mask_cache[key]

    def _use_kernel(self, rpe, key_padding_mask, attn_mask) -> bool:
        """The block-sparse kernel serves the pure-layout case; rpe and
        runtime masks take the masked plain attention."""
        if rpe is not None or key_padding_mask is not None \
                or attn_mask is not None:
            return False
        return self.sparsity_config.block >= KERNEL_MIN_BLOCK

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None):
        S = query.shape[2]
        if S > self.max_seq_length:
            raise ValueError(f"seq len {S} exceeds max_seq_length "
                             f"{self.max_seq_length}")
        if S % self.sparsity_config.block:
            raise ValueError(
                f"seq len {S} must be divisible by block "
                f"{self.sparsity_config.block} (use "
                f"SparseAttentionUtils.pad_to_block_size)")
        if self._use_kernel(rpe, key_padding_mask, attn_mask):
            return block_sparse_attention(query, key, value,
                                          self._layout(S))
        mask = self._layout_mask(S, query.device)[None]  # [1, H, S, S]
        if attn_mask is not None:
            keep = _keep(attn_mask, self.attn_mask_mode).to(query.device)
            while keep.dim() < 4:
                keep = keep[None]
            mask = mask & keep
        if key_padding_mask is not None:
            keep = _keep(key_padding_mask,
                         self.key_padding_mask_mode).to(query.device)
            mask = mask & keep[:, None, None, :]
        # a relative position bias folds into the logits
        return attention_reference(
            query, key, value, mask=mask, causal=False,
            bias=None if rpe is None else torch.as_tensor(
                rpe, device=query.device))


_MODES = {sc.DenseSparsityConfig: "dense", sc.FixedSparsityConfig: "fixed",
          sc.VariableSparsityConfig: "variable",
          sc.BigBirdSparsityConfig: "bigbird",
          sc.BSLongformerSparsityConfig: "bslongformer",
          sc.LocalSlidingWindowSparsityConfig: "local"}


def _config_section(sparsity_config):
    """A ``SparsityConfig`` instance → its config-section dict: only the
    ``__init__`` parameters round-trip. An instance whose generator has
    drawn already (or is not the default one) is refused: the model
    config carries a dict, and the layout would be redrawn from the
    default seed."""
    cls = type(sparsity_config)
    if cls not in _MODES:
        raise ValueError(
            f"unsupported sparsity_config type {cls.__name__}; pass a "
            "config-section dict or one of the registry classes "
            f"({sorted(m.__name__ for m in _MODES)})")
    attrs = vars(sparsity_config)
    rng = attrs.get("_rng")
    if rng is not None and rng.bit_generator.state != \
            np.random.default_rng(0).bit_generator.state:
        raise ValueError(
            "sparsity_config instances with a custom rng cannot be carried "
            "through the model config (the layout would be redrawn from "
            "the default seed); pass a config dict and rely on the default "
            "deterministic rng, or patch before drawing from the generator")
    params = [p for p in inspect.signature(cls.__init__).parameters
              if p not in ("self", "num_heads", "rng")]
    return {"mode": _MODES[cls], **{p: attrs[p] for p in params
                                    if p in attrs}}


class SparseAttentionUtils:
    """HF-model patching helpers (reference ``sparse_attention_utils.py``)."""

    @staticmethod
    def pad_to_block_size(block_size: int, input_ids=None,
                          attention_mask=None, token_type_ids=None,
                          position_ids=None, inputs_embeds=None,
                          pad_token_id: int = 0, model_embeddings=None):
        """Right-pad token inputs so seq_len % block == 0. Returns
        ``(pad_len, input_ids, attention_mask, token_type_ids,
        position_ids, inputs_embeds)`` — reference signature kept."""
        ref = input_ids if input_ids is not None else inputs_embeds
        if ref is None:
            raise ValueError("provide input_ids or inputs_embeds")
        pad_len = (-ref.shape[1]) % block_size
        if pad_len == 0:
            return (0, input_ids, attention_mask, token_type_ids,
                    position_ids, inputs_embeds)

        def pad_tokens(x, value=0):
            return None if x is None else F.pad(x, (0, pad_len), value=value)

        input_ids = pad_tokens(input_ids, pad_token_id)
        attention_mask = pad_tokens(attention_mask, 0)
        token_type_ids = pad_tokens(token_type_ids, 0)
        if position_ids is not None:
            extra = position_ids[:, -1:] + torch.arange(
                1, pad_len + 1, device=position_ids.device)[None]
            position_ids = torch.cat([position_ids, extra], dim=1)
        if inputs_embeds is not None:
            if model_embeddings is None:
                raise ValueError(
                    "padding inputs_embeds requires model_embeddings")
            pad_ids = torch.full((inputs_embeds.shape[0], pad_len),
                                 pad_token_id, dtype=torch.long,
                                 device=inputs_embeds.device)
            inputs_embeds = torch.cat(
                [inputs_embeds, model_embeddings(pad_ids)], dim=1)
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        """Reference ``unpad_sequence_output``."""
        return sequence_output[:, :-pad_len] if pad_len else sequence_output

    @staticmethod
    def extend_position_embedding(position_embedding, max_position: int):
        """Tile an existing position table to a longer window (reference
        ``extend_position_embedding``): repeats the learned table."""
        pe = torch.as_tensor(position_embedding)
        orig = pe.shape[0]
        if max_position <= orig:
            return pe[:max_position]
        return pe.repeat(-(-max_position // orig), 1)[:max_position]

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            model, max_position, sparsity_config=None):
        """Patch a model onto block-sparse self-attention with a longer
        position window (reference ``sparse_attention_utils.py``
        ``replace_model_self_attention_with_sparse_self_attention``).

        The port's models carry a frozen config, as the JAX ones do: the
        patch builds the same model type on a config with
        ``sparse_attention`` and ``max_position_embeddings`` set, holding
        ``model``'s parameters, with every position table retiled to
        ``max_position`` (:meth:`extend_position_embedding`). Supports any
        model whose config has a ``sparse_attention`` field (the BERT
        family, ``models/bert.py``).

        ``sparsity_config``: a config-section dict (``{"mode": "bigbird",
        "block": 16, ...}``) or a ``SparsityConfig`` instance; default
        fixed mode. Returns the patched model (the JAX helper also returns
        the retiled params tree: here the model holds them).
        """
        cfg = getattr(model, "config", None)
        if cfg is None or not dataclasses.is_dataclass(cfg) or not any(
                f.name == "sparse_attention"
                for f in dataclasses.fields(cfg)):
            raise ValueError(
                "model's config has no sparse_attention field; supported "
                "today: the BERT family (models/bert.py). To extend: add a "
                "sparse_attention config field and route the model's "
                "attention through SparseSelfAttention like "
                "BertSelfAttention does")
        if sparsity_config is None:
            sparsity_config = {"mode": "fixed"}
        if not isinstance(sparsity_config, dict):
            sparsity_config = _config_section(sparsity_config)
        new_cfg = dataclasses.replace(
            cfg, sparse_attention=dict(sparsity_config),
            max_position_embeddings=int(max_position))
        with torch.no_grad():
            state = {
                name: (SparseAttentionUtils.extend_position_embedding(
                    t, int(max_position)).clone()
                    if "position_embedding" in name else t)
                for name, t in model.state_dict(keep_vars=True).items()}
        patched = type(model)(new_cfg, device="meta")
        patched.load_state_dict(state, assign=True)
        return patched
