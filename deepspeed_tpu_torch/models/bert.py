"""The BERT encoder family on the card (counterpart of
``deepspeed_tpu/models/bert.py``).

Post-LN encoder layers (LayerNorm of the residual sum, eps 1e-12, exact
GELU) whose self-attention routes by the config: with a
``sparse_attention`` section through one :class:`~deepspeed_tpu_torch.
ops.sparse_attention.SparseSelfAttention` shared by every layer of the
model (the block-sparse kernels on the card for the pure-layout case),
otherwise through ``ops.attention.attention`` (the non-causal flash
kernels without a padding mask, the plain masked attention with one).
Module names mirror the JAX model's (``attention.self.query``,
``attention.output_dense``, ``intermediate``, ``output``) so its weights
convert one for one (``utils/params.py``).

Parameters are fp32 (the masters); products run in the config's compute
dtype, as in ``models/gpt2.py``. The word, position and token-type tables
are summed in fp32 and cast once; the MLM head's logits are fp32 plus the
fp32 decoder bias.

Dropout, host-offloaded checkpoints (``cpu_checkpointing``) and
``partition_activations`` come with later slices and raise.
"""

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.gpt2 import (_dense, _layer_norm,
                                             cross_entropy_loss, head_logits)
from deepspeed_tpu_torch.models.remat_utils import (REMAT_POLICIES,
                                                    checkpointed)
from deepspeed_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16  # compute/activation dtype
    # per-layer activation checkpointing: "full" recomputes the layer in
    # backward, "dots" saves matmul and attention-kernel outputs
    # (models/remat_utils.py)
    remat: bool = False
    remat_policy: str = "full"
    cpu_checkpointing: bool = False
    partition_activations: bool = False
    # ds-config "sparse_attention" section (mode/block/...): the encoder
    # attends through the block-sparse layout zoo instead of densely.
    # Accepts a dict; stored as a sorted item tuple so the frozen config
    # stays hashable
    sparse_attention: Optional[Any] = None

    def __post_init__(self):
        if isinstance(self.sparse_attention, dict):
            def freeze(v):  # JSON configs carry lists (e.g. block indices)
                if isinstance(v, (list, tuple)):
                    return tuple(freeze(x) for x in v)
                return v

            object.__setattr__(
                self, "sparse_attention",
                tuple(sorted((k, freeze(v))
                             for k, v in self.sparse_attention.items())))
        for knob, value, where in (
                ("dropout > 0", self.dropout > 0,
                 "the training-features slice"),
                ("cpu_checkpointing", self.cpu_checkpointing,
                 "the offload slice"),
                ("partition_activations", self.partition_activations,
                 "the rest of the tensor-parallel training slice ([7d])")):
            if value:
                raise NotImplementedError(
                    f"BertConfig.{knob} is not ported yet: it comes with "
                    f"{where} of the PyTorch port")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} not in "
                             f"{REMAT_POLICIES}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def bert_large(**kw):
        return BertConfig(hidden_size=1024, num_hidden_layers=24,
                          num_attention_heads=16, intermediate_size=4096,
                          **kw)

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 64)
        return BertConfig(**kw)


@functools.lru_cache(maxsize=16)
def _sparse_attn_for(frozen_cfg, num_heads: int, max_seq: int):
    """One SparseSelfAttention per (config, heads, window): every layer of
    a model shares it, so a random layout is drawn once and is the same in
    all layers, and its lists and masks are built once."""
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import SparseSelfAttention
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
        sparsity_config_from_dict)

    d = dict(frozen_cfg)
    if d.get("mode", "fixed") != "dense":
        # an ENCODER must see rightward context: "local" defaults to
        # unidirectional, which would silently break BERT
        d.setdefault("attention", "bidirectional")
    return SparseSelfAttention(sparsity_config_from_dict(d, num_heads),
                               key_padding_mask_mode="mul",
                               max_seq_length=max_seq)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        C = config.hidden_size
        self.query = nn.Linear(C, C, device=device)
        self.key = nn.Linear(C, C, device=device)
        self.value = nn.Linear(C, C, device=device)

    def forward(self, x, mask=None):
        cfg = self.config
        B, T, C = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        # [B, H, T, D] views of the [B, T, C] projections: the kernels read
        # them through their strides, and write O in the same layout
        q, k, v = (_dense(lin, x, cfg.dtype).view(B, T, H, D).transpose(1, 2)
                   for lin in (self.query, self.key, self.value))
        if cfg.sparse_attention is not None:
            # block-sparse encoder attention; padding becomes a
            # multiplicative key mask
            sp = _sparse_attn_for(cfg.sparse_attention, H,
                                  cfg.max_position_embeddings)
            y = sp(q, k, v, key_padding_mask=None if mask is None
                   else mask.float())
        else:
            # bidirectional; a padding mask [B, T] becomes a [B, 1, 1, T]
            # keep-mask and takes the plain attention
            mask4 = None if mask is None else mask[:, None, None, :].bool()
            y = attention(q, k, v, mask=mask4, causal=False)
        return y.transpose(1, 2).reshape(B, T, C)


class BertAttention(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        C = config.hidden_size
        self.self = BertSelfAttention(config, device=device)
        self.output_dense = nn.Linear(C, C, device=device)
        self.output_ln = nn.LayerNorm(C, eps=config.layer_norm_eps,
                                      device=device)

    def forward(self, x, mask=None):
        dt = self.config.dtype
        y = _dense(self.output_dense, self.self(x, mask), dt)
        # post-LN (original transformer): normalize the residual SUM
        return _layer_norm(self.output_ln, x + y, dt)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        C, inner = config.hidden_size, config.intermediate_size
        self.attention = BertAttention(config, device=device)
        self.intermediate = nn.Linear(C, inner, device=device)
        self.output = nn.Linear(inner, C, device=device)
        self.output_ln = nn.LayerNorm(C, eps=config.layer_norm_eps,
                                      device=device)

    def forward(self, x, mask=None):
        dt = self.config.dtype
        x = self.attention(x, mask)
        h = F.gelu(_dense(self.intermediate, x, dt), approximate="none")
        return _layer_norm(self.output_ln, x + _dense(self.output, h, dt), dt)


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(BertLayer(config, device=device)
                                    for _ in range(config.num_hidden_layers))

    def forward(self, x, mask=None):
        cfg = self.config
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = (checkpointed(layer, x, mask, policy=cfg.remat_policy)
                 if remat else layer(x, mask))
        return x


class BertModel(nn.Module):
    """Embeddings → encoder stack; returns the final hidden states (the
    word-embedding table ``word_embeddings`` ties the MLM head)."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        C = config.hidden_size
        self.word_embeddings = nn.Parameter(
            torch.empty(config.vocab_size, C, device=device))
        self.position_embeddings = nn.Parameter(
            torch.empty(config.max_position_embeddings, C, device=device))
        self.token_type_embeddings = nn.Parameter(
            torch.empty(config.type_vocab_size, C, device=device))
        self.embeddings_ln = nn.LayerNorm(C, eps=config.layer_norm_eps,
                                          device=device)
        self.encoder = BertEncoder(config, device=device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        cfg = self.config
        T = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings[input_ids]
             + self.position_embeddings[None, :T]
             + self.token_type_embeddings[token_type_ids]).to(cfg.dtype)
        x = _layer_norm(self.embeddings_ln, x, cfg.dtype)
        return self.encoder(x, attention_mask)


def _init_weights(module: nn.Module, generator: torch.Generator):
    """The JAX model's initializers: normal(0.02) tables and dense
    kernels, zero biases (``decoder_bias`` included), unit LayerNorms."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("_ln.weight"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)


class BertForMaskedLM(nn.Module):
    """MLM head: transform (dense + GELU + LN) → tied decoder + bias (HF
    ``cls.predictions``). ``BertForMaskedLM(config, seed=0)`` draws its
    weights on the CPU from a ``torch.Generator`` seeded with ``seed``;
    ``device="meta"`` builds the structure without weights."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        C = config.hidden_size
        self.bert = BertModel(config, device=device)
        self.transform = nn.Linear(C, C, device=device)
        self.transform_ln = nn.LayerNorm(C, eps=config.layer_norm_eps,
                                         device=device)
        self.decoder_bias = nn.Parameter(torch.empty(config.vocab_size,
                                                     device=device))
        if torch.device(device or "cpu").type != "meta":
            _init_weights(self, torch.Generator().manual_seed(seed))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        """fp32 logits ``[B, T, vocab]``."""
        return self.head(self.bert(input_ids, attention_mask,
                                   token_type_ids))

    def head(self, hidden):
        """fp32 logits of the final hidden states: transform, exact GELU,
        LayerNorm, the tied decoder (compute-dtype products summed in
        fp32) and the fp32 bias."""
        dt = self.config.dtype
        x = F.gelu(_dense(self.transform, hidden, dt), approximate="none")
        x = _layer_norm(self.transform_ln, x, dt)
        return head_logits(x, self.bert.word_embeddings) + self.decoder_bias


class BertForSequenceClassification(nn.Module):
    """Pooler (first-token tanh dense) → fp32 classifier (HF
    ``BertForSequenceClassification``). Weights as in
    :class:`BertForMaskedLM`."""

    def __init__(self, config: BertConfig, num_labels: int = 2, device=None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        self.num_labels = num_labels
        C = config.hidden_size
        self.bert = BertModel(config, device=device)
        self.pooler = nn.Linear(C, C, device=device)
        self.classifier = nn.Linear(C, num_labels, device=device)
        if torch.device(device or "cpu").type != "meta":
            _init_weights(self, torch.Generator().manual_seed(seed))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        x = self.bert(input_ids, attention_mask, token_type_ids)
        pooled = torch.tanh(_dense(self.pooler, x[:, 0], self.config.dtype))
        return F.linear(pooled.float(), self.classifier.weight,
                        self.classifier.bias)


def _batch_fields(batch):
    """``(input_ids, labels, attention_mask, token_type_ids)`` of a dict
    batch (labels default to the ids) or an ``(input_ids, labels)`` pair."""
    if isinstance(batch, dict):
        ids = batch["input_ids"]
        labels = batch.get("labels", ids)
        mask, tt = batch.get("attention_mask"), batch.get("token_type_ids")
    else:
        (ids, labels), mask, tt = batch, None, None
    return (ids.long(), labels.long(), mask,
            None if tt is None else tt.long())


def mlm_loss_fn(model: BertForMaskedLM):
    """Engine-facing MLM objective: mean token cross-entropy where labels
    != -100 (no shift: BERT predicts in place)."""

    def loss_fn(batch):
        ids, labels, mask, tt = _batch_fields(batch)
        return cross_entropy_loss(model(ids, mask, tt), labels)

    return loss_fn


class BertForTraining(nn.Module):
    """Engine-ready BERT MLM: ``initialize(model=BertForTraining(cfg))``;
    ``forward(batch)`` returns the mean masked-token loss. Weights as in
    :class:`BertForMaskedLM` (``seed``, ``device="meta"`` for none)."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        self.model = BertForMaskedLM(config, device=device, seed=seed)
        self.loss_fn = mlm_loss_fn(self.model)

    def forward(self, batch):
        return self.loss_fn(batch)

    def _with_config(self, config: BertConfig) -> "BertForTraining":
        """The same model on ``config``, holding THIS model's parameter
        tensors (no copy): the engine's hooks run after the weights exist,
        unlike the JAX engine's, which run before ``init``."""
        new = BertForTraining(config, device="meta")
        new.load_state_dict(self.state_dict(keep_vars=True), assign=True)
        return new

    def with_activation_checkpointing(self, enabled: bool,
                                      policy: str = "full",
                                      cpu_checkpointing: bool = False,
                                      partition_activations: bool = False):
        if policy == "none":
            enabled, policy = False, "full"
        return self._with_config(dataclasses.replace(
            self.config, remat=enabled, remat_policy=policy,
            cpu_checkpointing=cpu_checkpointing,
            partition_activations=partition_activations))

    def with_sparse_attention(self, sparse_config):
        """Engine hook: the ds-config ``sparse_attention`` section swaps
        the encoder onto the block-sparse layout zoo, keeping the
        weights."""
        return self._with_config(dataclasses.replace(
            self.config, sparse_attention=sparse_config))


__all__ = ["BertConfig", "BertModel", "BertForMaskedLM",
           "BertForSequenceClassification", "BertForTraining", "BertLayer",
           "BertAttention", "BertSelfAttention", "BertEncoder",
           "mlm_loss_fn"]
