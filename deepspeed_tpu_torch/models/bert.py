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

Tensor parallelism (:meth:`BertForTraining.with_tensor_parallel`, which
the training engine calls on a ``tp`` mesh; the slices of
:meth:`BertForMaskedLM.tp_specs`, the policy's specs): ``query`` /
``key`` / ``value`` column-parallel, so a rank attends its ``H / tp``
heads (the block-sparse layout's rows of those heads, drawn at all ``H``);
``output_dense`` and ``output`` row-parallel (g's all-reduce) and
``intermediate`` column-parallel where the spec splits them. Where split
heads or columns feed a projection the spec leaves whole (the ``"auto"``
policy splits only q/k/v), their outputs are all-gathered
(``gather_from_tp``) before it, and the rest of the layer runs whole on
every rank. A split ``word_embeddings`` is looked up masked and its fp32
rows all-reduced before the fp32 sum, so the sum rounds as at tp 1; the
MLM head runs the tied decoder on the rank's vocabulary (f before it),
adds the rank's slice of ``decoder_bias`` (its gradient all-gathered, so
every rank holds the whole one, as the replicated parameter's spec says)
and takes the vocab-parallel cross-entropy. Where the heads do not divide
by tp, attention (q/k/v and ``output_dense``) stays whole on every rank,
as GPT-2's does. ``partition_activations`` keeps ``T / tp`` rows of each
saved layer input (``models/remat_utils.py``); the padding mask passes
whole. :meth:`BertForTraining.comm_plan` counts the collectives.

Dropout and host-offloaded checkpoints (``cpu_checkpointing``) come with
later slices and raise.
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
from deepspeed_tpu_torch.module_inject.layers import (ColumnParallelLinear,
                                                      RowParallelLinear,
                                                      TensorParallel,
                                                      column_projections,
                                                      copy_to_tp,
                                                      gather_from_tp,
                                                      scatter_to_tp,
                                                      vocab_parallel_lookup)
from deepspeed_tpu_torch.module_inject.policies import get_tp_policy
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
    # the JAX tree's layer layout in checkpoints (stacked under
    # bert/encoder/layers/layer, else one layer_<i> each): the port's
    # encoder loops over its layers either way
    scan_layers: bool = True
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
                 "the offload slice")):
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
def _sparse_attn_for(frozen_cfg, num_heads: int, max_seq: int,
                     heads=None):
    """One SparseSelfAttention per (config, heads, window, head range):
    every layer of a model shares it, so a random layout is drawn once and
    is the same in all layers, and its lists and masks are built once;
    ``heads`` ``(start, stop)``: a tensor-parallel rank's rows of the
    layout drawn at all ``num_heads``."""
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
                               max_seq_length=max_seq, heads=heads)


def _linear(in_features, out_features, tp, parallel, device):
    """A projection with its bias: whole, or this rank's column / row
    slice (``parallel``) under ``tp``."""
    if tp is None:
        return nn.Linear(in_features, out_features, device=device)
    return parallel(in_features, out_features, tp, device=device)


def _into(layer, x, dtype, split):
    """``x`` through ``layer`` in ``dtype``; ``split``: the tp group
    whose rank holds only its feature slice of ``x`` (None: ``x`` is
    whole). A row-parallel layer takes that slice; a whole layer gets
    ``x`` gathered first (split heads or columns before a projection the
    spec leaves whole)."""
    if split is not None and not isinstance(layer, RowParallelLinear):
        x = gather_from_tp(x, split.group, dim=-1)
    return _dense(layer, x, dtype)


class BertSelfAttention(nn.Module):
    """Bidirectional self-attention over ``H`` heads, or under a tensor-
    parallel ``tp`` that splits ``query`` / ``key`` / ``value`` by
    columns over this rank's ``H / tp``."""

    def __init__(self, config: BertConfig, device=None, tp=None):
        super().__init__()
        self.config = config
        C = config.hidden_size
        self.tp = tp
        self.n_head = config.num_attention_heads // (tp.size if tp else 1)
        self.query, self.key, self.value = (
            _linear(C, C, tp, ColumnParallelLinear, device)
            for _ in range(3))

    def forward(self, x, mask=None):
        cfg = self.config
        B, T, _ = x.shape
        H, D = self.n_head, cfg.head_dim
        # [B, H, T, D] views of the [B, T, H * D] projections: the kernels
        # read them through their strides, and write O in the same layout
        q, k, v = (y.view(B, T, H, D).transpose(1, 2)
                   for y in column_projections(
                       (self.query, self.key, self.value), x, cfg.dtype))
        if cfg.sparse_attention is not None:
            # block-sparse encoder attention on this rank's heads; padding
            # becomes a multiplicative key mask
            first = self.tp.rank * H if self.tp is not None else 0
            sp = _sparse_attn_for(cfg.sparse_attention,
                                  cfg.num_attention_heads,
                                  cfg.max_position_embeddings,
                                  heads=(first, first + H))
            y = sp(q, k, v, key_padding_mask=None if mask is None
                   else mask.float())
        else:
            # bidirectional; a padding mask [B, T] becomes a [B, 1, 1, T]
            # keep-mask and takes the plain attention
            mask4 = None if mask is None else mask[:, None, None, :].bool()
            y = attention(q, k, v, mask=mask4, causal=False)
        return y.transpose(1, 2).reshape(B, T, H * D)


class BertAttention(nn.Module):
    """Self-attention, the output projection (row-parallel under a
    ``proj_tp``) and the post-LN of the residual sum."""

    def __init__(self, config: BertConfig, device=None, tp=None,
                 proj_tp=None):
        super().__init__()
        self.config = config
        C = config.hidden_size
        self.self = BertSelfAttention(config, device=device, tp=tp)
        self.output_dense = _linear(C, C, proj_tp, RowParallelLinear, device)
        self.output_ln = nn.LayerNorm(C, eps=config.layer_norm_eps,
                                      device=device)

    def forward(self, x, mask=None):
        dt = self.config.dtype
        y = _into(self.output_dense, self.self(x, mask), dt, self.self.tp)
        # post-LN (original transformer): normalize the residual SUM
        return _layer_norm(self.output_ln, x + y, dt)


class BertLayer(nn.Module):
    """Attention, then the exact-GELU MLP and the post-LN; each ``*_tp``
    the tp group that splits that projection (None: whole)."""

    def __init__(self, config: BertConfig, device=None, attn_tp=None,
                 proj_tp=None, in_tp=None, out_tp=None):
        super().__init__()
        self.config = config
        C, inner = config.hidden_size, config.intermediate_size
        self.attention = BertAttention(config, device=device, tp=attn_tp,
                                       proj_tp=proj_tp)
        self.intermediate = _linear(C, inner, in_tp, ColumnParallelLinear,
                                    device)
        self.output = _linear(inner, C, out_tp, RowParallelLinear, device)
        self.output_ln = nn.LayerNorm(C, eps=config.layer_norm_eps,
                                      device=device)
        self.in_tp = in_tp

    def forward(self, x, mask=None):
        dt = self.config.dtype
        x = self.attention(x, mask)
        h = F.gelu(_dense(self.intermediate, x, dt), approximate="none")
        return _layer_norm(self.output_ln,
                           x + _into(self.output, h, dt, self.in_tp), dt)


def _split_by(tp, name: str, dim: int):
    """``tp`` where its specs split parameter ``name`` on ``dim``, else
    None."""
    return tp if tp is not None and tp.split(name) == dim else None


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig, device=None, tp=None):
        super().__init__()
        self.config = config
        self.tp = tp

        def layer(i):
            p = f"bert.encoder.layers.{i}."
            return BertLayer(
                config, device=device,
                attn_tp=_split_by(tp, p + "attention.self.query.weight", 0),
                proj_tp=_split_by(tp, p + "attention.output_dense.weight",
                                  1),
                in_tp=_split_by(tp, p + "intermediate.weight", 0),
                out_tp=_split_by(tp, p + "output.weight", 1))

        self.layers = nn.ModuleList(layer(i)
                                    for i in range(config.num_hidden_layers))

    def forward(self, x, mask=None):
        cfg = self.config
        remat = cfg.remat and torch.is_grad_enabled()
        partition = (self.tp if cfg.partition_activations and self.tp
                     and self.tp.size > 1 else None)
        for layer in self.layers:
            x = (checkpointed(layer, x, mask, policy=cfg.remat_policy,
                              partition=partition)
                 if remat else layer(x, mask))
        return x


class BertModel(nn.Module):
    """Embeddings → encoder stack; returns the final hidden states (the
    word-embedding table ``word_embeddings`` ties the MLM head).
    ``tp``: the tensor-parallel slice of a :class:`BertForMaskedLM`
    (its specs name the whole model's parameters)."""

    def __init__(self, config: BertConfig, device=None, tp=None):
        super().__init__()
        self.config = config
        C = config.hidden_size
        self.vocab_tp = _split_by(tp, "bert.word_embeddings", 0)
        vocab = config.vocab_size // (self.vocab_tp.size if self.vocab_tp
                                      else 1)
        self.word_embeddings = nn.Parameter(torch.empty(vocab, C,
                                                        device=device))
        self.position_embeddings = nn.Parameter(
            torch.empty(config.max_position_embeddings, C, device=device))
        self.token_type_embeddings = nn.Parameter(
            torch.empty(config.type_vocab_size, C, device=device))
        self.embeddings_ln = nn.LayerNorm(C, eps=config.layer_norm_eps,
                                          device=device)
        self.encoder = BertEncoder(config, device=device, tp=tp)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        cfg = self.config
        T = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        # the word rows in fp32, summed over a split vocabulary before the
        # fp32 sum rounds once, as at tp 1
        x = (vocab_parallel_lookup(self.word_embeddings, input_ids,
                                   self.vocab_tp)
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
    ``device="meta"`` builds the structure without weights. ``tp`` (a
    :class:`~deepspeed_tpu_torch.module_inject.layers.TensorParallel`
    whose ``specs`` are :meth:`tp_specs`') builds this rank's
    tensor-parallel slice; it takes its weights from ``load_state_dict``,
    not from ``seed``."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0,
                 tp=None):
        super().__init__()
        self.config = config
        self.tp = tp
        C = config.hidden_size
        self.bert = BertModel(config, device=device, tp=tp)
        self.vocab_tp = self.bert.vocab_tp
        self.transform = nn.Linear(C, C, device=device)
        self.transform_ln = nn.LayerNorm(C, eps=config.layer_norm_eps,
                                         device=device)
        # replicated, as the JAX specs have it: a rank adds its slice
        self.decoder_bias = nn.Parameter(torch.empty(config.vocab_size,
                                                     device=device))
        if torch.device(device or "cpu").type != "meta" and tp is None:
            _init_weights(self, torch.Generator().manual_seed(seed))

    def tp_specs(self, policy, tp_size: int) -> dict:
        """``{name: PartitionSpec or None}`` of the whole model's
        parameters at ``tp_size`` tp ranks under ``policy`` (a name, a
        ``TPPolicy`` or the reference's injection forms): the policy's
        ``spec_for`` (the JAX engine's ``specs_from_policy`` in the port's
        dim order), except that ``query`` / ``key`` / ``value`` split
        only together and only where the heads divide by ``tp_size``
        (else they and ``output_dense`` stay whole), a row-parallel
        projection splits only after its split column partner, the word
        table only on its vocab dim, and nothing else splits."""
        policy = get_tp_policy(policy)
        specs = {name: policy.spec_for(name, tuple(p.shape), tp_size)
                 for name, p in self.named_parameters()}

        def splits(name, dim):
            spec = specs.get(name)
            return spec is not None and spec[dim] is not None

        keep = set()
        heads = self.config.num_attention_heads % tp_size == 0
        for i in range(self.config.num_hidden_layers):
            p = f"bert.encoder.layers.{i}."
            for cols, row, ok in (
                    ([f"attention.self.{n}" for n in ("query", "key",
                                                      "value")],
                     "attention.output_dense", heads),
                    (["intermediate"], "output", True)):
                names = [p + f"{c}.{w}" for c in cols
                         for w in ("weight", "bias")]
                if ok and all(splits(n, 0) for n in names):
                    keep.update(names)
                    if splits(p + row + ".weight", 1):
                        keep.add(p + row + ".weight")
        if splits("bert.word_embeddings", 0):
            keep.add("bert.word_embeddings")
        return {n: spec if n in keep else None for n, spec in specs.items()}

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        """fp32 logits ``[B, T, vocab]``."""
        return self.head(self.bert(input_ids, attention_mask,
                                   token_type_ids))

    def head(self, hidden):
        """fp32 logits of the final hidden states (under a split
        vocabulary every rank's :meth:`local_logits` all-gathered)."""
        logits = self.local_logits(hidden)
        if self.vocab_tp is None:
            return logits
        return gather_from_tp(logits, self.vocab_tp.group, dim=-1)

    def local_logits(self, hidden):
        """fp32 logits of the final hidden states over this rank's
        vocabulary: transform, exact GELU, LayerNorm, the tied decoder
        (compute-dtype products summed in fp32) and the fp32 bias. Under a
        split vocabulary f sits before the decoder and the bias is this
        rank's slice (:func:`~deepspeed_tpu_torch.module_inject.layers.
        scatter_to_tp`)."""
        dt = self.config.dtype
        x = F.gelu(_dense(self.transform, hidden, dt), approximate="none")
        x = _layer_norm(self.transform_ln, x, dt)
        if self.vocab_tp is None:
            return head_logits(x, self.bert.word_embeddings) \
                + self.decoder_bias
        x = copy_to_tp(x, self.vocab_tp.group)
        return (head_logits(x, self.bert.word_embeddings)
                + scatter_to_tp(self.decoder_bias, self.vocab_tp))


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
    != -100 (no shift: BERT predicts in place); vocab-parallel where
    ``model`` splits its vocabulary."""

    def loss_fn(batch):
        ids, labels, mask, tt = _batch_fields(batch)
        return cross_entropy_loss(
            model.local_logits(model.bert(ids, mask, tt)), labels,
            tp=model.vocab_tp)

    return loss_fn


class BertForTraining(nn.Module):
    """Engine-ready BERT MLM: ``initialize(model=BertForTraining(cfg))``;
    ``forward(batch)`` returns the mean masked-token loss. Weights as in
    :class:`BertForMaskedLM` (``seed``, ``device="meta"`` for none);
    ``tp``: this rank's tensor-parallel slice (weights from
    :meth:`with_tensor_parallel`)."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        self.config = config
        self.model = BertForMaskedLM(config, device=device, seed=seed, tp=tp)
        self.loss_fn = mlm_loss_fn(self.model)

    def forward(self, batch):
        return self.loss_fn(batch)

    @property
    def tp(self) -> Optional[TensorParallel]:
        return self.model.tp

    @staticmethod
    def loss_tokens(batch):
        """The tokens the loss of ``batch`` averages over (labels !=
        -100), for the engine's mean over ranks that hold different
        counts of them."""
        if isinstance(batch, dict):
            labels = batch.get("labels", batch["input_ids"])
        else:
            labels = batch[1]
        return (torch.as_tensor(labels) != -100).sum()

    def with_tensor_parallel(self, tp: TensorParallel, policy="auto"):
        """This rank's tensor-parallel slice of this whole model (on its
        device): the slices :meth:`BertForMaskedLM.tp_specs` gives under
        ``policy`` at ``tp.size`` ranks, copied from this model's
        weights."""
        from deepspeed_tpu_torch.module_inject.policies import \
            shard_params_with_policy

        if self.tp is not None:
            raise ValueError("the model is a tensor-parallel slice already")
        specs = self.model.tp_specs(policy, tp.size)
        local, _ = shard_params_with_policy(self.model.state_dict(), policy,
                                            tp.rank, tp.size, specs=specs)
        sliced = BertForTraining(
            self.config, device=self.model.bert.word_embeddings.device,
            tp=dataclasses.replace(tp, specs=specs))
        sliced.model.load_state_dict(local)
        return sliced

    def param_specs(self) -> dict:
        """``{parameter name: tp PartitionSpec or None}`` in the port's
        dim order, for SpecLayout."""
        specs = self.tp.specs if self.tp is not None else {}
        return {name: specs.get(name[len("model."):])
                for name, _ in self.named_parameters()}

    def comm_plan(self, rows: int, seq: int) -> dict:
        """The tensor-parallel collectives of one micro-step (forward and
        backward) on ``rows`` x ``seq`` tokens a rank. A layer's split
        heads and split MLP columns each take f's all-reduce in backward,
        and each hands its output on through g's all-reduce (a split row
        partner) or an all-gather (a whole one) forward; under ``"full"``
        remat the recompute issues those forward collectives again (the
        post-LN needs the residual sum, so it runs to the layer's end;
        ``"dots"`` saves their outputs). A split vocabulary: the lookup's
        all-reduce, f before the decoder, the loss's pair, and the
        bias gradient's all-gather. Under ``partition_activations`` one
        all-gather a layer where ``seq`` divides. Empty at tp 1."""
        tp, cfg = self.tp, self.config
        if tp is None or tp.size == 1:
            return {}
        counts = {"all_reduce": 0, "all_gather": 0}
        again = int(cfg.remat and cfg.remat_policy == "full")
        for layer in self.model.bert.encoder.layers:
            for column, row in ((layer.attention.self.query,
                                 layer.attention.output_dense),
                                (layer.intermediate, layer.output)):
                if not isinstance(column, ColumnParallelLinear):
                    continue
                counts["all_reduce"] += 1
                out = ("all_reduce" if isinstance(row, RowParallelLinear)
                       else "all_gather")
                counts[out] += 1 + again
        if cfg.remat and cfg.partition_activations and seq % tp.size == 0:
            counts["all_gather"] += cfg.num_hidden_layers
        if self.model.vocab_tp is not None:
            counts["all_reduce"] += 4  # lookup, f, the loss's pair
            counts["all_gather"] += 1  # decoder_bias's gradient
        return counts

    def _with_config(self, config: BertConfig) -> "BertForTraining":
        """The same model on ``config``, holding THIS model's parameter
        tensors (no copy), its tensor-parallel slice and any ZeRO shards
        included: the engine's hooks run after the weights exist, unlike
        the JAX engine's, which run before ``init``."""
        new = BertForTraining(config, device="meta", tp=self.tp)
        for name, p in self.named_parameters():
            owner, _, attr = name.rpartition(".")
            setattr(new.get_submodule(owner), attr, p)
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
