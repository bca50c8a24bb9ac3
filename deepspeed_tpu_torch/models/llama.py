"""Llama on the card (counterpart of ``deepspeed_tpu/models/llama.py``).

The Llama family: RMSNorm, rotary position embeddings (HF's half-split
convention), grouped-query attention, the SwiGLU MLP, no biases, and a
tied or separate LM head. The inference paths of the JAX model (the
causal forward and the append-cache decode of ``generate()``, left-padded
batches included) and its training path (:class:`LlamaForTraining`, the
LM-head cross-entropy with the dense/chunked switch and per-block
activation checkpointing) run here as in ``models/gpt2.py``:

- a prefill and the training forward go through
  ``ops/attention.py:attention`` on ``[B, T, H, D]`` views: the flash
  forward kernel, and in training its two backward kernels; a left-padded
  prefill (``attention_mask``) takes the plain masked attention, as the
  JAX model does;
- a decode step writes its keys and values into the ``[B, S, KV, D]``
  append cache (the JAX model's ``cached_key``) and runs the append
  decode kernel on the cache with its KV heads repeated to the query
  heads, as JAX's ``jnp.repeat`` does (query head h reads KV head ``h //
  (H / KV)``): one copy of the whole cache a layer and step when KV < H.
  A left-padded batch's decode steps run the same kernel with each row's
  first key at its pad length, where the JAX model takes its plain masked
  attention (as the port's GPT-2 does).

The serving engine takes the canonical decoder family alone and refuses
a Llama (no ``for_paged_decode``), as the JAX one does.

Parameters are fp32 (the masters, RMSNorm scales included); every
product runs in the config's compute dtype, casting the weights at each
use. RMSNorm and the rotary rotation compute in fp32 from fp32 tables and
cast to the compute dtype afterwards, as the JAX model does.

Tensor parallelism (``LlamaModel(config, tp=TensorParallel(...))``, the
slices of :meth:`LlamaModel.tp_specs`): ``q_proj`` / ``k_proj`` /
``v_proj`` column-parallel and ``o_proj`` row-parallel where both the
query heads and the KV heads divide by tp (else attention stays whole on
every rank), ``gate_proj`` / ``up_proj`` column- and ``down_proj``
row-parallel, and ``embed_tokens`` / ``lm_head`` split over the
vocabulary; one f before each column group (a block's attention and its
MLP) and one g after each row layer, as ``models/gpt2.py``. The
vocab-parallel loss is ``models/gpt2.py:vocab_parallel_nll``.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.decode_utils import (decode_positions,
                                                     pad_lengths,
                                                     row_positions)
from deepspeed_tpu_torch.models.gpt2 import (KVCache, _dense,
                                             _dense_head, _head_budget,
                                             _input_ids_labels, _pair_tp,
                                             head_logits, lm_head_loss,
                                             shift_labels)
from deepspeed_tpu_torch.models.remat_utils import (REMAT_POLICIES,
                                                    checkpointed)
from deepspeed_tpu_torch.module_inject.layers import (ColumnParallelLinear,
                                                      RowParallelLinear,
                                                      TensorParallel,
                                                      column_projections,
                                                      copy_to_tp,
                                                      gather_from_tp,
                                                      vocab_parallel_lookup)
from deepspeed_tpu_torch.module_inject.policies import get_tp_policy
from deepspeed_tpu_torch.ops.attention import attention
from deepspeed_tpu_torch.ops.decode_attention import decode_attention_tp


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_position_embeddings: int = 4096
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # None = MHA; < heads = GQA
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16  # compute/activation dtype
    # accepted for the JAX config's sake, and inert: the port loops over
    # its layers, and a checkpoint's layer axis is read either way
    # (utils/params.py:llama_params_from_jax)
    scan_layers: bool = True
    # training: per-block activation checkpointing (models/remat_utils.py)
    remat: bool = False
    remat_policy: str = "full"
    # host-offloaded saved activations: the offload slice ([12.8])
    cpu_checkpointing: bool = False
    # training under tensor parallelism: each tp rank keeps T / tp rows of
    # the block inputs the checkpoint saves; a no-op at tp = 1
    partition_activations: bool = False
    # None/True: flash attention; False: the plain attention, as the JAX
    # model's attention(use_flash=False)
    use_flash: Optional[bool] = None
    # decode mode: attention reads/writes a KV cache (forward(cache=))
    decode: bool = False
    # padded decode: the batch was prefilled with LEFT-padded prompts
    padded: bool = False

    def __post_init__(self):
        if self.cpu_checkpointing:
            raise NotImplementedError(
                "LlamaConfig.cpu_checkpointing is not ported yet: it comes "
                "with the offload slice ([12.8]) of the PyTorch port")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} not in "
                             f"{REMAT_POLICIES}")
        if self.num_attention_heads % self.kv_heads:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be a "
                f"multiple of num_key_value_heads ({self.kv_heads})")

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def for_decode(self, padded: bool = False):
        return dataclasses.replace(self, decode=True, padded=padded)

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_position_embeddings", 64)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        return LlamaConfig(**kw)


class RMSNorm(nn.Module):
    """Root-mean-square norm (no mean subtraction, no bias): statistics
    and the fp32 scale applied in fp32, the output in ``dtype``."""

    def __init__(self, hidden: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.empty(hidden, device=device))

    def forward(self, x):
        x32 = x.float()
        x32 = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True)
                                + self.eps)
        return (x32 * self.weight.float()).to(self.dtype)


def rope_frequencies(head_dim: int, positions, theta: float):
    """fp32 cos/sin tables ``[..., head_dim // 2]`` at the absolute
    ``positions`` (``[T]`` shared, or ``[B, T]`` per row)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device)
                           / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Rotate ``x [B, T, H, D]`` by the tables ``cos`` / ``sin`` (``[T,
    D/2]`` shared or ``[B, T, D/2]`` per row, left-padded batches): HF's
    half-split convention, the first half of each head against the
    second, in fp32, cast to x's dtype afterwards."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def repeat_kv(t, rep: int):
    """``[B, T, KV, D]`` with each KV head repeated ``rep`` times next to
    itself (``jnp.repeat`` on the head axis): query head h reads KV head
    ``h // rep``. ``t`` itself when ``rep`` is 1."""
    return t if rep == 1 else t.repeat_interleave(rep, dim=2)


def _linear(in_features, out_features, tp, parallel, device):
    """A bias-free projection: whole, or this rank's column / row slice
    (``parallel``) under ``tp``."""
    if tp is None:
        return nn.Linear(in_features, out_features, bias=False,
                         device=device)
    return parallel(in_features, out_features, tp, bias=False,
                    device=device)


class LlamaAttention(nn.Module):
    """Grouped-query attention with rotary positions over ``H`` query and
    ``KV`` key/value heads, or this rank's ``H / tp`` and ``KV / tp``
    under a ``tp`` that splits it."""

    def __init__(self, config: LlamaConfig, device=None, tp=None):
        super().__init__()
        self.config = config
        C, D = config.hidden_size, config.head_dim
        size = tp.size if tp is not None else 1
        self.n_head = config.num_attention_heads // size
        self.n_kv = config.kv_heads // size
        H, KV = config.num_attention_heads, config.kv_heads
        self.q_proj = _linear(C, H * D, tp, ColumnParallelLinear, device)
        self.k_proj = _linear(C, KV * D, tp, ColumnParallelLinear, device)
        self.v_proj = _linear(C, KV * D, tp, ColumnParallelLinear, device)
        self.o_proj = _linear(H * D, C, tp, RowParallelLinear, device)

    def forward(self, x, keys=None, values=None, step=None):
        """``keys`` / ``values``: this layer's cache buffers (decode
        mode); ``step``: the per-call addressing and rotary tables the
        model computed once for all layers (:meth:`LlamaModel._step`)."""
        cfg = self.config
        B, T, _ = x.shape
        H, KV, D = self.n_head, self.n_kv, cfg.head_dim
        dt = cfg.dtype
        q, k, v = column_projections(
            (self.q_proj, self.k_proj, self.v_proj), x, dt)
        cos, sin = step["rope"]
        q = apply_rope(q.view(B, T, H, D), cos, sin)
        k = apply_rope(k.view(B, T, KV, D), cos, sin)
        v = v.view(B, T, KV, D)
        rep = H // KV
        y = None
        if cfg.decode:
            # append cache: rows [index, index + T), in place
            keys.index_copy_(1, step["write_rows"], k)
            values.index_copy_(1, step["write_rows"], v)
            if not step["prefill"]:
                # the cache's KV heads repeated to the query heads (JAX's
                # jnp.repeat); a padded batch's rows start at their first
                # real key
                y = decode_attention_tp(q, repeat_kv(keys, rep),
                                        repeat_kv(values, rep),
                                        step["index"], pad=step["pad"])
        if y is None:
            # the causal forward (training included) and every prefill:
            # causal attention over the call's own keys, flash on the
            # [B, T, H, D] views; a left-padded prompt also masks its pad
            # keys (the plain masked attention, as in the JAX model)
            mask = step["key_valid"]
            y = attention(q.transpose(1, 2),
                          repeat_kv(k, rep).transpose(1, 2),
                          repeat_kv(v, rep).transpose(1, 2), mask=mask,
                          causal=True,
                          use_flash=cfg.use_flash if mask is None else False
                          ).transpose(1, 2)
        return _dense(self.o_proj, y.reshape(B, T, H * D), dt)


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``, whole or (under a ``tp``
    that splits it) this rank's column / row slices."""

    def __init__(self, config: LlamaConfig, device=None, tp=None):
        super().__init__()
        self.config = config
        C, I = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(C, I, tp, ColumnParallelLinear, device)
        self.up_proj = _linear(C, I, tp, ColumnParallelLinear, device)
        self.down_proj = _linear(I, C, tp, RowParallelLinear, device)

    def forward(self, x):
        dt = self.config.dtype
        gate, up = column_projections((self.gate_proj, self.up_proj), x, dt)
        return _dense(self.down_proj, F.silu(gate) * up, dt)


class LlamaBlock(nn.Module):
    """Pre-norm residual block: ``x + attn(norm x)``, then ``+
    mlp(norm ·)``; ``attn_tp`` / ``mlp_tp``: the tp group that splits
    each half, or None where it stays whole."""

    def __init__(self, config: LlamaConfig, device=None, attn_tp=None,
                 mlp_tp=None):
        super().__init__()
        C, eps, dt = config.hidden_size, config.rms_norm_eps, config.dtype
        self.input_layernorm = RMSNorm(C, eps, dt, device)
        self.self_attn = LlamaAttention(config, device=device, tp=attn_tp)
        self.post_attention_layernorm = RMSNorm(C, eps, dt, device)
        self.mlp = LlamaMLP(config, device=device, tp=mlp_tp)

    def forward(self, x, keys=None, values=None, step=None):
        x = x + self.self_attn(self.input_layernorm(x), keys, values, step)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaLMHead(nn.Module):
    """The LM head's fp32 logits against ``weight`` ``[V, C]``: its own
    matrix (``lm_head.weight``), or under ``tie_word_embeddings`` the
    embedding table itself (one Parameter under both names). ``vocab_tp``:
    the weight is this rank's vocabulary slice, and the local logits are
    all-gathered."""

    def __init__(self, weight: nn.Parameter, vocab_tp=None):
        super().__init__()
        self.weight = weight
        self.vocab_tp = vocab_tp

    def forward(self, hidden):
        if self.vocab_tp is None:
            return head_logits(hidden, self.weight)
        group = self.vocab_tp.group
        return gather_from_tp(head_logits(copy_to_tp(hidden, group),
                                          self.weight), group, dim=-1)


def _retie(model, incompatible_keys):
    """Tie the head back to the embedding table after a state-dict
    load."""
    model.lm_head.weight = model.embed_tokens


class LlamaModel(nn.Module):
    """Decoder stack, final RMSNorm and the (tied or separate) LM head.

    ``LlamaModel(config, device=None, seed=0)`` draws its weights from a
    ``torch.Generator`` seeded with ``seed`` on the weights' own device
    (the JAX model's initializers: normal(0.02) tables and projections,
    unit norms), so a 7B model is drawn on the card without a host copy;
    the same seed gives the same weights on one device type.
    ``device="meta"`` builds the structure without weights. ``tp`` builds
    this rank's tensor-parallel slice (its weights come from the engine's
    ``load_state_dict``, not from ``seed``)."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0,
                 tp=None):
        super().__init__()
        self.config = config
        self.tp = tp
        C = config.hidden_size
        self.vocab_tp = (tp if tp is not None
                         and tp.split("embed_tokens") == 0 else None)
        vocab = config.vocab_size // (self.vocab_tp.size if self.vocab_tp
                                      else 1)
        self.embed_tokens = nn.Parameter(torch.empty(vocab, C,
                                                     device=device))
        self.layers = nn.ModuleList(
            LlamaBlock(config, device=device,
                       attn_tp=_pair_tp(tp, f"layers.{i}.self_attn.q_proj"
                                            f".weight"),
                       mlp_tp=_pair_tp(tp, f"layers.{i}.mlp.gate_proj"
                                           f".weight"))
            for i in range(config.num_hidden_layers))
        self.norm = RMSNorm(C, config.rms_norm_eps, config.dtype, device)
        head = (self.embed_tokens if config.tie_word_embeddings else
                nn.Parameter(torch.empty(vocab, C, device=device)))
        self.lm_head = LlamaLMHead(head, self.vocab_tp)
        if config.tie_word_embeddings:
            # a state dict names the tied table twice, and loading it with
            # assign=True would give the head a Parameter of its own
            self.register_load_state_dict_post_hook(_retie)
        if torch.device(device or "cpu").type != "meta" and tp is None:
            self.init_weights(seed)

    def tp_specs(self, policy, tp_size: int) -> dict:
        """``{state-dict name: PartitionSpec or None}`` of the whole model
        at ``tp_size`` tp ranks under ``policy`` (a name, a ``TPPolicy``
        or the reference's injection forms): the policy's ``spec_for``,
        except that a block's attention splits only where its query and
        KV heads both divide by ``tp_size``, each column group with its
        row layer, and the vocabulary (the embedding and the head
        together) only on its vocab dim."""
        policy = get_tp_policy(policy)
        specs = {name: policy.spec_for(name, tuple(p.shape), tp_size)
                 for name, p in self.named_parameters(remove_duplicate=False)}

        def splits(name, dim):
            spec = specs.get(name)
            return spec is not None and spec[dim] is not None

        def whole(names):
            for n in names:
                specs[n] = None

        cfg = self.config
        heads_split = not (cfg.num_attention_heads % tp_size
                           or cfg.kv_heads % tp_size)
        for i in range(cfg.num_hidden_layers):
            for mod, cols, row, ok in (
                    ("self_attn", ("q_proj", "k_proj", "v_proj"), "o_proj",
                     heads_split),
                    ("mlp", ("gate_proj", "up_proj"), "down_proj", True)):
                names = [f"layers.{i}.{mod}.{n}.weight" for n in cols + (row,)]
                if not (ok and all(splits(n, 0) for n in names[:-1])
                        and splits(names[-1], 1)):
                    whole(names)
        vocab = ["embed_tokens", "lm_head.weight"]
        if not all(splits(n, 0) for n in vocab):
            whole(vocab)
        return specs

    @torch.no_grad()
    def init_weights(self, seed: int):
        """normal(0.02) embedding, projections and head; unit norms."""
        generator = torch.Generator(device=self.embed_tokens.device)
        generator.manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("layernorm.weight") or name == "norm.weight":
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def new_cache(self, batch: int, device=None):
        """A fresh append :class:`~deepspeed_tpu_torch.models.gpt2.
        KVCache` of ``batch`` rows for this decode-mode model: per layer
        ``[B, max_position_embeddings, KV, D]`` of this rank's KV heads
        (the JAX model's ``cached_key``)."""
        cfg = self.config
        return KVCache(cfg.num_hidden_layers,
                       (batch, cfg.max_position_embeddings,
                        self.layers[0].self_attn.n_kv, cfg.head_dim),
                       cfg.dtype, device or self.embed_tokens.device)

    def _step(self, input_ids, cache, attention_mask):
        """Addressing shared by every layer of one call: the cache rows
        (decode), the pad-key mask of a left-padded prompt, and the rotary
        tables at the token positions (per row under a left-padded
        ``attention_mask``, from 0 at each row's first real token)."""
        cfg = self.config
        B, T = input_ids.shape
        t = torch.arange(T, device=input_ids.device)
        step = {"key_valid": (attention_mask[:, None, None, :].bool()
                              if attention_mask is not None else None)}
        if not cfg.decode:
            pos = (row_positions(attention_mask)
                   if attention_mask is not None else t)
        else:
            window = cfg.max_position_embeddings
            if cache.length + T > window:
                raise ValueError(f"cache holds {window} positions; "
                                 f"{cache.length} used + {T} new overflows "
                                 f"it")
            prefill = cache.length == 0
            rows = (cache.index + t).long()
            step.update(prefill=prefill, write_rows=rows, index=cache.index,
                        pad=cache.pad)
            if cfg.padded and prefill and attention_mask is not None:
                # each row's pad length stays in the cache for its decode
                # steps
                cache.pad = pad_lengths(attention_mask, T)
                pos = row_positions(attention_mask)
            elif cache.pad is not None:
                pos = decode_positions(cache.index, T, cache.pad)
            else:
                pos = rows
        step["rope"] = rope_frequencies(cfg.head_dim, pos, cfg.rope_theta)
        return step

    def forward(self, input_ids, cache=None, return_hidden=False,
                attention_mask=None):
        """Logits ``[B, T, vocab]`` in fp32 (or the final hidden states
        with ``return_hidden``). Decode mode needs ``cache`` (from
        :meth:`new_cache`). ``attention_mask`` (``[B, T]`` int, 0 = LEFT
        padding) marks a left-padded batch: the causal forward, or a
        padded decode model's prefill, which keeps each row's pad length
        in the cache."""
        cfg = self.config
        if cfg.decode and cache is None:
            raise ValueError("decode mode needs a cache from new_cache()")
        step = self._step(input_ids, cache, attention_mask)
        x = vocab_parallel_lookup(self.embed_tokens, input_ids,
                                  self.vocab_tp, cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        partition = (self.tp if cfg.partition_activations and self.tp
                     and self.tp.size > 1 else None)
        for i, layer in enumerate(self.layers):
            if cfg.decode:
                x = layer(x, cache.keys[i], cache.values[i], step)
            elif remat:
                x = checkpointed(layer, x, None, None, step,
                                 policy=cfg.remat_policy,
                                 partition=partition)
            else:
                x = layer(x, step=step)
        if cfg.decode:
            cache.index += input_ids.shape[1]
            cache.length += input_ids.shape[1]
        x = self.norm(x)
        return x if return_hidden else self.lm_head(x)


def llama_loss_fn(model: LlamaModel):
    """Engine-facing loss of ``model``: ``fn(batch) -> loss``, the
    next-token objective against the tied or separate head, with the JAX
    model's dense-head budgets (3.5 GB of fp32 logits under remat, 1 GB
    without); vocab-parallel where ``model`` splits its vocabulary."""

    def loss_fn(batch):
        ids, labels = _input_ids_labels(batch)
        hidden = model(ids, return_hidden=True)
        return lm_head_loss(hidden, model.lm_head.weight, shift_labels(labels),
                            dense_budget=_head_budget(model.config),
                            tp=model.vocab_tp)

    return loss_fn


class LlamaForTraining(nn.Module):
    """Engine-ready Llama: ``initialize(model=LlamaForTraining(cfg))``;
    ``forward(batch)`` returns the mean next-token loss. Weights as in
    :class:`LlamaModel` (``seed``, ``device``); ``tp``: this rank's
    tensor-parallel slice (weights from :meth:`with_tensor_parallel`)."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        if config.decode:
            raise ValueError("LlamaForTraining needs a config without "
                             "decode")
        self.config = config
        self.model = LlamaModel(config, device=device, seed=seed, tp=tp)
        self.loss_fn = llama_loss_fn(self.model)

    def forward(self, batch):
        return self.loss_fn(batch)

    @property
    def tp(self) -> Optional[TensorParallel]:
        return self.model.tp

    def with_tensor_parallel(self, tp: TensorParallel, policy="auto"):
        """This rank's tensor-parallel slice of this whole model (on its
        device): the slices :meth:`LlamaModel.tp_specs` gives under
        ``policy`` at ``tp.size`` ranks, copied from this model's
        weights."""
        from deepspeed_tpu_torch.module_inject.policies import \
            shard_params_with_policy

        if self.tp is not None:
            raise ValueError("the model is a tensor-parallel slice already")
        specs = self.model.tp_specs(policy, tp.size)
        local, _ = shard_params_with_policy(self.model.state_dict(), policy,
                                            tp.rank, tp.size, specs=specs)
        sliced = LlamaForTraining(self.config,
                                  device=self.model.embed_tokens.device,
                                  tp=dataclasses.replace(tp, specs=specs))
        sliced.model.load_state_dict(local)
        return sliced

    def param_specs(self) -> dict:
        """``{parameter name: tp PartitionSpec or None}`` in the port's
        dim order, for SpecLayout."""
        specs = self.tp.specs if self.tp is not None else {}
        return {name: specs.get(name[len("model."):])
                for name, _ in self.named_parameters(remove_duplicate=False)}

    def comm_plan(self, rows: int, seq: int) -> dict:
        """The tensor-parallel collectives of one micro-step on ``rows`` x
        ``seq`` tokens a rank, counted as
        :meth:`~deepspeed_tpu_torch.models.gpt2.GPT2ForTraining.
        comm_plan` counts them: g's all-reduce a split group forward and
        f's backward (one a group: a block's attention, its MLP), the
        attention's g again at a ``"full"`` recompute; the split
        vocabulary's lookup, head and loss; under
        ``partition_activations`` one all-gather a block. Empty at tp
        1."""
        tp, cfg = self.tp, self.config
        if tp is None or tp.size == 1:
            return {}
        attn = sum(isinstance(block.self_attn.q_proj, ColumnParallelLinear)
                   for block in self.model.layers)
        pairs = attn + sum(isinstance(block.mlp.gate_proj,
                                      ColumnParallelLinear)
                           for block in self.model.layers)
        remat = cfg.remat
        all_reduce = 2 * pairs + attn * int(remat
                                            and cfg.remat_policy == "full")
        all_gather = 0
        if remat and cfg.partition_activations and seq % tp.size == 0:
            all_gather = cfg.num_hidden_layers
        if self.model.vocab_tp is not None:
            heads = 1
            if not _dense_head(rows, seq, cfg.vocab_size, _head_budget(cfg)):
                heads = 2 * -(-seq // 512)  # forward and recompute a chunk
            all_reduce += 2 + 2 * heads  # lookup, f, the loss's pair
        return {"all_reduce": all_reduce, "all_gather": all_gather}


__all__ = ["LlamaConfig", "LlamaModel", "LlamaForTraining", "LlamaAttention", "LlamaMLP", "LlamaBlock", "LlamaLMHead",
           "RMSNorm", "apply_rope", "llama_loss_fn", "repeat_kv",
           "rope_frequencies"]
