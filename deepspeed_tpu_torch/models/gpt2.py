"""GPT-2 on the card (counterpart of ``deepspeed_tpu/models/gpt2.py``).

The inference paths of the JAX model (the causal forward, the append-cache
decode of ``generate()``, left-padded batches included, and the paged
prefill/decode of the serving engine) and its training path
(:class:`GPT2ForTraining`, the LM-head cross-entropy with the
dense/chunked switch, per-block activation checkpointing), with learned
positions, tanh-GELU MLP, sequential residual blocks and the tied LM
head. Attention routes through
``deepspeed_tpu_torch.ops``: the flash kernels (forward and backward) for
causal self-attention, the append and paged decode kernels for cached
steps (the int8 paged kernel over int8 pools) — their plain versions on
the CPU. A left-padded prefill (``attention_mask``) takes the plain masked
attention, as the JAX model does; its decode steps run the append kernel
with each row's first key at its pad length, where the JAX model takes
its plain masked path.

Parameters are fp32 (the masters); every product runs in the config's
compute dtype, casting the weights at each use, so gradients reach the
fp32 parameters through the casts.

KV caches and pools are tensors updated IN PLACE (``index_copy_``) where
the JAX model returns new arrays and the serving engine donates the old
ones: one allocation lives for the whole generation or serving run.

Tensor parallelism (``GPT2LMHeadModel(config, tp=TensorParallel(...))``,
built by the inference engine from this rank's slices,
:meth:`GPT2LMHeadModel.tp_specs`): ``c_attn`` is column-parallel, split
per Q, K and V, so the rank keeps ``n_head / tp`` heads, and the
attention ``c_proj`` row-parallel; the MLP's ``c_fc`` column- and
``c_proj`` row-parallel; ``wte`` vocab-parallel where the policy splits
the vocab (a masked lookup and an all-reduce; the tied head's local
logits all-gathered). That is ``2 * n_layer`` all-reduces a forward, plus
the vocabulary's pair. Attention stays whole on every rank where the
heads do not divide by tp, as the JAX wrappers fall back to the plain
call; the caches and pools hold the rank's heads.

Training under tensor parallelism (:meth:`GPT2ForTraining.
with_tensor_parallel`, which the engine calls on a ``tp`` mesh): the same
slices, with gradients through Megatron's f/g pair (``module_inject/
layers.py``): f before each column layer and the head, g after each row
layer and the vocab-parallel lookup. Under a split vocabulary the loss is
Megatron's vocab-parallel cross-entropy (:func:`vocab_parallel_nll`):
each rank's logits stay local, and two all-reduces of ``[N]`` values (the
row maxima, then each row's sum of exponentials with its target logit)
give every rank the whole-vocabulary loss; gathering the logits would
move ``N x V`` values instead. With ``partition_activations`` each
rank keeps ``T / tp`` rows of every block input the checkpoint saves
(``models/remat_utils.py``). :meth:`GPT2ForTraining.comm_plan` counts the
collectives a micro-step issues.

ALiBi, rotary, parallel residuals, local windows, dropout and
progressive layer drop belong to other model families or later slices.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.decode_utils import (decode_positions,
                                                     pad_lengths,
                                                     paged_positions,
                                                     paged_write_rows,
                                                     row_positions)
from deepspeed_tpu_torch.models.remat_utils import (REMAT_POLICIES,
                                                    checkpointed)
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.module_inject.layers import (ColumnParallelLinear,
                                                      RowParallelLinear,
                                                      TensorParallel,
                                                      copy_to_tp,
                                                      gather_from_tp,
                                                      vocab_parallel_lookup)
from deepspeed_tpu_torch.module_inject.policies import (decode_cache_specs,
                                                        get_tp_policy)
from deepspeed_tpu_torch.ops.attention import attention_reference
from deepspeed_tpu_torch.ops.decode_attention import (
    decode_attention_paged_int8_tp, decode_attention_paged_tp,
    decode_attention_tp)
from deepspeed_tpu_torch.ops.flash_attention import flash_attention_bthd_tp
from deepspeed_tpu_torch.ops.quantizer import quantize_rowwise


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # compute/activation dtype
    # decode mode: attention reads/writes a KV cache (``forward(cache=)``)
    decode: bool = False
    # padded decode: the batch was prefilled with LEFT-padded prompts
    # (``attention_mask``); decode steps skip each row's padded cache
    # prefix and compute per-row positions
    padded: bool = False
    # paged decode (the serving engine's cache): KV lives in a SHARED
    # block pool ([paged_num_blocks, paged_block_size, H, D] per layer);
    # block tables / lengths / valid counts arrive via ``paging``
    paged: bool = False
    paged_num_blocks: int = 0
    paged_block_size: int = 0
    # paged-KV pool dtype: "" stores blocks in the compute dtype; "int8"
    # quantizes K/V per pool row (ops.quantizer.quantize_rowwise — one
    # fp32 scale per token x head in a side pool indexed by the same
    # block table)
    paged_kv_dtype: str = ""
    # training: per-block activation checkpointing ("full" recomputes the
    # block in backward, "dots" saves matmul and flash outputs and
    # recomputes the elementwise chains — models/remat_utils.py)
    remat: bool = False
    remat_policy: str = "full"
    # training under tensor parallelism: each tp rank keeps T / tp rows of
    # the block inputs the checkpoint saves, all-gathered at recompute
    # (JAX's P(data, model, None) constraint); a no-op at tp = 1
    partition_activations: bool = False
    # accepted for the JAX config's sake: the port loops over its layers
    scan_layers: bool = True
    # accepted for the JAX config's sake, and inert: JAX's "bthd" runs
    # flash attention on [B, T, H, D] views to spare XLA its transposes
    # (any other value is its "bhtd" path; it checks no value), and the
    # port's attention always reads [B, T, H, D] views through the
    # kernels' strides (flash_attention_bthd), so both values give the
    # same outputs in both packages
    attn_layout: str = "bhtd"
    # None/True: flash attention; False: the dense plain attention (the
    # JAX model's escape hatch for numerics comparison)
    use_flash: Optional[bool] = None
    dropout: float = 0.0
    pld: bool = False

    def __post_init__(self):
        if self.dropout > 0:
            raise NotImplementedError(
                "GPT2Config.dropout > 0 is not ported yet: dropout comes "
                "with the training-features slice of the PyTorch port")
        if self.pld:
            raise NotImplementedError(
                "GPT2Config.pld (progressive layer drop) is not ported yet: "
                "it comes with the training-features slice of the PyTorch "
                "port")
        if self.paged_kv_dtype not in ("", "int8"):
            raise ValueError(f"paged_kv_dtype must be '' or 'int8', got "
                             f"{self.paged_kv_dtype!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} not in "
                             f"{REMAT_POLICIES}")
        if self.paged and self.padded:
            raise ValueError("paged and padded decode are mutually "
                             "exclusive: ragged prompts are the block "
                             "table's job in paged mode")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def for_decode(self, padded: bool = False):
        return dataclasses.replace(self, decode=True, padded=padded)

    def for_paged_decode(self, num_blocks: int, block_size: int,
                         kv_dtype: str = ""):
        """Serving variant: decode mode whose KV cache is a shared block
        pool (block 0 reserved as the garbage sink — see
        ``ops.decode_attention.GARBAGE_BLOCK``). Mutually exclusive with
        ``padded``: ragged prompts are the block table's job here.
        ``kv_dtype="int8"`` stores the pool quantized per row with a scale
        side pool (the serving ``kv_cache_dtype`` knob)."""
        return dataclasses.replace(self, decode=True, padded=False,
                                   paged=True,
                                   paged_num_blocks=int(num_blocks),
                                   paged_block_size=int(block_size),
                                   paged_kv_dtype=str(kv_dtype))

    @staticmethod
    def gpt2_125m(**kw):
        return GPT2Config(n_embd=768, n_layer=12, n_head=12, **kw)

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("n_positions", 64)
        kw.setdefault("n_embd", 64)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 4)
        return GPT2Config(**kw)


class KVCache:
    """Append KV cache of one decode batch: ``layers`` key/value buffers
    of ``shape`` ``[B, window, H, D]`` (``H``: the KV heads this rank
    holds), the 0-d int32 device index of the next free row (read by the
    decode kernel on the card, never synced to the host) and its host
    mirror ``length``; ``pad``, the ``[B]`` int32 device tensor of each
    row's left-padded prefix, set by a padded prefill (``None`` when
    unpadded). The decoders' ``new_cache`` give the shapes."""

    def __init__(self, layers: int, shape, dtype, device):
        self.keys = [torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(layers)]
        self.values = [torch.zeros_like(k) for k in self.keys]
        self.index = torch.zeros((), dtype=torch.int32, device=device)
        self.length = 0
        self.pad = None


class PagedKVCache:
    """Paged KV pools of the serving engine: per-layer ``[num_blocks,
    block_size, H, D]`` key/value pools shared by every sequence, in the
    compute dtype or (``paged_kv_dtype="int8"``) as int8 codes with
    per-layer ``[num_blocks, block_size, H, 1]`` fp32 ``key_scales`` /
    ``value_scales`` side pools (empty lists otherwise). ``heads``: this
    rank's heads (all of them by default)."""

    def __init__(self, config: GPT2Config, device,
                 heads: Optional[int] = None):
        if config.paged_num_blocks <= 1 or config.paged_block_size <= 0:
            raise ValueError(
                f"paged decode needs paged_num_blocks > 1 (got "
                f"{config.paged_num_blocks}; block 0 is the reserved garbage "
                f"sink) and paged_block_size > 0 (got "
                f"{config.paged_block_size})")
        shape = (config.paged_num_blocks, config.paged_block_size,
                 heads or config.n_head, config.head_dim)
        quant = config.paged_kv_dtype == "int8"
        dtype = torch.int8 if quant else config.dtype
        self.keys = [torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(config.n_layer)]
        self.values = [torch.zeros_like(k) for k in self.keys]
        scale_shape = shape[:3] + (1,)
        self.key_scales = [torch.zeros(scale_shape, dtype=torch.float32,
                                       device=device)
                           for _ in range(config.n_layer)] if quant else []
        self.value_scales = [torch.zeros_like(s) for s in self.key_scales]

    def pools(self):
        """Every pool tensor: keys, values and (int8) their scales."""
        return self.keys + self.values + self.key_scales + self.value_scales


def _dense(layer, x, dtype):
    """A dense layer in ``dtype``: an ``nn.Linear`` (weights cast at use;
    with or without a bias) or a column- / row-parallel layer holding
    this rank's slice."""
    if isinstance(layer, nn.Linear):
        return F.linear(x, layer.weight.to(dtype), None if layer.bias is None
                        else layer.bias.to(dtype))
    return layer(x, dtype)


def _pair_tp(tp, column: str):
    """``tp`` where its specs split the column-parallel weight
    ``column`` (:meth:`GPT2LMHeadModel.tp_specs` splits a column / row
    pair only as a pair), else None: the pair stays whole."""
    return tp if tp is not None and tp.split(column) is not None else None


def _cache_heads(config: GPT2Config, tp) -> int:
    """This rank's heads of every KV cache and pool under its attention's
    ``tp`` (None: attention whole): the head dim as
    :func:`~deepspeed_tpu_torch.module_inject.policies.decode_cache_specs`
    splits it."""
    size = tp.size if tp is not None else 1
    shape = (1, 1, config.n_head, config.head_dim)
    split = decode_cache_specs({"keys": shape}, size)["keys"] is not None
    return config.n_head // size if split else config.n_head


def _pair(column, row, tp, device):
    """The layers of one projection pair, ``column`` and ``row`` each an
    ``(in, out)`` feature count: whole ``nn.Linear``s, or this rank's
    column- and row-parallel slices."""
    if tp is None:
        return (nn.Linear(*column, device=device),
                nn.Linear(*row, device=device))
    return (ColumnParallelLinear(*column, tp, device=device),
            RowParallelLinear(*row, tp, device=device))


def _layer_norm(ln: nn.LayerNorm, x, dtype):
    # statistics in fp32, output in the compute dtype (flax LayerNorm)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype)


class CausalSelfAttention(nn.Module):
    """Causal self-attention over ``n_head`` heads, or under a tensor-
    parallel ``tp`` that splits its pair over this rank's ``n_head /
    tp``."""

    def __init__(self, config: GPT2Config, device=None, tp=None):
        super().__init__()
        self.config = config
        C = config.n_embd
        self.tp = tp
        self.n_head = config.n_head // (tp.size if tp else 1)
        self.c_attn, self.c_proj = _pair((C, 3 * C), (C, C), tp, device)

    def forward(self, x, keys=None, values=None, step=None, scales=None):
        """``keys``/``values``: this layer's cache buffers (decode mode);
        ``scales``: its ``(key_scales, value_scales)`` side pools (int8
        paged KV); ``step``: the per-call cache addressing the model
        computed once for all layers (see
        :meth:`GPT2LMHeadModel.forward`)."""
        cfg = self.config
        B, T, _ = x.shape
        H, D = self.n_head, cfg.head_dim
        q, k, v = _dense(self.c_attn, x, cfg.dtype).split(H * D, dim=-1)
        q4, k4, v4 = (t.view(B, T, H, D) for t in (q, k, v))
        y4 = None
        if cfg.decode and cfg.paged:
            # scatter this step's KV into the shared pools, in place; pad
            # tokens land in the garbage block (paged_write_rows). int8
            # pools take the row-quantized codes and their scales through
            # the same rows
            rows = step["write_rows"]
            if scales is None:
                writes = ((keys, k4), (values, v4))
            else:
                (kq, ks), (vq, vs) = (quantize_rowwise(t) for t in (k4, v4))
                writes = ((keys, kq), (values, vq), (scales[0], ks),
                          (scales[1], vs))
            for pool, t in writes:
                pool.view(-1, H, t.shape[-1]).index_copy_(
                    0, rows, t.reshape(B * T, H, t.shape[-1]))
            # a whole-prompt prefill attends its own unquantized keys
            # below; every other call attends the pool
            if not step["prefill"]:
                if scales is None:
                    y4 = decode_attention_paged_tp(
                        q4.contiguous(), keys, values, step["block_tables"],
                        step["lengths"])
                else:
                    y4 = decode_attention_paged_int8_tp(
                        q4.contiguous(), keys, values, scales[0], scales[1],
                        step["block_tables"], step["lengths"])
        elif cfg.decode:
            # append cache: rows [index, index + T), in place
            keys.index_copy_(1, step["write_rows"], k4)
            values.index_copy_(1, step["write_rows"], v4)
            if not step["prefill"]:
                # a padded batch's rows start at their first real key
                y4 = decode_attention_tp(q4.contiguous(), keys, values,
                                         step["index"], pad=step["pad"])
        if y4 is None:
            # the causal forward (training included) and every prefill:
            # causal attention over the call's own keys, through the flash
            # kernel on this rank's heads; a left-padded prompt also masks
            # its pad keys (the plain masked attention, as in the JAX
            # model: pad queries see only pad keys, and their outputs are
            # never used)
            mask = step.get("key_valid") if step else None
            if mask is None and cfg.use_flash is not False:
                y4 = flash_attention_bthd_tp(q4, k4, v4, causal=True)
            else:
                y4 = attention_reference(
                    q4.transpose(1, 2), k4.transpose(1, 2),
                    v4.transpose(1, 2), causal=True,
                    mask=mask).transpose(1, 2)
        return _dense(self.c_proj, y4.reshape(B, T, H * D), cfg.dtype)


class MLP(nn.Module):
    """The tanh-GELU MLP, whole or (under a ``tp`` that splits its pair)
    as this rank's column / row slices."""

    def __init__(self, config: GPT2Config, device=None, tp=None):
        super().__init__()
        self.config = config
        C = config.n_embd
        self.c_fc, self.c_proj = _pair((C, 4 * C), (4 * C, C), tp, device)

    def forward(self, x):
        dt = self.config.dtype
        h = F.gelu(_dense(self.c_fc, x, dt), approximate="tanh")
        return _dense(self.c_proj, h, dt)


class Block(nn.Module):
    """Sequential residual: ``x + attn(ln_1 x)``, then ``+ mlp(ln_2 ·)``;
    ``attn_tp`` / ``mlp_tp``: the tensor-parallel group that splits each
    pair, or None where it stays whole."""

    def __init__(self, config: GPT2Config, device=None, attn_tp=None,
                 mlp_tp=None):
        super().__init__()
        self.config = config
        eps = config.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(config.n_embd, eps=eps, device=device)
        self.attn = CausalSelfAttention(config, device=device, tp=attn_tp)
        self.ln_2 = nn.LayerNorm(config.n_embd, eps=eps, device=device)
        self.mlp = MLP(config, device=device, tp=mlp_tp)

    def forward(self, x, keys=None, values=None, step=None, scales=None):
        dt = self.config.dtype
        x = x + self.attn(_layer_norm(self.ln_1, x, dt), keys, values, step,
                          scales)
        return x + self.mlp(_layer_norm(self.ln_2, x, dt))


class GPT2LMHeadModel(nn.Module):
    """GPT-2 with the tied-embedding LM head.

    ``GPT2LMHeadModel(config, seed=0)`` draws its weights on the CPU from
    a ``torch.Generator`` seeded with ``seed`` — the JAX model's init
    distributions — so the same seed gives the same weights on every
    device; ``device="meta"`` builds the structure without weights.
    ``tp`` (a :class:`~deepspeed_tpu_torch.module_inject.layers.
    TensorParallel` whose ``specs`` are :meth:`tp_specs`') builds this
    rank's tensor-parallel slice of the model; it takes its weights from
    the inference engine (``load_state_dict``), not from ``seed``.
    """

    def __init__(self, config: GPT2Config, device=None, seed: int = 0,
                 tp=None):
        super().__init__()
        self.config = config
        self.tp = tp
        C = config.n_embd
        # vocab-parallel embedding and tied head where tp splits the vocab
        self.vocab_tp = tp if tp is not None and tp.split("wte") == 0 \
            else None
        vocab = config.vocab_size // (self.vocab_tp.size if self.vocab_tp
                                      else 1)
        self.wte = nn.Parameter(torch.empty(vocab, C, device=device))
        self.wpe = nn.Parameter(torch.empty(config.n_positions, C,
                                            device=device))
        self.h = nn.ModuleList(
            Block(config, device=device,
                  attn_tp=_pair_tp(tp, f"h.{i}.attn.c_attn.weight"),
                  mlp_tp=_pair_tp(tp, f"h.{i}.mlp.c_fc.weight"))
            for i in range(config.n_layer))
        self.ln_f = nn.LayerNorm(C, eps=config.layer_norm_epsilon,
                                 device=device)
        if torch.device(device or "cpu").type != "meta" and tp is None:
            self.init_weights(torch.Generator().manual_seed(seed))

    def tp_specs(self, policy, tp_size: int) -> dict:
        """``{name: PartitionSpec or None}`` of the whole model's
        parameters at ``tp_size`` tp ranks under ``policy`` (a name, a
        ``TPPolicy`` or the reference's injection forms): the policy's
        ``spec_for``, except that a column / row pair splits only as a
        pair, attention only where ``n_head`` divides by ``tp_size``, and
        the vocabulary only on its vocab dim. The inference engine slices
        the weights by these specs and builds the model's ``tp`` slice
        from them."""
        policy = get_tp_policy(policy)
        specs = {name: policy.spec_for(name, tuple(p.shape), tp_size)
                 for name, p in self.named_parameters()}

        def whole(*names):
            for n in names:
                specs[n] = None

        def splits(name, dim):
            spec = specs.get(name)
            return spec is not None and spec[dim] is not None

        for i in range(self.config.n_layer):
            for mod, col, row in (("attn", "c_attn", "c_proj"),
                                  ("mlp", "c_fc", "c_proj")):
                p = f"h.{i}.{mod}."
                names = [p + f"{n}.{w}" for n in (col, row)
                         for w in ("weight", "bias")]
                if not (splits(p + col + ".weight", 0)
                        and splits(p + row + ".weight", 1)) or (
                        mod == "attn" and self.config.n_head % tp_size):
                    whole(*names)
        if not splits("wte", 0):
            whole("wte")
        return specs

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """normal(0.02) embeddings and projections, normal(0.01)
        positions, normal(0.02/sqrt(2L)) residual projections, zero
        biases, unit LayerNorms (the JAX model's initializers)."""
        resid = 0.02 / (2 * self.config.n_layer) ** 0.5

        def normal(t, std):
            t.copy_(torch.randn(t.shape, generator=generator) * std)

        normal(self.wte, 0.02)
        normal(self.wpe, 0.01)
        for block in self.h:
            normal(block.attn.c_attn.weight, 0.02)
            normal(block.attn.c_proj.weight, resid)
            normal(block.mlp.c_fc.weight, 0.02)
            normal(block.mlp.c_proj.weight, resid)
        for name, p in self.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            elif ".ln_" in name or name.startswith("ln_f"):
                p.fill_(1.0)

    def new_cache(self, batch: int, device=None):
        """A fresh cache for this decode-mode model: a :class:`KVCache`
        of ``batch`` rows, or the :class:`PagedKVCache` pools."""
        device = device or self.wte.device
        heads = _cache_heads(self.config, self.h[0].attn.tp)
        if self.config.paged:
            return PagedKVCache(self.config, device, heads)
        cfg = self.config
        return KVCache(cfg.n_layer, (batch, cfg.n_positions, heads,
                                     cfg.head_dim), cfg.dtype, device)

    def _step(self, input_ids, cache, paging, attention_mask):
        """Cache addressing shared by every layer of one call, and the
        token positions (per row under a left-padded ``attention_mask``,
        from 0 at each row's first real token)."""
        cfg = self.config
        B, T = input_ids.shape
        dev = input_ids.device
        t = torch.arange(T, device=dev)
        key_valid = (attention_mask[:, None, None, :].bool()
                     if attention_mask is not None else None)
        if not cfg.decode:
            if attention_mask is None:
                return None, t[None]
            return {"key_valid": key_valid}, row_positions(attention_mask)
        if cfg.paged:
            if paging is None:
                raise ValueError(
                    "paged decode needs the `paging` argument: "
                    '{"block_tables": [B, MB] int32, "lengths": [B] int32, '
                    '"num_valid": [B] int32, "prefill": bool}')
            tables, lengths = paging["block_tables"], paging["lengths"]
            pos = paged_positions(lengths, T)
            rows = paged_write_rows(tables, pos, paging["num_valid"],
                                    cfg.paged_block_size)
            step = {"prefill": bool(paging["prefill"]),
                    "write_rows": rows.reshape(-1).long(),
                    "block_tables": tables, "lengths": lengths}
            # pads read a clipped position; their outputs are never used
            return step, pos.clamp(0, cfg.n_positions - 1)
        if cache.length + T > cfg.n_positions:
            raise ValueError(f"cache holds {cfg.n_positions} positions; "
                             f"{cache.length} used + {T} new overflows it")
        prefill = cache.length == 0
        rows = (cache.index + t).long()
        step = {"prefill": prefill, "write_rows": rows,
                "index": cache.index, "pad": cache.pad}
        if cfg.padded and prefill and attention_mask is not None:
            # each row's pad length stays in the cache for its decode steps
            cache.pad = pad_lengths(attention_mask, T)
            step["key_valid"] = key_valid
            return step, row_positions(attention_mask)
        if cache.pad is None:
            return step, rows[None]
        return step, decode_positions(cache.index, T, cache.pad).long()

    def forward(self, input_ids, cache=None, paging=None,
                return_hidden=False, attention_mask=None):
        """Logits ``[B, T, vocab]`` in fp32 (or the final hidden states
        with ``return_hidden``). Decode mode needs ``cache`` (from
        :meth:`new_cache`), and paged mode also ``paging``.
        ``attention_mask`` (``[B, T]`` int, 0 = LEFT padding) marks a
        left-padded batch: the causal forward, or a padded decode model's
        prefill, which keeps each row's pad length in the cache."""
        cfg = self.config
        if cfg.decode and cache is None:
            raise ValueError("decode mode needs a cache from new_cache()")
        step, pos = self._step(input_ids, cache, paging, attention_mask)
        x = (vocab_parallel_lookup(self.wte, input_ids, self.vocab_tp,
                                   cfg.dtype)
             + self.wpe[pos].to(cfg.dtype))
        remat = cfg.remat and torch.is_grad_enabled()
        partition = (self.tp if cfg.partition_activations and self.tp
                     and self.tp.size > 1 else None)
        for i, block in enumerate(self.h):
            if cfg.decode:
                scales = ((cache.key_scales[i], cache.value_scales[i])
                          if cfg.paged_kv_dtype == "int8" else None)
                x = block(x, cache.keys[i], cache.values[i], step, scales)
            elif remat:
                x = checkpointed(block, x, None, None, step,
                                 policy=cfg.remat_policy,
                                 partition=partition)
            else:
                x = block(x, step=step)
        if cfg.decode and not cfg.paged:
            cache.index += input_ids.shape[1]
            cache.length += input_ids.shape[1]
        x = _layer_norm(self.ln_f, x, cfg.dtype)
        return x if return_hidden else self.lm_head(x)

    def lm_head(self, hidden):
        """Tied-embedding logits in fp32 (:func:`head_logits`);
        vocab-parallel, this rank's logits all-gathered."""
        if self.vocab_tp is None:
            return head_logits(hidden, self.wte)
        group = self.vocab_tp.group
        return gather_from_tp(head_logits(copy_to_tp(hidden, group),
                                          self.wte), group, dim=-1)


# ---------------------------------------------------------------------------
# the LM head (fp32 logits, cross-entropy) and the engine-facing model
# ---------------------------------------------------------------------------
class _Bf16HeadLogits(torch.autograd.Function):
    """fp32 logits ``h · wᵀ`` of bf16 ``h [N, C]`` and ``w [V, C]`` on the
    card: one bf16 GEMM with fp32 output (``torch.mm(out_dtype=)``, the
    JAX head's ``preferred_element_type=float32``), so the logits are not
    rounded to bf16. Backward rounds the fp32 cotangent to bf16 and runs
    two bf16 GEMMs, as the TPU does with its default matmul precision."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        return g @ w, g.t() @ h


def head_logits(hidden, head_w):
    """fp32 logits ``[..., V]`` of the tied head: compute-dtype products
    summed in fp32 (``einsum(..., preferred_element_type=float32)``)."""
    w = head_w.to(hidden.dtype)
    if hidden.dtype == torch.float32:
        return F.linear(hidden, w)
    if hidden.device.type == "cuda" and hidden.dtype == torch.bfloat16:
        flat = _Bf16HeadLogits.apply(hidden.reshape(-1, hidden.shape[-1]), w)
        return flat.view(*hidden.shape[:-1], w.shape[0])
    # the products of two 16-bit values are exact in fp32
    return F.linear(hidden.float(), w.float())


def shift_labels(labels, ignore_index: int = -100):
    """Next-token shift: labels[t] <- labels[t+1], last column ignored."""
    return torch.cat([labels[:, 1:],
                      labels.new_full((labels.shape[0], 1), ignore_index)],
                     dim=1)


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token cross-entropy ``[N]`` of logits split over a tp group's
    vocabulary (``logits [N, V/tp]`` fp32, this rank's ``rank``-th slice;
    ``labels [N]`` whole-vocabulary ids): the row maxima all-reduced by
    MAX, then each row's sum of exponentials and its target logit (on the
    rank that holds it) in one SUM all-reduce. Backward: ``softmax -
    onehot`` of the local slice, no collective."""

    @staticmethod
    def forward(ctx, logits, labels, group, rank, ignore_index):
        rows = logits.shape[-1]
        m = comm.all_reduce(logits.max(dim=-1).values, op=comm.ReduceOp.MAX,
                            group=group)
        shifted = logits - m[:, None]
        local = labels - rank * rows
        inside = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        target = torch.where(
            inside, shifted.gather(1, local[:, None])[:, 0], 0.0)
        exp = shifted.exp()
        sums = comm.all_reduce(torch.stack([exp.sum(dim=-1), target]),
                               group=group)
        valid = labels != ignore_index
        nll = torch.where(valid, sums[0].log() - sums[1], 0.0)
        exp.div_(sums[0][:, None])
        ctx.save_for_backward(exp, local, inside & valid, valid)
        return nll

    @staticmethod
    def backward(ctx, grad):
        softmax, local, hit, valid = ctx.saved_tensors
        g = softmax.scatter_add(1, local[:, None], -hit.to(softmax.dtype)
                                [:, None])
        return g * (grad * valid)[:, None], None, None, None, None


def vocab_parallel_nll(logits, labels, tp: TensorParallel,
                       ignore_index: int = -100):
    """Summed cross-entropy of ``[..., V/tp]`` fp32 logits, this tp rank's
    vocabulary slice (:class:`_VocabParallelNLL`), against whole-
    vocabulary ``labels``: the same value on every rank of ``tp.group``."""
    return _VocabParallelNLL.apply(
        logits.reshape(-1, logits.shape[-1]).float(), labels.reshape(-1),
        tp.group, tp.rank, ignore_index).sum()


def _nll_sum(logits, labels, ignore_index, tp=None):
    if tp is not None:
        return vocab_parallel_nll(logits, labels, tp, ignore_index)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1), ignore_index=ignore_index,
                           reduction="sum")


def cross_entropy_loss(logits, labels, ignore_index: int = -100, tp=None):
    """Mean token cross-entropy in fp32, masked where ``labels ==
    ignore_index`` (0 when every token is); ``tp``: the logits are this
    rank's slice of a vocabulary split over ``tp.group``."""
    valid = (labels != ignore_index).sum().clamp_min(1)
    return _nll_sum(logits.float(), labels, ignore_index, tp) / valid


def chunked_softmax_xent(hidden, wte, labels, chunk: int = 128,
                         ignore_index: int = -100, tp=None):
    """Cross-entropy against the tied embedding without the full ``[B, T,
    V]`` fp32 logits: one sequence chunk at a time, each under activation
    checkpointing, so the peak is ``[B, chunk, V]`` and backward recomputes
    each chunk's logits (the JAX version's remat'd scan). ``tp``: ``wte``
    is this rank's vocabulary slice; the vocab-parallel loss, ``hidden``'s
    gradient summed over the group once."""
    w = wte.to(hidden.dtype)
    if tp is not None:
        hidden = copy_to_tp(hidden, tp.group)

    def chunk_nll(hc, wc, lc):
        return _nll_sum(head_logits(hc, wc), lc, ignore_index, tp)

    total = hidden.new_zeros((), dtype=torch.float32)
    for t0 in range(0, hidden.shape[1], chunk):
        total = total + checkpointed(chunk_nll, hidden[:, t0:t0 + chunk], w,
                                     labels[:, t0:t0 + chunk])
    return total / (labels != ignore_index).sum().clamp_min(1)


def _dense_head(rows, seq, vocab, dense_budget) -> bool:
    """Whether the head's fp32 ``[rows, seq, vocab]`` logits fit."""
    return rows * seq * vocab * 4 <= dense_budget


def lm_head_loss(hidden, head_w, shifted_labels,
                 dense_budget: int = 1_000_000_000, chunk: int = 512,
                 tp=None):
    """LM-head cross-entropy with the dense-vs-chunked switch: the full
    ``[B, T, V]`` fp32 logits when they fit ``dense_budget`` bytes, else
    :func:`chunked_softmax_xent`. The tied head has no bias (GPT-J's
    separate head and its bias come with that model family). ``tp``: the
    vocabulary is split over ``tp.group`` (``head_w`` is this rank's
    slice); the switch reads the whole vocabulary, as in JAX."""
    B, T, _ = hidden.shape
    vocab = head_w.shape[0] * (tp.size if tp is not None else 1)
    if not _dense_head(B, T, vocab, dense_budget):
        return chunked_softmax_xent(hidden, head_w, shifted_labels,
                                    chunk=chunk, tp=tp)
    if tp is not None:
        hidden = copy_to_tp(hidden, tp.group)
    return cross_entropy_loss(head_logits(hidden, head_w), shifted_labels,
                              tp=tp)


def _input_ids_labels(batch):
    """``(input_ids, labels)`` of a batch: a dict with ``input_ids`` (and
    optionally ``labels``) or an ``(input_ids, labels)`` pair."""
    if isinstance(batch, dict):
        ids, labels = batch["input_ids"], batch.get("labels")
    else:
        ids, labels = batch
    ids = ids.long()
    return ids, ids if labels is None else labels.long()


def _head_budget(config: GPT2Config) -> int:
    """The dense head's logits budget: 3.5 GB under remat and 1 GB
    without, where the saved block activations already take the
    memory."""
    return 3_500_000_000 if config.remat else 1_000_000_000


def gpt2_loss_fn(model: GPT2LMHeadModel):
    """Engine-facing loss of ``model``: ``fn(batch) -> loss``, the
    next-token objective (labels shifted inside), vocab-parallel where
    ``model`` splits its vocabulary."""

    def loss_fn(batch):
        ids, labels = _input_ids_labels(batch)
        hidden = model(ids, return_hidden=True)
        return lm_head_loss(hidden, model.wte, shift_labels(labels),
                            dense_budget=_head_budget(model.config),
                            tp=model.vocab_tp)

    return loss_fn


class GPT2ForTraining(nn.Module):
    """Engine-ready GPT-2: ``initialize(model=GPT2ForTraining(cfg))``;
    ``forward(batch)`` returns the mean next-token loss. Weights as in
    :class:`GPT2LMHeadModel` (``seed``, ``device="meta"`` for none);
    ``tp``: this rank's tensor-parallel slice (weights from
    :meth:`with_tensor_parallel`, not ``seed``)."""

    def __init__(self, config: GPT2Config, device=None, seed: int = 0,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        if config.decode:
            raise ValueError("GPT2ForTraining needs a config without decode")
        self.config = config
        self.model = GPT2LMHeadModel(config, device=device, seed=seed, tp=tp)
        self.loss_fn = gpt2_loss_fn(self.model)

    def forward(self, batch):
        return self.loss_fn(batch)

    @property
    def tp(self) -> Optional[TensorParallel]:
        return self.model.tp

    def with_tensor_parallel(self, tp: TensorParallel, policy="auto"):
        """This rank's tensor-parallel slice of this whole model (on its
        device): the slices :meth:`GPT2LMHeadModel.tp_specs` gives under
        ``policy`` at ``tp.size`` ranks, copied from this model's
        weights (the inference engine's ``_shard``)."""
        from deepspeed_tpu_torch.module_inject.policies import \
            shard_params_with_policy

        if self.tp is not None:
            raise ValueError("the model is a tensor-parallel slice already")
        specs = self.model.tp_specs(policy, tp.size)
        local, _ = shard_params_with_policy(self.model.state_dict(), policy,
                                            tp.rank, tp.size, specs=specs)
        sliced = GPT2ForTraining(self.config, device=self.model.wte.device,
                                 tp=dataclasses.replace(tp, specs=specs))
        sliced.model.load_state_dict(local)
        return sliced

    def param_specs(self) -> dict:
        """``{parameter name: tp PartitionSpec or None}`` in the port's
        dim order (the JAX model's ``param_specs``), for SpecLayout."""
        specs = self.tp.specs if self.tp is not None else {}
        return {name: specs.get(name[len("model."):])
                for name, _ in self.named_parameters()}

    def comm_plan(self, rows: int, seq: int) -> dict:
        """The tensor-parallel collectives of one micro-step (forward and
        backward) on ``rows`` x ``seq`` tokens a rank: g's all-reduce a
        split pair forward and f's backward, and under ``"full"`` remat
        the attention's g again at the recompute (``"dots"`` saves it;
        the MLP's g ends the block, where the recompute, which stops once
        backward has what it needs, never gets); the split
        vocabulary's lookup, head (f) and loss (2 a call, and under the
        chunked head 2 more a chunk at its recompute); under
        ``partition_activations`` one all-gather a block. Empty at tp 1."""
        tp, cfg = self.tp, self.config
        if tp is None or tp.size == 1:
            return {}
        attn = sum(isinstance(block.attn.c_attn, ColumnParallelLinear)
                   for block in self.model.h)
        pairs = attn + sum(isinstance(block.mlp.c_fc, ColumnParallelLinear)
                           for block in self.model.h)
        remat = cfg.remat
        all_reduce = 2 * pairs + attn * int(remat
                                            and cfg.remat_policy == "full")
        all_gather = 0
        if remat and cfg.partition_activations and seq % tp.size == 0:
            all_gather = cfg.n_layer
        if self.model.vocab_tp is not None:
            heads = 1
            if not _dense_head(rows, seq, cfg.vocab_size, _head_budget(cfg)):
                heads = 2 * -(-seq // 512)  # forward and recompute a chunk
            all_reduce += 2 + 2 * heads  # lookup, f, the loss's pair
        return {"all_reduce": all_reduce, "all_gather": all_gather}


__all__ = ["GPT2Config", "GPT2LMHeadModel", "GPT2ForTraining", "KVCache",
           "PagedKVCache", "Block", "MLP", "CausalSelfAttention",
           "chunked_softmax_xent", "cross_entropy_loss", "gpt2_loss_fn",
           "head_logits", "lm_head_loss", "shift_labels",
           "vocab_parallel_nll"]
