"""GPT-2 on the card (counterpart of ``deepspeed_tpu/models/gpt2.py``).

The inference paths of the JAX model (the causal forward, the append-cache
decode of ``generate()`` and the paged prefill/decode of the serving
engine) and its training path (:class:`GPT2ForTraining`, the LM-head
cross-entropy with the dense/chunked switch, per-block activation
checkpointing), with learned positions, tanh-GELU MLP, sequential residual
blocks and the tied LM head. Attention routes through
``deepspeed_tpu_torch.ops``: the flash kernels (forward and backward) for
causal self-attention, the append and paged decode kernels for cached
steps (the int8 paged kernel over int8 pools) — their plain versions on
the CPU.

Parameters are fp32 (the masters); every product runs in the config's
compute dtype, casting the weights at each use, so gradients reach the
fp32 parameters through the casts.

KV caches and pools are tensors updated IN PLACE (``index_copy_``) where
the JAX model returns new arrays and the serving engine donates the old
ones: one allocation lives for the whole generation or serving run.

ALiBi, rotary, parallel residuals, local windows, padded generation,
dropout and progressive layer drop belong to other model families or
later slices.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.decode_utils import (paged_positions,
                                                     paged_write_rows)
from deepspeed_tpu_torch.models.remat_utils import (REMAT_POLICIES,
                                                    checkpointed)
from deepspeed_tpu_torch.ops.attention import attention, attention_reference
from deepspeed_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_paged, decode_attention_paged_int8)
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
    # accepted for the JAX config's sake: the port loops over its layers
    scan_layers: bool = True
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

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def for_decode(self):
        return dataclasses.replace(self, decode=True)

    def for_paged_decode(self, num_blocks: int, block_size: int,
                         kv_dtype: str = ""):
        """Serving variant: decode mode whose KV cache is a shared block
        pool (block 0 reserved as the garbage sink — see
        ``ops.decode_attention.GARBAGE_BLOCK``); ``kv_dtype="int8"``
        stores the pool quantized per row with a scale side pool (the
        serving ``kv_cache_dtype`` knob)."""
        return dataclasses.replace(self, decode=True, paged=True,
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
    """Append KV cache of one decode batch: per-layer ``[B, n_positions,
    H, D]`` key/value buffers, the 0-d int32 device index of the next free
    row (read by the decode kernel on the card, never synced to the host)
    and its host mirror ``length``."""

    def __init__(self, config: GPT2Config, batch: int, device):
        shape = (batch, config.n_positions, config.n_head, config.head_dim)
        self.keys = [torch.zeros(shape, dtype=config.dtype, device=device)
                     for _ in range(config.n_layer)]
        self.values = [torch.zeros_like(k) for k in self.keys]
        self.index = torch.zeros((), dtype=torch.int32, device=device)
        self.length = 0


class PagedKVCache:
    """Paged KV pools of the serving engine: per-layer ``[num_blocks,
    block_size, H, D]`` key/value pools shared by every sequence, in the
    compute dtype or (``paged_kv_dtype="int8"``) as int8 codes with
    per-layer ``[num_blocks, block_size, H, 1]`` fp32 ``key_scales`` /
    ``value_scales`` side pools (empty lists otherwise)."""

    def __init__(self, config: GPT2Config, device):
        if config.paged_num_blocks <= 1 or config.paged_block_size <= 0:
            raise ValueError(
                f"paged decode needs paged_num_blocks > 1 (got "
                f"{config.paged_num_blocks}; block 0 is the reserved garbage "
                f"sink) and paged_block_size > 0 (got "
                f"{config.paged_block_size})")
        shape = (config.paged_num_blocks, config.paged_block_size,
                 config.n_head, config.head_dim)
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


def _dense(layer: nn.Linear, x, dtype):
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(ln: nn.LayerNorm, x, dtype):
    # statistics in fp32, output in the compute dtype (flax LayerNorm)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        self.config = config
        self.c_attn = nn.Linear(config.n_embd, 3 * config.n_embd,
                                device=device)
        self.c_proj = nn.Linear(config.n_embd, config.n_embd, device=device)

    def forward(self, x, keys=None, values=None, step=None, scales=None):
        """``keys``/``values``: this layer's cache buffers (decode mode);
        ``scales``: its ``(key_scales, value_scales)`` side pools (int8
        paged KV); ``step``: the per-call cache addressing the model
        computed once for all layers (see
        :meth:`GPT2LMHeadModel.forward`)."""
        cfg = self.config
        B, T, C = x.shape
        H, D = cfg.n_head, cfg.head_dim
        q, k, v = _dense(self.c_attn, x, cfg.dtype).split(C, dim=-1)
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
                    y4 = decode_attention_paged(
                        q4.contiguous(), keys, values, step["block_tables"],
                        step["lengths"])
                else:
                    y4 = decode_attention_paged_int8(
                        q4.contiguous(), keys, values, scales[0], scales[1],
                        step["block_tables"], step["lengths"])
        elif cfg.decode:
            # append cache: rows [index, index + T), in place
            keys.index_copy_(1, step["write_rows"], k4)
            values.index_copy_(1, step["write_rows"], v4)
            if not step["prefill"]:
                y4 = decode_attention(q4.contiguous(), keys, values,
                                      step["index"])
        if y4 is None:
            # the causal forward (training included) and every prefill:
            # causal attention over the call's own keys
            attend = attention_reference if cfg.use_flash is False \
                else attention
            y4 = attend(q4.transpose(1, 2), k4.transpose(1, 2),
                        v4.transpose(1, 2), causal=True).transpose(1, 2)
        return _dense(self.c_proj, y4.reshape(B, T, C), cfg.dtype)


class MLP(nn.Module):
    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        self.config = config
        self.c_fc = nn.Linear(config.n_embd, 4 * config.n_embd, device=device)
        self.c_proj = nn.Linear(4 * config.n_embd, config.n_embd,
                                device=device)

    def forward(self, x):
        dt = self.config.dtype
        h = F.gelu(_dense(self.c_fc, x, dt), approximate="tanh")
        return _dense(self.c_proj, h, dt)


class Block(nn.Module):
    """Sequential residual: ``x + attn(ln_1 x)``, then ``+ mlp(ln_2 ·)``."""

    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        self.config = config
        eps = config.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(config.n_embd, eps=eps, device=device)
        self.attn = CausalSelfAttention(config, device=device)
        self.ln_2 = nn.LayerNorm(config.n_embd, eps=eps, device=device)
        self.mlp = MLP(config, device=device)

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
    """

    def __init__(self, config: GPT2Config, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        C = config.n_embd
        self.wte = nn.Parameter(torch.empty(config.vocab_size, C,
                                            device=device))
        self.wpe = nn.Parameter(torch.empty(config.n_positions, C,
                                            device=device))
        self.h = nn.ModuleList(Block(config, device=device)
                               for _ in range(config.n_layer))
        self.ln_f = nn.LayerNorm(C, eps=config.layer_norm_epsilon,
                                 device=device)
        if torch.device(device or "cpu").type != "meta":
            self.init_weights(torch.Generator().manual_seed(seed))

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
        if self.config.paged:
            return PagedKVCache(self.config, device)
        return KVCache(self.config, batch, device)

    def _step(self, input_ids, cache, paging):
        """Cache addressing shared by every layer of one call, and the
        token positions."""
        cfg = self.config
        B, T = input_ids.shape
        dev = input_ids.device
        t = torch.arange(T, device=dev)
        if not cfg.decode:
            return None, t[None]
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
        pos = (cache.index + t).long()
        step = {"prefill": cache.length == 0, "write_rows": pos,
                "index": cache.index}
        return step, pos[None]

    def forward(self, input_ids, cache=None, paging=None,
                return_hidden=False):
        """Logits ``[B, T, vocab]`` in fp32 (or the final hidden states
        with ``return_hidden``). Decode mode needs ``cache`` (from
        :meth:`new_cache`), and paged mode also ``paging``."""
        cfg = self.config
        if cfg.decode and cache is None:
            raise ValueError("decode mode needs a cache from new_cache()")
        step, pos = self._step(input_ids, cache, paging)
        x = self.wte[input_ids].to(cfg.dtype) + self.wpe[pos].to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.h):
            if cfg.decode:
                scales = ((cache.key_scales[i], cache.value_scales[i])
                          if cfg.paged_kv_dtype == "int8" else None)
                x = block(x, cache.keys[i], cache.values[i], step, scales)
            elif remat:
                x = checkpointed(block, x, policy=cfg.remat_policy)
            else:
                x = block(x)
        if cfg.decode and not cfg.paged:
            cache.index += input_ids.shape[1]
            cache.length += input_ids.shape[1]
        x = _layer_norm(self.ln_f, x, cfg.dtype)
        return x if return_hidden else self.lm_head(x)

    def lm_head(self, hidden):
        """Tied-embedding logits in fp32 (:func:`head_logits`)."""
        return head_logits(hidden, self.wte)


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


def _nll_sum(logits, labels, ignore_index):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1), ignore_index=ignore_index,
                           reduction="sum")


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Mean token cross-entropy in fp32, masked where ``labels ==
    ignore_index`` (0 when every token is)."""
    valid = (labels != ignore_index).sum().clamp_min(1)
    return _nll_sum(logits.float(), labels, ignore_index) / valid


def chunked_softmax_xent(hidden, wte, labels, chunk: int = 128,
                         ignore_index: int = -100):
    """Cross-entropy against the tied embedding without the full ``[B, T,
    V]`` fp32 logits: one sequence chunk at a time, each under activation
    checkpointing, so the peak is ``[B, chunk, V]`` and backward recomputes
    each chunk's logits (the JAX version's remat'd scan)."""
    w = wte.to(hidden.dtype)

    def chunk_nll(hc, wc, lc):
        return _nll_sum(head_logits(hc, wc), lc, ignore_index)

    total = hidden.new_zeros((), dtype=torch.float32)
    for t0 in range(0, hidden.shape[1], chunk):
        total = total + checkpointed(chunk_nll, hidden[:, t0:t0 + chunk], w,
                                     labels[:, t0:t0 + chunk])
    return total / (labels != ignore_index).sum().clamp_min(1)


def lm_head_loss(hidden, head_w, shifted_labels,
                 dense_budget: int = 1_000_000_000, chunk: int = 512):
    """LM-head cross-entropy with the dense-vs-chunked switch: the full
    ``[B, T, V]`` fp32 logits when they fit ``dense_budget`` bytes, else
    :func:`chunked_softmax_xent`. The tied head has no bias (GPT-J's
    separate head and its bias come with that model family)."""
    B, T, _ = hidden.shape
    if B * T * head_w.shape[0] * 4 <= dense_budget:
        return cross_entropy_loss(head_logits(hidden, head_w), shifted_labels)
    return chunked_softmax_xent(hidden, head_w, shifted_labels, chunk=chunk)


def _input_ids_labels(batch):
    """``(input_ids, labels)`` of a batch: a dict with ``input_ids`` (and
    optionally ``labels``) or an ``(input_ids, labels)`` pair."""
    if isinstance(batch, dict):
        ids, labels = batch["input_ids"], batch.get("labels")
    else:
        ids, labels = batch
    ids = ids.long()
    return ids, ids if labels is None else labels.long()


def gpt2_loss_fn(model: GPT2LMHeadModel):
    """Engine-facing loss of ``model``: ``fn(batch) -> loss``, the
    next-token objective (labels shifted inside). The dense head gets a
    3.5 GB logits budget under remat and 1 GB without, where the saved
    block activations already take the memory."""

    def loss_fn(batch):
        ids, labels = _input_ids_labels(batch)
        hidden = model(ids, return_hidden=True)
        return lm_head_loss(
            hidden, model.wte, shift_labels(labels),
            dense_budget=3_500_000_000 if model.config.remat
            else 1_000_000_000)

    return loss_fn


class GPT2ForTraining(nn.Module):
    """Engine-ready GPT-2: ``initialize(model=GPT2ForTraining(cfg))``;
    ``forward(batch)`` returns the mean next-token loss. Weights as in
    :class:`GPT2LMHeadModel` (``seed``, ``device="meta"`` for none)."""

    def __init__(self, config: GPT2Config, device=None, seed: int = 0):
        super().__init__()
        if config.decode:
            raise ValueError("GPT2ForTraining needs a config without decode")
        self.config = config
        self.model = GPT2LMHeadModel(config, device=device, seed=seed)
        self.loss_fn = gpt2_loss_fn(self.model)

    def forward(self, batch):
        return self.loss_fn(batch)


__all__ = ["GPT2Config", "GPT2LMHeadModel", "GPT2ForTraining", "KVCache",
           "PagedKVCache", "Block", "MLP", "CausalSelfAttention",
           "chunked_softmax_xent", "cross_entropy_loss", "gpt2_loss_fn",
           "head_logits", "lm_head_loss", "shift_labels"]
