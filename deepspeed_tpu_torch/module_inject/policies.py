"""Tensor-parallel policies (counterpart of ``deepspeed_tpu/module_inject/
policies.py``): parameter paths -> tp roles -> PartitionSpecs over the
``tp`` axis, which :class:`~deepspeed_tpu_torch.runtime.zero.partition.
SpecLayout` asks for each parameter's base spec.

Roles and families are the JAX package's. Paths may be the JAX ones
(``transformer/h_0/attn/c_attn/kernel``) or the port's state-dict names
(``model.h.0.attn.c_attn.weight``): a path splits into segments at ``/``
and ``.``. Shapes are the port's: an ``nn.Linear`` weight is ``[out, in]``
where a flax ``Dense`` kernel is ``[in, out]``, so a column-parallel
weight shards its dim 0 and a row-parallel one its dim 1.

At a tp size of 1 every base spec is replicated (None). Above 1, the
inference and training engines ask :func:`shard_params_with_policy` for
this rank's slices of a whole state dict (a fused QKV weight split per Q,
K and V), and the models hold them in the column- and row-parallel
layers of ``layers.py``; :func:`gather_params_with_policy` puts the whole
state dict back together from every rank's slices (the training engine's
``module_state_dict``); :func:`decode_cache_specs` splits the KV caches
and pools on their head dim.
"""

import re
from typing import Dict, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.parallel.topology import AXIS_TP
from deepspeed_tpu_torch.runtime.state_dict_factory import (
    merge_qkv_tp_shards, shard_qkv_for_tp)
from deepspeed_tpu_torch.runtime.zero.partition import PartitionSpec as P

COLUMN = "column"
ROW = "row"
VOCAB = "vocab"
REPLICATE = "replicate"

FAMILY_EMBED = "embedding"
FAMILY_ATTN_QKV = "attn_qkv"
FAMILY_ATTN_PROJ = "attn_proj"
FAMILY_MLP_IN = "mlp_in"
FAMILY_MLP_OUT = "mlp_out"
FAMILY_NORM = "norm"
FAMILY_OTHER = "other"

_ATTN_PARENTS = {"attn", "attention", "self_attn", "self_attention",
                 "crossattention", "cross_attn"}
_NORM_SEGMENTS = {"ln", "ln_1", "ln_2", "ln_f", "emb_ln", "norm",
                  "layernorm", "layer_norm", "input_layernorm",
                  "post_attention_layernorm", "final_layer_norm",
                  "ln_attn", "ln_mlp"}


def _segments(path: str):
    return set(re.split(r"[/.]", path))


def family_for(path: str, shape: Tuple[int, ...], policy) -> str:
    """Parameter family of ``path`` under ``policy``."""
    segments = _segments(path)
    if _NORM_SEGMENTS & segments:
        return FAMILY_NORM
    role = policy.role_for(path)
    if role == VOCAB:
        return FAMILY_EMBED
    in_attn = bool(_ATTN_PARENTS & segments)
    if role == COLUMN:
        return FAMILY_ATTN_QKV if in_attn else FAMILY_MLP_IN
    if role == ROW:
        return FAMILY_ATTN_PROJ if in_attn else FAMILY_MLP_OUT
    return FAMILY_OTHER


class TPPolicy:
    """Ordered ``(segment_name, role)`` rules; a parameter whose path has
    ``segment_name`` as a full segment gets that role (first match)."""

    def __init__(self, name: str, rules: Sequence[Tuple[str, str]]):
        self.name = name
        self.rules = list(rules)

    def role_for(self, path: str) -> str:
        segments = _segments(path)
        for seg, role in self.rules:
            if seg in segments:
                return role
        return REPLICATE

    def spec_for(self, path: str, shape: Tuple[int, ...], tp_size: int,
                 axis: str = AXIS_TP) -> Optional[P]:
        """PartitionSpec of one parameter in the port's layout, or None
        (replicated)."""
        role = self.role_for(path)
        if role == REPLICATE or tp_size <= 1 or not shape:
            return None
        leaf = re.split(r"[/.]", path)[-1]
        is_bias = leaf in ("bias", "b") or len(shape) == 1
        if role == COLUMN:
            dim = 0  # output dim: [out, in] weights and their biases
        elif role == ROW:
            if is_bias:
                return None  # a row-parallel bias applies after the sum
            dim = len(shape) - 1  # input dim
        elif role == VOCAB:
            dim = max(range(len(shape)), key=lambda i: shape[i])
        else:
            raise ValueError(f"unknown TP role {role!r}")
        if shape[dim] % tp_size != 0:
            return None
        entries = [None] * len(shape)
        entries[dim] = axis
        return P(*entries)


_QKV_UP = [
    "c_attn", "q_proj", "k_proj", "v_proj", "qkv_proj", "query", "key",
    "value", "query_key_value", "c_fc", "fc1", "fc_in", "gate_proj",
    "up_proj", "dense_h_to_4h", "wi", "wi_0", "wi_1", "in_proj", "w1", "w3",
]
_OUT_DOWN = [
    "o_proj", "out_proj", "c_proj", "fc2", "fc_out", "down_proj",
    "dense_4h_to_h", "wo", "dense", "w2",
]
_EMBED = ["wte", "embed_tokens", "word_embeddings", "embedding", "lm_head",
          "shared", "embed_out"]

AUTO_POLICY = TPPolicy(
    "auto",
    [(s, ROW) for s in _OUT_DOWN]
    + [(s, COLUMN) for s in _QKV_UP]
    + [(s, VOCAB) for s in _EMBED])

GPT2_POLICY = TPPolicy(
    "gpt2",
    [("c_proj", ROW), ("c_attn", COLUMN), ("c_fc", COLUMN), ("wte", VOCAB),
     ("lm_head", VOCAB)])

LLAMA_POLICY = TPPolicy(
    "llama",
    [("o_proj", ROW), ("down_proj", ROW),
     ("q_proj", COLUMN), ("k_proj", COLUMN), ("v_proj", COLUMN),
     ("gate_proj", COLUMN), ("up_proj", COLUMN),
     ("embed_tokens", VOCAB), ("lm_head", VOCAB)])

OPT_POLICY = TPPolicy(
    "opt",
    [("out_proj", ROW), ("fc2", ROW),
     ("q_proj", COLUMN), ("k_proj", COLUMN), ("v_proj", COLUMN),
     ("fc1", COLUMN), ("embed_tokens", VOCAB), ("lm_head", VOCAB)])

BLOOM_POLICY = TPPolicy(
    "bloom",
    [("dense", ROW), ("dense_4h_to_h", ROW),
     ("query_key_value", COLUMN), ("dense_h_to_4h", COLUMN),
     ("word_embeddings", VOCAB), ("lm_head", VOCAB)])

GPTJ_POLICY = TPPolicy(
    "gptj",
    [("out_proj", ROW), ("fc_out", ROW),
     ("q_proj", COLUMN), ("k_proj", COLUMN), ("v_proj", COLUMN),
     ("fc_in", COLUMN), ("wte", VOCAB), ("lm_head", VOCAB)])

GPT_NEOX_POLICY = TPPolicy(
    "gpt-neox",
    [("dense", ROW), ("dense_4h_to_h", ROW),
     ("query_key_value", COLUMN), ("dense_h_to_4h", COLUMN),
     ("embed_in", VOCAB), ("embed_out", VOCAB)])

BERT_POLICY = TPPolicy(
    "bert",
    [("output_dense", ROW), ("output", ROW),
     ("query", COLUMN), ("key", COLUMN), ("value", COLUMN),
     ("intermediate", COLUMN), ("word_embeddings", VOCAB)])

CLIP_POLICY = TPPolicy(
    "clip",
    [("out_proj", ROW), ("fc2", ROW),
     ("q_proj", COLUMN), ("k_proj", COLUMN), ("v_proj", COLUMN),
     ("fc1", COLUMN), ("token_embedding", VOCAB)])

_POLICIES: Dict[str, TPPolicy] = {
    "auto": AUTO_POLICY, "gpt2": GPT2_POLICY, "llama": LLAMA_POLICY,
    "opt": OPT_POLICY, "bloom": BLOOM_POLICY, "gptj": GPTJ_POLICY,
    "gpt-neox": GPT_NEOX_POLICY, "bert": BERT_POLICY, "clip": CLIP_POLICY,
}


def register_tp_policy(policy: TPPolicy):
    """User plug point (reference ``injection_policy`` kwarg)."""
    _POLICIES[policy.name] = policy


def get_tp_policy(name="auto") -> TPPolicy:
    """A policy by name, a :class:`TPPolicy`, or the reference's
    ``injection_policy`` forms (the JAX engine's ``_resolve_policy``): a
    dict ``{module_or_segment: role}`` (``{"c_proj": "row"}``) or
    ``{module: ("attn.c_proj", ...)}`` naming row-parallel outputs, or a
    bare tuple of them (``injection_policy_tuple``); the user's rules go
    first, then the auto policy's. None is the auto policy."""
    if name is None:
        name = "auto"
    if isinstance(name, TPPolicy):
        return name
    if isinstance(name, (tuple, list)):
        name = {"_tuple": tuple(name)}
    if isinstance(name, dict):
        rules = []
        for key, val in name.items():
            if isinstance(val, str):
                rules.append((str(key), val))
            else:
                rules.extend((str(n).rsplit(".", 1)[-1], ROW) for n in val)
        return TPPolicy("user", rules + AUTO_POLICY.rules)
    if name not in _POLICIES:
        raise ValueError(
            f"unknown TP policy {name!r}; have {sorted(_POLICIES)}")
    return _POLICIES[name]


def specs_from_policy(policy: TPPolicy, named_shapes, mesh,
                      axis: str = AXIS_TP):
    """``{name: base spec or None}`` for ``{name: shape}``."""
    tp_size = int(mesh.shape.get(axis, 1))
    return {name: policy.spec_for(name, tuple(shape), tp_size, axis)
            for name, shape in dict(named_shapes).items()}


def shard_params_with_policy(state_dict, policy, tp_rank: int,
                             tp_size: int, specs=None,
                             axis: str = AXIS_TP):
    """``(local_state_dict, specs)``: rank ``tp_rank``'s slice of each
    tensor of a whole ``state_dict`` along the dim its spec splits over
    ``axis`` (``specs`` if given, else the policy's), the whole tensor
    where it is replicated. A tensor whose path has a ``c_attn`` segment
    is a fused Q|K|V projection and is split per Q, K and V
    (:func:`~deepspeed_tpu_torch.runtime.state_dict_factory.
    shard_qkv_for_tp`)."""
    if specs is None:
        policy = get_tp_policy(policy)
        specs = {name: policy.spec_for(name, tuple(t.shape), tp_size, axis)
                 for name, t in state_dict.items()}
    local = {}
    for name, t in state_dict.items():
        spec = specs.get(name)
        if spec is None:
            local[name] = t
            continue
        dim = next(i for i, e in enumerate(spec) if e is not None)
        if "c_attn" in _segments(name):
            local[name] = shard_qkv_for_tp(t, tp_size, tp_rank, out_axis=dim)
        else:
            local[name] = t.chunk(tp_size, dim=dim)[tp_rank].contiguous()
    return local, specs


def gather_params_with_policy(local_state_dict, specs, group):
    """The whole state dict from every rank's slices (the inverse of
    :func:`shard_params_with_policy` under the same ``specs``): one tiled
    all-gather over the tp ``group`` per split tensor (every rank of the
    group must call), the ``c_attn`` slices merged per Q, K and V
    (:func:`~deepspeed_tpu_torch.runtime.state_dict_factory.
    merge_qkv_tp_shards`); replicated tensors as they are."""
    from deepspeed_tpu_torch import comm

    whole = {}
    for name, t in local_state_dict.items():
        spec = specs.get(name)
        if spec is None:
            whole[name] = t
            continue
        dim = next(i for i, e in enumerate(spec) if e is not None)
        shards = list(comm.all_gather(t.contiguous(), group=group).unbind(0))
        whole[name] = (merge_qkv_tp_shards(shards, out_axis=dim)
                       if "c_attn" in _segments(name)
                       else torch.cat(shards, dim=dim))
    return whole


CACHE_LEAVES = ("keys", "values", "key_scales", "value_scales")


def decode_cache_specs(named_shapes, tp_size: int, axis: str = AXIS_TP):
    """``{name: spec or None}`` of a decode cache's tensors under tensor
    parallelism: the append caches ``[B, S, H, D]``, the block pools
    ``[num_blocks, block_size, H, D]`` and their int8 scale side pools
    ``[..., H, 1]`` (names whose first segment is one of
    :data:`CACHE_LEAVES`) split their head dim (-2) over ``axis`` when
    the heads divide, as the attention heads do: each tp rank owns its
    heads' pool. Everything else is replicated."""
    out = {}
    for name, shape in dict(named_shapes).items():
        spec = None
        if (re.split(r"[/.]", name)[0] in CACHE_LEAVES and tp_size > 1
                and len(shape) >= 2 and shape[-2] % tp_size == 0):
            entries = [None] * len(shape)
            entries[-2] = axis
            spec = P(*entries)
        out[name] = spec
    return out
