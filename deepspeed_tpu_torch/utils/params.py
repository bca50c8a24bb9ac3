"""Weights of the JAX package's GPT-2 in the port's layout.

:func:`params_from_jax` turns the flax parameter tree of
``deepspeed_tpu.models.gpt2.GPT2LMHeadModel`` — as numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, params)`` — into a state dict for
:class:`deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel`. Two layout facts
drive it:

- with ``scan_layers=True`` (the JAX default) the block parameters sit
  under ``transformer/h/block`` stacked on a leading layer axis; with
  ``scan_layers=False`` under ``transformer/h_<i>``;
- a flax ``Dense`` kernel is ``[in, out]``, an ``nn.Linear`` weight
  ``[out, in]``; LayerNorm ``scale`` is the ``weight``.

No JAX import: the tree is plain nested dicts of numpy arrays. With
``tp_size`` above 1 it gives one tensor-parallel rank's slices
(:func:`shard_for_rank`), so both packages compute the same thing on
the same weights at any tp size.
:func:`training_model_from_jax` builds the port's
:class:`~deepspeed_tpu_torch.models.gpt2.GPT2ForTraining` on those weights
(the JAX training engine's ``GPT2ForTraining`` has the same tree).

:func:`bert_params_from_jax` does the same for the JAX BERT family
(``BertForMaskedLM``, which ``BertForTraining`` trains, and
``BertForSequenceClassification``): encoder layers under
``bert/encoder/layers/layer`` with a leading layer axis (scanned) or under
``bert/encoder/layer_<i>``; every Dense (``query``/``key``/``value``,
``output_dense``, ``intermediate``, ``output``, ``transform``, the pooler
and the classifier) becomes an ``nn.Linear``, every LayerNorm an
``nn.LayerNorm``, and the tables and ``decoder_bias`` stay as they are.

:func:`llama_params_from_jax` does the same for the JAX Llama
(``LlamaModel``, which ``LlamaForTraining`` trains): blocks under
``layers/block`` with a leading layer axis (scanned) or under
``layers_<i>``, each Dense kernel transposed into its ``nn.Linear``
weight, each RMSNorm ``scale`` a ``weight``; ``embed_tokens`` and an
untied ``lm_head`` (both ``[V, C]``) as they are, and under
``tie_word_embeddings`` the embedding again as ``lm_head.weight``.
"""

import numpy as np
import torch

_DENSE = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"),
          ("mlp", "c_proj"))
_NORMS = ("ln_1", "ln_2")


def _layer(tree, i: int):
    """Layer ``i``'s flax sub-tree (stacked or per-layer layout)."""
    blocks = tree["transformer"]
    if "h" in blocks:
        return {k: _index(v, i) for k, v in blocks["h"]["block"].items()}
    return blocks[f"h_{i}"]


def _index(node, i):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return node[i]


def params_from_jax(tree, config, tp_rank: int = 0, tp_size: int = 1,
                    policy="auto") -> dict:
    """State dict of the port's GPT-2 (fp32 tensors on the CPU) from the
    JAX model's flax params (``{"params": ...}`` or the bare tree); with
    ``tp_size`` above 1, tp rank ``tp_rank``'s slices of it (the ones the
    inference engine keeps under ``policy``: :func:`shard_for_rank`)."""
    if tp_size > 1:
        return shard_for_rank(params_from_jax(tree, config), config,
                              tp_rank, tp_size, policy)
    tree = tree.get("params", tree)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {"wte": t(tree["wte"]), "wpe": t(tree["wpe"]),
          "ln_f.weight": t(tree["ln_f"]["scale"]),
          "ln_f.bias": t(tree["ln_f"]["bias"])}
    for i in range(config.n_layer):
        layer = _layer(tree, i)
        for mod, name in _DENSE:
            dense = layer[mod][name]
            sd[f"h.{i}.{mod}.{name}.weight"] = t(dense["kernel"]).T \
                .contiguous()
            sd[f"h.{i}.{mod}.{name}.bias"] = t(dense["bias"])
        for name in _NORMS:
            sd[f"h.{i}.{name}.weight"] = t(layer[name]["scale"])
            sd[f"h.{i}.{name}.bias"] = t(layer[name]["bias"])
    return sd


def shard_for_rank(state_dict, config, tp_rank: int, tp_size: int,
                   policy="auto") -> dict:
    """Tp rank ``tp_rank``'s slices of the port's whole GPT-2
    ``state_dict`` at ``tp_size`` ranks: the specs of
    :meth:`~deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel.tp_specs`,
    the fused ``c_attn`` split per Q, K and V."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    from deepspeed_tpu_torch.module_inject.policies import \
        shard_params_with_policy

    specs = GPT2LMHeadModel(config, device="meta").tp_specs(policy, tp_size)
    return shard_params_with_policy(state_dict, policy, tp_rank, tp_size,
                                    specs=specs)[0]


def training_model_from_jax(tree, config):
    """The port's ``GPT2ForTraining(config)`` holding the JAX model's
    weights (fp32, on the CPU; the engine moves them to its device)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForTraining

    model = GPT2ForTraining(config, device="meta")
    model.model.load_state_dict(params_from_jax(tree, config), assign=True)
    return model


def _flax_modules(node, prefix, sd, t):
    """State-dict entries of a flax sub-tree: a Dense (``kernel``,
    ``bias``) becomes ``<prefix>.weight`` ``[out, in]`` and ``.bias``, a
    LayerNorm (``scale``, ``bias``) ``.weight`` and ``.bias``; a bare
    array keeps its name."""
    if not isinstance(node, dict):
        sd[prefix] = t(node)
    elif "kernel" in node:
        sd[f"{prefix}.weight"] = t(node["kernel"]).T.contiguous()
        sd[f"{prefix}.bias"] = t(node["bias"])
    elif "scale" in node:
        sd[f"{prefix}.weight"] = t(node["scale"])
        sd[f"{prefix}.bias"] = t(node["bias"])
    else:
        for name, child in node.items():
            _flax_modules(child, f"{prefix}.{name}" if prefix else name, sd,
                          t)


def bert_params_from_jax(tree, config) -> dict:
    """State dict of the port's ``BertForMaskedLM`` (or
    ``BertForSequenceClassification``, whose tree has ``pooler`` and
    ``classifier``) — fp32 tensors on the CPU — from the JAX model's flax
    params (``{"params": ...}`` or the bare tree)."""
    tree = dict(tree.get("params", tree))

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    bert = dict(tree.pop("bert"))
    encoder = bert.pop("encoder")
    sd = {}
    _flax_modules({"bert": bert, **tree}, "", sd, t)
    for i in range(config.num_hidden_layers):
        layer = (_index(encoder["layers"]["layer"], i)
                 if "layers" in encoder else encoder[f"layer_{i}"])
        _flax_modules(layer, f"bert.encoder.layers.{i}", sd, t)
    return sd


def bert_training_model_from_jax(tree, config):
    """The port's ``BertForTraining(config)`` holding the JAX model's
    weights (fp32, on the CPU; the engine moves them to its device)."""
    from deepspeed_tpu_torch.models.bert import BertForTraining

    model = BertForTraining(config, device="meta")
    model.model.load_state_dict(bert_params_from_jax(tree, config),
                                assign=True)
    return model


def _llama_layer(tree, i: int):
    """Llama layer ``i``'s flax sub-tree (stacked or per-layer layout)."""
    if "layers" in tree:
        return _index(tree["layers"]["block"], i)
    return tree[f"layers_{i}"]


def llama_params_from_jax(tree, config, tp_rank: int = 0, tp_size: int = 1,
                          policy="auto") -> dict:
    """State dict of the port's ``LlamaModel`` (fp32 tensors on the CPU)
    from the JAX model's flax params (``{"params": ...}`` or the bare
    tree), scanned or unrolled; with ``tp_size`` above 1, tp rank
    ``tp_rank``'s slices of it under ``policy`` (the ones the inference
    engine keeps: :meth:`~deepspeed_tpu_torch.models.llama.LlamaModel.
    tp_specs`)."""
    if tp_size > 1:
        from deepspeed_tpu_torch.models.llama import LlamaModel
        from deepspeed_tpu_torch.module_inject.policies import \
            shard_params_with_policy

        specs = LlamaModel(config, device="meta").tp_specs(policy, tp_size)
        return shard_params_with_policy(
            llama_params_from_jax(tree, config), policy, tp_rank, tp_size,
            specs=specs)[0]
    tree = tree.get("params", tree)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {"embed_tokens": t(tree["embed_tokens"]),
          "norm.weight": t(tree["norm"]["scale"])}
    sd["lm_head.weight"] = (sd["embed_tokens"] if config.tie_word_embeddings
                            else t(tree["lm_head"]))
    for i in range(config.num_hidden_layers):
        layer = _llama_layer(tree, i)
        p = f"layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{p}{norm}.weight"] = t(layer[norm]["scale"])
        for mod, names in (("self_attn", ("q_proj", "k_proj", "v_proj",
                                          "o_proj")),
                           ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                sd[f"{p}{mod}.{name}.weight"] = t(
                    layer[mod][name]["kernel"]).T.contiguous()
    return sd


def llama_training_model_from_jax(tree, config):
    """The port's ``LlamaForTraining(config)`` holding the JAX model's
    weights (fp32, on the CPU; the engine moves them to its device)."""
    from deepspeed_tpu_torch.models.llama import LlamaForTraining

    model = LlamaForTraining(config, device="meta")
    model.model.load_state_dict(llama_params_from_jax(tree, config),
                                assign=True)
    return model
