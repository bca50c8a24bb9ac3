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

:func:`params_to_jax`, :func:`bert_params_to_jax` and
:func:`llama_params_to_jax` are the inverse maps: the port's whole state
dict back to the JAX model's flax tree (layers stacked on a leading axis
under ``scan_layers``, else one sub-tree a layer; Dense kernels ``[in,
out]``; JAX's names), each leaf a contiguous CPU tensor of the state
dict's dtype. ``x_to_jax(x_from_jax(tree))`` is ``tree`` exactly.
:func:`training_params_to_jax` / :func:`training_params_from_jax` apply
them to a training wrapper's state dict (``model.``-prefixed names) by
the wrapped model's family: the layout of the checkpoints both packages
write.
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


# ---------------------------------------------------------------------------
# the inverse maps: the port's state dict -> the JAX model's flax tree
# ---------------------------------------------------------------------------
def _jax_leaf(t):
    t = t.detach()
    return (t if t.device.type == "meta" else t.cpu()).contiguous()


def _kernel(weight):
    """A flax Dense kernel ``[in, out]`` from an ``nn.Linear`` weight."""
    return _jax_leaf(weight.detach().T)


def _blocks(layers, scan: bool, stacked_key, layer_key):
    """``{stacked_key: {"<block>": stacked}}`` from per-layer sub-trees
    (scanned), else ``{layer_key(i): layer}``."""
    if not scan:
        return {layer_key(i): layer for i, layer in enumerate(layers)}
    return {stacked_key[0]: {stacked_key[1]: _stack(layers)}}


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return torch.stack(layers).contiguous()


def params_to_jax(state_dict, config) -> dict:
    """The JAX GPT-2's flax params (the bare tree) from the port's whole
    ``GPT2LMHeadModel`` state dict; stacked under ``transformer/h/block``
    with ``config.scan_layers``, else under ``transformer/h_<i>``."""
    sd = state_dict
    layers = []
    for i in range(config.n_layer):
        layer = {mod: {} for mod, _ in _DENSE}
        for mod, name in _DENSE:
            layer[mod][name] = {
                "kernel": _kernel(sd[f"h.{i}.{mod}.{name}.weight"]),
                "bias": _jax_leaf(sd[f"h.{i}.{mod}.{name}.bias"])}
        for name in _NORMS:
            layer[name] = {"scale": _jax_leaf(sd[f"h.{i}.{name}.weight"]),
                           "bias": _jax_leaf(sd[f"h.{i}.{name}.bias"])}
        layers.append(layer)
    return {"wte": _jax_leaf(sd["wte"]), "wpe": _jax_leaf(sd["wpe"]),
            "ln_f": {"scale": _jax_leaf(sd["ln_f.weight"]),
                     "bias": _jax_leaf(sd["ln_f.bias"])},
            "transformer": _blocks(layers, config.scan_layers,
                                   ("h", "block"), lambda i: f"h_{i}")}


def _flax_tree(entries):
    """A flax sub-tree from state-dict entries ``{rest: tensor}`` of one
    scope: ``<m>.weight`` / ``<m>.bias`` of a LayerNorm (a module named
    ``*_ln``) become ``scale`` / ``bias``, of a Linear ``kernel`` /
    ``bias``; a bare tensor keeps its name."""
    tree = {}
    for rest, t in entries.items():
        parts = rest.split(".")
        node = tree
        if parts[-1] in ("weight", "bias"):
            *mods, leaf = parts
            if leaf == "weight":
                leaf = "scale" if mods[-1].endswith("_ln") else "kernel"
                t = _jax_leaf(t) if leaf == "scale" else _kernel(t)
            else:
                t = _jax_leaf(t)
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = t
        else:
            for m in parts[:-1]:
                node = node.setdefault(m, {})
            node[parts[-1]] = _jax_leaf(t)
    return tree


def bert_params_to_jax(state_dict, config) -> dict:
    """The JAX BERT's flax params (``BertForMaskedLM``, or
    ``BertForSequenceClassification`` with ``pooler`` / ``classifier``)
    from the port's whole state dict; the encoder layers stacked under
    ``bert/encoder/layers/layer`` with ``config.scan_layers`` (JAX's
    default), else under ``bert/encoder/layer_<i>``."""
    prefix = "bert.encoder.layers."
    rest = {k: v for k, v in state_dict.items() if not k.startswith(prefix)}
    tree = _flax_tree(rest)
    layers = []
    for i in range(config.num_hidden_layers):
        p = f"{prefix}{i}."
        layers.append(_flax_tree({k[len(p):]: v for k, v in
                                  state_dict.items() if k.startswith(p)}))
    tree.setdefault("bert", {})["encoder"] = _blocks(
        layers, config.scan_layers, ("layers", "layer"),
        lambda i: f"layer_{i}")
    return tree


def llama_params_to_jax(state_dict, config) -> dict:
    """The JAX Llama's flax params (``LlamaModel``) from the port's whole
    state dict; blocks stacked under ``layers/block`` with
    ``config.scan_layers``, else under ``layers_<i>``; ``lm_head`` only
    when the head is untied."""
    sd = state_dict
    tree = {"embed_tokens": _jax_leaf(sd["embed_tokens"]),
            "norm": {"scale": _jax_leaf(sd["norm.weight"])}}
    if not config.tie_word_embeddings:
        tree["lm_head"] = _jax_leaf(sd["lm_head.weight"])
    layers = []
    for i in range(config.num_hidden_layers):
        p = f"layers.{i}."
        layer = {norm: {"scale": _jax_leaf(sd[f"{p}{norm}.weight"])}
                 for norm in ("input_layernorm",
                              "post_attention_layernorm")}
        for mod, names in (("self_attn", ("q_proj", "k_proj", "v_proj",
                                          "o_proj")),
                           ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            layer[mod] = {name: {"kernel": _kernel(
                sd[f"{p}{mod}.{name}.weight"])} for name in names}
        layers.append(layer)
    tree.update(_blocks(layers, config.scan_layers, ("layers", "block"),
                        lambda i: f"layers_{i}"))
    return tree


# ---------------------------------------------------------------------------
# training wrappers: the layout of the checkpoints both packages write
# ---------------------------------------------------------------------------
def model_family(model):
    """``"gpt2"``, ``"bert"`` or ``"llama"`` by the wrapped model's
    config; None for a model the JAX package has no tree for."""
    config = getattr(getattr(model, "model", model), "config", None)
    name = type(config).__name__
    return {"GPT2Config": "gpt2", "BertConfig": "bert",
            "LlamaConfig": "llama"}.get(name)


def training_params_to_jax(model, state_dict):
    """The JAX training model's flax params from a port training
    wrapper's whole state dict (``model.<name>`` entries; optimizer slots
    named alike map the same way, so a tied Llama's slot dict may lack
    ``lm_head``); None for a model of another family."""
    family = model_family(model)
    if family is None:
        return None
    inner = {k[len("model."):]: v for k, v in state_dict.items()
             if k.startswith("model.")}
    config = model.model.config
    if family == "gpt2":
        return params_to_jax(inner, config)
    if family == "bert":
        return bert_params_to_jax(inner, config)
    if config.tie_word_embeddings and "lm_head.weight" not in inner:
        inner["lm_head.weight"] = inner["embed_tokens"]
    return llama_params_to_jax(inner, config)


def training_params_from_jax(model, tree) -> dict:
    """A port training wrapper's state dict (``model.<name>`` entries,
    fp32 CPU tensors) from the JAX training model's flax params."""
    config = model.model.config
    family = model_family(model)
    if family == "gpt2":
        sd = params_from_jax(tree, config)
    elif family == "bert":
        sd = bert_params_from_jax(tree, config)
    else:
        sd = llama_params_from_jax(tree, config)
    return {f"model.{k}": v for k, v in sd.items()}
