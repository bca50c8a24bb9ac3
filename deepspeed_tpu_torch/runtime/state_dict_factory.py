"""State-dict factory: HF checkpoint ingestion (counterpart of
``deepspeed_tpu/runtime/state_dict_factory.py``: the reference
``SDLoaderFactory`` and the Llama loader).

- :class:`SDLoaderFactory` reads a checkpoint into ``{name: tensor}``: a
  dict, a ``.bin`` / ``.pt`` torch file (``torch.load(weights_only=
  True)``), an ``.npz`` (bf16 stored as 16-bit views beside a
  ``__bf16_keys__`` list, as the JAX package writes it), a ``.safetensors``
  file where the ``safetensors`` package is installed, or an HF model
  directory (its sharded index first).
- The port's models keep HF's module names and ``nn.Linear``'s ``[out,
  in]`` weights, so a Llama checkpoint needs no name map: the loader
  drops the ``model.`` prefix. :func:`detect_arch` names a checkpoint's
  architecture; the loaders of the canonical-decoder family (GPT-2, OPT,
  BLOOM, GPT-J, GPT-NeoX, GPT-Neo) come with [12.1], BERT's with [12.3]
  and CLIP's with [12.5].
- :func:`load_hf_llama` gives ``(LlamaConfig, state dict)`` for
  ``models/llama.py:LlamaModel``; :func:`export_hf_llama` is its inverse
  (the HF ``LlamaForCausalLM`` names) and :func:`save_hf_llama` writes an
  HF directory (``pytorch_model.bin`` and ``config.json``).

The fused-QKV pair for tensor parallelism (the reference
``MegatronSDLoader`` merge and split): a fused QKV projection
concatenates Q, K and V along its output features. A tp rank must hold
heads of all three, so the split takes EACH of Q, K and V apart (a plain
split of the fused dim would give rank 0 all of Q and half of K).
``out_axis`` is the output-feature dim: the last one of a flax ``Dense``
kernel ``[in, 3C]``, dim 0 of an ``nn.Linear`` weight ``[3C, in]`` and of
a bias.
"""

import functools
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger


def shard_qkv_for_tp(fused: torch.Tensor, tp_size: int, rank: int,
                     out_axis: int = -1) -> torch.Tensor:
    """Rank ``rank``'s slice of a fused QKV tensor: its ``1/tp_size`` of
    each of Q, K and V, concatenated in that order."""
    qkv = fused.chunk(3, dim=out_axis)
    return torch.cat([x.chunk(tp_size, dim=out_axis)[rank] for x in qkv],
                     dim=out_axis)


def merge_qkv_tp_shards(shards, out_axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`shard_qkv_for_tp`: the per-rank fused shards (in
    rank order) back into the whole fused tensor."""
    per_rank = [s.chunk(3, dim=out_axis) for s in shards]
    return torch.cat([torch.cat([r[i] for r in per_rank], dim=out_axis)
                      for i in range(3)], dim=out_axis)


# ----------------------------------------------------------------------
# raw checkpoint loading


def _to_tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(t)))


class SDLoaderFactory:
    """Entry point (reference ``SDLoaderFactory.get_sd_loader_json``)."""

    @staticmethod
    def load(src) -> Dict[str, torch.Tensor]:
        """``{name: tensor}`` (on the CPU, in the stored dtype) from: a
        dict (torch or numpy values), an ``.npz`` / ``.bin`` / ``.pt`` /
        ``.safetensors`` file, or an HF model directory holding one of
        those or a sharded checkpoint's index."""
        if isinstance(src, dict):
            return {k: _to_tensor(v) for k, v in src.items()}
        path = str(src)
        if os.path.isdir(path):
            # HF sharded checkpoints (how every large model ships): the
            # index's weight_map names the shard file of each tensor
            for idx_name in ("model.safetensors.index.json",
                             "pytorch_model.bin.index.json"):
                idx_path = os.path.join(path, idx_name)
                if os.path.exists(idx_path):
                    with open(idx_path) as f:
                        weight_map = json.load(f)["weight_map"]
                    out = {}
                    for shard in sorted(set(weight_map.values())):
                        out.update(SDLoaderFactory.load(
                            os.path.join(path, shard)))
                    return out
            for name in ("model.safetensors", "pytorch_model.bin",
                         "weights.npz"):
                cand = os.path.join(path, name)
                if os.path.exists(cand):
                    path = cand
                    break
            else:
                raise FileNotFoundError(
                    f"no checkpoint file found under {path!r}")
        if path.endswith(".npz"):
            with np.load(path) as z:
                # bf16 tensors stored as 16-bit views plus this sidecar key
                bf16 = set(np.atleast_1d(z["__bf16_keys__"]).tolist()) \
                    if "__bf16_keys__" in z.files else set()
                return {k: (torch.from_numpy(z[k].view(np.int16))
                            .view(torch.bfloat16) if k in bf16
                            else torch.from_numpy(z[k]))
                        for k in z.files if k != "__bf16_keys__"}
        if path.endswith(".safetensors"):
            try:
                from safetensors.torch import load_file
            except ImportError as e:
                raise ImportError(
                    f"{path!r} is a safetensors checkpoint and the "
                    f"safetensors package is not installed: install it, or "
                    f"save the checkpoint as pytorch_model.bin") from e
            return load_file(path)
        # torch pickle (pytorch_model.bin / *.pt)
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return {k: _to_tensor(v) for k, v in sd.items()}


# ----------------------------------------------------------------------
# architectures


# the architectures whose loaders come with later slices
_LATER = {"gpt2": "[12.1]", "opt": "[12.1]", "bloom": "[12.1]",
          "gptj": "[12.1]", "gpt-neox": "[12.1]", "gpt-neo": "[12.1]",
          "bert": "[12.3]", "clip": "[12.5]"}


def _later(arch: str, what: str):
    return NotImplementedError(
        f"{what} for {arch!r} checkpoints is not ported yet: it comes with "
        f"{_LATER[arch]} of the PyTorch port (the Llama family loads today)")


def detect_arch(sd) -> Optional[str]:
    """The architecture of a state dict, from its weight names (None when
    none matches)."""
    keys = list(sd)
    if any("attn.c_attn" in k for k in keys):
        return "gpt2"
    if any("self_attn.q_proj" in k and "decoder" in k for k in keys):
        return "opt"
    if any("self_attention.query_key_value" in k for k in keys):
        return "bloom"
    if any("mlp.gate_proj" in k for k in keys):
        return "llama"
    if any("mlp.fc_in" in k for k in keys):
        return "gptj"
    if any("attn.attention.q_proj" in k for k in keys):
        return "gpt-neo"
    if any("attention.query_key_value" in k for k in keys):
        return "gpt-neox"
    if any("attention.self.query" in k for k in keys):
        return "bert"
    if any(k.startswith("visual_projection")
           or "vision_model.encoder" in k for k in keys):
        return "clip"
    return None


# ----------------------------------------------------------------------
# config.json


@functools.lru_cache(maxsize=32)
def _load_config_json(path: str):
    # open/parse errors propagate: a present-but-unreadable config.json
    # must not silently degrade to default hyperparameters
    with open(path) as f:
        return json.load(f)


def _sniff_config(src, *keys):
    """First matching value from the model dir's config.json (``src`` may
    be a dir, a file inside one, or a non-path: then None). The json is
    parsed once per path however many keys get sniffed."""
    if not isinstance(src, (str, os.PathLike)):
        return None
    path = str(src)
    if not os.path.isdir(path):
        path = os.path.dirname(path)
    cfg_json = os.path.join(path, "config.json") if path else None
    if not cfg_json or not os.path.exists(cfg_json):
        return None
    hf = _load_config_json(cfg_json)
    for key in keys:
        if key in hf:
            return hf[key]
    return None


# ----------------------------------------------------------------------
# Llama


_LLAMA_LAYER_WEIGHTS = tuple(
    f"{n}.weight" for n in ("input_layernorm", "post_attention_layernorm",
                            "self_attn.q_proj", "self_attn.k_proj",
                            "self_attn.v_proj", "self_attn.o_proj",
                            "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"))


def load_hf_llama(src, dtype=None, num_attention_heads: Optional[int] = None,
                  num_key_value_heads: Optional[int] = None,
                  rope_theta: Optional[float] = None,
                  rms_norm_eps: Optional[float] = None,
                  max_position_embeddings: Optional[int] = None,
                  state_dict=None):
    """HF Llama checkpoint -> ``(LlamaConfig, state dict)`` for
    :class:`deepspeed_tpu_torch.models.llama.LlamaModel` (fp32 tensors on
    the CPU). For every config knob an explicit argument wins; unset knobs
    come from the model dir's config.json when present, else the Llama-2
    defaults. Pass head counts for bare state dicts (k_proj's out-dim
    reveals KV heads only up to the head dim). ``dtype`` is the config's
    compute dtype (fp32 by default); a checkpoint without ``lm_head``
    gives a tied config. ``state_dict`` is ``src``'s checkpoint when the
    caller has read it already (config.json is still found from
    ``src``)."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig

    def knob(value, key, default=None):
        if value is None:
            value = _sniff_config(src, key)
        return default if value is None else value

    sd = SDLoaderFactory.load(src if state_dict is None else state_dict)
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}
    n_layer = 1 + max((int(k.split(".")[1]) for k in sd
                       if k.startswith("layers.")), default=-1)
    embed = sd["embed_tokens.weight"]
    hidden = embed.shape[1]
    heads = knob(num_attention_heads, "num_attention_heads",
                 max(1, hidden // 128))
    kv_dim = sd["layers.0.self_attn.k_proj.weight"].shape[0]
    kv_heads = knob(num_key_value_heads, "num_key_value_heads",
                    max(1, kv_dim // (hidden // heads)))
    tied = "lm_head.weight" not in sd
    config = LlamaConfig(
        vocab_size=embed.shape[0], hidden_size=hidden,
        intermediate_size=sd["layers.0.mlp.gate_proj.weight"].shape[0],
        num_hidden_layers=n_layer, num_attention_heads=heads,
        num_key_value_heads=kv_heads,
        rope_theta=knob(rope_theta, "rope_theta", 10000.0),
        rms_norm_eps=knob(rms_norm_eps, "rms_norm_eps", 1e-5),
        max_position_embeddings=knob(max_position_embeddings,
                                     "max_position_embeddings", 4096),
        tie_word_embeddings=tied,
        dtype=dtype if dtype is not None else torch.float32)

    def f32(t):
        return t.to(torch.float32).contiguous()

    state = {"embed_tokens": f32(embed), "norm.weight": f32(sd["norm.weight"])}
    state["lm_head.weight"] = (state["embed_tokens"] if tied
                               else f32(sd["lm_head.weight"]))
    for i in range(n_layer):
        for name in _LLAMA_LAYER_WEIGHTS:
            state[f"layers.{i}.{name}"] = f32(sd[f"layers.{i}.{name}"])
    logger.info(f"loaded HF Llama: {n_layer} layers, hidden={hidden}, "
                f"heads={heads}/{kv_heads}kv, vocab={embed.shape[0]}")
    return config, state


def export_hf_llama(state_dict, dtype=torch.float32) -> Dict[str,
                                                               torch.Tensor]:
    """The port's Llama state dict (``LlamaModel``'s, or a
    ``LlamaForTraining``'s under ``model.``) -> an HF ``LlamaForCausalLM``
    state dict, each tensor cast to ``dtype`` (None keeps it) and on the
    CPU. A tied model writes its table as ``lm_head.weight`` too, as the
    JAX exporter does (HF re-ties on load; :func:`load_hf_llama` reads it
    back as a separate head of the same values)."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in state_dict.items()}

    def out(t):
        t = t.detach().cpu()
        return (t if dtype is None else t.to(dtype)).contiguous()

    hf = {"model.embed_tokens.weight": out(sd["embed_tokens"]),
          "model.norm.weight": out(sd["norm.weight"]),
          "lm_head.weight": out(sd.get("lm_head.weight",
                                       sd["embed_tokens"]))}
    for name, t in sd.items():
        if name.startswith("layers."):
            hf["model." + name] = out(t)
    return hf


def hf_llama_config(config) -> dict:
    """The ``config.json`` of an HF ``LlamaForCausalLM`` for a
    ``LlamaConfig``."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": config.vocab_size,
            "hidden_size": config.hidden_size,
            "intermediate_size": config.intermediate_size,
            "num_hidden_layers": config.num_hidden_layers,
            "num_attention_heads": config.num_attention_heads,
            "num_key_value_heads": config.kv_heads,
            "max_position_embeddings": config.max_position_embeddings,
            "rms_norm_eps": config.rms_norm_eps,
            "rope_theta": config.rope_theta,
            "tie_word_embeddings": config.tie_word_embeddings,
            "hidden_act": "silu", "attention_bias": False,
            "mlp_bias": False}


def save_hf_llama(path, config, state_dict, dtype=torch.float32):
    """Write an HF model directory: ``pytorch_model.bin`` (the
    :func:`export_hf_llama` tensors in ``dtype``) and ``config.json``."""
    os.makedirs(path, exist_ok=True)
    torch.save(export_hf_llama(state_dict, dtype),
               os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_llama_config(config), f, indent=1)
    return path
