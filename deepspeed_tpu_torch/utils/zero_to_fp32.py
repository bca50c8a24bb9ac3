"""Reference import path ``deepspeed.utils.zero_to_fp32`` (counterpart
of ``deepspeed_tpu/utils/zero_to_fp32.py``):
``get_fp32_state_dict_from_zero_checkpoint`` /
``convert_zero_checkpoint_to_fp32_state_dict`` (in
:mod:`deepspeed_tpu_torch.checkpoint`) and
``load_state_dict_from_zero_checkpoint``.
"""

import torch

from deepspeed_tpu_torch.checkpoint.deepspeed_checkpoint import (
    convert_zero_checkpoint_to_fp32_state_dict,
    get_fp32_state_dict_from_zero_checkpoint)


def load_state_dict_from_zero_checkpoint(model, checkpoint_dir, tag=None):
    """Consolidate a checkpoint of either package to fp32 and load it
    into ``model``: a port training wrapper or model of a family the JAX
    package has (GPT-2, BERT, Llama) takes its weights through the
    inverse of the checkpoint's flax layout (``utils/params.py``); any
    other module with ``load_state_dict`` takes the file's flat names."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine \
        import unflatten_by_paths
    from deepspeed_tpu_torch.utils import params as P

    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=tag)
    family = P.model_family(model)
    if family is None:
        if not hasattr(model, "load_state_dict"):
            raise TypeError(
                "model must expose load_state_dict(...); for raw trees "
                "call get_fp32_state_dict_from_zero_checkpoint")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in sd.items()})
        return model
    tree = unflatten_by_paths(sd, "")
    if hasattr(model, "model") and hasattr(model.model, "config"):
        model.load_state_dict(P.training_params_from_jax(model, tree))
        return model
    from_jax = {"gpt2": P.params_from_jax, "bert": P.bert_params_from_jax,
                "llama": P.llama_params_from_jax}[family]
    model.load_state_dict(from_jax(tree, model.config))
    return model


__all__ = [
    "convert_zero_checkpoint_to_fp32_state_dict",
    "get_fp32_state_dict_from_zero_checkpoint",
    "load_state_dict_from_zero_checkpoint",
]
