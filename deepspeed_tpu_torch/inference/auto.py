"""Arch-detecting inference entry: HF checkpoint -> inference engine
(counterpart of ``deepspeed_tpu/inference/auto.py``)::

    engine = deepspeed_tpu_torch.inference.from_pretrained(
        "/path/to/hf-llama", dtype=torch.bfloat16)
    out = engine.generate(ids, max_new_tokens=64)

The architecture is detected from the checkpoint's weight names and the
matching tp injection policy is chosen. The Llama family loads today; the
canonical-decoder family (GPT-2, OPT, BLOOM, GPT-J, GPT-NeoX, GPT-Neo)
comes with [12.1] and CLIP's dual-encoder engine with [12.5], and each
raises ``NotImplementedError`` naming its item.
"""

from typing import Optional

from deepspeed_tpu_torch.runtime.state_dict_factory import (
    _LATER, SDLoaderFactory, _later, detect_arch, load_hf_llama)
from deepspeed_tpu_torch.utils.logging import logger

_POLICY_FOR_ARCH = {"llama": "llama"}


def load_pretrained(src, arch: Optional[str] = None, dtype=None,
                    **loader_kw):
    """``(model, state_dict, arch)`` from an HF checkpoint (a directory, a
    weights file or a state dict), the architecture detected when
    ``arch`` is omitted: ``model`` holds the checkpoint's weights (fp32 on
    the CPU: :func:`~deepspeed_tpu_torch.runtime.state_dict_factory.
    load_hf_llama`'s state dict, the same tensors). The checkpoint is
    read once; the loader finds config.json from ``src``."""
    sd = SDLoaderFactory.load(src)
    arch = arch or detect_arch(sd)
    if arch in _LATER:
        raise _later(arch, "from_pretrained")
    if arch not in _POLICY_FOR_ARCH:
        raise ValueError(
            f"unsupported architecture {arch!r}; supported: "
            f"{sorted(_POLICY_FOR_ARCH)} (auto-detected from weight names "
            "when arch is omitted)")
    from deepspeed_tpu_torch.models.llama import LlamaModel

    config, state = load_hf_llama(src, dtype=dtype, state_dict=sd,
                                  **loader_kw)
    model = LlamaModel(config, device="meta")
    model.load_state_dict(state, assign=True)
    logger.info(f"load_pretrained: arch={arch}")
    return model, state, arch


def from_pretrained(src, arch: Optional[str] = None, dtype=None,
                    loader_kw=None, **engine_kw):
    """One-call inference engine for an HF checkpoint (the reference's
    ``init_inference`` + policy + loader flow): the model of
    :func:`load_pretrained` through ``init_inference(model,
    injection_policy=<the arch's>, dtype=dtype, **engine_kw)``."""
    import deepspeed_tpu_torch

    model, _, arch = load_pretrained(src, arch=arch, dtype=dtype,
                                     **(loader_kw or {}))
    engine_kw.setdefault("injection_policy", _POLICY_FOR_ARCH[arch])
    if dtype is not None:
        engine_kw.setdefault("dtype", dtype)
    return deepspeed_tpu_torch.init_inference(model, **engine_kw)
