"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

It mirrors the JAX package's module paths, imports ``torch`` and never
``jax`` or ``deepspeed_tpu``, and runs on the card unless the caller
passes ``device="cpu"``. This slice holds the serving path: GPT-2 with
hand-written flash-prefill and decode-attention kernels for Hopper
(``csrc/``), the inference engine's ``generate()`` and the
continuous-batching serving engine.
"""

def init_inference(model, config=None, **kwargs):
    """Build an :class:`~deepspeed_tpu_torch.inference.engine.
    InferenceEngine` (``device=None`` is the card)."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    return InferenceEngine(model, config=config, **kwargs)


def init_serving(model, config=None, **kwargs):
    """Build the continuous-batching serving engine (paged KV cache +
    request scheduler) over an inference engine: ``model`` is a model
    (a fresh engine is built from ``config``/``kwargs``, which must carry
    a ``serving`` block) or an existing InferenceEngine whose config has
    one. The multi-replica router, fleet and gateway blocks come with the
    multi-GPU serving slice and raise at config time."""
    from deepspeed_tpu_torch.serving.engine import ServingEngine

    return ServingEngine(model, config=config, **kwargs)
