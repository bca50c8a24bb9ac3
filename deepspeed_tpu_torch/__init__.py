"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

It mirrors the JAX package's module paths, imports ``torch`` and never
``jax`` or ``deepspeed_tpu``, and runs on the card unless the caller
passes ``device="cpu"``. It holds the serving path (GPT-2 with
hand-written flash-prefill and decode-attention kernels for Hopper in
``csrc/``, the inference engine's ``generate()`` and the
continuous-batching serving engine with its fast path: prefix cache,
chunked prefill, speculative decoding and int8 paged KV) and the
one-card training path
(:func:`initialize`, the training engine with the fused step, AdamW/SGD/
LAMB, and the flash-attention backward kernels) for GPT-2 and for BERT,
whose ``sparse_attention`` config section routes attention through the
block-sparse layout zoo and its kernels (``ops/sparse_attention``).

``DeepSpeedEngine``, ``InferenceEngine``, ``SparseSelfAttention`` and
``SparseAttentionUtils`` resolve lazily from the package, as in the JAX
package (whose ``deepspeed.ops.sparse_attention`` path the port keeps).
"""


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mesh=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, device=None):
    """Build a training engine around ``model`` (an ``nn.Module`` whose
    ``forward(batch)`` returns the loss, e.g. ``models.gpt2.
    GPT2ForTraining`` or ``models.bert.BertForTraining``) on the card
    (``device=None``) or the CPU. A ``sparse_attention`` config section
    goes to the model's ``with_sparse_attention`` hook.

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``;
    the dataloader is None. ``mesh`` comes with the multi-GPU slice and
    ``training_data`` with the checkpoint slice (the data-loader cursor);
    every parameter of ``model`` is trained, so ``model_parameters`` is
    not taken."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    for name, value, where in (
            ("mesh", mesh, "the multi-GPU slice"),
            ("training_data", training_data, "the checkpoint slice"),
            ("collate_fn", collate_fn, "the checkpoint slice"),
            ("model_parameters", model_parameters,
             "no slice: the engine trains every parameter of the model")):
        if value is not None:
            raise NotImplementedError(
                f"initialize({name}=...) is not supported by the PyTorch "
                f"port: {where}")
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    engine = DeepSpeedEngine(model=model, optimizer=optimizer,
                             lr_scheduler=lr_scheduler, config=config,
                             device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler


def default_inference_config():
    """The default inference config as a plain dict."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig

    return DeepSpeedInferenceConfig().model_dump()


def init_inference(model, config=None, **kwargs):
    """Build an :class:`~deepspeed_tpu_torch.inference.engine.
    InferenceEngine` (``device=None`` is the card)."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    return InferenceEngine(model, config=config, **kwargs)


def init_serving(model, config=None, draft_model=None, **kwargs):
    """Build the continuous-batching serving engine (paged KV cache +
    request scheduler) over an inference engine: ``model`` is a model
    (a fresh engine is built from ``config``/``kwargs``, which must carry
    a ``serving`` block) or an existing InferenceEngine whose config has
    one. ``draft_model`` is the draft of ``serving.speculative``'s
    ``"draft_model"`` proposer: a callable ``(context, k) -> tokens`` or
    an engine with ``.generate`` (e.g. a small InferenceEngine). The
    multi-replica router, fleet and gateway blocks come with the
    multi-GPU serving slice and raise at config time."""
    from deepspeed_tpu_torch.serving.engine import ServingEngine

    return ServingEngine(model, config=config, draft_model=draft_model,
                         **kwargs)


def add_config_arguments(parser):
    """Add the ``--deepspeed`` / ``--deepspeed_config`` flags (and their
    deprecated ``--deepscale`` forms and ``--deepspeed_mpi``) to an
    ``argparse`` parser; :func:`initialize` reads ``args.
    deepspeed_config``."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag to indicate usage)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to DeepSpeed json configuration")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help="Deprecated enable flag")
    group.add_argument("--deepscale_config", default=None, type=str,
                       help="Deprecated config path")
    group.add_argument("--deepspeed_mpi", default=False, action="store_true",
                       help="Run via MPI discovery")
    return parser


def __getattr__(name):
    """Lazy top-level classes (the JAX package's ``__getattr__``), resolved
    on first touch so importing the package stays light."""
    lazy = {
        "DeepSpeedEngine": ("deepspeed_tpu_torch.runtime.engine",
                            "DeepSpeedEngine"),
        "InferenceEngine": ("deepspeed_tpu_torch.inference.engine",
                            "InferenceEngine"),
        "SparseSelfAttention": ("deepspeed_tpu_torch.ops.sparse_attention",
                                "SparseSelfAttention"),
        "SparseAttentionUtils": ("deepspeed_tpu_torch.ops.sparse_attention",
                                 "SparseAttentionUtils"),
    }
    if name in lazy:
        import importlib

        mod, sym = lazy[name]
        return getattr(importlib.import_module(mod), sym)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
