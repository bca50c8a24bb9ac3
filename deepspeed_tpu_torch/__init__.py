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
Training runs over ``torch.distributed`` (``comm``), one process per
device, with ZeRO stages 0-3 (``runtime/zero``, ``zero``) on a ``data x
fsdp x tp`` mesh (``parallel/topology.py``; GPT-2's layers split over
``tp`` with Megatron's f/g pair); inference and serving run
tensor-parallel on a ``tp`` mesh, one process a rank
(``module_inject``).

``DeepSpeedEngine``, ``InferenceEngine``, ``SparseSelfAttention``,
``SparseAttentionUtils`` and the ``zero`` and ``comm`` modules resolve
lazily from the package, as in the JAX package (whose
``deepspeed.ops.sparse_attention`` path the port keeps).
"""


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mesh=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, device=None):
    """Build a training engine around ``model`` (an ``nn.Module`` whose
    ``forward(batch)`` returns the loss, e.g. ``models.gpt2.
    GPT2ForTraining`` or ``models.bert.BertForTraining``) on the card
    (``device=None``; ``cuda:LOCAL_RANK`` under a process group) or the
    CPU. A ``sparse_attention`` config section goes to the model's
    ``with_sparse_attention`` hook.

    ``mesh`` (a :class:`~deepspeed_tpu_torch.parallel.topology.
    MeshTopology` or an axis dict such as ``{"data": 2, "fsdp": 2}``; the
    config's ``mesh`` section otherwise) or a ZeRO stage above 0 makes
    the run multi-process: one process per device, each calling
    ``initialize`` with the same arguments and the whole model, the
    process group started by :func:`init_distributed` unless one runs
    (``dist_init_required=False`` refuses to start one). A ``tp`` axis
    above 1 trains this rank's tensor-parallel slice of the model (its
    ``with_tensor_parallel`` hook: ``GPT2ForTraining``).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``;
    the dataloader is None. ``training_data`` comes with the checkpoint
    slice (the data-loader cursor); every parameter of ``model`` is
    trained, so ``model_parameters`` is not taken."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    for name, value, where in (
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
                             device=device, mesh=mesh,
                             dist_init_required=dist_init_required)
    return engine, engine.optimizer, None, engine.lr_scheduler


def init_distributed(dist_backend="xla", **kwargs):
    """Start the job's ``torch.distributed`` process group (NCCL on the
    card, gloo with ``device="cpu"``); idempotent. See
    :func:`deepspeed_tpu_torch.comm.init_distributed`."""
    from deepspeed_tpu_torch.comm.comm import init_distributed as _init

    return _init(dist_backend=dist_backend, **kwargs)


def default_inference_config():
    """The default inference config as a plain dict."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig

    return DeepSpeedInferenceConfig().model_dump()


def init_inference(model, config=None, **kwargs):
    """Build an :class:`~deepspeed_tpu_torch.inference.engine.
    InferenceEngine` (``device=None`` is the card). With
    ``tensor_parallel={"tp_size": N}`` every one of N ranks of a process
    group (``init_distributed``) calls it with the same arguments and the
    whole model, and serves its slice; ``mesh=`` (a ``MeshTopology`` or an
    axis dict) names the tp mesh instead."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    return InferenceEngine(model, config=config, **kwargs)


def init_serving(model, config=None, draft_model=None, **kwargs):
    """Build the continuous-batching serving engine (paged KV cache +
    request scheduler) over an inference engine: ``model`` is a model
    (a fresh engine is built from ``config``/``kwargs``, which must carry
    a ``serving`` block) or an existing InferenceEngine whose config has
    one. ``draft_model`` is the draft of ``serving.speculative``'s
    ``"draft_model"`` proposer: a callable ``(context, k) -> tokens`` or
    an engine with ``.generate`` (e.g. a small InferenceEngine). Under
    ``tensor_parallel`` (or ``mesh=``) every rank builds and drives the
    engine with the same calls. The multi-replica router, fleet and
    gateway blocks come with the serving fleet slice and raise at config
    time."""
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
    if name in ("zero", "comm"):
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
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
