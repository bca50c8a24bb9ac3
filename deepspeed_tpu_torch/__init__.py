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
block-sparse layout zoo and its kernels (``ops/sparse_attention``), and
for the Llama family (``models/llama.py``: ``init_inference``,
``initialize`` and ``inference.from_pretrained`` on HF directories).
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
    with ``training_data`` the dataloader is the engine's
    ``deepspeed_io(training_data)`` (a ``DeepSpeedDataLoader`` of global
    micro-batches with JAX's sample order and cursor, ``collate_fn``
    assembling samples), else None. Every parameter of ``model`` is
    trained, so ``model_parameters`` is not taken."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if model_parameters is not None:
        raise NotImplementedError(
            "initialize(model_parameters=...) is not supported by the "
            "PyTorch port: no slice: the engine trains every parameter of "
            "the model")
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    engine = DeepSpeedEngine(model=model, optimizer=optimizer,
                             lr_scheduler=lr_scheduler, config=config,
                             device=device, mesh=mesh,
                             dist_init_required=dist_init_required,
                             training_data=training_data,
                             collate_fn=collate_fn)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


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
    ``tensor_parallel={"tp_size": N}`` every rank of a process group of
    ``data x N`` ranks (``init_distributed``) calls it with the same
    arguments and the whole model, serves its slice, and takes its data
    group's share of each batch; ``mesh=`` (a ``MeshTopology`` or an axis
    dict) names the mesh instead."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    return InferenceEngine(model, config=config, **kwargs)


def init_serving(model, config=None, replicas=None, factory=None,
                 clock=None, draft_model=None, **kwargs):
    """Build the continuous-batching serving engine (paged KV cache +
    request scheduler) over an inference engine: ``model`` is a model
    (a fresh engine is built from ``config``/``kwargs``, which must carry
    a ``serving`` block) or an existing InferenceEngine whose config has
    one. ``draft_model`` is the draft of ``serving.speculative``'s
    ``"draft_model"`` proposer: a callable ``(context, k) -> tokens`` or
    an engine with ``.generate`` (e.g. a small InferenceEngine). Under
    ``tensor_parallel`` (or ``mesh=``) every rank builds and drives the
    engine with the same calls.

    With a ``serving.router`` block the result is the multi-replica front
    door (:class:`~deepspeed_tpu_torch.serving.router.ReplicaRouter`):
    ``serving.router.replicas`` engines are built from ``model`` (they
    share its weights on the card, each with its own pools) — or
    ``replicas`` is a count, or a pre-built list (InferenceEngines are
    wrapped, anything with the ServingEngine surface is taken as it is)
    — behind one submit()/step()/drain() with health-aware routing,
    failover with deduplicated replay and the degradation ladder; a
    ``serving.migration`` block moves live KV state instead of replaying
    it. One process steps the replicas in turn.

    A ``serving.fleet`` block on top wraps the router in the
    :class:`~deepspeed_tpu_torch.serving.router.FleetManager` (SLO
    error-budget autoscaling through the drain/reactivate seams):
    scale-up builds replicas through ``factory`` — a ``ReplicaFactory``
    or a zero-arg callable; built from ``model``, the default factory
    repeats the same build. ``clock`` injects the engines', router's
    and fleet's timebase (default ``time.monotonic``): the trace-replay
    ``ReplayClock`` drives the whole front door faster than real time.

    A ``serving.gateway`` block puts the whole stack behind the HTTP/SSE
    front door: the result is a started
    :class:`~deepspeed_tpu_torch.serving.gateway.ServingGateway` (read
    ``.port``) with the block's tenants, quotas and SLO classes.

    Tensor-parallel replicas: every rank of a ``data x tp`` world passes
    ``replicas=[engine]``, its own InferenceEngine built with
    ``tensor_parallel={"tp_size": N}``. Each data group is one replica
    (``serving/group_replica.py``): on rank 0 (the controller) the
    result is the router or fleet over one proxy a group, the first
    ``serving.router.replicas`` groups serving (all groups without a
    router block) and the rest idle for the fleet's factory; every other
    rank serves its group's calls and returns None when the controller
    destroys the front. One-process replicas that this function builds
    while a process group runs take a rank-local mesh
    (:func:`~deepspeed_tpu_torch.parallel.topology.rank_local_mesh`)."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.serving.engine import ServingEngine

    def _on(block):
        # the standard config off switch: block present, layer disabled
        # — identical to absent
        if block is None:
            return None
        enabled = (block.get("enabled", True) if isinstance(block, dict)
                   else getattr(block, "enabled", True))
        return block if enabled else None

    def _behind_gateway(backend, gateway_block):
        gateway_block = _on(gateway_block)
        if gateway_block is None:
            return backend
        from deepspeed_tpu_torch.serving.gateway import ServingGateway
        gw_clock = clock if clock is not None \
            else getattr(backend, "clock", None)
        gw_kwargs = {} if gw_clock is None else {"clock": gw_clock}
        return ServingGateway(backend, config=gateway_block,
                              **gw_kwargs).start()

    # probe the blocks ahead of construction (full coercion lives in
    # ServingConfig); `replicas` alone also selects the router
    serving = kwargs.get("serving")
    if serving is None:
        serving = (config.get("serving") if isinstance(config, dict)
                   else getattr(config, "serving", None))
    if serving is None:
        # a prebuilt InferenceEngine carries its serving block — a
        # router configured there must not be silently dropped
        serving = getattr(model, "_serving_cfg", None)

    def _block(name):
        return (serving.get(name) if isinstance(serving, dict)
                else getattr(serving, name, None))

    router = _on(_block("router"))
    fleet = _on(_block("fleet"))
    gateway = _block("gateway")
    clock_kwargs = {} if clock is None else {"clock": clock}
    engine_kwargs = dict(kwargs, draft_model=draft_model, **clock_kwargs)

    def _engine(source, **kw):
        return ServingEngine(source, **kw, **engine_kwargs)

    def _replica(source, **kw):
        # a one-process replica is this rank's alone, whatever the world
        import torch.distributed as dist

        if (dist.is_available() and dist.is_initialized()
                and "mesh" not in engine_kwargs):
            from deepspeed_tpu_torch.parallel.topology import \
                rank_local_mesh
            kw["mesh"] = rank_local_mesh()
        return _engine(source, **kw)

    if router is None and replicas is None:
        engine = _engine(model, config=config)
        if gateway is None:
            gateway = engine.config.gateway
        return _behind_gateway(engine, gateway)

    from deepspeed_tpu_torch.serving.router import (CallableReplicaFactory,
                                                    FleetManager,
                                                    ReplicaRouter)

    groups = (isinstance(replicas, (list, tuple)) and len(replicas) == 1
              and isinstance(replicas[0], InferenceEngine)
              and replicas[0].mp_world_size > 1)
    built_from_model = False
    if groups:
        from deepspeed_tpu_torch.serving.group_replica import (
            group_replicas)
        tp_engine = replicas[0]
        cfg = tp_engine._serving_cfg
        block = router if router is not None else cfg.router

        def field(name):
            return (None if block is None else block.get(name)
                    if isinstance(block, dict) else getattr(block, name,
                                                            None))

        # a group's reply waits the router's stall timeout (real
        # seconds) where one is set
        built = group_replicas(tp_engine, active=field("replicas"),
                               timeout=field("stall_timeout_secs") or 60.0,
                               draft_model=draft_model,
                               **({} if clock is None else {"clock": clock}))
        if built is None:
            return None  # a follower rank: its group was stopped
        engines, group_factory = built
        if factory is None:
            factory = group_factory
    elif replicas is None or isinstance(replicas, int):
        if isinstance(model, InferenceEngine):
            raise ValueError(
                "one InferenceEngine is one replica — pass the prebuilt "
                "engines as a list via `replicas` instead of a count")
        built_from_model = True
        first = _replica(model, config=config)
        count = replicas if isinstance(replicas, int) else (
            first.config.router.replicas if first.config.router else 2)
        engines = [first] + [_replica(model, config=config)
                             for _ in range(count - 1)]
    else:
        engines = [ServingEngine(r, draft_model=draft_model, **clock_kwargs)
                   if isinstance(r, InferenceEngine) else r
                   for r in replicas]

    def _carried(field):
        # prebuilt replicas, no explicit block: fall back to a config an
        # engine carries (explicit caller blocks always win)
        return next(
            (c for c in (getattr(getattr(e, "config", None), field, None)
                         for e in engines) if c is not None), None)

    if router is None:
        router = _carried("router")
    if fleet is None:
        # an engine-carried fleet block silently dropped would read as
        # "autoscaling is on" when it is not
        fleet = _on(_carried("fleet"))
    migration = _block("migration")
    if migration is None:
        migration = _carried("migration")
    if gateway is None:
        gateway = _carried("gateway")
    front = ReplicaRouter(engines, config=router, migration=migration,
                          **clock_kwargs)
    if fleet is None:
        if factory is not None and not groups:
            raise ValueError(
                "init_serving got a replica `factory` but no "
                "serving.fleet block — the factory is the fleet "
                "manager's scale-up seam; add \"fleet\": {...} to use it")
        return _behind_gateway(front, gateway)
    if factory is None and built_from_model:
        # the same build as the first replicas
        factory = CallableReplicaFactory(
            lambda: _replica(model, config=config))
    return _behind_gateway(
        FleetManager(front, factory=factory, config=fleet), gateway)


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
