"""Spawned gloo ranks for the port's multi-rank tests.

:func:`run_ranks` starts ``world`` processes (``spawn``), each of which
joins one gloo process group through a ``FileStore`` under the test's
temporary directory (no TCP port, so parallel test workers cannot
collide), runs one of the programs below, and writes its result for the
parent. The parent joins with a hard timeout and kills every child, so a
hung collective fails its test instead of stalling the run.

This module imports only numpy, torch and the port: the children never
import JAX. Weights and batches arrive as files the parent wrote.
"""

import os
import pickle
import time
import traceback

import numpy as np
import torch

RANK_TIMEOUT = 240.0


def run_ranks(program, world, tmp_path, args=None, timeout=RANK_TIMEOUT):
    """Run ``program(rank, world, args)`` on ``world`` gloo ranks; returns
    the list of their results, by rank."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = os.path.join(str(tmp_path), f"ranks-{program.__name__}")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    procs = [ctx.Process(target=_child, args=(program, rank, world, store,
                                              out, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = []
    for rank, p in enumerate(procs):
        err = os.path.join(out, f"{rank}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
    if hung:
        raise TimeoutError(f"ranks {hung} of {program.__name__} still ran "
                           f"after {timeout} s (killed)\n"
                           + "\n".join(errors))
    if any(p.exitcode != 0 for p in procs) or errors:
        raise RuntimeError(f"{program.__name__} failed: exit codes "
                           f"{[p.exitcode for p in procs]}\n"
                           + "\n".join(errors))
    results = []
    for rank in range(world):
        with open(os.path.join(out, f"{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def shared_dir(tmp_path_factory):
    """A directory every test worker of this pytest run shares."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    path = base.parent / f"torch-ranks-{uid}" if uid else base / "torch-ranks"
    path.mkdir(parents=True, exist_ok=True)
    return path


def cached(tmp_path_factory, name, run):
    """``run(directory)``'s result, computed once for the whole run: the
    first worker to ask runs it, the others read its result."""
    from filelock import FileLock

    shared = shared_dir(tmp_path_factory)
    with FileLock(str(shared / f"{name}.lock")):
        path = shared / f"{name}.pkl"
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        result = run(shared)
        with open(path, "wb") as f:
            pickle.dump(result, f)
        return result


def programs(rank, world, args):
    """Several programs on one spawn of ranks: each ``(name, program,
    program_args)`` of ``args`` in turn; their results by name."""
    return {name: program(rank, world, a) for name, program, a in args}


def _child(program, rank, world, store, out, args):
    try:
        # one thread, at a lower priority: the ranks share the machine
        # with the other test workers (and their timing tests)
        os.nice(10)
        torch.set_num_threads(1)
        from deepspeed_tpu_torch import comm

        comm.init_distributed(init_method=f"file://{store}", rank=rank,
                              world_size=world, device="cpu", timeout=120,
                              verbose=False)
        result = program(rank, world, args)
        with open(os.path.join(out, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        comm.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _np(t):
    return t.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def collectives(rank, world, args):
    """Every collective of ``deepspeed_tpu_torch.comm`` on a
    ``{"data": 2, "fsdp": 2}`` mesh; rank r's inputs are made from r."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import (MeshTopology,
                                                       set_topology)

    backend = comm.init_distributed(device="cpu")  # runs: kept
    again = comm.init_distributed(device="cpu")
    topo = MeshTopology(axis_sizes={"data": 2, "fsdp": 2})
    set_topology(topo)
    x = torch.arange(24, dtype=torch.float32).view(4, 6) + 10 * rank
    res = {"idempotent": backend is again and comm.is_initialized(),
           "rank": comm.get_rank(), "world": comm.get_world_size(),
           "coord": tuple(topo.coord)}
    for group in (None, "data", "fsdp", ("data", "fsdp")):
        key = group if isinstance(group, (str, type(None))) \
            else "+".join(group)
        res[f"ranks/{key}"] = comm.get_all_ranks_from_group(group)
        res[f"group_rank/{key}"] = comm.get_rank(group)
        res[f"group_size/{key}"] = comm.get_world_size(group)
        for op in ("SUM", "AVG", "MAX", "MIN", "PRODUCT"):
            t = x.clone() / 10 + 1
            comm.all_reduce(t, op=getattr(comm.ReduceOp, op), group=group)
            res[f"all_reduce/{op}/{key}"] = _np(t)
        res[f"all_gather/{key}"] = _np(comm.all_gather(x, group=group))
        res[f"all_gather_tiled1/{key}"] = _np(
            comm.all_gather(x, group=group, axis=1, tiled=True))
        res[f"reduce_scatter/{key}"] = _np(
            comm.reduce_scatter(x, group=group))
        res[f"reduce_scatter_avg1/{key}"] = _np(
            comm.reduce_scatter(x[:, :4], group=group, axis=1,
                                op=comm.ReduceOp.AVG))
        res[f"all_to_all/{key}"] = _np(
            comm.all_to_all_single(x, group=group, split_axis=0,
                                   concat_axis=1))
        res[f"broadcast/{key}"] = _np(comm.broadcast(
            x.clone(), src=comm.get_world_size(group) - 1, group=group))
        ring = [(i, (i + 1) % comm.get_world_size(group))
                for i in range(comm.get_world_size(group))]
        res[f"ppermute_ring/{key}"] = _np(comm.ppermute(x, ring,
                                                        group=group))
        res[f"ppermute_pair/{key}"] = _np(comm.ppermute(x, [(0, 1)],
                                                        group=group))
    res["all_gather_base"] = _np(comm.all_gather_base(
        torch.empty(4 * 24), x.reshape(-1)))
    res["reduce_scatter_untiled"] = _np(comm.reduce_scatter(
        x, tiled=False))
    t = x.clone()
    comm.reduce(t, dst=2)
    res["reduce"] = _np(t) if rank == 2 else None
    g = comm.gather(x, dst=1)
    res["gather"] = None if g is None else _np(g)
    t = torch.empty(4, 6)
    comm.scatter(t, scatter_list=[x + 100 * i for i in range(world)]
                 if rank == 3 else None, src=3)
    res["scatter"] = _np(t)
    t = torch.zeros(4, 6)
    if rank == 0:
        comm.send(x, dst=3)
    elif rank == 3:
        comm.recv(t, src=0)
    res["send_recv"] = _np(t)
    t = torch.zeros(4, 6)
    if rank == 1:
        comm.isend(x, dst=2, group="data+fsdp".split("+")).wait()
    elif rank == 2:
        comm.irecv(t, src=1, group=("data", "fsdp")).wait()
    res["isend_irecv"] = _np(t)
    res["inference_all_reduce"] = _np(comm.inference_all_reduce(
        x.clone(), group="fsdp"))
    res["reduce_scatter_base"] = _np(comm.reduce_scatter_base(
        x, group="data"))
    from deepspeed_tpu_torch.runtime.zero.reduce import reduce_gradients

    # two buckets of 48 fp32 bytes: [x[2:]] then [x[:2]] (reverse order)
    res["reduce_gradients"] = [_np(t) for t in reduce_gradients(
        [x[:2], x[2:]], group="data", bucket_bytes=48)]
    from deepspeed_tpu_torch.utils import groups

    res["groups"] = (groups.get_data_parallel_world_size(),
                     groups.get_data_parallel_rank(),
                     groups.get_model_parallel_world_size(),
                     groups.get_pipe_parallel_world_size(),
                     comm.get_all_ranks_from_group(
                         groups.get_data_parallel_group()))
    comm.barrier()
    comm.monitored_barrier(timeout=60)
    res["counts"] = dict(comm.counts)
    return res


# ---------------------------------------------------------------------------
# ZeRO training
# ---------------------------------------------------------------------------
def zero_config(stage, gas=1, fused=True, optimizer="AdamW", **zero):
    """The bench keys at a tiny batch, fp32 (``test_torch_training.py``'s
    ``bench_config``), with a ZeRO stage."""
    params = {"lr": 6e-4, "weight_decay": 0.1}
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": optimizer, "params": params},
            "gradient_clipping": 1.0,
            "bf16": {"enabled": False},
            "fused_step": fused,
            "zero_optimization": {"stage": stage, **zero},
            "steps_per_print": 10_000}


def _gpt2(args, **extra):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.utils.params import training_model_from_jax

    cfg = GPT2Config.tiny(dtype=torch.float32, remat=True,
                          remat_policy="dots", **extra)
    return training_model_from_jax(args["weights"], cfg)


def train(rank, world, args):
    """Each case of ``args["cases"]`` (name -> config) for
    ``args["steps"]`` steps on ``args["batches"]`` (global micro-batches)
    over ``args["mesh"]``: losses of every micro-step, pre-clip grad norms,
    the gathered final parameters (rank 0), the shapes each rank holds,
    and the collectives each step launched against the stage's plan and
    the model's (its tensor-parallel collectives)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    topo = MeshTopology(axis_sizes=args["mesh"])
    out = {}
    for name, config in args["cases"].items():
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=_gpt2(args), config=config, mesh=topo, device="cpu")
        gas = engine.gradient_accumulation_steps()
        losses, norms = [], []
        comm.reset_counts()
        for i, ids in enumerate(args["batches"][:args["steps"] * gas]):
            loss = engine({"input_ids": ids})
            engine.backward(loss)
            engine.step()
            losses.append(float(loss))
            if (i + 1) % gas == 0:
                norms.append(engine.get_global_grad_norm())
        counts = dict(comm.counts)
        zero = engine._zero
        plan = zero.comm_plan(
            gas, recompute=True,
            lamb=config["optimizer"]["type"].lower() == "lamb")
        # the model's own (tensor-parallel) collectives, a micro-step
        rows, seq = args["batches"][0].shape
        rows //= engine.topology.get_data_parallel_world_size()
        for k, v in engine.module.comm_plan(rows, seq).items():
            plan[k] = plan.get(k, 0) + v * gas
        out[name] = {
            "losses": losses, "norms": norms,
            "counts": {k: counts.get(k, 0) for k in plan},
            "plan": {k: v * args["steps"] for k, v in plan.items()},
            "param_shapes": {e.name: tuple(e.param.shape)
                             for e in zero.entries},
            "master_shapes": {e.name: tuple(e.master.shape)
                              for e in zero.entries},
            "applied": engine.was_step_applied()}
        params = engine.module_state_dict()
        if rank == 0:
            out[name]["params"] = {k: _np(v) for k, v in params.items()}
    return out


def overflow(rank, world, args):
    """fp16 dynamic scaling where only rank 0's rows overflow: the
    element they make inf lies in rank 0's optimizer shard alone, and
    every rank must skip the step."""
    import deepspeed_tpu_torch
    from torch import nn

    class Probe(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.ones(4, 8))

        def forward(self, batch):
            return (self.w * batch["x"]).sum()

    x = np.ones((world, 4, 8), np.float32)
    x[0, 0, 0] = 1e38  # times the 2^16 loss scale: inf in fp32
    config = {"train_micro_batch_size_per_gpu": 1,
              "optimizer": {"type": "Adam", "params": {"lr": 0.1}},
              "fp16": {"enabled": True}, "fused_step": True,
              "zero_optimization": {"stage": args["stage"]},
              "steps_per_print": 10_000}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=Probe(), config=config, mesh={"data": world}, device="cpu")
    grads = engine._zero.entries[0]
    engine({"x": x})
    skipped = (engine.get_skipped_steps(), engine.was_step_applied())
    w = _np(engine.module.w)
    engine({"x": np.ones_like(x)})
    return {"skipped": skipped, "w": w, "w_after": _np(engine.module.w),
            "shard": tuple(grads.master.shape),
            "loss_scale": engine.loss_scale}


def gathered(rank, world, args):
    """``zero.GatheredParameters`` at stage 3 on ``{"data": 2, "fsdp":
    2}``: whole parameters inside, rank 1's write broadcast on exit and
    re-sharded; then a step runs from the written weights."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import zero

    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_gpt2(args), config={**zero_config(
            3, stage3_param_persistence_threshold=0),
            "mesh": {"data": 2, "fsdp": 2}}, device="cpu")
    params = list(engine.module.parameters())
    res = {"shards": [tuple(p.shape) for p in params]}
    with zero.GatheredParameters(params, modifier_rank=1):
        res["inside"] = [tuple(p.shape) for p in params]
        res["wte_inside"] = _np(engine.module.model.wte)
        with torch.no_grad():
            engine.module.model.wte[0] = 7.0 if rank == 1 else -1.0
    res["after"] = [tuple(p.shape) for p in params]
    sd = engine.module_state_dict()
    res["wte_row0"] = _np(sd["model.wte"][0])
    res["wte_rest"] = _np(sd["model.wte"][1:])
    # with no modifier, the block writes nothing back
    with zero.GatheredParameters(params):
        with torch.no_grad():
            engine.module.model.wte[1] = 5.0
    res["wte_row1_read_only"] = _np(engine.module_state_dict()
                                    ["model.wte"][1])
    loss = engine({"input_ids": args["batches"][0]})
    res["loss"] = float(loss)
    res["step_applied"] = engine.was_step_applied()
    # load_module_state_dict re-shards whole tensors into the shards and
    # the masters: the trained weights come back as they were saved
    saved = engine.module_state_dict()
    engine.load_module_state_dict(
        {k: torch.zeros_like(v) for k, v in saved.items()})
    res["zeroed"] = float(sum(v.abs().sum() for v in
                              engine.module_state_dict().values()))
    engine.load_module_state_dict(saved)
    res["reloaded"] = max(float((v - saved[k]).abs().max()) for k, v in
                          engine.module_state_dict().items())
    # zero.Init partitions the model before initialize, which keeps its
    # shards: the first step's loss and gradient norm equal an engine
    # built from the whole model
    config = {**zero_config(3, stage3_param_persistence_threshold=0),
              "mesh": {"data": 2, "fsdp": 2}}
    runs = []
    for init in (True, False):
        model = _gpt2(args)
        if init:
            zero.Init(config_dict_or_path=config).materialize(model)
            res["init_shapes"] = [tuple(p.shape) for p in model.parameters()]
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=config, device="cpu")
        runs.append((float(engine({"input_ids": args["batches"][0]})),
                     engine.get_global_grad_norm()))
    res["init_runs"] = runs
    res.update(_stage3_lifetimes(args, config))
    return res


def _stage3_lifetimes(args, config):
    """Stage 3's gathered weights: after the forward only the root
    unit's are alive (the LM head keeps ``wte`` for its backward), after
    the backward none; the first step's loss and gradient norm under
    "full" remat and without remat equal stage 0's."""
    import gc
    import weakref

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.zero import stage as zero_stage

    calls = []
    gather = zero_stage.all_gather_flat

    def recording(shards, plans):
        whole = gather(shards, plans)
        calls.append([weakref.ref(t) for t in whole])
        return whole

    zero_stage.all_gather_flat = recording
    try:
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=_gpt2(args), config=config, device="cpu")
        batch = {"input_ids": torch.from_numpy(args["batches"][0])}
        loss = engine.module(engine._to_device(batch))
        gc.collect()
        after_forward = [sum(r() is not None for r in c) for c in calls]
        loss.backward()
        del loss
        gc.collect()
        after_backward = [sum(r() is not None for r in c) for c in calls]
    finally:
        zero_stage.all_gather_flat = gather
    out = {"alive_after_forward": after_forward,
           "alive_after_backward": after_backward}
    for remat in ("full", None):
        extra = {"remat": False} if remat is None else {
            "remat_policy": remat}
        steps = []
        for stage in (0, 3):
            from deepspeed_tpu_torch.models.gpt2 import GPT2Config
            from deepspeed_tpu_torch.utils.params import \
                training_model_from_jax

            cfg = GPT2Config.tiny(dtype=torch.float32, **{
                "remat": True, "remat_policy": "dots", **extra})
            engine, *_ = deepspeed_tpu_torch.initialize(
                model=training_model_from_jax(args["weights"], cfg),
                config={**config, "zero_optimization": {
                    "stage": stage, "stage3_param_persistence_threshold": 0}},
                device="cpu")
            steps.append((float(engine(batch)),
                          engine.get_global_grad_norm()))
        out[f"remat_{remat}"] = steps
    return out


# ---------------------------------------------------------------------------
# tensor-parallel inference and serving
# ---------------------------------------------------------------------------
TP_SERVING = {"block_size": 8, "decode_slots": 3}
TP_PAGED = {"enabled": True, "decode_slots": 2, "block_size": 8,
            "max_model_len": 64}
TP_SAMP = {**TP_SERVING, "sampling": {"enabled": True}}
TP_KNOBS = dict(seed=101, temperature=0.8, top_p=0.9)
TP_FAST = {**TP_SERVING, "prefix_cache": True, "prefill_chunk_tokens": 8,
           "kv_cache_dtype": "int8"}
TP_SPEC = {**TP_SERVING, "speculative": {"num_speculative_tokens": 4}}


def tp_generate_inputs():
    """(greedy prompt, keyed ids, padded ids and mask) of the tp tests."""
    keyed = np.random.default_rng(2).integers(1, 256, (2, 6))
    ids = np.array([[7, 23, 56, 11, 9], [0, 0, 3, 17, 42]], np.int64)
    mask = np.array([[1, 1, 1, 1, 1], [0, 0, 1, 1, 1]], np.int64)
    return np.array([[3, 1, 4, 1, 5]]), keyed, (ids, mask)


def tp_fast_stream(srv):
    """A shared 16-token system prompt: ``a`` served alone first, then
    ``c`` extending it inside its partial last block (copy-on-write), a
    tiled motif and one that shares nothing; 6 new tokens each."""
    rng = np.random.default_rng(0)
    system = rng.integers(1, 256, 16)
    motif = rng.integers(1, 256, 4)
    a = np.concatenate([system, rng.integers(1, 256, 3)])
    rest = [np.concatenate([system, rng.integers(1, 256, 9)]),
            np.concatenate([a, rng.integers(1, 256, 2)]),
            np.concatenate([system, np.tile(motif, 3)]), np.tile(motif, 4)]
    reqs = [srv.submit(a, max_new_tokens=6, request_id="a")]
    srv.drain()
    reqs += [srv.submit(p, max_new_tokens=6, request_id=rid)
             for rid, p in zip("bcmu", rest)]
    srv.drain()
    return [r.tokens for r in reqs]


def _tiny_model(weights, **extra):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config.tiny(**{"dtype": torch.float32, **extra})
    model = GPT2LMHeadModel(cfg, device="meta")
    model.load_state_dict(weights, assign=True)
    return model


def _tp_layers(rank, world, args):
    """The column / row / MLP functions and modules on this rank's
    shards of ``args["layers"]`` (flax-layout ``[in, out]`` numpy)."""
    from deepspeed_tpu_torch.module_inject import layers

    lay = {k: torch.from_numpy(v) for k, v in args["layers"].items()}
    w_in, w_out = lay["w_in"].T, lay["w_out"].T         # [out, in]
    w_in_r = w_in.chunk(world, 0)[rank]
    b_in_r = lay["b_in"].chunk(world, 0)[rank]
    w_out_r = w_out.chunk(world, 1)[rank].contiguous()
    h_r = lay["h"].chunk(world, -1)[rank]
    group = torch.distributed.group.WORLD
    tp = layers.TensorParallel(group=group, size=world, rank=rank)
    col = layers.ColumnParallelLinear(w_in.shape[1], w_in.shape[0], tp)
    row = layers.RowParallelLinear(w_out.shape[1], w_out.shape[0], tp)
    with torch.no_grad():
        col.weight.copy_(w_in_r)
        col.bias.copy_(b_in_r)
        row.weight.copy_(w_out_r)
        row.bias.copy_(lay["b_out"])
        return {
            "column": _np(layers.column_parallel_linear(lay["x"], w_in_r,
                                                        b_in_r)),
            "row": _np(layers.row_parallel_linear(h_r, w_out_r,
                                                  lay["b_out"], group)),
            "row_nobias": _np(layers.row_parallel_linear(h_r, w_out_r,
                                                         None, group)),
            "mlp": _np(layers.injected_mlp(lay["x"], w_in_r, b_in_r, w_out_r,
                                           lay["b_out"], group)),
            "modules": _np(row(torch.nn.functional.gelu(
                col(lay["x"]), approximate="tanh")))}


def _generate(engine, ids, n, mask=None, **kw):
    out = engine.generate(torch.from_numpy(np.asarray(ids)),
                          max_new_tokens=n,
                          attention_mask=None if mask is None
                          else torch.from_numpy(mask), **kw)
    return _np(out)[:, np.asarray(ids).shape[1]:].tolist()


def tensor_parallel(rank, world, args):
    """Tensor-parallel inference and serving at ``tp_size = world`` on a
    tiny fp32 GPT-2 made from ``args["weights"]`` (the port's whole state
    dict): the layers, this rank's slices and specs, greedy / keyed /
    padded ``generate``, paged, sampled and fast-path serving, the
    all-reduces a forward, and (``args["wide3"]``) the 3-head model whose
    attention stays whole; on 4 ranks also a tp=2 engine, which must
    raise, and a tp=1 engine, which serves alone."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils import groups
    from deepspeed_tpu_torch.utils.params import shard_for_rank

    def engine(**kw):
        return deepspeed_tpu_torch.init_inference(
            _tiny_model(args["weights"]), dtype="fp32", device="cpu",
            tensor_parallel={"tp_size": world}, **kw)

    out = {"layers": _tp_layers(rank, world, args)}
    greedy, keyed, (pad_ids, pad_mask) = tp_generate_inputs()
    eng = engine()
    out["greedy"] = _generate(eng, greedy, 6)
    comm.reset_counts()
    eng.forward(torch.from_numpy(greedy))
    out["forward_counts"] = dict(comm.counts)
    out["local"] = {k: _np(v) for k, v in eng.module.state_dict().items()}
    out["shard_for_rank"] = {
        k: _np(v) for k, v in shard_for_rank(
            args["weights"], eng.model_config, rank, world).items()}
    out["specs"] = {k: None if s is None else tuple(s)
                    for k, s in eng.param_shardings.items()}
    out["mp_world_size"] = eng.mp_world_size
    out["groups"] = (groups.get_tensor_parallel_world_size(),
                     groups.get_tensor_parallel_rank(),
                     groups.get_model_parallel_world_size(),
                     groups.get_model_parallel_rank(),
                     comm.get_all_ranks_from_group(
                         groups.get_tensor_parallel_group()),
                     comm.get_all_ranks_from_group("tp"))
    if world == 4:
        # tp 3 does not divide a world of 4: the JAX mesh's error
        try:
            deepspeed_tpu_torch.init_inference(
                _tiny_model(args["weights"]), dtype="fp32", device="cpu",
                tensor_parallel={"tp_size": 3})
            out["tp2_on_world4"] = None
        except ValueError as e:
            out["tp2_on_world4"] = str(e)
        # an explicit one-rank mesh: each rank serves alone
        from deepspeed_tpu_torch.parallel.topology import rank_local_mesh

        alone = deepspeed_tpu_torch.init_inference(
            _tiny_model(args["weights"]), dtype="fp32", device="cpu",
            mesh=rank_local_mesh())
        out["tp1_on_world4"] = (_generate(alone, greedy, 6),
                                alone.topo.world_size)
        out.update(dp_inference(rank, world, args))
        out.update(group_replicas(rank, world, args))  # last: kills ranks
        return out
    out["keyed"] = _generate(eng, keyed, 6, do_sample=True, **TP_KNOBS)
    out["padded"] = _generate(eng, pad_ids, 6, mask=pad_mask)
    srv = deepspeed_tpu_torch.init_serving(engine(serving=TP_PAGED))
    req = srv.submit([11, 23, 42, 7], max_new_tokens=8)
    srv.drain()
    out["paged"] = req.tokens
    out["paged_pools"] = [tuple(p.shape) for p in srv.cache.pools()]
    out["paged_stats_tp"] = srv.stats()["tp"]
    srv = deepspeed_tpu_torch.init_serving(engine(serving=TP_SAMP))
    req = srv.submit([5, 17, 42, 9], max_new_tokens=4, do_sample=True,
                     seed=7, temperature=0.8, top_p=0.9)
    srv.drain()
    out["sampled"] = req.tokens
    srv = deepspeed_tpu_torch.init_serving(engine(serving=TP_FAST))
    out["fast"] = tp_fast_stream(srv)
    out["fast_pools"] = [tuple(p.shape) for p in srv.cache.pools()]
    out["spec"] = tp_fast_stream(deepspeed_tpu_torch.init_serving(
        engine(serving=TP_SPEC)))
    eng3 = deepspeed_tpu_torch.init_inference(
        _tiny_model(args["wide3"], n_embd=96, n_head=3), dtype="fp32",
        device="cpu", tensor_parallel={"tp_size": world})
    out["wide3"] = {
        "greedy": _generate(eng3, greedy, 6),
        "shapes": {k: tuple(v.shape)
                   for k, v in eng3.module.state_dict().items()},
        "cache_heads": eng3.module.new_cache(1).keys[0].shape[2]}
    out.update(dp_inference(rank, world, args))
    out.update(comms_log(rank, world, args))
    return out


# ---------------------------------------------------------------------------
# data-parallel inference and tp replicas behind the router ([7e])
# ---------------------------------------------------------------------------
DP_SERVING = {"enabled": True, "decode_slots": 2, "block_size": 8,
              "max_model_len": 64, "prompt_buckets": [16]}
DP_KNOBS = dict(seed=101, temperature=0.8, top_p=0.9)
FLEET_SLICE = {
    "block_size": 8, "decode_slots": 3, "prompt_buckets": [16],
    "max_queue_depth": 3, "default_max_new_tokens": 6, "sampling": {},
    "router": {"replicas": 2, "failure_threshold": 2}, "migration": {},
    "fleet": {"min_replicas": 1, "max_replicas": 3,
              "target_ttft_p95_ms": 1000.0, "fast_window_steps": 4,
              "scale_up_cooldown_steps": 3, "scale_down_quiet_steps": 40,
              "scale_down_cooldown_steps": 40}}
MIGRATE_SERVING = {"block_size": 8, "decode_slots": 3, "prompt_buckets": [16],
                   "default_max_new_tokens": 6, "router": {"replicas": 2},
                   "migration": {}}


def dp_inputs():
    """(4-row prompts, 3-row prompts, left-padded 3-row ids and mask) of
    the data-parallel cases, from one seed."""
    rng = np.random.default_rng(7)
    ids4 = rng.integers(1, 256, (4, 8))
    ids3 = rng.integers(1, 256, (3, 8))
    pad = rng.integers(1, 256, (3, 8))
    mask = np.ones((3, 8), np.int64)
    mask[1, :3] = 0
    mask[2, :6] = 0
    pad[mask == 0] = 0
    return ids4, ids3, (pad, mask)


class RowSpy:
    """Counts the batch rows the kernel paths' plain versions see (the
    flash forward and the append decode), as a context manager."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops import decode_attention as da
        from deepspeed_tpu_torch.ops import flash_attention as fa

        self.rows = set()
        self._saved = [(fa, "flash_attention_reference"),
                       (da, "decode_attention_reference")]
        self._orig = [getattr(m, n) for m, n in self._saved]

        def spy(fn):
            def wrapped(q, *a, **k):
                self.rows.add(int(q.shape[0]))
                return fn(q, *a, **k)
            return wrapped

        for (m, n), fn in zip(self._saved, self._orig):
            setattr(m, n, spy(fn))
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self._saved, self._orig):
            setattr(m, n, fn)
        return False


def dp_inference(rank, world, args):
    """``init_inference(tensor_parallel={"tp_size": world // 2})`` on the
    world: ``data=2 x tp=2`` on 4 ranks, ``data=2`` at tp 1 on 2. Greedy,
    keyed and padded ``generate`` at B=4 and B=3 (not dividing), bucketed
    padded ``generate``, ``forward`` logits, the batch rows each rank's
    kernel paths saw, serving on the mesh, and the tiny GQA Llama."""
    import deepspeed_tpu_torch

    tp = world // 2
    ids4, ids3, (pad, mask) = dp_inputs()

    def engine(model, **kw):
        return deepspeed_tpu_torch.init_inference(
            model, dtype="fp32", device="cpu",
            tensor_parallel={"tp_size": tp}, **kw)

    eng = engine(_tiny_model(args["weights"]))
    out = {"shape": eng.topo.shape,
           "coord": (eng.dp_rank, eng.topo.get_tensor_parallel_rank())}
    with RowSpy() as spy:
        out["greedy4"] = _generate(eng, ids4, 6)
        out["greedy3"] = _generate(eng, ids3, 6)
        out["keyed4"] = _generate(eng, ids4, 6, do_sample=True, **DP_KNOBS)
        out["keyed3"] = _generate(eng, ids3, 6, do_sample=True, **DP_KNOBS)
        out["padded3"] = _generate(eng, pad, 6, mask)
        out["keyed_padded3"] = _generate(eng, pad, 6, mask, do_sample=True,
                                         **DP_KNOBS)
        out["logits3"] = _np(eng.forward(torch.from_numpy(ids3)))
        out["one_row"] = _generate(eng, ids3[:1], 6)
    out["rows"] = sorted(spy.rows)
    out["model_times"] = len(eng.model_times())
    bucketed = engine(_tiny_model(args["weights"]), serving=DP_SERVING)
    out["bucketed3"] = _generate(bucketed, pad, 6, mask)
    srv = deepspeed_tpu_torch.init_serving(engine(
        _tiny_model(args["weights"]), serving=TP_PAGED))
    req = srv.submit([11, 23, 42, 7], max_new_tokens=8)
    srv.drain()
    out["served"] = req.tokens
    if "llama" in args:
        from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
        from deepspeed_tpu_torch.utils.params import llama_params_from_jax

        cfg = LlamaConfig.tiny(dtype=torch.float32,
                               num_key_value_heads=args["llama"]["kv"])
        model = LlamaModel(cfg, device="meta")
        model.load_state_dict(llama_params_from_jax(
            args["llama"]["weights"], cfg), assign=True)
        leng = engine(model)
        out["llama_greedy3"] = _generate(leng, ids3, 6)
        out["llama_logits3"] = _np(leng.forward(torch.from_numpy(ids3)))
    key = "dp_tp2" if tp == 2 else "dp_tp1"
    return {key: out}


def comms_log(rank, world, args):
    """One ZeRO-2 step of the tiny GPT-2 on ``{"data": world}`` with the
    ``comms_logger`` section: the ops the logger recorded, ``comm.counts``
    and the stage's plan, by op."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2ForTraining
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    torch.manual_seed(0)
    model = GPT2ForTraining(GPT2Config.tiny(dtype=torch.float32, remat=True,
                                            remat_policy="dots"))
    config = {**zero_config(2), "comms_logger": {"enabled": True}}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config, mesh=MeshTopology({"data": world}),
        device="cpu")
    ids = np.random.default_rng(0).integers(0, 256, (2 * world, 16))
    engine.backward(engine({"input_ids": ids}))
    engine.step()
    comm.reset_counts()
    comm.comms_logger.comms_dict.clear()
    engine.backward(engine({"input_ids": ids}))
    engine.step()
    logged = {}
    for name, sizes in comm.log_summary().items():
        logged[name] = sum(v["count"] for v in sizes.values())
    plan = engine._zero.comm_plan(1, recompute=True)
    comm.configure(enabled=False)
    engine.destroy()
    return {"comms_log": (logged, {k: comm.counts.get(k, 0) for k in plan},
                          {k: v for k, v in plan.items() if v})}


class EventLog:
    """A recording ``telemetry=`` object for the router and fleet."""

    enabled = True

    def __init__(self):
        self.events = []

    def emit(self, kind, name, step=None, **data):
        self.events.append((kind, name, step, data))


def _record(front):
    log = EventLog()
    front.telemetry = log
    router = getattr(front, "router", front)
    router.telemetry = log
    return log


def fleet_slice(front, clk):
    """The serving-fleet slice of ``tests/test_torch_fleet.py`` over
    ``front`` (a FleetManager of two replicas): replica 1 crashes at its
    4th step (failover replay), replica 0's work migrates at the
    replayer's 8th step, and the fleet scales up through its factory."""
    from deepspeed_tpu_torch.runtime.resilience import chaos
    from deepspeed_tpu_torch.serving import replay

    log = _record(front)
    front.router.replicas[1] = chaos.ChaosReplica(front.router.replicas[1],
                                                  crash_at_step=4)
    trace = replay.burst_trace(6, seed=2, base_rate=1.5,
                               bursts=[(1, 2, 6.0)], prompt_len_mean=6,
                               prompt_len_max=12, gen_mean=5, gen_max=6,
                               sampled_fraction=0.3, temperature=0.8)
    moved = []

    def hook(rep, done):
        if rep.steps == 8:
            moved.append(front.router.migrate_work(0, "rebalance"))

    rep = replay.TraceReplayer(front, trace, clk, step_secs=0.25, seed=3,
                               vocab_size=256, max_steps=400, on_step=hook)
    report = rep.run()
    st = front.stats()
    return {"tokens": [(h.request_id, h.state, h.finish_reason, h.tokens)
                       for h in rep.handles],
            "moved": moved, "report": report,
            "counters": {k: st[k] for k in ("scale_ups", "scale_downs",
                                            "parks", "factory_builds",
                                            "factory_failures",
                                            "drain_migrations")},
            "router": st["router"], "events": log.events}


def migrate_pools(front, group):
    """Two replicas: 5 requests, two steps, the wire form of one live
    sequence (each rank's chunk of a group replica), then a drain of
    replica 0 that migrates its live work to replica 1."""
    log = _record(front)
    hs = [front.submit([5, 17, 42, 7 + i, 9], max_new_tokens=6,
                       request_id=f"m{i}") for i in range(5)]
    front.step()
    front.step()
    src = front.replicas[0]
    rid = sorted(r.proxy.request_id for r in hs
                 if r.replica == 0 and r.proxy is not None
                 and r.proxy.tokens)[0]
    meta = src.export_sequence(rid)
    chunks = (src.collect_chunks(rid) if group
              else [(meta["rows"], meta["dtypes"])])
    moved = front.migrate_work(0, "drain")
    front.drain(max_steps=60)
    return {"tokens": [(h.request_id, h.state, h.tokens, h.replica,
                        h.attempt) for h in hs],
            "stats": front.stats(), "moved": moved,
            "wire": (meta["blocks"], meta["wire_bytes"]), "chunks": chunks,
            "events": log.events}


def group_replicas(rank, world, args):
    """Two tp=2 replicas on 4 ranks behind ``init_serving(replicas=
    [engine])``, rank 0 the controller: the fleet slice, the drain with
    live migration on bf16 and int8 pools, and last a killed group (its
    ranks leave the program)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.serving.replay import ReplayClock

    def engine(serving, dtype="fp32"):
        model = _tiny_model(args["weights"], dtype={
            "fp32": torch.float32, "bf16": torch.bfloat16}[dtype])
        return deepspeed_tpu_torch.init_inference(
            model, dtype=dtype, device="cpu",
            tensor_parallel={"tp_size": 2}, serving=serving)

    out = {}
    clk = ReplayClock()
    front = deepspeed_tpu_torch.init_serving(
        None, replicas=[engine(FLEET_SLICE)], clock=clk)
    if front is not None:
        out["slice"] = fleet_slice(front, clk)
        front.destroy()
    for name, dtype, kv in (("bf16", "bf16", ""), ("int8", "fp32", "int8")):
        front = deepspeed_tpu_torch.init_serving(
            None, replicas=[engine({**MIGRATE_SERVING,
                                    "kv_cache_dtype": kv}, dtype)],
            clock=ReplayClock())
        if front is not None:
            out[f"migrate-{name}"] = migrate_pools(front, group=True)
            front.destroy()
    # last: group 1 is killed; the router must mark it DEAD within its
    # timeout (2 s here) and finish the work on group 0
    front = deepspeed_tpu_torch.init_serving(None, replicas=[engine(
        {**MIGRATE_SERVING, "router": {"replicas": 2,
                                       "stall_timeout_secs": 2.0}})])
    if front is not None:
        hs = [front.submit([5, 17, 42, 7 + i], max_new_tokens=6,
                           request_id=f"k{i}") for i in range(4)]
        front.step()
        front.replicas[1].kill()
        t0 = time.monotonic()
        front.drain(max_steps=40)
        out["killed"] = {"states": [h.state for h in front.health],
                         "secs": time.monotonic() - t0,
                         "tokens": [(h.request_id, h.state, h.tokens)
                                    for h in hs],
                         "failovers": front.stats()["failovers"]}
        front.destroy()
    return {"group_replicas": out}


# ---------------------------------------------------------------------------
# tensor-parallel training
# ---------------------------------------------------------------------------
TP_MESH = {"data": 2, "tp": 2}


def _tp_functions(tp, args):
    """The f/g pair, the tiled gather and the vocab-parallel losses on
    this rank's slices of ``args["fg"]`` (numpy): outputs and the
    gradients autograd gives the inputs and this rank's slices."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.models.gpt2 import (chunked_softmax_xent,
                                                 cross_entropy_loss,
                                                 head_logits)
    from deepspeed_tpu_torch.module_inject import layers

    a = {k: torch.from_numpy(v) for k, v in args["fg"].items()}
    n, r = tp.size, tp.rank

    def leaf(t):
        return t.clone().requires_grad_()

    out = {}
    # column (f) -> gelu -> row (g): out and the gradients of x and the
    # rank's weight slices
    x = leaf(a["x"])
    w_in = leaf(a["w_in"].chunk(n, 0)[r])
    w_out = leaf(a["w_out"].chunk(n, 1)[r])
    y = layers.row_parallel_linear(
        F.gelu(layers.column_parallel_linear(x, w_in, None, tp.group)),
        w_out, None, tp.group)
    (y * a["dy"]).sum().backward()
    out["mlp"] = [_np(t) for t in (y, x.grad, w_in.grad, w_out.grad)]
    # the tiled gather: the whole forward, this rank's slice backward
    h = leaf(a["x"].chunk(n, -1)[r])
    g = layers.gather_from_tp(h, tp.group, dim=-1)
    (g * a["dy"]).sum().backward()
    out["gather"] = [_np(g), _np(h.grad)]
    # the vocab-parallel loss on whole logits split by columns
    logits = leaf(a["logits"].chunk(n, -1)[r])
    loss = cross_entropy_loss(logits, torch.from_numpy(args["labels"]),
                              tp=tp)
    loss.backward()
    out["xent"] = [_np(loss), _np(logits.grad)]
    # the chunked head over a split vocabulary (chunks of 3 positions)
    hidden = leaf(a["hidden"])
    wte = leaf(a["wte"].chunk(n, 0)[r])
    loss = chunked_softmax_xent(hidden, wte,
                                torch.from_numpy(args["seq_labels"]),
                                chunk=3, tp=tp)
    loss.backward()
    out["chunked"] = [_np(loss), _np(hidden.grad), _np(wte.grad)]
    hidden = leaf(a["hidden"])
    wte = leaf(a["wte"].chunk(n, 0)[r])
    logits = head_logits(layers.copy_to_tp(hidden, tp.group), wte)
    loss = cross_entropy_loss(logits, torch.from_numpy(args["seq_labels"]),
                              tp=tp)
    loss.backward()
    out["dense_head"] = [_np(loss), _np(hidden.grad), _np(wte.grad)]
    return out


def _tp_engine_of(model, config):
    import deepspeed_tpu_torch

    return deepspeed_tpu_torch.initialize(model=model, config=config,
                                          mesh=TP_MESH, device="cpu")[0]


def _tp_engine(args, config, **extra):
    return _tp_engine_of(_gpt2(args, **extra), config)


def _steps(engine, batches, n):
    losses = []
    for ids in batches[:n]:
        loss = engine({"input_ids": ids})
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    return losses


def tp_checks(rank, world, args):
    """Tensor-parallel training's pieces on ``{"data": 2, "tp": 2}``:
    the f/g pair and the vocab-parallel losses on each tp group (2
    ranks); ``partition_activations`` against the run without it (losses
    and the collectives of 3 steps); an fp16 overflow in tp rank 0's
    slice alone; ``module_state_dict`` / ``load_module_state_dict``;
    ``zero.Init`` and ``GatheredParameters`` at stage 3."""
    from deepspeed_tpu_torch import comm, zero
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel
    from deepspeed_tpu_torch.parallel.topology import (MeshTopology,
                                                       set_topology)

    topo = MeshTopology(axis_sizes=TP_MESH)
    set_topology(topo)
    tp = TensorParallel(group=topo.get_tensor_parallel_group(), size=2,
                        rank=topo.get_tensor_parallel_rank())
    from deepspeed_tpu_torch.utils import groups

    out = {"tp_rank": tp.rank, "functions": _tp_functions(tp, args),
           "groups": (groups.get_model_parallel_world_size(),
                      groups.get_model_parallel_rank(),
                      comm.get_all_ranks_from_group(
                          groups.get_model_parallel_group()),
                      groups.get_tensor_parallel_world_size(),
                      groups.get_tensor_parallel_rank(),
                      comm.get_all_ranks_from_group(
                          groups.get_tensor_parallel_group()),
                      groups.get_data_parallel_world_size(),
                      comm.get_all_ranks_from_group(
                          groups.get_data_parallel_group()))}
    batches = args["batches"]

    # a model with no tensor-parallel form is refused, naming the hook
    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4))

        def forward(self, batch):
            return self.w.sum()

    try:
        _tp_engine_of(Probe(), zero_config(0))
        out["refused"] = None
    except NotImplementedError as e:
        out["refused"] = str(e)

    # partition_activations: the same bits, one all-gather a block
    for part in (False, True):
        engine = _tp_engine(args, zero_config(0), partition_activations=part)
        comm.reset_counts()
        losses = _steps(engine, batches, 3)
        out[f"partition_{part}"] = {
            "losses": losses, "counts": dict(comm.counts),
            "plan": engine.module.comm_plan(2, batches[0].shape[1])}

    # fp16: an inf in tp rank 0's slice of one gradient skips every rank
    config = {**zero_config(0, fused=False), "fp16": {"enabled": True}}
    engine = _tp_engine(args, config)
    w = engine.module.model.h[0].mlp.c_fc.weight
    before = _np(w)
    loss = engine({"input_ids": batches[0]})
    if tp.rank == 0:
        w.grad[0, 0] = float("inf")
    engine.backward(loss)
    engine.step()
    out["overflow"] = {"skipped": engine.get_skipped_steps(),
                       "applied": engine.was_step_applied(),
                       "unchanged": bool(np.array_equal(before, _np(w)))}

    # the whole state dict back from the slices, and re-sliced
    saved = engine.module_state_dict()
    engine.load_module_state_dict(
        {k: torch.zeros_like(v) for k, v in saved.items()})
    zeroed = float(sum(v.abs().sum() for v in
                       engine.module_state_dict().values()))
    engine.load_module_state_dict(saved)
    out["state_dict"] = {
        "shapes": {k: tuple(v.shape) for k, v in saved.items()},
        "wte": _np(saved["model.wte"]),
        "c_attn": _np(saved["model.h.0.attn.c_attn.weight"]),
        "zeroed": zeroed,
        "reloaded": max(float((v - saved[k]).abs().max()) for k, v in
                        engine.module_state_dict().items())}

    # zero.Init at stage 3: this rank's tp slice, then its ZeRO shard;
    # GatheredParameters gives the tp slice whole over data
    config = {**zero_config(3, stage3_param_persistence_threshold=0),
              "mesh": TP_MESH}
    model = zero.Init(config_dict_or_path=config).materialize(_gpt2(args))
    c_attn = model.model.h[0].attn.c_attn.weight
    res = {"init_shape": tuple(c_attn.shape)}
    runs = []
    for m in (model, _gpt2(args)):
        import deepspeed_tpu_torch

        engine = deepspeed_tpu_torch.initialize(model=m, config=config,
                                                device="cpu")[0]
        runs.append((float(engine({"input_ids": batches[0]})),
                     engine.get_global_grad_norm()))
    res["runs"] = runs
    params = [engine.module.model.h[0].attn.c_attn.weight,
              engine.module.model.ln_f.weight]
    with zero.GatheredParameters(params, modifier_rank=1):
        res["inside"] = [tuple(p.shape) for p in params]
        res["c_attn_inside"] = _np(params[0])
        with torch.no_grad():
            params[0][0, 0] = 7.0 + tp.rank if rank == 1 else -1.0
            params[1][0] = 3.0 if rank == 1 else -1.0
    sd = engine.module_state_dict()
    res["after"] = [tuple(p.shape) for p in params]
    res["c_attn"] = _np(sd["model.h.0.attn.c_attn.weight"])
    res["ln_f"] = _np(sd["model.ln_f.weight"])
    out["zero_init"] = res
    return out


# ---------------------------------------------------------------------------
# the Llama family
# ---------------------------------------------------------------------------
def _llama(weights, **extra):
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.utils.params import \
        llama_training_model_from_jax

    cfg = LlamaConfig.tiny(dtype=torch.float32, **extra)
    return llama_training_model_from_jax(weights, cfg)


def _llama_train(model, config, mesh, batches):
    """Step-1 gradients (reduced and merged whole) of the first batch,
    then one optimizer step a batch: ``(grads, losses, collectives,
    plan)``, the collectives and the plan those of the steps."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm

    engine = deepspeed_tpu_torch.initialize(model=model, config=config,
                                            mesh=mesh, device="cpu")[0]
    engine.module({"input_ids": torch.from_numpy(batches[0])}).backward()
    grads = {k: _np(v) for k, v in engine.gathered_grads().items()}
    engine.zero_grad()
    comm.reset_counts()
    losses = _steps(engine, batches, len(batches))
    plan = engine._zero.comm_plan(1, recompute=True) if engine._zero else {}
    rows, seq = batches[0].shape
    if engine.topology is not None:
        rows //= engine.topology.get_data_parallel_world_size()
    for k, v in engine.module.comm_plan(rows, seq).items():
        plan[k] = plan.get(k, 0) + v
    plan = {k: v * len(batches) for k, v in plan.items()}
    counts = {k: comm.counts.get(k, 0) for k in plan}
    return grads, losses, counts, plan


def llama(rank, world, args):
    """The Llama cases on one spawn: ZeRO stage 3 on ``{"data": world}``
    (``args["zero"]``), then for each tiny config of ``args["tp"]`` (KV
    heads that divide ``world`` and ones that do not) greedy and
    left-padded ``generate`` through ``init_inference(tensor_parallel=
    world)`` and one training step on ``{"tp": world}``, each with its
    step-1 gradients merged whole."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from deepspeed_tpu_torch.utils.params import llama_params_from_jax

    zero = args["zero"]
    remat = dict(remat=True, remat_policy="dots")
    out = {"zero": _llama_train(
        _llama(zero["weights"], num_key_value_heads=zero["kv"], **remat),
        zero["config"], {"data": world}, zero["batches"])}
    for case in args["tp"]:
        cfg = LlamaConfig.tiny(dtype=torch.float32,
                               num_key_value_heads=case["kv"])
        model = LlamaModel(cfg, device="meta")
        model.load_state_dict(llama_params_from_jax(case["weights"], cfg),
                              assign=True)
        engine = deepspeed_tpu_torch.init_inference(
            model, dtype="fp32", device="cpu",
            tensor_parallel={"tp_size": world})
        ids, mask = case["ids"], case["mask"]
        res = {"greedy": _generate(engine, ids, case["new"]),
               "padded": _generate(engine, ids, case["new"], mask),
               "split": sorted(n for n, s in engine.param_shardings.items()
                               if s is not None),
               "kv_heads": engine.module.layers[0].self_attn.n_kv}
        res["grads"], res["losses"], res["counts"], res["plan"] = \
            _llama_train(_llama(case["weights"],
                                num_key_value_heads=case["kv"], **remat),
                         case["config"], {"tp": world}, case["batches"])
        if case.get("partition"):  # partition_activations: T / tp rows
            res["partitioned"] = _llama_train(
                _llama(case["weights"], num_key_value_heads=case["kv"],
                       partition_activations=True, **remat),
                case["config"], {"tp": world}, case["batches"])[1:]
            # "full" remat: the collectives its recompute issues
            res["full"] = _llama_train(
                _llama(case["weights"], num_key_value_heads=case["kv"],
                       remat=True, remat_policy="full"),
                case["config"], {"tp": world}, case["batches"])[1:]
        out[f"tp-kv{case['kv']}"] = res
    if "gpt2" in args:  # GPT-2's plan under "full" remat, the same rule
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config
        from deepspeed_tpu_torch.utils.params import training_model_from_jax

        model = training_model_from_jax(
            args["gpt2"], GPT2Config.tiny(dtype=torch.float32, remat=True,
                                          remat_policy="full"))
        out["gpt2-full"] = _llama_train(model, args["tp"][0]["config"],
                                        {"tp": world},
                                        args["tp"][0]["batches"])[1:]
    return out


# ---------------------------------------------------------------------------
# BERT under tensor parallelism
# ---------------------------------------------------------------------------
def _bert(weights, **extra):
    from deepspeed_tpu_torch.models.bert import BertConfig
    from deepspeed_tpu_torch.utils.params import bert_training_model_from_jax

    cfg = BertConfig.tiny(dtype=torch.float32, remat=True,
                          remat_policy="dots", **extra)
    return bert_training_model_from_jax(weights, cfg)


def bert_train(rank, world, args):
    """Each BERT case of ``args["cases"]`` (name -> ``{"mesh", "config",
    "model"}``: the mesh, the engine config, the tiny model's extra
    fields and its JAX weights under ``"weights"``) for ``args["steps"]``
    steps on its global micro-batches (``"batches"``, dicts): as
    :func:`train` returns them, plus the decoder bias's first-step
    gradient and, after the steps, ``eval_batch``'s loss of each of
    ``"evals"``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    out = {}
    for name, case in args["cases"].items():
        topo = MeshTopology(axis_sizes=case["mesh"])
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=_bert(case["weights"], **case["model"]),
            config=case["config"], mesh=topo, device="cpu")
        batches = case["batches"]
        engine.module(engine._to_device(batches[0])).backward()
        bias = engine.module.model.decoder_bias.grad  # None: a ZeRO shard
        bias = None if bias is None else _np(bias)
        engine.zero_grad()
        losses, norms = [], []
        comm.reset_counts()
        for batch in batches[:args["steps"]]:
            losses.append(float(engine(batch)))
            engine.backward(None)
            engine.step()
            norms.append(engine.get_global_grad_norm())
        counts = dict(comm.counts)
        zero = engine._zero
        plan = zero.comm_plan(1, recompute=True)
        ids = batches[0]["input_ids"]
        rows, seq = engine.spec_layout.batch_sharding(
            ids.ndim, ids.shape).shard_shape
        for k, v in engine.module.comm_plan(rows, seq).items():
            plan[k] = plan.get(k, 0) + v
        out[name] = {
            "losses": losses, "norms": norms, "decoder_bias_grad": bias,
            "evals": [float(engine.eval_batch(b)) for b in case["evals"]],
            "counts": {k: counts.get(k, 0) for k in plan},
            "plan": {k: v * args["steps"] for k, v in plan.items()},
            "param_shapes": {e.name: tuple(e.param.shape)
                             for e in zero.entries},
            "master_shapes": {e.name: tuple(e.master.shape)
                              for e in zero.entries},
            "applied": engine.was_step_applied()}
        params = engine.module_state_dict()
        if rank == 0:
            out[name]["params"] = {k: _np(v) for k, v in params.items()}
    return out


def bert_tp_checks(rank, world, args):
    """BERT's tensor-parallel pieces on ``{"data": 2, "tp": 2}``:
    ``partition_activations`` against the run without it (losses and the
    collectives of 3 steps); each rank's sparse layout (``fixed`` per head
    and ``bigbird``) at its heads; ``module_state_dict`` /
    ``load_module_state_dict``; ``eval_batch`` under ZeRO 3 and
    ``partition_activations`` after one step, and the state it leaves."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import bert as port_bert

    batches = args["batches"]

    def engine_of(config, **extra):
        return deepspeed_tpu_torch.initialize(
            model=_bert(args["weights"], **extra),
            config={**config, "tensor_parallel": {"policy": "bert"}},
            mesh=TP_MESH, device="cpu")[0]

    out = {}
    for part in (False, True):
        engine = engine_of(zero_config(0), partition_activations=part)
        comm.reset_counts()
        losses = [float(engine(b)) for b in batches]
        out[f"partition_{part}"] = {
            "losses": losses, "counts": dict(comm.counts),
            "plan": engine.module.comm_plan(
                2, batches[0]["input_ids"].shape[1])}

    # each rank's rows of the layout drawn at all heads
    tp_rank = engine.tp.rank
    layouts = {}
    for name, section in args["sparse"].items():
        model = engine_of(zero_config(0), sparse_attention=section).module
        attn = model.model.bert.encoder.layers[0].attention.self
        cfg = model.config
        sp = port_bert._sparse_attn_for(
            cfg.sparse_attention, cfg.num_attention_heads,
            cfg.max_position_embeddings,
            heads=(tp_rank * attn.n_head, (tp_rank + 1) * attn.n_head))
        layouts[name] = sp._layout(args["seq"])
    out["layouts"] = layouts

    # the whole state dict back from the slices, and re-sliced
    saved = engine.module_state_dict()
    engine.load_module_state_dict(
        {k: torch.zeros_like(v) for k, v in saved.items()})
    zeroed = float(sum(v.abs().sum() for v in
                       engine.module_state_dict().values()))
    engine.load_module_state_dict(saved)
    out["state_dict"] = {
        "shapes": {k: tuple(v.shape) for k, v in saved.items()},
        "word_embeddings": _np(saved["model.bert.word_embeddings"]),
        "query": _np(saved["model.bert.encoder.layers.0.attention.self."
                           "query.weight"]),
        "zeroed": zeroed,
        "reloaded": max(float((v - saved[k]).abs().max()) for k, v in
                        engine.module_state_dict().items())}

    # eval_batch after one step: its loss, and the state untouched
    engine = engine_of(zero_config(3, stage3_param_persistence_threshold=0),
                       partition_activations=True)
    engine.backward(engine(batches[0]))
    engine.step()
    before = [_np(e.param) for e in engine._zero.entries]
    masters = [_np(e.master) for e in engine._zero.entries]
    slots = _flat_state(engine._opt_state)
    loss = float(engine.eval_batch(batches[1]))
    after = _flat_state(engine._opt_state)
    out["eval"] = {
        "loss": loss,
        "params": all(np.array_equal(b, _np(e.param)) for b, e in
                      zip(before, engine._zero.entries)),
        "masters": all(np.array_equal(b, _np(e.master)) for b, e in
                       zip(masters, engine._zero.entries)),
        "slots": len(slots) == len(after) and all(
            np.array_equal(a, b) for a, b in zip(slots, after)),
        "grads": all(e.param.grad is None and e.slot is None
                     for e in engine._zero.entries),
        "counters": (engine.global_steps, engine.micro_steps)}
    return out


def _flat_state(state):
    """An optimizer state's tensors and counters, flat, on the host."""
    if isinstance(state, torch.Tensor):
        return [_np(state)]
    if isinstance(state, (list, tuple)):
        return [a for part in state for a in _flat_state(part)]
    return [] if state is None else [np.asarray(state)]


# ---------------------------------------------------------------------------
# checkpoints across layouts
# ---------------------------------------------------------------------------
def checkpoint_reshard(rank, world, args):
    """Checkpoints saved under one layout and loaded under another, on 2
    ranks: ZeRO 2 on ``{"data": 2}`` takes 2 steps, saves to
    ``<dir>/z2`` and takes steps 3 and 4 (the uninterrupted run); ZeRO 3
    (every weight split) loads that tag and takes steps 3 and 4; tp=2
    (``{"tp": 2}``, ZeRO 0) takes 2 steps, saves to ``<dir>/tp2`` and
    takes steps 3 and 4. Each case's losses on every rank; on rank 0 also
    its whole Adam state (``step`` and the gathered slots) as saved or as
    loaded, its whole parameters after step 4 and its topology manifest.
    Every engine runs ``args["scheduler"]``, as the parent's does. The
    parent loads both tags at ZeRO 0 and tp=1 on one rank."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    batches, ckpt = args["batches"], args["dir"]

    def engine(config, mesh):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=_gpt2(args),
            config={**config, "scheduler": args["scheduler"]},
            mesh=MeshTopology(axis_sizes=mesh), device="cpu")
        return eng

    def steps(eng, ids):
        out = []
        for b in ids:
            loss = eng({"input_ids": b})
            eng.backward(loss)
            eng.step()
            out.append(float(loss))
        return out

    # copies: a tensor left whole is the live slot or parameter itself
    def adam_state(eng):  # collectives: every rank calls
        opt = eng._opt_state
        state = {k: {n: v.numpy().copy() for n, v in
                     eng._whole_slots(getattr(opt, k)).items()}
                 for k in ("exp_avg", "exp_avg_sq")}
        return {"step": int(opt.step), **state}

    def params(eng):  # collectives: every rank calls
        return {k: v.detach().cpu().numpy().copy()
                for k, v in eng.module_state_dict().items()}

    out, extra = {}, {}
    z2 = engine(zero_config(2), {"data": 2})
    out["z2"] = steps(z2, batches[:2])
    z2.save_checkpoint(os.path.join(ckpt, "z2"))
    extra["z2_saved"] = adam_state(z2)
    out["z2"] += steps(z2, batches[2:4])
    extra["z2_params"] = params(z2)
    extra["z2_topology"] = z2.describe_topology(include_data=False)
    z3 = engine(zero_config(3, stage3_param_persistence_threshold=0),
                {"data": 2})
    out["z3_split"] = any(e.pplan.sharded for e in z3._zero.entries)
    out["z3_tag"] = z3.load_checkpoint(os.path.join(ckpt, "z2"))[0]
    extra["z3_loaded"] = adam_state(z3)
    out["z3"] = steps(z3, batches[2:4])
    extra["z3_params"] = params(z3)
    extra["z3_topology"] = z3.describe_topology(include_data=False)
    tp = engine({**zero_config(0), "train_micro_batch_size_per_gpu": 4},
                {"tp": 2})
    out["tp2"] = steps(tp, batches[:2])
    tp.save_checkpoint(os.path.join(ckpt, "tp2"))
    extra["tp2_saved"] = adam_state(tp)
    out["tp2"] += steps(tp, batches[2:4])
    extra["tp2_params"] = params(tp)
    extra["tp2_topology"] = tp.describe_topology(include_data=False)
    return {**out, **extra} if rank == 0 else out
