"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``).

Wraps a :class:`~deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel` or a
:class:`~deepspeed_tpu_torch.models.llama.LlamaModel` on one device (its
window ``n_positions`` or ``max_position_embeddings``:
:func:`model_window`): the weights are cast to the config dtype once
(``_convert_dtype`` in the JAX engine), ``forward``/``forward_last`` run
the causal forward, and ``generate`` runs one prefill then a Python loop
of decode steps over an append KV cache, sampling greedily or with temperature/top-k/top-p
from a ``torch.Generator``, or, given a ``seed``, with the keyed sampler
(``ops/sampling.py``): the token at absolute position P is a pure
function of (seed, P, logits), the same as the JAX engine's and the
serving engine's for the same request. The loop keeps the tokens on the
device: it never waits on the host between steps.

A left-padded ``attention_mask`` batches prompts of unequal length: the
prefill masks each row's pads, and the decode steps start each row's keys
at its first real one (the append kernel's per-row first key). With a
``serving`` section, ``bucket_legacy_generate`` left-pads every prompt up
to the serving bucket set the same way, and strips the pads on return.

Tensor and data parallelism (``tensor_parallel={"tp_size": N}``): one
process a rank, each calling the engine with the same arguments on a
process group of ``data x N`` ranks (``comm.init_distributed``; the mesh
is :func:`~deepspeed_tpu_torch.parallel.topology.resolve_tp_topology`'s,
``data = world / N``, as JAX's ``MeshTopology(axis_sizes={"tp": N})``).
Each rank holds the whole model on the host, keeps its slices by the
injection policy (``module_inject``, :meth:`GPT2LMHeadModel.tp_specs`)
and moves only those to its device; the ranks of a tp group return the
same bits, since the row-parallel all-reduce gives each the same sums.
``forward``, ``forward_last`` and ``generate`` take the GLOBAL batch on
every rank: data group ``d`` runs rows ``[d * ceil(B / data), ...)`` and
the results are all-gathered over ``data``, so every rank returns the
whole tensor, as the JAX engine returns a global array. Rows that do not
divide are padded by repeating the batch's last row up to ``ceil(B /
data)`` a rank and trimmed after the gather (a rank with no real row
computes a copy and still joins every collective). Keyed sampling keys
each row on (seed, its global row's absolute position), so its tokens do
not depend on ``data``; unkeyed sampling draws from each rank's own
``torch.Generator``, so its draws depend on ``data`` too (they differ
from the JAX engine's already). A rank-local engine under a running
group takes an explicit one-rank mesh
(:func:`~deepspeed_tpu_torch.parallel.topology.rank_local_mesh`).

Every ``forward``, ``forward_last`` and ``generate`` call is timed on the
host, ending in a synchronize of the device, into the list
:meth:`InferenceEngine.model_times` drains (a rank times its own rows,
not the gather); each entry is mirrored into the telemetry stream as a
``model_time`` event, and each ``generate`` is a step boundary of the
engine's ``Telemetry(name="inference")`` (the ``telemetry`` section)
and of its ``Resilience(name="inference", serving=True)`` (the
``resilience`` section: the hang watchdog's stall timer runs while a
request is in flight).

Checkpoints (JAX's ``resolve_checkpoint_params`` / ``load_module_params``
/ ``save_mp_checkpoint``): ``checkpoint=`` names a checkpoint directory
of either package — a training ``save_checkpoint`` directory (its
``latest`` tag), one tag directory, or a ``save_mp_checkpoint_path``
output — whose module file replaces the model's weights before the
engine slices and casts them (build the model on ``meta`` to skip its
init); ``save_mp_checkpoint_path`` writes the dtype-converted whole
weights in the same layout, and ``load_checkpoint`` swaps the served
weights in place.

Not in this slice: weight-only int8.
"""

import time
import warnings
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.module_inject.layers import TensorParallel
from deepspeed_tpu_torch.module_inject.policies import (
    get_tp_policy, shard_params_with_policy)
from deepspeed_tpu_torch.parallel.topology import (AXIS_DATA, AXIS_TP,
                                                   MeshTopology,
                                                   resolve_tp_topology)
from deepspeed_tpu_torch.models.decode_utils import validate_left_padded_mask
from deepspeed_tpu_torch.ops.sampling import keyed_sample
from deepspeed_tpu_torch.serving.config import (ServingConfig, bucket_for,
                                                resolve_buckets)
from deepspeed_tpu_torch.runtime.resilience.manager import Resilience
from deepspeed_tpu_torch.telemetry.manager import Telemetry
from deepspeed_tpu_torch.utils.logging import log_dist


def warn_inert_options(config):
    """Name each inference option that is accepted but has no effect on
    this backend, set to another value than its default
    (``config.inert_notes()``): the call keeps working, and the user
    learns the knob does nothing here."""
    for name, why in config.inert_notes():
        log_dist(f"inference config '{name}' has no effect on this "
                 f"backend: {why}", ranks=[0])


def resolve_checkpoint_params(checkpoint, base_dir=""):
    """The JAX-layout param tree for an engine's ``checkpoint=`` (a
    checkpoint directory, joined onto ``base_dir`` when relative);
    anything else fails loudly, as in the JAX engine."""
    import os

    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError

    if base_dir and isinstance(checkpoint, str) \
            and not os.path.isabs(checkpoint):
        checkpoint = os.path.join(base_dir, checkpoint)
    if isinstance(checkpoint, str) and os.path.isdir(checkpoint):
        return load_module_params(checkpoint)
    raise DeepSpeedConfigError(
        f"checkpoint= resolved to {checkpoint!r}, which is not a "
        "checkpoint DIRECTORY (training save_checkpoint layout or a "
        "save_mp_checkpoint_path output); for HF model names / "
        "sharded-index dirs use deepspeed_tpu_torch.inference.auto."
        "from_pretrained")


def load_module_params(load_dir, tag=None):
    """The module file's param tree (nested dicts of numpy arrays, bf16
    leaves as fp32) from a checkpoint directory: ``<load_dir>/<tag>``
    with the tag from ``latest`` (``global_step0`` without one), or
    ``load_dir`` itself when it is a tag directory."""
    import os

    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine \
        import ArrayCheckpointEngine, read_latest, unflatten_by_paths

    if tag is None and os.path.exists(os.path.join(load_dir, "module.npz")):
        path = os.path.join(load_dir, "module")
    else:
        if tag is None:
            tag = read_latest(load_dir) or "global_step0"
        path = os.path.join(load_dir, str(tag), "module")
    state = ArrayCheckpointEngine().load(path)
    state = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in state.items()}
    return unflatten_by_paths(state, "params/")


def save_mp_checkpoint(path, model, dtype):
    """``save_mp_checkpoint_path``: rank 0 writes the whole model's
    weights cast to ``dtype`` as ``<path>/inference/module`` (the JAX
    layout; bf16 leaves carry the ``#dtype`` marker) and ``latest``;
    every rank waits for it."""
    import os

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine \
        import ArrayCheckpointEngine, atomic_write_text

    if comm.get_rank() == 0:
        tag = "inference"
        sd = {k: (v.to(dtype) if v.is_floating_point() else v)
              for k, v in model.state_dict().items()}
        ArrayCheckpointEngine().save({"params": jax_tree_of(model, sd)},
                                     os.path.join(path, tag, "module"))
        atomic_write_text(os.path.join(path, "latest"), tag)
        log_dist(f"saved inference (mp) checkpoint to {path}", ranks=[0])
    if comm.get_world_size() > 1:
        comm.barrier()


def jax_tree_of(model, state_dict):
    """The JAX model's flax tree of an inference model's whole state
    dict (GPT-2 or Llama)."""
    from deepspeed_tpu_torch.utils import params as P

    if hasattr(model.config, "n_layer"):
        return P.params_to_jax(state_dict, model.config)
    return P.llama_params_to_jax(state_dict, model.config)


def state_dict_from_jax(model, tree):
    """An inference model's whole state dict from the JAX model's flax
    tree (GPT-2 or Llama)."""
    from deepspeed_tpu_torch.utils import params as P

    if hasattr(model.config, "n_layer"):
        return P.params_from_jax(tree, model.config)
    return P.llama_params_from_jax(tree, model.config)


def model_window(model_config) -> int:
    """The positions a model's KV cache holds: the GPT-2 family's
    ``n_positions``, else ``max_position_embeddings`` (Llama's name, and
    HF configs' generally)."""
    return (getattr(model_config, "n_positions", None)
            or getattr(model_config, "max_position_embeddings", None))


def filter_logits(logits, temperature, top_k: int, top_p: float):
    """Temperature, then top-k, then nucleus (top-p) filtering in fp32:
    filtered entries become ``-inf``. Nucleus keeps the smallest prefix of
    the sorted distribution whose mass reaches ``top_p`` (the first token
    past the threshold stays, HF-style)."""
    logits = logits.float() / max(float(temperature), 1e-6)
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.tensor(float("inf"),
                                          device=logits.device)).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


def sample_logits(logits, generator, temperature, do_sample: bool,
                  top_k: int, top_p: float):
    """Greedy/temperature/top-k/top-p next-token sampling over the last
    dim, shared by ``generate`` and the serving engine. Greedy takes the
    first maximal index."""
    if not do_sample:
        return torch.argmax(logits.float(), dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        probs.shape[:-1])


def _run_loop(loop, ids, label):
    """``generate``'s decode loop, through the signature watch (``ids``
    and ``label`` name the call)."""
    return loop()


class InferenceEngine:
    """``InferenceEngine(model, config=None, device=None, seed=0,
    mesh=None, **config_kwargs)``: ``device=None`` is the card; ``seed``
    seeds the sampling generator (the weights come with the model, whole);
    ``mesh`` a :class:`~deepspeed_tpu_torch.parallel.topology.
    MeshTopology` (or an axis dict) whose ``tp`` axis shards the model,
    by default ``resolve_tp_topology(tensor_parallel.tp_size)``.

    ``topo``, ``mp_world_size``, ``policy`` and ``param_shardings`` (each
    whole-model parameter name -> its spec over ``tp``, None where
    replicated) are the JAX engine's attributes."""

    def __init__(self, model, config=None, device=None, seed: int = 0,
                 mesh=None, **kwargs):
        if config is None:
            config = DeepSpeedInferenceConfig(**kwargs)
        elif isinstance(config, dict):
            config = DeepSpeedInferenceConfig(**{**config, **kwargs})
        elif kwargs:
            merged = {**config.model_dump(exclude_unset=True), **kwargs}
            config = DeepSpeedInferenceConfig(**merged)
        self._config = config
        warn_inert_options(config)
        self.device = resolve_device(device)
        # the data x tp mesh (reference _create_model_parallel_group)
        if mesh is None:
            self.topo = resolve_tp_topology(config.tensor_parallel.tp_size)
        else:
            self.topo = mesh if isinstance(mesh, MeshTopology) \
                else MeshTopology(axis_sizes=mesh)
        extra = {a: s for a, s in self.topo.shape.items()
                 if s > 1 and a not in (AXIS_DATA, AXIS_TP)}
        if extra:
            raise ValueError(f"inference runs on a data x tp mesh; "
                             f"{self.topo.shape} has {extra}")
        self.mp_world_size = self.topo.get_model_parallel_world_size()
        self.dp_world_size = self.topo.axis_size(AXIS_DATA)
        self.dp_rank = int(getattr(self.topo.coord, AXIS_DATA))
        self.policy = get_tp_policy(config.injection_policy
                                    or config.injection_policy_tuple)
        self.model_config = model.config
        if config.checkpoint is not None:
            # the checkpoint's weights replace the model's, whole, before
            # the engine slices and casts them
            model.load_state_dict(state_dict_from_jax(
                model, resolve_checkpoint_params(config.checkpoint,
                                                 config.base_dir)),
                assign=True)
        if config.save_mp_checkpoint_path:
            save_mp_checkpoint(config.save_mp_checkpoint_path, model,
                               config.dtype)
        model = self._shard(model)
        # reference _convert_to_dtype: weights cast once, moved to the
        # device, frozen (inference only: the kernels have no backward)
        self.module = model.to(device=self.device, dtype=config.dtype)
        self.module.requires_grad_(False)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self._serving_cfg = (ServingConfig(**config.serving)
                             if config.serving is not None else None)
        # the decode-mode modules sharing the weights, unpadded and padded
        self._decode_models = {}
        self._model_times = []
        self.model_profile_enabled = False
        self.telemetry = Telemetry(config.telemetry, name="inference")
        # the hang watchdog covers serving too: a wedged collective in a
        # generate step stalls request progress as a training stall
        # stops step boundaries
        self.resilience = Resilience(config.resilience,
                                     telemetry=self.telemetry,
                                     name="inference", serving=True)
        self._request_count = 0
        # the forwards through the signature watch (themselves with
        # telemetry off), unbound: a bound method kept on the engine
        # would make a reference cycle that outlives a `del engine`
        self._forward_fn = self.telemetry.watch_jit(
            InferenceEngine._logits, "inference.forward")
        self._forward_last_fn = self.telemetry.watch_jit(
            InferenceEngine._last_logits, "inference.forward_last")
        self._generate_fn = self.telemetry.watch_jit(
            _run_loop, "inference.generate",
            name_of=lambda loop, ids, label: label)
        log_dist(f"InferenceEngine: device={self.device} "
                 f"dtype={config.dtype} tp={self.mp_world_size} "
                 f"data={self.dp_world_size}", ranks=[0])

    def _shard(self, model):
        """This rank's tensor-parallel slice of the whole ``model`` (still
        on the host), built on ``meta`` and given this rank's slices of
        the weights; the model itself at tp 1. Sets ``param_shardings``."""
        tp_size = self.mp_world_size
        if tp_size <= 1:
            self.param_shardings = {n: None for n, _ in
                                    model.named_parameters()}
            return model
        rank = self.topo.get_tensor_parallel_rank()
        specs = model.tp_specs(self.policy, tp_size)
        local, _ = shard_params_with_policy(model.state_dict(), self.policy,
                                            rank, tp_size, specs=specs)
        tp = TensorParallel(group=self.topo.get_tensor_parallel_group(),
                            size=tp_size, rank=rank, specs=specs)
        sliced = type(model)(model.config, device="meta", tp=tp)
        sliced.load_state_dict(local, assign=True)
        self.param_shardings = specs
        return sliced

    # ------------------------------------------------------------------
    def mode_module(self, config):
        """A module of the same family in another mode (``for_decode``,
        ``for_paged_decode``) sharing this engine's weight tensors (and
        its tensor-parallel slice)."""
        module = type(self.module)(config, device="meta",
                                   tp=getattr(self.module, "tp", None))
        module.load_state_dict(self.module.state_dict(), assign=True)
        return module

    def _decode_module(self, padded: bool):
        """The decode-mode module (``for_decode(padded)``), built once."""
        if padded not in self._decode_models:
            self._decode_models[padded] = self.mode_module(
                self.model_config.for_decode(padded=padded))
        return self._decode_models[padded]

    @staticmethod
    def _logits_of(out):
        """Models may return (logits, aux); inference wants the logits."""
        return out[0] if isinstance(out, tuple) else out

    def _ids(self, input_ids):
        ids = torch.as_tensor(input_ids, device=self.device).long()
        return ids[None] if ids.dim() == 1 else ids

    def _timed(self, name, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, its host time up to a synchronize of
        the device appended to the model times (and the stream)."""
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._record_model_time(name, time.perf_counter() - start)
        return out

    def _record_model_time(self, name: str, seconds: float):
        """One forward / generate latency: buffered for
        :meth:`model_times` and mirrored into the telemetry stream (kind
        ``model_time``), as in the JAX engine."""
        self._model_times.append(seconds)
        self.telemetry.emit("model_time", name, step=self._request_count,
                            ms=round(1e3 * seconds, 4))

    # ------------------------------------------------------------------
    # the batch over data (module docstring)
    def _share(self, batch: int):
        """This data rank's row indices of a global batch of ``batch``
        rows, padded to ``ceil(batch / data)`` by repeating the last row;
        None when ``data`` is 1."""
        if self.dp_world_size == 1:
            return None
        per = -(-batch // self.dp_world_size)
        rows = torch.arange(self.dp_rank * per, (self.dp_rank + 1) * per)
        return rows.clamp(max=batch - 1)

    def _gather_rows(self, out, batch: int):
        """Every data rank's rows of ``out`` concatenated in rank order
        and trimmed to the ``batch`` real rows."""
        if self.dp_world_size == 1:
            return out
        from deepspeed_tpu_torch import comm

        whole = comm.all_gather(out, group=self.topo.group(AXIS_DATA),
                                tiled=True)
        return whole[:batch]

    def _local(self, ids, fn):
        """``fn`` on this data rank's rows of ``ids``, gathered whole."""
        rows = self._share(ids.shape[0])
        if rows is None:
            return fn(ids)
        return self._gather_rows(fn(ids[rows.to(ids.device)]),
                                 ids.shape[0])

    @torch.inference_mode()
    def forward(self, input_ids):
        """Full (non-cached) forward: fp32 logits ``[B, T, vocab]``."""
        return self._local(self._ids(input_ids), lambda ids: self._timed(
            "forward", self._forward_fn, self, ids))

    __call__ = forward

    def _logits(self, ids):
        return self._logits_of(self.module(ids))

    def _last_logits(self, ids):
        hidden = self.module(ids, return_hidden=True)
        return self.module.lm_head(hidden[:, -1])

    @torch.inference_mode()
    def forward_last(self, input_ids):
        """Last-position logits only: the LM head runs on one position."""
        return self._local(self._ids(input_ids), lambda ids: self._timed(
            "forward_last", self._forward_last_fn, self, ids))

    def profile_model_time(self, use_cuda_events=None):
        """The JAX engine's: latencies are always collected (each call
        ends in a synchronize), so this only records the request;
        ``use_cuda_events`` is accepted, warned about and ignored."""
        if use_cuda_events is not None:
            warnings.warn(
                "profile_model_time(use_cuda_events=...) is ignored: every "
                "forward and generate call is synchronized and timed on "
                "the host regardless", DeprecationWarning, stacklevel=2)
        self.model_profile_enabled = True

    def model_times(self):
        """The host seconds of each forward / generate call since the
        last drain; drains the list."""
        times, self._model_times = self._model_times, []
        return times

    def load_checkpoint(self, load_dir, tag=None):
        """Serve the module weights of a checkpoint directory (JAX's
        ``load_checkpoint``): whole tensors, sliced for this rank and
        cast, copied into the served weights in place."""
        sd = state_dict_from_jax(self.module,
                                 load_module_params(load_dir, tag))
        if self.mp_world_size > 1:
            sd, _ = shard_params_with_policy(
                sd, self.policy, self.topo.get_tensor_parallel_rank(),
                self.mp_world_size, specs=self.param_shardings)
        with torch.no_grad():
            for name, t in self.module.state_dict().items():
                if name in sd:
                    t.copy_(sd[name])
        self._decode_models.clear()

    def destroy(self):
        """Drop the decode-mode modules and the model times and close the
        resilience manager and the telemetry (stopping an open trace
        window), as the JAX engine releases its compiled programs."""
        self._decode_models.clear()
        self._model_times = []
        self.resilience.close()
        self.telemetry.close()

    def eval(self):
        return self

    def train(self, mode=False):
        return self

    # ------------------------------------------------------------------
    def generate(self, input_ids, max_new_tokens: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 0.0, eos_token_id: int = -1,
                 attention_mask=None, generator=None, seed=None):
        """:meth:`_generate` inside the resilience bracket: the hang
        watchdog's stall timer runs only while a request is in flight,
        and a raising request clears its bracket."""
        self.resilience.serving_request_begin()
        try:
            return self._generate(
                input_ids, max_new_tokens=max_new_tokens,
                do_sample=do_sample, temperature=temperature, top_k=top_k,
                top_p=top_p, eos_token_id=eos_token_id,
                attention_mask=attention_mask, generator=generator,
                seed=seed)
        except BaseException:
            self.resilience.serving_request_abandon()
            raise

    @torch.inference_mode()
    def _generate(self, input_ids, max_new_tokens: Optional[int] = None,
                  do_sample: bool = False, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 0.0, eos_token_id: int = -1,
                  attention_mask=None, generator=None, seed=None):
        """Autoregressive generation (timed into :meth:`model_times`). Returns ``[batch, prompt_len +
        max_new_tokens]`` token ids on the engine's device (prompt
        included, HF-style); after ``eos_token_id`` a row repeats it
        (``-1`` disables the stop). ``attention_mask`` (``[B, T]``, 0 =
        LEFT padding) batches prompts of unequal length: per-row positions
        start at the first real token and padded cache slots are never
        attended; an all-real mask is the unpadded call.

        ``do_sample=True`` with ``seed`` set selects the keyed sampler:
        the first token is drawn at position ``prompt_len`` (each row's
        real length under a mask) and each later one at the next
        position, from ``fold_in(PRNGKey(seed), position)`` (``generator``
        is not used); a ``seed`` with ``do_sample=False`` is greedy, as in
        the JAX engine."""
        ids = self._ids(input_ids)
        B, T = ids.shape
        limit = model_window(self.model_config)
        if max_new_tokens is None:
            max_new_tokens = min(self._config.max_out_tokens, limit) - T
        if T + max_new_tokens > limit:
            raise ValueError(
                f"prompt ({T}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"model window {limit}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if attention_mask is not None:
            attention_mask = validate_left_padded_mask(ids, attention_mask)
        # serving-bucketed prompts: pad LEFT up to the bucket set (the
        # padded path gives the same tokens); the pads are stripped on
        # return
        trim = 0
        scfg = self._serving_cfg
        if scfg is not None and scfg.enabled and scfg.bucket_legacy_generate:
            ids, attention_mask, trim = self._bucket_prompt(
                ids, attention_mask, limit, max_new_tokens)
        generator = generator or self.generator
        padded = attention_mask is not None
        keyed = bool(do_sample) and seed is not None
        # the first generated token's absolute position: the REAL prompt
        # length, per row under left padding, so pads never shift the key
        # stream (read from the host-validated mask once, before the loop)
        first_pos = (attention_mask.sum(dim=1).cpu().numpy() if padded
                     else np.full(B, ids.shape[1]))
        # this data rank's rows keep their global row's first position
        rows = self._share(B)
        if rows is not None:
            first_pos = first_pos[rows.numpy()]
            ids = ids[rows.to(ids.device)]
            if padded:
                attention_mask = attention_mask[rows.to(ids.device)]
        b = ids.shape[0]
        model = self._decode_module(padded)
        cache = model.new_cache(b)

        def next_token(input_ids, step, mask=None):
            hidden = model(input_ids, cache=cache, return_hidden=True,
                           attention_mask=mask)
            logits = model.lm_head(hidden[:, -1])
            if keyed:
                return keyed_sample(logits, [seed] * b, first_pos + step,
                                    [1] * b, [temperature] * b, [top_k] * b,
                                    [top_p] * b)
            return sample_logits(logits, generator, temperature, do_sample,
                                 top_k, top_p)

        def loop():
            token = next_token(ids, 0, attention_mask)
            done = token == eos_token_id
            tokens = [token]
            for step in range(1, max_new_tokens):
                nxt = next_token(token[:, None], step)
                nxt = torch.where(done, torch.full_like(nxt, eos_token_id),
                                  nxt)
                done = done | (nxt == eos_token_id)
                tokens.append(nxt)
                token = nxt
            return torch.cat([ids[:, trim:], torch.stack(tokens, dim=1)],
                             dim=1)

        # JAX's program label: one a (prompt, budget, sampler) build
        label = (f"inference.generate[T={ids.shape[1]},"
                 f"new={max_new_tokens},"
                 + (f"keyed=True,padded={padded}]" if keyed else
                    f"sample={bool(do_sample)},k={int(top_k)},"
                    f"p={float(top_p)},padded={padded}]"))
        out = self._gather_rows(self._timed(
            "generate", self._generate_fn, loop, ids, label), B)
        # request boundary: memory sample / trace window (the timing's
        # synchronize above is the fence it piggybacks on)
        self._request_count += 1
        self.telemetry.on_step_boundary(self._request_count, samples=int(B))
        self.resilience.serving_heartbeat(self._request_count)
        return out

    def _bucket_prompt(self, ids, attention_mask, limit, max_new_tokens):
        """Round the prompt length up to the serving bucket set by LEFT
        padding (plus a mask marking the pads), as the serving engine
        buckets its prefills. Skipped when the padded length would
        overflow the model window. Returns ``(ids, mask, pads added)``."""
        B, T = ids.shape
        scfg = self._serving_cfg
        buckets = resolve_buckets(scfg.prompt_buckets, limit,
                                  floor=scfg.block_size)
        bT = bucket_for(T, buckets)
        if bT is None or bT == T or bT + max_new_tokens > limit:
            return ids, attention_mask, 0
        pad = bT - T
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int32,
                                        device=ids.device)
        ids = torch.cat([ids.new_zeros((B, pad)), ids], dim=1)
        attention_mask = torch.cat(
            [attention_mask.new_zeros((B, pad)), attention_mask], dim=1)
        return ids, attention_mask, pad
