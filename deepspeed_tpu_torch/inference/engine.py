"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``).

Wraps a :class:`~deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel` on one
device: the weights are cast to the config dtype once (``_convert_dtype``
in the JAX engine), ``forward``/``forward_last`` run the causal forward,
and ``generate`` runs one prefill then a Python loop of decode steps over
an append KV cache, sampling greedily or with temperature/top-k/top-p
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

Not in this slice: weight-only int8, tensor parallelism, telemetry and
resilience.
"""

from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models.decode_utils import validate_left_padded_mask
from deepspeed_tpu_torch.ops.sampling import keyed_sample
from deepspeed_tpu_torch.serving.config import (ServingConfig, bucket_for,
                                                resolve_buckets)
from deepspeed_tpu_torch.utils.logging import log_dist


def warn_inert_options(config):
    """Name each inference option that is accepted but has no effect on
    this backend, set to another value than its default
    (``config.inert_notes()``): the call keeps working, and the user
    learns the knob does nothing here."""
    for name, why in config.inert_notes():
        log_dist(f"inference config '{name}' has no effect on this "
                 f"backend: {why}", ranks=[0])


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


class InferenceEngine:
    """``InferenceEngine(model, config=None, device=None, seed=0,
    **config_kwargs)``: ``device=None`` is the card; ``seed`` seeds the
    sampling generator (the weights come with the model)."""

    def __init__(self, model, config=None, device=None, seed: int = 0,
                 **kwargs):
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
        self.model_config = model.config
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
        log_dist(f"InferenceEngine: device={self.device} "
                 f"dtype={config.dtype}", ranks=[0])

    # ------------------------------------------------------------------
    def mode_module(self, config):
        """A module of the same family in another mode (``for_decode``,
        ``for_paged_decode``) sharing this engine's weight tensors."""
        module = type(self.module)(config, device="meta")
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

    @torch.inference_mode()
    def forward(self, input_ids):
        """Full (non-cached) forward: fp32 logits ``[B, T, vocab]``."""
        return self._logits_of(self.module(self._ids(input_ids)))

    __call__ = forward

    @torch.inference_mode()
    def forward_last(self, input_ids):
        """Last-position logits only: the LM head runs on one position."""
        hidden = self.module(self._ids(input_ids), return_hidden=True)
        return self.module.lm_head(hidden[:, -1])

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 0.0, eos_token_id: int = -1,
                 attention_mask=None, generator=None, seed=None):
        """Autoregressive generation. Returns ``[batch, prompt_len +
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
        limit = self.model_config.n_positions
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
        model = self._decode_module(padded)
        cache = model.new_cache(B)

        keyed = bool(do_sample) and seed is not None
        # the first generated token's absolute position: the REAL prompt
        # length, per row under left padding, so pads never shift the key
        # stream (read from the host-validated mask once, before the loop)
        first_pos = (attention_mask.sum(dim=1).cpu().numpy() if padded
                     else np.full(B, ids.shape[1]))

        def next_token(input_ids, step, mask=None):
            hidden = model(input_ids, cache=cache, return_hidden=True,
                           attention_mask=mask)
            logits = model.lm_head(hidden[:, -1])
            if keyed:
                return keyed_sample(logits, [seed] * B, first_pos + step,
                                    [1] * B, [temperature] * B, [top_k] * B,
                                    [top_p] * B)
            return sample_logits(logits, generator, temperature, do_sample,
                                 top_k, top_p)

        token = next_token(ids, 0, attention_mask)
        done = token == eos_token_id
        tokens = [token]
        for step in range(1, max_new_tokens):
            nxt = next_token(token[:, None], step)
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
            tokens.append(nxt)
            token = nxt
        return torch.cat([ids[:, trim:], torch.stack(tokens, dim=1)], dim=1)

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
