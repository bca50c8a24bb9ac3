"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``).

Wraps a :class:`~deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel` on one
device: the weights are cast to the config dtype once (``_convert_dtype``
in the JAX engine), ``forward``/``forward_last`` run the causal forward,
and ``generate`` runs one prefill then a Python loop of decode steps over
an append KV cache, sampling greedily or with temperature/top-k/top-p
from a ``torch.Generator``. The loop keeps the tokens on the device: it
never waits on the host between steps.

Not in this slice: weight-only int8, the keyed threefry sampler (the
keyed-sampling slice), left-padded ``attention_mask`` generation (the
padded-generate slice), tensor parallelism, telemetry and resilience.
"""

from typing import Optional

import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.serving.config import ServingConfig
from deepspeed_tpu_torch.utils.logging import log_dist


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
        for key, why in config.inert_notes():
            log_dist(f"inference config '{key}' has no effect on this "
                     f"backend: {why}", ranks=[0])
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
        self._decode_model = None
        log_dist(f"InferenceEngine: device={self.device} "
                 f"dtype={config.dtype}", ranks=[0])

    # ------------------------------------------------------------------
    def mode_module(self, config):
        """A module of the same family in another mode (``for_decode``,
        ``for_paged_decode``) sharing this engine's weight tensors."""
        module = type(self.module)(config, device="meta")
        module.load_state_dict(self.module.state_dict(), assign=True)
        return module

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
        (``-1`` disables the stop)."""
        if attention_mask is not None:
            raise NotImplementedError(
                "generate(attention_mask=...) (left-padded batches) is not "
                "ported yet: it comes with the padded-generate slice of the "
                "PyTorch port")
        if seed is not None:
            raise NotImplementedError(
                "generate(seed=...) (keyed reproducible sampling) is not "
                "ported yet: it comes with the keyed-sampling slice of the "
                "PyTorch port")
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
        generator = generator or self.generator
        if self._decode_model is None:
            self._decode_model = self.mode_module(
                self.model_config.for_decode())
        model = self._decode_model
        cache = model.new_cache(B)

        def next_token(input_ids):
            hidden = model(input_ids, cache=cache, return_hidden=True)
            logits = model.lm_head(hidden[:, -1])
            return sample_logits(logits, generator, temperature, do_sample,
                                 top_k, top_p)

        token = next_token(ids)
        done = token == eos_token_id
        tokens = [token]
        for _ in range(max_new_tokens - 1):
            nxt = next_token(token[:, None])
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
            tokens.append(nxt)
            token = nxt
        return torch.cat([ids, torch.stack(tokens, dim=1)], dim=1)
