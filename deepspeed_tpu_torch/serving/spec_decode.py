"""Speculative-decoding proposers: host-side draft-token sources (copy
of ``deepspeed_tpu/serving/spec_decode.py``).

Draft-and-verify decoding splits each decode step in two: a cheap
*proposer* guesses up to ``k`` continuation tokens on the host, then ONE
verify forward scores all ``k`` guesses (plus the pending last token) in
a single model call through the multi-row paged attention kernel, and
the engine keeps the longest prefix the target model's greedy tokens
agree with: every verify step emits between 1 and ``k + 1`` tokens for
the cost of one call.

This module is the proposer side only and host-only (no torch imports):
proposing is list-of-int work the step loop does between model calls.
Two built-ins:

- :class:`PromptLookupProposer` — prompt-lookup / n-gram matching: the
  request's own context (prompt + tokens generated so far) is searched
  for the most recent earlier occurrence of its current suffix n-gram,
  and the tokens that followed that occurrence are proposed.
- :class:`DraftModelProposer` — a small draft model proposes the next
  ``k`` tokens greedily. The draft is injected as a callable or an
  engine-like object (``ServingEngine(..., draft_model=...)``, e.g. an
  :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`).

The verify side (the verify forward, KV commit/drop through the block
manager's speculative ledger) lives in
:mod:`deepspeed_tpu_torch.serving.engine`.
"""

from typing import Callable, List, Optional, Sequence

from deepspeed_tpu_torch.serving import request as rq


class Proposer:
    """One host-side draft-token source. ``propose`` returns up to ``k``
    guessed continuation tokens for the request's current context (its
    prompt plus every token generated so far); fewer (or none) is
    always legal — the engine right-pads the verify batch against the
    garbage block, so a short proposal costs nothing extra."""

    name = "null"

    def propose(self, req: rq.Request, k: int) -> List[int]:
        raise NotImplementedError

    @staticmethod
    def context(req: rq.Request) -> List[int]:
        """The request's full generated-so-far context, as plain ints.
        The serving engine already normalizes ``prompt`` to a list of
        ints at submit (and ``emit_token`` appends ints), so the common
        case is two list concats — no per-token conversion in the
        per-step host hot loop; only a raw array prompt (direct
        scheduler use) pays the conversion."""
        p = req.prompt
        if type(p) is not list:
            p = [int(t) for t in p]
        return p + req.tokens


class PromptLookupProposer(Proposer):
    """Prompt-lookup (n-gram) proposer: match the context's trailing
    n-gram against its own earlier occurrences and propose what followed
    the most recent one.

    Longest n-grams are tried first (``max_ngram`` down to
    ``min_ngram``) — a longer match is stronger evidence the
    continuation repeats — and within one n-gram size the most RECENT
    earlier occurrence wins (recent repetition predicts the near future
    better than a stale one). No match proposes nothing, which the
    engine treats as a plain decode step for that slot.

    ``window`` bounds the scan to the trailing tokens (``0`` =
    unbounded): the scan is pure-Python host work on the step-critical
    path and a MISS pays the whole scan every step, so long-context
    serving needs the bound (recent context is also where predictive
    repetition lives).
    """

    name = "prompt_lookup"

    def __init__(self, min_ngram: int = 1, max_ngram: int = 3,
                 window: int = 0):
        if not (1 <= int(min_ngram) <= int(max_ngram)):
            raise ValueError(
                f"prompt lookup needs 1 <= min_ngram <= max_ngram, got "
                f"min={min_ngram} max={max_ngram}")
        if int(window) < 0:
            raise ValueError(f"prompt lookup window must be >= 0 "
                             f"(0 = unbounded), got {window}")
        self.min_ngram = int(min_ngram)
        self.max_ngram = int(max_ngram)
        self.window = int(window)

    def propose(self, req: rq.Request, k: int) -> List[int]:
        ctx = self.context(req)
        k = int(k)
        if k <= 0 or len(ctx) < self.min_ngram + 1:
            return []
        floor = max(0, len(ctx) - self.window) if self.window else 0
        for n in range(min(self.max_ngram, len(ctx) - 1),
                       self.min_ngram - 1, -1):
            suffix = ctx[-n:]
            # scan right-to-left (recent repetition predicts best),
            # excluding the suffix's own position — but a match hard
            # against the context tail yields a TRUNCATED continuation
            # (a period-1 loop's most recent match proposes one token),
            # so keep scanning for the nearest match with a full
            # k-token continuation and fall back to the longest short
            # one only when none exists
            best: List[int] = []
            for i in range(len(ctx) - n - 1, floor - 1, -1):
                if ctx[i:i + n] == suffix:
                    cont = ctx[i + n:i + n + k]
                    if len(cont) >= k:
                        return cont
                    if len(cont) > len(best):
                        best = cont
            if best:
                return best
        return []


class DraftModelProposer(Proposer):
    """Draft-model proposer: a small model guesses the next ``k`` tokens
    greedily from the request's trailing context.

    ``draft`` is either a plain callable ``(context_tokens, k) ->
    sequence of proposed tokens`` or an engine-like object exposing
    ``generate(ids, max_new_tokens=, do_sample=)`` over a ``[1, T]``
    batch (an :class:`~deepspeed_tpu_torch.inference.engine.
    InferenceEngine` on a shrunk config fits as-is). ``context_window`` bounds how much
    trailing context the draft sees per step (``0`` = all of it) — the
    draft runs every decode step, so its per-call cost is the knob that
    decides whether speculation pays.
    """

    name = "draft_model"

    def __init__(self, draft, context_window: int = 0):
        if draft is None:
            raise ValueError(
                'proposer "draft_model" needs a draft: pass draft_model= '
                "to ServingEngine/init_serving (a callable "
                "(context, k) -> tokens, or an engine with .generate)")
        self.context_window = int(context_window)
        generate = getattr(draft, "generate", None)
        if callable(draft) and generate is None:
            self._fn: Callable = draft
        elif callable(generate):
            self._fn = self._wrap_generate(generate)
        else:
            raise ValueError(
                f"draft_model must be callable or expose .generate, got "
                f"{type(draft).__name__}")

    @staticmethod
    def _wrap_generate(generate) -> Callable:
        def fn(ctx: Sequence[int], k: int):
            out = generate([list(ctx)], max_new_tokens=int(k),
                           do_sample=False)
            # [1, T + k] -> the k generated tail tokens
            return [int(t) for t in out[0][len(ctx):]]

        return fn

    def propose(self, req: rq.Request, k: int) -> List[int]:
        ctx = self.context(req)
        if self.context_window > 0:
            ctx = ctx[-self.context_window:]
        if int(k) <= 0 or not ctx:
            return []
        out = self._fn(ctx, int(k))
        return [int(t) for t in out][:int(k)]


def build_proposer(spec_cfg, draft_model=None) -> Optional[Proposer]:
    """The engine-facing factory: a :class:`Proposer` for one
    ``serving.speculative`` block, or ``None`` when the block is absent
    or disabled (speculation does not exist; the decode step loop is
    exactly as before)."""
    if spec_cfg is None or not spec_cfg.enabled:
        return None
    if spec_cfg.proposer == "prompt_lookup":
        return PromptLookupProposer(
            min_ngram=spec_cfg.prompt_lookup_min_ngram,
            max_ngram=spec_cfg.prompt_lookup_max_ngram,
            window=spec_cfg.prompt_lookup_window)
    if spec_cfg.proposer == "draft_model":
        return DraftModelProposer(
            draft_model, context_window=spec_cfg.draft_context_window)
    raise ValueError(
        f"unknown speculative proposer {spec_cfg.proposer!r} "
        '(known: "prompt_lookup", "draft_model")')
