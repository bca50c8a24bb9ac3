"""Optimizers of the training engine (counterpart of
``deepspeed_tpu/ops/optimizer.py``).

The same update math as the JAX package, in fp32: Adam's eps sits outside
``sqrt(v / bc2)``, and AdamW's decoupled decay is added to the update
before ``lr`` scales it. The JAX package writes no kernel here (XLA fuses
the pytree-wide update); this port writes plain multi-tensor PyTorch
(``torch._foreach_*``), which launches a few kernels over all parameters
at once. It keeps the JAX interface — ``init(params)`` returns the state,
``update(grads, state, params, lr)`` returns the next one — but updates
the parameters and the moment buffers IN PLACE, where JAX returns new
arrays. These are not ``torch.optim`` optimizers.

Under ZeRO the engine hands them shards of the masters, gradients and
moments. Every update but LAMB's is elementwise; LAMB's trust ratio needs
each parameter's whole norm, so ``update`` takes ``norm_reduce``: a
function that sums squared per-parameter norms over the ZeRO group where
a parameter is split (the engine's; None on one rank or unsplit).
"""

from typing import Any, NamedTuple, Optional


import torch


class AdamState(NamedTuple):
    step: int          # host count of applied updates
    exp_avg: Any       # m (Adam/LAMB) or the momentum buffer (SGD)
    exp_avg_sq: Any    # v


def _zeros(params):
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _fp32(grads):
    return [g.float() for g in grads]


def _bias_corrections(betas, step, enabled):
    if not enabled:
        return 1.0, 1.0
    return 1.0 - betas[0] ** step, 1.0 - betas[1] ** step


def _adam_direction(grads, state, betas, eps, bc1, bc2):
    """m and v updated in place; returns ``(m / bc1) / (sqrt(v / bc2) +
    eps)`` as new tensors."""
    b1, b2 = betas
    m, v = state.exp_avg, state.exp_avg_sq
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, grads, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(m, bc1)
    torch._foreach_div_(update, denom)
    return update


class FusedAdam:
    """Adam/AdamW (``adam_w_mode=True`` → decoupled weight decay)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True, bias_correction=True,
                 amsgrad=False, **_ignored):
        if amsgrad:
            raise ValueError("FusedAdam does not support amsgrad "
                             "(reference parity)")
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction

    def init(self, params) -> AdamState:
        return AdamState(0, _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params,
               lr: Optional[float] = None, norm_reduce=None) -> AdamState:
        lr = self.lr if lr is None else lr
        step = state.step + 1
        bc1, bc2 = _bias_corrections(self.betas, step, self.bias_correction)
        grads = _fp32(grads)
        if not self.adam_w_mode and self.weight_decay:
            grads = torch._foreach_add(grads, params,
                                       alpha=self.weight_decay)
        update = _adam_direction(grads, state, self.betas, self.eps, bc1,
                                 bc2)
        if self.adam_w_mode and self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)
        return state._replace(step=step)


class FusedSGD:
    """SGD with momentum (reference falls back to torch.optim.SGD)."""

    def __init__(self, lr=1e-3, momentum=0.0, weight_decay=0.0,
                 nesterov=False, **_):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def init(self, params) -> AdamState:
        return AdamState(0, _zeros(params) if self.momentum else None, None)

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, lr=None,
               norm_reduce=None) -> AdamState:
        lr = self.lr if lr is None else lr
        grads = _fp32(grads)
        if self.weight_decay:
            grads = torch._foreach_add(grads, params,
                                       alpha=self.weight_decay)
        direction = grads
        if self.momentum:
            buf = state.exp_avg
            torch._foreach_mul_(buf, self.momentum)
            torch._foreach_add_(buf, grads)
            direction = (torch._foreach_add(grads, buf, alpha=self.momentum)
                         if self.nesterov else buf)
        torch._foreach_add_(params, direction, alpha=-lr)
        return state._replace(step=state.step + 1)


class FusedLamb:
    """LAMB with a per-parameter trust ratio (``max_coeff``/``min_coeff``
    clamp it, as the reference's fused LAMB kernel does)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, bias_correction=True, max_coeff=10.0,
                 min_coeff=0.01, **_):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff

    def init(self, params) -> AdamState:
        return AdamState(0, _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, lr=None,
               norm_reduce=None) -> AdamState:
        lr = self.lr if lr is None else lr
        step = state.step + 1
        bc1, bc2 = _bias_corrections(self.betas, step, self.bias_correction)
        update = _adam_direction(_fp32(grads), state, self.betas, self.eps,
                                 bc1, bc2)
        if self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        w_norm = torch.stack(torch._foreach_norm(params))
        u_norm = torch.stack(torch._foreach_norm(update))
        if norm_reduce is not None:
            w_norm, u_norm = norm_reduce(
                torch.stack([w_norm, u_norm]).square()).sqrt().unbind(0)
        trust = torch.where((w_norm > 0) & (u_norm > 0),
                            (w_norm / u_norm).clamp(self.min_coeff,
                                                    self.max_coeff),
                            torch.ones_like(w_norm))
        torch._foreach_mul_(update, list(trust.unbind()))
        torch._foreach_add_(params, update, alpha=-lr)
        return state._replace(step=step)


ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
SGD_OPTIMIZER = "sgd"
ONEBIT_OPTIMIZERS = ("onebitadam", "onebitlamb", "zerooneadam")


def build_basic_optimizer(name: str, params: dict):
    """Optimizer factory (reference ``engine._configure_basic_optimizer``)."""
    name = (name or ADAM_OPTIMIZER).lower()
    params = dict(params or {})
    params.pop("torch_adam", None)
    if name == ADAM_OPTIMIZER:
        # reference: "adam" honors adam_w_mode (default True)
        return FusedAdam(**params)
    if name == ADAMW_OPTIMIZER:
        params["adam_w_mode"] = True
        return FusedAdam(**params)
    if name == LAMB_OPTIMIZER:
        return FusedLamb(**params)
    if name == SGD_OPTIMIZER:
        return FusedSGD(**params)
    if name in ONEBIT_OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet: the 1-bit optimizers "
            "come with the compressed-collectives slice of the PyTorch port")
    raise ValueError(f"Unknown optimizer {name!r}")
