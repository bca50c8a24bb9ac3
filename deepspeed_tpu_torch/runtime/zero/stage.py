"""The ZeRO stages at run time: the port's counterpart of what GSPMD does
for the JAX engine with ``SpecLayout``'s shardings (the reference's
``stage_1_and_2.py`` and ``stage3.py``).

:class:`ZeroPartition` owns, for every trainable parameter of a module,
its two :class:`~deepspeed_tpu_torch.runtime.zero.partition.ShardPlan`\\ s
(the parameter's, the optimizer state's), its fp32 master and its
gradient slot:

- the **master** is what the optimizer updates: the parameter itself
  when both plans lay it out alike (stage 0; stage 3 below the hpZ split),
  else a separate fp32 tensor in the optimizer's layout, whose update is
  all-gathered back into the parameter after the step;
- the **slot** holds the gradient in the optimizer's layout, already
  mean-reduced over the ZeRO group (``data x fsdp``): all-reduced where
  the optimizer state is whole, reduce-scattered where it is split, in
  ``reduce_bucket_size`` buckets (``runtime/zero/reduce.py``). Stages 0
  and 1 reduce the accumulated ``.grad`` once at the step; stages 2 and 3
  every micro-step, so the accumulation holds only this rank's shard.

At stage 3 the module holds only this rank's shard of each split
parameter (``ds_plan``/``ds_shape`` tag it). Each child of an
``nn.ModuleList`` (a transformer block) is a gather unit, and the rest of
the module (embeddings, final norm) the root unit. A forward pre-hook on
a unit runs :class:`_GatherUnit`, an ``autograd.Function`` whose forward
all-gathers the unit's shards into whole tensors and whose backward
reduce-scatters their gradients into the slots; the hook installs the
whole tensors as the owners' attributes for the forward; a forward
hook drops them after, and the unit's backward drops what a recompute
installed. Under activation checkpointing the block's recompute runs the
hooks again, so it gathers again, and nothing keeps a block's whole
weights between its forward and its backward, or after it. Without
checkpointing, autograd keeps what each layer's backward needs, as it
would without ZeRO. The tied ``wte`` is one tensor of the root unit, used
at the embedding and at the LM head: its two gradients meet in one
``_GatherUnit`` backward, one reduce-scatter.

Under tensor parallelism every tensor is this rank's tp slice and every
ZeRO group spans the ZeRO axes at this rank's tp coordinate, so the
gathers, reduce-scatters and all-reduces above see only that slice. The
global norm, the fp16 overflow flag and LAMB's per-parameter norms take
one all-reduce over the ZeRO axes and ``tp`` together, each element
counted once: a rank adds a ZeRO-split slot only where it is tp-split or
this rank is the tp group's first, and a ZeRO-whole one only where it is
tp-split and this rank is the ZeRO group's first; a slot whole on both
axes is added locally.
"""

import types

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch.parallel.topology import AXIS_TP
from deepspeed_tpu_torch.runtime.utils import sum_of_squares
from deepspeed_tpu_torch.runtime.zero.partition import ZERO_AXES
from deepspeed_tpu_torch.runtime.zero.reduce import (all_gather_flat,
                                                     all_reduce_flat,
                                                     bucket_by_bytes,
                                                     reduce_scatter_flat)


class ZeroParamStatus:
    NOT_AVAILABLE = 1
    INFLIGHT = 2
    AVAILABLE = 3


def _owners(module):
    """``id(param) -> [(submodule, attribute)]``, tied parameters under
    every name."""
    owners = {}
    for _, sub in module.named_modules(remove_duplicate=False):
        for attr, p in sub._parameters.items():
            if p is not None:
                owners.setdefault(id(p), []).append((sub, attr))
    return owners


def _units(module):
    """``submodule -> unit``: each child of an ``nn.ModuleList`` (the
    outermost) is a unit for itself and its descendants; the rest
    belongs to ``module``, the root unit."""
    unit_of = {}
    for sub in module.modules():
        if isinstance(sub, nn.ModuleList):
            for child in sub:
                for d in child.modules():
                    unit_of.setdefault(d, child)
    return unit_of


def shard_module(module, param_plans):
    """Replace each parameter whose plan splits it by a Parameter holding
    this rank's shard (tagged ``ds_plan``, ``ds_shape`` and
    ``ds_status``), on every owner of a tied parameter. Parameters
    already split (``zero.Init``) are kept. Returns ``module``."""
    owners = _owners(module)
    for name, p in list(module.named_parameters()):
        plan = param_plans.get(name)
        if plan is None or not plan.sharded or hasattr(p, "ds_plan"):
            continue
        shard = nn.Parameter(plan.local(p.detach()).contiguous().clone(),
                             requires_grad=p.requires_grad)
        shard.ds_plan, shard.ds_shape = plan, plan.shape
        shard.ds_status = ZeroParamStatus.NOT_AVAILABLE
        for sub, attr in owners[id(p)]:
            sub._parameters[attr] = shard
    return module


class _GatherUnit(torch.autograd.Function):
    """Forward: one all-gather of a unit's shards, whole tensors out, each
    laid out as the whole parameter is (a shard split on a dim other than
    0 comes out of the rank-major buffer transposed: copied, so the GEMMs
    see stage 0's layout and round alike). Backward: their gradients
    reduce-scattered into the slots (the shards' own ``.grad`` stays
    empty)."""

    @staticmethod
    def forward(ctx, zero, unit, *shards):
        ctx.zero, ctx.unit = zero, unit
        entries = zero.unit_entries[unit]
        return tuple(t.contiguous() for t in all_gather_flat(
            shards, [e.pplan for e in entries]))

    @staticmethod
    def backward(ctx, *grads):
        entries = ctx.zero.unit_entries[ctx.unit]
        # the unit's backward is over: drop what a checkpoint's recompute
        # installed (it stops once it has what backward needs, before the
        # unit's forward hook)
        ctx.zero.release(ctx.unit)
        grads = [torch.zeros(e.pplan.shape, dtype=torch.float32,
                             device=e.param.device) if g is None else g
                 for e, g in zip(entries, grads)]
        ctx.zero.reduce_into_slots(entries, grads)
        return (None, None) + (None,) * len(grads)


def _sized(plans):
    """Stand-ins of the plans' whole tensors for ``bucket_by_bytes``."""
    return [types.SimpleNamespace(size=int(np.prod(p.shape))) for p in plans]


class _Entry:
    __slots__ = ("name", "param", "owners", "pplan", "oplan", "master",
                 "slot")


class ZeroPartition:
    """The ZeRO state of ``module`` at ``stage`` (module docstring).
    ``layout`` is the engine's SpecLayout; ``scale`` the reference's
    gradient pre/post-scaling (:class:`~deepspeed_tpu_torch.runtime.zero.
    reduce.GradScale`). Parameters move to ``device``; at stage 3 the
    split ones are replaced by their shards first, so a model built whole
    on the host never exists whole on the device."""

    def __init__(self, module, layout, stage, device, scale,
                 reduce_bucket_size, allgather_bucket_size):
        self.module = module
        self.stage = stage
        self.scale = scale
        self.reduce_bucket_size = reduce_bucket_size
        self.allgather_bucket_size = allgather_bucket_size
        mesh = layout.mesh
        self.zero_group = mesh.group(ZERO_AXES)
        self.tp_size = layout.tp_size
        # the norm's group, and whether this rank leads its ZeRO / tp group
        self.norm_group = mesh.group(ZERO_AXES + (AXIS_TP,))
        self.zero_lead = mesh.group_ranks(ZERO_AXES)[0] == mesh.rank
        self.tp_lead = mesh.get_tensor_parallel_rank() == 0
        pplans, oplans = layout.shardings(module, stage)
        full = {n: p.detach() for n, p in module.named_parameters()
                if p.requires_grad and not hasattr(p, "ds_plan")}
        shard_module(module, pplans)
        owners = _owners(module)
        self.entries = []
        for name, p in module.named_parameters():
            if not p.requires_grad:
                continue
            e = _Entry()
            e.name, e.owners = name, owners[id(p)]
            e.pplan, e.oplan = pplans[name], oplans[name]
            p.data = p.data.to(device)
            e.param, e.slot = p, None
            if e.pplan.same_layout(e.oplan):
                e.master = p
            else:
                whole = full[name] if name in full else self.gather_params(
                    [e])[0]
                e.master = e.oplan.local(whole.to(device)).contiguous() \
                    .clone()
            # a separate master only: the parameter naming itself would
            # be a reference cycle, freed by the garbage collector alone
            p.ds_plan, p.ds_opt_plan = e.pplan, e.oplan
            p.ds_master = e.master if e.master is not p else None
            p.ds_shape = e.pplan.shape
            p.ds_status = (ZeroParamStatus.NOT_AVAILABLE
                           if e.pplan.sharded else ZeroParamStatus.AVAILABLE)
            self.entries.append(e)
        del full
        self._install_hooks()

    # ------------------------------------------------------------------
    # stage 3: gather before use
    def _install_hooks(self):
        unit_of = _units(self.module)
        self.unit_entries = {}
        for e in self.entries:
            if not e.pplan.sharded:
                continue
            units = {unit_of.get(sub, self.module) for sub, _ in e.owners}
            unit = units.pop() if len(units) == 1 else self.module
            self.unit_entries.setdefault(unit, []).append(e)
        self._hooks = []
        for unit in self.unit_entries:
            self._hooks.append(unit.register_forward_pre_hook(
                self._gather_hook))
            self._hooks.append(unit.register_forward_hook(
                lambda unit, args, output: self.release(unit)))

    def _gather_hook(self, unit, args):
        entries = self.unit_entries[unit]
        whole = _GatherUnit.apply(self, unit, *(e.param for e in entries))
        for e, t in zip(entries, whole):
            for sub, attr in e.owners:
                sub.__dict__[attr] = t  # shadows the shard Parameter

    def release(self, unit):
        """Drop the unit's gathered tensors: its shards show again."""
        for e in self.unit_entries[unit]:
            for sub, attr in e.owners:
                sub.__dict__.pop(attr, None)

    # ------------------------------------------------------------------
    # gradients
    def reduce_into_slots(self, entries, grads):
        """Mean-reduce whole gradients over the ZeRO group into the
        entries' slots, one collective per bucket and kind: a
        reduce-scatter for split optimizer state, an all-reduce for
        whole."""
        for bucket in bucket_by_bytes(grads, self.reduce_bucket_size):
            split = [i for i in bucket if entries[i].oplan.sharded]
            whole = [i for i in bucket if not entries[i].oplan.sharded]
            out = []
            if split:
                out += zip(split, reduce_scatter_flat(
                    [grads[i] for i in split],
                    [entries[i].oplan for i in split], self.scale))
            if whole:
                out += zip(whole, all_reduce_flat(
                    [grads[i] for i in whole], self.zero_group, self.scale))
            for i, g in out:
                # a shard split on a dim other than 0 is a strided view:
                # its slot is laid out as the master is
                e = entries[i]
                e.slot = g.contiguous() if e.slot is None else e.slot.add_(g)

    def _reduce_whole_params(self):
        """Reduce the ``.grad`` of the parameters held whole into their
        slots, and clear it."""
        entries = [e for e in self.entries if not e.pplan.sharded]
        if not entries:
            return
        grads = [e.param.grad if e.param.grad is not None
                 else torch.zeros_like(e.param) for e in entries]
        for e in entries:
            e.param.grad = None
        self.reduce_into_slots(entries, grads)

    def after_micro_step(self):
        """Stages 2 and 3 reduce every micro-step."""
        if self.stage >= 2:
            self._reduce_whole_params()

    def reduced_grads(self):
        """The slots (stages 0 and 1 reduce here, once a step), zeros
        where a parameter had no gradient; aligned with
        :attr:`masters`."""
        if self.stage < 2:
            self._reduce_whole_params()
        return [e.slot if e.slot is not None
                else torch.zeros(e.oplan.shard_shape, dtype=torch.float32,
                                 device=e.master.device)
                for e in self.entries]

    def clear(self):
        for e in self.entries:
            e.slot = None
            e.param.grad = None

    @property
    def masters(self):
        return [e.master for e in self.entries]

    @property
    def any_split(self) -> bool:
        return any(e.oplan.sharded for e in self.entries)

    @property
    def reduces_norm(self) -> bool:
        """Whether a norm needs a collective: some slot is split."""
        return self.any_split or self.tp_size > 1

    def _counted(self, e) -> bool:
        """Whether this rank adds the entry's squares to the norm's
        all-reduce (module docstring)."""
        tp_split = e.oplan.tp_split
        if e.oplan.sharded:
            return tp_split or self.tp_lead
        return tp_split and self.zero_lead

    def norm_and_overflow(self, grads, overflow=None):
        """Global L2 norm of the slots, each element counted once (split
        slots summed over the ZeRO and tp groups, whole ones taken once),
        and the overflow flag summed over them, in one all-reduce."""
        reduced = [g for g, e in zip(grads, self.entries)
                   if self._counted(e)]
        local = [g for g, e in zip(grads, self.entries)
                 if not (e.oplan.sharded or e.oplan.tp_split)]
        total = sum_of_squares(local).to(grads[0].device)
        if self.reduces_norm:
            flag = (overflow.float() if overflow is not None
                    else total.new_zeros(()))
            buf = torch.stack([sum_of_squares(reduced).to(total.device),
                               flag])
            dist.all_reduce(buf, group=self.norm_group)
            total = total + buf[0]
            if overflow is not None:
                overflow = buf[1] > 0
        return total.sqrt(), overflow

    def norm_reduce(self, sq):
        """Squared per-parameter norms ``[..., k]`` (one column per
        master) summed over the ZeRO and tp groups where the master is
        split: LAMB's trust ratio on shards."""
        if not self.reduces_norm:
            return sq
        split = torch.tensor([e.oplan.sharded or e.oplan.tp_split
                              for e in self.entries], device=sq.device)
        counted = torch.tensor([self._counted(e) for e in self.entries],
                               device=sq.device)
        part = torch.where(counted, sq, torch.zeros_like(sq))
        dist.all_reduce(part, group=self.norm_group)
        return torch.where(split, part, sq)

    # ------------------------------------------------------------------
    # parameters
    def write_back(self):
        """Parameters from the updated masters where the two differ: one
        all-gather a bucket of split masters."""
        entries = [e for e in self.entries if e.master is not e.param]
        split = [e for e in entries if e.oplan.sharded]
        for e in entries:
            if not e.oplan.sharded:
                e.param.data.copy_(e.pplan.local(e.master))
        sizes = _sized(e.oplan for e in split)
        for bucket in bucket_by_bytes(sizes, self.allgather_bucket_size):
            whole = all_gather_flat([split[i].master for i in bucket],
                                    [split[i].oplan for i in bucket])
            for i, t in zip(bucket, whole):
                split[i].param.data.copy_(split[i].pplan.local(t))

    def gather_params(self, entries=None):
        """Whole values of the entries' parameters (all-gathers of the
        split ones: every rank of the group must call)."""
        entries = self.entries if entries is None else entries
        out = [e.param.detach() for e in entries]
        split = [i for i, e in enumerate(entries) if e.pplan.sharded]
        sizes = _sized(entries[i].pplan for i in split)
        for bucket in bucket_by_bytes(sizes, self.allgather_bucket_size):
            idx = [split[b] for b in bucket]
            whole = all_gather_flat([entries[i].param.detach() for i in idx],
                                    [entries[i].pplan for i in idx])
            for i, t in zip(idx, whole):
                out[i] = t
        return out

    def gather_grads(self):
        """``{name: whole reduced gradient}`` of the current slots."""
        grads = self.reduced_grads()
        out = {e.name: g for e, g in zip(self.entries, grads)}
        split = [e for e in self.entries if e.oplan.sharded]
        for e in split:
            out[e.name] = all_gather_flat([out[e.name]], [e.oplan])[0]
        return out

    def load(self, values):
        """Re-shard whole values (``{name: tensor}``) into the parameters
        and masters; no collective."""
        for e in self.entries:
            if e.name not in values:
                continue
            whole = values[e.name].to(e.param.device, torch.float32)
            e.param.data.copy_(e.pplan.local(whole))
            if e.master is not e.param:
                e.master.copy_(e.oplan.local(whole))

    # ------------------------------------------------------------------
    def comm_plan(self, gas: int = 1, recompute: bool = False,
                  lamb: bool = False):
        """The collectives one optimizer step launches, by name: what the
        stage's plan makes of this module (``recompute``: each non-root
        unit runs its forward again in backward, as activation
        checkpointing does; ``lamb``: the trust ratio's norms)."""
        def buckets(entries):
            rs = ar = 0
            for b in bucket_by_bytes(_sized(e.pplan for e in entries),
                                     self.reduce_bucket_size):
                rs += any(entries[i].oplan.sharded for i in b)
                ar += any(not entries[i].oplan.sharded for i in b)
            return rs, ar

        whole = [e for e in self.entries if not e.pplan.sharded]
        rs, ar = buckets(whole)
        ag = 0
        for unit, entries in self.unit_entries.items():
            urs, uar = buckets(entries)
            rs, ar = rs + urs, ar + uar
            ag += 1 + int(recompute and unit is not self.module)
        per_step = 1 if self.stage < 2 else gas
        split = [e for e in self.entries
                 if e.master is not e.param and e.oplan.sharded]
        writes = len(bucket_by_bytes(_sized(e.oplan for e in split),
                                     self.allgather_bucket_size))
        ar_step = int(self.reduces_norm) * (1 + int(lamb))
        return {"all_gather": ag * gas + writes,
                "reduce_scatter": rs * per_step,
                # + one all-reduce of the loss a micro-step
                "all_reduce": ar * per_step + ar_step + gas}
