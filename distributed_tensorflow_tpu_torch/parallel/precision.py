"""End-to-end mixed-precision training policies (port of
``parallel/precision.py``; Micikevicius et al., arXiv:1710.03740).

``PrecisionPolicy`` names the storage, compute, gradient-reduce and master
dtypes of one ``--precision`` value:

  ``f32``             everything float32: the default and a strict no-op
                      (no cast, no optimizer wrapper; the trajectory is
                      bitwise the one of an engine built without a policy).
  ``bf16``            parameters stored and computed in bfloat16; the
                      optimizer runs on them directly, so Adam's moments
                      are bfloat16 too (optax's moments inherit the param
                      dtype).  Parameters and optimizer state halve.
  ``bf16-f32master``  parameters stored and computed in bfloat16, with a
                      float32 master copy inside the optimizer
                      (``MasterWeights``): the optimizer updates the
                      master and the parameters become ``cast(master)``
                      every step, so updates below bf16 resolution still
                      accumulate.
  ``fp16-f32master``  float16 storage and compute, the f32 master, and
                      dynamic loss scaling: the engine multiplies the
                      differentiated loss by the running scale
                      (``loss_scale_from``), ``MasterWeights`` divides the
                      gradients back, and a non-finite gradient skips the
                      step (master, optimizer state and parameters left
                      bitwise as they were) and backs the scale off;
                      ``growth_interval`` finite steps in a row grow it.

The JAX wrapper is an optax transformation that emits
``cast(master') - params`` so that ``apply_updates`` lands the parameters
on the downcast master.  Here the wrapper owns the step: it widens the
16-bit gradients into the master's ``.grad``, steps the inner
``torch.optim`` optimizer on the master, and copies the master into the
parameters (``copy_`` rounds to nearest even, as ``astype`` does), so
``params == cast(master)`` holds bitwise after every step.  The master is
one flat f32 tensor and the stored parameters are views of one flat
16-bit tensor: the cast back is one kernel over all parameters, and the
inner optimizer sees one tensor (Adam is elementwise, so the update is
the per-tensor one).

Everything the fp16 step decides stays on the device: the finite flag is
a 0-dim device tensor, a skipped step restores the master and the inner
state with ``torch.where`` from copies taken before the inner step, and
the scale bookkeeping is device arithmetic.  No ``.item()``, so a chunk
of steps runs without a host sync and can be captured as a CUDA graph
(an inner optimizer with on-device step counts, ``Adam(capturable=True)``,
keeps the skip free of syncs on the card).

With 16-bit storage the gradients are 16-bit, so a data-parallel reduce
of them moves 2 bytes per parameter (``grad_reduce_dtype``).  Restoring a
checkpoint into a policy (``f32_template``, ``restore_into_policy``)
waits for the checkpoint module.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from distributed_tensorflow_tpu_torch import not_ported

POLICIES = ("f32", "bf16", "bf16-f32master", "fp16-f32master")

# per-step metric keys the scaling policy adds to the trajectory
SCALE_KEYS = ("loss_scale", "ls_skipped")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One resolved ``--precision`` value: the dtypes of mixed precision
    and the shape of the dynamic loss scale.  ``active`` False (``f32``)
    means every hook is a no-op."""

    name: str = "f32"
    param_dtype: torch.dtype = torch.float32    # stored parameters
    compute_dtype: torch.dtype = torch.float32  # the model's dtype
    master_dtype: torch.dtype | None = None     # f32 master in the
                                                # optimizer (None: none)
    loss_scaling: bool = False                  # dynamic loss scale
    init_scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 200    # consecutive finite steps per growth

    @property
    def active(self) -> bool:
        return self.name != "f32"

    @property
    def grad_reduce_dtype(self) -> torch.dtype:
        """The dtype the gradient collective moves: gradients share the
        stored parameters' dtype."""
        return self.param_dtype

    def cast_params(self, module: nn.Module) -> nn.Module:
        """Store ``module``'s floating-point parameters in the policy's
        dtype, in place (the ``Parameter`` objects stay); identity for
        ``f32``."""
        if self.active:
            for p in module.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(self.param_dtype)
        return module

    def wrap_optimizer(self, make_optimizer: Callable) -> Callable:
        """The optimizer factory to build: ``MasterWeights`` around
        ``make_optimizer`` when the policy keeps a master, else
        ``make_optimizer`` itself."""
        if self.master_dtype is None:
            return make_optimizer
        return lambda params: MasterWeights(params, make_optimizer, self)


def make_policy(precision: str | PrecisionPolicy | None) -> PrecisionPolicy:
    """Resolve a ``--precision`` value (or a ready policy); a typo fails
    here with the full menu."""
    if precision is None:
        return PrecisionPolicy()
    if isinstance(precision, PrecisionPolicy):
        return precision
    if precision in ("f32", "float32"):
        return PrecisionPolicy()
    if precision == "bf16":
        return PrecisionPolicy(name="bf16", param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    if precision == "bf16-f32master":
        return PrecisionPolicy(name="bf16-f32master",
                               param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16,
                               master_dtype=torch.float32)
    if precision == "fp16-f32master":
        return PrecisionPolicy(name="fp16-f32master",
                               param_dtype=torch.float16,
                               compute_dtype=torch.float16,
                               master_dtype=torch.float32,
                               loss_scaling=True)
    raise ValueError(f"unknown precision '{precision}'; "
                     f"known: {', '.join(POLICIES)}")


def _tensors(state: dict) -> list[torch.Tensor]:
    return [v for v in state.values() if isinstance(v, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class MasterWeights:
    """The f32-master optimizer (the counterpart of JAX ``master_weights``,
    :180-271) with the interface the engines call: ``zero_grad`` and
    ``step``.

    On construction the floating-point ``params`` become views of one flat
    tensor of their dtype, ``master`` is its f32 copy, and
    ``inner = make_inner([master])``.  ``step()`` writes the gradients,
    widened, into ``master.grad``; with loss scaling divides them by the
    scale and takes their finite flag; steps ``inner``; restores master and
    inner state where the flag is false; updates the scale; and copies the
    master into the parameters.

    ``loss_scale`` is the scale the NEXT step's loss is multiplied by
    (1.0 without scaling); ``good_steps``, ``skipped`` and
    ``last_skipped`` are JAX's ``MasterWeightsState`` fields, all 0-dim
    device tensors updated in place."""

    def __init__(self, params, make_inner: Callable,
                 policy: PrecisionPolicy):
        params = [p for p in params if p.is_floating_point()]
        if not params:
            raise ValueError("MasterWeights needs floating-point parameters")
        self.policy = policy
        self.params = params
        dev = params[0].device
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        off = 0
        for p in params:
            p.data = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        self.flat = flat
        self.master = flat.to(policy.master_dtype)
        self.master.grad = torch.zeros_like(self.master)
        self.inner = make_inner([self.master])
        self.loss_scale = torch.tensor(
            policy.init_scale if policy.loss_scaling else 1.0,
            dtype=torch.float32, device=dev)
        self.good_steps = torch.zeros((), dtype=torch.int32, device=dev)
        self.skipped = torch.zeros((), dtype=torch.int32, device=dev)
        self.last_skipped = torch.zeros((), dtype=torch.bool, device=dev)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def _inner_state(self) -> list[torch.Tensor]:
        return _tensors(self.inner.state.get(self.master, {}))

    @torch.no_grad()
    def step(self) -> None:
        g = self.master.grad
        torch.cat([p.grad.reshape(-1) if p.grad is not None
                   else torch.zeros(p.numel(), dtype=p.dtype,
                                    device=p.device)
                   for p in self.params], out=g)
        if not self.policy.loss_scaling:
            self.inner.step()
            self.flat.copy_(self.master)
            return
        g.mul_(self.loss_scale.reciprocal())
        finite = torch.isfinite(g).all()
        had = self.master in self.inner.state
        saved = [t.clone() for t in [self.master, *self._inner_state()]]
        self.inner.step()
        now = [self.master, *self._inner_state()]
        if not had:
            # the inner state was born in this step: its value before it
            # is the fresh state, zeros (Adam's count and moments)
            saved += [torch.zeros_like(t) for t in now[len(saved):]]
        for new, old in zip(now, saved):
            # a skipped step keeps every value bitwise as it was
            new.copy_(torch.where(finite.to(new.device), new, old))
        self._update_scale(finite)
        self.flat.copy_(self.master)

    def _update_scale(self, finite: torch.Tensor) -> None:
        """JAX :239-251: grow by ``growth_factor`` after ``growth_interval``
        finite steps, back off by ``backoff_factor`` on a non-finite one,
        clip to [1, 2^24]; ``good_steps`` restarts whenever the scale
        changes."""
        pol, scale = self.policy, self.loss_scale
        grown = torch.where(self.good_steps + 1 >= pol.growth_interval,
                            scale * pol.growth_factor, scale)
        new = torch.where(finite, grown,
                          scale * pol.backoff_factor).clamp(1.0, 2.0 ** 24)
        self.good_steps.copy_(torch.where(
            finite & (new == scale), self.good_steps + 1,
            torch.zeros_like(self.good_steps)))
        self.skipped.add_((~finite).to(torch.int32))
        self.last_skipped.copy_(~finite)
        scale.copy_(new)

    def state_bytes(self) -> int:
        """Bytes of the optimizer state: the master, the inner state and
        the four scale fields (not the gradient buffer)."""
        return _nbytes([self.master, *self._inner_state(), self.loss_scale,
                        self.good_steps, self.skipped, self.last_skipped])


def optimizer_state_bytes(optimizer) -> int:
    """Bytes of ``optimizer``'s state tensors (a ``MasterWeights``'s
    master, inner state and scale fields)."""
    if isinstance(optimizer, MasterWeights):
        return optimizer.state_bytes()
    return sum(_nbytes(_tensors(s)) for s in optimizer.state.values())


def _master(optimizer) -> MasterWeights:
    if not isinstance(optimizer, MasterWeights):
        raise ValueError(
            "no MasterWeights optimizer — the loss-scaling policy must wrap "
            "the optimizer before init_state()")
    return optimizer


def loss_scale_from(optimizer) -> torch.Tensor:
    """The scale the current step's loss is multiplied by: the entering
    state's scale, a 0-dim f32 device tensor."""
    return _master(optimizer).loss_scale


def scale_stats_from(optimizer) -> dict[str, torch.Tensor]:
    """The per-step scaling metrics: the scale after the step, and whether
    the step was skipped (copies: the fields change in place)."""
    m = _master(optimizer)
    return {"loss_scale": m.loss_scale.clone(),
            "ls_skipped": m.last_skipped.to(torch.int32)}


def strip_master(optimizer):
    """The f32-era rendering of a master-policy optimizer: its inner
    optimizer (the one an ``f32`` run of the same optimizer builds)."""
    return (optimizer.inner if isinstance(optimizer, MasterWeights)
            else optimizer)


@torch.no_grad()
def adopt_f32_state(state, state_dict32: dict[str, torch.Tensor],
                    policy: PrecisionPolicy):
    """Enter f32 parameters (a ``state_dict``, e.g. from
    ``models.convert``) into a policy's live ``TrainState``: the stored
    parameters become their downcast and, under a master policy, the
    master becomes the f32 values themselves; the loss-scale fields
    restart fresh.  The optimizer's inner state is kept (the JAX adoption
    nests the restored f32 optimizer state back in)."""
    named = dict(state.model.named_parameters())
    missing = sorted(set(named) - set(state_dict32))
    if missing:
        raise KeyError(f"state_dict lacks parameters {missing}")
    for name, t in state_dict32.items():
        named[name].copy_(t)                   # rounds to the stored dtype
    opt = state.optimizer
    if policy.master_dtype is not None:
        m = _master(opt)
        index = {id(p): i for i, p in enumerate(m.params)}
        off, offsets = 0, []
        for p in m.params:
            offsets.append(off)
            off += p.numel()
        for name, t in state_dict32.items():
            i = index[id(named[name])]
            m.master[offsets[i]:offsets[i] + t.numel()].copy_(
                t.reshape(-1).to(policy.master_dtype))
        m.loss_scale.fill_(policy.init_scale if policy.loss_scaling
                           else 1.0)
        m.good_steps.zero_()
        m.skipped.zero_()
        m.last_skipped.zero_()
    return state


def f32_template(state):
    not_ported("restoring an f32 checkpoint into a precision policy "
               "(f32_template)", "remaining engines")


def restore_into_policy(manager, template, policy):
    not_ported("restore_into_policy (policy-aware checkpoint restore)",
               "remaining engines")
