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
of them moves 2 bytes per parameter (``grad_reduce_dtype``).

A checkpoint (``utils/checkpoint.py``) holds an optimizer's state by
parameter name (``optimizer_entries``): under a master policy the f32
master and the inner state are cut per parameter out of their flat
tensors, so the inner state of a master run and the state of an ``f32``
run of the same optimizer have the same names.  ``restore_into_policy``
restores a checkpoint of the same policy directly and adopts one of an
``f32`` run into a master policy (``f32_template``): the master becomes
the restored f32 parameters, the stored parameters their downcast, the
inner state the restored one, and the loss scale starts fresh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

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


# ------------------------------------------------------------ checkpoints

def _flat_offsets(params) -> list[int]:
    offs, off = [], 0
    for p in params:
        offs.append(off)
        off += p.numel()
    return offs


def optimizer_entries(model: nn.Module, optimizer) -> dict[str, torch.Tensor]:
    """The live tensors of ``optimizer``'s state by parameter name: views
    a restore copies into.  ``opt/<name>/<key>`` for each state entry of
    the parameter (the inner optimizer's under a master policy, whose
    flat entries are cut per parameter and whose scalar entries, Adam's
    count, appear under every name); a ``MasterWeights`` adds
    ``master/<name>`` and its four ``scale/*`` fields, and the health
    capture (``observability/health.py``) its ``health/count``."""
    names = {id(p): n for n, p in model.named_parameters()}
    out: dict[str, torch.Tensor] = {}
    if isinstance(optimizer, MasterWeights):
        m = optimizer
        pnames = [names[id(p)] for p in m.params]
        offs = _flat_offsets(m.params)

        def cut(flat):
            return {n: flat[o:o + p.numel()].view_as(p)
                    for n, p, o in zip(pnames, m.params, offs)}

        for n, v in cut(m.master).items():
            out[f"master/{n}"] = v
        for key, v in m.inner.state.get(m.master, {}).items():
            if not isinstance(v, torch.Tensor):
                continue
            if v.shape == m.master.shape:
                for n, piece in cut(v).items():
                    out[f"opt/{n}/{key}"] = piece
            else:
                for n in pnames:
                    out[f"opt/{n}/{key}"] = v
        for key in ("loss_scale", "good_steps", "skipped", "last_skipped"):
            out[f"scale/{key}"] = getattr(m, key)
    else:
        for group in optimizer.param_groups:
            for p in group["params"]:
                for key, v in optimizer.state.get(p, {}).items():
                    if isinstance(v, torch.Tensor):
                        out[f"opt/{names[id(p)]}/{key}"] = v
    capture = getattr(optimizer, "health_capture", None)
    if capture is not None:
        # the health capture's step count (JAX keeps it in opt_state)
        out["health/count"] = capture.count
    return out


@torch.no_grad()
def materialize_optimizer_state(optimizer) -> None:
    """Build the state of an optimizer that builds it lazily (torch's Adam
    at its first ``step``), so that a restore has tensors to copy into:
    one step on zero gradients, the parameters (the master) put back as
    they were.  A no-op where every parameter has its state."""
    opt = optimizer.inner if isinstance(optimizer, MasterWeights) else \
        optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    if all(p in opt.state and opt.state[p] for p in params):
        return
    saved = [(p.detach().clone(), p.grad) for p in params]
    for p in params:
        p.grad = torch.zeros_like(p)
    # the optimizer's own step: a health capture around it
    # (observability/health.py) must not count this one
    capture = getattr(opt, "health_capture", None)
    (opt.step if capture is None else capture.inner_step)()
    for p, (value, grad) in zip(params, saved):
        p.copy_(value)
        p.grad = grad


@dataclasses.dataclass
class F32Template:
    """``f32_template``'s product: the layout an ``f32`` run of the same
    model and optimizer writes, restored INTO the master-policy ``state``
    it wraps (``Engine.load_checkpoint_state`` adopts as it loads)."""

    state: Any

    @property
    def engine(self):
        return self.state.engine


def f32_template(state) -> F32Template:
    """A restore template for a checkpoint WRITTEN by an f32 run, read
    into the master-policy ``state``: its floating-point parameters are
    expected in f32 and its optimizer without the master wrapper."""
    if not isinstance(state.optimizer, MasterWeights):
        raise ValueError("f32_template needs a master-policy state (its "
                         "optimizer a MasterWeights)")
    return F32Template(state)


def f32_layout(state) -> dict[str, tuple[torch.Size, torch.dtype]]:
    """Names, shapes and dtypes of what an f32 run of ``state``'s model
    and optimizer checkpoints (``f32_template``'s layout)."""
    floats = {n for n, p in state.model.named_parameters()
              if p.is_floating_point()}
    out = {}
    for k, v in state.model.state_dict().items():
        out[f"model/{k}"] = (v.shape, torch.float32 if k in floats
                             else v.dtype)
    for k, v in optimizer_entries(state.model, state.optimizer).items():
        if k.startswith(("opt/", "health/")):
            out[k] = (v.shape, v.dtype)
    return out


@torch.no_grad()
def adopt_f32_checkpoint(state, d: dict, policy: PrecisionPolicy):
    """Adopt an f32 checkpoint's tensors ``d`` (checked against
    ``f32_layout``) into the master-policy ``state``: the parameters
    through ``adopt_f32_state`` (master := the f32 values, stored
    parameters := their downcast, a fresh loss scale), then the inner
    optimizer state by name.  Returns ``state``."""
    floats = {n for n, p in state.model.named_parameters()
              if p.is_floating_point()}
    params32 = {k[len("model/"):]: v for k, v in d.items()
                if k.startswith("model/") and k[len("model/"):] in floats}
    adopt_f32_state(state, params32, policy)
    sd = state.model.state_dict()
    for k, v in d.items():
        if k.startswith("model/") and k[len("model/"):] not in floats:
            sd[k[len("model/"):]].copy_(v)
    live = optimizer_entries(state.model, state.optimizer)
    for k, v in d.items():
        if k.startswith(("opt/", "health/")):
            live[k].copy_(v)
    return state


def restore_into_policy(manager, template, policy: PrecisionPolicy):
    """Restore the latest checkpoint into ``template`` (a fresh
    ``TrainState``), policy-aware: a checkpoint written under the SAME
    policy restores directly; one written by an f32 run (no master)
    restores through ``f32_template`` and is adopted as it loads.  Raises
    the direct-restore error when neither layout matches.  Restores in
    place (``copy_``); returns the restored state."""
    try:
        return manager.restore(template)
    except Exception as direct_err:
        if policy.master_dtype is None:
            raise
        try:
            return manager.restore(f32_template(template))
        except Exception:
            # neither layout matches: the DIRECT error is the informative
            # one, the f32 template's is just "also not that layout"
            raise direct_err
