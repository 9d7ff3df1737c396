"""The optimizer recipe's schedules and update, on the device.

The JAX harness builds its recipe from optax (JAX ``utils/harness.py``
``make_lr_schedule``, ``_make_optimizer``): a learning-rate schedule and
``chain(clip_by_global_norm(c), adamw(schedule, wd, mask=_decay_mask))``.
This module is the port's counterpart of the optax pieces it uses, and the
port's harness builds the recipe from it.

* Schedules (``constant_schedule``, ``linear_schedule``,
  ``cosine_decay_schedule``, ``warmup_cosine_decay_schedule``,
  ``join_schedules``) are optax's formulas, step for step, over a float32
  count tensor: ``schedule(count)`` is a float32 tensor of the count's
  shape, computed on the count's device.
* ``ScheduledAdamW`` is the chain as one ``torch.optim.Optimizer`` whose
  state (the step count and both moments), learning rate, clip and decay
  mask are device tensors.  ``step`` reads no value on the host, so a
  chunk of steps captured as a CUDA graph (``engines/sync.py``) replays
  the schedule: each replayed step evaluates it at the count it reaches.
  A learning rate written into ``param_groups`` from the host would be
  frozen at its value at capture.

Where torch's stock pieces compute other numbers, this module follows
optax:

* the schedule is read at optax's count, which is 0 at the first update
  (the Adam bias correction's count is then 1);
* the clip keeps ``g`` when ``norm < max`` and else gives
  ``g / norm * max`` (``clip_grad_norm_`` scales by ``max / (norm +
  1e-6)``);
* weight decay adds ``wd · p`` to the Adam direction, which the learning
  rate then scales, on the masked parameters only (``torch.optim.AdamW``
  multiplies every parameter by ``1 - lr · wd`` before the Adam step).

Under a master precision policy this optimizer is the inner optimizer of
``parallel.precision.MasterWeights``: it sees one flat f32 master, its
decay mask is a flat 0/1 vector in the parameters' order, it clips the
gradient after the loss scale is divided out, and a skipped fp16 step
restores its state tensors, the step count among them, so a skip does not
advance the schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant_schedule(value: float) -> Schedule:
    """optax ``constant_schedule``."""
    return lambda count: torch.full_like(count, value, dtype=torch.float32)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax ``linear_schedule`` (``polynomial_schedule`` at power 1):
    ``(init - end) · (1 - min(count, T) / T) + end``; a transition of
    ``T <= 0`` steps holds ``init_value``."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        frac = 1 - count.float().clamp(0, transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax ``cosine_decay_schedule`` at exponent 1:
    ``init · ((1 - alpha) · ½(1 + cos(π · min(count, T) / T)) + alpha)``."""
    if not decay_steps > 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps}.")

    def schedule(count):
        c = count.float().clamp(max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """optax ``join_schedules``: schedule ``i + 1`` takes over at boundary
    ``i`` and counts from it."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, sched(count - boundary))
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax ``warmup_cosine_decay_schedule``: a linear warmup, then a
    cosine decay; ``decay_steps`` is the whole length, warmup included."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha)],
        [warmup_steps])


class ScheduledAdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(lr, b1, b2, eps,
    weight_decay, mask))`` with its state on the device (module
    docstring).

    ``lr`` is a float or a ``Schedule``.  ``clip_norm`` 0 means no clip,
    ``weight_decay`` 0 no decay.  ``decay_mask`` lists, for each
    parameter, whether it decays: a bool, or a 0/1 tensor of the
    parameter's shape in its dtype (the flat master's mask).  The
    parameters share one device and one dtype.  The state is built here,
    so that it exists before a chunk is captured: ``state[p]`` holds
    ``step`` (a 0-dim f32 count), ``exp_avg`` and ``exp_avg_sq``, as
    torch's Adam names them.

    ``global_norm`` (None: the norm of the gradients it holds) is the
    clip's norm under an engine whose ranks hold slices of the
    parameters: a callable from the gradients (or the flat master's) to
    the whole model's norm, which the engine sets
    (``Engine._global_norm``), as optax's ``clip_by_global_norm`` sees the
    global arrays under GSPMD."""

    global_norm: Callable | None = None

    def __init__(self, params, lr: float | Schedule = 1e-3, *,
                 betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decay_mask: Sequence, clip_norm: float = 0.0):
        super().__init__(list(params), dict(betas=betas, eps=eps))
        if len(self.param_groups) != 1:
            raise ValueError("ScheduledAdamW takes one parameter group")
        group = self.param_groups[0]["params"]
        if len({(p.device, p.dtype) for p in group}) != 1:
            raise ValueError("ScheduledAdamW's parameters must share one "
                             "device and one dtype")
        self.schedule = lr if callable(lr) else None
        self.lr = None if callable(lr) else float(lr)
        self.weight_decay = float(weight_decay)
        self.clip_norm = float(clip_norm)
        if len(decay_mask) != len(group):
            raise ValueError(f"decay_mask has {len(decay_mask)} entries for "
                             f"{len(group)} parameters")
        self.decay_mask = list(decay_mask)
        for p in group:
            self.state[p] = {
                "step": torch.zeros((), dtype=torch.float32,
                                    device=p.device),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def current_lr(self) -> torch.Tensor:
        """The learning rate the next step applies: the schedule at the
        count so far, a 0-dim f32 device tensor."""
        p = self.param_groups[0]["params"][0]
        count = self.state[p]["step"]
        if self.schedule is None:
            return torch.full((), self.lr, dtype=torch.float32,
                              device=count.device)
        return self.schedule(count)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ScheduledAdamW.step takes no closure")
        group = self.param_groups[0]
        params = group["params"]
        b1, b2 = group["betas"]
        dt = params[0].dtype
        states = [self.state[p] for p in params]
        lr = self.current_lr()                 # optax's count: before +1
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.clip_norm:
            norm = (self.global_norm(grads) if self.global_norm is not None
                    else torch.linalg.vector_norm(
                        torch.stack(torch._foreach_norm(grads)).float()))
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            grads = torch._foreach_div(grads, torch.where(keep, one, norm)
                                       .to(dt))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(norm, self.clip_norm)).to(dt))
        steps = [s["step"] for s in states]
        m = [s["exp_avg"] for s in states]
        v = [s["exp_avg_sq"] for s in states]
        torch._foreach_add_(steps, 1)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        count = steps[0]
        upd = torch._foreach_div(m, (1 - torch.pow(b1, count)).to(dt))
        den = torch._foreach_div(v, (1 - torch.pow(b2, count)).to(dt))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            whole = [i for i, k in enumerate(self.decay_mask)
                     if k is True]
            if whole:
                torch._foreach_add_([upd[i] for i in whole],
                                    [params[i] for i in whole],
                                    alpha=self.weight_decay)
            part = [i for i, k in enumerate(self.decay_mask)
                    if isinstance(k, torch.Tensor)]
            if part:
                torch._foreach_addcmul_(
                    [upd[i] for i in part], [params[i] for i in part],
                    [self.decay_mask[i] for i in part],
                    value=self.weight_decay)
        torch._foreach_mul_(upd, (-lr).to(dt))
        torch._foreach_add_(params, upd)
