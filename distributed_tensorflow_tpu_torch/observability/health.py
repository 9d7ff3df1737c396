"""Numeric training-health stats, computed on the device inside the step
(port of ``observability/health.py``).

Every step's metrics gain, beside the loss and accuracy:

  grad_norm        global L2 of the raw gradient (before the optimizer)
  param_norm       global L2 of the parameters entering the update
  update_norm      global L2 of the applied update (new − old, in f32)
  update_ratio     ‖Δp‖ / ‖p‖
  nonfinite_count  parameters holding a NaN or inf after the update
  loss_spike       loss / bias-corrected running EMA of the loss

The JAX capture rides the optimizer: ``wrap_optimizer`` chains two
pass-through optax transforms around the engine's ``tx``, whose states
hold the scalars.  Here the optimizer is a live ``torch.optim`` object
(or ``precision.MasterWeights``), so ``wrap_optimizer`` gives it a
``HealthCapture`` (``optimizer.health_capture``) and routes its ``step``
through it: before the inner step the gradient norm (with the test
injection applied), a snapshot of the parameters; after it the
parameter, update and non-finite stats.  The optimizer object stays what
it was (every ``isinstance`` and state reader of ``parallel/precision``
still sees it), and health sits outside a master policy's f32 master, as
in JAX (``parallel/precision.py:121-128``): under a master policy
(new − old) in f32 is JAX's emitted ``cast_lp(master') − p``.  Every
engine steps its optimizer once per step, so one hook covers every
engine.

Every value stays a 0-dim device tensor, updated in place (``count``,
the scalars, the snapshot), and nothing reads the host: the capture
runs inside a replayed CUDA-graph chunk as it does eagerly.  The
per-parameter squared norms and non-finite flags go through the
engine's ``reduce`` (``Engine._health_reduce``): identity where every
rank holds every parameter whole, the whole model's sums where ranks
hold slices (JAX's GSPMD ``global_norm``), the worst rank for the
norms and the ratio and the sum for the count where ranks hold their own
copies (local SGD, gossip; JAX ``from_opt_state``'s max and sum over
the stacked device axis).

``detect_anomalies`` is the host-side policy half (a copy of the JAX
function): given one step's floats and thresholds, it names every
offending stat.  The Trainer runs it per step at each chunk flush
(``on_anomaly``).

``HealthConfig.inject_nan_at`` is a TEST hook: it scales the gradients of
one optimizer step (1-based) by ``inject_scale`` (default inf) inside the
capture, through a ``torch.where`` on the device step count, so the
detection path is testable end to end on any engine.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

# the per-step stats the health layer adds to the metrics trajectory
HEALTH_KEYS = ("grad_norm", "param_norm", "update_norm", "update_ratio",
               "nonfinite_count", "loss_spike")

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds of the anomaly policy and the EMA shape of the spike
    score (JAX's defaults: they flag pathology, not noisy training).
    ``max_grad_norm`` None disables the ceiling; non-finite grad norms are
    always flagged."""

    ema_decay: float = 0.9           # loss EMA decay (bias-corrected)
    loss_spike_factor: float = 10.0  # anomaly: loss > factor × EMA
    max_update_ratio: float = 1.0    # anomaly: ‖Δp‖/‖p‖ above this
    max_grad_norm: float | None = None  # anomaly ceiling (None: disabled)
    # TEST hook: scale the gradients of this 1-based optimizer step by
    # inject_scale (inf → the seeded-NaN scenario); None leaves the step
    # as it is
    inject_nan_at: int | None = None
    inject_scale: float = float("inf")


def _f32_norms(tensors: list, ord: float) -> list:
    """Multi-tensor norms of ``tensors`` in f32 (16-bit tensors' norms
    accumulated and returned in f32)."""
    if not tensors:
        return []
    wide = any(t.dtype != torch.float32 for t in tensors)
    return torch._foreach_norm(tensors, ord,
                               dtype=torch.float32 if wide else None)


def _sq_norms(tensors: list, zero: torch.Tensor) -> torch.Tensor:
    """(P,) f32 squared L2 norm of each tensor (a None counts as zeros),
    from multi-tensor norms accumulated in f32."""
    norms = iter(_f32_norms([t for t in tensors if t is not None], 2))
    return torch.stack([next(norms) if t is not None else zero
                        for t in tensors]).square()


def _nonfinite_flags(tensors: list, zero: torch.Tensor) -> torch.Tensor:
    """(P,) bool: each floating tensor holds a NaN or inf (its max-abs
    norm is not finite: it never overflows a finite tensor)."""
    norms = iter(_f32_norms([t for t in tensors if t is not None
                             and t.is_floating_point()], float("inf")))
    return ~torch.isfinite(torch.stack([
        next(norms) if t is not None and t.is_floating_point() else zero
        for t in tensors]))


def global_norm(tensors) -> torch.Tensor:
    """Global L2 norm over every tensor (None skipped), accumulated in f32
    (bf16 tensors would overflow their own square sums)."""
    leaves = [t for t in tensors if t is not None]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    return _sq_norms(leaves, zero).sum().sqrt()


def nonfinite_leaf_count(tensors) -> torch.Tensor:
    """Number of floating tensors holding any NaN/inf (integer tensors
    cannot be non-finite and are skipped)."""
    leaves = [t for t in tensors if t.is_floating_point()]
    if not leaves:
        return torch.zeros((), dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    return _nonfinite_flags(leaves, zero).sum(dtype=torch.int32)


def local_stats(gsq: torch.Tensor, psq: torch.Tensor, usq: torch.Tensor,
                flags: torch.Tensor) -> dict[str, torch.Tensor]:
    """The five captured stats from per-parameter squared norms and
    non-finite flags held whole on this rank."""
    pn, un = psq.sum().sqrt(), usq.sum().sqrt()
    return {"grad_norm": gsq.sum().sqrt(), "param_norm": pn,
            "update_norm": un,
            "update_ratio": un / torch.clamp(pn, min=_EPS),
            "nonfinite_count": flags.sum(dtype=torch.int32)}


_STAT_KEYS = HEALTH_KEYS[:5]


class HealthCapture:
    """The capture around one optimizer's ``step`` (JAX's
    ``_grad_capture`` and ``_update_capture``).  ``params`` are the
    parameters the optimizer steps (their ``.grad`` the gradients it
    reads), in the engine's order; ``reduce(gsq, psq, usq, flags)`` turns
    this rank's per-parameter squared norms and flags into the five
    stats (``local_stats`` by default); ``loss_scale`` is the fp16
    policy's live scale tensor (None without scaling): the gradients it
    multiplied are divided by the scale the step entered with.

    ``count`` (the optimizer steps taken, 1-based after a step, a
    checkpoint entry) and ``stats`` are 0-dim device tensors made here;
    the f32 snapshot of the parameters is made at the first step, which
    runs eagerly before any capture of a chunk."""

    def __init__(self, optimizer, params: list, config: HealthConfig,
                 reduce: Callable | None = None,
                 loss_scale: torch.Tensor | None = None):
        self.config = config
        self.params = list(params)
        self.reduce = reduce if reduce is not None else local_stats
        self.loss_scale = loss_scale
        self.inner_step = optimizer.step
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self._zero = torch.zeros((), dtype=torch.float32, device=dev)
        self.stats = {k: torch.zeros((), dtype=torch.int32 if
                                     k == "nonfinite_count" else
                                     torch.float32, device=dev)
                      for k in _STAT_KEYS}
        if config.inject_nan_at is not None:
            self._inject = (
                torch.tensor(config.inject_scale, dtype=torch.float32,
                             device=dev),
                torch.ones((), dtype=torch.float32, device=dev))
        self._snap: list | None = None

    @torch.no_grad()
    def _before(self):
        """The gradient side, before the inner step: the step count, the
        injection, the gradients' and the entering parameters' squared
        norms (the parameters into the snapshot) and the entering loss
        scale (None without one)."""
        cfg, params = self.config, self.params
        self.count.add_(1)
        grads = [p.grad for p in params]
        if cfg.inject_nan_at is not None:
            factor = torch.where(self.count == cfg.inject_nan_at,
                                 *self._inject)
            present = [g for g in grads if g is not None]
            if present:
                torch._foreach_mul_(present, factor)
        gsq = _sq_norms(grads, self._zero)
        if self._snap is None:
            self._snap = [torch.empty(p.shape, dtype=torch.float32,
                                      device=p.device) for p in params]
        torch._foreach_copy_(self._snap, [p.detach() for p in params])
        psq = _sq_norms(self._snap, self._zero)
        scale = (self.loss_scale.clone() if self.loss_scale is not None
                 else None)
        return gsq, psq, scale

    @torch.no_grad()
    def _after(self, gsq: torch.Tensor, psq: torch.Tensor,
               scale: torch.Tensor | None) -> None:
        params = [p.detach() for p in self.params]
        # the snapshot becomes old − new: the update's norm, in f32
        torch._foreach_sub_(self._snap, params)
        usq = _sq_norms(self._snap, self._zero)
        flags = _nonfinite_flags(params, self._zero)
        out = self.reduce(gsq, psq, usq, flags)
        if scale is not None:
            # the gradients carried the entering scale; nan/inf divide
            # through unchanged, so the anomaly signal survives
            out["grad_norm"] = out["grad_norm"] / scale
        for k, v in out.items():
            self.stats[k].copy_(v)

    def step(self, *args, **kwargs):
        before = self._before()
        result = self.inner_step(*args, **kwargs)
        self._after(*before)
        return result


def wrap_optimizer(optimizer, config: HealthConfig, params: list,
                   reduce: Callable | None = None,
                   loss_scale: torch.Tensor | None = None):
    """Install a ``HealthCapture`` on ``optimizer`` (its ``step`` now
    runs through the capture) and return the same optimizer."""
    capture = HealthCapture(optimizer, params, config, reduce=reduce,
                            loss_scale=loss_scale)
    optimizer.health_capture = capture
    optimizer.step = capture.step
    return optimizer


def from_opt_state(optimizer) -> dict[str, torch.Tensor]:
    """The captured health scalars of the last step (copies: the capture
    rewrites its tensors in place every step)."""
    capture = getattr(optimizer, "health_capture", None)
    if capture is None:
        raise ValueError(
            "no health capture state in opt_state — call "
            "Engine.enable_health() BEFORE init_state()/the first step, so "
            "the optimizer tree gains its capture slots")
    return {k: v.clone() for k, v in capture.stats.items()}


# --------------------------------------------------------------- loss EMA

def ema_init(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(ema_value, step_count): the carry the spike score is computed
    from on the device, updated in place by ``ema_update_``."""
    return (torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def ema_spike(loss: torch.Tensor, ema: tuple[torch.Tensor, torch.Tensor],
              config: HealthConfig):
    """(spike_score, new_ema): the loss over the bias-corrected running
    EMA of the loss (Adam-style correction, so early steps are not judged
    against the zero init).  The first step scores 1.0 by definition."""
    val, t = ema
    loss32 = loss.to(torch.float32)
    decay = config.ema_decay
    corrected = val / torch.clamp(1.0 - decay ** t.to(torch.float32),
                                  min=_EPS)
    spike = torch.where(t > 0, loss32 / torch.clamp(corrected, min=_EPS),
                        torch.ones_like(loss32))
    new = (decay * val + (1.0 - decay) * loss32, t + 1)
    return spike, new


def ema_update_(loss: torch.Tensor, ema: tuple[torch.Tensor, torch.Tensor],
                config: HealthConfig) -> torch.Tensor:
    """``ema_spike`` with the carry written back in place; returns the
    spike score."""
    spike, (val, t) = ema_spike(loss, ema, config)
    ema[0].copy_(val)
    ema[1].copy_(t)
    return spike


# --------------------------------------------------------- anomaly policy

def detect_anomalies(floats: dict[str, float],
                     config: HealthConfig) -> list[dict[str, Any]]:
    """Host-side policy over ONE step's materialized metrics: returns one
    record per offending stat — ``{"stat", "value", "limit", "reason",
    "kind"}`` — empty when the step is healthy.  ``kind`` separates
    ``'nonfinite'`` (divergence: NaN/inf anywhere — the class the legacy
    nan_guard made fatal) from ``'threshold'`` (a finite value past its
    ceiling); the threshold checks only fire on finite values (a NaN
    comparison would silently pass them)."""
    out: list[dict[str, Any]] = []

    def flag(stat: str, value, limit, reason: str, kind: str) -> None:
        out.append({"stat": stat, "value": value, "limit": limit,
                    "reason": reason, "kind": kind})

    nf = floats.get("nonfinite_count")
    if nf is not None and nf > 0:
        flag("nonfinite_count", nf, 0,
             "non-finite values in the updated parameters", "nonfinite")
    for stat in ("loss", "grad_norm", "update_ratio", "loss_spike"):
        v = floats.get(stat)
        if v is not None and not math.isfinite(v):
            flag(stat, v, None, "non-finite", "nonfinite")
    gn = floats.get("grad_norm")
    if (config.max_grad_norm is not None and gn is not None
            and math.isfinite(gn) and gn > config.max_grad_norm):
        flag("grad_norm", gn, config.max_grad_norm,
             "gradient norm above ceiling", "threshold")
    ur = floats.get("update_ratio")
    if ur is not None and math.isfinite(ur) and ur > config.max_update_ratio:
        flag("update_ratio", ur, config.max_update_ratio,
             "update rewrote too much of the model in one step", "threshold")
    ls = floats.get("loss_spike")
    if ls is not None and math.isfinite(ls) and ls > config.loss_spike_factor:
        flag("loss_spike", ls, config.loss_spike_factor,
             "loss spiked vs its running EMA", "threshold")
    return out
