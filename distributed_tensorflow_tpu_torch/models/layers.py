"""flax's layer numerics shared by the port's models: ``lecun_normal``
initialization, ``nn.Dense(dtype=...)``, ``nn.Dropout`` drawing its mask
from a passed ``torch.Generator``, and input-width inference for lazy
layers (flax infers widths from the sample ``Module.init`` sees).

Under a precision policy (``parallel/precision.py``) the parameters are
stored in the compute dtype, so ``dense``'s casts are no-ops; the
normalisations widen their 16-bit scale and bias to f32, as flax promotes
them against its f32 statistics.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(p: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> None:
    """flax's ``lecun_normal`` into ``p``: a normal truncated at ±2σ whose
    variance is ``1 / fan_in`` (std / .87962566 makes up for the cut),
    drawn from ``generator`` on the CPU and copied to ``p``'s device."""
    std = math.sqrt(1.0 / fan_in)
    host = torch.empty(p.shape, dtype=torch.float32)
    nn.init.trunc_normal_(host, 0.0, std / .87962566103423978,
                          -2 * std / .87962566103423978,
                          2 * std / .87962566103423978, generator=generator)
    p.copy_(host)


def infer_shape(layer: nn.Module, x: torch.Tensor) -> None:
    """Give a lazy layer its input width from its first input, as flax's
    ``Module.init`` infers it from the sample (a no-op once it has one)."""
    if getattr(layer, "has_uninitialized_params", lambda: False)():
        layer.initialize_parameters(x)


def dense(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    infer_shape(lin, x)
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale by
    ``1 / (1 - rate)``; the keep mask is drawn from ``generator``."""
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
