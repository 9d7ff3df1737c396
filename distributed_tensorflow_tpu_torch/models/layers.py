"""flax's layer numerics shared by the port's models: ``lecun_normal``
initialization, ``nn.Dense(dtype=...)``, ``nn.Dropout`` drawing its mask
from a passed ``torch.Generator``, input-width inference for lazy layers
(flax infers widths from the sample ``Module.init`` sees), and ``remat``,
the counterpart of ``nn.remat`` around a transformer block.

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
from torch.utils.checkpoint import checkpoint


LN_EPS = 1e-6   # flax nn.LayerNorm default (torch's is 1e-5)


def layer_norm(ln: nn.LayerNorm, x, dtype):
    """flax ``nn.LayerNorm(dtype=...)``: statistics in f32, output in
    ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), LN_EPS).to(dtype)


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator | None):
    """Flax's initializers for every Linear, Embedding and LayerNorm of
    ``model``, drawn from ``generator`` on the CPU and copied to the
    model's device: Dense kernels lecun-normal (truncated at ±2σ), biases
    zero, embeddings normal with std ``features ** -0.5``, LayerNorm scale
    1 and bias 0.  Returns ``model``."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            lecun_normal_(mod.weight, mod.in_features, generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            host = torch.empty(mod.weight.shape, dtype=torch.float32)
            host.normal_(0.0, math.sqrt(1.0 / mod.embedding_dim),
                         generator=generator)
            mod.weight.copy_(host)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model


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


def remat(block: nn.Module, x: torch.Tensor, *args,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """``block(x, *args, generator=generator)`` with activation
    checkpointing (flax ``nn.remat`` around a block): the forward keeps
    the block's inputs and none of its activations, and the backward runs
    the block again to rebuild them (``torch.utils.checkpoint``,
    non-reentrant).  The parameters are the block's own, so the
    ``state_dict`` is the same with and without remat.  Where no gradient
    is taken (evaluation) the block runs once, as it is.

    The recompute must draw the dropout masks the forward drew, or the
    gradients belong to masks that were never applied.
    ``preserve_rng_state`` stashes only the default generators, so the
    state of ``generator`` (the engine's per-rank stream) is saved here
    before the block, set again for the recompute, and then put back to
    where the stream had got to, so that later draws are those of a run
    without remat.  On the card ``get_state``/``set_state`` are legal
    inside a CUDA graph capture, and a captured restore rewinds the
    replayed draws (``SyncEngine`` captures its chunks; ``clone_state``,
    by contrast, raises there)."""
    if not torch.is_grad_enabled():
        return block(x, *args, generator=generator)
    if generator is None:
        # dropout draws from the default generators, which
        # preserve_rng_state (on by default) stashes
        return checkpoint(block, x, *args, use_reentrant=False)
    entry = generator.get_state()
    recompute = False

    def run(x, *args):
        nonlocal recompute
        if not recompute:
            recompute = True
            return block(x, *args, generator=generator)
        now = generator.get_state()
        generator.set_state(entry)
        try:
            return block(x, *args, generator=generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, *args, use_reentrant=False,
                      preserve_rng_state=False)


def bind_seq_mesh(model: nn.Module, mesh) -> nn.Module:
    """Give every module of ``model`` that runs sequence-parallel
    attention (those with a ``seq_mesh`` attribute) the mesh whose ``seq``
    axis it shards over: ``SeqParallelEngine`` binds its mesh, as JAX's
    ``shard_map`` names the axis.  Returns ``model``."""
    for mod in model.modules():
        if hasattr(mod, "seq_mesh"):
            mod.seq_mesh = mesh
    return model
