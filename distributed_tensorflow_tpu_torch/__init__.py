"""PyTorch/CUDA port of ``distributed_tensorflow_tpu``.

The JAX package beside this one is the reference: every module here keeps
the JAX module's path and public names, and is held against it by the
``tests/test_torch_*.py`` parity tests.  Plain tensor code is PyTorch; each
TPU (Pallas) kernel on a ported path is a hand-written Hopper kernel under
``ops/csrc/`` with a plain PyTorch version beside it.

This package never imports jax, flax, optax or the JAX package.

Entry points take ``device=None``, which means the CUDA card; they raise
when no card is present.  There is no silent fall-back to the CPU: callers
that want the CPU (the tests) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); anything else is
    passed to ``torch.device`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's entry points run on the GPU "
                "unless the caller passes device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


def not_ported(what: str, item: str):
    """Raise for a feature of the JAX package the port does not have yet,
    naming the ROADMAP Queue 1 item that will bring it."""
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP Queue 1: "
        f"{item})")
