"""Model plug-in point (port of ``distributed_tensorflow_tpu.models``).

``create_model`` builds the ported models: the MLP (``mlp``,
``mnist_mlp``, ``fashion_mlp``), the CNN (``cnn``, ``mnist_cnn``), the GPT
(``gpt``, ``gpt_tiny``), ResNet-20 (``resnet20``, ``resnet``) and BERT-tiny
(``bert_tiny``, ``bert``) and the MoE classifier (``moe``, ``moe_mlp``);
``get_model_fn`` is the reference's zero-arg ``model_fn``.
Models are built with float32 parameters and compute in ``dtype``; under
a precision policy (``parallel/precision.py``) the engine stores the
parameters in the policy's dtype, so the per-call weight casts of
``dtype`` go away.
``device=None`` means the CUDA card.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_tensorflow_tpu_torch.models.bert import BertTinyClassifier
from distributed_tensorflow_tpu_torch.models.cnn import CNN
from distributed_tensorflow_tpu_torch.models.mlp import MLP
from distributed_tensorflow_tpu_torch.models.moe import MoEClassifier
from distributed_tensorflow_tpu_torch.models.resnet import ResNet20

_DTYPES = {
    "float32": torch.float32, "f32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "f16": torch.float16, "fp16": torch.float16,
}

_REGISTRY: dict[str, Callable[..., torch.nn.Module]] = {
    "mlp": MLP, "mnist_mlp": MLP, "fashion_mlp": MLP,
    "cnn": CNN, "mnist_cnn": CNN,
    "resnet20": ResNet20, "resnet": ResNet20,
    "bert_tiny": BertTinyClassifier, "bert": BertTinyClassifier,
    "moe": MoEClassifier, "moe_mlp": MoEClassifier,
}


def resolve_dtype(dtype) -> torch.dtype:
    """Map a CLI string ('bfloat16', 'bf16', ...) or dtype to a torch
    dtype."""
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _DTYPES:
            raise KeyError(f"unknown dtype '{dtype}'; known: {sorted(_DTYPES)}")
        return _DTYPES[key]
    return dtype


def create_model(name: str, num_classes: int = 10, **kw):
    """Instantiate a ported model.  ``device=None`` means the CUDA card."""
    if "dtype" in kw:
        kw["dtype"] = resolve_dtype(kw["dtype"])
    if name in ("gpt", "gpt_tiny"):
        from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

        # an LM's "classes" are its tokens (the JAX registry's convention)
        kw.setdefault("vocab_size", num_classes)
        return GPTLM(**kw)
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(_REGISTRY)} "
                       f"+ gpt")
    return _REGISTRY[name](num_classes=num_classes, **kw)


def get_model_fn(name: str, num_classes: int = 10,
                 **kw) -> Callable[[], torch.nn.Module]:
    """Reference-style zero-arg model_fn."""
    return lambda: create_model(name, num_classes=num_classes, **kw)
