"""Model plug-in point (port of ``distributed_tensorflow_tpu.models``).

``create_model("gpt", ...)`` builds the ported ``GPTLM``; the other names
of the JAX registry are not ported yet and raise ``NotImplementedError``.
Models keep float32 parameters and compute in ``dtype``.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32, "f32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "f16": torch.float16, "fp16": torch.float16,
}

_CNN = "training with the CNN/MLP sync path"
_BERT = "BERT, ResNet and remat"
_LATER = {
    "mlp": _CNN, "mnist_mlp": _CNN, "fashion_mlp": _CNN, "cnn": _CNN,
    "mnist_cnn": _CNN, "resnet20": _BERT, "resnet": _BERT,
    "bert_tiny": _BERT, "bert": _BERT,
    "moe": "remaining engines", "moe_mlp": "remaining engines",
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
    if name in _LATER:
        raise NotImplementedError(
            f"model '{name}' is not ported to the PyTorch package yet "
            f"(ROADMAP Queue 1: {_LATER[name]})")
    raise KeyError(f"unknown model '{name}'; ported: gpt")
