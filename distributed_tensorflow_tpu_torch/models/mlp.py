"""MNIST MLP (port of ``models/mlp.py``): the reference's default model_fn,
Flatten → Dense(512, relu) → Dropout(0.2) → Dense(10), f32 logits.

flax infers a Dense layer's input width from the first call; here the
first layer is a ``LazyLinear`` that takes its width from the sample the
engine's ``init_state`` passes through the model (``infer_shape``), as
``Module.init`` does.
``reset_parameters`` then draws flax's initializers: kernels lecun-normal
(truncated at ±2σ), biases zero.  Dropout draws its keep masks from the
``generator`` the caller passes (the engine's per-step generator); it
cannot reproduce flax's bits.
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_tensorflow_tpu_torch import resolve_device
from distributed_tensorflow_tpu_torch.models.layers import (
    dense, dropout, lecun_normal_)


class MLP(nn.Module):
    """``forward(x, train=False, generator=None)`` → (B, num_classes) f32
    logits of any (B, ...) input, flattened."""

    def __init__(self, num_classes: int = 10, hidden: int = 512,
                 dropout_rate: float = 0.2, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes, self.hidden = num_classes, hidden
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.fc1 = nn.LazyLinear(hidden, device=device)
        self.fc2 = nn.Linear(hidden, num_classes, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for lin in (self.fc1, self.fc2):
            lecun_normal_(lin.weight, lin.in_features, generator)
            lin.bias.zero_()
        return self

    def forward(self, x, train: bool = False, generator=None):
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        x = torch.relu(dense(self.fc1, x, self.dtype))
        x = dropout(x, self.dropout_rate, train, generator)
        return dense(self.fc2, x, self.dtype).float()
