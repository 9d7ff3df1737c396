"""Small convnet for MNIST-class workloads (port of ``models/cnn.py``):
per feature width, Conv 3×3 SAME → ReLU → max-pool 2×2 (stride 2, VALID),
then Flatten → Dense(128, relu) → Dropout(0.25) → Dense(num_classes).

The input is NHWC as in flax: ``(B, H, W, C)``, or ``(B, H, W)``, which
gains a channel dim.  The convolutions run in NCHW (``F.conv2d``; flax's
``"SAME"`` 3×3 is ``padding=1``, and ``max_pool`` is VALID, so 28 → 14 → 7),
and the feature map is permuted back to NHWC before the flatten, so the
first Dense sees its 3136 inputs in flax's (h, w, c) order and a flax
kernel carries over by a transpose alone (``convert.cnn_state_dict``).
The convolutions and GEMMs are plain PyTorch: the JAX package computes
them through XLA, outside any Pallas kernel.

Lazy layers take the input's channel count and the flattened width from
the sample ``init_state`` passes through the model, as flax's
``Module.init`` does; ``reset_parameters`` draws flax's initializers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch import resolve_device
from distributed_tensorflow_tpu_torch.models.layers import (
    dense as _dense, dropout, infer_shape, lecun_normal_)


class CNN(nn.Module):
    """``forward(x, train=False, generator=None)`` → (B, num_classes) f32
    logits."""

    def __init__(self, num_classes: int = 10,
                 features: tuple[int, ...] = (32, 64), dense: int = 128,
                 dropout_rate: float = 0.25, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes, self.features = num_classes, tuple(features)
        self.dense_width, self.dropout_rate = dense, dropout_rate
        self.dtype = dtype
        convs = [nn.LazyConv2d(self.features[0], 3, padding=1, device=device)]
        convs += [nn.Conv2d(a, b, 3, padding=1, device=device)
                  for a, b in zip(self.features, self.features[1:])]
        self.convs = nn.ModuleList(convs)
        self.fc1 = nn.LazyLinear(dense, device=device)
        self.fc2 = nn.Linear(dense, num_classes, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for conv in self.convs:
            kh, kw = conv.kernel_size
            lecun_normal_(conv.weight, conv.in_channels * kh * kw, generator)
            conv.bias.zero_()
        for lin in (self.fc1, self.fc2):
            lecun_normal_(lin.weight, lin.in_features, generator)
            lin.bias.zero_()
        return self

    def forward(self, x, train: bool = False, generator=None):
        x = x.to(self.dtype)
        if x.ndim == 3:  # (B, H, W) → add channel dim
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        for conv in self.convs:
            infer_shape(conv, x)
            x = F.conv2d(x, conv.weight.to(self.dtype),
                         conv.bias.to(self.dtype), padding=1)
            x = F.max_pool2d(torch.relu(x), 2, 2)
        # back to NHWC so the flatten order is flax's (h, w, c)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(_dense(self.fc1, x, self.dtype))
        x = dropout(x, self.dropout_rate, train, generator)
        return _dense(self.fc2, x, self.dtype).float()
