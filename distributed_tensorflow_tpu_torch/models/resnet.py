"""ResNet-20 for CIFAR-10 (port of ``models/resnet.py``): 3 stages × 3 basic
blocks, widths 16/32/64, bias-free 3×3 convolutions, GroupNorm(8) in place
of BatchNorm, a global mean pool and a Dense head; BASELINE config 3.

The input is NHWC as in flax: ``(B, H, W, C)``, or ``(B, H, W)``, which
gains a channel dim; the convolutions run in NCHW.  Three details of flax
that a straight transcription gets silently wrong:

* XLA's ``"SAME"`` padding puts the odd pad at the high end.  A 3×3
  stride-2 convolution of a 32×32 (or 16, 28, 14) map pads ``(0, 1)``
  per spatial dim, where ``F.conv2d(padding=1)`` pads ``(1, 1)`` and gives
  the same output shape with every window shifted by one.  ``_same_pad``
  computes XLA's pads from the input size, and an asymmetric pad is
  applied explicitly;
* flax's ``GroupNorm`` has ``epsilon=1e-6`` (torch's default is 1e-5) and
  normalizes in f32 before casting to ``dtype``;
* flax's kernels are ``lecun_normal`` (fan-in ``in·kh·kw``), GroupNorm
  scales 1 and biases 0, the Dense bias 0: ``reset_parameters`` draws
  them.

The first convolution is lazy: it takes 1 or 3 input channels from the
sample ``init_state`` passes through the model, as flax's ``init`` does.
The convolutions and GEMMs are plain PyTorch: the JAX package computes
them through XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch import resolve_device
from distributed_tensorflow_tpu_torch.models.layers import (
    dense, infer_shape, lecun_normal_)

GROUPS = 8
GN_EPS = 1e-6   # flax nn.GroupNorm's epsilon


def _same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` (low, high) pad of one spatial dim: the output has
    ``ceil(size / stride)`` positions, and the odd pad goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", use_bias=False, dtype=...)`` on an
    NCHW map.  Symmetric pads go to the convolution itself; only an
    asymmetric one is a separate ``F.pad``."""
    infer_shape(conv, x)
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    top, bottom = _same_pad(x.shape[2], kh, sh)
    left, right = _same_pad(x.shape[3], kw, sw)
    x = x.to(dtype)
    pad = (top, left)
    if (top, left) != (bottom, right):
        x, pad = F.pad(x, (left, right, top, bottom)), 0
    return F.conv2d(x, conv.weight.to(dtype), stride=conv.stride,
                    padding=pad)


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, dtype) -> torch.Tensor:
    """flax ``nn.GroupNorm(num_groups=8, dtype=...)``: statistics and affine
    in f32, the result in ``dtype``."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(dtype)


def _norm(width: int, device) -> nn.GroupNorm:
    return nn.GroupNorm(GROUPS, width, eps=GN_EPS, device=device)


class BasicBlock(nn.Module):
    """conv3×3(stride) → GN → relu → conv3×3 → GN, plus the input or, where
    the shape changes, a 1×1 strided projection and its GN; relu."""

    def __init__(self, in_width: int, filters: int, strides: int = 1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_width, filters, 3, stride=strides,
                               bias=False, device=device)
        self.norm1 = _norm(filters, device)
        self.conv2 = nn.Conv2d(filters, filters, 3, bias=False,
                               device=device)
        self.norm2 = _norm(filters, device)
        self.proj = self.proj_norm = None
        if strides != 1 or in_width != filters:
            self.proj = nn.Conv2d(in_width, filters, 1, stride=strides,
                                  bias=False, device=device)
            self.proj_norm = _norm(filters, device)

    def forward(self, x):
        dt = self.dtype
        y = torch.relu(group_norm(conv_same(x, self.conv1, dt), self.norm1,
                                  dt))
        y = group_norm(conv_same(y, self.conv2, dt), self.norm2, dt)
        if self.proj is not None:
            x = group_norm(conv_same(x, self.proj, dt), self.proj_norm, dt)
        return torch.relu(y + x)


class ResNet20(nn.Module):
    """``forward(x, train=False, generator=None)`` → (B, num_classes) f32
    logits.  ResNet-20 has no dropout: ``train`` and ``generator`` are
    accepted for the engines' common call."""

    def __init__(self, num_classes: int = 10,
                 widths: tuple[int, ...] = (16, 32, 64),
                 blocks_per_stage: int = 3, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes, self.widths = num_classes, tuple(widths)
        self.blocks_per_stage, self.dtype = blocks_per_stage, dtype
        self.stem = nn.LazyConv2d(self.widths[0], 3, bias=False,
                                  device=device)
        self.stem_norm = _norm(self.widths[0], device)
        blocks, width = [], self.widths[0]
        for stage, filters in enumerate(self.widths):
            for block in range(blocks_per_stage):
                strides = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(width, filters, strides, dtype,
                                         device))
                width = filters
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(width, num_classes, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kh, kw = m.kernel_size
                lecun_normal_(m.weight, m.in_channels * kh * kw, generator)
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        lecun_normal_(self.head.weight, self.head.in_features, generator)
        self.head.bias.zero_()
        return self

    def forward(self, x, train: bool = False, generator=None):
        del train, generator
        x = x.to(self.dtype)
        if x.ndim == 3:  # (B, H, W) → add channel dim
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        x = torch.relu(group_norm(conv_same(x, self.stem, self.dtype),
                                  self.stem_norm, self.dtype))
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))  # global average pool
        return dense(self.head, x, self.dtype).float()
