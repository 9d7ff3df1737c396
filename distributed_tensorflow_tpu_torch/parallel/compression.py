"""int8 channel codec (port of ``parallel/compression.py``).

Only ``int8_channel_encode``/``int8_channel_decode`` are ported: they make
the int8 pools with per-vector f32 scales that ``ops.paged_attention``'s
quantized variant reads.  The gradient codecs are later work.
"""

from __future__ import annotations

import torch


def int8_channel_encode(x: torch.Tensor,
                        axis: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, scale): max-abs scale reduced over ``axis`` (one f32 scale per
    remaining index), values rounded to nearest (ties to even, as
    ``jnp.round``) into int8 [-127, 127].  The scale is floored at
    ``finfo(float32).tiny`` so an all-zero vector encodes to zeros."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=axis) / 127.0
    scale = torch.clamp_min(scale, torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(x32 / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def int8_channel_decode(q: torch.Tensor, scale: torch.Tensor, dtype,
                        axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`int8_channel_encode` (broadcasts the scale back
    over ``axis``)."""
    return (q.to(torch.float32)
            * scale.unsqueeze(axis).to(torch.float32)).to(dtype)
