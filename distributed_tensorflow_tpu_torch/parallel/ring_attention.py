"""Single-device dense attention (port of ``parallel/ring_attention.py``).

Only ``dense_attention`` is ported: it is the gather path's attention in
paged serving and the math behind ``ops.paged_attention``'s plain version.
The ring and Ulysses schedules are later work (ROADMAP Queue 1).
Shapes follow the JAX package: q/k/v are (batch, seq, heads, head_dim).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp() NaN-free when
                 # an entire row is masked


def dense_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    kv_mask=None):
    """Reference attention over (B, L, H, D) tensors, computed in q's dtype.

    ``kv_mask``: optional key-validity mask; masked keys get NEG_INF.
    (B, Lk) applies per batch row to every query; (B, Lq, Lk) applies per
    query (the multi-position decode step).
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
    neg = torch.tensor(NEG_INF, dtype=s.dtype, device=s.device)
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(lq, device=s.device)[:, None]
        kpos = torch.arange(lk, device=s.device)[None, :]
        s = torch.where(qpos >= kpos, s, neg)
    if kv_mask is not None:
        m = (kv_mask[:, None, :, :] if kv_mask.ndim == 3
             else kv_mask[:, None, None, :])
        s = torch.where(m > 0, s, neg)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", p, v)
