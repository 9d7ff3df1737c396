"""Single-device dense attention (port of ``parallel/ring_attention.py``).

Only ``dense_attention`` is ported: it is the gather path's attention in
paged serving, the math behind ``ops.paged_attention``'s plain version,
and BERT's ``dense`` attention (with attention-probability dropout through
``prob_fn``).
The ring and Ulysses schedules are later work (ROADMAP Queue 1).
Shapes follow the JAX package: q/k/v are (batch, seq, heads, head_dim).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp() NaN-free when
                 # an entire row is masked


def dense_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    kv_mask=None, prob_fn=None):
    """Reference attention over (B, L, H, D) tensors, computed in q's dtype.

    ``kv_mask``: optional key-validity mask; masked keys get NEG_INF.
    (B, Lk) applies per batch row to every query; (B, Lq, Lk) applies per
    query (the multi-position decode step).
    ``prob_fn``: optional transform of the post-softmax probabilities
    (B, H, Lq, Lk): the hook for attention-probability dropout.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
    # masked_fill takes the scalar as a kernel argument: no host-to-device
    # copy, so the read can be captured in a CUDA graph
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(lq, device=s.device)[:, None]
        kpos = torch.arange(lk, device=s.device)[None, :]
        s = s.masked_fill(qpos < kpos, NEG_INF)
    if kv_mask is not None:
        m = (kv_mask[:, None, :, :] if kv_mask.ndim == 3
             else kv_mask[:, None, None, :])
        s = s.masked_fill(~(m > 0), NEG_INF)
    p = torch.softmax(s, dim=-1)
    if prob_fn is not None:
        p = prob_fn(p)
    return torch.einsum("bhlm,bmhd->blhd", p, v)
