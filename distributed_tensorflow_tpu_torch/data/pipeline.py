"""Host input pipeline: shuffle examples, then batch (a copy of the JAX
package's ``data/pipeline.py``, which imports only numpy).

Shuffling is example-level with a per-epoch deterministic permutation
(``default_rng((seed, epoch))``), so the batches are byte-equal to the JAX
package's for the same arguments.  Batches are ``(x, y, mask)``: ``mask``
flags the padding rows a short final batch gets unless ``drop_remainder``.
``start_batch`` skips the first N batches of an epoch without changing its
permutation.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

Batch = tuple[np.ndarray, np.ndarray, np.ndarray]


def iter_batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_remainder: bool = False,
    start_batch: int = 0,
) -> Iterator[Batch]:
    if start_batch < 0:
        raise ValueError(f"start_batch must be >= 0, got {start_batch}")
    n = len(x)
    idx = np.arange(n)
    if shuffle:
        # the permutation depends only on (seed, epoch), never on
        # start_batch
        rng = np.random.default_rng((seed, epoch))
        rng.shuffle(idx)
    for start in range(start_batch * batch_size, n, batch_size):
        take = idx[start : start + batch_size]
        if len(take) < batch_size:
            if drop_remainder:
                return
            bx, by = x[take], y[take]
            mask = np.ones(len(take), dtype=np.float32)
            pad = batch_size - len(take)
            bx = np.concatenate([bx, np.zeros((pad, *x.shape[1:]), x.dtype)])
            # labels may be multi-dim (LM next-token targets are (B, L))
            by = np.concatenate([by, np.zeros((pad, *y.shape[1:]), y.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            yield bx, by, mask
            return
        yield x[take], y[take], np.ones(batch_size, dtype=np.float32)


def steps_per_epoch(n: int, batch_size: int, drop_remainder: bool = False) -> int:
    return n // batch_size if drop_remainder else -(-n // batch_size)
