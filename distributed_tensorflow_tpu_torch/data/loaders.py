"""Dataset loading for the language-model training path (port of the LM
parts of ``data/loaders.py``).

The arrays are the JAX package's, byte for byte, for the same arguments:
the synthetic corpus is the same ``numpy.random.default_rng`` draws, and a
local corpus is read the same way.  Ported: ``Dataset`` (Python batching
path only), ``synthetic_lm``, ``load_lm_dataset`` and ``load_dataset`` for
``lm_synth``/``lm``.  The image and text-classification datasets belong to
the CNN/MLP training path and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np

from distributed_tensorflow_tpu_torch import not_ported

_CNN = "training with the CNN/MLP sync path"


@dataclasses.dataclass
class Dataset:
    """Host-side dataset: plain numpy, batched lazily by the pipeline."""

    x: np.ndarray
    y: np.ndarray
    num_classes: int
    name: str = "dataset"
    synthetic: bool = False

    def __len__(self) -> int:
        return len(self.x)

    def batches(self, batch_size: int, *, shuffle: bool = True,
                seed: int = 0, epoch: int = 0, drop_remainder: bool = False,
                native: bool | None = None, start_batch: int = 0):
        """Iterate (x, y, mask) batches for one epoch (``iter_batches``).

        ``native=True`` (the JAX package's C++ batcher) is not ported and
        raises; ``None``/``False`` take the Python path, whose batches are
        the ones the JAX package yields on either of its paths."""
        from distributed_tensorflow_tpu_torch.data.pipeline import (
            iter_batches)

        if native:
            not_ported("the native C++ batcher (native=True)", "native/")
        return iter_batches(
            self.x, self.y, batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
            drop_remainder=drop_remainder, start_batch=start_batch)


def _find(*names: str) -> Path | None:
    """First of ``names`` in ``$DTF_TPU_DATA_DIR`` or ``./datasets``."""
    dirs = [Path(os.environ["DTF_TPU_DATA_DIR"])] if os.environ.get(
        "DTF_TPU_DATA_DIR") else []
    dirs.append(Path("datasets"))
    for d in dirs:
        for n in names:
            if (d / n).exists():
                return d / n
    return None


def synthetic_lm(
    n: int,
    seq_len: int = 128,
    vocab_size: int = 128,
    seed: int = 0,
    split: str = "train",
    concentration: float = 0.1,
):
    """First-order Markov-chain token streams for language modeling.

    Each row of the transition matrix is a Dirichlet(concentration) draw,
    so an LM that learns the chain reaches high next-token accuracy while
    an untrained one sits near 1/vocab.  Deterministic in (seed, split);
    the chain is shared across splits while the trajectories are disjoint.

    Returns ``(x, y)`` with x = tokens[:, :-1] and y = tokens[:, 1:].
    """
    proto_rng = np.random.default_rng(seed)
    trans = proto_rng.dirichlet(
        np.full(vocab_size, concentration), size=vocab_size)
    cdf = np.cumsum(trans, axis=1)
    rng = np.random.default_rng((seed, 0 if split == "train" else 1))
    seq = np.empty((n, seq_len + 1), np.int64)
    seq[:, 0] = rng.integers(0, vocab_size, size=n)
    for t in range(1, seq_len + 1):
        u = rng.random(n)
        # inverse-CDF sampling; the clip guards a row whose cumsum tops out
        # below 1.0 (a draw past it would give the id vocab_size)
        seq[:, t] = np.minimum(
            (cdf[seq[:, t - 1]] < u[:, None]).sum(axis=1), vocab_size - 1)
    seq = seq.astype(np.int32)
    return seq[:, :-1], seq[:, 1:]


def load_lm_dataset(
    name: str = "lm_synth",
    split: str = "train",
    seq_len: int = 128,
    vocab_size: int | None = None,
    n_train: int = 4096,
    n_test: int = 1024,
    holdout: float = 0.1,
) -> Dataset:
    """Language-modeling workload: (B, L) token inputs with (B, L)
    next-token targets; ``num_classes`` is the vocab size.

    A local ``<name>.bin`` (or ``lm_tokens.bin``) of uint16 token ids in
    ``$DTF_TPU_DATA_DIR`` or ``./datasets`` is windowed into non-overlapping
    ``seq_len`` chunks, the final ``holdout`` fraction being the test split
    (the JAX loader also searches two directories outside the checkout; the
    port reads nothing there).  Otherwise the deterministic Markov-chain
    synthetic corpus."""
    path = _find(f"{name}.bin", "lm_tokens.bin")
    if path is not None:
        tokens = np.memmap(path, dtype=np.uint16, mode="r")
        cut = int(len(tokens) * (1.0 - holdout))
        lo, hi = (0, cut) if split == "train" else (cut, len(tokens))
        n = (hi - lo - 1) // seq_len
        if n < 1:
            raise ValueError(
                f"{split} region of {path.name} has {hi - lo} tokens — "
                f"fewer than seq_len + 1 = {seq_len + 1}; shrink seq_len "
                f"or holdout")
        base = lo + np.arange(n * seq_len)
        x = np.asarray(tokens[base]).reshape(n, seq_len).astype(np.int32)
        y = np.asarray(tokens[base + 1]).reshape(n, seq_len).astype(np.int32)
        vocab = (vocab_size if vocab_size is not None
                 else int(tokens.max()) + 1)
        if vocab_size is not None:
            top = int(max(x.max(), y.max()))
            if top >= vocab_size:
                raise ValueError(
                    f"vocab_size {vocab_size} does not cover {path.name}: "
                    f"{split} split contains token id {top}; pass "
                    f"vocab_size >= {top + 1} or omit it to derive from "
                    f"the corpus")
        return Dataset(x=x, y=y, num_classes=vocab, name=name,
                       synthetic=False)
    vocab = vocab_size if vocab_size is not None else 128
    n = n_train if split == "train" else n_test
    x, y = synthetic_lm(n, seq_len=seq_len, vocab_size=vocab,
                        seed=sum(ord(c) for c in name) % (2**31), split=split)
    return Dataset(x=x, y=y, num_classes=vocab, name=name, synthetic=True)


def load_dataset(name: str, split: str = "train") -> Dataset:
    """Load a named dataset: ``lm_synth``/``lm`` (``load_lm_dataset``).
    The image and text-classification names are not ported."""
    if name in ("lm_synth", "lm"):
        return load_lm_dataset(name, split=split)
    if name in ("glue_synth", "text", "glue", "synthetic", "synth", "mnist",
                "fashion_mnist", "cifar10"):
        not_ported(f"dataset '{name}'", _CNN)
    raise KeyError(f"unknown dataset '{name}'; ported: lm_synth, lm")
