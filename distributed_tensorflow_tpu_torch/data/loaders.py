"""Dataset loading: local archives when present, deterministic synthetic
fallback otherwise (nothing downloads).  A port of the JAX package's
``data/loaders.py``, which imports only numpy and the stdlib.

The arrays are the JAX package's, byte for byte, for the same arguments:
the synthetic datasets are the same ``numpy.random.default_rng`` draws and
a local file is read the same way.

Real-data formats understood:
  mnist / fashion_mnist  — keras-style ``.npz`` with x_train/y_train/x_test/y_test
  cifar10                — either ``cifar10.npz`` (same keys) or the original
                           ``cifar-10-batches-py`` pickle directory
  lm / lm_synth          — a flat uint16 token file ``<name>.bin``

Search order: $DTF_TPU_DATA_DIR, ~/.keras/datasets, ./datasets, /root/data.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from pathlib import Path

import numpy as np

from distributed_tensorflow_tpu_torch import not_ported

_SHAPES = {
    "mnist": ((28, 28), 10),
    "fashion_mnist": ((28, 28), 10),
    "cifar10": ((32, 32, 3), 10),
}


@dataclasses.dataclass
class Dataset:
    """Host-side dataset: plain numpy, batched lazily by the pipeline."""

    x: np.ndarray
    y: np.ndarray
    num_classes: int
    name: str = "dataset"
    synthetic: bool = False
    batch_size: int | None = None
    buffer_size: int = 10000
    # (index, count) when this dataset is one PROCESS's shard of a larger
    # logical dataset: the Trainer then treats batches as process-local
    # rows of a global batch
    process_shard: tuple[int, int] | None = None

    def __len__(self) -> int:
        return len(self.x)

    def shard(self, n_shards: int, index: int, even: bool = False) -> "Dataset":
        """Every n-th example, like ``tf.data .shard``.  ``even=True``
        truncates every shard to ``len // n_shards`` so all shards are the
        same size (lock-step ranks must run the same batch count)."""
        x, y = self.x[index::n_shards], self.y[index::n_shards]
        if even:
            m = len(self.x) // n_shards
            x, y = x[:m], y[:m]
        return dataclasses.replace(self, x=x, y=y)

    def process_shard_of(self, n_procs: int, index: int) -> "Dataset":
        """This process's EVEN shard plus the ``process_shard`` marker the
        Trainer reads to assemble global batches from process-local rows."""
        return dataclasses.replace(
            self.shard(n_procs, index, even=True),
            process_shard=(index, n_procs))

    def with_batching(self, batch_size: int,
                      buffer_size: int = 10000) -> "Dataset":
        return dataclasses.replace(
            self, batch_size=batch_size, buffer_size=buffer_size)

    def batches(self, batch_size: int | None = None, *, shuffle: bool = True,
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
        bs = batch_size or self.batch_size
        if bs is None:
            raise ValueError(
                "batch_size not set; pass it or use with_batching()")
        return iter_batches(
            self.x, self.y, bs, shuffle=shuffle, seed=seed, epoch=epoch,
            drop_remainder=drop_remainder, start_batch=start_batch)


def _search_dirs() -> list[Path]:
    dirs = []
    if os.environ.get("DTF_TPU_DATA_DIR"):
        dirs.append(Path(os.environ["DTF_TPU_DATA_DIR"]))
    dirs += [
        Path.home() / ".keras" / "datasets",
        Path("datasets"),
        Path("/root/data"),
    ]
    return [d for d in dirs if d.is_dir()]


def _find(*names: str) -> Path | None:
    for d in _search_dirs():
        for n in names:
            p = d / n
            if p.exists():
                return p
    return None


def _load_npz(path: Path, split: str):
    with np.load(path, allow_pickle=False) as f:
        if split == "train":
            return f["x_train"], f["y_train"]
        return f["x_test"], f["y_test"]


def _load_cifar_batches(path: Path, split: str):
    def one(p: Path):
        with open(p, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x, np.asarray(d[b"labels"])

    if split == "train":
        parts = [one(path / f"data_batch_{i}") for i in range(1, 6)]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))
    return one(path / "test_batch")


def synthetic_classification(
    shape: tuple[int, ...],
    num_classes: int,
    n: int,
    seed: int,
    split: str = "train",
    noise: float = 0.35,
):
    """Per-class Gaussian prototypes + noise: learnable, deterministic.
    Prototypes depend only on ``seed`` (shared across splits); the noise
    and label draws are keyed by (seed, split)."""
    proto_rng = np.random.default_rng(seed)
    protos = proto_rng.normal(0.5, 0.25, size=(num_classes, *shape)).clip(0, 1)
    rng = np.random.default_rng((seed, 0 if split == "train" else 1))
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = protos[y] + rng.normal(0.0, noise, size=(n, *shape))
    return x.clip(0.0, 1.0).astype(np.float32), y


def synthetic_text_classification(
    n: int,
    seq_len: int = 128,
    vocab_size: int = 1024,
    num_classes: int = 2,
    seed: int = 0,
    split: str = "train",
):
    """Topic-model synthetic text: each class draws tokens from its own
    Zipf-reweighted vocabulary distribution.  Token id 0 is reserved for
    padding; sequences are full-length."""
    proto_rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, vocab_size)  # ids 1..V-1, Zipf-ish
    class_logits = np.stack([
        np.log(base) + 0.75 * proto_rng.normal(size=vocab_size - 1)
        for _ in range(num_classes)
    ])
    probs = np.exp(class_logits)
    probs /= probs.sum(axis=1, keepdims=True)
    rng = np.random.default_rng((seed, 0 if split == "train" else 1))
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = np.stack([
        rng.choice(vocab_size - 1, size=seq_len, p=probs[c]) + 1 for c in y
    ]).astype(np.int32)
    x[:, 0] = 1  # fixed [CLS]-like token at position 0
    return x, y


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
    the data search path is windowed into non-overlapping ``seq_len``
    chunks, the final ``holdout`` fraction being the test split.
    Otherwise the deterministic Markov-chain synthetic corpus."""
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


def load_text_dataset(
    name: str = "glue_synth",
    split: str = "train",
    seq_len: int = 128,
    vocab_size: int = 1024,
    n_train: int = 4096,
    n_test: int = 1024,
) -> Dataset:
    """Text workload loader (BERT-tiny stand-in).  Synthetic only: real
    GLUE needs a download."""
    n = n_train if split == "train" else n_test
    x, y = synthetic_text_classification(
        n, seq_len=seq_len, vocab_size=vocab_size,
        seed=sum(ord(c) for c in name) % (2**31), split=split)
    return Dataset(x=x, y=y, num_classes=2, name=name, synthetic=True)


def load_dataset(
    name: str,
    split: str = "train",
    reshape: bool = True,
    n_synthetic_train: int = 8192,
    n_synthetic_test: int = 2048,
) -> Dataset:
    """Load a named dataset; fall back to synthetic arrays when no local
    copy exists (``synthetic`` says which).  ``reshape=True`` adds a
    trailing channel dim to 2-D images ((28,28) → (28,28,1))."""
    if name in ("glue_synth", "text", "glue"):
        return load_text_dataset(name, split=split)
    if name in ("lm_synth", "lm"):
        return load_lm_dataset(name, split=split)
    if name in ("synthetic", "synth"):
        name, shape, ncls, path = "synthetic", (28, 28), 10, None
    elif name in _SHAPES:
        shape, ncls = _SHAPES[name]
        if name == "mnist":
            path = _find("mnist.npz")
        elif name == "fashion_mnist":
            path = _find("fashion_mnist.npz", "fashion-mnist.npz")
        else:
            path = _find("cifar10.npz") or _find("cifar-10-batches-py")
    else:
        raise KeyError(f"unknown dataset '{name}'; known: {sorted(_SHAPES)} "
                       f"+ synthetic")

    if path is not None:
        if path.is_dir():
            x, y = _load_cifar_batches(path, split)
        else:
            x, y = _load_npz(path, split)
        x = x.astype(np.float32) / 255.0
        synthetic = False
    else:
        n = n_synthetic_train if split == "train" else n_synthetic_test
        # stable per-dataset seed (hash() is salted per process)
        seed = sum(ord(c) for c in name) * 1000003 % (2**31)
        x, y = synthetic_classification(shape, ncls, n, seed, split=split)
        synthetic = True

    if reshape and x.ndim == 3:  # (N,28,28) → (N,28,28,1)
        x = x[..., None]
    return Dataset(x=x, y=y.astype(np.int32), num_classes=ncls, name=name,
                   synthetic=synthetic)
