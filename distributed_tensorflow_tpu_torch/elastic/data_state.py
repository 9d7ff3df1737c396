"""Exactly-once data resume: the batch stream's position as checkpoint
state (a copy of the JAX package's ``elastic/data_state.py``, which
imports the stdlib only).

The training loop's batch sequence is a pure function of (seed, epoch,
batch index): the shuffle permutation is a deterministic draw from
``(seed, epoch)`` (data/pipeline.py) and ``start_batch`` resumes an epoch
mid-stream without changing it.  So the ENTIRE data-iterator state is the
small record below — it rides each checkpoint as the elastic sidecar
(utils/checkpoint.py ``save(..., extra=)``), and a resumed run continues
the *identical* batch sequence: kill-and-resume is bitwise-comparable to
the uninterrupted run on the same mesh, and tolerance-comparable across
meshes (tests/test_elastic.py).

Prefetch discounting: the device prefetcher (data/device_prefetch.py) and
the Trainer's chunk assembly read AHEAD of the steps actually trained.
Batches staged but not yet consumed must be neither replayed (they were
pulled from the source) nor dropped (they were never trained on) — the
position that goes into the checkpoint is the CONSUMER count, not the
producer count.  The Trainer derives it from its own step counter (a
checkpoint boundary's state covers exactly ``steps`` batches);
``consumer_state`` below is the same discount for custom consumers
wrapping a :class:`ResumableBatches` in a ``DevicePrefetch``.

A checkpoint without a data state (written by an older build, or by a run
with different seed/batch-size) still restores — the resumed run then
restarts the batch stream from epoch 0 and reports the unrecoverable
positions as ``resume_replay_steps`` (BASELINE.md "Preemption
accounting").

Scope note (process-sharded datasets): the state records the PER-PROCESS
local batch size and shard length, so a resume across a different
*process* count fails the match and replay-accounts — deliberately.
Each process iterates its own dataset shard, and resharding the data
across a new process count changes every shard's content: there is no
position in the new shards that continues the old global sequence, so a
claimed "exact" resume would be a lie.  In the port every rank draws the
same global batches (``Trainer.fit``), so a relaunch onto another rank
count at the same global batch matches.
"""

from __future__ import annotations

import dataclasses
from typing import Any

DATA_STATE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class DataState:
    """One batch stream's resume position plus the identity fields that
    decide whether an exact resume is valid: a state recorded under a
    different seed, batch size or dataset length describes a DIFFERENT
    batch sequence, so matching fails and the consumer falls back to
    replay accounting instead of silently training on the wrong stream."""

    epoch: int
    batch_index: int          # batches consumed within `epoch`
    seed: int
    batch_size: int           # the LOCAL batch size the stream was cut at
    dataset_len: int
    dataset: str = "dataset"
    version: int = DATA_STATE_VERSION

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, payload: Any) -> "DataState | None":
        """Tolerant decode: a missing/garbled payload returns None (the
        replay-accounting path), never raises — a checkpoint must stay
        restorable even when its sidecar is from another build."""
        if not isinstance(payload, dict):
            return None
        try:
            return cls(
                epoch=int(payload["epoch"]),
                batch_index=int(payload["batch_index"]),
                seed=int(payload["seed"]),
                batch_size=int(payload["batch_size"]),
                dataset_len=int(payload["dataset_len"]),
                dataset=str(payload.get("dataset", "dataset")),
                version=int(payload.get("version", DATA_STATE_VERSION)))
        except (KeyError, TypeError, ValueError):
            return None

    def matches(self, *, seed: int, batch_size: int, dataset_len: int,
                dataset: str | None = None) -> bool:
        """True iff this state describes the batch sequence the given run
        parameters would produce — the precondition for an exact resume.
        ``dataset`` (the stream's recorded name) participates when given:
        two different datasets can coincide in seed/batch/length (e.g.
        equal-sized synthetic corpora), and resuming one at the other's
        position would silently train the wrong sequence."""
        return (self.seed == seed and self.batch_size == batch_size
                and self.dataset_len == dataset_len
                and (dataset is None or self.dataset == dataset))


class ResumableBatches:
    """The iterator contract's ``state()``/``restore()`` implementation:
    one epoch of ``(x, y, mask)`` batches over a ``Dataset`` that knows
    its own position.

    Satisfies the shared producer contract (data/pipeline.py module
    docstring — same-size batches, ``close()``) and adds ``state()``,
    which reports the PRODUCER position: how many of the epoch's batches
    have been pulled.  A consumer reading ahead (DevicePrefetch) must
    discount its buffer — use :func:`consumer_state` — or, like the
    Trainer, derive the position from its own consumption counter.

    ``ResumableBatches.restore(ds, state)`` continues the identical
    sequence: same (seed, epoch) permutation, skipping ``batch_index``
    batches (tests prove list equality with the uninterrupted stream).
    """

    def __init__(self, dataset, batch_size: int, *, seed: int = 0,
                 epoch: int = 0, start_batch: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True):
        self._dataset = dataset
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.start_batch = int(start_batch)
        self._index = int(start_batch)
        self._it = dataset.batches(
            batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
            drop_remainder=drop_remainder, start_batch=start_batch,
            native=False)

    def __iter__(self) -> "ResumableBatches":
        return self

    def __next__(self):
        batch = next(self._it)
        self._index += 1
        return batch

    def state(self) -> DataState:
        """Producer position: batches pulled from this stream so far."""
        return DataState(
            epoch=self.epoch, batch_index=self._index, seed=self.seed,
            batch_size=self.batch_size, dataset_len=len(self._dataset),
            dataset=getattr(self._dataset, "name", "dataset"))

    @classmethod
    def restore(cls, dataset, state: DataState,
                **kwargs) -> "ResumableBatches":
        """Resume the stream ``state`` describes: validates that ``state``
        was recorded over THIS dataset (its length and name — seed and
        batch size come FROM the state, so they cannot mismatch), then
        continues at its batch index."""
        name = getattr(dataset, "name", "dataset")
        if state.dataset_len != len(dataset) or state.dataset != name:
            raise ValueError(
                f"data state (dataset '{state.dataset}', "
                f"len={state.dataset_len}) does not describe this dataset "
                f"('{name}', len={len(dataset)}); an exact resume would "
                f"train the wrong batch sequence")
        return cls(dataset, state.batch_size, seed=state.seed,
                   epoch=state.epoch, start_batch=state.batch_index,
                   **kwargs)

    def close(self) -> None:
        close = getattr(self._it, "close", None)
        if close is not None:
            close()


def consumer_state(source: ResumableBatches, prefetcher) -> DataState:
    """The exactly-once position of a prefetched stream: the source's
    producer index minus everything the prefetcher staged but never handed
    out — i.e. ``start_batch + prefetcher.consumed``.  Checkpointing THIS
    number means a resume neither replays a trained batch nor drops a
    staged-but-untrained one (the prefetch depth is drained/discounted,
    not persisted)."""
    return dataclasses.replace(
        source.state(),
        batch_index=source.start_batch + prefetcher.consumed)
