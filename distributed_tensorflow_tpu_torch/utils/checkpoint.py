"""Checkpoint / resume (port of ``utils/checkpoint.py``).

A checkpoint holds a whole ``TrainState``: every parameter and buffer of
the module, the optimizer's state (a master policy's f32 master, inner
state and loss-scale fields included), the step, the seed and, on the
card, the dropout generator's state (``Engine.checkpoint_state``).  The
on-disk format is the port's own, not orbax's: ``step_N/state.pt`` is a
``torch.save`` of a flat dict of CPU tensors, read back with
``torch.load(..., weights_only=True)`` (no pickled objects), and
``step_N/state.json`` the plain fields (step, seed, precision, the rank
count and whether each rank's state was saved).  A restore copies into
the live tensors of a template state (``Engine.load_checkpoint_state``),
so CUDA graphs captured over them stay valid.

Engines whose ranks hold the same state (sync/allreduce, sequence and
expert parallel) are written by rank 0, the expert-parallel engine's
experts gathered first; local SGD and gossip write every rank's state
(``state_rank<r>.pt``), as the JAX package saves the per-device stacked
state, and restore only onto the rank count that wrote them.  A save of
more than one rank ends in a barrier.

Two write disciplines share one on-disk format:

* :class:`CheckpointManager` — synchronous: ``save`` blocks the caller
  for the full device→host copy, write and retention sweep.
* :class:`AsyncCheckpointManager` — ``save`` enqueues the snapshot on the
  compute stream (a non-blocking copy into pinned host buffers on the
  card, a copy on the CPU), since the next step changes the state in
  place, and hands it to a single background writer thread, which waits
  for the copy's CUDA event before it writes; the caller dispatches its
  next chunk immediately.  At most one save is in flight (a second
  ``save`` waits on the previous write — bounded host memory); writer
  errors re-raise at the next ``save``/``wait``/``close``; ``restore``
  begins with a drain barrier so resume never races a pending write.  A
  save of more than one rank stays synchronous.

Both write atomically: the files go into ``tmp_step_N``, every file is
fsynced, then the directory is renamed to ``step_N`` — a crash mid-write
leaves only a ``tmp_`` directory (invisible to ``steps()``/``restore``
and swept on the next manager start), never a half-written visible
checkpoint.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

_STEP_DIR = re.compile(r"^step_(\d+)$")
_TMP_DIR = re.compile(r"^tmp_step_(\d+)$")

# JSON sidecar riding INSIDE each step directory: the elastic payload —
# data-iterator state + save wall time — that makes a checkpoint a
# resumable, exactly-once object (elastic/data_state.py).  Written into
# tmp_step_N BEFORE the fsync + rename, so the payload is atomic with the
# checkpoint itself: a visible step_N either carries its sidecar or was
# written without one (restore then degrades to replay accounting).
_EXTRA_FILE = "elastic.json"
_META_FILE = "state.json"
_PLAIN = ("step", "seed", "precision")
FORMAT_VERSION = 1


def _fsync_dir(path: Path) -> None:
    """Best-effort directory fsync: make the tmp→final rename (and the
    entries under it) durable before the checkpoint becomes visible."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_tree(path: Path) -> None:
    """fsync every file (then directory) under ``path``: the rename must
    never become durable before the bytes it points at."""
    for p in sorted(path.rglob("*")):
        if p.is_dir():
            _fsync_dir(p)
            continue
        try:
            fd = os.open(p, os.O_RDONLY)
        except OSError:
            continue
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)
    _fsync_dir(path)


def _layout(state) -> tuple[Any, int, int]:
    """(engine, ranks, this rank) of a ``TrainState`` (or a template)."""
    engine = state.engine
    if engine is None:
        raise ValueError("the state has no engine: checkpoint a state that "
                         "Engine.init_state built")
    mesh = engine.mesh
    if mesh is None:
        return engine, 1, 0
    return engine, mesh.world_size, mesh.rank


def _split(d: dict) -> tuple[dict, dict]:
    """A ``checkpoint_state`` dict as (tensors, plain fields)."""
    tensors = {k: v for k, v in d.items() if isinstance(v, torch.Tensor)}
    plain = {k: d[k] for k in _PLAIN}
    return tensors, plain


def _host_copy(tensors: dict) -> dict:
    """Blocking copies on the host (compact: a view's copy holds only
    its elements)."""
    return {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in tensors.items()}


def _rank_file(rank: int | None) -> str:
    return "state.pt" if rank is None else f"state_rank{rank}.pt"


class AsyncCheckpointError(RuntimeError):
    """A background checkpoint write failed; re-raised on the training
    thread at the next ``save``/``wait``/``close``."""


class CheckpointManager:
    """Step-numbered checkpoints under ``directory`` with retention."""

    asynchronous = False

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        if not dist.is_initialized() or dist.get_rank() == 0:
            # rank 0 alone writes tmp directories, so it alone sweeps them
            self._clean_tmp()

    def _clean_tmp(self) -> None:
        """A ``tmp_step_N`` left by a crashed write is garbage by
        definition (the rename never happened): sweep it on start."""
        for p in self.directory.iterdir():
            if _TMP_DIR.match(p.name) and p.is_dir():
                shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------ save
    @staticmethod
    def _resolve_step(state: Any, step: int | None) -> int:
        return int(state.step) if step is None else int(step)

    def _tmp(self, step: int) -> Path:
        tmp = self.directory / f"tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        return tmp

    @staticmethod
    def _put(tmp: Path, host_state: dict) -> None:
        """Write ``host_state`` ({file name: tensors or plain dict}) into
        ``tmp``: ``.pt`` files with ``torch.save``, ``.json`` as JSON."""
        for name, payload in host_state.items():
            if name.endswith(".json"):
                (tmp / name).write_text(json.dumps(payload))
            else:
                torch.save(payload, tmp / name)

    def _publish(self, step: int, tmp: Path, extra: dict | None) -> None:
        """Sidecar, fsync, rename: the checkpoint becomes visible whole."""
        if extra is not None:
            (tmp / _EXTRA_FILE).write_text(json.dumps(extra))
        _fsync_tree(tmp)
        final = self.directory / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(self.directory)

    def _write(self, step: int, host_state: dict,
               extra: dict | None = None) -> None:
        """Atomic visible write of one process's files: into
        ``tmp_step_N``, fsync, rename to ``step_N``.  A crash anywhere
        before the rename leaves only the ``tmp_`` directory — never a
        half-written ``step_N``.  ``extra`` (the elastic sidecar) is
        written into the tmp directory, so it becomes visible atomically
        with the checkpoint."""
        tmp = self._tmp(step)
        self._put(tmp, host_state)
        self._publish(step, tmp, extra)

    @staticmethod
    def _meta(plain: dict, ranks: int, per_rank: bool, engine) -> dict:
        return {**plain, "ranks": ranks, "per_rank": per_rank,
                "engine": type(engine).__name__, "format": FORMAT_VERSION}

    def save(self, state: Any, step: int | None = None,
             extra: dict | None = None) -> Path:
        """Write ``state`` as ``step_N`` (``step``: the state's step when
        None); every rank of a multi-rank engine calls it."""
        step = self._resolve_step(state, step)
        engine, ranks, rank = _layout(state)
        tensors, plain = _split(engine.checkpoint_state(state))
        per_rank = engine.checkpoint_per_rank
        meta = self._meta(plain, ranks, per_rank, engine)
        host = _host_copy(tensors)
        if ranks == 1:
            self._write(step, {_rank_file(0 if per_rank else None): host,
                               _META_FILE: meta}, extra)
            self._retain()
        else:
            # rank 0 makes the tmp directory, every rank writing a state
            # of its own puts its file there, rank 0 publishes
            tmp = self.directory / f"tmp_step_{step}"
            if rank == 0:
                self._tmp(step)
            dist.barrier()
            if per_rank:
                self._put(tmp, {_rank_file(rank): host})
            dist.barrier()
            if rank == 0:
                if not per_rank:
                    self._put(tmp, {_rank_file(None): host})
                self._put(tmp, {_META_FILE: meta})
                self._publish(step, tmp, extra)
                self._retain()
            dist.barrier()
        return self.directory / f"step_{step}"

    def _retain(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------- async interface
    # no-ops on the synchronous manager, so the Trainer/harness treat both
    # disciplines uniformly (drain barriers cost nothing here)
    def wait(self, reraise: bool = True) -> None:
        """No save is ever in flight on the synchronous manager."""

    def close(self, reraise: bool = True) -> None:
        """Nothing to join on the synchronous manager."""

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for p in self.directory.iterdir():
            m = _STEP_DIR.match(p.name)
            if m and p.is_dir():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def load_extra(self, step: int | None = None) -> dict | None:
        """The elastic sidecar saved with ``step`` (latest when None):
        data-iterator state + save wall time (elastic/data_state.py).
        ``None`` when the checkpoint carries none — callers then fall
        back to replay accounting — or when the step does not exist."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = self.directory / f"step_{step}" / _EXTRA_FILE
        try:
            payload = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return None
        return payload if isinstance(payload, dict) else None

    def load(self, template: Any, step: int | None = None) -> dict:
        """The checkpoint dict of ``step`` (latest when None) as this rank
        of ``template``'s engine reads it: its tensors on the CPU and the
        plain fields.  A checkpoint of every rank's state reads only on
        the rank count that wrote it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self.directory / f"step_{step}"
        meta = json.loads((path / _META_FILE).read_text())
        engine, ranks, rank = _layout(template)
        per_rank = engine.checkpoint_per_rank
        if meta["per_rank"] != per_rank:
            held = "every rank's state" if meta["per_rank"] else "one state"
            kept = ("a state per rank" if per_rank
                    else "one state on every rank")
            raise ValueError(
                f"checkpoint {path} holds {held} ({meta['engine']}); "
                f"{type(engine).__name__} keeps {kept}")
        if per_rank and meta["ranks"] != ranks:
            raise ValueError(
                f"checkpoint {path} holds {meta['ranks']} ranks' states; "
                f"this run has {ranks} ranks")
        tensors = torch.load(path / _rank_file(rank if per_rank else None),
                             map_location="cpu", weights_only=True)
        return {**tensors, **{k: meta[k] for k in _PLAIN}}

    def restore(self, template: Any, step: int | None = None) -> Any:
        """Restore into ``template`` (a freshly initialized TrainState —
        engine.init_state output, or a ``precision.f32_template``) in
        place; returns the restored state."""
        d = self.load(template, step)
        return template.engine.load_checkpoint_state(template, d)


class AsyncCheckpointManager(CheckpointManager):
    """Checkpointing off the training critical path (see module docstring).

    ``save`` costs the training thread the snapshot's enqueue (+ any wait
    for a still-running previous write — the at-most-one-in-flight
    backpressure that bounds host memory to one extra TrainState); the
    wait for the copy, the write, fsync-rename and retention sweep run on
    one background writer thread.  Training-thread seconds spent blocked
    accumulate in ``wait_s``; writer seconds that ran GENUINELY
    concurrently with training accumulate in ``overlapped_s`` (write
    wall time the trainer stood blocked on is counted once, in
    ``wait_s`` — never double-booked as overlap).

    A multi-rank save falls back to the synchronous path: it is a
    collective (the expert gather, the barriers) and cannot leave the
    training thread without racing training's own collectives.
    """

    asynchronous = True

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        super().__init__(directory, max_to_keep)
        self.wait_s = 0.0           # training-thread seconds blocked here
        # writer seconds GENUINELY concurrent with training: the writer
        # tallies its wall time, minus any of it the trainer spent
        # blocked waiting on that same write (see _blocked)
        self.overlapped_s = 0.0
        self.saves = 0
        self._idle = threading.Event()
        self._idle.set()
        self._error: BaseException | None = None
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._thread: threading.Thread | None = None
        self._acct_lock = threading.Lock()
        # pinned host buffers of the last snapshot, reused by the next
        # (at most one write is in flight, and it has ended by then)
        self._pinned: dict[str, torch.Tensor] = {}

    # ----------------------------------------------------------- writer side
    def _ensure_writer(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            step, host_state, copied, extra = job
            t0 = time.perf_counter()
            try:
                if copied is not None:
                    copied.synchronize()  # the snapshot's copies landed
                self._write(step, host_state, extra)
                self._retain()
            except BaseException as e:  # noqa: BLE001 — surfaced on the
                self._error = e         # training thread at the next sync
            finally:
                with self._acct_lock:
                    self.overlapped_s += time.perf_counter() - t0
                self._idle.set()

    def _reraise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise AsyncCheckpointError(
                f"background checkpoint write under {self.directory} "
                f"failed: {type(err).__name__}: {err}") from err

    # --------------------------------------------------------- training side
    def _blocked(self, seconds: float) -> None:
        """Account training-thread seconds spent waiting on an in-flight
        write: into ``wait_s``, and back out of ``overlapped_s`` (clamped
        at 0 against enqueue→dequeue jitter)."""
        self.wait_s += seconds
        with self._acct_lock:
            self.overlapped_s = max(0.0, self.overlapped_s - seconds)

    def _snapshot(self, tensors: dict):
        """Copies of ``tensors`` decoupled from the live state: card
        tensors go into pinned host buffers by non-blocking copies
        enqueued on the current stream (ordered after the step that made
        them and before the next one), CPU tensors are copied here.
        Returns the copies and the CUDA event the writer waits on (None
        without card tensors)."""
        out, on_card = {}, False
        for k, t in tensors.items():
            if t.is_cuda:
                buf = self._pinned.get(k)
                if buf is None or buf.shape != t.shape or \
                        buf.dtype != t.dtype:
                    buf = self._pinned[k] = torch.empty(
                        t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                on_card = True
            else:
                buf = t.detach().clone()
            out[k] = buf
        copied = None
        if on_card:
            copied = torch.cuda.Event()
            copied.record()
        return out, copied

    def save(self, state: Any, step: int | None = None,
             extra: dict | None = None) -> Path:
        engine, ranks, _ = _layout(state)
        if ranks > 1:
            return super().save(state, step, extra)  # collective: sync
        step = self._resolve_step(state, step)
        t0 = time.perf_counter()
        self._idle.wait()  # backpressure: at most ONE save in flight
        self._blocked(time.perf_counter() - t0)
        self._reraise()
        tensors, plain = _split(engine.checkpoint_state(state))
        per_rank = engine.checkpoint_per_rank
        host, copied = self._snapshot(tensors)
        host_state = {_rank_file(0 if per_rank else None): host,
                      _META_FILE: self._meta(plain, 1, per_rank, engine)}
        self._idle.clear()
        self._ensure_writer()
        self._queue.put((step, host_state, copied, extra))
        self.saves += 1
        return self.directory / f"step_{step}"

    def wait(self, reraise: bool = True) -> None:
        """Drain barrier: block until no write is in flight; surface any
        writer error (unless ``reraise=False`` — exception-path cleanup
        must not mask the original failure)."""
        t0 = time.perf_counter()
        self._idle.wait()
        self._blocked(time.perf_counter() - t0)
        if reraise:
            self._reraise()

    def close(self, reraise: bool = True) -> None:
        """Drain, stop the writer thread, surface any pending error."""
        self.wait(reraise=False)
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=60)
        self._thread = None
        self._pinned.clear()
        if reraise:
            self._reraise()

    def load(self, template: Any, step: int | None = None) -> dict:
        self.wait()  # resume must never read a directory mid-write
        return super().load(template, step)

    def latest_step(self) -> int | None:
        self.wait()  # an in-flight write IS the latest step once visible
        return super().latest_step()

    def load_extra(self, step: int | None = None) -> dict | None:
        self.wait()  # the sidecar lands with the write it rides
        return super().load_extra(step)

    def stats(self) -> dict[str, Any]:
        return {"saves": self.saves, "wait_s": self.wait_s,
                "overlapped_s": self.overlapped_s}
