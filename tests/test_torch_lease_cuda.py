"""The lease drain on the card: a fit whose chunks are replayed CUDA
graphs, drained by the lease's step budget and by a SIGTERM, with its
final checkpoint, then restored by a fresh engine: bitwise the
uninterrupted run.  The telemetry (tracer, metrics logger, timeline,
straggler detector) rides the same fits and changes no bit.  Marked
``cuda``: skipped without an NVIDIA GPU.  On the card, with no JAX
installed there:

    python -m pytest -m cuda tests/test_torch_lease_cuda.py

A small dense-attention GPT with dropout 0.1 (the Philox stream is part of
what a resume restores), f32, TF32 off, chunks of 4 steps (the first
eager, the second captured, the rest replayed by ``SyncEngine``).
"""

import os
import signal

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.data.loaders import Dataset
from distributed_tensorflow_tpu_torch.elastic import (
    LeaseManager, StragglerDetector, elastic_restore)
from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer
from distributed_tensorflow_tpu_torch.engines.sync import _ChunkGraph
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.observability import Timeline, Tracer
from distributed_tensorflow_tpu_torch.utils.checkpoint import (
    AsyncCheckpointManager)
from distributed_tensorflow_tpu_torch.utils.metrics import MetricsLogger

pytestmark = pytest.mark.cuda

GPT = dict(num_classes=256, hidden=256, layers=2, heads=4, ffn=1024,
           max_len=64, dropout_rate=0.1, attention_impl="dense")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs, pinned copies and "
                    "the CUDA generator have no CPU mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32 = saved


def _ds(n=256):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (n, 64)).astype(np.int32)
    return Dataset(x=x, y=np.roll(x, -1, axis=1), num_classes=256,
                   name="tokens", synthetic=True)


def _trainer():
    return Trainer(None, engine=SyncEngine(create_model("gpt", device="cuda",
                                                        **GPT)), seed=0)


def _fit(tr, telemetry=False, **kw):
    ml = MetricsLogger(None, log_every=1)
    extra = dict(tracer=Tracer(), timeline=Timeline(interval_s=0.0),
                 straggler_detector=StragglerDetector()) if telemetry else {}
    r = tr.fit(_ds(), epochs=1, batch_size=8, log_every=0, steps_per_call=4,
               metrics_logger=ml, **extra, **kw)
    return r, [(m["step"], m["loss"]) for m in ml.records]


def _snapshot(tr):
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in tr.engine.checkpoint_state(tr.state).items()}


@pytest.mark.parametrize("trigger", ["budget", "signal"])
def test_lease_drain_with_graph_chunks_is_bitwise(cuda_device, tmp_path,
                                                  trigger):
    """32 uninterrupted steps in chunks of 4 against a fit drained at the
    boundary after step 10 (budget: the lease's 10 steps; signal: SIGTERM
    sent at boundary 8), its final checkpoint restored into a fresh engine
    that trains the rest: the per-step losses and the final state are
    bitwise, with the telemetry on in the drained halves."""
    whole = _trainer()
    rw, traj = _fit(whole)
    assert rw["steps"] == 32
    captures = _ChunkGraph.captures
    mgr = AsyncCheckpointManager(tmp_path / "c")
    first = _trainer()
    before = signal.getsignal(signal.SIGTERM)
    with LeaseManager(max_steps_per_lease=10 if trigger == "budget"
                      else 0) as lease:
        def hook(steps_done):
            reason = lease.should_stop(steps_done)
            if trigger == "signal" and steps_done == 8:
                os.kill(os.getpid(), signal.SIGTERM)
            return reason

        r1, traj1 = _fit(first, telemetry=True, checkpoint_manager=mgr,
                         should_stop=hook)
    assert signal.getsignal(signal.SIGTERM) is before
    assert _ChunkGraph.captures > captures       # the drained run replayed
    assert r1["preempted"] == ("max_steps_per_lease:10"
                               if trigger == "budget" else "signal:SIGTERM")
    assert r1["steps"] == 12 and mgr.latest_step() == 12
    tr = _trainer()
    template = tr.engine.init_state(torch.Generator().manual_seed(0),
                                    _ds().x[:1])
    tr.state, extra = elastic_restore(mgr, tr.engine, template)
    mgr.close()
    r2, traj2 = _fit(tr, telemetry=True, data_state=extra["data_state"])
    assert r2["start_step"] == 12 and r2["resume_replay_steps"] == 0
    assert traj1 + traj2 == traj
    a, b = _snapshot(whole), _snapshot(tr)
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k
