"""The gradient codecs on the card: the codec collectives on a one-rank
NCCL group, an int8 chunk replayed as a CUDA graph against its eager
twin, and an int8 run checkpointed and resumed against the uninterrupted
one.  Marked ``cuda``: skipped without an NVIDIA GPU.  On the card, with
no JAX installed there:

    python -m pytest -m cuda tests/test_torch_codec_cuda.py

* The collectives (no generator: deterministic rounding) on the NCCL
  group equal the same math on the CPU with no group, bit for bit: a sum
  over one rank is the identity, and the codec's operations (casts,
  max, division, rounding) are correctly rounded on both.
* A small dense-attention GPT with dropout 0.1, f32, TF32 off, under
  ``int8`` (bucketed, K = 2 too): chunks of 4 steps (the first eager, the
  second captured, then replays) against single eager steps from the same
  seed: losses and parameters bitwise, and the codec stream advanced
  alike — the codec generator is registered with each graph.
* An int8 run stopped at step 8 with its checkpoint (``codec_generator/0``
  beside ``generator/0``), restored into a fresh engine and run on to 16:
  bitwise the uninterrupted run.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.data.loaders import Dataset
from distributed_tensorflow_tpu_torch.elastic import elastic_restore
from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer
from distributed_tensorflow_tpu_torch.engines.sync import _ChunkGraph
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.parallel import compression
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel import overlap
from distributed_tensorflow_tpu_torch.utils.checkpoint import (
    AsyncCheckpointManager)

pytestmark = pytest.mark.cuda

GPT = dict(num_classes=256, hidden=256, layers=2, heads=4, ffn=1024,
           max_len=64, dropout_rate=0.1, attention_impl="dense")


@pytest.fixture(scope="module")
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL, CUDA graphs and the CUDA "
                    "generator have no CPU mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = meshlib.create_mesh(1, device="cuda")
    yield mesh
    mesh.close()
    torch.backends.cuda.matmul.allow_tf32 = saved


def _leaves(device):
    rng = np.random.default_rng(0)
    shapes = [(37, 5), (1024,), (3, 300), (17,)]
    out = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in shapes]
    out.append(torch.from_numpy(rng.standard_normal(64).astype(np.float16)))
    return [t.to(device) for t in out]


@pytest.mark.parametrize("bucket", [0, 1e-3])
@pytest.mark.parametrize("name", compression.CODECS)
def test_collectives_on_nccl_equal_cpu_math(nccl_mesh, name, bucket):
    codec = overlap.make_overlap_codec(name, bucket)
    for op in ("all_reduce_sum", "all_reduce_mean"):
        got = getattr(codec, op)(_leaves("cuda"), nccl_mesh)
        want = getattr(codec, op)(_leaves("cpu"), None)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), (op,)
    got = codec.roundtrip(_leaves("cuda"))
    for g, w in zip(got, codec.roundtrip(_leaves("cpu"))):
        assert torch.equal(g.cpu(), w)
    nccl = compression.all_to_all_.nccl_launches
    compression.Int8Codec().all_reduce_sum(_leaves("cuda"), nccl_mesh)
    assert compression.all_to_all_.nccl_launches == nccl + 1


def _ds(n=256):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (n, 64)).astype(np.int32)
    return Dataset(x=x, y=np.roll(x, -1, axis=1), num_classes=256,
                   name="tokens", synthetic=True)


def _engine(mesh, **kw):
    return SyncEngine(create_model("gpt", device="cuda", **GPT), mesh=mesh,
                      grad_compression="int8", **kw)


@pytest.mark.parametrize("kw", [{}, dict(grad_bucket_mb=1.0,
                                         grad_accum=2)])
def test_int8_replay_equals_eager_twin(nccl_mesh, kw):
    ds = _ds()
    runs = {}
    for k in (4, 1):
        tr = Trainer(None, engine=_engine(nccl_mesh, **kw), seed=0)
        before = _ChunkGraph.replays
        lines = []
        tr.fit(ds, epochs=1, batch_size=8, log_every=1,
               log_fn=lines.append, steps_per_call=k, max_steps=16)
        torch.cuda.synchronize()
        runs[k] = (lines, [p.detach().clone()
                           for p in tr.state.model.parameters()],
                   tr.state.codec_generator.get_state(),
                   _ChunkGraph.replays - before)
    (l4, p4, g4, replays), (l1, p1, g1, _) = runs[4], runs[1]
    assert replays == 3    # chunk 2 captured and replayed, then 3 and 4
    assert l4 == l1 and len(l4) == 16
    assert all(torch.equal(a, b) for a, b in zip(p4, p1))
    assert torch.equal(g4, g1)


def test_int8_resume_is_bitwise(nccl_mesh, tmp_path):
    ds = _ds()
    whole = Trainer(None, engine=_engine(nccl_mesh), seed=0)
    whole.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
              max_steps=16)
    mgr = AsyncCheckpointManager(tmp_path / "c")
    first = Trainer(None, engine=_engine(nccl_mesh), seed=0)
    first.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
              max_steps=8, checkpoint_manager=mgr, checkpoint_every=4)
    assert mgr.steps() == [4, 8]
    saved = torch.load(f"{tmp_path}/c/step_8/state.pt", weights_only=True)
    assert "codec_generator/0" in saved and "generator/0" in saved
    tr = Trainer(None, engine=_engine(nccl_mesh), seed=0)
    template = tr.engine.init_state(torch.Generator().manual_seed(0),
                                    ds.x[:1])
    tr.state, extra = elastic_restore(mgr, tr.engine, template)
    mgr.close()
    tr.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
           max_steps=8, data_state=extra["data_state"])
    for name in ("generator", "codec_generator"):
        assert torch.equal(getattr(whole.state, name).get_state(),
                           getattr(tr.state, name).get_state()), name
    for (n, p), q in zip(whole.state.model.named_parameters(),
                         tr.state.model.parameters()):
        assert torch.equal(p, q), n
