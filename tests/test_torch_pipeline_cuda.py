"""Pipeline parallelism on the card.  Marked ``cuda``: skipped without an
NVIDIA GPU (the flash kernels have no CPU mode).  On the card, with no
JAX installed there:

    python -m pytest -m cuda tests/test_torch_pipeline_cuda.py

The card is one GPU and NCCL takes one rank per device, so the pipeline
runs on a (1, 1) (data, pipe) mesh here: one stage, every shift a copy
(the many-stage schedules are held on gloo ranks on the CPU,
``tests/test_torch_pipeline_dist.py``).  Over the GPT stages with flash
attention (2 layers, bf16 compute over f32 parameters, the ``tc``
kernels):

* GPipe, GPipe with remat and 1F1B give bitwise equal losses and
  parameters (one order of operations and of gradient sums,
  engines/pipeline.py), and the first step's loss is the sequential
  forward's cross-entropy over the whole batch within 1e-3 of it (the
  same kernels at other row counts: cuBLAS may round a bf16 activation
  otherwise);
* a step launches layers × M flash forwards, dQ and dK/dV under GPipe and
  twice the forwards under remat and 1F1B (the recompute); the shifts are
  copies, T − 1 each way a step (T = M + S − 1 ticks for GPipe,
  2 (M + S − 1) for 1F1B), and two NCCL all-reduces a step;
* ``generate`` at f32 (the ``tc32`` kernels) equals the naive rollout of
  the sequential forward on the growing prefix.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

LAYERS, MICRO, STEPS = 2, 2, 3
STAGES = dict(vocab_size=512, hidden=128, heads=2, ffn=256, max_len=256,
              layers_per_stage=LAYERS, attention_impl="flash")


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels have no CPU "
                    "mode")
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = meshlib.create_mesh(1, shape=(1, 1), axis_names=("data", "pipe"))
    yield m
    m.close()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _engine(mesh, schedule="gpipe", remat=False, dtype=torch.bfloat16):
    from distributed_tensorflow_tpu_torch.engines import PipelineEngine
    from distributed_tensorflow_tpu_torch.models.gpt import (
        gpt_pipeline_stages)

    return PipelineEngine(
        microbatches=MICRO, mesh=mesh, schedule=schedule, remat=remat,
        stages=gpt_pipeline_stages(**STAGES, dtype=dtype),
        optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))


def _batch():
    tok = np.random.default_rng(0).integers(0, 512, (4, 129))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _counts():
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll

    f = fa.flash_attention
    return {"fwd_tc": f.fwd_tc_launches, "dq_tc": f.dq_tc_launches,
            "dkv_tc": f.dkv_tc_launches,
            "next": coll.shift_to_next.clones,
            "prev": coll.shift_to_prev.clones,
            "p2p": coll.shift_to_next.launches + coll.shift_to_prev.launches,
            "nccl": coll.all_reduce_.nccl_launches}


def _run(mesh, schedule, remat, init):
    from distributed_tensorflow_tpu_torch.engines.base import cross_entropy

    eng = _engine(mesh, schedule, remat)
    state = eng.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(init)
    xs, ys = eng.shard_batch(*_batch())
    with torch.no_grad():
        seq = float(cross_entropy(eng._sequential_logits(
            eng.eval_params(state), xs), ys).mean())
    before = _counts()
    losses = []
    for _ in range(STEPS):
        state, m = eng.step(state, xs, ys)
        losses.append(float(m["loss"]))
    counts = {k: v - before[k] for k, v in _counts().items()}
    return losses, seq, counts, {k: v.clone() for k, v in
                                 state.model.state_dict().items()}


def test_schedules_are_bitwise_equal_with_planned_launches(mesh):
    init = {k: v.clone() for k, v in _engine(mesh).init_state(
        torch.Generator().manual_seed(0)).model.state_dict().items()}
    runs = {name: _run(mesh, *cfg, init) for name, cfg in (
        ("gpipe", ("gpipe", False)), ("remat", ("gpipe", True)),
        ("1f1b", ("1f1b", False)))}
    losses, seq, _, params = runs["gpipe"]
    assert abs(losses[0] - seq) <= 1e-3 * seq, (losses[0], seq)
    for name in ("remat", "1f1b"):
        assert runs[name][0] == losses, (name, runs[name][0], losses)
        for k, v in params.items():
            assert torch.equal(runs[name][3][k], v), (name, k)
    n = LAYERS * MICRO * STEPS
    ticks = {"gpipe": MICRO, "remat": MICRO, "1f1b": 2 * MICRO}
    for name, (_, _, counts, _) in runs.items():
        fwd = n if name == "gpipe" else 2 * n
        shifts = (ticks[name] - 1) * STEPS
        assert counts == {"fwd_tc": fwd, "dq_tc": n, "dkv_tc": n,
                          "next": shifts, "prev": shifts, "p2p": 0,
                          "nccl": 2 * STEPS}, (name, counts)


def test_generate_matches_the_naive_rollout_at_f32(mesh):
    eng = _engine(mesh, dtype=torch.float32)
    state = eng.init_state(torch.Generator().manual_seed(1))
    x, y = _batch()
    state, _ = eng.step(state, *eng.shard_batch(x, y))
    prompt = x[:, :16]
    got = eng.generate(state, prompt, 8)
    model = eng.eval_params(state)
    toks = torch.as_tensor(prompt, device="cuda").long()
    with torch.no_grad():
        for _ in range(8):
            nxt = eng._sequential_logits(model, toks)[:, -1].argmax(-1)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(got, toks.cpu().numpy())
