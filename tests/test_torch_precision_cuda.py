"""Mixed precision and the graph-replayed drain on the card.  Marked
``cuda``: skipped without an NVIDIA GPU (the kernels and CUDA graphs have
no CPU mode).  On the card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_precision_cuda.py

* The float16 instantiations of the flash kernels against their plain
  versions, on both routes: ``tc`` (``csrc/flash_attention_sm90.cu``,
  ``mma.sync ... .f16``) and ``simt`` (``csrc/flash_attention.cu``).
  Tolerance as for bf16 (``tests/test_torch_flash_attention_cuda.py``):
  each rounding of a term moves an output by at most 2^-9 of it (fp16's
  unit roundoff is 2^-11, so the bf16 bound holds with room), element-wise
  ``2^-8 (|want| + Σ|terms|) + 1e-5`` and a relative Frobenius error under
  1e-2.  The backward also runs with dO scaled by 2^15, the scale an
  fp16 step starts from: N(0, 1) draws times 2^15, saturated at fp16's
  largest value 65504 (the 5% of draws past 2 would be inf, and an inf
  in a row of dO makes the plain version non-finite on that row and on
  every key it sees, which would leave almost nothing to compare).  One
  such case also scales V by 4, so that the plain version's dS passes
  65504 (asserted): the ``tc`` kernels round dS to fp16 and must scale
  such rows first.  The kernels' gradients must be finite wherever the
  plain version's round to a finite fp16 value, save within the bound of
  fp16's overflow threshold 65520, where the kernel's rounding and the
  plain version's may fall on either side of it; and within the same
  bound there.  dQ and dK also allow 2^-20 of ``_cancel_sums``: dS = P (dP - Δ)
  scale cancels to near 0 where dP ≈ Δ (a causal row's first key), and
  the f32 sums of dP and Δ, in other orders on each side, leave noise of a
  few f32 roundings (2^-24) of the magnitudes cancelled; with a scaled dO
  that noise is larger than the bf16-sized bound of the small results.
* ``MasterWeights`` skips a non-finite fp16 step with no host sync
  (``torch.cuda.set_sync_debug_mode("error")`` around the step) and leaves
  master, Adam's moments and count bitwise as they were.
* ``SyncEngine.many_step`` replayed as a CUDA graph equals the eager chunk
  bitwise (losses and final parameters, dropout on), on a 1-rank NCCL mesh
  with one all-reduce counted per replayed step, under f32 and under the
  master policies.  A second fit on the same engine (a new state) trains
  that state, through graphs of its own, as a fresh engine does; a graph
  refuses a state it was not captured for.
* Only the engine that captures its chunk builds the default Adam
  ``capturable``; async and gossip keep the plain one.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.engines import (
    AsyncLocalEngine, Engine, GossipEngine, SyncEngine, Trainer)
from distributed_tensorflow_tpu_torch.data import loaders
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel import precision as tpl

pytestmark = pytest.mark.cuda

RTOL, ATOL, FROBENIUS = 2.0 ** -8, 1e-5, 1e-2
CANCEL = 2.0 ** -20
F16_MAX, F16_OVERFLOW = 65504.0, 65520.0   # |x| >= 65520 rounds to inf
LOSS_SCALE = 2.0 ** 15                     # PrecisionPolicy.init_scale
F32 = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels and CUDA "
                    "graphs have no CPU mode")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield "cuda"
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _inputs(seed, b, lq, lk, h, d, masked, do_scale=1.0, v_scale=1.0):
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        a = np.clip(rng.standard_normal(shape) * scale, -F16_MAX, F16_MAX)
        return torch.from_numpy(a.astype(np.float32)).to("cuda",
                                                         torch.float16)

    q, k = t((b, lq, h, d)), t((b, lk, h, d))
    v = t((b, lk, h, d), v_scale)
    do = t((b, lq, h, d), do_scale)
    mask = None
    if masked:
        m = (rng.uniform(size=(b, lk)) > 0.3).astype(np.float32)
        m[:, 0] = 1.0
        mask = torch.from_numpy(m).to("cuda")
    return q, k, v, do, mask


def _close(got, want, terms, name, cancel=None):
    """``got`` (fp16) against the plain version's f32 ``want``, where
    ``want`` rounds to a finite fp16 value."""
    got, want = got.detach().float(), want.float()
    bound = RTOL * (want.abs() + terms) + ATOL
    if cancel is not None:
        bound = bound + CANCEL * cancel
    ok = torch.isfinite(want.half())
    lost = ok & ~torch.isfinite(got)
    assert bool((want.abs() + bound)[lost].ge(F16_OVERFLOW).all()), (
        name, "non-finite where the plain version is finite in fp16")
    ok &= ~lost
    got, want, bound = got[ok], want[ok], bound[ok]
    err = (got - want).abs()
    worst = float((err / bound).max())
    assert worst <= 1.0, (name, worst, float(err.max()))
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert rel < FROBENIUS, (name, rel)


def _counts():
    f = tfa.flash_attention
    return {n: getattr(f, f"{n}_launches") for n in (
        "fwd", "dq", "dkv", "fwd_tc", "dq_tc", "dkv_tc", "fwd_f16",
        "dq_f16", "dkv_f16")}


def _ds_max(q, k, v, mask, do, lse, delta, scale, causal) -> float:
    """The plain version's largest |dS| = P |dP - Δ| scale."""
    p = torch.exp(tfa._scores(q, k, mask, scale, causal) - lse[..., None])
    dp = torch.einsum("blhd,bmhd->bhlm", do.float(), v.float())
    return float((p * (dp - delta[..., None]) * scale).abs().max())


LS = LOSS_SCALE


@pytest.mark.parametrize("route", ["tc", "simt"])
@pytest.mark.parametrize(
    "b, lq, lk, h, d, causal, masked, do_scale, v_scale", [
        (8, 1024, 1024, 8, 64, True, False, 1.0, 1.0),  # the training shape
        (8, 1024, 1024, 8, 64, True, False, LS, 1.0),   # dO x 2^15
        (8, 1024, 1024, 8, 64, True, False, LS, 4.0),   # dS past 65504
        (2, 1000, 1000, 2, 64, True, False, 1.0, 1.0),  # ragged, causal
        (2, 96, 160, 2, 64, False, True, LS, 1.0),      # cross lengths, mask
        (1, 384, 384, 2, 128, True, False, 1.0, 1.0),   # head_dim 128
        (2, 200, 200, 2, 16, True, True, 1.0, 1.0),     # head_dim 16
    ])
def test_float16_kernels_match_plain_versions(cuda_device, route, b, lq, lk,
                                              h, d, causal, masked,
                                              do_scale, v_scale):
    q, k, v, do, mask = _inputs(7, b, lq, lk, h, d, masked, do_scale,
                                v_scale)
    scale = d ** -0.5
    assert tfa._route(torch.float16, d) == "tc"
    before = _counts()
    out, lse = tfa._fwd_cuda(q, k, v, mask, scale, causal, route=route)
    ref_out, ref_lse = tfa._fwd_reference(q, k, v, mask, scale, causal)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    dk, dv = tfa._dkv_cuda(q, k, v, mask, do, ref_lse, delta, scale, causal,
                           route=route)
    dq = tfa._dq_cuda(q, k, v, mask, do, ref_lse, delta, scale, causal,
                      route=route)
    torch.cuda.synchronize()
    tc = int(route == "tc")
    moved = {n: c - before[n] for n, c in _counts().items()}
    assert moved == {"fwd": 1, "dq": 1, "dkv": 1, "fwd_tc": tc,
                     "dq_tc": tc, "dkv_tc": tc, "fwd_f16": 1, "dq_f16": 1,
                     "dkv_f16": 1}
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.float16
    terms = tfa._term_sums(q, k, v, mask, do, ref_lse, delta, scale, causal)
    _close(out, ref_out, terms[0], "out")
    torch.testing.assert_close(lse, ref_lse, **F32)
    if v_scale > 1.0:
        # the case holds what it is for: dS that fp16 cannot hold
        assert _ds_max(q, k, v, mask, do, ref_lse, delta, scale,
                       causal) > F16_OVERFLOW
    want_dq, want_dk, want_dv = tfa._bwd_reference(
        q, k, v, mask, do, ref_lse, delta, scale, causal)
    cancel = tfa._cancel_sums(q, k, v, mask, do, ref_lse, delta, scale,
                              causal)
    _close(dk, want_dk, terms[1], "dk", cancel[0])
    _close(dv, want_dv, terms[2], "dv")
    _close(dq, want_dq, terms[3], "dq", cancel[1])


def test_float16_autograd_runs_the_tc_kernels(cuda_device):
    q, k, v, do, _ = _inputs(8, 2, 256, 256, 2, 64, False)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = _counts()
    tfa.flash_attention(*leaves, causal=True).backward(do)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in _counts().items()}
    assert all(v == 1 for v in moved.values()), moved
    assert all(x.grad.dtype == torch.float16 for x in leaves)


# ------------------------------------------------- the skip without a sync

def test_fp16_skip_has_no_host_sync_and_keeps_the_state(cuda_device):
    params = [torch.nn.Parameter(torch.randn(1000, device="cuda").half()),
              torch.nn.Parameter(torch.randn(10, 20, device="cuda").half())]
    opt = tpl.make_policy("fp16-f32master").wrap_optimizer(
        lambda p: torch.optim.Adam(p, lr=1e-3, capturable=True))(params)
    for p in params:
        p.grad = torch.randn_like(p)
    opt.step()                       # Adam's state is born here
    master = opt.master.clone()
    inner = {k: v.clone() for k, v in opt.inner.state[opt.master].items()}
    flat = opt.flat.clone()
    for p in params:
        p.grad = torch.randn_like(p)
    params[1].grad[3, 4] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(opt.master, master) and torch.equal(opt.flat, flat)
    for key, v in opt.inner.state[opt.master].items():
        assert torch.equal(v, inner[key]), key
    assert bool(opt.last_skipped) and int(opt.skipped) == 1
    assert float(opt.loss_scale) == 2.0 ** 14


# ------------------------------------------------------ the graph drain

def _chunks(eng, graph, chunks=3, k=4):
    ds = loaders.load_dataset("mnist")
    state = eng.init_state(torch.Generator().manual_seed(0), ds.x[:1])
    losses = []
    for c in range(chunks):
        xs, ys = zip(*(eng.shard_batch(ds.x[32 * i:32 * i + 32],
                                       ds.y[32 * i:32 * i + 32])
                       for i in range(c * k, (c + 1) * k)))
        drain = eng.many_step if graph else functools.partial(
            Engine.many_step, eng)
        state, m = drain(state, list(xs), list(ys))
        losses.append(m["loss"].cpu())
    return torch.cat(losses), [p.detach().cpu()
                               for p in state.model.parameters()]


@pytest.mark.parametrize("policy", ["f32", "bf16-f32master",
                                    "fp16-f32master"])
def test_graph_replayed_chunk_equals_eager_chunk(cuda_device, policy):
    """Chunk 1 eager, chunk 2 captured and replayed, chunk 3 replayed,
    against three eager chunks (``Engine.many_step``, the loop the graph
    captures): same losses and parameters, bit for bit, with the MLP's
    dropout on."""
    dtype = {"f32": "float32", "bf16-f32master": "bfloat16",
             "fp16-f32master": "float16"}[policy]
    runs = {}
    for graph in (False, True):
        mesh = meshlib.create_mesh(1)
        try:
            eng = SyncEngine(create_model("mlp", dropout_rate=0.2,
                                          dtype=dtype), mesh=mesh,
                             precision=policy)
            before = coll.all_reduce_.nccl_launches
            runs[graph] = _chunks(eng, graph)
            reduces = coll.all_reduce_.nccl_launches - before
            assert bool(eng._graphs) == graph
        finally:
            mesh.close()
        # one gradient all-reduce per step; 16-bit gradients add one of
        # the f32 metrics
        assert reduces == 12 * (1 if policy == "f32" else 2), reduces
    (l0, p0), (l1, p1) = runs[False], runs[True]
    assert torch.equal(l0, l1), (l0, l1)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


def test_trainer_drain_through_the_graph_equals_k1(cuda_device):
    ds = loaders.load_dataset("mnist")
    ds = loaders.Dataset(x=ds.x[:32 * 24], y=ds.y[:32 * 24], num_classes=10,
                         name="mnist")
    runs = {}
    for k in (1, 8):
        lines = []
        trainer = Trainer(create_model("mlp", dropout_rate=0.2), seed=0)
        r = trainer.fit(ds, batch_size=32, log_every=1, log_fn=lines.append,
                        steps_per_call=k)
        assert r["steps"] == 24
        runs[k] = lines
        if k == 8:
            assert len(trainer.engine._graphs) == 1
    assert runs[1] == runs[8]


def test_second_fit_on_one_engine_trains_its_own_state(cuda_device):
    """Two Trainers on one engine, as the harness runs them: the second
    state (another seed) is captured anew and trains as it does on a
    fresh engine; the first state's graph refuses the second state."""
    ds = loaders.load_dataset("mnist")
    ds = loaders.Dataset(x=ds.x[:32 * 24], y=ds.y[:32 * 24], num_classes=10,
                         name="mnist")

    def fit(eng, seed):
        lines = []
        t = Trainer(None, engine=eng, seed=seed)
        r = t.fit(ds, batch_size=32, log_every=1, log_fn=lines.append,
                  steps_per_call=8)
        assert r["steps"] == 24
        return t.state, lines, [p.detach().clone()
                                for p in t.state.model.parameters()]

    def engine():
        return SyncEngine(create_model("mlp", dropout_rate=0.2),
                          precision="bf16-f32master")

    shared = engine()
    first, _, _ = fit(shared, 0)
    (old_graph,) = shared._graphs.values()
    second, lines, params = fit(shared, 1)
    (new_graph,) = shared._graphs.values()
    assert new_graph is not old_graph and new_graph.state is second
    _, want_lines, want_params = fit(engine(), 1)
    assert lines == want_lines
    for a, b in zip(params, want_params):
        assert torch.equal(a, b)
    xs = list(old_graph.xs)
    with pytest.raises(ValueError, match="another TrainState"):
        old_graph.replay(second, xs, list(old_graph.ys))


def test_only_the_capturing_engine_builds_capturable_adam(cuda_device):
    for cls, want in ((SyncEngine, True), (AsyncLocalEngine, False),
                      (GossipEngine, False)):
        eng = cls(create_model("mlp"), device="cuda")
        assert eng.captures_chunks is want
        opt = eng.make_optimizer([torch.nn.Parameter(
            torch.zeros(3, device="cuda"))])
        assert opt.param_groups[0]["capturable"] is want, cls.__name__
