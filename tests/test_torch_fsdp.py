"""The port's ``FSDPEngine`` against the JAX package, on gloo ranks (CPU).

``fsdp_spec`` is held against JAX's on a parametrised set of shapes, rank
counts and Megatron bases.  One spawn of 4 ranks, run once by a module
fixture, holds the engine; the rank bodies live at module level in this
file, which imports no JAX at the top (a spawned child re-imports the
module of its target), and the JAX references are computed in the parent
on 4 devices of the 8-device CPU mesh while the ranks run.  The ranks
first form a group of 4 (a ('data',) mesh of 4), then ranks 0 and 1 a
group of 2, then rank 0 a group of 1.

Every run trains the MLP (hidden 32, 10 classes, 8 × 8 inputs, dropout
0) from the JAX engine's initial weights: ``fc2.bias`` (10,) has no dim
that splits over 4, so it stays whole and takes the all-reduce path.
Tolerances, each with its reason:

* FSDP with SGD 0.5 for 3 steps against JAX's ``FSDPEngine``: parameters
  within 1e-5 (JAX ``test_fsdp_matches_sync_math``'s bound), the loss
  within 1e-5.  SGD, as it is linear in the gradient: a wrong scale or a
  dropped reduce-scatter shows.
* FSDP against the port's ``SyncEngine`` on the same ranks: 1e-6 (f32
  sums in another order: reduce-scatter against all-reduce).
* ``grad_accum`` 2 against 1: 1e-6 (the same order argument).
* ``state_bytes_per_device`` against JAX's under Adam: the port holds a
  step count per parameter (4 bytes each, torch's Adam), JAX one count,
  so both figures exceed JAX's by exactly 4 × (leaves − 1).
* ``bf16-f32master`` and ``fp16-f32master``, 4 Adam steps of lr 1e-3:
  ``test_torch_precision.py``'s bounds (loss 2e-2 relative; every
  parameter within 2 bf16 roundings plus 2·lr a step, 99% within 2
  roundings plus lr).
* The ``bf16`` codec, one SGD step: each element of the update within
  2⁻⁷ of JAX's (the roundtrip rounds the same reduced gradient to bf16 in
  both; the reduced f32 values differ by summation order, which moves a
  rounding by at most one bf16 step) plus 1e-7.
* The ``int8`` codec, one SGD step, against the port's exact step: each
  element within lr × 1.01 × max|g| / 127 of its leaf (one stochastic
  rounding quantum of the whole leaf's scale, as
  ``tests/test_torch_codec.py`` holds the roundtrip).
* ``--clip-norm`` (the recipe's ``ScheduledAdamW``, eps 1 so that the
  update scales with the clipped gradient, clip 0.05 below the
  gradients' global norm) against ``optax.chain(clip_by_global_norm,
  adam)``: parameters within 1e-6 after 3 steps.
* Checkpoints: one written by FSDP on 4 ranks restores bitwise on 4, on
  2 and on 1 rank, and under ``SyncEngine`` (whole leaves, so the same
  names and shapes as sync's).
* ``cli.main -m d -ds fsdp -n 2`` in the 2-rank group prints a summary
  named ``fsdp`` (JAX's name), and the JAX CLI's rejections are the
  port's word for word.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

WORLD = 4
LR = 0.5
BATCH = 32
MLP_KW = dict(num_classes=10, hidden=32, dropout_rate=0.0)
PRECISION_STEPS, ADAM_LR = 4, 1e-3
CLIP, CLIP_EPS, CLIP_LR = 0.05, 1.0, 0.1
BF16_LOSS = dict(rtol=2e-2, atol=0)
BF16_PARAMS = dict(rtol=2 ** -7, atol=1e-3)
BF16_PARAMS_ALL = dict(rtol=2 ** -7, atol=4 * 2 * 1e-3)
CLI_ARGV = ["-m", "d", "-ds", "fsdp", "-n", "2", "-b", "8", "--model", "mlp",
            "--dataset", "synthetic", "--log-every", "0",
            "--model-arg", "hidden=32"]


def _data(n: int = BATCH * 4, seed: int = 3):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 8, 8, 1), dtype=np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def _batches(steps: int):
    x, y = _data()
    return [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
            for i in range(steps)]


def _sgd(lr=LR):
    return lambda params: torch.optim.SGD(params, lr=lr)


def _whole(eng, state) -> dict:
    return {k: v.float().numpy().copy()
            for k, v in eng.full_state_dict(state).items()}


def _mlp(dtype=torch.float32):
    from distributed_tensorflow_tpu_torch.models.mlp import MLP

    return MLP(**MLP_KW, dtype=dtype, device="cpu")


def _engine(cls, mesh, init, dtype=torch.float32, **kw):
    """``cls`` over the MLP from the whole f32 ``init``: a policy's
    stored parameters and master through ``adopt_f32_state``, this rank's
    slices cut by ``convert.fsdp_shard_state_dict``."""
    from distributed_tensorflow_tpu_torch.models import convert
    from distributed_tensorflow_tpu_torch.parallel import precision as tpl

    eng = cls(_mlp(dtype), mesh=mesh, **kw)
    state = eng.init_state(torch.Generator().manual_seed(0), _data()[0][:1])
    sd = convert.fsdp_shard_state_dict(init, eng.param_specs,
                                       eng.n_devices, eng.rank)
    tpl.adopt_f32_state(state, sd, eng.precision)
    return eng, state


def _grad_max(init, x, y) -> list[float]:
    """Each leaf's max |gradient| of the global batch's mean loss (what
    the roundtrip quantizes, whole)."""
    from distributed_tensorflow_tpu_torch.engines.base import cross_entropy

    m = _mlp()
    m(torch.from_numpy(x[:1]))
    m.load_state_dict(init)
    cross_entropy(m(torch.from_numpy(x)), torch.from_numpy(y)).mean(
    ).backward()
    return [float(p.grad.abs().max()) for p in m.parameters()]


def _clip_opt(params):
    from distributed_tensorflow_tpu_torch.utils import optim

    params = list(params)
    return optim.ScheduledAdamW(params, CLIP_LR, eps=CLIP_EPS,
                                decay_mask=[False] * len(params),
                                clip_norm=CLIP)


def _group_of_four(rank, ports, inits, out_dir, out):
    from distributed_tensorflow_tpu_torch.engines import (
        FSDPEngine, SyncEngine)
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    mesh = meshlib.create_mesh(WORLD, device="cpu")
    init = inits["f32"]
    for label, cls, kw in (("fsdp", FSDPEngine, {}),
                           ("sync", SyncEngine, {}),
                           ("k2", FSDPEngine, dict(grad_accum=2))):
        eng, state = _engine(cls, mesh, init, optimizer=_sgd(), **kw)
        if label == "fsdp":
            out["specs"] = json.dumps(eng.param_specs)
            out["local_shapes"] = json.dumps(
                {k: list(v.shape) for k, v in state.model.state_dict()
                 .items()})
        for s, (x, y) in enumerate(_batches(3), 1):
            state, m = eng.step(state, *eng.shard_batch(x, y))
            out[f"{label}/{s}/loss"] = np.asarray(float(m["loss"]))
            for k, v in _whole(eng, state).items():
                out[f"{label}/{s}/{k}"] = v
    # the memory claim under Adam, after a step (torch's Adam builds its
    # state at the first step)
    eng, state = _engine(FSDPEngine, mesh, init,
                         optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))
    state, _ = eng.step(state, *eng.shard_batch(*_batches(1)[0]))
    out["bytes"] = np.asarray(eng.state_bytes_per_device(state))
    # precision policies, Adam lr 1e-3
    for policy, dtype in (("bf16-f32master", torch.bfloat16),
                          ("fp16-f32master", torch.float16)):
        eng, state = _engine(FSDPEngine, mesh, init, dtype=dtype,
                             precision=policy,
                             optimizer=lambda p: torch.optim.Adam(
                                 p, lr=ADAM_LR))
        for s, (x, y) in enumerate(_batches(PRECISION_STEPS), 1):
            state, m = eng.step(state, *eng.shard_batch(x, y))
            out[f"{policy}/{s}/loss"] = np.asarray(float(m["loss"]))
        for k, v in _whole(eng, state).items():
            out[f"{policy}/{k}"] = v
        out[f"{policy}/dtype"] = np.asarray(
            str(next(state.model.parameters()).dtype))
    # codecs: one SGD step each
    for codec in ("none", "bf16", "int8"):
        eng, state = _engine(FSDPEngine, mesh, init, optimizer=_sgd(),
                             grad_compression=codec)
        state, _ = eng.step(state, *eng.shard_batch(*_batches(1)[0]))
        for k, v in _whole(eng, state).items():
            out[f"codec/{codec}/{k}"] = v
    # the recipe's clip, 3 steps
    eng, state = _engine(FSDPEngine, mesh, init, optimizer=_clip_opt)
    for x, y in _batches(3):
        state, _ = eng.step(state, *eng.shard_batch(x, y))
    for k, v in _whole(eng, state).items():
        out[f"clip/{k}"] = v
    # a checkpoint on 4 ranks, restored on 4
    eng, state = _engine(FSDPEngine, mesh, init,
                         optimizer=lambda p: torch.optim.Adam(p, lr=1e-2))
    for x, y in _batches(2):
        state, _ = eng.step(state, *eng.shard_batch(x, y))
    CheckpointManager(f"{out_dir}/ckpt").save(state)
    _ckpt_views(out, "ckpt/written", eng, state)
    eng2, fresh = _engine(FSDPEngine, mesh, init,
                          optimizer=lambda p: torch.optim.Adam(p, lr=1e-2))
    CheckpointManager(f"{out_dir}/ckpt").restore(fresh)
    _ckpt_views(out, "ckpt/4", eng2, fresh)
    mesh.close()


def _ckpt_views(out, prefix, eng, state) -> None:
    """The state's whole leaves and optimizer entries, as a checkpoint
    holds them."""
    for k, v in eng.checkpoint_state(state).items():
        if isinstance(v, torch.Tensor) and not k.startswith("generator"):
            out[f"{prefix}/{k}"] = v.float().numpy().copy()


def _group_of_two(rank, ports, inits, out_dir, out):
    from distributed_tensorflow_tpu_torch import cli
    from distributed_tensorflow_tpu_torch.engines import FSDPEngine
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    mesh = meshlib.create_mesh(2, device="cpu")
    eng, fresh = _engine(FSDPEngine, mesh, inits["f32"],
                         optimizer=lambda p: torch.optim.Adam(p, lr=1e-2))
    CheckpointManager(f"{out_dir}/ckpt").restore(fresh)
    _ckpt_views(out, "ckpt/2", eng, fresh)
    mesh.close()
    summary = cli.main(CLI_ARGV + ["--device", "cpu"])
    out["cli"] = json.dumps(summary)


def _group_of_one(out_dir, inits, out):
    from distributed_tensorflow_tpu_torch.engines import (
        FSDPEngine, SyncEngine)
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    mesh = meshlib.create_mesh(1, device="cpu")
    for label, cls in (("1", FSDPEngine), ("sync", SyncEngine)):
        eng, fresh = _engine(cls, mesh, inits["f32"],
                             optimizer=lambda p: torch.optim.Adam(p,
                                                                  lr=1e-2))
        CheckpointManager(f"{out_dir}/ckpt").restore(fresh)
        _ckpt_views(out, f"ckpt/{label}", eng, fresh)
    mesh.close()


def _rank(rank: int, ports, inits, out_dir: str) -> None:
    torch.set_num_threads(1)
    out: dict = {}
    meshlib.init_process_group("cpu", WORLD, rank,
                               f"tcp://127.0.0.1:{ports[0]}")
    try:
        _group_of_four(rank, ports, inits, out_dir, out)
    finally:
        dist.destroy_process_group()
    if rank < 2:
        meshlib.init_process_group("cpu", 2, rank,
                                   f"tcp://127.0.0.1:{ports[1]}")
        try:
            _group_of_two(rank, ports, inits, out_dir, out)
        finally:
            dist.destroy_process_group()
    if rank == 0:
        _group_of_one(out_dir, inits, out)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


# ------------------------------------------------------------- the parent


def _jax_engine(cls_name="fsdp", precision="f32", optimizer=None,
                codec="none"):
    """A JAX engine over the MLP on 4 devices of the CPU mesh, its initial
    state, and the state's f32 weights as a port state_dict."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_tensorflow_tpu.engines.fsdp import FSDPEngine
    from distributed_tensorflow_tpu.models import create_model
    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu.parallel import precision as jpl

    pol = jpl.make_policy(precision)
    model = create_model("mlp", **MLP_KW,
                         dtype=pol.compute_dtype if pol.active
                         else jnp.float32)
    eng = FSDPEngine(model, optimizer=optimizer or optax.sgd(LR),
                     mesh=jmesh.create_mesh(WORLD), precision=precision,
                     grad_compression=codec)
    state = eng.init_state(jax.random.key(0), _data()[0][:1])
    return eng, state


def _jax_f32_init(state) -> dict:
    """An f32 JAX state's weights as a port ``state_dict``."""
    import jax

    from distributed_tensorflow_tpu_torch.models import convert

    return convert.mlp_state_dict(jax.tree.map(np.asarray, state.params))


def _jax_run(eng, state, steps) -> tuple[list, dict]:
    import jax

    from distributed_tensorflow_tpu_torch.models import convert

    losses = []
    for x, y in _batches(steps):
        state, m = eng.step(state, *eng.shard_batch(x, y))
        losses.append(float(m["loss"]))
    sd = convert.mlp_state_dict(jax.tree.map(
        lambda a: np.asarray(a, np.float32), state.params))
    return losses, {k: v.numpy() for k, v in sd.items()}, state


@pytest.fixture(scope="module")
def spawn_run(tmp_path_factory):
    import jax
    import optax

    eng, state0 = _jax_engine()
    init = _jax_f32_init(state0)
    inits = {"f32": init}
    out = tmp_path_factory.mktemp("fsdp")
    ranks = mp.spawn(_rank, args=([meshlib.free_port(), meshlib.free_port()],
                                  inits, str(out)), nprocs=WORLD, join=False)
    want = {}
    # SGD, 3 steps, each step's params
    per_step = []
    state = state0
    for s, (x, y) in enumerate(_batches(3), 1):
        state, m = eng.step(state, *eng.shard_batch(x, y))
        sd = _jax_f32_init(state)
        per_step.append((float(m["loss"]),
                         {k: v.numpy() for k, v in sd.items()}))
    want["sgd"] = per_step
    # the bytes under Adam, after a step
    eng, state = _jax_engine(optimizer=optax.adam(1e-3))
    state, _ = eng.step(state, *eng.shard_batch(*_batches(1)[0]))
    want["bytes"] = eng.state_bytes_per_device(state)
    want["leaves"] = len(jax.tree.leaves(state.params))
    for policy in ("bf16-f32master", "fp16-f32master"):
        eng, state = _jax_engine(precision=policy,
                                 optimizer=optax.adam(ADAM_LR))
        losses, sd, _ = _jax_run(eng, state, PRECISION_STEPS)
        want[policy] = (losses, sd)
    eng, state = _jax_engine(codec="bf16")
    want["bf16"] = _jax_run(eng, state, 1)[1]
    eng, state = _jax_engine(optimizer=optax.chain(
        optax.clip_by_global_norm(CLIP), optax.adam(CLIP_LR, eps=CLIP_EPS)))
    want["clip"] = _jax_run(eng, state, 3)[1]
    want["init"] = {k: v.numpy() for k, v in init.items()}
    want["gmax"] = _grad_max(init, *_batches(1)[0])
    want["norm0"] = _global_grad_norm(init, *_batches(1)[0])
    while not ranks.join():
        pass
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return want, got


def _global_grad_norm(init, x, y) -> float:
    from distributed_tensorflow_tpu_torch.engines.base import cross_entropy

    m = _mlp()
    m(torch.from_numpy(x[:1]))
    m.load_state_dict(init)
    cross_entropy(m(torch.from_numpy(x)), torch.from_numpy(y)).mean(
    ).backward()
    return float(torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in m.parameters()])))


# --------------------------------------------------------------- the tests


SPEC_CASES = [((64, 32), 8, None), ((8, 512), 8, None), ((7, 9), 8, None),
              ((), 8, None), ((32, 64), 4, (None, "model")),
              ((32, 64), 4, ("model", None)), ((64, 32), 2, (None, "model")),
              ((30,), 4, ("model",)), ((12, 12), 4, None),
              ((6, 10), 3, ("model", None)), ((4, 8, 16), 4, None),
              ((4, 8, 16), 4, (None, None, "model")), ((5,), 5, None),
              ((0, 4), 4, None)]


@pytest.mark.parametrize("shape,n,base", SPEC_CASES)
def test_fsdp_spec_matches_jax(shape, n, base):
    from jax.sharding import PartitionSpec as P

    from distributed_tensorflow_tpu.engines.fsdp import fsdp_spec as jspec
    from distributed_tensorflow_tpu_torch.engines.fsdp import fsdp_spec

    want = jspec(shape, n, base=None if base is None else P(*base))
    assert fsdp_spec(shape, n, base=base) == tuple(want)


def test_engine_matches_jax_every_step(spawn_run):
    want, got = spawn_run
    for r in range(WORLD):
        for s, (loss, params) in enumerate(want["sgd"], 1):
            np.testing.assert_allclose(got[r][f"fsdp/{s}/loss"], loss,
                                       rtol=0, atol=1e-5)
            for k, w in params.items():
                np.testing.assert_allclose(got[r][f"fsdp/{s}/{k}"], w,
                                           rtol=0, atol=1e-5,
                                           err_msg=f"rank {r} {s} {k}")


def test_engine_matches_sync_and_grad_accum(spawn_run):
    _, got = spawn_run
    for r in range(WORLD):
        for s in (1, 2, 3):
            for k in ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias",
                      "loss"):
                for other in ("sync", "k2"):
                    np.testing.assert_allclose(
                        got[r][f"fsdp/{s}/{k}"], got[r][f"{other}/{s}/{k}"],
                        rtol=0, atol=1e-6, err_msg=f"{other} {r} {s} {k}")


def test_state_is_sliced_and_bytes_match_jax(spawn_run):
    want, got = spawn_run
    specs = json.loads(str(got[0]["specs"]))
    # the leaves with a dim that splits over 4 are cut (on flax's
    # largest dim: fc1's input width), fc2.bias (10,) stays whole
    assert specs == {"fc1.weight": [None, "data"], "fc1.bias": ["data"],
                     "fc2.weight": [None, "data"]}
    shapes = json.loads(str(got[1]["local_shapes"]))
    assert shapes == {"fc1.weight": [32, 16], "fc1.bias": [8],
                      "fc2.weight": [10, 8], "fc2.bias": [10]}
    per, total = (int(v) for v in got[0]["bytes"])
    jper, jtotal = want["bytes"]
    counts = 4 * (want["leaves"] - 1)
    assert (per - jper, total - jtotal) == (counts, counts)
    assert per < total / WORLD * 1.3, (per, total)


@pytest.mark.parametrize("policy", ["bf16-f32master", "fp16-f32master"])
def test_master_policies_match_jax(spawn_run, policy):
    want, got = spawn_run
    losses, params = want[policy]
    for r in range(WORLD):
        assert str(got[r][f"{policy}/dtype"]) == (
            "torch.bfloat16" if policy.startswith("bf16")
            else "torch.float16")
        for s, loss in enumerate(losses, 1):
            np.testing.assert_allclose(got[r][f"{policy}/{s}/loss"], loss,
                                       **BF16_LOSS)
        close = total = 0
        for k, w in params.items():
            g = got[r][f"{policy}/{k}"]
            np.testing.assert_allclose(g, w, err_msg=k, **BF16_PARAMS_ALL)
            close += int(np.isclose(g, w, **BF16_PARAMS).sum())
            total += g.size
        assert close >= 0.99 * total, (close, total)


def test_codecs_match_jax_and_the_exact_step(spawn_run):
    want, got = spawn_run
    init = want["init"]
    names = ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")
    for r in range(WORLD):
        for i, k in enumerate(names):
            exact = got[r][f"codec/none/{k}"]
            bf16 = got[r][f"codec/bf16/{k}"] - init[k]
            jbf16 = want["bf16"][k] - init[k]
            np.testing.assert_array_less(
                np.abs(bf16 - jbf16), 2 ** -7 * np.abs(jbf16) + 1e-7)
            quantum = LR * 1.01 * want["gmax"][i] / 127
            np.testing.assert_array_less(
                np.abs(got[r][f"codec/int8/{k}"] - exact), quantum + 1e-7)


def test_clip_norm_takes_the_global_norm(spawn_run):
    want, got = spawn_run
    assert want["norm0"] > 2 * CLIP     # the clip acts
    for r in range(WORLD):
        for k, w in want["clip"].items():
            np.testing.assert_allclose(got[r][f"clip/{k}"], w, rtol=0,
                                       atol=1e-6, err_msg=f"rank {r} {k}")


def test_checkpoint_restores_on_4_2_1_ranks_and_under_sync(spawn_run):
    _, got = spawn_run
    written = {k[len("ckpt/written/"):]: v for k, v in got[0].items()
               if k.startswith("ckpt/written/")}
    assert written and "opt/fc1.weight/exp_avg" in written
    assert written["model/fc1.weight"].shape == (32, 64)
    for r, label in ((0, "4"), (3, "4"), (0, "2"), (1, "2"), (0, "1"),
                     (0, "sync")):
        restored = {k[len(f"ckpt/{label}/"):]: v for k, v in got[r].items()
                    if k.startswith(f"ckpt/{label}/")}
        assert set(restored) == set(written), (label, r)
        for k, v in written.items():
            assert np.array_equal(restored[k], v), (label, r, k)


def test_cli_fsdp_in_a_group_of_two(spawn_run):
    _, got = spawn_run
    for r in (0, 1):
        summary = json.loads(str(got[r]["cli"]))
        # JAX harness.py:722: the default path names the run after its
        # engine
        assert summary["engine"] == "fsdp", summary
        assert summary["n_devices"] == summary["data_parallel"] == 2
        assert np.isfinite(summary["test_loss"])
        assert summary["run_report"]["param_bytes_per_device"] > 0


def test_rejections_match_jax_word_for_word():
    from distributed_tensorflow_tpu.utils import harness as jharness
    from distributed_tensorflow_tpu_torch.utils import harness

    for kw in (dict(engine="async", tensor_parallel=2),
               dict(engine="gossip", tensor_parallel=2),
               dict(engine="fsdp", seq_parallel=2, model="gpt_tiny",
                    dataset="lm_synth")):
        cfg = dict(dict(model="mlp", dataset="synthetic", n_devices=2), **kw)
        with pytest.raises(ValueError) as ref:
            jharness._setup(jharness.ExperimentConfig(**cfg))
        with pytest.raises(ValueError) as port:
            harness._setup(harness.ExperimentConfig(**cfg, device="cpu"))
        assert str(port.value) == str(ref.value)
    # fsdp × pipeline: the pipeline itself is not ported, so the split's
    # own message is held at the split
    for mod, extra in ((jharness, {}), (harness, {"device": "cpu"})):
        cfg = mod.ExperimentConfig(engine="fsdp", n_devices=2, **extra)
        with pytest.raises(ValueError) as err:
            mod._split_mesh(cfg, 2, "pipeline_parallel", "pipe")
        if mod is jharness:
            ref = str(err.value)
    assert str(err.value) == ref
    assert "fsdp × pipeline is rejected by design" in ref
