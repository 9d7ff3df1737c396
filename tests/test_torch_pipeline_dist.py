"""The port's ``PipelineEngine`` on gloo ranks (CPU) against the JAX
package's on a CPU mesh of the same shape.

One spawn of 4 ranks, run once by a module fixture.  The rank bodies live
at module level in this file, which imports no JAX at the top (a spawned
child re-imports the module of its target); the JAX references are
computed in the parent on the 8-device CPU mesh while the ranks run.  The
ranks first form a group of 4 ((data, pipe) meshes of (1, 4), (2, 2) and
(4, 1)), then ranks 0 and 1 a group of 2 (a (1, 2) mesh, and the CLI's
``-pp 2 -n 2``).  Every engine starts from the JAX engine's initial
weights (``convert.pipeline_state_dicts``, stacked by
``convert.stacked_state_dict`` and cut by ``load_full_state_dict``), and
trains 3 steps on one batch.  Tolerances, each with its reason:

* loss and accuracy within 1e-5, every parameter (the stacked whole
  leaves, on every rank) within atol 2e-5, rtol 1e-4: JAX
  ``test_gradients_match_sequential_model``'s bound, f32 sums in other
  orders (XLA's against torch's, JAX's GPipe adding the microbatches'
  gradients in reverse);
* the MLP stages, SGD 0.1: on (1, 4) with M = 2 (M < S) the port's GPipe
  against JAX's GPipe and its 1F1B against JAX's 1F1B; on (2, 2) with
  M = 4 all three against JAX's GPipe with remat; on (4, 1) with M = 2
  against JAX's GPipe.  On every mesh the port's GPipe, GPipe with remat
  and 1F1B are bitwise equal (one order of operations and of gradient
  sums, engines/pipeline.py);
* the GPT stages on (2, 2), M = 2, dense and flash (the plain version on
  the CPU), against JAX's with the same attention; the BERT stages on
  (1, 2) against JAX's;
* ``--weight-decay`` (``ScheduledAdamW``, eps 1 so that the update
  scales with the gradient, the mask from ``harness._decay_mask``) on
  (2, 2) against JAX's engine under ``optax.adamw(mask=
  jharness._decay_mask)``, which JAX applies to its stacked tree: the
  parameter bound above.  With ``--clip-norm`` too, against the same
  optax chain (``clip_by_global_norm`` first) applied by hand to the
  stacked tree with ``jax.grad`` of JAX's ``_sequential_logits`` loss:
  JAX's own engine cannot run that chain (its shard_map refuses the
  head's optimizer state, which the pipe-varying norm makes vary over
  'pipe'; ROADMAP Queue 3), so the math it stands for is the oracle;
* a checkpoint written on (2, 2) (Adam, 2 steps) restores on (2, 2) and
  the next step is bitwise the uninterrupted one; each block leaf is
  stacked (2, ...); on (4, 1) the restore raises;
* ``cli.main -pp 2 -n 4 --microbatches 2 --model mlp --dataset synthetic``
  prints a summary named ``pipeline_parallel``; with ``--checkpoint-dir``
  and then ``--resume`` the step numbering continues (JAX
  ``test_pipeline_checkpoint_resume_through_harness``); ``--model gpt -pp
  2 -n 2 --sample 8`` prints ``samples``;
* the rejections a run meets after its mesh is made (``--model-arg``
  under the MLP stages, an unknown stage key, a batch that does not
  divide by ``--microbatches``, ``--serve``): JAX's words.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

WORLD = 4
LR = 0.1
TOL = dict(atol=2e-5, rtol=1e-4)
SCHEDULES = {"gpipe": ("gpipe", False), "1f1b": ("1f1b", False),
             "remat": ("gpipe", True)}
MESHES = {"14": ((1, 4), 2), "22": ((2, 2), 4), "41": ((4, 1), 2)}
# the JAX run each port schedule on each MLP mesh is held to
MLP_REF = {("14", "gpipe"): "mlp14_gpipe", ("14", "1f1b"): "mlp14_1f1b",
           ("14", "remat"): "mlp14_gpipe", ("22", "gpipe"): "mlp22_remat",
           ("22", "1f1b"): "mlp22_remat", ("22", "remat"): "mlp22_remat",
           ("41", "gpipe"): "mlp41_gpipe", ("41", "1f1b"): "mlp41_gpipe",
           ("41", "remat"): "mlp41_gpipe"}
GPT = dict(vocab_size=64, hidden=32, heads=4, ffn=64, max_len=16)
BERT = dict(num_classes=2, vocab_size=64, hidden=32, heads=2, ffn=64,
            max_len=16)
CLIP, CLIP_EPS, CLIP_LR, WD = 0.05, 1.0, 0.1, 0.5
CLI_MLP = ["-pp", "2", "-n", "4", "--microbatches", "2", "--model", "mlp",
           "--dataset", "synthetic", "--log-every", "0", "--device", "cpu"]
CLI_GPT = ["--model", "gpt", "--dataset", "lm_synth", "-pp", "2", "-n", "2",
           "--sample", "8", "--microbatches", "2", "--pipeline-hidden", "32",
           "-b", "4", "--log-every", "0", "--device", "cpu"]
# the rejections a -pp 2 run meets after its mesh is made
REJECT = {
    "mlp_model_arg": dict(model="mlp", dataset="synthetic",
                          model_args={"hidden": 64}),
    "stage_key": dict(model="gpt", dataset="lm_synth",
                      model_args={"hidden": 64}),
    "microbatches": dict(model="mlp", dataset="synthetic", batch_size=3),
    "serve": dict(model="gpt", dataset="lm_synth", serve_requests=4),
}


def _images(n=16):
    rng = np.random.default_rng(5)
    return (rng.random((n, 4, 4, 1), dtype=np.float32),
            (np.arange(n) % 10).astype(np.int32))


def _tokens():
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 64, (8, 16)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _bert_tokens():
    ids, _ = _tokens()
    ids[:, 13:] = 0
    return ids, (np.arange(8) % 2).astype(np.int32)


def _small_lm(batch_size, type="train", **kw):
    from distributed_tensorflow_tpu_torch.data import loaders

    return loaders.load_lm_dataset(seq_len=16, vocab_size=64, n_train=32,
                                   n_test=16, split=type)


def _sgd(params):
    return torch.optim.SGD(params, lr=LR)


def _engine(mesh, family="mlp", schedule="gpipe", remat=False, m=2,
            optimizer=_sgd, **kw):
    from distributed_tensorflow_tpu_torch.engines import PipelineEngine
    from distributed_tensorflow_tpu_torch.models.bert import (
        bert_pipeline_stages)
    from distributed_tensorflow_tpu_torch.models.gpt import (
        gpt_pipeline_stages)

    stages = None
    if family == "gpt":
        stages = gpt_pipeline_stages(**GPT, device="cpu", **kw)
    elif family == "bert":
        stages = bert_pipeline_stages(**BERT, device="cpu")
    return PipelineEngine(num_classes=10, hidden=16, microbatches=m,
                          mesh=mesh, schedule=schedule, remat=remat,
                          stages=stages, optimizer=optimizer)


def _train(out, prefix, eng, init, batch, steps=3):
    state = eng.init_state(torch.Generator().manual_seed(0), batch[0])
    eng.load_full_state_dict(state, init)
    xs, ys = eng.shard_batch(*batch)
    for s in range(1, steps + 1):
        state, m = eng.step(state, xs, ys)
        out[f"{prefix}/{s}/loss"] = np.asarray(float(m["loss"]))
        out[f"{prefix}/{s}/accuracy"] = np.asarray(float(m["accuracy"]))
        for k, v in eng.full_state_dict(state).items():
            out[f"{prefix}/{s}/{k}"] = v.numpy().copy()
    return state


def _clip_optimizer(eng, clip):
    from distributed_tensorflow_tpu_torch.utils import harness, optim

    def make(params):
        keep = harness._decay_mask(eng.model)
        return optim.ScheduledAdamW(
            params, CLIP_LR, eps=CLIP_EPS, weight_decay=WD, clip_norm=clip,
            decay_mask=[keep[n] for n, _ in eng.model.named_parameters()])
    return make


def _checkpoint(out, out_dir, mesh, init):
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    x, y = _images()
    eng = _engine(mesh, m=4, optimizer=adam)
    state = _train({}, "ckpt", eng, init, (x, y), steps=2)
    CheckpointManager(f"{out_dir}/ckpt").save(state)
    for k, v in eng.checkpoint_state(state).items():
        if isinstance(v, torch.Tensor):
            out[f"ckpt/written/{k}"] = v.numpy().copy()
    fresh = _engine(mesh, m=4, optimizer=adam)
    restored = fresh.init_state(torch.Generator().manual_seed(9), x)
    CheckpointManager(f"{out_dir}/ckpt").restore(restored)
    xs, ys = eng.shard_batch(x, y)
    for tag, e, st in (("uninterrupted", eng, state),
                       ("restored", fresh, restored)):
        st, m = e.step(st, xs, ys)
        out[f"ckpt/{tag}/loss"] = np.asarray(float(m["loss"]))
        for k, v in e.full_state_dict(st).items():
            out[f"ckpt/{tag}/{k}"] = v.numpy().copy()


def _group_of_four(rank, inits, out_dir, out):
    from distributed_tensorflow_tpu_torch import cli
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    x, y = _images()
    for tag, (shape, m) in MESHES.items():
        mesh = meshlib.create_mesh(WORLD, device="cpu", shape=shape,
                                   axis_names=("data", "pipe"))
        init = inits[MLP_REF[(tag, "gpipe")]]
        for name, (schedule, remat) in SCHEDULES.items():
            _train(out, f"mlp{tag}/{name}", _engine(mesh, "mlp", schedule,
                                                    remat, m), init, (x, y))
        if tag == "22":
            for impl in ("dense", "flash"):
                _train(out, f"gpt22/{impl}",
                       _engine(mesh, "gpt", attention_impl=impl),
                       inits[f"gpt22_{impl}"], _tokens())
            for name, clip in (("decay22", 0.0), ("clip22", CLIP)):
                eng = _engine(mesh, m=4, optimizer=None)
                eng.make_optimizer = _clip_optimizer(eng, clip)
                _train(out, name, eng, inits[name], (x, y))
            _checkpoint(out, out_dir, mesh, init)
        if tag == "41":
            template = _engine(mesh, m=4).init_state(
                torch.Generator().manual_seed(0), x)
            try:
                CheckpointManager(f"{out_dir}/ckpt").restore(template)
                out["ckpt/other_pipe"] = "restored"
            except ValueError as e:
                out["ckpt/other_pipe"] = str(e)
        mesh.close()
    ckdir = f"{out_dir}/cli_ckpt"
    first = cli.main(CLI_MLP + ["--checkpoint-dir", ckdir])
    second = cli.main(CLI_MLP + ["--checkpoint-dir", ckdir, "--resume"])
    out["cli/mlp"] = json.dumps(first)
    out["cli/resumed"] = json.dumps(second)
    out["cli/latest_step"] = np.asarray(
        CheckpointManager(ckdir).latest_step())
    dist.barrier()


def _group_of_two(inits, out):
    from distributed_tensorflow_tpu_torch import cli
    from distributed_tensorflow_tpu_torch.utils import harness

    mesh = meshlib.create_mesh(2, device="cpu", shape=(1, 2),
                               axis_names=("data", "pipe"))
    _train(out, "bert12", _engine(mesh, "bert"), inits["bert12"],
           _bert_tokens())
    mesh.close()
    out["cli/gpt"] = json.dumps(cli.main(CLI_GPT, dataset_fn=_small_lm))
    for name, cfg in REJECT.items():
        config = harness.ExperimentConfig(
            **cfg, pipeline_parallel=2, microbatches=2, log_every=0,
            dataset_fn=_small_lm if cfg["model"] == "gpt" else None,
            device="cpu")
        try:
            harness.run(config)
            out[f"reject/{name}"] = "ran"
        except ValueError as e:
            out[f"reject/{name}"] = str(e)
    # a mesh of (1, 2) makes sub-groups of one rank each, which no peer
    # joins: without a meeting here rank 0 could tear the store down
    # while rank 1 still makes its own
    dist.barrier()


def _rank(rank: int, ports, inits, out_dir: str) -> None:
    torch.set_num_threads(1)
    out: dict = {}
    meshlib.init_process_group("cpu", WORLD, rank,
                               f"tcp://127.0.0.1:{ports[0]}")
    try:
        _group_of_four(rank, inits, out_dir, out)
    finally:
        dist.destroy_process_group()
    if rank < 2:
        meshlib.init_process_group("cpu", 2, rank,
                                   f"tcp://127.0.0.1:{ports[1]}")
        try:
            _group_of_two(inits, out)
        finally:
            dist.destroy_process_group()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


# ------------------------------------------------------------- the parent


class _JaxRun:
    """A JAX ``PipelineEngine``: its initial weights in the port's stacked
    layout (``init``) and its loss, accuracy and weights after each
    step."""

    def __init__(self, eng, batch):
        import jax

        self.eng, self.batch = eng, batch
        self.state = eng.init_state(jax.random.key(0), batch[0])
        self.init = self._stacked(self.state.params)
        self.steps = []

    @staticmethod
    def _stacked(params):
        import jax

        from distributed_tensorflow_tpu_torch.models import convert

        tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            jax.device_get(params))
        return convert.stacked_state_dict(
            *convert.pipeline_state_dicts(tree))

    def run(self, steps=3):
        state = self.state
        xs, ys = self.eng.shard_batch(*self.batch)
        for _ in range(steps):
            state, m = self.eng.step(state, xs, ys)
            self.steps.append(
                (float(m["loss"]), float(m["accuracy"]),
                 {k: v.numpy() for k, v in self._stacked(
                     state.params).items()}))
        return self


class _JaxOracle(_JaxRun):
    """JAX's math without its engine: ``jax.grad`` of the global batch's
    mean loss over ``_sequential_logits`` and ``tx`` applied to the
    stacked tree."""

    def __init__(self, eng, batch, tx):
        super().__init__(eng, batch)
        self.tx = tx

    def run(self, steps=3):
        import jax
        import jax.numpy as jnp
        import optax

        from distributed_tensorflow_tpu.engines.base import cross_entropy

        x, y = (jnp.asarray(a) for a in self.batch)
        params = jax.device_get(self.state.params)
        opt = self.tx.init(params)

        def loss_fn(p):
            logits = self.eng._sequential_logits(p, x)
            return cross_entropy(logits, y).mean(), logits

        for _ in range(steps):
            (loss, logits), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt = self.tx.update(grads, opt, params)
            params = optax.apply_updates(params, updates)
            acc = float((logits.argmax(-1) == y).mean())
            self.steps.append((float(loss), acc, {
                k: v.numpy() for k, v in self._stacked(params).items()}))
        return self


def _jax_runs():
    import optax

    from distributed_tensorflow_tpu.engines.pipeline import PipelineEngine
    from distributed_tensorflow_tpu.models.bert import bert_pipeline_stages
    from distributed_tensorflow_tpu.models.gpt import gpt_pipeline_stages
    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu.utils import harness as jharness

    def mesh(dp, pp):
        return jmesh.create_mesh(dp * pp, shape=(dp, pp),
                                 axis_names=("data", "pipe"))

    def eng(shape, m, opt=None, **kw):
        return PipelineEngine(num_classes=10, hidden=16, microbatches=m,
                              mesh=mesh(*shape),
                              optimizer=opt or optax.sgd(LR), **kw)

    def adamw():
        return optax.adamw(CLIP_LR, eps=CLIP_EPS, weight_decay=WD,
                           mask=jharness._decay_mask)

    img, tok = _images(), _tokens()
    return {
        "mlp14_gpipe": _JaxRun(eng((1, 4), 2), img),
        "mlp14_1f1b": _JaxRun(eng((1, 4), 2, schedule="1f1b"), img),
        "mlp22_remat": _JaxRun(eng((2, 2), 4, remat=True), img),
        "mlp41_gpipe": _JaxRun(eng((4, 1), 2), img),
        "gpt22_dense": _JaxRun(eng((2, 2), 2, stages=gpt_pipeline_stages(
            **GPT)), tok),
        "gpt22_flash": _JaxRun(eng((2, 2), 2, stages=gpt_pipeline_stages(
            **GPT, attention_impl="flash")), tok),
        "bert12": _JaxRun(eng((1, 2), 2, stages=bert_pipeline_stages(
            **BERT)), _bert_tokens()),
        "decay22": _JaxRun(eng((2, 2), 4, opt=adamw()), img),
        "clip22": _JaxOracle(eng((2, 2), 4), img, optax.chain(
            optax.clip_by_global_norm(CLIP), adamw())),
    }


def _jax_rejections() -> dict:
    from distributed_tensorflow_tpu.data.loaders import load_lm_dataset
    from distributed_tensorflow_tpu.utils import harness as jharness

    def small(batch_size, type="train", **kw):
        return load_lm_dataset(seq_len=16, vocab_size=64, n_train=32,
                               n_test=16, split=type)

    out = {}
    for name, cfg in REJECT.items():
        config = jharness.ExperimentConfig(
            **cfg, n_devices=2, pipeline_parallel=2, microbatches=2,
            log_every=0, dataset_fn=small if cfg["model"] == "gpt" else None)
        with pytest.raises(ValueError) as err:
            jharness.run(config)
        out[name] = str(err.value)
    return out


@pytest.fixture(scope="module")
def spawn_run(tmp_path_factory):
    runs = _jax_runs()
    inits = {name: run.init for name, run in runs.items()}
    out = tmp_path_factory.mktemp("pp")
    ranks = mp.spawn(_rank, args=([meshlib.free_port(), meshlib.free_port()],
                                  inits, str(out)), nprocs=WORLD, join=False)
    try:
        for run in runs.values():
            run.run()
        rejections = _jax_rejections()
    finally:
        while not ranks.join():
            pass
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return runs, rejections, got


def _held(got, prefix, run, ranks, **tol):
    tol = tol or TOL
    for r in ranks:
        for s, (loss, acc, params) in enumerate(run.steps, 1):
            for name, want in (("loss", loss), ("accuracy", acc)):
                np.testing.assert_allclose(
                    got[r][f"{prefix}/{s}/{name}"], want, rtol=0, atol=1e-5,
                    err_msg=f"rank {r} step {s} {name}")
            for k, w in params.items():
                np.testing.assert_allclose(
                    got[r][f"{prefix}/{s}/{k}"], w,
                    err_msg=f"rank {r} step {s} {k}", **tol)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_mlp_stages_match_jax(spawn_run, tag, schedule):
    runs, _, got = spawn_run
    _held(got, f"mlp{tag}/{schedule}", runs[MLP_REF[(tag, schedule)]],
          range(WORLD))


@pytest.mark.parametrize("tag", list(MESHES))
def test_schedules_and_remat_are_bitwise_equal(spawn_run, tag):
    _, _, got = spawn_run
    for r in range(WORLD):
        keys = [k for k in got[r] if k.startswith(f"mlp{tag}/gpipe/")]
        assert keys
        for other in ("1f1b", "remat"):
            for k in keys:
                assert np.array_equal(
                    got[r][k], got[r][k.replace("/gpipe/", f"/{other}/")]), (
                    r, other, k)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_gpt_stages_match_jax_on_2x2(spawn_run, impl):
    runs, _, got = spawn_run
    _held(got, f"gpt22/{impl}", runs[f"gpt22_{impl}"], range(WORLD))


def test_bert_stages_match_jax_on_1x2(spawn_run):
    runs, _, got = spawn_run
    _held(got, "bert12", runs["bert12"], range(2))


@pytest.mark.parametrize("name", ["decay22", "clip22"])
def test_decay_and_clip_use_the_stacked_tree(spawn_run, name):
    runs, _, got = spawn_run
    _held(got, name, runs[name], range(WORLD))


def test_checkpoint_roundtrip_is_bitwise(spawn_run):
    _, _, got = spawn_run
    written = {k[len("ckpt/written/"):]: v for k, v in got[0].items()
               if k.startswith("ckpt/written/")}
    assert written["model/block.fc1.weight"].shape == (2, 32, 16)
    assert written["opt/block.fc1.weight/exp_avg"].shape == (2, 32, 16)
    assert written["model/head.fc.weight"].shape == (10, 16)
    for r in range(WORLD):
        keys = [k for k in got[r] if k.startswith("ckpt/uninterrupted/")]
        assert len(keys) > 1
        for k in keys:
            assert np.array_equal(
                got[r][k], got[r][k.replace("uninterrupted", "restored")]), k
    assert "stacked over 2 slices" in str(got[0]["ckpt/other_pipe"])


def test_cli_runs_the_pipeline_and_resumes(spawn_run):
    _, _, got = spawn_run
    for r in range(WORLD):
        first = json.loads(str(got[r]["cli/mlp"]))
        assert first["engine"] == "pipeline_parallel"
        assert (first["n_devices"], first["data_parallel"],
                first["pipeline_parallel"], first["microbatches"]) == (
                    4, 2, 2, 2)
        assert np.isfinite(first["test_loss"])
        second = json.loads(str(got[r]["cli/resumed"]))
        assert np.isfinite(second["test_loss"])
    assert int(got[0]["cli/latest_step"]) == 2 * first["steps"]


def test_cli_samples_gpt_stages(spawn_run):
    _, _, got = spawn_run
    for r in range(2):
        summary = json.loads(str(got[r]["cli/gpt"]))
        assert summary["engine"] == "pipeline_parallel"
        samples = np.asarray(summary["samples"])
        assert samples.shape == (1, 8)
        assert samples.min() >= 0 and samples.max() < 64
        assert np.asarray(summary["sample_prompts"]).shape == (1, 8)


@pytest.mark.parametrize("name", list(REJECT))
def test_rejections_after_the_mesh_are_jax_word_for_word(spawn_run, name):
    _, rejections, got = spawn_run
    for r in range(2):
        assert str(got[r][f"reject/{name}"]) == rejections[name]
