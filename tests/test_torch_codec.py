"""The port's gradient codecs and bucketed overlap against the JAX package,
in one process (CPU).

* ``make_codec``/``make_overlap_codec``: names, bucketing and the errors.
* ``roundtrip`` under ``none`` and ``bf16`` bitwise JAX's (both cast to
  bfloat16 rounding to nearest even); ``int8`` without a generator
  (round to nearest even) bitwise JAX's ``roundtrip`` and its
  one-device ``all_reduce_sum`` (under ``jax.vmap`` with an axis of one),
  bucketed too: the same f32 operations in the same order.
* Stochastic int8: over 512 draws the mean decoded value is within 4σ of
  the input (σ from the Bernoulli rounding's variance) and every error is
  under one quantum.
* ``wire_bytes`` equal to JAX's for every codec, bucketed or not, on the
  GPT's and the MLP's parameters; ``plan_buckets`` equal to JAX's plans
  (mixed dtypes, split leaves, empty leaves); pack/unpack bitwise;
  ``overlap_split`` equal.
* fp16 overflow under int8: a NaN feature at step 3 makes non-finite
  gradients; both packages skip the step and back the scale off (the
  decoded gradient stays non-finite: the scale goes non-finite).
* ``SeqParallelEngine`` and ``ExpertParallelEngine`` at (1, 1) with SGD:
  under ``bf16`` each parameter's update is the exact step's within the
  bf16 rounding of its gradient (2⁻⁸ of it); under ``int8`` within one
  quantum of its leaf (``max|g| / 127``) times the learning rate.
* The CLI flags: JAX's defaults and choices; a misspelt codec and a
  negative bucket are refused; the run summary and run report of an MLP
  run carry the codec keys with JAX's values (bytes, codec, bucket size)
  and a probe split under ``--grad-bucket-mb``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.data import loaders as jloaders
from distributed_tensorflow_tpu.engines.allreduce import Trainer as JaxTrainer
from distributed_tensorflow_tpu.engines.sync import SyncEngine as JaxSync
from distributed_tensorflow_tpu.models.gpt import GPTLM as JaxGPT
from distributed_tensorflow_tpu.models.mlp import MLP as JaxMLP
from distributed_tensorflow_tpu.parallel import compression as jcomp
from distributed_tensorflow_tpu.parallel import overlap as joverlap
from distributed_tensorflow_tpu.parallel.mesh import create_mesh as jax_mesh
from distributed_tensorflow_tpu_torch import cli as tcli
from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.engines import (
    ExpertParallelEngine, SeqParallelEngine, SyncEngine, Trainer)
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.models.mlp import MLP
from distributed_tensorflow_tpu_torch.parallel import compression
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel import overlap
from distributed_tensorflow_tpu_torch.utils import harness

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

GPT = dict(vocab_size=64, hidden=32, layers=2, heads=4, max_len=32)
BUCKET_MB = 2e-3     # ~2 KB: several buckets over the small models
LR = 0.1


def _leaves(seed=0):
    """f32 leaves of odd sizes (a padded int8 tail at any n) and one
    fp16 leaf."""
    rng = np.random.default_rng(seed)
    shapes = [(5, 3), (7,), (4, 6), (33,)]
    out = [rng.standard_normal(s).astype(np.float32) * 3 for s in shapes]
    out.append(rng.standard_normal((2, 5)).astype(np.float16))
    return out


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _equal(got, want):
    for g, w in zip(got, want):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------- codecs

def test_make_codec_and_overlap_codec_resolution():
    for name in compression.CODECS:
        assert compression.make_codec(name).name == name
        codec = overlap.make_overlap_codec(name, 0)
        assert codec.name == name and not getattr(codec, "bucketed", False)
        b = overlap.make_overlap_codec(name, 4)
        assert b.name == name and b.bucketed and b.bucket_mb == 4.0
        assert compression.codec_active(b) == \
            jcomp.codec_active(joverlap.make_overlap_codec(name, 4))
        assert compression.codec_active(codec) == (name != "none")
    assert compression.make_codec(None).name == "none"
    codec = compression.Int8Codec()
    assert compression.make_codec(codec) is codec
    for mod in (compression, jcomp):
        with pytest.raises(ValueError, match="unknown grad_compression"):
            mod.make_codec("fp4")
    for ov, comp in ((overlap, compression), (joverlap, jcomp)):
        with pytest.raises(ValueError, match="already bucketed"):
            ov.BucketedCodec(ov.BucketedCodec(comp.GradCodec(), 1.0))
        with pytest.raises(ValueError, match="must be > 0"):
            ov.BucketedCodec(comp.GradCodec(), -1.0)
        with pytest.raises(NotImplementedError, match="per-leaf"):
            ov.make_overlap_codec("int8", 1.0).leaf_wire_bytes((4,),
                                                               np.float32
                                                               if ov is
                                                               joverlap else
                                                               torch.float32)


@pytest.mark.parametrize("bucket", [0, BUCKET_MB / 8])
@pytest.mark.parametrize("name", ["none", "bf16", "int8"])
def test_roundtrip_bitwise_against_jax(name, bucket):
    """Deterministic rounding (no generator): the port's roundtrip is
    JAX's bit for bit, per leaf and per bucket (a ~256-byte bucket splits
    the leaves)."""
    a = _leaves()
    got = overlap.make_overlap_codec(name, bucket).roundtrip(_t(a))
    want = jax.jit(joverlap.make_overlap_codec(name, bucket).roundtrip)(
        _j(a))
    _equal(got, want)


@pytest.mark.parametrize("bucket", [0, BUCKET_MB / 8])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("name", ["none", "bf16", "int8"])
def test_one_rank_reduce_bitwise_against_jax(name, mean, bucket):
    """A reduce over one rank (the card's case; here with no mesh) is
    JAX's under a vmap axis of one, bit for bit: the int8 codec still
    quantizes twice."""
    a = _leaves(1)
    op = "all_reduce_mean" if mean else "all_reduce_sum"
    got = getattr(overlap.make_overlap_codec(name, bucket), op)(_t(a), None)
    jc = joverlap.make_overlap_codec(name, bucket)
    want = jax.jit(jax.vmap(lambda t: getattr(jc, op)(t, "data"),
                            axis_name="data"))([x[None] for x in _j(a)])
    _equal(got, [w[0] for w in want])


def test_int8_stochastic_rounding_unbiased_within_one_quantum():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(64)
                         .astype(np.float32))
    q0, scale = compression._int8_encode(x)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([compression.Int8Codec().roundtrip(
        [x], generator=gen)[0] for _ in range(512)])
    s = float(scale)
    assert float((draws - x).abs().max()) <= s * (1 + 1e-6)
    frac = (x / s) - torch.floor(x / s)
    sigma = s * torch.sqrt(frac * (1 - frac) / 512)
    err = (draws.mean(0) - x).abs()
    assert bool((err <= 4 * sigma + 1e-7).all()), float(err.max())
    # deterministic rounding differs from the draws (they do round)
    assert not torch.equal(draws[0], compression._int8_decode(
        q0, scale, torch.float32))


def _jax_gpt_leaves():
    return jax.tree.leaves(jax.eval_shape(
        JaxGPT(**GPT).init, jax.random.key(0),
        jnp.zeros((1, 8), jnp.int32))["params"])


def _jax_mlp_leaves():
    return jax.tree.leaves(jax.eval_shape(
        JaxMLP(num_classes=10, hidden=32).init, jax.random.key(0),
        jnp.zeros((1, 28, 28, 1)))["params"])


def _port_leaves(kind):
    if kind == "gpt":
        return list(GPTLM(**GPT, device="cpu").parameters())
    model = MLP(num_classes=10, hidden=32, device="cpu")
    model(torch.zeros(1, 28, 28, 1), train=False)
    return list(model.parameters())


@pytest.mark.parametrize("kind", ["gpt", "mlp"])
def test_wire_bytes_equal_jax(kind):
    ours = _port_leaves(kind)
    theirs = _jax_gpt_leaves() if kind == "gpt" else _jax_mlp_leaves()
    assert sorted(p.numel() for p in ours) == sorted(
        int(np.prod(a.shape)) for a in theirs)
    for name in compression.CODECS:
        for mb in (0, BUCKET_MB):
            got = overlap.make_overlap_codec(name, mb).wire_bytes(ours)
            want = joverlap.make_overlap_codec(name, mb).wire_bytes(theirs)
            assert got == want, (kind, name, mb)
        if name == "none":
            continue
        assert sorted(compression.make_codec(name).leaf_wire_bytes(
            p.shape, p.dtype) for p in ours) == sorted(
                jcomp.make_codec(name).leaf_wire_bytes(a.shape, a.dtype)
                for a in theirs)


class _Leaf(NamedTuple):
    shape: tuple
    dtype: Any


_DTYPES = {"float32": (torch.float32, np.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16),
           "int8": (torch.int8, np.int8)}


@pytest.mark.parametrize("spec", [
    # mixed dtypes: a dtype change closes the bucket
    [((4, 4), "float32"), ((8,), "bfloat16"), ((3,), "bfloat16"),
     ((5,), "float32")],
    # split leaves: one leaf over several buckets
    [((100,), "float32"), ((7, 9), "float32"), ((2,), "float32")],
    # empty leaves skipped, int8 leaves
    [((0,), "float32"), ((6,), "int8"), ((0, 3), "float32"),
     ((9,), "float32")],
])
@pytest.mark.parametrize("bucket_bytes", [1, 24, 64, 1 << 20])
def test_plan_buckets_equal_jax(spec, bucket_bytes):
    ours = overlap.plan_buckets([_Leaf(s, _DTYPES[d][0]) for s, d in spec],
                                bucket_bytes)
    theirs = joverlap.plan_buckets(
        [_Leaf(s, _DTYPES[d][1]) for s, d in spec], bucket_bytes)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert str(a.dtype).removeprefix("torch.") == str(jnp.dtype(b.dtype))
        assert a.size == b.size
        assert [tuple(s) for s in a.slices] == [tuple(s) for s in b.slices]
    for mod in (overlap, joverlap):
        with pytest.raises(ValueError, match="must be > 0"):
            mod.plan_buckets([], 0)


def test_pack_unpack_bitwise():
    leaves = _t(_leaves(3)) + [torch.zeros(0)]
    plan = overlap.plan_buckets(leaves, 40)
    packed = overlap.pack_buckets(leaves, plan)
    assert sum(p.numel() for p in packed) == sum(x.numel() for x in leaves)
    for got, want in zip(overlap.unpack_buckets(packed, plan, leaves),
                         leaves):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_overlap_split_equal_jax():
    for full, compute, coll_s in ((1.0, 0.7, 0.5), (0.5, 0.6, 0.2),
                                  (2.0, 1.0, 0.0)):
        assert overlap.overlap_split(full, compute, coll_s) == \
            joverlap.overlap_split(full, compute, coll_s)


# ------------------------------------------------------- fp16 overflow

def _images(n, seed=5):
    x, y = jloaders.synthetic_classification((12, 12), 10, n, seed=seed,
                                             split="train")
    return x.reshape((n, 12, 12, 1)), y


def test_fp16_overflow_under_int8_skips_in_both_packages():
    """A NaN feature in the batch of step 3: the fp16 gradients are
    non-finite, the int8 codec's scale is non-finite, its decoded
    gradient too, and both packages skip the step and halve the scale."""
    x, y = _images(32)
    ds = tloaders.Dataset(x=x, y=y, num_classes=10, name="small")
    third = next(b for i, b in enumerate(
        ds.batches(8, shuffle=True, seed=0, epoch=0, drop_remainder=True))
        if i == 2)[0]
    row = int(np.flatnonzero((x == third[0]).all(axis=(1, 2, 3)))[0])
    x = x.copy()
    x[row, 3, 4, 0] = np.nan
    kw = dict(num_classes=10, hidden=32, dropout_rate=0.0)
    jtr = JaxTrainer(None, engine=JaxSync(
        JaxMLP(**kw, dtype=jnp.float16), mesh=jax_mesh(1),
        precision="fp16-f32master", grad_compression="int8"), seed=0)
    want = jtr.fit(jloaders.Dataset(x=x, y=y, num_classes=10), epochs=1,
                   batch_size=8, log_every=0)
    ttr = Trainer(None, engine=SyncEngine(
        MLP(**kw, dtype=torch.float16, device="cpu"), device="cpu",
        precision="fp16-f32master", grad_compression="int8"), seed=0)
    got = ttr.fit(tloaders.Dataset(x=x, y=y, num_classes=10), epochs=1,
                  batch_size=8, log_every=1, log_fn=lambda _: None)
    assert want["loss_scale"]["skipped_step_list"] == [3], want["loss_scale"]
    assert got["loss_scale"] == want["loss_scale"]
    assert got["grad_compression"] == want["grad_compression"] == "int8"
    assert got["grad_allreduce_bytes"] == want["grad_allreduce_bytes"]
    assert all(torch.isfinite(p).all() for p in ttr.state.model.parameters())


# ------------------------------------------------- SP and EP at (1, 1)

@pytest.fixture
def one_rank(request):
    mesh = meshlib.create_mesh(1, device="cpu", shape=(1, 1),
                               axis_names=("data", request.param))
    yield mesh
    mesh.close()


def _sp_engine(mesh, codec):
    model = create_model("gpt", num_classes=64, attention_impl="ring",
                         device="cpu", vocab_size=64, hidden=32, layers=1,
                         heads=2, max_len=16, dropout_rate=0.0)
    return SeqParallelEngine(model, mesh=mesh, grad_compression=codec,
                             optimizer=lambda p: torch.optim.SGD(p, lr=LR))


def _ep_engine(mesh, codec):
    model = create_model("moe", device="cpu", num_classes=10, num_experts=4,
                         embed_dim=16, expert_hidden=32, dropout_rate=0.0)
    return ExpertParallelEngine(model, mesh=mesh, grad_compression=codec,
                                optimizer=lambda p: torch.optim.SGD(p,
                                                                    lr=LR))


def _batch(kind):
    rng = np.random.default_rng(4)
    if kind == "seq":
        x = rng.integers(0, 64, (4, 16)).astype(np.int32)
        return x, np.roll(x, -1, axis=1)
    return (rng.standard_normal((8, 8, 8)).astype(np.float32),
            rng.integers(0, 10, 8).astype(np.int32))


@pytest.mark.parametrize("one_rank", ["seq", "expert"], indirect=True)
def test_roundtrip_engines_at_one_by_one(one_rank):
    """SP and EP at (1, 1): the exact step, then bf16 and int8 from the
    same weights; each parameter's move from the exact step is within
    its gradient's bf16 rounding, or one int8 quantum of its leaf."""
    kind = one_rank.axis_names[1]
    make = _sp_engine if kind == "seq" else _ep_engine
    x, y = _batch(kind)
    runs = {}
    for codec in ("none", "bf16", "int8"):
        eng = make(one_rank, codec)
        state = eng.init_state(torch.Generator().manual_seed(0), x[:1])
        init = {k: v.clone() for k, v in state.model.state_dict().items()}
        state, m = eng.step(state, *eng.shard_batch(x, y))
        runs[codec] = (init, {k: v.clone() for k, v in
                              state.model.state_dict().items()},
                       float(m["loss"]))
        assert eng.grad_codec.name == codec and eng.codec_stream_words == ()
    init, exact, loss = runs["none"]
    for codec in ("bf16", "int8"):
        i2, got, l2 = runs[codec]
        assert l2 == loss   # the forward is the same
        moved = False
        for k, w in exact.items():
            assert torch.equal(i2[k], init[k])
            g = (init[k] - w) / LR
            if codec == "bf16":
                bound = LR * 2.0 ** -8 * g.abs() + 1e-7
            else:
                bound = LR * float(g.abs().max()) / 127 * (1 + 1e-4) + 1e-7
            assert bool(((got[k] - w).abs() <= bound).all()), (codec, k)
            moved |= not torch.equal(got[k], w)
        assert moved, codec


# ------------------------------------------------------------ CLI + run

def test_cli_flags_parse_as_jax():
    from distributed_tensorflow_tpu import cli as jcli

    p, jp = tcli.build_parser(), jcli.build_parser()
    for argv in ([], ["--grad-compression", "int8", "--grad-bucket-mb",
                      "4"], ["--grad-compression", "bf16"]):
        got, want = p.parse_args(argv), jp.parse_args(argv)
        for f in ("grad_compression", "grad_bucket_mb"):
            assert getattr(got, f) == getattr(want, f), (argv, f)
    acts = {a.dest: a for a in p._actions}
    jacts = {a.dest: a for a in jp._actions}
    for f in ("grad_compression", "grad_bucket_mb"):
        assert acts[f].choices == jacts[f].choices
        assert acts[f].default == jacts[f].default
    with pytest.raises(SystemExit):
        p.parse_args(["--grad-compression", "fp4"])


def _tiny_ds(batch_size, type="train"):  # noqa: A002 — harness API
    n = 128 if type == "train" else 64
    x, y = jloaders.synthetic_classification((8,), 4, n, seed=3)
    return tloaders.Dataset(x=x, y=y, num_classes=4, name="tiny",
                            synthetic=True)


def _jax_tiny_ds(batch_size, type="train"):  # noqa: A002 — harness API
    n = 128 if type == "train" else 64
    x, y = jloaders.synthetic_classification((8,), 4, n, seed=3)
    return jloaders.Dataset(x=x, y=y, num_classes=4, name="tiny",
                            synthetic=True)


def test_misspelt_codec_and_negative_bucket_are_refused():
    base = harness.ExperimentConfig(model="mlp", dataset="synthetic",
                                    dataset_fn=_tiny_ds, device="cpu",
                                    n_devices=1)
    with pytest.raises(ValueError, match="unknown grad_compression 'fp4'"):
        harness._setup(dataclasses.replace(base, grad_compression="fp4"))
    with pytest.raises(ValueError, match="--grad-bucket-mb must be >= 0"):
        harness._setup(dataclasses.replace(base, grad_bucket_mb=-1.0))
    with pytest.raises(ValueError, match="--grad-bucket-mb must be >= 0"):
        tcli.main(["--device", "cpu", "--grad-bucket-mb", "-2"])


CODEC_KEYS = ("grad_allreduce_bytes", "grad_allreduce_bytes_raw",
              "grad_compression", "grad_bucket_mb")


def test_summary_and_run_report_codec_keys_match_jax():
    from distributed_tensorflow_tpu import cli as jcli

    argv = ["-m", "c", "-cs", "sync", "-n", "1", "-b", "16", "--model",
            "mlp", "--model-arg", "hidden=32", "--log-every", "0",
            "--grad-compression", "int8", "--grad-bucket-mb",
            str(BUCKET_MB / 4)]
    want = jcli.main(argv, dataset_fn=_jax_tiny_ds)
    got = tcli.main(argv + ["--device", "cpu"], dataset_fn=_tiny_ds)
    assert set(got) <= set(want), set(got) - set(want)
    assert set(got["run_report"]) <= set(want["run_report"]), \
        set(got["run_report"]) - set(want["run_report"])
    for key in CODEC_KEYS:
        assert got["run_report"][key] == want["run_report"][key], key
    split = got["run_report"]["collective_overlap"]
    assert split["n_buckets"] == want["run_report"]["collective_overlap"][
        "n_buckets"] > 1
    for key in ("exposed_s", "hidden_s", "full_step_s", "compute_s"):
        assert np.isfinite(split[key]) and split[key] >= 0, key
    assert got["run_report"]["grad_collective_exposed_s"] == \
        split["exposed_s"]
    assert np.isfinite(got["test_loss"]) and got["steps"] == want["steps"]
