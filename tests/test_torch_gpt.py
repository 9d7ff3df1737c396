"""Port of ``models/gpt.py`` and its building blocks, held to the JAX package
at a small size in f32: GPT training-mode logits against flax (learned and
RoPE positions, GQA) through ``models/convert.py``, dense and flash
attention, and the gradients of the mean cross-entropy of the flash model
against ``jax.grad`` of flax's (whose flash attention runs the Pallas
kernels in interpret mode), ``apply_rope``,
``dense_attention``, the int8 channel codec, the paged write's drop of
positions past the table, and a subprocess showing the port imports no JAX.

It also holds the decode modes: cursor decode step by step against flax
``decode=True`` (and a block prefill against the same steps), ``generate``
against JAX ``generate``, the ``max_len`` check and the sticky overflow
flag, and monolithic slot decode over a (B, L) token block against flax
``decode_slots`` with bf16 and int8 storage, with the drop of positions
past the table.

Tolerance for the logits: ``atol=2e-5, rtol=1e-5`` — f32 with the same
operation order up to BLAS blocking and flax's one-pass LayerNorm variance.
Stored bf16 K/V: ``atol=2e-3, rtol=1e-3``; int8: ``atol=rtol=1e-2`` —
both sides round the same projections, which differ by f32 noise, so a
value next to a rounding boundary may round to the neighbouring bf16 value
(a step of 2^-8 of it) or int8 code (a step of 1/127 of its vector's
max-abs value).
Gradients: ``rtol=1e-4, atol=1e-6`` — the flash backward's tolerance
(``tests/test_flash_attention.py``), carried through two layers; gradient
entries are of order 1e-3 to 1e-1 here.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models.gpt import GPTLM as JaxGPT
from distributed_tensorflow_tpu.models.gpt import apply_rope as jax_rope
from distributed_tensorflow_tpu.models.gpt import generate as jax_generate
from distributed_tensorflow_tpu.parallel import compression as jcomp
from distributed_tensorflow_tpu.parallel.ring_attention import (
    dense_attention as jax_dense)
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.models.convert import gpt_state_dict
from distributed_tensorflow_tpu_torch.models.gpt import (
    GPTLM, apply_rope, generate)
from distributed_tensorflow_tpu_torch.parallel import compression as tcomp
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    dense_attention)

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SMALL = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
             ffn=64, max_len=32, dropout_rate=0.0)
TOL = dict(rtol=1e-5, atol=2e-5)
STORED_TOL = {"bfloat16": dict(rtol=1e-3, atol=2e-3),
              "int8": dict(rtol=1e-2, atol=1e-2)}
REPO = Path(__file__).resolve().parent.parent


def _pair(weight_scale=1.0, **over):
    """A flax GPT and its port at the same params; ``weight_scale`` scales
    every Dense kernel and embedding so that greedy streams vary."""
    kw = dict(SMALL, **over)
    jm = JaxGPT(**kw)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * weight_scale
        if path[-1].key in ("kernel", "embedding") else x, params)
    tm = GPTLM(**kw, device="cpu")
    tm.load_state_dict(gpt_state_dict(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("positional", ["learned", "rope"])
@pytest.mark.parametrize("kv_heads", [2, 4])
def test_training_logits_match_flax(positional, kv_heads):
    _assert_logits_match(positional=positional, kv_heads=kv_heads)


@pytest.mark.parametrize("positional", ["learned", "rope"])
@pytest.mark.parametrize("kv_heads", [2, 4])
def test_flash_training_logits_match_flax(positional, kv_heads):
    _assert_logits_match(positional=positional, kv_heads=kv_heads,
                         attention_impl="flash")


def _assert_logits_match(**kw):
    jm, params, tm = _pair(**kw)
    ids = np.random.default_rng(0).integers(0, 64, (2, 12)).astype(np.int32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                               train=False))
    got = tm(torch.from_numpy(ids)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (2, 12, 64)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("positional, kv_heads", [("learned", 4),
                                                  ("rope", 2)])
def test_flash_model_loss_gradients_match_flax(positional, kv_heads):
    """Gradients of the mean next-token cross-entropy over every token, the
    tied token table's included (its lookup and head uses summed)."""
    import optax

    jm, params, tm = _pair(positional=positional, kv_heads=kv_heads,
                           attention_impl="flash")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 64, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 64, (2, 16)).astype(np.int32)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    want_loss, grads = jax.value_and_grad(loss_fn)(params)
    want = gpt_state_dict(jax.tree.map(np.asarray, grads))
    logits = tm(torch.from_numpy(ids), train=True)
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 64), torch.from_numpy(labels).long().reshape(-1))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_untied_head_converts():
    jm, params, tm = _pair(tie_embeddings=False)
    assert tm.lm_head is not None
    ids = np.random.default_rng(1).integers(0, 64, (1, 9)).astype(np.int32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                               train=False))
    np.testing.assert_allclose(
        tm(torch.from_numpy(ids)).detach().numpy(), want, **TOL)


def test_convert_layouts():
    """Dense kernels transpose to (out, in); embeddings copy as they are;
    LayerNorm scale becomes weight; the tied head has no weight of its
    own."""
    _, params, tm = _pair()
    sd = gpt_state_dict(jax.tree.map(np.asarray, params))
    q = np.asarray(params["GPTBlock_0"]["CausalSelfAttention_0"]["query"]
                   ["kernel"])
    np.testing.assert_array_equal(sd["blocks.0.attn.query.weight"].numpy(),
                                  q.T)
    np.testing.assert_array_equal(
        sd["token_embed.weight"].numpy(),
        np.asarray(params["token_embed"]["embedding"]))
    np.testing.assert_array_equal(
        sd["ln_f.weight"].numpy(),
        np.asarray(params["LayerNorm_0"]["scale"]))
    assert not any(k.startswith("lm_head") for k in sd)
    assert set(sd) == set(tm.state_dict())


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask", ["none", "causal", "per_row", "per_query"])
def test_dense_attention_matches_jax(mask):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
    kw = {}
    if mask == "causal":
        k, v = k[:, :4], v[:, :4]
        kw["causal"] = True
    elif mask == "per_row":
        kw["kv_mask"] = (rng.uniform(size=(2, 6)) > 0.3).astype(np.float32)
    elif mask == "per_query":
        kw["kv_mask"] = (rng.uniform(size=(2, 4, 6)) > 0.3).astype(
            np.float32)
    want = np.asarray(jax_dense(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}))
    got = dense_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **{n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_int8_channel_codec_matches_jax():
    """Round to nearest, clip ±127, scale floor finfo(f32).tiny (the zero
    vector) — the same int8 payload bit for bit."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 2, 8)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    jq, js = jcomp.int8_channel_encode(jnp.asarray(x))
    tq, ts = tcomp.int8_channel_encode(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0, 0, 0]) == np.finfo(np.float32).tiny
    np.testing.assert_array_equal(
        tcomp.int8_channel_decode(tq, ts, torch.float32).numpy(),
        np.asarray(jcomp.int8_channel_decode(jq, js, jnp.float32)))


def test_paged_write_drops_positions_past_the_table():
    """A position past max_len (a pad row) must not land in any live
    block: it goes to the pool's last block, the scratch block."""
    tm = GPTLM(**SMALL, device="cpu")
    tm.reset_parameters(torch.Generator().manual_seed(0))
    blk, mb = 4, SMALL["max_len"] // 4
    pools = [{"key_pool": torch.zeros(mb + 1, blk, 2, 8),
              "value_pool": torch.zeros(mb + 1, blk, 2, 8)}
             for _ in range(SMALL["layers"])]
    bt = torch.arange(mb, dtype=torch.int32)[None, :]
    ids = torch.tensor([[5, 6, 7, 8]])
    pos = torch.tensor([[30, 31, 32, 33]], dtype=torch.int32)
    with torch.no_grad():
        logits = tm(ids, positions=pos, block_tables=bt, pools=pools,
                    paged_fused=False)
    assert torch.isfinite(logits).all()
    for layer in pools:
        kp = layer["key_pool"]
        assert kp[:mb - 1].abs().sum() == 0           # untouched live blocks
        assert kp[mb - 1, 2:].abs().sum() > 0          # positions 30, 31
        assert kp[mb - 1, :2].abs().sum() == 0
        assert kp[mb, :2].abs().sum() > 0              # 32, 33 → scratch


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("positional", ["learned", "rope"])
@pytest.mark.parametrize("kv_heads", [2, 4])
def test_cursor_decode_logits_match_flax(positional, kv_heads):
    """Seven single-token steps of cursor decode against flax
    ``decode=True`` (its cache from ``init``, advanced by ``apply``); a
    5-token block prefill gives the logits of the first five steps at
    once."""
    jm, params, tm = _pair(positional=positional, kv_heads=kv_heads)
    dm = jm.clone(decode=True)
    ids = np.random.default_rng(6).integers(0, 64, (2, 7)).astype(np.int32)
    jcache = dm.init(jax.random.key(0), jnp.asarray(ids[:, :1]),
                     train=False)["cache"]
    cache = tm.init_cache(2)
    want = []
    for t in range(ids.shape[1]):
        logits, upd = dm.apply({"params": params, "cache": jcache},
                               jnp.asarray(ids[:, t:t + 1]), train=False,
                               mutable=["cache"])
        jcache = upd["cache"]
        want.append(np.asarray(logits[:, 0]))
        with torch.no_grad():
            got, cache = tm(torch.from_numpy(ids[:, t:t + 1]), cache=cache)
        np.testing.assert_allclose(_np(got[:, 0]), want[-1], **TOL)
    assert int(cache[0]["cache_index"]) == 7
    block = tm.init_cache(2)
    with torch.no_grad():
        got, block = tm(torch.from_numpy(ids[:, :5]), cache=block)
    np.testing.assert_allclose(_np(got), np.stack(want[:5], 1), **TOL)
    assert all(int(layer["cache_index"]) == 5 for layer in block)


@pytest.mark.parametrize("positional, kv_heads", [("learned", 2),
                                                  ("rope", 4)])
def test_generate_greedy_equals_jax(positional, kv_heads):
    """Greedy ``generate`` streams equal JAX ``generate``'s token for
    token (prompt prefilled in one forward here, by a scan there)."""
    jm, params, tm = _pair(weight_scale=3.0, positional=positional,
                           kv_heads=kv_heads)
    prompt = np.random.default_rng(7).integers(0, 64, (3, 7)).astype(
        np.int32)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), 20,
                                   greedy=True))
    got = generate(tm, None, prompt, 20, greedy=True, device="cpu")
    assert got.shape == (3, 20) and len(np.unique(want)) > 8
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_capacity_and_overflow_flag():
    """``generate`` refuses Lp + max_new_tokens > max_len; direct cursor
    decode past capacity sets the sticky overflow flag, as flax does; a
    decode-only model needs a cache."""
    _, _, tm = _pair()
    with pytest.raises(ValueError, match="exceeds the cache capacity"):
        generate(tm, None, np.zeros((1, 20), np.int32), 13, device="cpu")
    assert generate(tm, None, np.zeros((1, 20), np.int32), 12,
                    greedy=True, device="cpu").shape == (1, 12)
    cache = tm.init_cache(1)
    with torch.no_grad():
        _, cache = tm(torch.zeros(1, 31, dtype=torch.long), cache=cache)
        assert not bool(cache[0]["overflow"])
        _, cache = tm(torch.zeros(1, 1, dtype=torch.long), cache=cache)
        assert not bool(cache[0]["overflow"])      # position 31: the last
        _, full = tm(torch.zeros(1, 1, dtype=torch.long), cache=cache)
        _, full = tm(torch.zeros(1, 1, dtype=torch.long), cache=full)
    assert all(bool(layer["overflow"]) for layer in full)
    assert int(full[0]["cache_index"]) == 34
    assert not bool(cache[0]["overflow"])          # the dicts passed in
    dm = GPTLM(**SMALL, decode=True, device="cpu")
    with pytest.raises(ValueError, match="init_cache"):
        dm(torch.zeros(1, 1, dtype=torch.long))


def _slot_caches(store, slots, layers=SMALL["layers"]):
    shape = (slots, SMALL["max_len"], 2, 8)
    out = []
    for _ in range(layers):
        layer = {"cached_key": torch.zeros(shape, dtype=store),
                 "cached_value": torch.zeros(shape, dtype=store)}
        if store == torch.int8:
            layer["key_scale"] = torch.zeros(shape[:3])
            layer["value_scale"] = torch.zeros(shape[:3])
        out.append(layer)
    return out


@pytest.mark.parametrize("store", ["bfloat16", "int8"])
def test_monolithic_slot_block_logits_match_flax(store):
    """Monolithic slot decode over a (B, L) token block at per-slot
    offsets, then a one-token step, against flax ``decode_slots`` with the
    same storage: logits, and the stored table (STORED_TOL)."""
    jm, params, tm = _pair()
    quant = store == "int8"
    dm = jm.clone(decode=True, decode_slots=True, kv_quant=quant)
    dummy = jnp.zeros((3, 1), jnp.int32)
    shapes = jax.eval_shape(lambda: dm.init(
        jax.random.key(0), dummy, train=False, positions=dummy))["cache"]
    jcache = jax.tree.map(lambda t: jnp.zeros(t.shape, t.dtype), shapes)
    if not quant:
        jcache = jax.tree.map(lambda t: t.astype(jnp.bfloat16), jcache)
    pools = _slot_caches(torch.int8 if quant else torch.bfloat16, 3)
    rng = np.random.default_rng(8)
    starts = np.array([0, 5, 20], np.int32)
    for width in (6, 1):
        ids = rng.integers(0, 64, (3, width)).astype(np.int32)
        pos = starts[:, None] + np.arange(width, dtype=np.int32)[None, :]
        want, upd = dm.apply({"params": params, "cache": jcache},
                             jnp.asarray(ids), train=False,
                             positions=jnp.asarray(pos), mutable=["cache"])
        jcache = upd["cache"]
        with torch.no_grad():
            got = tm(torch.from_numpy(ids), positions=torch.from_numpy(pos),
                     pools=pools)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   **STORED_TOL[store])
        starts = starts + width
    jl = jcache["GPTBlock_1"]["CausalSelfAttention_0"]
    for name in pools[1]:
        np.testing.assert_allclose(
            _np(pools[1][name]), np.asarray(jl[name]).astype(np.float32),
            rtol=1e-2, atol=1.0 if quant and "cached" in name else 1e-2,
            err_msg=name)


def test_monolithic_write_drops_positions_past_the_table():
    """A position at or past max_len is dropped: rows 30 and 31 are
    written, nothing else of the table changes."""
    tm = GPTLM(**SMALL, device="cpu")
    tm.reset_parameters(torch.Generator().manual_seed(0))
    pools = _slot_caches(torch.float32, 1)
    with torch.no_grad():
        logits = tm(torch.tensor([[5, 6, 7, 8]]),
                    positions=torch.tensor([[30, 31, 32, 33]]), pools=pools)
    assert torch.isfinite(logits).all()
    for layer in pools:
        ck = layer["cached_key"][0]
        assert ck[:30].abs().sum() == 0
        assert (ck[30:].abs().sum(dim=(1, 2)) > 0).all()


def test_unported_options_raise():
    # ported since: the tensor-parallel layout (a MoE block's experts stay
    # whole, as in JAX, unless partition_experts), and its composite with
    # sequence parallelism, which needs the mesh CompositeEngine binds
    for kw in (dict(moe_experts=2, partition_model=True),
               dict(partition_model=True)):
        assert GPTLM(**SMALL, **kw, device="cpu").partition_model
    with pytest.raises(ValueError, match="no mesh bound"):
        GPTLM(**SMALL, partition_model=True, attention_impl="ring_flash",
              device="cpu")(torch.zeros((1, 4), dtype=torch.int64))
    # the sequence-parallel attentions are ported: they need the mesh
    # SeqParallelEngine binds
    for impl in ("ring_flash", "ring", "ulysses", "ulysses_flash"):
        with pytest.raises(ValueError, match="no mesh bound"):
            GPTLM(**SMALL, attention_impl=impl, device="cpu")(
                torch.zeros((1, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="unknown attention_impl"):
        GPTLM(**SMALL, attention_impl="sparse", device="cpu")
    with pytest.raises(ValueError, match="remat \\+ MoE blocks"):
        GPTLM(**SMALL, remat=True, moe_experts=2, device="cpu")
    # ported since: generate(mesh=...) (TP decode), which keeps JAX's
    # refusal of a batch the 'data' axis does not divide
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    two = Mesh(rank=0, world_size=2, device=torch.device("cpu"),
               backend="gloo")
    with pytest.raises(ValueError,
                       match=r"batch 1 not divisible by the data axis \(2\)"):
        generate(GPTLM(**SMALL, device="cpu"), None,
                 np.zeros((1, 4), np.int32), 2, device="cpu", mesh=two)


def test_create_model_builds_gpt_on_cpu_and_defaults_to_cuda():
    m = create_model("gpt", num_classes=64, hidden=32, layers=1, heads=4,
                     ffn=64, max_len=16, dtype="bf16", device="cpu")
    assert m.vocab_size == 64 and m.dtype == torch.bfloat16
    assert m.token_embed.weight.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("gpt", num_classes=64, hidden=32, layers=1,
                         heads=4, ffn=64, max_len=16)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import distributed_tensorflow_tpu_torch.serving\n"
        "import distributed_tensorflow_tpu_torch.models.convert\n"
        "import distributed_tensorflow_tpu_torch.ops.paged_attention\n"
        "import distributed_tensorflow_tpu_torch.observability\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'distributed_tensorflow_tpu')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
