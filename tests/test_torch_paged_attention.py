"""Port of ``ops/paged_attention.py``: the plain PyTorch version held to the
JAX kernel (Pallas interpret mode on the CPU, as the JAX package's own tests
run it) on the cases of ``tests/test_serving_paged_kernel.py``, including
the JAX kernel under a GSPMD mesh, and the wrapper's input checks.  The
plain model of the kernel's split-key design (``_split_reference``: a
partial ``(m, l, acc)`` per split, then the merge) is held to the one-pass
plain version and to the JAX kernel at split counts 1–4, and the split
and shared-memory planning is checked.  The Hopper kernel itself is held
to the plain version on the card by
``tests/test_torch_paged_attention_cuda.py``.

Tolerance: f32 ``rtol=1e-5, atol=2e-5``, the JAX package's own kernel-vs-
oracle bound (online-softmax reassociation against one dense softmax).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_tensorflow_tpu.ops import paged_attention as jpa
from distributed_tensorflow_tpu_torch.ops import paged_attention as tpa

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=2e-5)


def _case(seed, *, s=4, l_q=1, h=4, kvh=None, d=8, blk=4, mb=4, int8=False):
    """numpy inputs: random pools, a PERMUTED block table, positions that
    leave every query row at least one valid key (the JAX suite's
    generator)."""
    kvh = kvh if kvh is not None else h
    n = s * mb + 2
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s, l_q, h, d)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (n, blk, kvh, d)).astype(np.int8)
        v = rng.integers(-127, 128, (n, blk, kvh, d)).astype(np.int8)
        ks = (rng.uniform(0.5, 1.5, (n, blk, kvh)) / 127.0).astype(np.float32)
        vs = (rng.uniform(0.5, 1.5, (n, blk, kvh)) / 127.0).astype(np.float32)
    else:
        k = rng.standard_normal((n, blk, kvh, d)).astype(np.float32)
        v = rng.standard_normal((n, blk, kvh, d)).astype(np.float32)
        ks = vs = None
    bt = rng.permutation(n)[:s * mb].reshape(s, mb).astype(np.int32)
    pos = rng.integers(1, mb * blk - l_q + 1, s).astype(np.int32)
    return dict(q=q, k=k, v=v, bt=bt, pos=pos, ks=ks, vs=vs)


def _jax(c):
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(jpa.paged_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["bt"]), jnp.asarray(c["pos"]),
        k_scale=opt(c["ks"]), v_scale=opt(c["vs"])))


def _port(c, fn=tpa.paged_attention, device="cpu"):
    t = lambda a: (None if a is None  # noqa: E731
                   else torch.from_numpy(a).to(device))
    out = fn(t(c["q"]), t(c["k"]), t(c["v"]), t(c["bt"]), t(c["pos"]),
             k_scale=t(c["ks"]), v_scale=t(c["vs"]))
    return out.cpu().numpy()


CASES = {
    "decode_mha": dict(seed=0),
    "gqa": dict(seed=1, h=4, kvh=2),
    "verify_width": dict(seed=2, l_q=3, h=4, kvh=2),
    "int8_dequant": dict(seed=3, h=4, kvh=2, int8=True),
    "mqa_wide_table": dict(seed=8, h=4, kvh=1, mb=6, blk=2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_kernel(name):
    """The port's plain version (what the wrapper runs on a CPU tensor)
    against the Pallas kernel in interpret mode."""
    kw = dict(CASES[name])
    c = _case(kw.pop("seed"), **kw)
    np.testing.assert_allclose(_port(c), _jax(c), **TOL)
    np.testing.assert_allclose(
        _port(c, tpa.paged_attention_reference), _jax(c), **TOL)


SPLIT_CASES = dict(
    CASES,
    # 4 live entries of 6 at most: splits 3 and 4 leave a split past the
    # last position (an empty range)
    past_last_position=dict(seed=10, s=3, mb=6, blk=4, pos=[0, 5, 13]),
    # l_q=5 at pos 3, block 2: 4 live entries, and at 2 splits the boundary
    # (key 4) falls between pos and pos + 4, so row 0 sees no valid key in
    # split 1
    verify_boundary=dict(seed=11, s=2, l_q=5, h=4, kvh=2, mb=5, blk=2,
                         pos=[3, 3]),
)


@functools.cache
def _split_case(name):
    kw = dict(SPLIT_CASES[name])
    pos = kw.pop("pos", None)
    c = _case(kw.pop("seed"), **kw)
    if pos is not None:
        c["pos"] = np.asarray(pos, np.int32)
    return c, _jax(c)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_model_matches_reference_and_jax_kernel(name, splits):
    """The kernel's split and merge, in plain PyTorch, equals the one-pass
    plain version and the Pallas kernel in interpret mode."""
    c, want = _split_case(name)
    got = _port(c, functools.partial(tpa._split_reference, splits=splits))
    np.testing.assert_allclose(got, _port(c, tpa.paged_attention_reference),
                               **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_splits_at_the_timed_shapes():
    """The serve decode shape and the 4096-token context of
    ``chip_smoke.py``: the counts its sweep measured best."""
    assert tpa._splits(8, 8, 18, 8) == 4
    assert tpa._splits(8, 8, 256, 16) == 8


def test_split_ranges_cover_the_live_entries_in_order():
    for n_live in range(1, 20):
        for splits in range(1, 9):
            ranges = tpa._split_ranges(n_live, splits)
            assert len(ranges) == splits
            assert ranges[0][0] == 0 and ranges[-1][1] == n_live
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert max(j1 - j0 for j0, j1 in ranges) == -(-n_live // splits)
    # the verify case above: split 1 starts past row 0's position
    assert tpa._split_ranges(4, 2) == [(0, 2), (2, 4)]
    assert tpa._split_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]


@pytest.mark.parametrize("slots, kvh, mb, blk", [
    (8, 8, 18, 8), (8, 8, 256, 16), (4, 2, 4, 4), (1, 1, 1, 8),
    (64, 8, 18, 8), (2, 1, 300, 16)])
def test_splits_depend_on_shapes_only_and_stay_in_range(slots, kvh, mb, blk):
    n = tpa._splits(slots, kvh, mb, blk)
    assert 1 <= n <= mb and n & (n - 1) == 0
    assert n == tpa._splits(slots, kvh, mb, blk)
    assert tpa._splits(slots * 2, kvh, mb, blk) <= n


@pytest.mark.parametrize("kw, want", [
    # decode shape: GL=1, D=64, bf16 rows (128 bytes, padded to 144), 5
    # splits of 18 -> 4 entries
    (dict(gl=1, d=64, blk=8, mb=18, splits=5, chunk=4, kv_bytes=2),
     2 * 256 + 16 + 16 + 128 + 512 + 2 * 32 * 144),
    # a chunk shorter than the split: two stages
    (dict(gl=1, d=64, blk=16, mb=256, splits=4, chunk=7, kv_bytes=2),
     2 * 256 + 16 + 256 + 448 + 512 + 2 * 2 * 112 * 144),
    # int8 rows of 8 bytes (not padded) and their scales
    (dict(gl=2, d=8, blk=4, mb=4, splits=1, chunk=4, kv_bytes=1,
          quantized=True),
     2 * 64 + 32 + 16 + 128 + 512 + 2 * (128 + 64)),
    # f32 rows of 48 bytes: already an odd number of chunks
    (dict(gl=1, d=12, blk=4, mb=2, splits=2, chunk=1),
     2 * 48 + 16 + 16 + 16 + 512 + 2 * 4 * 48),
])
def test_smem_bytes_mirror_the_kernel_layout(kw, want):
    assert tpa.smem_bytes(**kw) == want


@pytest.mark.parametrize("gl, d, blk, mb, splits, kv_bytes", [
    (1, 64, 8, 18, 5, 2), (1, 64, 16, 256, 1, 2), (1, 64, 16, 256, 5, 2),
    (80, 128, 8, 6, 1, 4), (1, 256, 8, 4, 1, 4), (8, 8, 4, 4, 2, 1)])
def test_plan_keeps_a_cta_under_its_target_where_it_can(gl, d, blk, mb,
                                                        splits, kv_bytes):
    chunk, smem = tpa._plan(gl, d, blk, mb, splits, kv_bytes, False)
    cmax = -(-mb // splits)
    assert 1 <= chunk <= cmax
    assert smem == tpa.smem_bytes(gl, d, blk, mb=mb, splits=splits,
                                  chunk=chunk, kv_bytes=kv_bytes)
    assert smem <= tpa._SMEM_TARGET or chunk == 1
    assert smem <= tpa._SMEM_LIMIT


def test_verify_staircase_row0_equals_solo_decode():
    """Row 0 of an l_q=3 verify block equals an l_q=1 call at the same
    position: each row r attends ``t <= pos + r``."""
    c = _case(2, l_q=3, h=4, kvh=2)
    solo = dict(c, q=np.ascontiguousarray(c["q"][:, :1]))
    np.testing.assert_allclose(_port(solo)[:, 0], _port(c)[:, 0], **TOL)


def test_reads_through_block_aliases():
    """Two slots whose tables point at the same blocks compute identical
    outputs for identical queries, as in the JAX kernel."""
    c = _case(4, s=2)
    c["bt"] = np.stack([c["bt"][0], c["bt"][0]])
    c["pos"] = np.stack([c["pos"][0], c["pos"][0]])
    c["q"] = np.stack([c["q"][0], c["q"][0]])
    out = _port(c)
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_allclose(out, _jax(c), **TOL)


def test_masks_tail_and_unmapped_blocks():
    """Poisoning every block past each slot's position changes nothing."""
    c = _case(5, s=3, mb=4, blk=4)
    c["pos"] = np.asarray([2, 5, 9], np.int32)
    base = _port(c)
    k2, v2 = c["k"].copy(), c["v"].copy()
    for s_i, p_i in enumerate(c["pos"]):
        for j in range(p_i // 4 + 1, 4):
            bid = c["bt"][s_i, j]
            k2[bid], v2[bid] = 1e4, -1e4
    np.testing.assert_array_equal(base, _port(dict(c, k=k2, v=v2)))
    np.testing.assert_allclose(base, _jax(c), **TOL)


def test_positions_at_block_edges():
    """Positions on the last and first row of a block (the live-block
    count changes there)."""
    c = _case(9, s=6, h=4, kvh=2, mb=4, blk=4)
    c["pos"] = np.asarray([0, 3, 4, 7, 8, 15], np.int32)
    np.testing.assert_allclose(_port(c), _jax(c), **TOL)


def test_matches_jax_kernel_under_gspmd_mesh(mesh8):
    """The JAX serving layout under jit (slots sharded over the 8-way data
    axis, pools replicated) gives the numbers the port computes."""
    c = _case(6, s=8)
    row = lambda n: NamedSharding(  # noqa: E731
        mesh8, P("data", *([None] * (n - 1))))
    repl = NamedSharding(mesh8, P())
    want = np.asarray(jax.jit(jpa.paged_attention)(
        jax.device_put(jnp.asarray(c["q"]), row(4)),
        jax.device_put(jnp.asarray(c["k"]), repl),
        jax.device_put(jnp.asarray(c["v"]), repl),
        jax.device_put(jnp.asarray(c["bt"]), row(2)),
        jax.device_put(jnp.asarray(c["pos"]), row(1))))
    np.testing.assert_allclose(_port(c), want, **TOL)


def _bad(**over):
    c = _case(7, h=4, kvh=2)
    t = {k: (None if a is None else torch.from_numpy(a))
         for k, a in c.items()}
    t.update(over)
    return t


@pytest.mark.parametrize("over, exc, match", [
    (dict(ks=torch.ones(18, 4, 2)), ValueError, "together"),
    (dict(q=torch.zeros(4, 1, 3, 8)), ValueError, "divisible"),
    (dict(q=torch.zeros(4, 1, 4, 8, dtype=torch.float16)), TypeError,
     "float32 or bfloat16"),
    (dict(k=torch.zeros(18, 4, 2, 8, dtype=torch.float64),
          v=torch.zeros(18, 4, 2, 8, dtype=torch.float64)), TypeError,
     "pools"),
    (dict(k=torch.zeros(18, 4, 2, 8, dtype=torch.int8),
          v=torch.zeros(18, 4, 2, 8, dtype=torch.int8)), TypeError,
     "k_scale"),
    (dict(bt=torch.zeros(4, 4, dtype=torch.int64)), TypeError, "int32"),
    (dict(pos=torch.zeros(4, dtype=torch.int64)), TypeError, "int32"),
    (dict(bt=torch.zeros(3, 4, dtype=torch.int32)), ValueError,
     "block_tables"),
    (dict(pos=torch.zeros(5, dtype=torch.int32)), ValueError, "positions"),
    (dict(q=torch.zeros(4, 1, 4, 512),
          k=torch.zeros(18, 4, 2, 512), v=torch.zeros(18, 4, 2, 512)),
     ValueError, "head_dim=512"),
    (dict(q=torch.zeros(4, 1, 8, 4).transpose(2, 3)), ValueError,
     "contiguous"),
    (dict(q=torch.zeros(4, 1, 4, 9)), ValueError, "head_dim"),
])
def test_wrapper_rejects_bad_inputs(over, exc, match):
    t = _bad(**over)
    with pytest.raises(exc, match=match):
        tpa.paged_attention(t["q"], t["k"], t["v"], t["bt"], t["pos"],
                            k_scale=t["ks"], v_scale=t["vs"])


def test_wrapper_counts_no_launch_on_cpu():
    """A CPU tensor runs the plain version; only kernel launches count."""
    before = tpa.paged_attention.launches
    _port(_case(0))
    assert tpa.paged_attention.launches == before
