"""The program ledger (``observability/xla_stats.py``), its observers (the
KV tables, the kernel build cache) and the offline analyzer
(``observability/analyze.py``), held to the JAX package on the CPU:

* the manifest's sums and ``diff_manifests`` equal JAX's on the same
  records;
* ``SlotKVCache(ledger=)`` records the first prefill chunk of each
  length, the decode step and each verify width under JAX's program
  names, in both layouts, once per signature, and changes no token;
* ``ops/_build.watch_builds`` records a library built under it (a
  stand-in compiler, the CPU having no ``nvcc``) in the directory
  ``set_build_dir`` chose, and nothing outside it;
* JAX's and the port's ``analyze`` print the same answers from the same
  port-written trace, metrics and summary, for every subcommand.
"""

from __future__ import annotations

import contextlib
import io
import json
import stat
import sys

import numpy as np
import pytest

from distributed_tensorflow_tpu.observability import analyze as janalyze
from distributed_tensorflow_tpu.observability import xla_stats as jxs
from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.observability import analyze
from distributed_tensorflow_tpu_torch.observability import xla_stats as xs
from distributed_tensorflow_tpu_torch.ops import _build
from distributed_tensorflow_tpu_torch.serving import SlotKVCache

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SMALL = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
             ffn=64, max_len=32, dropout_rate=0.0)
MEM = dict(argument_bytes=100, output_bytes=20, temp_bytes=300,
           generated_code_bytes=0, alias_bytes=0, peak_bytes_est=420)


def _both(records):
    """The same records in the port's ledger and JAX's."""
    ours, theirs = xs.ProgramLedger(), jxs.ProgramLedger()
    for name, mem, seconds, flops in records:
        ours.record(name, compile_s=seconds, flops=flops, **(mem or {}))
        theirs._record(name, None if mem is None and flops is None else
                       {**(mem or {}), **({"flops": flops}
                                          if flops is not None else {})},
                       seconds)
    return ours, theirs


def test_manifest_sums_equal_jax():
    records = [("train_chunk_k8", MEM, 0.5, 1e9),
               ("kv_decode_step", dict(MEM, temp_bytes=10,
                                       peak_bytes_est=130), 0.25, None),
               ("kv_decode_step", dict(MEM, temp_bytes=50,
                                       peak_bytes_est=170), 0.25, None),
               ("nvcc_paged_attention", None, 30.0, None)]
    ours, theirs = _both(records)
    got, want = ours.manifest(), theirs.manifest()
    assert got == want
    assert got["peak_hbm_bytes_est"] == 420 + 170
    assert got["programs"]["kv_decode_step"]["compiles"] == 2
    assert got["programs"]["kv_decode_step"]["temp_bytes"] == 50
    assert got["compile_total_s"] == 31.0


@pytest.mark.parametrize("change", ["same", "added", "grew", "flops",
                                    "removed"])
def test_diff_manifests_equal_jax(change):
    base = [("a", MEM, 1.0, 1e9), ("b", MEM, 1.0, None)]
    cur = {"same": base,
           "added": base + [("c", MEM, 1.0, None)],
           "grew": [("a", dict(MEM, temp_bytes=400), 1.0, 1e9),
                    ("b", MEM, 1.0, None)],
           "flops": [("a", MEM, 1.0, 2e9), ("b", MEM, 1.0, None)],
           "removed": base[:1]}[change]
    b_ours, b_theirs = _both(base)
    c_ours, c_theirs = _both(cur)
    got = xs.diff_manifests(c_ours.manifest(), b_ours.manifest())
    want = jxs.diff_manifests(c_theirs.manifest(), b_theirs.manifest())
    assert got == want
    assert bool(got) == (change != "same")


def test_observe_records_time_and_no_memory_on_the_cpu():
    ledger = xs.ProgramLedger()
    with ledger.observe("x", device="cpu"):
        pass
    with pytest.raises(KeyError):
        with ledger.observe("y", device="cpu"):
            raise KeyError("boom")
    rec = ledger.programs()
    assert set(rec) == {"x"} and rec["x"]["compiles"] == 1
    assert rec["x"]["peak_bytes_est"] == 0 and rec["x"]["flops"] is None
    assert ledger.first_call("z", (1,)) is not ledger.first_call("z", (1,))


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_kv_table_records_first_calls_under_jax_names(layout):
    sd = GPTLM(**SMALL, device="cpu").state_dict()
    kw = dict(kv_layout=layout, prefix_block=4, device="cpu")
    if layout == "paged":
        kw["paged_block"] = 4
    ledger = xs.ProgramLedger()
    watched = SlotKVCache(GPTLM(**SMALL, device="cpu"), sd, 2,
                          ledger=ledger, **kw)
    plain = SlotKVCache(GPTLM(**SMALL, device="cpu"), sd, 2, **kw)
    for kv in (watched, plain):
        kv.insert(np.arange(5, dtype=np.int32))
        kv.insert(np.arange(7, dtype=np.int32))
    toks = [[kv.advance() for _ in range(3)] for kv in (watched, plain)]
    assert all(np.array_equal(a, b) for a, b in zip(*toks))
    block = np.stack([watched.tokens, watched.tokens], axis=1)
    watched.verify_block(block)
    watched.verify_block(block)
    prefix = "kv_paged" if layout == "paged" else "kv"
    progs = ledger.programs()
    assert set(progs) == {f"{prefix}_prefill_chunk_l5",
                          f"{prefix}_prefill_chunk_l7",
                          f"{prefix}_decode_step", f"{prefix}_verify_w2"}
    assert all(r["compiles"] == 1 and r["compile_s"] > 0
               for r in progs.values())


def test_watch_builds_records_a_build_in_the_chosen_dir(tmp_path,
                                                         monkeypatch):
    """A stand-in ``nvcc`` (a script writing its ``-o`` file) through the
    real build path, with the library load stubbed."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!" + sys.executable + "\n"
                    "import sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'wb').write(b'lib')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "build_seconds", {})
    monkeypatch.setattr(_build, "build_logs", {})
    where = _build.set_build_dir(tmp_path / "cache")
    ledger = xs.ProgramLedger()
    with _build.watch_builds(ledger):
        lib = _build.load("paged_attention")
    assert str(lib).startswith(str(where))
    rec = ledger.programs()["nvcc_paged_attention"]
    assert rec["compiles"] == 1 and rec["compile_s"] > 0
    # loaded as built: no build, no record; outside the block, none either
    with _build.watch_builds(ledger):
        _build.load("paged_attention")
    (where / "flash_attention-x.so").write_text("")
    _build.load("flash_attention")
    assert set(ledger.programs()) == {"nvcc_paged_attention"}
    assert ledger.programs()["nvcc_paged_attention"]["compiles"] == 1


# ------------------------------------------------------------- analyze

def _lm_fn(batch_size, type="train"):  # noqa: A002 — harness API
    return tloaders.load_lm_dataset("lm_synth", split=type, seq_len=16,
                                    vocab_size=64, n_train=32, n_test=24)


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    """One port run with every sink on: health, the roofline, the
    timeline, a serve window; its trace, metrics and summary files."""
    from distributed_tensorflow_tpu_torch.utils import harness

    d = tmp_path_factory.mktemp("run")
    harness.run(harness.ExperimentConfig(
        model="gpt_tiny", dataset_fn=_lm_fn, batch_size=8, epochs=1,
        log_every=0, device="cpu", health="on", roofline=True,
        timeline=True, timeline_interval=0.0, serve_requests=3,
        serve_slots=2, serve_max_new=3, serve_prompt_len=4,
        trace_path=str(d / "trace.jsonl"),
        metrics_path=str(d / "metrics.jsonl"),
        result_path=str(d / "result.jsonl")))
    return d


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    return code, out.getvalue()


@pytest.mark.parametrize("cmd", [
    ["spans", "{d}/trace.jsonl"],
    ["export", "{d}/trace.jsonl", "-o", "{d}/out.json"],
    ["health", "{d}/metrics.jsonl"],
    ["serve", "{d}/trace.jsonl"],
    ["serve", "{d}/trace.jsonl", "--text"],
    ["diff", "{d}/result.jsonl", "{d}/result.jsonl"],
    ["timeline", "{d}/trace.jsonl"],
    ["timeline", "{d}/trace.jsonl", "--json"],
    ["programs", "{d}/result.jsonl"],
    ["programs", "{d}/result.jsonl", "--against", "{d}/result.jsonl"],
    ["roofline", "{d}/result.jsonl"],
    ["roofline", "{d}/result.jsonl", "--json", "--device",
     "NVIDIA H100 80GB HBM3", "--dtype", "f32"],
], ids=lambda c: "-".join(a for a in c if not a.startswith("{")))
def test_analyze_prints_jax_answers_from_port_files(run_files, cmd):
    argv = [a.format(d=run_files) for a in cmd]
    got = _run(analyze.main, argv)
    if cmd[0] == "export":
        ours = json.loads((run_files / "out.json").read_text())
    want = _run(janalyze.main, argv)
    if cmd[0] == "roofline" and "--device" in cmd:
        # the peak tables differ by design: JAX's knows no H100
        g, w = json.loads(got[1]), json.loads(want[1])
        assert g["device_kind"] == w["device_kind"]
        assert g["known_device"] and not w["known_device"]
        assert g["ridge_flops_per_byte"] == 67e12 / 3.35e12
        assert w["ridge_flops_per_byte"] is None
        assert len(g["programs"]) == len(w["programs"]) > 0
        return
    assert got == want
    assert got[0] == 0
    if cmd[0] == "export":
        assert ours == json.loads((run_files / "out.json").read_text())
        assert ours["traceEvents"]
    if cmd[0] == "health":
        sec = json.loads(got[1])
        assert sec["steps"] == 4 and sec["first_anomaly_step"] is None
