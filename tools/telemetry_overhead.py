"""What the telemetry costs the cli-lm run: the tracer's host cost per
record, and window L1 of ``chip_smoke.py`` with the telemetry off and on.

    python3 tools/telemetry_overhead.py [--records 20000] [--runs 2]

1. ``Tracer`` spans in a tight loop, each span also a
   ``record_function`` region (and an NVTX range once CUDA is
   initialised): aggregate-only, then file-backed (a JSONL sink whose
   writer thread runs beside the loop), then file-backed with a device
   synchronise inside every span (as the Trainer's ``materialize`` span
   holds one).  One JSON line each: microseconds per span of wall time
   and of the tracer's own ``overhead_s``.
2. ``cli.main`` of window L1's argv (the cli-lm GPT, f32, 512 steps in
   chunks of 8, ``--sample``, the paged ``--serve`` window) with no
   telemetry flag and with ``--metrics-path``, ``--trace`` and
   ``--timeline``, in the order off, on, on, off (``--runs 2``: each side
   twice).  One JSON line per run: the fit's step p50, the serve
   window's tokens/s, TTFT p50 and ITL p50, the span table's serve spans,
   and the report's telemetry overhead share.

The line before the last is the card's name and power limit
(``nvidia-smi``); the device path needs a CUDA card (``--device cpu``
runs part 1 only, for a rehearsal).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from distributed_tensorflow_tpu_torch import cli  # noqa: E402
from distributed_tensorflow_tpu_torch.observability import Tracer  # noqa: E402


def spans(records: int, tmp: str, device: str) -> None:
    """Part 1: per-span cost of the three tracers."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    for label, path, synced in (("aggregate", None, False),
                                ("file", f"{tmp}/spans.jsonl", False),
                                ("file+sync", f"{tmp}/spans_sync.jsonl",
                                 True)):
        tracer = Tracer(path=path)
        t0 = time.perf_counter()
        for i in range(records):
            with tracer.span("materialize", steps=8):
                if synced:
                    sync()
        wall = time.perf_counter() - t0
        tracer.close()
        print(json.dumps({"part": "spans", "tracer": label,
                          "records": records,
                          "us_per_span": wall / records * 1e6,
                          "overhead_us_per_span":
                              tracer.overhead_s / records * 1e6}))


def l1_runs(runs: int, tmp: str) -> None:
    """Part 2: window L1 with the telemetry off and on, alternated."""
    from chip_smoke import CLI_L1_ARGV

    order = (["off", "on"] + ["on", "off"]) * ((runs + 1) // 2)
    for i, side in enumerate(order[:2 * runs]):
        extra = ([] if side == "off" else
                 ["--metrics-path", f"{tmp}/m{i}.jsonl", "--trace",
                  f"{tmp}/t{i}.jsonl", "--timeline"])
        with contextlib.redirect_stdout(io.StringIO()):
            sm = cli.main(CLI_L1_ARGV + extra)
        rr, sv = sm["run_report"], sm["serve"]
        print(json.dumps({
            "part": "L1", "run": i, "telemetry": side,
            "step_ms_p50": rr["step_time_p50_s"] * 1e3,
            "serve_tokens_per_sec": sv["serve_tokens_per_sec"],
            "ttft_p50_s": sv["serve_ttft_p50_s"],
            "itl_p50_s": sv["serve_itl_p50_s"],
            "decode_step_spans_s": rr["spans"].get("decode_step"),
            "telemetry_overhead_frac": rr["telemetry_overhead_frac"]}))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--records", type=int, default=20000)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("telemetry_overhead: no CUDA device", file=sys.stderr)
            return 2
        torch.zeros(1, device="cuda")   # CUDA initialised: NVTX ranges on
    with tempfile.TemporaryDirectory() as tmp:
        spans(args.records, tmp, args.device)
        if args.device == "cuda":
            l1_runs(args.runs, tmp)
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True)
            print(card.stdout.strip())
    print(json.dumps({"ok": True, "device": args.device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
