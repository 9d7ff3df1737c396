"""Per-program compile and memory ledger (port of
``observability/xla_stats.py``; the module keeps its name so a reader
finds its counterpart).

The JAX ledger records every compiled XLA program: its compile wall time
and its ``memory_analysis`` bytes.  PyTorch compiles no programs; what a
run builds and fixes in place on the card is this, and
:class:`ProgramLedger` observes it without changing what runs:

* each CUDA-graph capture: a training chunk (``engines/sync._ChunkGraph``
  in the sync and FSDP engines, named ``train_chunk_k<k>``) and a fused
  decode round (``serving/decode_graph.RoundGraph``, JAX's
  ``kv_decode_multi_k<k>`` and ``kv_paged_decode_multi_k<k>``);
* each kernel library that ``ops/_build.py`` builds with ``nvcc``
  (``nvcc_<source>``);
* the first eager call per shape signature of each KV-table entry point
  (prefill chunk, decode step, verify: JAX's program names).

Each record has ``compiles`` (captures, builds or first calls),
``compile_s`` (the capture's, build's or first call's wall time) and
the memory fields.  ``peak_bytes_est`` is the peak of the memory
allocated on the card during the observed region above what was
allocated before it (``torch.cuda`` memory statistics; observing resets
the device's peak statistic, so a caller reading
``torch.cuda.max_memory_allocated`` across an observed region reads the
peak since its start).  ``argument_bytes`` is what was allocated before
it, ``output_bytes`` what it left allocated, ``temp_bytes`` the peak
above both.  Fields with no torch counterpart (``generated_code_bytes``,
``alias_bytes``) stay 0, as JAX leaves them off-TPU; on the CPU every
memory field is 0.  ``flops`` is ``torch.utils.flop_counter``'s count of
an eager warm-up of the same work (a chunk's first run, never inside a
capture), else None; ``bytes_accessed`` is None.

``manifest()``, ``peak_hbm_bytes_est()`` and ``diff_manifests`` are the
JAX module's.  The ledger never changes what runs: a capture that fails
raises as it does without it.

Stdlib only at import: ``analyze programs`` imports ``diff_manifests``
without torch.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any

_MEM_FIELDS = ("argument_bytes", "output_bytes", "temp_bytes",
               "generated_code_bytes", "alias_bytes")


def _cuda_device(device):
    """``device`` as a CUDA device, or None (the CPU, or no device)."""
    if device is None:
        return None
    import torch

    device = torch.device(device)
    return device if device.type == "cuda" else None


class ProgramLedger:
    """Named per-program compile/memory records (module docstring).
    Thread-safe, as JAX's."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {compiles, compile_s, <memory fields>, flops, ...}
        self._programs: dict[str, dict[str, Any]] = {}
        self._seen: set = set()

    # ------------------------------------------------------------- capture
    @contextlib.contextmanager
    def observe(self, name: str, device=None, flops: float | None = None):
        """Time the region and read the card's memory around it (on a
        CUDA ``device``), then record it under ``name``.  An exception in
        the region propagates and records nothing."""
        dev = _cuda_device(device)
        mem = None
        if dev is not None:
            import torch

            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        yield
        if dev is not None:
            torch.cuda.synchronize(dev)
            after = torch.cuda.memory_allocated(dev)
            peak = torch.cuda.max_memory_allocated(dev)
            mem = {"argument_bytes": before,
                   "output_bytes": max(after - before, 0),
                   "temp_bytes": max(peak - max(after, before), 0),
                   "peak_bytes_est": max(peak - before, 0)}
        self._record(name, mem, time.perf_counter() - t0, flops)

    def first_call(self, name: str, signature, device=None):
        """``observe`` for the first call of ``name`` per ``signature``
        (a hashable shape key); a null context for every later one."""
        key = (name, signature)
        with self._lock:
            if key in self._seen:
                return contextlib.nullcontext()
            self._seen.add(key)
        return self.observe(name, device)

    def record(self, name: str, compile_s: float = 0.0,
               flops: float | None = None, **mem: int) -> None:
        """Record work observed elsewhere (a kernel build's wall time, a
        warm-up's FLOP count)."""
        self._record(name, mem or None, compile_s, flops)

    def add_flops(self, name: str, flops: float) -> None:
        """Set ``name``'s FLOP count (its eager warm-up's), keeping the
        largest seen, without counting a compile."""
        with self._lock:
            rec = self._programs.setdefault(name, self._fresh())
            rec["flops"] = (flops if rec["flops"] is None
                            else max(rec["flops"], flops))

    @staticmethod
    def _fresh() -> dict[str, Any]:
        return {"compiles": 0, "compile_s": 0.0,
                **{f: 0 for f in _MEM_FIELDS}, "peak_bytes_est": 0,
                # None until observed: "no data", never 0
                "flops": None, "bytes_accessed": None}

    def _record(self, name: str, mem: dict[str, int] | None,
                compile_s: float, flops: float | None = None) -> None:
        with self._lock:
            rec = self._programs.setdefault(name, self._fresh())
            rec["compiles"] += 1
            rec["compile_s"] += float(compile_s)
            # the same program captured again (another table, another
            # state) keeps its worst case
            for k, v in (mem or {}).items():
                rec[k] = max(rec.get(k) or 0, int(v))
            if flops is not None:
                rec["flops"] = (flops if rec["flops"] is None
                                else max(rec["flops"], flops))

    # ------------------------------------------------------------- reading
    def programs(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return {name: dict(rec)
                    for name, rec in sorted(self._programs.items())}

    def compile_total_s(self) -> float:
        with self._lock:
            return sum(rec["compile_s"] for rec in self._programs.values())

    def peak_hbm_bytes_est(self) -> int:
        """Per-run peak estimate: the per-program peaks SUMMED (every
        captured graph keeps its memory pool for the life of the run)."""
        with self._lock:
            return sum(rec["peak_bytes_est"]
                       for rec in self._programs.values())

    def manifest(self) -> dict[str, Any]:
        """JSON-ready ledger: the ``analyze programs`` input."""
        return {
            "schema_version": 1,
            "programs": self.programs(),
            "program_count": len(self._programs),
            "peak_hbm_bytes_est": self.peak_hbm_bytes_est(),
            "compile_total_s": self.compile_total_s(),
        }


def count_flops(fn, *args, **kwargs):
    """(result, FLOPs) of ``fn(*args, **kwargs)`` under
    ``torch.utils.flop_counter.FlopCounterMode``: the matmul and
    convolution FLOPs torch can attribute (a hand-written kernel's are
    not among them)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, float(counter.get_total_flops())


def diff_manifests(current: dict[str, Any], baseline: dict[str, Any],
                   temp_threshold: float = 0.10,
                   flops_threshold: float = 0.10) -> list[dict[str, Any]]:
    """Program-set drift between two manifests (JAX's function).

    Returns a list of findings; empty means no drift.  A finding is a
    program ADDED vs baseline, or one whose ``temp_bytes`` grew more than
    ``temp_threshold`` (relative; absolute growth when baseline is 0).
    FLOPs growth past ``flops_threshold`` WARNS (``severity: warn``) the
    way temp-bytes growth fails — more model work per call is worth a
    look but legitimate config changes move it, so it never exits the
    gate nonzero on its own; None columns compare as "no data" and are
    skipped.  Removed programs are reported as informational
    (``severity: info``) — shrinking the program set never fails the
    gate."""
    cur = current.get("programs", {})
    base = baseline.get("programs", {})
    findings: list[dict[str, Any]] = []
    for name in sorted(cur):
        if name not in base:
            findings.append({
                "severity": "fail", "kind": "program_added", "name": name,
                "detail": f"program {name!r} not in baseline"})
            continue
        t_cur = int(cur[name].get("temp_bytes", 0))
        t_base = int(base[name].get("temp_bytes", 0))
        if t_base <= 0:
            grew = t_cur > 0
            rel = None
        else:
            rel = (t_cur - t_base) / t_base
            grew = rel > temp_threshold
        if grew:
            findings.append({
                "severity": "fail", "kind": "temp_bytes_grew", "name": name,
                "baseline": t_base, "current": t_cur, "relative": rel,
                "threshold": temp_threshold,
                "detail": (f"temp bytes {t_base} -> {t_cur} "
                           f"(threshold {temp_threshold:.0%})")})
        f_cur = cur[name].get("flops")
        f_base = base[name].get("flops")
        if f_cur is not None and f_base is not None and f_base > 0:
            f_rel = (float(f_cur) - float(f_base)) / float(f_base)
            if f_rel > flops_threshold:
                findings.append({
                    "severity": "warn", "kind": "flops_grew", "name": name,
                    "baseline": f_base, "current": f_cur,
                    "relative": f_rel, "threshold": flops_threshold,
                    "detail": (f"flops {f_base:.3g} -> {f_cur:.3g} "
                               f"(threshold {flops_threshold:.0%})")})
    for name in sorted(set(base) - set(cur)):
        findings.append({
            "severity": "info", "kind": "program_removed", "name": name,
            "detail": f"program {name!r} gone vs baseline"})
    return findings
