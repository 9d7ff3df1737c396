"""End-of-run report (port of ``observability/report.py``): one
structured summary of how the run behaved.

A single dict (emitted as the harness's ``run_report`` event and carried
in the summary) with the JAX report's keys, answering the operational
questions a throughput number alone cannot:

* steady-state step time p50/p95 SPLIT from compile (the first chunk
  carries the first call's kernel builds, cuBLAS set-up and CUDA graph
  capture over its k entries; percentiles over the rest);
* which chunk shapes the drain actually dispatched (``chunk_sizes``);
* watchdog heartbeat/stall counts, prefetch starvation totals, metric
  sink drops — the "did telemetry or input starve the device" trio;
* the lease's outcome (``preempted``, ``lease``) and the straggler
  summary;
* the measured cost of the telemetry itself (``telemetry_overhead_s`` /
  ``_frac``).

``serve_section`` is the JAX package's stdlib-only function, copied
unchanged.  ``runtime_environment`` reports what makes a card's number
attributable: torch, CUDA and NCCL versions, the device's name and its
power limit, in place of JAX's ``jax_version``, ``xla_flags`` and
``libtpu_init_args``.  With the program ledger
(``xla_stats.ProgramLedger``) the report carries its manifest (``xla``)
and ``peak_hbm_bytes_est``; with a ``roofline.Roofline`` the
``roofline`` section (train and serve utilizations, the device's peaks,
the per-program attribution) and ``train_mfu``.
"""

from __future__ import annotations

import subprocess
from typing import Any

import torch

from distributed_tensorflow_tpu_torch.observability.sink import SCHEMA_VERSION


def _power_limit_w(index: int) -> float | None:
    """The card's power limit in watts as ``nvidia-smi`` reports it, or
    None where it cannot be read (a card may run below its maximum
    under load, so a time is attributable only beside its limit)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=10, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def runtime_environment() -> dict[str, Any]:
    """The execution-environment facts that make a card's numbers
    attributable across containers: the torch, CUDA and NCCL versions,
    the device's name and its power limit (watts).  The device fields
    are filled only where CUDA is already initialised — the report never
    initialises it — and degrade to None otherwise."""
    env: dict[str, Any] = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "nccl_version": None,
        "device_kind": None,
        "power_limit_w": None,
    }
    if torch.version.cuda:
        try:
            env["nccl_version"] = ".".join(
                map(str, torch.cuda.nccl.version()))
        except Exception:
            pass
    if torch.cuda.is_initialized():
        index = torch.cuda.current_device()
        env["device_kind"] = torch.cuda.get_device_name(index)
        env["power_limit_w"] = _power_limit_w(index)
    return env


def serve_section(summary: dict[str, Any] | None,
                  n_devices: int = 1, tracer=None) -> dict[str, Any] | None:
    """Normalize a ContinuousBatcher summary into the run-report/bench
    ``serve`` section: the per-request result objects are dropped (the
    section must stay JSON), and the per-chip rates — requests/sec (the
    round-7 headline) and goodput-under-SLO (the round-13 one, mirroring
    examples_per_sec_per_device) — are derived here so every surface
    divides by the same device count.  ``tracer`` (when enabled) adds the
    serve window's telemetry self-accounting — sink drop counter + span
    bookkeeping overhead, previously train-report-only — gated
    lower-is-better by `analyze diff`."""
    if summary is None:
        return None
    sec = {k: v for k, v in summary.items() if k != "results"}
    for key in ("serve_requests_per_sec", "serve_goodput_under_slo"):
        v = sec.get(key)
        sec[f"{key}_per_chip"] = (
            v / n_devices if isinstance(v, (int, float)) and n_devices
            else None)
    if tracer is not None and getattr(tracer, "enabled", False):
        tstats = tracer.stats()
        sec["serve_sink_dropped"] = tstats.get("dropped")
        sec["serve_sink_written"] = tstats.get("written")
        sec["serve_trace_overhead_s"] = tstats.get("overhead_s", 0.0)
    return sec


def build_run_report(fit_result: dict[str, Any], *,
                     watchdog=None, metrics_logger=None, tracer=None,
                     serve: dict[str, Any] | None = None,
                     timeline=None, ledger=None, roofline=None,
                     ) -> dict[str, Any]:
    """Assemble the run report from the Trainer's fit result and the live
    telemetry objects.  Every argument except ``fit_result`` is optional —
    absent subsystems report as None, so readers can distinguish
    "disabled" from "zero".  ``serve`` is a post-training serving window's
    section (``serve_section``) — serving gets the same trajectory and
    regression gating training has (`analyze diff` flattens the nested
    serve_* keys).

    ``ledger`` (``xla_stats.ProgramLedger``) adds its manifest as the
    ``xla`` section, with ``peak_hbm_bytes_est`` and the ledger's seconds
    in ``compile_total_s`` hoisted; ``roofline``
    (``roofline.Roofline``) adds the ``roofline`` section and
    ``train_mfu`` (only then: the key set without it is unchanged)."""
    st = fit_result.get("step_time") or {}
    elapsed = float(fit_result.get("elapsed") or 0.0)

    report: dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "steps": fit_result.get("steps"),
        # the measured value, even when it is 0.0 (an instantly-ending run
        # is a real observation); None only when fit never reported one —
        # `elapsed or None` used to collapse the two
        "elapsed_s": (float(fit_result["elapsed"])
                      if fit_result.get("elapsed") is not None else None),
        # resolved drain shape + the chunk lengths actually dispatched,
        # and WHY auto mode downshifted when it did (None: no clamp)
        "steps_per_call": fit_result.get("steps_per_call"),
        "steps_per_call_clamp": fit_result.get("steps_per_call_clamp"),
        "chunk_sizes": fit_result.get("chunk_sizes"),
        "prefetch_depth": fit_result.get("prefetch_depth"),
        # gradient-collective payload: wire bytes under --grad-compression
        # vs the raw (uncompressed) figure (None: stateless engine)
        "grad_allreduce_bytes": fit_result.get("grad_allreduce_bytes"),
        "grad_allreduce_bytes_raw": fit_result.get(
            "grad_allreduce_bytes_raw"),
        "grad_compression": fit_result.get("grad_compression"),
        # mixed-precision policy (--precision; parallel/precision.py) +
        # the per-device state footprint it moves: param bytes halve
        # under bf16 storage, optimizer bytes grow by a master policy's
        # f32 copy — both gated lower-is-better by `analyze diff`.
        # loss_scale is the fp16 skip-accounting section (None: policy
        # without dynamic scaling).
        "precision": fit_result.get("precision"),
        "param_bytes_per_device": fit_result.get("param_bytes_per_device"),
        "opt_state_bytes_per_device": fit_result.get(
            "opt_state_bytes_per_device"),
        "loss_scale": fit_result.get("loss_scale"),
        # communication/compute overlap (--grad-bucket-mb;
        # parallel/overlap.py): the bucket size in effect, and the
        # exposed-vs-hidden collective split the one-time probe measured
        # (exposed_s is the gated number — BASELINE.md; None = overlap
        # off or probe unsupported, distinguishable from a measured 0.0)
        "grad_bucket_mb": fit_result.get("grad_bucket_mb"),
        "grad_collective_exposed_s": (
            fit_result.get("collective_overlap") or {}).get("exposed_s"),
        "grad_collective_hidden_s": (
            fit_result.get("collective_overlap") or {}).get("hidden_s"),
        "collective_overlap": fit_result.get("collective_overlap"),
        # steady-state percentiles (compile excluded — see StepTimer)
        "compile_s": st.get("compile_s", st.get("first_step_s")),
        "step_time_p50_s": st.get("steady_p50_s"),
        "step_time_p95_s": st.get("steady_p95_s"),
        "step_time_mean_s": st.get("steady_mean_s"),
        # checkpoint cost split (BASELINE.md accounting rule): wait_s is
        # training-thread blocked time — the only part charged against
        # throughput — overlapped_s ran on the background writer behind
        # training.  None when the run had no checkpoint manager.
        "checkpoint_wait_s": fit_result.get("checkpoint_wait_s"),
        "checkpoint_overlapped_s": fit_result.get("checkpoint_overlapped_s"),
        "checkpoint_async": fit_result.get("checkpoint_async"),
        # elastic preemption tolerance (distributed_tensorflow_tpu/
        # elastic/): the graceful-drain outcome (the lease's should_stop
        # reason, None on a normal finish), the resume-side accounting of
        # an --elastic-restore run — preemption_lost_s (save → resume
        # wall-clock gap, the MLPerf time-to-quality cost of the
        # preemption) and resume_replay_steps (steps whose data position
        # could not be restored; 0 = exact resume), both gated
        # lower-is-better by `analyze diff` — plus the step the restore
        # came from, the lease arming record and the straggler summary.
        # None throughout when the run was not elastic — "not an elastic
        # run" stays distinguishable from a measured 0.
        "preempted": fit_result.get("preempted"),
        "preemption_lost_s": fit_result.get("preemption_lost_s"),
        "resume_replay_steps": fit_result.get("resume_replay_steps"),
        "restored_step": fit_result.get("restored_step"),
        "lease": fit_result.get("lease"),
        "stragglers": fit_result.get("stragglers"),
    }

    report["watchdog"] = None if watchdog is None else {
        "beats": watchdog.beats,
        "stall_episodes": watchdog.stall_episodes,
        "timeout_s": watchdog.timeout,
    }

    starvation = fit_result.get("prefetch_starvation")
    report["prefetch"] = None if starvation is None else {
        "depth": fit_result.get("prefetch_depth"),
        "starvation": starvation,
        "fill_wait_s": fit_result.get("prefetch_fill_wait_s"),
    }

    report["metrics_sink"] = None if metrics_logger is None else \
        metrics_logger.stats()

    # numeric-health summary (Trainer fit with the engine's health layer
    # on): anomaly record + run maxima of the per-step stats.  None when
    # health was off — "disabled" stays distinguishable from "healthy".
    report["health"] = fit_result.get("health")

    # serving window (--serve): requests/sec/chip + TTFT/ITL percentiles
    # of the post-training continuous-batching run.  None when serving was
    # off — the section, not its absence, is what `analyze diff` gates.
    report["serve"] = serve

    overhead = 0.0
    if tracer is not None and tracer.enabled:
        report["spans"] = tracer.span_summary()
        tstats = tracer.stats()
        # an ENABLED tracer always reports a dict — written/dropped are
        # ints for a file-backed sink (0 = enabled but idle), None for an
        # aggregate-only tracer (no file).  The old `... or None` collapsed
        # enabled-but-idle into the same None as disabled.
        report["trace"] = {"written": tstats.get("written"),
                           "dropped": tstats.get("dropped")}
        overhead += tracer.overhead_s
    else:
        report["spans"] = None
        report["trace"] = None
    if metrics_logger is not None:
        overhead += getattr(metrics_logger, "overhead_s", 0.0)

    # --timeline sections (None when sampling or the ledger is off —
    # "disabled" stays distinguishable from "measured zero"): `timeline`,
    # per-series digests + the sampler's own measured cost (the < 1%
    # budget is reported, not assumed); `xla`, the program ledger's
    # manifest, with peak_hbm_bytes_est (the per-program peaks summed)
    # and compile_total_s (the `compile` span total + the ledger's
    # captures, builds and first calls) hoisted for `analyze diff`.
    compile_span_s = 0.0
    if tracer is not None and tracer.enabled:
        compile_span_s = (tracer.span_summary().get("compile") or
                          {}).get("total_s", 0.0)
    if timeline is not None:
        report["timeline"] = {
            "interval_s": timeline.interval_s,
            "overhead_s": round(timeline.overhead_s, 6),
            "overhead_frac": (round(timeline.overhead_s / elapsed, 6)
                              if elapsed > 0 else None),
            "series": timeline.summary(),
        }
        overhead += timeline.overhead_s
    else:
        report["timeline"] = None
    if ledger is not None:
        manifest = ledger.manifest()
        report["xla"] = manifest
        report["peak_hbm_bytes_est"] = manifest["peak_hbm_bytes_est"]
        report["compile_total_s"] = round(
            compile_span_s + manifest["compile_total_s"], 6)
    else:
        report["xla"] = None
        report["peak_hbm_bytes_est"] = None
        report["compile_total_s"] = (round(compile_span_s, 6)
                                     if compile_span_s else None)

    # --roofline section, ONLY when a Roofline was given (the key set
    # without it is unchanged): the train half echoes the Trainer's
    # roofline keys, the serve half the serve section's own roofline
    # block, and `programs` is the per-program attribution table from the
    # ledger's manifest (intensity, bound, attainable fraction of peak;
    # None columns where the ledger measured no FLOPs or bytes)
    if roofline is not None:
        from distributed_tensorflow_tpu_torch.observability.roofline import (
            flops_crosscheck, program_attribution)

        rf_train = {
            "model_flops_per_step": fit_result.get(
                "train_model_flops_per_step"),
            "achieved_flops_per_sec": fit_result.get(
                "train_achieved_flops_per_sec"),
            "mfu": fit_result.get("train_mfu"),
        }
        programs = None
        if ledger is not None:
            manifest = report["xla"] or {}
            programs = program_attribution(
                manifest.get("programs", {}),
                peaks=roofline.peaks, dtype=roofline.dtype)
            # the measured-vs-analytic cross-check on the training chunk
            # (None when either side is missing): a captured chunk
            # ``train_chunk_k<k>`` counted k steps' FLOPs
            name, xla_train = next(
                ((name, rec.get("flops"))
                 for name, rec in manifest.get("programs", {}).items()
                 if "train" in name and rec.get("flops")), (None, None))
            steps = (int(name.rpartition("_k")[2])
                     if name and name.startswith("train_chunk_k") else 1)
            model = rf_train["model_flops_per_step"]
            rf_train["xla_flops_crosscheck"] = flops_crosscheck(
                model * steps if model else None, xla_train)
        report["roofline"] = {
            "device": roofline.describe(),
            "train": rf_train,
            "serve": (serve or {}).get("roofline"),
            "programs": programs,
        }
        # hoisted for `analyze diff`'s higher-is-better gate
        report["train_mfu"] = fit_result.get("train_mfu")

    # execution environment (torch, CUDA and NCCL versions, the card and
    # its power limit): report trajectories stay attributable across
    # containers and power caps
    report["environment"] = runtime_environment()

    # the telemetry's own measured cost, against the run's wall clock —
    # this is the number the 5%-overhead acceptance bound reads
    report["telemetry_overhead_s"] = round(overhead, 6)
    report["telemetry_overhead_frac"] = (
        round(overhead / elapsed, 6) if elapsed > 0 else None)
    return report
