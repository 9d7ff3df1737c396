"""Utilities (port of ``distributed_tensorflow_tpu.utils``).

Ported: ``metrics`` (``StepTimer``, ``MetricsLogger``, the
``torch.profiler`` window ``profile``), ``wire`` (the reference's
framing), ``supervisor`` (``ResultSink`` with the ``preempted`` notice,
``SupervisorListener``), a slim ``harness`` (``ExperimentConfig``,
``run``, ``steps_to_accuracy``), ``optim``, ``checkpoint``
(``CheckpointManager``, ``AsyncCheckpointManager``) and ``failure``
(``Watchdog``, ``run_with_recovery``).
"""
