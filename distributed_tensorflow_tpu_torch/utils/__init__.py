"""Utilities (port of ``distributed_tensorflow_tpu.utils``).

Ported: ``metrics.StepTimer``, ``wire`` (the reference's framing),
``supervisor`` (``ResultSink``, ``SupervisorListener``), a slim
``harness`` (``ExperimentConfig``, ``run``, ``steps_to_accuracy``),
``optim``, ``checkpoint`` (``CheckpointManager``,
``AsyncCheckpointManager``) and ``failure`` (``Watchdog``,
``run_with_recovery``).  The profiling helpers are later work (ROADMAP
Queue 1).
"""
