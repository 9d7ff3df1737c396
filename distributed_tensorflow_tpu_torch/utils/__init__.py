"""Utilities (port of ``distributed_tensorflow_tpu.utils``).

Ported: ``metrics.StepTimer``, ``wire`` (the reference's framing),
``supervisor`` (``ResultSink``, ``SupervisorListener``) and a slim
``harness`` (``ExperimentConfig``, ``run``, ``steps_to_accuracy``).  The
checkpoint, failure and profiling modules are later work (ROADMAP
Queue 1).
"""
