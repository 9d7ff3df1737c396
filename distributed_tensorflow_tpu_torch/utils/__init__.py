"""Utilities (port of ``distributed_tensorflow_tpu.utils``).

Only ``metrics.StepTimer`` is ported, for the ``Trainer``; the checkpoint,
failure, supervisor and harness modules are later work (ROADMAP Queue 1).
"""
