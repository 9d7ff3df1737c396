"""Parallel building blocks (port of ``distributed_tensorflow_tpu.parallel``).

Only the single-device pieces the paged serving path needs are ported so
far: ``ring_attention.dense_attention`` and the int8 channel codec of
``compression``.
"""
