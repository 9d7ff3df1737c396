"""Parallel building blocks (port of ``distributed_tensorflow_tpu.parallel``).

Ported: ``mesh`` and ``collectives`` on ``torch.distributed`` (NCCL on the
card, gloo on the CPU), ``ring_attention.dense_attention`` and the int8
channel codec of ``compression``.
"""
