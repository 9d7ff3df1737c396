"""Parallel building blocks (port of ``distributed_tensorflow_tpu.parallel``).

Ported: ``mesh`` (the 1-D data mesh and (data, seq) meshes on sub-groups)
and ``collectives`` on ``torch.distributed`` (NCCL on the card, gloo on
the CPU), ``ring_attention`` (dense attention, the ring and Ulysses
schedules), ``precision`` and the int8 channel codec of
``compression``.
"""
