"""Hand-written Hopper kernels (port of ``distributed_tensorflow_tpu.ops``).

Each module holds a kernel's wrapper, its plain PyTorch version and its
launch count; the CUDA sources live in ``csrc/`` and are built at first
use (``_build``).
"""
