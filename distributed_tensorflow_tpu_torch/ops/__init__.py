"""Hand-written Hopper kernels (port of ``distributed_tensorflow_tpu.ops``).

Each module holds a kernel's wrapper, its plain PyTorch version and its
launch count; the CUDA sources live in ``csrc/`` and are built at first
use (``_build``).

``COUNT_LOCK`` guards every launch counter's update: the replicas of a
serving fleet launch the same kernels from several threads, and a bare
``+=`` on an attribute can lose a count between two of them.
"""

import threading

COUNT_LOCK = threading.Lock()
