"""Data plug-in point (port of ``distributed_tensorflow_tpu.data``).

Host numpy datasets batched by the pipeline (shuffle examples, then batch);
``DevicePrefetch`` stages each batch on the device ahead of the training
step (``Engine.shard_batch`` places it).  The native C++ batcher and
``make_dataset_fn`` are not ported.
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch.data.device_prefetch import (  # noqa: F401
    DevicePrefetch)
from distributed_tensorflow_tpu_torch.data.loaders import (  # noqa: F401
    Dataset, load_dataset, load_lm_dataset, load_text_dataset,
    synthetic_classification, synthetic_lm, synthetic_text_classification)
from distributed_tensorflow_tpu_torch.data.pipeline import (  # noqa: F401
    iter_batches, steps_per_epoch)
