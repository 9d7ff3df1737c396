"""Data plug-in point (port of ``distributed_tensorflow_tpu.data``).

Host numpy datasets batched by the pipeline (shuffle examples, then batch);
the engine moves each batch to the device (``Engine.shard_batch``).  Only
the language-model datasets and the Python batching path are ported; the
device prefetcher and ``make_dataset_fn`` come with the CNN/MLP training
path (ROADMAP Queue 1).
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch.data.loaders import (  # noqa: F401
    Dataset, load_dataset, load_lm_dataset, synthetic_lm)
from distributed_tensorflow_tpu_torch.data.pipeline import (  # noqa: F401
    iter_batches, steps_per_epoch)
