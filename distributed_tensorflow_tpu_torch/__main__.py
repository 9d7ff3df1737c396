"""``python -m distributed_tensorflow_tpu_torch``: the CLI (``cli.main``)."""

from distributed_tensorflow_tpu_torch.cli import main

main()
