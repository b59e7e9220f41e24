"""Data layer: synthetic planted data, the streaming batcher and the binary
row files (the reference's ``data`` exports). The CIFAR-10 and MNIST
loaders (``load_cifar10``, ``load_CIFAR_10_data``, ``unpickle``,
``preprocess``, ``load_mnist``, ``read_idx``) are not ported yet (ROADMAP.md
Queue 1 item 16b)."""

from distributed_eigenspaces_tpu_torch.data.bin_stream import (
    bin_block_stream,
    write_rows,
)
from distributed_eigenspaces_tpu_torch.data.stream import (
    block_stream,
    make_batches,
    synthetic_stream,
)
from distributed_eigenspaces_tpu_torch.data.synthetic import (
    PlantedSpectrum,
    planted_spectrum,
)

__all__ = [
    "bin_block_stream",
    "write_rows",
    "planted_spectrum",
    "PlantedSpectrum",
    "block_stream",
    "make_batches",
    "synthetic_stream",
]
