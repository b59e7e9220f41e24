"""Data layer: the CIFAR-10 and MNIST loaders, synthetic planted data, the
streaming batcher and the binary row files (the reference's ``data``
exports). User row directories load with ``data.npy_dir.load_rows_dir``;
``data.mnist.write_idx`` writes the IDX format."""

from distributed_eigenspaces_tpu_torch.data.bin_stream import (
    bin_block_stream,
    write_rows,
)
from distributed_eigenspaces_tpu_torch.data.cifar import (
    load_CIFAR_10_data,
    load_cifar10,
    preprocess,
    unpickle,
)
from distributed_eigenspaces_tpu_torch.data.mnist import load_mnist, read_idx
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
    "load_mnist",
    "read_idx",
    "bin_block_stream",
    "write_rows",
    "unpickle",
    "load_cifar10",
    "load_CIFAR_10_data",
    "preprocess",
    "planted_spectrum",
    "PlantedSpectrum",
    "block_stream",
    "make_batches",
    "synthetic_stream",
]
