"""MNIST IDX loader (BASELINE.md eval config 3: MNIST-784 streaming).

The port's copy of ``distributed_eigenspaces_tpu/data/mnist.py`` (which
imports no JAX), unchanged.

The reference ships only a CIFAR pickle loader (``load_data.py:8-50``); the
MNIST config in BASELINE.json needs the classic IDX format (the
``train-images-idx3-ubyte`` files from yann.lecun.com), which this module
parses directly — magic header, big-endian dims, raw ubyte payload —
with transparent ``.gz`` support and the same ``(data, labels)`` return
shape as :func:`..cifar.load_cifar10`.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_IDX_DTYPES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (optionally gzipped) into a numpy array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zeros, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zeros != 0 or dtype_code not in _IDX_DTYPES:
            raise ValueError(f"{path}: not an IDX file (magic {zeros:#x} "
                             f"{dtype_code:#x})")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        dt = _IDX_DTYPES[dtype_code]
        raw = f.read()
    n_items = int(np.prod(dims)) if dims else 0
    arr = np.frombuffer(raw, dtype=dt, count=n_items)
    return arr.reshape(dims)


def _find(data_dir: str, stem: str) -> str | None:
    for name in (stem, stem + ".gz", stem.replace("-idx", ".idx"),
                 stem.replace("-idx", ".idx") + ".gz"):
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            return p
    return None


def load_mnist(
    data_dir: str,
    *,
    split: str = "train",
    flatten: bool = True,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Load MNIST: ``(N, 784) float32`` images (pixel values 0..255, like
    the CIFAR loader keeps raw scale) plus ``(N,)`` integer labels.

    ``split`` is ``"train"`` (60k) or ``"test"``/``"t10k"`` (10k).
    """
    prefix = "train" if split == "train" else "t10k"
    img_path = _find(data_dir, f"{prefix}-images-idx3-ubyte")
    lbl_path = _find(data_dir, f"{prefix}-labels-idx1-ubyte")
    if img_path is None or lbl_path is None:
        raise FileNotFoundError(
            f"MNIST IDX files for split {split!r} not found in {data_dir}"
        )
    images = read_idx(img_path)
    labels = read_idx(lbl_path).astype(np.int64)
    if images.ndim != 3:
        raise ValueError(f"{img_path}: expected (N, 28, 28), got "
                         f"{images.shape}")
    if flatten:
        images = images.reshape(images.shape[0], -1)
    return images.astype(dtype), labels


def write_idx(path: str, arr: np.ndarray) -> None:
    """Write an array as an IDX file (test fixtures / dataset prep)."""
    codes = {np.dtype(np.uint8): 0x08, np.dtype(np.int8): 0x09}
    code = codes.get(arr.dtype)
    if code is None:
        raise ValueError(f"unsupported IDX dtype {arr.dtype}")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, code, arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(np.ascontiguousarray(arr).tobytes())
