"""CIFAR-10 pickle loader — feature parity with reference ``load_data.py``.

The port's copy of ``distributed_eigenspaces_tpu/data/cifar.py`` (which
imports no JAX), on the port's native kernels (``runtime/native.py``).

Same on-disk format (the python-pickle CIFAR batches), same public result
``(data, filenames, labels)`` with data in (N, 32, 32, 3) layout, plus the
preprocessing the reference applied inline at ``distributed.py:170-173``
(channel-mean grayscale + flatten) made explicit and optional — the RGB
3072-d path is first-class because BASELINE.md's CIFAR config requires it
(SURVEY.md §2.2-B7).
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np

# Reference `UNUSED_FILES` (load_data.py:5): non-batch files in the dir.
UNUSED_FILES = ("readme.html", "batches.meta")


def unpickle(path: str):
    """Decode one CIFAR batch pickle (reference ``load_data.py:8-15``)."""
    with open(path, "rb") as fo:
        return pickle.load(fo, encoding="bytes")


def _assemble(paths, negatives: bool):
    """vstack batches, reshape to (N, 32, 32, 3) (reference ``load_data.py:18-33``).

    ``negatives=True`` gives float32 NHWC; False gives the uint8 rollaxis
    path — both kept for parity.
    """
    chunks, filenames, labels = [], [], []
    for p in paths:
        d = unpickle(p)
        chunks.append(d[b"data"])
        filenames += list(d[b"filenames"])
        labels += list(d[b"labels"])
    data = np.vstack(chunks).reshape((-1, 3, 32, 32))
    if negatives:
        data = data.transpose(0, 2, 3, 1).astype(np.float32)
    else:
        data = np.rollaxis(data, 1, 4)
    return data, np.array(filenames), np.array(labels)


def load_CIFAR_10_data(data_dir: str, negatives: bool = False):
    """Reference-identical entry point (``load_data.py:36-50``): glob the dir,
    drop metadata files, return ``(data (N,32,32,3), filenames, labels)``."""
    paths = sorted(glob.glob(os.path.join(data_dir, "*")))
    skip = {os.path.join(data_dir, u) for u in UNUSED_FILES}
    paths = [p for p in paths if p not in skip]
    if not paths:
        raise FileNotFoundError(f"no CIFAR batch files under {data_dir!r}")
    return _assemble(paths, negatives)


def preprocess(
    images: np.ndarray, *, grayscale: bool = True, dtype=np.float32
) -> np.ndarray:
    """(N, H, W, C) images -> (N, d) feature rows.

    ``grayscale=True`` reproduces the reference CLI path
    (``distributed.py:170-173``): channel mean then flatten to H*W (1024-d
    for CIFAR). ``grayscale=False`` flattens all channels (3072-d), the
    BASELINE.md CIFAR config. uint8 input takes the native C++ conversion
    kernels (``native/loader.cc``); anything else the numpy path.
    """
    images = np.asarray(images)
    if images.dtype == np.uint8 and dtype == np.float32 and images.ndim == 4:
        from distributed_eigenspaces_tpu_torch.runtime.native import (
            to_f32,
            to_gray_f32,
        )

        if grayscale:
            return to_gray_f32(images)
        return to_f32(images).reshape(images.shape[0], -1)
    x = images.astype(dtype)
    if grayscale:
        x = x.mean(axis=3)
    return x.reshape(x.shape[0], -1)


def load_cifar10(
    data_dir: str, *, grayscale: bool = True, dtype=np.float32
):
    """One-call loader: pickles -> (N, d) rows + labels, with the B7 toggle."""
    data, _, labels = load_CIFAR_10_data(data_dir)
    return preprocess(data, grayscale=grayscale, dtype=dtype), labels
