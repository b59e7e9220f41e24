"""The port's dataset loaders (``data/cifar.py``, ``data/mnist.py``,
``data/npy_dir.py``) and the native grayscale kernel against the
reference's, on small files written here (no dataset is in the repository):
every result bit-equal, every refusal the same exception and message.
"""

import pickle

import numpy as np
import pytest

import distributed_eigenspaces_tpu.data.cifar as jcifar
import distributed_eigenspaces_tpu.data.mnist as jmnist
import distributed_eigenspaces_tpu.data.npy_dir as jnpy
import distributed_eigenspaces_tpu.runtime.native as jnative
import distributed_eigenspaces_tpu_torch.data as tdata
from distributed_eigenspaces_tpu_torch.data import cifar, mnist, npy_dir
from distributed_eigenspaces_tpu_torch.runtime import native


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for key in a:
            _equal(a[key], b[key])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _raised(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the exception is the result here
        return type(e), str(e)
    return None


@pytest.fixture()
def cifar_dir(tmp_path):
    """A CIFAR-10 directory in the pickle format: two batches of ``b"data"``
    (N, 3072) uint8 rows, filenames and labels, and the two files the loader
    skips."""
    rng = np.random.default_rng(7)
    for b in range(2):
        batch = {
            b"data": rng.integers(0, 256, (20, 3072), dtype=np.uint8),
            b"filenames": [f"img_{b}_{i}.png".encode() for i in range(20)],
            b"labels": [int(i % 10) for i in range(20)],
        }
        with open(tmp_path / f"data_batch_{b + 1}", "wb") as f:
            pickle.dump(batch, f)
    (tmp_path / "readme.html").write_text("<html></html>")
    with open(tmp_path / "batches.meta", "wb") as f:
        pickle.dump({b"label_names": [b"airplane"]}, f)
    return str(tmp_path)


@pytest.mark.parametrize("negatives", [False, True])
def test_cifar_batches_are_the_references(cifar_dir, negatives):
    _equal(cifar.load_CIFAR_10_data(cifar_dir, negatives=negatives),
           jcifar.load_CIFAR_10_data(cifar_dir, negatives=negatives))
    assert cifar.load_CIFAR_10_data(cifar_dir)[0].shape == (40, 32, 32, 3)


@pytest.mark.parametrize("grayscale", [True, False])
def test_cifar_rows_are_the_references(cifar_dir, grayscale):
    _equal(cifar.load_cifar10(cifar_dir, grayscale=grayscale),
           jcifar.load_cifar10(cifar_dir, grayscale=grayscale))
    data = cifar.load_CIFAR_10_data(cifar_dir)[0]
    for dtype in (np.float32, np.float64):
        _equal(cifar.preprocess(data, grayscale=grayscale, dtype=dtype),
               jcifar.preprocess(data, grayscale=grayscale, dtype=dtype))
    _equal(cifar.unpickle(cifar_dir + "/data_batch_1"),
           jcifar.unpickle(cifar_dir + "/data_batch_1"))


def test_cifar_refusals_are_the_references(tmp_path):
    assert _raised(cifar.unpickle, "/nonexistent/batch") == \
        _raised(jcifar.unpickle, "/nonexistent/batch")
    got = _raised(cifar.load_CIFAR_10_data, str(tmp_path))
    assert got[0] is FileNotFoundError and got == _raised(jcifar.load_CIFAR_10_data,
                                                           str(tmp_path))


def test_native_grayscale_is_the_references():
    """``u8_nhwc_to_gray_f32`` (``native/loader.cc``) and its numpy
    fallback, each bit-equal to the reference's, and to each other within
    the one rounding of a mean."""
    rng = np.random.default_rng(3)
    for shape in ((5, 32, 32, 3), (17, 4, 6, 3), (2, 3, 3, 1)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        got = native.to_gray_f32(img)
        assert got.shape == (shape[0], shape[1] * shape[2]) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jnative.to_gray_f32(img))
        np.testing.assert_allclose(got, img.astype(np.float32).mean(axis=3).reshape(
            shape[0], -1), rtol=1e-6)
    assert native.native_available() == jnative.native_available()


def test_grayscale_fallback_without_the_native_library(monkeypatch):
    img = np.random.default_rng(4).integers(0, 256, (3, 4, 4, 3), dtype=np.uint8)
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    np.testing.assert_array_equal(native.to_gray_f32(img), jnative.to_gray_f32(img))


@pytest.fixture()
def mnist_dir(tmp_path):
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (50, 28, 28), dtype=np.uint8)
    lbls = rng.integers(0, 10, (50,), dtype=np.uint8)
    jmnist.write_idx(str(tmp_path / "train-images-idx3-ubyte"), imgs)
    jmnist.write_idx(str(tmp_path / "train-labels-idx1-ubyte.gz"), lbls)
    return tmp_path


def test_mnist_is_the_references(mnist_dir, tmp_path):
    _equal(mnist.load_mnist(str(mnist_dir)), jmnist.load_mnist(str(mnist_dir)))
    arr = np.random.default_rng(2).integers(0, 256, (7, 5), dtype=np.uint8)
    for name in ("a.idx", "a.idx.gz"):
        mnist.write_idx(str(tmp_path / name), arr)
        _equal(mnist.read_idx(str(tmp_path / name)), jmnist.read_idx(str(tmp_path / name)))
    mnist.write_idx(str(tmp_path / "p.idx"), arr)
    jmnist.write_idx(str(tmp_path / "r.idx"), arr)
    assert (tmp_path / "p.idx").read_bytes() == (tmp_path / "r.idx").read_bytes()


def test_mnist_refusals_are_the_references(tmp_path):
    assert _raised(mnist.load_mnist, str(tmp_path))[0] is FileNotFoundError
    assert _raised(mnist.load_mnist, str(tmp_path)) == _raised(jmnist.load_mnist,
                                                               str(tmp_path))
    bad = tmp_path / "bad.idx"
    bad.write_bytes(b"\xff\xff\xff\xff" + b"0" * 16)
    assert _raised(mnist.read_idx, str(bad))[0] is ValueError
    assert _raised(mnist.read_idx, str(bad)) == _raised(jmnist.read_idx, str(bad))


def test_row_dir_is_the_references(tmp_path):
    rng = np.random.default_rng(9)
    np.save(tmp_path / "a_rows.npy", rng.standard_normal((10, 48)).astype(np.float32))
    np.save(tmp_path / "b_patches.npy", rng.standard_normal((6, 4, 4, 3)).astype(np.float32))
    rng.standard_normal((8, 48)).astype(np.float32).tofile(tmp_path / "c.bin")
    for max_rows in (None, 11, 24):
        got = npy_dir.load_rows_dir(str(tmp_path), 48, max_rows=max_rows)
        want = jnpy.load_rows_dir(str(tmp_path), 48, max_rows=max_rows)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("case", ["empty", "width", "ragged"])
def test_row_dir_refusals_are_the_references(tmp_path, case):
    if case == "width":
        np.save(tmp_path / "bad.npy", np.zeros((4, 7), np.float32))
    elif case == "ragged":
        (tmp_path / "ragged.bin").write_bytes(b"\x00" * 33)
    got = _raised(npy_dir.load_rows_dir, str(tmp_path), 8)
    assert got is not None and got == _raised(jnpy.load_rows_dir, str(tmp_path), 8)
    assert got[0] is (FileNotFoundError if case == "empty" else ValueError)


def test_data_package_exports_the_loaders():
    for name in ("load_cifar10", "load_CIFAR_10_data", "unpickle", "preprocess",
                 "load_mnist", "read_idx"):
        assert name in tdata.__all__ and getattr(tdata, name) is getattr(
            cifar if hasattr(cifar, name) else mnist, name)
