"""``scripts/torch_real_data_check.py`` on the CPU, in process: the offline
contract of ``scripts/real_data_check.py`` on the port's loaders and
``run_eval``. Real files on disk run the real-data eval (the report says
``"data": "real"``, never a silent synthetic fallback), a synthesized rows
corpus is labelled ``synthesized-on-disk``, missing data exits 3 and an
unknown config 2. Nothing is fetched."""

import contextlib
import gzip
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu_torch.data.mnist import write_idx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


check = _load("torch_real_data_check")


def _run(*args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = check.main([*args, "--offline", "--steps", "2", "--device", "cpu"])
    lines = out.getvalue().strip().splitlines()
    return rc, [json.loads(x) for x in lines], err.getvalue()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one eval at mnist784's width: torch's intra-op threads and numpy's BLAS
    # threads only contend with each other and the other test workers
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # numpy keeps its own thread count
        threadpool_limits = None
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    limits = threadpool_limits(1) if threadpool_limits is not None else None
    yield
    if limits is not None:
        limits.restore_original_limits()
    torch.set_num_threads(n)


# one step's rows (8 x 1024) and a window to spare: run_eval samples windows
MNIST_ROWS = 9216


def _mnist_arrays():
    rng = np.random.default_rng(0)
    return {"train-images-idx3-ubyte": rng.integers(0, 256, (MNIST_ROWS, 28, 28),
                                                    dtype=np.uint8),
            "train-labels-idx1-ubyte": rng.integers(0, 10, (MNIST_ROWS,), dtype=np.uint8)}


def test_offline_mnist_runs_on_real_data(tmp_path):
    d = tmp_path / "mnist"
    d.mkdir()
    for name, arr in _mnist_arrays().items():
        write_idx(str(d / name), arr)
    rc, reps, err = _run("mnist784", "--data-dir", str(tmp_path))
    assert rc == 0, err[-1500:]
    [rep] = reps
    assert rep["data"] == "real" and rep["dim"] == 784 and rep["steps"] == 2
    assert rep["data_source"]["kind"] == "mnist" and rep["data_source"]["rows"] == MNIST_ROWS
    assert 0.0 <= rep["principal_angle_deg"] <= 90.0
    assert rep["device"]["platform"] == "cpu"
    assert "source" not in rep


def test_offline_accepts_gz_archives(tmp_path):
    """--offline decompresses pre-placed .gz archives (no network needed),
    and the files then read as the IDX pair."""
    from distributed_eigenspaces_tpu_torch.data.mnist import load_mnist

    d = tmp_path / "mnist"
    d.mkdir()
    arrays = _mnist_arrays()
    for name, arr in arrays.items():
        raw = tmp_path / name
        write_idx(str(raw), arr)
        with open(raw, "rb") as f_in, gzip.open(d / (name + ".gz"), "wb") as f_out:
            f_out.write(f_in.read())
    assert check.prepare_mnist(str(tmp_path), offline=True) == str(d)
    images, labels = load_mnist(str(tmp_path))
    assert images.shape == (MNIST_ROWS, 784)
    np.testing.assert_array_equal(labels, arrays["train-labels-idx1-ubyte"])


@pytest.mark.parametrize("name", ["cifar10", "mnist784"])
def test_offline_missing_data_exits_3(tmp_path, name):
    rc, reps, err = _run(name, "--data-dir", str(tmp_path))
    assert rc == 3 and reps == []
    assert "could not obtain" in err


def test_unknown_config_exits_2(tmp_path):
    rc, reps, err = _run("synthetic1024", "--data-dir", str(tmp_path))
    assert rc == 2 and "real-data configs are" in err


def test_synthesized_clip768_corpus_is_labelled(tmp_path):
    rc, reps, err = _run("clip768", "--data-dir", str(tmp_path))
    assert rc == 0, err[-1500:]
    [rep] = reps
    assert rep["data"] == "real" and rep["source"] == "synthesized-on-disk"
    assert rep["data_source"]["dir"].endswith("clip768")
    assert sorted(os.listdir(tmp_path / "clip768")) == ["embeddings_000.npy",
                                                        "embeddings_001.bin"]
    assert rep["reference_angles_deg"]["planted_leading"] <= check.PLANTED_GATE_DEG
    # the files now on disk are the user's: a second run takes them as such
    assert check.prepare_rows(str(tmp_path), "clip768") == (str(tmp_path), False)


def test_synthesized_corpus_off_its_planted_basis_exits_1(tmp_path, monkeypatch):
    # the corpus is drawn from its planted subspace, the gate is handed
    # another one: the fit is far from it, so the check must fail
    from distributed_eigenspaces_tpu_torch.data.synthetic import planted_subspace

    true_rows = check.planted_rows
    calls = []

    def planted_rows(name):
        calls.append(name)
        if len(calls) == 1:
            return true_rows(name)
        return planted_subspace(768, k_planted=256, gap=20.0, noise=0.01, seed=12)

    monkeypatch.setattr(check, "planted_rows", planted_rows)
    rc, reps, err = _run("clip768", "--data-dir", str(tmp_path))
    assert calls == ["clip768", "clip768"]
    assert rc == 1 and "outside the fit" in err
    assert reps[0]["reference_angles_deg"]["planted_leading"] > check.PLANTED_GATE_DEG


def test_contract_constants_equal_the_reference_script():
    ref = _load("real_data_check")
    assert check.ROWS_CONFIGS == ref.ROWS_CONFIGS
    assert check.MNIST_FILES == ref.MNIST_FILES
    assert (check.CIFAR_URL, check.CIFAR_MD5, check.MNIST_BASE) == (
        ref.CIFAR_URL, ref.CIFAR_MD5, ref.MNIST_BASE)
