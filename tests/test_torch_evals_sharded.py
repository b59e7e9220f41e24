"""The port's eval harness against the reference's, the feature-sharded and
out-of-core evals: ``imagenet12288`` and ``clip768_chip`` (the sketch on
the features axis) and ``clip768`` (the int8 row file, the segmented whole
fit, its stage breakdown), the per-step trainer, and user row directories.

The cases and the comparison are ``tests/eval_parity.py``'s.
"""

import numpy as np
import pytest

from distributed_eigenspaces_tpu import evals as jevals
from distributed_eigenspaces_tpu_torch import evals
from distributed_eigenspaces_tpu_torch.parallel import worker_pool

import eval_parity as parity

CPU = parity.CPU
NAMES = ("imagenet12288", "clip768", "clip768_chip")


@pytest.fixture(scope="module")
def ref_reports():
    return parity.ref_reports(NAMES)


@pytest.fixture(scope="module")
def port_reports():
    return parity.port_reports(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_report_matches_the_reference(name, ref_reports, port_reports):
    parity.assert_report_matches(name, ref_reports[name], port_reports[name])


def test_sharded_evals_take_the_sketch(port_reports):
    for name in ("imagenet12288", "clip768_chip"):
        rep = port_reports[name]
        assert (rep["backend"], rep["trainer"], rep["streaming"]) == \
            ("feature_sharded", "sketch", "memory")


def test_out_of_core_report_carries_the_link_evidence(port_reports):
    rep = port_reports["clip768"]
    assert rep["trainer"] == "segmented" and rep["streaming"] == "bin"
    assert rep["bin_dtype"] == "int8"
    assert rep["stage_ms"]["window_steps"] == 4
    assert set(rep["stage_ms"]) == {"disk_read", "host_to_device",
                                    "compute_dispatch_per_window", "window_steps"}
    assert rep["bytes_per_step"] == 8 * 256 * 128  # int8: one byte a value
    assert rep["pipeline_rows_per_sec"] > 0 and rep["link_bound_samples_per_sec"] > 0
    assert rep["link_bound_fraction"] >= 0 and isinstance(rep["pipeline_ok"], bool)


def test_segmented_solves_take_the_route_the_model_assumes(monkeypatch):
    """Gram calls of the out-of-core run: the cold step of each of its three
    window passes (the warm-up, one timed run, the window timed alone), the
    warm steps streaming, as the roofline's model says at this shape."""
    calls = []
    real = worker_pool.gram_auto

    def counted(x, **kw):
        calls.append((tuple(x.shape), x.dtype))
        return real(x, **kw)

    monkeypatch.setattr(worker_pool, "gram_auto", counted)
    kw = parity.CASES["clip768"]
    spec = evals.EVAL_SPECS["clip768"].replace(**kw)
    blocks, v0 = parity.ref_inputs("clip768", **kw)
    evals.run_eval("clip768", device=CPU, blocks=blocks, v0=v0, **kw)
    assert parity.gram_calls_per_fit(spec) == 1
    shape = (spec.num_workers, spec.rows_per_worker, spec.dim)
    assert [c[0] for c in calls] == [shape] * 3
    assert all(str(c[1]) == "torch.int8" for c in calls)  # the int8 wire, unconverted


def test_per_step_trainer_still_available():
    rep = evals.run_eval("clip768", device=CPU, dim=64, k=8, subspace_iters=12,
                         rows_per_worker=128, steps=3, trainer="step")
    assert rep["trainer"] == "step" and rep["accuracy_ok"]
    assert set(rep["stage_ms"]) == {"disk_read", "host_to_device", "compute_dispatch"}


@pytest.mark.parametrize("name,shrink", [
    ("imagenet12288", dict(dim=192, k=5, num_workers=2, rows_per_worker=64, steps=3)),
    ("clip768", dict(dim=96, k=8, num_workers=2, rows_per_worker=64, steps=3)),
])
def test_eval_ingests_rows_dir(tmp_path, name, shrink):
    """Configs 4 and 5 on user row files, provenance in the report."""
    d = shrink["dim"]
    rows = shrink["num_workers"] * shrink["rows_per_worker"] * (shrink["steps"] + 1)
    sub = tmp_path / name
    sub.mkdir()
    x = np.random.default_rng(5).standard_normal((rows, d)).astype(np.float32)
    if name == "imagenet12288":
        np.save(sub / "patches.npy", x.reshape(rows, 8, 8, 3))
    else:
        np.save(sub / "emb.npy", x)
    rep = evals.run_eval(name, device=CPU, data_dir=str(tmp_path), **shrink)
    assert rep["data"] == "real"
    assert rep["data_source"]["rows"] == rows and rep["data_source"]["dir"] == str(sub)
    assert 0.0 <= rep["principal_angle_deg"] <= 90.0


def test_real_data_is_loud_on_a_malformed_dir_and_quiet_on_a_missing_one(tmp_path):
    sub = tmp_path / "clip768"
    sub.mkdir()
    np.save(sub / "bad.npy", np.zeros((10, 7), np.float32))  # wrong width
    for mod in (evals, jevals):
        with pytest.raises(ValueError) as err:
            mod._real_data(mod.EVAL_SPECS["clip768"], str(tmp_path))
        assert "dim=768" in str(err.value)
        assert mod._real_data(mod.EVAL_SPECS["clip768"], str(tmp_path / "nope")) == (None, None)
        assert mod._real_data(mod.EVAL_SPECS["cifar10"], None) == (None, None)
