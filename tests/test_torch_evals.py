"""The port's eval harness (``evals.py``) against the reference's: the specs,
the dense in-memory evals (``synthetic1024``, ``cifar10``, ``mnist784``) and
the mesh branch, the timing statistics, real data, and ``main``.

The cases and the comparison are ``tests/eval_parity.py``'s (the
reference test's sizes, the reference's own blocks and cold start handed
to the port). The feature-sharded and out-of-core evals are
``tests/test_torch_evals_sharded.py``'s. The mesh branch runs once, on two
gloo ranks (``tests/torch_eval_ranks.py``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu import evals as jevals
from distributed_eigenspaces_tpu.analysis.hlo import ici_step_model as jici_step_model
from distributed_eigenspaces_tpu.data.mnist import write_idx
from distributed_eigenspaces_tpu_torch import evals
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel import worker_pool

import eval_parity as parity
import torch_eval_ranks as ranks

CPU = parity.CPU
NAMES = ("synthetic1024", "cifar10", "mnist784")


@pytest.fixture(scope="module")
def ref_reports():
    return parity.ref_reports(NAMES)


@pytest.fixture(scope="module")
def port_reports():
    return parity.port_reports(NAMES)


def test_all_six_specs_field_for_field():
    assert sorted(evals.EVAL_SPECS) == sorted(jevals.EVAL_SPECS) == [
        "cifar10", "clip768", "clip768_chip", "imagenet12288", "mnist784",
        "synthetic1024",
    ]
    for name, spec in jevals.EVAL_SPECS.items():
        assert dataclasses.asdict(evals.EVAL_SPECS[name]) == dataclasses.asdict(spec)
    assert [f.name for f in dataclasses.fields(evals.EvalSpec)] == \
        [f.name for f in dataclasses.fields(jevals.EvalSpec)]


def test_synthetic_model_is_the_references_decay_rule():
    """The decay the reference computes inline (``evals.py:319-328``)."""
    for spec in evals.EVAL_SPECS.values():
        gap, noise = 20.0, 0.01
        want = max(0.8, float((100.0 * noise / gap) ** (1.0 / max(spec.k - 1, 1))))
        got = evals.synthetic_model(spec, seed=3)
        assert got == dict(k_planted=spec.k, gap=gap, decay=want, noise=noise, seed=3)


@pytest.mark.parametrize("name", NAMES)
def test_report_matches_the_reference(name, ref_reports, port_reports):
    parity.assert_report_matches(name, ref_reports[name], port_reports[name])


def test_timing_statistics_over_repeats():
    """The headline samples/s is the median of the repeats, inside its IQR."""
    kw = parity.CASES["synthetic1024"]
    blocks, v0 = parity.ref_inputs("synthetic1024", **kw)
    rep = evals.run_eval("synthetic1024", device=CPU, repeats=3, blocks=blocks, v0=v0, **kw)
    t = rep["timing"]
    assert t["n_repeats"] == 3
    assert t["seconds_iqr"][0] <= t["seconds_median"] <= t["seconds_iqr"][1]
    lo, hi = t["samples_per_sec_iqr"]
    assert lo <= rep["samples_per_sec"] * 1.001 and rep["samples_per_sec"] <= hi * 1.001
    assert t["samples_per_sec_spread_pct"] >= 0
    with pytest.raises(ValueError, match="repeats"):
        evals.run_eval("synthetic1024", device=CPU, repeats=0, **kw)


def test_worker_solves_take_the_route_the_model_assumes(monkeypatch):
    """Gram calls in a run: the cold step of each of its three fits (the
    accuracy fit, the warm-up, one timed run) takes the Gram route and the
    warm steps stream, as the roofline's model says at this shape."""
    calls = []
    real = worker_pool.gram_auto

    def counted(x, **kw):
        calls.append(tuple(x.shape))
        return real(x, **kw)

    monkeypatch.setattr(worker_pool, "gram_auto", counted)
    kw = parity.CASES["cifar10"]
    spec = evals.EVAL_SPECS["cifar10"].replace(**kw)
    blocks, v0 = parity.ref_inputs("cifar10", **kw)
    evals.run_eval("cifar10", device=CPU, blocks=blocks, v0=v0, **kw)
    assert parity.gram_calls_per_fit(spec) == 1
    assert calls == [(spec.num_workers, spec.rows_per_worker, spec.dim)] * 3


def test_blocks_must_be_the_cycled_count():
    kw = parity.CASES["cifar10"]
    blocks, _ = parity.ref_inputs("cifar10", **kw)
    with pytest.raises(ValueError, match="cycles 4"):
        evals.run_eval("cifar10", device=CPU, blocks=blocks[:3], **kw)


def test_mnist784_real_data(tmp_path):
    """MNIST IDX files on disk: the eval reads them and measures against
    their exact top-k."""
    rng = np.random.default_rng(1234)
    write_idx(str(tmp_path / "train-images-idx3-ubyte"),
              rng.integers(0, 256, (2048, 28, 28), dtype=np.uint8))
    write_idx(str(tmp_path / "train-labels-idx1-ubyte"),
              rng.integers(0, 10, (2048,), dtype=np.uint8))
    rep = evals.run_eval("mnist784", device=CPU, data_dir=str(tmp_path), num_workers=4,
                         rows_per_worker=128, steps=3, subspace_iters=20)
    assert rep["data"] == "real" and rep["dim"] == 784
    assert rep["data_source"] == {"dir": str(tmp_path), "kind": "mnist", "rows": 2048}
    assert 0 <= rep["principal_angle_deg"] <= 90


def test_exact_top_k_is_the_references():
    x = np.random.default_rng(2).standard_normal((300, 24)).astype(np.float32)
    np.testing.assert_array_equal(evals.exact_top_k(x, 5), jevals.exact_top_k(x, 5))


def test_run_eval_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        evals.run_eval("cifar10", **parity.CASES["cifar10"])


def test_main_prints_one_json_line_a_config(monkeypatch, capsys):
    """``main``: one JSON line a config, its flags passed through, exit 1
    when an eval misses its accuracy gate."""
    seen = []

    def fake(name, **kw):
        seen.append((name, kw))
        return {"config": name, "accuracy_ok": name != "mnist784"}

    monkeypatch.setattr(evals, "run_eval", fake)
    assert evals.main(["cifar10", "--steps", "2", "--device", "cpu", "--seed", "3"]) == 0
    assert seen == [("cifar10", dict(data_dir=None, seed=3, repeats=None, device="cpu",
                                     steps=2))]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["config"] for line in lines] == ["cifar10"]
    assert evals.main(["cifar10", "mnist784"]) == 1
    assert len(capsys.readouterr().out.strip().splitlines()) == 2
    seen.clear()
    evals.main([])
    assert [name for name, _ in seen] == sorted(evals.EVAL_SPECS)


def test_mnist784_on_two_ranks_is_the_mesh_branch(port_reports):
    """Two gloo ranks: the worker mesh (``shard_map``), the collective model
    the reference's ``ici_step_model`` gives for a workers axis of 2, and
    the fit of the one-process run."""
    kw = parity.CASES["mnist784"]
    blocks, v0 = parity.ref_inputs("mnist784", **kw)
    out = pmesh.launch(ranks.eval_rank, 2, "mnist784", kw, blocks, v0, backend="gloo",
                       timeout=240)
    spec = evals.EVAL_SPECS["mnist784"].replace(**kw)
    want = jici_step_model(spec.num_workers, spec.dim, spec.k, n_workers_mesh=2)
    one = port_reports["mnist784"]
    for rep in out:
        assert rep["backend"] == "shard_map" and rep["trainer"] == "scan"
        for key in ("factor_gather_bytes_per_step", "dense_psum_bytes_per_step",
                    "dense_over_factor"):
            assert rep["ici_model"][key] == want[key], key
        assert rep["ici_model"]["assumed_ici_gb_per_sec"] == 450.0
        assert abs(rep["principal_angle_deg"] - one["principal_angle_deg"]) <= 0.01
        assert rep["roofline"]["model_flops_total"] == one["roofline"]["model_flops_total"]


#: chip_smoke.py's hand copies of the evals' settings before it read them
#: from the port's EVAL_SPECS, word for word
OLD_SMOKE = {
    "DSOLVE": dict(dim=12288, k=50, num_workers=4, rows_per_worker=2048, num_steps=10),
    "DSOLVE_DATA": dict(k_planted=50, gap=20.0, decay=max(0.8, 0.05 ** (1 / 49)), noise=0.01,
                        seed=0),
    "EVAL_FIT": dict(dim=3072, k=10, num_workers=8, rows_per_worker=1024, num_steps=20,
                     solver="subspace", subspace_iters=12, warm_start_iters=2,
                     compute_dtype="bfloat16", stage_dtype="int8", warm_orth_method="ns"),
    "EVAL_DATA": dict(k_planted=10, gap=20.0, decay=0.8, noise=0.01, seed=0),
    "SYNTH_FIT": dict(dim=1024, k=5, num_workers=8, rows_per_worker=2048, num_steps=20,
                      solver="subspace", subspace_iters=12, warm_start_iters=2,
                      compute_dtype="bfloat16", stage_dtype="int8", warm_orth_method="ns"),
    "SYNTH_DATA": dict(k_planted=5, gap=20.0, decay=max(0.8, (100 * 0.01 / 20.0) ** (1 / 4)),
                       noise=0.01, seed=0),
    "CLIP_FIT": dict(dim=768, k=256, num_workers=8, rows_per_worker=2048, num_steps=10,
                     solver="subspace", subspace_iters=8, warm_start_iters=2,
                     compute_dtype="bfloat16", backend="local"),
    "CLIP_DATA": dict(k_planted=256, gap=20.0, decay=max(0.8, 0.05 ** (1 / 255)), noise=0.01,
                      seed=0),
    "CLIP_DISTINCT": 4,
    "CLIP_SEGMENT": 5,
    "MNIST_FIT": dict(dim=784, k=20, num_workers=8, rows_per_worker=1024, num_steps=20,
                      solver="subspace", subspace_iters=16, warm_start_iters=2,
                      compute_dtype="bfloat16", stage_dtype="int8", warm_orth_method="ns",
                      backend="shard_map"),
    "MNIST_DATA": dict(k_planted=20, gap=20.0, decay=max(0.8, 0.05 ** (1 / 19)), noise=0.01,
                       seed=0),
}
#: the old fs_eval_config(): DSOLVE's shape with these fields
OLD_FS_EVAL = dict(subspace_iters=16, warm_start_iters=1, compute_dtype="bfloat16",
                   stage_dtype="int8", backend="feature_sharded")


def test_chip_smoke_reads_the_specs_it_used_to_copy():
    """Every setting chip_smoke.py derives from ``EVAL_SPECS`` equals its old
    hand copy, so no phase changes what it runs, with two differences, each
    named: cifar10 and synthetic1024 now say ``backend="local"`` (the spec's)
    where the copies left the default ``"auto"``, which resolves to the same
    one-process dense route at these shapes; and imagenet12288 now runs the
    spec's ``solver="subspace"`` with 12 cold iterations, where the copy
    left the solver at its default ``"eigh"`` (under which the rank-r scan
    never warm-starts) and had 16 iterations: two copying errors, since the
    reference's spec sets the solver and leaves the iterations at 12."""
    import sys
    from pathlib import Path

    from distributed_eigenspaces_tpu_torch.api.estimator import (
        _scan_mesh,
        resolves_feature_sharded,
    )
    from distributed_eigenspaces_tpu_torch.config import PCAConfig

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    for name, old in OLD_SMOKE.items():
        new = getattr(cs, name)
        if name.endswith("_FIT"):
            old_cfg = PCAConfig(**old)
            if name in ("EVAL_FIT", "SYNTH_FIT"):
                assert old_cfg.backend == "auto" and new["backend"] == "local"
                assert not resolves_feature_sharded(old_cfg)
                assert _scan_mesh(old_cfg, CPU) is None
                old_cfg = dataclasses.replace(old_cfg, backend="local")
            assert PCAConfig(**new) == old_cfg, name
        else:
            assert new == old, name
    old_fs = PCAConfig(**{**OLD_SMOKE["DSOLVE"], **OLD_FS_EVAL})
    assert old_fs.solver == "eigh" and old_fs.resolved_warm_start() is None
    assert cs.fs_eval_config() == dataclasses.replace(old_fs, solver="subspace",
                                                      subspace_iters=12)
    assert evals.EVAL_SPECS["imagenet12288"].subspace_iters == 12
    assert jevals.EVAL_SPECS["imagenet12288"].subspace_iters == 12
    assert cs.fs_eval_config(collectives="ring").collectives == "ring"
