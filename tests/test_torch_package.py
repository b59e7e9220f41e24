"""Guards on the PyTorch port: it imports neither JAX nor the JAX package,
and its entry points never drop to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.serving import (
    EigenbasisRegistry,
    QueryServer,
    TransformEngine,
)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "distributed_eigenspaces_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "distributed_eigenspaces_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, distributed_eigenspaces_tpu_torch as t\n"
        "import distributed_eigenspaces_tpu_torch.interop\n"
        "import distributed_eigenspaces_tpu_torch.serving\n"
        "import distributed_eigenspaces_tpu_torch.runtime.scheduler\n"
        "import distributed_eigenspaces_tpu_torch.runtime.supervisor\n"
        "import distributed_eigenspaces_tpu_torch.runtime.membership\n"
        "import distributed_eigenspaces_tpu_torch.utils.telemetry\n"
        "import distributed_eigenspaces_tpu_torch.utils.faults\n"
        "import distributed_eigenspaces_tpu_torch.utils.metrics\n"
        "import distributed_eigenspaces_tpu_torch.ops.serve_project\n"
        "import distributed_eigenspaces_tpu_torch.ops.matvec_gram\n"
        "import distributed_eigenspaces_tpu_torch.solvers\n"
        "import distributed_eigenspaces_tpu_torch.ops.geometry\n"
        "import distributed_eigenspaces_tpu_torch.ops.mutant_full_block\n"
        "import distributed_eigenspaces_tpu_torch.algo.scan\n"
        "import distributed_eigenspaces_tpu_torch.api.runner\n"
        "import distributed_eigenspaces_tpu_torch.data.bin_stream\n"
        "import distributed_eigenspaces_tpu_torch.runtime.native\n"
        "import distributed_eigenspaces_tpu_torch.runtime.prefetch\n"
        "import distributed_eigenspaces_tpu_torch.utils.checkpoint\n"
        "import distributed_eigenspaces_tpu_torch.evals\n"
        "import distributed_eigenspaces_tpu_torch.utils.roofline\n"
        "import distributed_eigenspaces_tpu_torch.utils.tracing\n"
        "import distributed_eigenspaces_tpu_torch.analysis.hlo\n"
        "import distributed_eigenspaces_tpu_torch.data.cifar\n"
        "import distributed_eigenspaces_tpu_torch.data.mnist\n"
        "import distributed_eigenspaces_tpu_torch.data.npy_dir\n"
        "import distributed_eigenspaces_tpu_torch.parallel.feature_sharded\n"
        "import distributed_eigenspaces_tpu_torch.parallel.mesh\n"
        "import distributed_eigenspaces_tpu_torch.algo.online\n"
        "import distributed_eigenspaces_tpu_torch.api.estimator\n"
        "import distributed_eigenspaces_tpu_torch.serving.replication\n"
        "import distributed_eigenspaces_tpu_torch.utils.guards\n"
        "import distributed_eigenspaces_tpu_torch.serving.drift\n"
        "import distributed_eigenspaces_tpu_torch.parallel.fleet\n"
        "from distributed_eigenspaces_tpu_torch.runtime.supervisor import (\n"
        "    Supervisor, supervised_fit)\n"
        "from distributed_eigenspaces_tpu_torch.runtime.membership import (\n"
        "    ElasticStream, MembershipTable)\n"
        "from distributed_eigenspaces_tpu_torch.runtime.scheduler import (\n"
        "    run_dynamic_round)\n"
        "from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger\n"
        "from distributed_eigenspaces_tpu_torch.utils.faults import (\n"
        "    ChaosPlan, ChaosStream, ChurnPlan, ClientChaosPlan, FaultInjector)\n"
        "from distributed_eigenspaces_tpu_torch.analysis import (\n"
        "    ast_lints, contracts, mutations, programs, report)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
    + sorted((ROOT / "scripts").glob("torch_*.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_in_port_sources(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path} imports {bad}"


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PCAConfig(dim=16, k=2, num_workers=2, rows_per_worker=8, num_steps=1)
    data = np.zeros((16, 16), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        dett.OnlineDistributedPCA(cfg).fit(data)
    evals = PCAConfig(dim=16, k=2, num_workers=2, rows_per_worker=8, num_steps=1,
                      solver="subspace", compute_dtype="bfloat16", stage_dtype="int8",
                      warm_orth_method="ns")
    with pytest.raises(RuntimeError, match="cuda"):
        dett.OnlineDistributedPCA(evals).fit(data)
    with pytest.raises(RuntimeError, match="cuda"):
        dett.make_train_step(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        dett.make_scan_fit(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        dett.make_segmented_fit(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        dett.OnlineDistributedPCA(cfg, checkpoint_dir="unused").fit(data)
    from distributed_eigenspaces_tpu_torch.runtime.prefetch import prefetch_stream
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import restore_checkpoint
    with pytest.raises(RuntimeError, match="cuda"):
        prefetch_stream(iter([data]))
    with pytest.raises(RuntimeError, match="cuda"):
        restore_checkpoint("unused")
    with pytest.raises(RuntimeError, match="cuda"):
        dett.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        TransformEngine(16, 2)
    reg = EigenbasisRegistry()
    reg.publish(np.eye(16, 2, dtype=np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        QueryServer(reg, cfg)


def test_kernel_sources_ship_with_the_package():
    assert (PKG / "csrc" / "gram.cu").is_file()
    assert (PKG / "csrc" / "serve_project.cu").is_file()
    assert (PKG / "csrc" / "matvec_gram.cu").is_file()
    assert (PKG / "csrc" / "mutant_full_block.cu").is_file()
    assert (PKG / "csrc" / "gram_s8.cu").is_file()
    assert (PKG / "native" / "loader.cc").is_file()  # the bin stream's host reader
    text = (ROOT / "pyproject.toml").read_text()
    assert ('distributed_eigenspaces_tpu_torch = ["csrc/*.cu", "csrc/*.cuh", '
            '"native/*.cc"]') in text


def test_feature_sharded_entry_points_raise_without_a_card(monkeypatch):
    """The feature-sharded trainers, the sharded engine and the estimator on
    the feature-sharded backend default to the card too."""
    from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as fs
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PCAConfig(dim=16, k=2, num_workers=2, rows_per_worker=8, num_steps=1,
                    solver="subspace", backend="feature_sharded")
    data = np.zeros((16, 16), np.float32)
    for build in (fs.make_feature_sharded_step, fs.make_feature_sharded_scan_fit,
                  fs.make_feature_sharded_sketch_fit, pmesh.local_mesh):
        with pytest.raises(RuntimeError, match="cuda"):
            build(cfg) if build is not pmesh.local_mesh else build()
    with pytest.raises(RuntimeError, match="cuda"):
        dett.OnlineDistributedPCA(cfg).fit(data)
    with pytest.raises(RuntimeError, match="cuda"):
        dett.OnlineDistributedPCA(cfg, trainer="sketch").fit(data)


def test_supervised_entry_points_raise_without_a_card(monkeypatch):
    """The supervised fit, the elastic stream and the dynamic round default
    to the card too: no retry or resume turns that into a CPU run."""
    from distributed_eigenspaces_tpu_torch.runtime.membership import (
        ElasticStream,
        MembershipTable,
    )
    from distributed_eigenspaces_tpu_torch.runtime.scheduler import run_dynamic_round
    from distributed_eigenspaces_tpu_torch.runtime.supervisor import supervised_fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PCAConfig(dim=16, k=2, num_workers=2, rows_per_worker=8, num_steps=1)
    data = np.zeros((16, 16), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        supervised_fit(lambda s: iter([data.reshape(2, 8, 16)]), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        supervised_fit(lambda s: iter([data.reshape(2, 8, 16)]), cfg, trainer="segmented")
    with pytest.raises(RuntimeError, match="cuda"):
        ElasticStream(iter([]), MembershipTable(2), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        run_dynamic_round(data, num_batches=2, k=2)
