"""The port's command line (``distributed_eigenspaces_tpu_torch/cli.py``)
against the reference's (``distributed_eigenspaces_tpu/cli.py``), on the CPU.

- The parsers: flag for flag (dest, default, choices, type); ``--device``
  is the port's one extra flag.
- The validation exits: exit 2 in both, before any fit, with the same flag
  named on stderr.
- The numbers: on one CIFAR-format directory written here (a planted
  two-direction structure in uint8 pixels, so the top-k is well separated),
  both CLIs' ``--save`` in fit (scan and the per-step trainer), oneshot and
  serve mode agree within 0.01 degrees, their JSON key sets are equal, and
  serve exits 0 in both. The reference CLI runs four times in all.
- The synthetic path (the port alone): fit, fleet and serve within 1
  degree of the planted truth; prefix-stable rows; a resumed fit with a
  larger ``--steps`` equal to an uninterrupted one; the compile cache's
  stderr line and JSON blocks.
Every port run passes ``--device cpu``.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu import cli as jcli
from distributed_eigenspaces_tpu_torch import cli
from distributed_eigenspaces_tpu_torch.data.synthetic import (
    planted_spectrum,
    sample_prefix_stable,
)
from distributed_eigenspaces_tpu_torch.ops import _build
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

CPU = ["--device", "cpu"]
PARITY_DEG = 0.01
PLANTED_DEG = 1.0
SYNTH = ["--data", "synthetic", "--dim", "32", "--rank", "2", "--workers", "2",
         "--rows-per-worker", "32", "--steps", "4"]


@pytest.fixture(autouse=True)
def _own_build_dir(monkeypatch):
    """``--compile-cache`` re-points the process's library directory: every
    test leaves it as it found it."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # a 1024-wide eigh on each side: torch's intra-op threads and the BLAS
    # threads of numpy and XLA only contend with each other and the other
    # test workers
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


def _run(main, argv, capsys):
    """``(exit code, stdout JSON or None, stderr)`` of one in-process run."""
    rc = main(argv)
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None), err


def _deg(a, b) -> float:
    return float(principal_angles_degrees(torch.as_tensor(np.asarray(a, np.float32)),
                                          torch.as_tensor(np.asarray(b, np.float32))).max())


# -- the parsers ----------------------------------------------------------------


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_matches_the_reference_flag_for_flag():
    got, want = _actions(cli.build_parser()), _actions(jcli.build_parser())
    assert set(got) - set(want) == {"device"}
    assert set(want) <= set(got)
    for dest, a in want.items():
        b = got[dest]
        assert (b.option_strings, b.default, b.choices, b.type, b.nargs,
                type(b).__name__) == (a.option_strings, a.default, a.choices,
                                      a.type, a.nargs, type(a).__name__), dest
    assert got["device"].default == "cuda"


# -- the validation exits ---------------------------------------------------------

INVALID = [
    (["--mode", "slave"], "slave"),
    (["--components", "2"], "--components"),
    (["--grow-k", "4"], "--grow-k"),
    (["--mode", "serve", "--grow-k", "2"], "--grow-k"),
    (["--warm-start-iters", "2"], "--warm-start-iters"),
    (["--resume"], "--resume"),
    (["--prewarm"], "--prewarm"),
    (["--pipeline-merge"], "--pipeline-merge"),
    (["--pipeline-merge", "--solver", "subspace", "--checkpoint-dir", "ck"],
     "--pipeline-merge"),
    (["--merge-topology", "chip"], "--merge-topology"),
    (["--mode", "serve", "--population", "10"], "--population"),
]


@pytest.mark.parametrize("argv,flag", INVALID, ids=lambda v: " ".join(v)
                         if isinstance(v, list) else v)
def test_validation_exits_match_the_reference(argv, flag, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # a fit would leave files here: none may run
    rc, out, err = _run(cli.main, argv + CPU, capsys)
    jrc, jout, jerr = _run(jcli.main, argv, capsys)
    assert (rc, jrc) == (2, 2)
    assert out is None and jout is None
    assert flag in err and flag in jerr
    assert list(tmp_path.iterdir()) == []


def test_plan_refuses_naming_the_planner_item(capsys, tmp_path, monkeypatch):
    # the planner is ported (tests/test_torch_planner.py applies a plan): a
    # path with no plan artifact exits 2 in both packages, naming the flag
    monkeypatch.chdir(tmp_path)
    rc, out, err = _run(cli.main, ["--plan", "plan.json"] + CPU, capsys)
    jrc, jout, jerr = _run(jcli.main, ["--plan", "plan.json"], capsys)
    assert (rc, jrc) == (2, 2) and out is None and jout is None
    assert "--plan plan.json: no such plan artifact" in err
    assert err == jerr


def test_cuda_is_the_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(SYNTH)


# -- numeric parity on one CIFAR-format directory ---------------------------------------


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    """One CIFAR-10 batch of 160 rows: two planted pixel patterns (standard
    deviations 40 and 20 grey levels) over noise of 4, as uint8."""
    root = tmp_path_factory.mktemp("cifar")
    rng = np.random.default_rng(11)
    rows = 160
    signs = rng.choice([-1.0, 1.0], size=(2, 3072))
    z = rng.standard_normal((rows, 2)) * np.array([40.0, 20.0])
    x = 128.0 + z @ signs + 4.0 * rng.standard_normal((rows, 3072))
    batch = {
        b"data": np.clip(np.rint(x), 0, 255).astype(np.uint8),
        b"filenames": [f"img_{i}.png".encode() for i in range(rows)],
        b"labels": [int(i % 10) for i in range(rows)],
    }
    with open(root / "data_batch_1", "wb") as f:
        pickle.dump(batch, f)
    return str(root)


# the subspace solver: both sides converge on the clean gap from their own
# starts, and neither runs a 1024-wide eigh a worker
CIFAR_ARGS = ["--rank", "2", "--workers", "2", "--rows-per-worker", "32",
              "--steps", "2", "--solver", "subspace"]
MODES = {
    "fit_scan": ["--mode", "fit", "--trainer", "scan"],
    "fit_step": ["--mode", "fit"],
    "oneshot": ["--mode", "oneshot"],
    "serve": ["--mode", "serve", "--serve-queries", "8", "--serve-bucket", "4"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cifar_runs_agree_with_the_reference(mode, cifar_dir, capsys, tmp_path):
    argv = MODES[mode] + ["--data", cifar_dir] + CIFAR_ARGS
    rc, out, _ = _run(cli.main, argv + CPU + ["--save", str(tmp_path / "w.npy")], capsys)
    jrc, jout, _ = _run(jcli.main, argv + ["--save", str(tmp_path / "jw.npy")], capsys)
    assert (rc, jrc) == (0, 0)
    assert set(out) == set(jout)
    w, jw = np.load(tmp_path / "w.npy"), np.load(tmp_path / "jw.npy")
    assert w.shape == jw.shape == (1024, 2)
    assert _deg(w, jw) <= PARITY_DEG
    if mode == "serve":
        assert out["max_abs_err_vs_direct"] == 0.0 == jout["max_abs_err_vs_direct"]


# -- the synthetic path -------------------------------------------------------------


def test_synthetic_rows_are_prefix_stable():
    spec = planted_spectrum(24, k_planted=2, gap=20.0, noise=0.01, seed=0)
    n = 5000  # more than one chunk
    small = sample_prefix_stable(spec, n, seed=1)
    large = sample_prefix_stable(spec, 2 * n, seed=1)
    assert torch.equal(small, large[:n])
    assert not torch.equal(sample_prefix_stable(spec, n, seed=2), small)


@pytest.mark.parametrize("mode", [
    ["--mode", "fit"],
    ["--mode", "fit", "--trainer", "scan"],
    ["--mode", "fleet", "--fleet-size", "2", "--prewarm"],
    ["--mode", "serve", "--prewarm"],
], ids=lambda v: " ".join(v[1:]))
def test_synthetic_lands_on_the_planted_truth(mode, capsys, tmp_path):
    rc, out, _ = _run(cli.main, mode + SYNTH + CPU + ["--save", str(tmp_path / "w.npy")],
                      capsys)
    assert rc == 0
    spec = planted_spectrum(32, k_planted=2, gap=20.0, noise=0.01, seed=0)
    w = np.load(tmp_path / "w.npy")
    for wt in (w if w.ndim == 3 else [w]):
        assert _deg(wt, spec.top_k(2)) <= PLANTED_DEG
    if mode[1] == "fleet":
        assert out["prewarmed"] is True and out["tenants"] == 2
    if mode[1] == "serve":
        assert out["max_abs_err_vs_direct"] == 0.0
        assert out["compile_misses"] == 0 and out["compile_stall_ms"] == 0.0
        assert out["prewarm"]["compiled"] == out["prewarm"]["submitted"]


@pytest.mark.parametrize("queries", [2, 3])
def test_prewarmed_serve_acquires_nothing_when_the_flush_timer_cuts_a_batch(
        queries, capsys, tmp_path):
    """Fewer queries than a bucket holds: only the flush timer dispatches, so
    every batch is short, and 2 or 3 queries of 8 rows in one batch pad to 16
    or 32 rows. ``--prewarm`` covers every batch of 1 to
    ``serve_bucket_size`` queries (8, 16, 32 and 64 rows, two kinds each), so
    the burst still acquires nothing."""
    rc, out, _ = _run(cli.main, ["--mode", "serve", "--prewarm", "--serve-queries",
                                 str(queries)] + SYNTH + CPU, capsys)
    assert rc == 0 and out["max_abs_err_vs_direct"] == 0.0
    assert 1 <= out["batches"] <= queries
    assert out["compile_misses"] == 0 and out["compile_stall_ms"] == 0.0
    assert out["prewarm"]["compiled"] == out["prewarm"]["submitted"] == 8


@pytest.mark.parametrize("trainer", ["scan", "step"])
def test_resume_with_more_steps_equals_one_run(trainer, capsys, tmp_path):
    # 1/t: a step's weight does not depend on --steps (under 1/T a run of 4
    # steps folds each at 1/4, one of 8 at 1/8, in both packages)
    base = ["--mode", "fit", "--trainer", trainer, "--checkpoint-every", "2",
            "--discount", "1/t"] + SYNTH[:-2]
    whole = tmp_path / "whole"
    rc, _, _ = _run(cli.main, base + ["--steps", "8", "--checkpoint-dir", str(whole),
                                      "--save", str(tmp_path / "one.npy")] + CPU, capsys)
    assert rc == 0
    ck = str(tmp_path / "ck")
    rc, _, _ = _run(cli.main, base + ["--steps", "4", "--checkpoint-dir", ck] + CPU, capsys)
    assert rc == 0
    rc, out, err = _run(cli.main, base + ["--steps", "8", "--checkpoint-dir", ck,
                                          "--resume", "--save",
                                          str(tmp_path / "two.npy")] + CPU, capsys)
    assert rc == 0 and '"resumed_step": 4' in err
    np.testing.assert_array_equal(np.load(tmp_path / "one.npy"),
                                  np.load(tmp_path / "two.npy"))


def test_compile_cache_reports_its_lifecycle(capsys, tmp_path):
    argv = ["--mode", "serve", "--prewarm", "--compile-cache", str(tmp_path)] + SYNTH + CPU
    rc, out, err = _run(cli.main, argv, capsys)
    assert rc == 0
    assert set(out["compile_cache"]) == {"hits", "disk_hits", "misses", "fallbacks",
                                         "not_portable", "compile_ms_total",
                                         "entries_mem", "dir"}
    assert out["compile_cache"]["not_portable"] >= 1  # CPU programs: memory only
    [line] = [json.loads(ln) for ln in err.splitlines() if "compile_lifecycle" in ln]
    life = line["compile_lifecycle"]
    assert life["nvcc_runs"] == 0 and life["kernel_dir"] == str(tmp_path / "kernels")
