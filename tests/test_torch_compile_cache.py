"""The port's compile lifecycle (utils/compile_cache.py, runtime/prewarm.py)
against the reference's contracts, on the CPU.

The port's counterpart of each test in ``tests/test_compile_cache.py``.
Three of those fail under the installed jax (the disk round trip, the
cached transform and the engine's persistent backing), so the cached
results here are held to the port's own fresh run, bit for bit, and to a
numpy oracle; the reference is used for its key's knob names only.

A CPU program is never persisted (it launches no kernel library), so the
disk tier is driven with keys made for ``backend="cuda"``: their entries
carry no library unless one is named, and a named library is a file the
test writes in place of an ``nvcc`` build (``ops._build`` patched).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.utils import compile_cache as jcc
from distributed_eigenspaces_tpu_torch.api import estimator as est_mod
from distributed_eigenspaces_tpu_torch.api.estimator import OnlineDistributedPCA
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.data.synthetic import (
    planted_spectrum,
    sample_prefix_stable,
)
from distributed_eigenspaces_tpu_torch.ops import _build
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel.fleet import FleetServer, fit_fleet
from distributed_eigenspaces_tpu_torch.serving import (
    EigenbasisRegistry,
    QueryServer,
    TransformEngine,
)
from distributed_eigenspaces_tpu_torch.utils import compile_cache as cc_mod
from distributed_eigenspaces_tpu_torch.utils.compile_cache import (
    CompileCache,
    compile_cache_for,
    config_knobs,
    configure_persistent_cache,
    make_key,
)
from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger
from distributed_eigenspaces_tpu_torch.utils.telemetry import Tracer

D, K, M, N, T = 32, 3, 2, 16, 4
CPU = "cpu"
TIMEOUT = 60


def _cfg(**kw):
    base = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
                serve_bucket_size=4, serve_flush_s=0.02)
    base.update(kw)
    return PCAConfig(**base)


@pytest.fixture(scope="module")
def corpus():
    spec = planted_spectrum(D, k_planted=K, gap=20.0, noise=0.01, seed=0)
    return spec, sample_prefix_stable(spec, T * M * N, seed=1).numpy()


@pytest.fixture(autouse=True)
def _own_build_dir(monkeypatch):
    """Every test leaves the process's library directory as it found it."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)


def _cuda_key(kind="toy", sig=(8, 4), **kw):
    return make_key(kind, sig, "float32", backend="cuda",
                    torch_version="torch=test|cuda=test|sm=90", **kw)


def _matmul():
    """A program the tests can run: the build_fn of a toy kind."""
    return lambda a, b: a @ b


def _run(program):
    a = torch.arange(32, dtype=torch.float32).reshape(8, 4) / 7.0
    b = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 3.0
    return program(a, b).numpy()


def _meta(tmp_path):
    [path] = glob.glob(str(tmp_path / "*.json"))
    return path


class TestCacheKey:
    def test_every_field_invalidates(self):
        base = make_key("scan_fit", (D, K, M, N, T), "float32",
                        knobs=config_knobs(_cfg()), backend="cpu")
        variants = [
            make_key("scan_fit", (D, K + 1, M, N, T), "float32",
                     knobs=config_knobs(_cfg(k=K + 1)), backend="cpu"),
            make_key("scan_fit", (D, K, M, N, T), "bfloat16",
                     knobs=config_knobs(_cfg()), backend="cpu"),
            make_key("scan_fit", (D, K, M, N, T), "float32",
                     knobs=config_knobs(_cfg(merge_interval=2)), backend="cpu"),
            make_key("scan_fit", (D, K, M, N, T), "float32",
                     knobs=config_knobs(_cfg()), backend="cpu",
                     torch_version="torch=9.9.9"),
            make_key("scan_fit", (D, K, M, N, T), "float32",
                     knobs=config_knobs(_cfg()), backend="cuda"),
            make_key("scan_extract", (D, K, M, N, T), "float32",
                     knobs=config_knobs(_cfg()), backend="cpu"),
        ]
        digests = {base.digest()} | {v.digest() for v in variants}
        assert len(digests) == 1 + len(variants)

    def test_knobs_cover_the_program_shapers(self):
        names = dict(config_knobs(_cfg()))
        for knob in ("merge_interval", "pipeline_merge", "solver",
                     "compute_dtype", "dtype", "warm_start"):
            assert knob in names
        # resolved, not raw: "auto" warm_start cannot alias its resolution
        assert names["warm_start"] == repr(_cfg().resolved_warm_start())
        assert "seed" not in names  # the seed rides each program's signature
        # the same knobs as the reference's, in its order
        want = [n for n, _ in jcc.config_knobs(JaxConfig(dim=D, k=K))]
        assert [n for n, _ in config_knobs(_cfg())] == want

    def test_runtime_versions_name_torch_and_cuda(self):
        key = make_key("toy", (1,), torch.float32, device=CPU)
        assert key.backend == "cpu" and key.dtype == "float32"
        assert key.torch_version == f"torch={torch.__version__}|cuda={torch.version.cuda}"

    def test_key_mismatch_is_a_disk_miss(self, tmp_path):
        CompileCache(str(tmp_path)).get_or_build(_cuda_key(), _matmul)
        fresh = CompileCache(str(tmp_path))  # a second process
        assert fresh.contains(_cuda_key())
        other_torch = make_key("toy", (8, 4), "float32", backend="cuda",
                               torch_version="torch=9.9.9")
        assert not fresh.contains(other_torch)
        assert not fresh.contains(make_key("toy", (8, 4), "float32", backend="cpu"))
        fresh.get_or_build(other_torch, _matmul)
        assert fresh.stats()["misses"] == 1 and fresh.stats()["fallbacks"] == 0


class TestCompileCache:
    def test_disk_round_trip_bit_identical(self, tmp_path):
        cc = CompileCache(str(tmp_path))
        fresh = _run(cc.get_or_build(_cuda_key(), _matmul))
        assert cc.stats()["misses"] == 1
        meta = json.load(open(_meta(tmp_path)))
        assert meta["key"] == _cuda_key().string() and meta["libraries"] == []
        cc2 = CompileCache(str(tmp_path))  # a second process
        cached = _run(cc2.get_or_build(_cuda_key(), _matmul))
        assert cc2.stats() == {**cc2.stats(), "disk_hits": 1, "misses": 0}
        assert cc2.stats()["compile_ms_total"] == 0.0
        np.testing.assert_array_equal(fresh, cached)

    def test_memory_hit_after_disk_hit(self, tmp_path):
        CompileCache(str(tmp_path)).get_or_build(_cuda_key(), _matmul)
        cc = CompileCache(str(tmp_path))
        cc.get_or_build(_cuda_key(), _matmul)
        cc.get_or_build(_cuda_key(), _matmul)
        assert (cc.stats()["disk_hits"], cc.stats()["hits"]) == (1, 1)

    @pytest.mark.parametrize("damage", ["corrupt", "truncated"])
    def test_damaged_entry_falls_back_loudly(self, tmp_path, damage):
        cc = CompileCache(str(tmp_path))
        fresh = _run(cc.get_or_build(_cuda_key(), _matmul))
        path = _meta(tmp_path)
        raw = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(b"not an entry" if damage == "corrupt" else raw[: len(raw) // 2])
        cc2 = CompileCache(str(tmp_path))
        with pytest.warns(UserWarning, match="fresh build"):
            out = _run(cc2.get_or_build(_cuda_key(), _matmul))
        assert (cc2.stats()["fallbacks"], cc2.stats()["misses"]) == (1, 1)
        np.testing.assert_array_equal(fresh, out)
        # the rebuilt entry is whole again: a third process hits it
        cc3 = CompileCache(str(tmp_path))
        cc3.get_or_build(_cuda_key(), _matmul)
        assert cc3.stats()["disk_hits"] == 1

    @pytest.mark.parametrize("field,value,match", [
        ("torch_version", "torch=0.0.1", "torch torch=0.0.1"),
        ("key", "something else entirely", "mismatch"),
        ("format", 0, "format 0"),
        ("backend", "cpu", "backend cpu"),
    ])
    def test_mismatched_meta_falls_back(self, tmp_path, field, value, match):
        CompileCache(str(tmp_path)).get_or_build(_cuda_key(), _matmul)
        path = _meta(tmp_path)
        meta = json.load(open(path))
        meta[field] = value
        json.dump(meta, open(path, "w"))
        cc = CompileCache(str(tmp_path))
        with pytest.warns(UserWarning, match=match):
            cc.get_or_build(_cuda_key(), _matmul)
        assert cc.stats()["fallbacks"] == 1

    def test_memory_only_cache_never_touches_disk(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        cc = CompileCache(None)
        out1 = _run(cc.get_or_build(_cuda_key(), _matmul))
        out2 = _run(cc.get_or_build(_cuda_key(), _matmul))
        np.testing.assert_array_equal(out1, out2)
        assert (cc.stats()["misses"], cc.stats()["hits"]) == (1, 1)
        assert cc.stats()["dir"] is None and cc.stats()["compile_ms_total"] > 0.0
        assert os.listdir(tmp_path) == []

    def test_cpu_program_is_not_persisted(self, tmp_path):
        cc = CompileCache(str(tmp_path))
        key = make_key("eigh", (6,), "float32", device=CPU)
        program = cc.get_or_build(key, lambda: torch.linalg.eigh)
        assert torch.isfinite(program(torch.eye(6))[1]).all()
        assert cc.stats()["not_portable"] == 1
        assert glob.glob(str(tmp_path / "*.json")) == []
        cc.get_or_build(key, lambda: torch.linalg.eigh)  # the memory tier serves it
        assert cc.stats()["hits"] == 1

    def test_contains_does_not_bump_counters(self, tmp_path):
        cc = CompileCache(str(tmp_path))
        assert not cc.contains(_cuda_key())
        cc.get_or_build(_cuda_key(), _matmul)
        before = cc.stats()
        assert cc.contains(_cuda_key())
        assert cc.stats() == before

    def test_tracer_sees_builds_and_hits(self, tmp_path):
        tracer = Tracer()
        cc = CompileCache(str(tmp_path))
        MetricsLogger().attach_tracer(tracer).attach_compile(cc)
        cc.get_or_build(_cuda_key(), _matmul)
        cc.get_or_build(_cuda_key(), _matmul)
        names = [s.name for s in tracer.spans]
        assert names.count("compile") == 1 and names.count("compile_cache_hit") == 1


class TestKernelLibraries:
    """Layer 1 and the library half of a disk entry, with ``nvcc`` replaced
    by a file the test writes."""

    @pytest.fixture()
    def fake_build(self, tmp_path, monkeypatch):
        kernels = tmp_path / "kernels"
        loads, builds = [], []

        def library_path(name):
            return _build.BUILD_DIR / f"lib{name}-0123456789abcdef.so"

        def build(name):
            path = library_path(name)
            if not path.is_file():
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_bytes(b"\x7fELF " + name.encode())
                builds.append(name)
            return path

        monkeypatch.setattr(_build, "library_path", library_path)
        monkeypatch.setattr(_build, "build", build)
        monkeypatch.setattr(_build, "load", lambda name: loads.append(name))
        configure_persistent_cache(str(tmp_path))
        assert _build.BUILD_DIR == kernels
        return kernels, loads, builds

    def test_entry_names_its_libraries_and_a_warm_process_loads_them(
            self, tmp_path, fake_build):
        kernels, loads, builds = fake_build
        programs = str(tmp_path / "programs")
        CompileCache(programs).get_or_build(_cuda_key(), _matmul,
                                            libraries=("serve_project",))
        assert builds == ["serve_project"] and loads == ["serve_project"]
        [lib] = json.load(open(glob.glob(programs + "/*.json")[0]))["libraries"]
        assert lib["name"] == "serve_project" and len(lib["sha256"]) == 64
        loads.clear()
        cc = CompileCache(programs)  # a second process: no build, a load
        cc.get_or_build(_cuda_key(), _matmul, libraries=("serve_project",))
        assert cc.stats()["disk_hits"] == 1 and builds == ["serve_project"]
        assert loads == ["serve_project"]

    @pytest.mark.parametrize("damage", ["rewritten", "removed"])
    def test_damaged_library_falls_back(self, tmp_path, fake_build, damage):
        kernels, loads, builds = fake_build
        programs = str(tmp_path / "programs")
        CompileCache(programs).get_or_build(_cuda_key(), _matmul, libraries=("gram",))
        [path] = kernels.glob("libgram-*.so")
        if damage == "rewritten":
            path.write_bytes(b"another library")
        else:
            path.unlink()
        cc = CompileCache(programs)
        with pytest.warns(UserWarning, match="library"):
            cc.get_or_build(_cuda_key(), _matmul, libraries=("gram",))
        assert (cc.stats()["fallbacks"], cc.stats()["misses"]) == (1, 1)

    def test_a_loaded_library_stays_loaded_when_the_dir_moves(self, tmp_path, monkeypatch):
        sentinel = object()
        monkeypatch.setitem(_build._libs, "gram", sentinel)
        before = _build.BUILD_DIR
        configure_persistent_cache(str(tmp_path / "a"))
        assert _build.BUILD_DIR == tmp_path / "a" / "kernels" != before
        assert _build.load("gram") is sentinel  # neither reloaded nor rebuilt
        configure_persistent_cache(str(tmp_path / "a"))  # idempotent
        assert _build.BUILD_DIR == tmp_path / "a" / "kernels"

    def test_compile_cache_for_is_one_instance_a_directory(self, tmp_path):
        cfg = _cfg(compile_cache_dir=str(tmp_path))
        a, b = compile_cache_for(cfg), compile_cache_for(_cfg(k=2, compile_cache_dir=str(tmp_path)))
        assert a is b and a.cache_dir == str(tmp_path / "programs")
        assert compile_cache_for(_cfg()) is None


class TestEstimatorIntegration:
    def test_cached_fit_bit_identical_and_reused(self, tmp_path, corpus):
        spec, data = corpus
        w_plain = OnlineDistributedPCA(_cfg(), device=CPU).fit(data).components_
        cfg = _cfg(compile_cache_dir=str(tmp_path))
        est = OnlineDistributedPCA(cfg, device=CPU).fit(data)
        torch.testing.assert_close(est.components_, w_plain, rtol=0, atol=0)
        cc = compile_cache_for(cfg)
        misses0 = cc.stats()["misses"]
        assert misses0 >= 2  # scan_fit + scan_extract
        est2 = OnlineDistributedPCA(cfg, device=CPU).fit(data)
        torch.testing.assert_close(est2.components_, w_plain, rtol=0, atol=0)
        assert cc.stats()["misses"] == misses0  # the memory tier reused
        assert cc.stats()["hits"] >= 2
        # the oracle: the planted top-k
        ang = principal_angles_degrees(est.components_, torch.as_tensor(spec.top_k(K)))
        assert float(ang.max()) < 1.0

    def test_changing_k_is_a_program_miss(self, tmp_path, corpus):
        _, data = corpus
        cfg = _cfg(compile_cache_dir=str(tmp_path))
        OnlineDistributedPCA(cfg, device=CPU).fit(data)
        cc = compile_cache_for(cfg)
        misses0 = cc.stats()["misses"]
        est = OnlineDistributedPCA(_cfg(k=K - 1, compile_cache_dir=str(tmp_path)),
                                   device=CPU).fit(data)
        assert tuple(est.components_.shape) == (D, K - 1)
        assert cc.stats()["misses"] > misses0  # never a stale program

    def test_another_start_is_another_program(self, tmp_path, corpus):
        _, data = corpus
        cfg = _cfg(solver="subspace", subspace_iters=8, compile_cache_dir=str(tmp_path))
        a = OnlineDistributedPCA(cfg, device=CPU).fit(data).components_
        v0 = np.linalg.qr(np.random.default_rng(5).standard_normal((D, K)))[0]
        b = OnlineDistributedPCA(cfg, device=CPU, v0=v0).fit(data).components_
        b_plain = OnlineDistributedPCA(_cfg(solver="subspace", subspace_iters=8),
                                       device=CPU, v0=v0).fit(data).components_
        torch.testing.assert_close(b, b_plain, rtol=0, atol=0)
        assert not torch.equal(a, b)

    def test_mesh_fit_with_cache_dir_stays_on_direct_path(self, tmp_path, corpus, monkeypatch):
        _, data = corpus
        # a (1, 1) mesh in one process stands in for a workers mesh: the fit
        # runs the mesh trainer, with collectives that are the identity
        monkeypatch.setattr(est_mod, "_scan_mesh",
                            lambda cfg, device="cuda": pmesh.local_mesh(device))
        w_plain = OnlineDistributedPCA(_cfg(), device=CPU).fit(data).components_
        cfg = _cfg(compile_cache_dir=str(tmp_path))
        est = OnlineDistributedPCA(cfg, device=CPU).fit(data)
        torch.testing.assert_close(est.components_, w_plain, rtol=0, atol=0)
        assert compile_cache_for(cfg).stats()["misses"] == 0

    def test_cached_transform_bit_identical(self, tmp_path, corpus):
        spec, data = corpus
        est_plain = OnlineDistributedPCA(_cfg(), device=CPU).fit(data)
        est = OnlineDistributedPCA(_cfg(compile_cache_dir=str(tmp_path)),
                                   device=CPU).fit(data)
        q = spec.sample(np.random.default_rng(9), 5)
        np.testing.assert_array_equal(est.transform(q).numpy(),
                                      est_plain.transform(q).numpy())
        np.testing.assert_array_equal(est.transform(q[0]).numpy(),
                                      est_plain.transform(q[0]).numpy())
        oracle = q.astype(np.float64) @ est.components_.numpy().astype(np.float64)
        np.testing.assert_allclose(est.transform(q).numpy(), oracle, rtol=0, atol=1e-5)
        assert est._transform_engine.stats()["persistent"]["not_portable"] >= 1


class TestServingStallAccounting:
    def _served(self, corpus, **kw):
        spec, data = corpus
        cfg = _cfg()
        reg = EigenbasisRegistry(keep=4)
        reg.publish_fit(OnlineDistributedPCA(cfg, device=CPU).fit(data))
        metrics = MetricsLogger()
        q = spec.sample(np.random.default_rng(9), 5)
        with QueryServer(reg, cfg, metrics=metrics, device=CPU, **kw) as srv:
            assert srv.wait_warm(timeout=TIMEOUT)
            first = srv.submit(q).result(timeout=TIMEOUT)
            srv.submit(q).result(timeout=TIMEOUT)  # a warm second batch
            labels = srv.prewarm_labels
        batches = [r for r in metrics.serve_records if r["serve"] == "batch"]
        return first, batches, metrics.summary()["serving"], labels

    def test_prewarmed_first_request_zero_stall(self, corpus):
        res, batches, serving, labels = self._served(corpus, prewarm=(5,))
        assert res.z.shape == (5, K)
        # one bucket (8 rows), its projection and residual programs
        assert [lbl[3:] for lbl in labels] == [("project", 8), ("residual", 8)]
        assert batches[0]["compile_misses"] == 0
        assert batches[0]["compile_stall_ms"] == 0.0
        assert serving["compile_misses"] == 0 and serving["compile_stall_ms"] == 0.0
        assert "compile_stall_ms_by_signature" not in serving

    def test_prewarm_true_warms_the_bucket_ladder(self, corpus):
        _, batches, serving, labels = self._served(corpus, prewarm=True)
        assert sorted({lbl[4] for lbl in labels}) == [8, 16, 32, 64, 128]
        assert serving["compile_misses"] == 0

    def test_cold_first_request_stall_counted_per_signature(self, corpus):
        _, batches, serving, _ = self._served(corpus)
        assert batches[0]["compile_misses"] >= 1
        assert batches[0]["compile_stall_ms"] > 0.0
        assert batches[-1]["compile_misses"] == 0
        assert batches[-1]["compile_stall_ms"] == 0.0
        assert serving["compile_stall_ms_by_signature"] == {
            str((D, K)): batches[0]["compile_stall_ms"]}

    def test_attach_compile_surfaces_cache_stats(self, tmp_path):
        cc = CompileCache(str(tmp_path))
        cc.get_or_build(_cuda_key(), _matmul)
        metrics = MetricsLogger().attach_compile(cc)
        assert metrics.summary()["compile"]["misses"] == 1
        assert metrics.summary()["compile"] == cc.stats()

    def test_engine_persistent_backing_cross_instance(self, tmp_path):
        rng = np.random.default_rng(3)
        x = rng.normal(size=(5, D)).astype(np.float32)
        v = np.linalg.qr(rng.normal(size=(D, K)))[0].astype(np.float32)
        cc = CompileCache(str(tmp_path))
        z1 = TransformEngine(D, K, cache=cc, device=CPU).project(x, v).numpy()
        assert cc.stats()["misses"] == 1
        cc2 = CompileCache(str(tmp_path))  # a second process
        eng2 = TransformEngine(D, K, cache=cc2, device=CPU)
        z2 = eng2.project(x, v).numpy()
        np.testing.assert_array_equal(z1, z2)
        np.testing.assert_allclose(z1, x.astype(np.float64) @ v, rtol=0, atol=1e-5)
        # a CPU bucket launches no library: memory only, never on disk
        assert eng2.stats()["persistent"]["not_portable"] == 1
        assert glob.glob(str(tmp_path / "*.json")) == []


class TestFleetStallAccounting:
    def _fleet_cfg(self, **kw):
        base = dict(dim=16, k=2, num_workers=2, rows_per_worker=16, num_steps=3,
                    fleet_bucket_size=2, fleet_flush_s=0.05)
        base.update(kw)
        return PCAConfig(**base)

    def _problems(self, cfg, count):
        spec = planted_spectrum(cfg.dim, k_planted=cfg.k, gap=20.0, noise=0.01, seed=0)
        rows = cfg.num_steps * cfg.num_workers * cfg.rows_per_worker
        return [spec.sample(np.random.default_rng(10 + i), rows) for i in range(count)]

    def test_prewarmed_fleet_dispatch_zero_stall_through_a_cache_dir(self, tmp_path):
        cfg = self._fleet_cfg(compile_cache_dir=str(tmp_path))
        metrics = MetricsLogger()
        probs = self._problems(cfg, 2)
        with FleetServer(cfg, mesh=None, metrics=metrics, device=CPU) as srv:
            assert srv.compile_cache is compile_cache_for(cfg)
            srv.prewarm()
            assert srv.wait_warm(timeout=TIMEOUT)
            ws = [t.result(timeout=TIMEOUT) for t in [srv.submit(p) for p in probs]]
        fleet = metrics.summary()["fleet"]
        assert fleet["compile_misses"] == 0 and fleet["compile_stall_ms"] == 0.0
        # the fleet fit and its extraction acquired once each, memory only
        assert compile_cache_for(cfg).stats()["not_portable"] == 2
        want = fit_fleet(self._fleet_cfg(), probs, mesh=None, device=CPU).components
        np.testing.assert_array_equal(np.stack(ws), want)

    def test_fit_fleet_auto_resolves_the_config_cache(self, tmp_path):
        cfg = self._fleet_cfg(compile_cache_dir=str(tmp_path))
        probs = self._problems(cfg, 2)
        a = fit_fleet(cfg, probs, mesh=None, device=CPU)
        b = fit_fleet(cfg, probs, mesh=None, device=CPU)
        np.testing.assert_array_equal(a.components, b.components)
        assert compile_cache_for(cfg).stats()["hits"] == 2


def test_module_names_are_the_references():
    assert sorted(cc_mod.__all__) == sorted(jcc.__all__)
