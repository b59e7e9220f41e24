"""The port's read path (serving/) against the reference's, on the CPU.

Inputs are made with numpy from a seed; a basis published to both
packages' registries is the same float32 array. Every server is a context
manager and every ``.result()`` has a timeout. Tolerances:
- fp32 engine vs the reference engine: relative Frobenius <= 1e-6 (both
  fp32 matmuls, summed in another order);
- bfloat16 / int8 engines vs the reference engine (its XLA twins off the
  TPU): <= 1e-5 (the same exact products of bf16-rounded operands);
- served vs direct on the CPU: bit-exact at fp32 (``torch.matmul`` keeps
  rows independent across bucket sizes here), within 0.2 degrees per row
  quantized (the reference's serve budget).
"""

import concurrent.futures
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu import config as jconfig
from distributed_eigenspaces_tpu.serving import (
    EigenbasisRegistry as JaxRegistry,
    QueryServer as JaxServer,
    TransformEngine as JaxEngine,
)
import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.interop import config_from_jax
from distributed_eigenspaces_tpu_torch.runtime.membership import QuorumLost
from distributed_eigenspaces_tpu_torch.serving import (
    EigenbasisRegistry,
    QueryServer,
    ServerClosed,
    ServerOverloaded,
    TransformEngine,
    VersionRetired,
    bucket_rows,
)
from distributed_eigenspaces_tpu_torch.utils.compile_cache import CompileCache
from distributed_eigenspaces_tpu_torch.utils.telemetry import Tracer

D, K = 32, 3
DTYPES = ("float32", "bfloat16", "int8")
TOL = {"float32": 1e-6, "bfloat16": 1e-5, "int8": 1e-5}
TIMEOUT = 30


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _basis(seed=0, d=D, k=K):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.standard_normal((d, k)))[0].astype(np.float32)


def _queries(count, seed=1, rows=(1, 5, 8)):
    """Rows with dominant energy in the span of ``_basis()`` (the serve
    regime the angle budget is stated for)."""
    rng = np.random.default_rng(seed)
    v = _basis()
    out = []
    for i in range(count):
        r = rows[i % len(rows)]
        coeffs = rng.standard_normal((r, K))
        noise = rng.standard_normal((r, D))
        noise *= 0.3 * np.linalg.norm(coeffs, axis=1, keepdims=True) / np.linalg.norm(
            noise, axis=1, keepdims=True)
        out.append((coeffs @ v.T + noise).astype(np.float32))
    return out


def _cfg(**kw):
    base = dict(dim=D, k=K, num_workers=2, rows_per_worker=16, num_steps=4,
                serve_bucket_size=4, serve_flush_s=0.02)
    base.update(kw)
    return PCAConfig(**base)


def _row_angles_deg(z, z_ref):
    z = np.asarray(z, np.float64)
    z_ref = np.asarray(z_ref, np.float64)
    cos = np.sum(z * z_ref, 1) / (np.linalg.norm(z, axis=1) * np.linalg.norm(z_ref, axis=1))
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


# -- engine ------------------------------------------------------------------


@pytest.mark.parametrize("serve_dtype", DTYPES)
def test_engine_matches_reference_engine(serve_dtype):
    v = _basis()
    x = np.concatenate(_queries(3))  # 14 rows: padded to a 16-row bucket
    ours = TransformEngine(D, K, serve_dtype=serve_dtype, device="cpu")
    ref = JaxEngine(D, K, serve_dtype=serve_dtype)
    z = ours.project(x, v)
    z_ref = np.asarray(ref.project(x, jnp.asarray(v)))
    assert z.shape == (14, K) and z.dtype == torch.float32
    assert _rel(z.numpy(), z_ref) <= TOL[serve_dtype]
    xr = ours.reconstruct(z, v)
    assert xr.shape == (14, D)
    assert _rel(xr.numpy(), np.asarray(ref.reconstruct(z_ref, jnp.asarray(v)))) <= TOL[serve_dtype]
    r, e = ours.residual_energy(x, z)
    r_ref, e_ref = ref.residual_energy(x, z_ref)
    assert _rel(e.numpy(), np.asarray(e_ref)) <= 1e-6
    assert _rel(r.numpy(), np.asarray(r_ref)) <= 1e-4  # a difference of two energies
    assert bool((r >= 0).all())


@pytest.mark.parametrize("serve_dtype", DTYPES)
def test_padded_rows_leave_real_rows_unchanged(serve_dtype):
    eng = TransformEngine(D, K, serve_dtype=serve_dtype, device="cpu")
    v = _basis()
    x = np.concatenate(_queries(4))  # 22 rows -> 32-row bucket
    z = eng.project(x, v)
    for lo, hi in ((0, 1), (0, 8), (3, 11)):
        np.testing.assert_array_equal(eng.project(x[lo:hi], v).numpy(), z[lo:hi].numpy())


@pytest.mark.parametrize("serve_dtype", DTYPES)
def test_self_check(serve_dtype):
    eng = TransformEngine(D, K, serve_dtype=serve_dtype, device="cpu")
    worst = eng.self_check()
    if serve_dtype == "float32":
        assert worst == 0.0
    else:
        assert 0.0 < worst <= 0.2
        with pytest.raises(ValueError, match="self-check"):
            eng.self_check(budget_deg=1e-12)
    # the reference's gate reads the same probe within the budget too
    ref_worst = JaxEngine(D, K, serve_dtype=serve_dtype).self_check()
    assert abs(worst - ref_worst) <= 0.05


@pytest.mark.parametrize("serve_dtype", DTYPES)
def test_five_bases_one_acquisition_per_bucket(serve_dtype):
    eng = TransformEngine(D, K, serve_dtype=serve_dtype, device="cpu")
    x = np.concatenate(_queries(2))  # 6 rows -> 8-row bucket
    for seed in range(5):
        eng.project(x, eng.place_basis(_basis(seed)))
    assert eng.compile_misses == 1 and eng.cache_hits == 4
    assert eng.stats()["buckets"] == [8]


def test_engine_rejects_bad_operands_and_unported_modes():
    eng = TransformEngine(D, K, device="cpu")
    with pytest.raises(ValueError, match="signature"):
        eng.project(np.zeros((2, D), np.float32), np.zeros((D, K + 1), np.float32))
    with pytest.raises(ValueError, match=r"\(rows, 32\)"):
        eng.project(np.zeros((2, D + 1), np.float32), _basis())
    with pytest.raises(ValueError, match="serve_dtype"):
        TransformEngine(D, K, serve_dtype="fp8", device="cpu")
    # the mesh engines are ported (tests/test_torch_sharded_basis.py); a
    # basis_spec without a mesh is refused loudly, as in the reference
    with pytest.raises(ValueError, match="features"):
        TransformEngine(D, K, basis_spec=("features", None), device="cpu")
    assert [bucket_rows(n) for n in (1, 8, 9, 64, 65)] == [8, 8, 16, 64, 128]


# -- registry ----------------------------------------------------------------


def test_registry_publish_gc_and_retired():
    reg = EigenbasisRegistry(keep=2)
    src = _basis()
    v1 = reg.publish(src, step=3, lineage={"producer": "test"})
    src[:] = 0.0  # the version holds its own frozen copy
    assert reg.latest() is v1 and float(np.abs(v1.v).sum()) > 0
    assert not v1.v.flags.writeable
    reg.publish(_basis(1))
    v3 = reg.publish(_basis(2))
    assert reg.versions() == [2, 3] and reg.latest() is v3
    with pytest.raises(VersionRetired, match="serve_keep_versions"):
        reg.get(1)
    bad = _basis()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        reg.publish(bad)
    assert reg.latest() is v3 and len(reg) == 2


def _publish_two(reg):
    st = np.diag(np.arange(D, 0, -1)).astype(np.float32)
    reg.publish(_basis(0), sigma_tilde=st, step=4, lineage={"trainer": "scan"})
    return reg.publish(_basis(1), sigma_tilde=st, step=8, lineage={"trainer": "step"})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_registry_dir_crosses_between_packages(tmp_path, writer):
    """A registry directory written by either package recovers in the other
    bit-exact: the on-disk format is shared."""
    write, read = (JaxRegistry, EigenbasisRegistry) if writer == "jax" else (
        EigenbasisRegistry, JaxRegistry)
    last = _publish_two(write(keep=4, registry_dir=str(tmp_path)))
    rec = read(keep=4, registry_dir=str(tmp_path))
    assert rec.recovered_versions == [1, 2]
    got = rec.latest()
    assert got.version == 2 and got.step == 8 and got.lineage == {"trainer": "step"}
    np.testing.assert_array_equal(got.v, last.v)
    np.testing.assert_array_equal(got.sigma_tilde, last.sigma_tilde)
    assert got.explained_variance == last.explained_variance


def test_registry_recovers_a_sharded_jax_publish(tmp_path):
    jreg = JaxRegistry(registry_dir=str(tmp_path))
    want = jreg.publish(_basis(4), num_shards=3, step=2)
    got = EigenbasisRegistry(registry_dir=str(tmp_path)).latest()
    assert got.version == 1 and got.shard_sizes == want.shard_sizes == (11, 11, 10)
    np.testing.assert_array_equal(got.v, want.v)
    # the port publishes in shards too, with the reference's balanced split
    mine = EigenbasisRegistry().publish(_basis(4), num_shards=3, step=2)
    assert mine.shard_sizes == want.shard_sizes and mine.spec == want.spec
    np.testing.assert_array_equal(mine.v, want.v)


def test_registry_quarantines_a_corrupt_version(tmp_path):
    _publish_two(EigenbasisRegistry(registry_dir=str(tmp_path)))
    payload = tmp_path / "v00000002" / "basis.npz"
    raw = bytearray(payload.read_bytes())
    raw[-8] ^= 0xFF
    payload.write_bytes(bytes(raw))
    rec = EigenbasisRegistry(registry_dir=str(tmp_path))
    assert rec.quarantined == ["v00000002.quarantined"]
    assert rec.latest().version == 1
    assert rec.publish(_basis(3)).version == 3  # the quarantined id is never reused


def test_publish_fit_moves_the_fit_to_the_host():
    cfg = _cfg(solver="subspace", subspace_iters=8)
    spec = dett.planted_spectrum(D, k_planted=K, seed=0)
    est = dett.OnlineDistributedPCA(cfg, device="cpu").fit(
        spec.sample(torch.Generator().manual_seed(0), 4 * 2 * 16)
    )
    bv = EigenbasisRegistry().publish_fit(est)
    assert isinstance(bv.v, np.ndarray) and bv.signature == (D, K) and bv.step == 4
    np.testing.assert_array_equal(bv.v, est.components_.numpy())
    assert bv.sigma_tilde.shape == (D, D)
    assert bv.lineage == {"producer": "OnlineDistributedPCA", "trainer": "scan"}


# -- query server ------------------------------------------------------------


@pytest.mark.parametrize("serve_dtype", DTYPES)
def test_server_burst_with_mid_burst_swap(serve_dtype):
    reg = EigenbasisRegistry(keep=4)
    v = _basis()
    reg.publish(v)
    qs = _queries(16)
    with QueryServer(reg, _cfg(serve_dtype=serve_dtype), device="cpu") as srv:
        warm = TransformEngine(D, K, serve_dtype=serve_dtype, device="cpu")
        for q in qs:  # every bucket the burst can pad to, both operations
            srv.engine.project(q, v)
            srv.engine.residual_energy(q, warm.project(q, v))
        for n in range(2, 5):
            for lo in range(0, 16 - n + 1):
                x = np.concatenate(qs[lo:lo + n])
                srv.engine.residual_energy(x, srv.engine.project(x, v))
        misses = srv.engine.compile_misses
        first = [srv.submit(q) for q in qs[:8]]
        res = [t.result(timeout=TIMEOUT) for t in first]
        reg.publish(v)  # the same basis as a new version: a hot swap
        second = [srv.submit(q) for q in qs[8:]]
        res += [t.result(timeout=TIMEOUT) for t in second]
        assert srv.engine.compile_misses == misses  # the swap acquired nothing
    assert {r.version for r in res} == {1, 2} and srv.swap_count >= 1
    for q, r in zip(qs, res):
        direct = q @ v
        assert r.z.shape == (q.shape[0], K)
        if serve_dtype == "float32":
            np.testing.assert_array_equal(r.z, torch.matmul(torch.from_numpy(q), torch.from_numpy(v)).numpy())
        else:
            assert float(_row_angles_deg(r.z, direct).max()) <= 0.2
        np.testing.assert_allclose(r.input_sq, (q.astype(np.float64) ** 2).sum(1), rtol=1e-5)


@pytest.mark.parametrize("serve_dtype", DTYPES)
def test_served_z_matches_reference_server(serve_dtype):
    v = _basis()
    qs = _queries(6)
    ours, theirs = EigenbasisRegistry(), JaxRegistry()
    ours.publish(v)
    theirs.publish(v)
    jcfg = jconfig.PCAConfig(dim=D, k=K, num_workers=2, rows_per_worker=16,
                             num_steps=4, serve_bucket_size=4, serve_dtype=serve_dtype)
    with QueryServer(ours, config_from_jax(dataclasses.asdict(jcfg)), device="cpu") as srv:
        got = [t.result(timeout=TIMEOUT) for t in [srv.submit(q) for q in qs]]
    with JaxServer(theirs, jcfg) as srv:
        want = [t.result(timeout=TIMEOUT) for t in [srv.submit(q) for q in qs]]
    for g, w in zip(got, want):
        assert g.version == w.version == 1
        assert _rel(g.z, w.z) <= TOL[serve_dtype]
        assert _rel(g.input_sq, w.input_sq) <= 1e-6


def test_nonfinite_query_fails_only_its_ticket():
    reg = EigenbasisRegistry()
    v = _basis()
    reg.publish(v)
    qs = _queries(3)
    bad = qs[1].copy()
    bad[0, 0] = np.nan
    with QueryServer(reg, _cfg(), bucket_size=3, flush_s=10.0, device="cpu") as srv:
        t1, t_bad, t2 = srv.submit(qs[0]), srv.submit(bad), srv.submit(qs[2])
        r1, r2 = t1.result(timeout=TIMEOUT), t2.result(timeout=TIMEOUT)
        with pytest.raises(ValueError, match="non-finite rows"):
            t_bad.result(timeout=TIMEOUT)
    eng = TransformEngine(D, K, device="cpu")
    np.testing.assert_array_equal(r1.z, eng.project(qs[0], v).numpy())
    np.testing.assert_array_equal(r2.z, eng.project(qs[2], v).numpy())


def test_server_boundary_errors():
    reg = EigenbasisRegistry()
    reg.publish(_basis())
    srv = QueryServer(reg, _cfg(), device="cpu")
    with srv:
        with pytest.raises(ValueError, match="signature"):
            srv.submit(np.zeros((3, D + 1), np.float32))
    with pytest.raises(ServerClosed):
        srv.submit(_queries(1)[0])
    assert not srv._thread.is_alive()
    gate = concurrent.futures.Future()
    with QueryServer(reg, _cfg(serve_queue_depth=2), bucket_size=1, flush_s=0.0,
                     fault_hook=lambda b: gate.result(timeout=TIMEOUT), device="cpu") as srv:
        held = [srv.submit(q) for q in _queries(2)]
        with pytest.raises(ServerOverloaded, match="load shedding"):
            srv.submit(_queries(1)[0])
        gate.set_result(None)
        assert all(t.result(timeout=TIMEOUT).z.shape[1] == K for t in held)
        assert srv.health()["sheds"]["overload"] == 1


def test_server_records_request_spans_on_the_engine_tracer():
    reg = EigenbasisRegistry()
    reg.publish(_basis())
    with QueryServer(reg, _cfg(), device="cpu") as srv:
        srv.engine.tracer = Tracer()
        srv.submit(_queries(1)[0]).result(timeout=TIMEOUT)
    names = {sp.name for sp in srv.engine.tracer.snapshot()}
    assert {"admit", "queue_wait", "dispatch", "compute", "reply",
            "batch_compute", "engine_compile"} <= names


def test_unported_server_modes_raise():
    reg = EigenbasisRegistry()
    reg.publish(_basis())
    # a MetricsLogger sink is ported (tests/test_torch_metrics.py); so are
    # prewarming and the compile cache (tests/test_torch_compile_cache.py)
    for kw in ({"prewarm": True}, {"compile_cache": CompileCache(None)}):
        with QueryServer(reg, _cfg(), device="cpu", **kw) as srv:
            assert srv.wait_warm(timeout=TIMEOUT)
            assert srv.compile_cache is kw.get("compile_cache")
    # a DriftMonitor is ported (tests/test_torch_drift.py)
    with QueryServer(reg, _cfg(), device="cpu", drift=object()) as srv:
        assert srv.drift is not None


def test_estimator_transform_through_the_server():
    cfg = _cfg(solver="subspace", subspace_iters=8)
    spec = dett.planted_spectrum(D, k_planted=K, seed=0)
    est = dett.OnlineDistributedPCA(cfg, device="cpu").fit(
        spec.sample(torch.Generator().manual_seed(0), 4 * 2 * 16)
    )
    reg = EigenbasisRegistry()
    reg.publish_fit(est)
    q = _queries(1, rows=(5,))[0]
    with QueryServer(reg, cfg, device="cpu") as srv, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        z = pool.submit(est.transform, q, serve=srv).result(timeout=TIMEOUT)
        z1 = pool.submit(est.transform, q[0], serve=srv).result(timeout=TIMEOUT)
    assert z.shape == (5, K) and z1.shape == (K,)
    np.testing.assert_array_equal(z.numpy(), est.transform(q).numpy())
    np.testing.assert_array_equal(z1.numpy(), z[0].numpy())


# -- config ------------------------------------------------------------------


@pytest.mark.parametrize("field,value,match", [
    ("serve_bucket_size", 0, "serve_bucket_size"),
    ("serve_bucket_size", True, "serve_bucket_size"),
    ("serve_flush_s", -1, "serve_flush_s"),
    ("serve_continuous", "yes", "must be a bool"),
    ("serve_dtype", "fp8", "serve_dtype"),
    ("serve_keep_versions", 0, "serve_keep_versions"),
    ("registry_dir", 123, "registry_dir"),
    ("serve_queue_depth", 0, "serve_queue_depth"),
    ("serve_breaker_threshold", True, "serve_breaker_threshold"),
    ("serve_slo_p99_ms", -5, "serve_slo_p99_ms"),
    ("compile_cache_dir", 123, "compile_cache_dir"),
])
def test_config_rejects_bad_serve_fields(field, value, match):
    with pytest.raises(ValueError, match=match):
        _cfg(**{field: value})
    with pytest.raises(ValueError, match=match):
        jconfig.PCAConfig(dim=D, k=K, **{field: value})


def test_config_carries_serve_fields_from_jax(tmp_path):
    jcfg = jconfig.PCAConfig(
        dim=D, k=K, serve_bucket_size=16, serve_flush_s=0.5, serve_continuous=True,
        serve_dtype="int8", serve_keep_versions=2, registry_dir=str(tmp_path),
        serve_queue_depth=9, serve_breaker_threshold=3, serve_slo_p99_ms=50.0,
    )
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    for f in ("serve_bucket_size", "serve_flush_s", "serve_continuous", "serve_dtype",
              "serve_keep_versions", "registry_dir", "serve_queue_depth",
              "serve_breaker_threshold", "serve_slo_p99_ms"):
        assert getattr(cfg, f) == getattr(jcfg, f)
    # the compile cache's directory carries over too (utils/compile_cache.py)
    jcfg = jconfig.PCAConfig(dim=D, k=K, compile_cache_dir=str(tmp_path))
    assert config_from_jax(dataclasses.asdict(jcfg)).compile_cache_dir == str(tmp_path)


def test_quorum_lost_names_the_table():
    class Table:
        num_workers, min_quorum_frac = 4, 0.75

        def live_count(self):
            return 2

        def live_frac(self):
            return 0.5

        def state_counts(self):
            return {"live": 2, "dead": 2}

    err = QuorumLost(Table(), step=7)
    assert err.step == 7 and err.live == 2 and "2/4 workers live" in str(err)
