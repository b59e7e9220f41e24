"""The port's large-d solvers (solvers/distributed.py) and the crossover
slice against the reference's, on the CPU.

Inputs are made with numpy from a seed. Random starts cross over as
numbers: the reference draws its block with ``jax.random.normal(key, (d,
k'))`` and the port takes the same bits as ``v_init``. Where the reference
reaches its Pallas kernel (``fused_factor_matvec``) it runs in interpret
mode. Tolerances: bases within 1e-3 degrees (the port's float64
re-orthonormalized principal angles), ``subspace_residual`` within 1e-5
relative, ``iters_used`` equal; the whole slice within 1e-4 absolute in
``sigma_tilde`` and 0.05 degrees in bases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu.algo import online as jon
from distributed_eigenspaces_tpu.algo.step import make_train_step as jax_train_step
from distributed_eigenspaces_tpu.api.estimator import (
    resolves_feature_sharded as jax_resolves_feature_sharded,
)
from distributed_eigenspaces_tpu.api.runner import extract_dense as jax_extract_dense
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import synthetic as jsyn
from distributed_eigenspaces_tpu.solvers import distributed as jdist
from distributed_eigenspaces_tpu_torch import interop
from distributed_eigenspaces_tpu_torch.algo import online as ton
from distributed_eigenspaces_tpu_torch.algo import step as tstep
from distributed_eigenspaces_tpu_torch.api.estimator import resolves_feature_sharded
from distributed_eigenspaces_tpu_torch.api.runner import extract_dense
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.solvers import distributed as tdist

ANGLE_DEG = 1e-3
SLICE_DEG = 0.05
SIGMA_ATOL = 1e-4
D, K, M = 256, 4, 4
KK = K + 8  # the default oversample of an m*k = 16 wide factor operator


def _normal(shape, seed=0):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def _angle(a, b):
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _worker_stack(rng, m=M, d=D, k=K, noise=0.05):
    """Per-worker orthonormal factors perturbed around one planted truth."""
    truth = np.linalg.qr(rng.standard_normal((d, k)))[0]
    vs = [np.linalg.qr(truth + noise * rng.standard_normal((d, k)))[0] for _ in range(m)]
    return np.stack(vs).astype(np.float32)


def _factor_operator(rng):
    """The scaled factor concatenation ``C (D, M K)`` of a worker stack."""
    vs = _worker_stack(rng)
    c = np.array(jdist._scaled_factor_concat(jnp.asarray(vs), jnp.ones((M,))))
    got = tdist._scaled_factor_concat(torch.from_numpy(vs), torch.ones((M,)))
    np.testing.assert_allclose(got.numpy(), c, rtol=1e-6, atol=1e-7)
    return c


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_dist_subspace_eig_matches(rng, fused, warm):
    c = _factor_operator(rng)
    v0 = np.linalg.qr(c[:, :K])[0].astype(np.float32) if warm else None
    jc = jnp.asarray(c)
    want = jdist.dist_subspace_eig(
        jdist.factor_matvec(jc, None), D, K, iters=16, axis_name=None,
        v0=None if v0 is None else jnp.asarray(v0), oversample=KK - K,
        matvec_gram=jdist.fused_factor_matvec(jc, interpret=True) if fused else None,
    )
    tc = torch.from_numpy(c)
    got = tdist.dist_subspace_eig(
        tdist.factor_matvec(tc), D, K, iters=16, v_init=torch.from_numpy(_normal((D, KK))),
        v0=None if v0 is None else torch.from_numpy(v0), oversample=KK - K,
        matvec_gram=tdist.fused_factor_matvec(tc) if fused else None,
    )
    assert got.shape == (D, K) and got.device.type == "cpu"
    assert _angle(got, np.asarray(want)) <= ANGLE_DEG
    # canonical signs: the largest-|entry| element of each column is positive
    idx = torch.argmax(got.abs(), dim=0)
    assert bool((got[idx, torch.arange(K)] > 0).all())


@pytest.mark.parametrize("fused", [False, True])
def test_tol_stop_uses_the_same_iterations(rng, fused):
    # C C^T = U diag(2 * 0.7^i) U^T: a 6-wide block converges at rate 0.7
    u = np.linalg.qr(rng.standard_normal((D, 24)))[0]
    c = (u * np.sqrt(2.0 * 0.7 ** np.arange(24))).astype(np.float32)
    jc = jnp.asarray(c)
    jout, jinfo = jdist.dist_subspace_eig(
        jdist.factor_matvec(jc, None), D, K, iters=40, axis_name=None, oversample=2,
        tol=1e-4, with_info=True,
        matvec_gram=jdist.fused_factor_matvec(jc, interpret=True) if fused else None,
    )
    tc = torch.from_numpy(c)
    out, info = tdist.dist_subspace_eig(
        tdist.factor_matvec(tc), D, K, iters=40, v_init=_normal((D, K + 2)),
        device="cpu", oversample=2, tol=1e-4, with_info=True,
        matvec_gram=tdist.fused_factor_matvec(tc) if fused else None,
    )
    assert 1 < info["iters_used"] < 40
    assert info["iters_used"] == int(jinfo["iters_used"])
    assert info["residual"] <= 1e-4
    np.testing.assert_allclose(info["residual"], float(jinfo["residual"]), rtol=1e-2)
    assert _angle(out, np.asarray(jout)) <= ANGLE_DEG
    _, fixed = tdist.dist_subspace_eig(
        tdist.factor_matvec(tc), D, K, iters=7, v_init=_normal((D, K)), device="cpu",
        with_info=True,
    )
    assert fixed["iters_used"] == 7 and np.isnan(fixed["residual"])


def test_subspace_residual_matches(rng):
    v = np.linalg.qr(rng.standard_normal((D, 6)))[0].astype(np.float32)
    w = (v @ rng.standard_normal((6, 6)) + 0.01 * rng.standard_normal((D, 6))).astype(np.float32)
    want = float(jdist.subspace_residual(jnp.asarray(v), jnp.asarray(w)))
    got = float(tdist.subspace_residual(torch.from_numpy(v), torch.from_numpy(w)))
    assert abs(got - want) <= 1e-5 * abs(want)
    # a zero w (the dead operator) has residual 0
    assert float(tdist.subspace_residual(torch.from_numpy(v), torch.zeros((D, 6)))) == 0.0


@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
def test_merged_top_k_distributed_matches(rng, mask):
    vs = _worker_stack(rng)
    jmask = None if mask is None else jnp.asarray(mask, jnp.float32)
    want = np.asarray(jdist.merged_top_k_distributed(jnp.asarray(vs), K, mask=jmask, iters=16))
    got = tdist.merged_top_k_distributed(
        torch.from_numpy(vs), K, mask=None if mask is None else torch.tensor(mask),
        iters=16, v_init=torch.from_numpy(_normal((D, KK))),
    )
    assert got.shape == (D, K)
    if mask is not None and not any(mask):
        assert not want.any()
        assert torch.count_nonzero(got) == 0
        return
    assert _angle(got, want) <= ANGLE_DEG


def test_dist_extract_top_k_matches(rng):
    r = 24
    u = np.linalg.qr(rng.standard_normal((D, r)))[0].astype(np.float32)
    s = np.linspace(8.0, 1.0, r).astype(np.float32)
    s[-1] = -0.5  # a negative weight is clamped out of the operator
    want = np.asarray(jdist.dist_extract_top_k(jnp.asarray(u), jnp.asarray(s), K,
                                               iters=16, axis_name=None))
    got = tdist.dist_extract_top_k(torch.from_numpy(u), torch.from_numpy(s), K,
                                   iters=16, v_init=_normal((D, K + 8)))
    assert _angle(got, want) <= ANGLE_DEG
    assert _angle(got, u[:, :K]) <= ANGLE_DEG  # the exact top-k of U S U^T


def test_operators_and_signs_match(rng):
    c = rng.standard_normal((D, 16)).astype(np.float32)
    u = np.linalg.qr(rng.standard_normal((D, 10)))[0].astype(np.float32)
    s = np.linspace(3.0, -1.0, 10).astype(np.float32)
    v = rng.standard_normal((D, 5)).astype(np.float32)
    tv = torch.from_numpy(v)
    for want, got in (
        (jdist.factor_matvec(jnp.asarray(c), None)(jnp.asarray(v)),
         tdist.factor_matvec(torch.from_numpy(c))(tv)),
        (jdist.lowrank_matvec(jnp.asarray(u), jnp.asarray(s), None)(jnp.asarray(v)),
         tdist.lowrank_matvec(torch.from_numpy(u), torch.from_numpy(s))(tv)),
    ):
        assert _rel(got, want) <= 1e-5
    np.testing.assert_array_equal(
        tdist.dist_canonicalize_signs(tv).numpy(),
        np.asarray(jdist.dist_canonicalize_signs(jnp.asarray(v), None)))
    # a dead operator is the identity, so CholeskyQR2 never sees a zero Gram
    dead = tdist.factor_matvec(torch.zeros((D, 16)), alive=torch.tensor(False))
    assert torch.equal(dead(tv), tv)
    q = np.linalg.qr(v)[0].astype(np.float32)
    a = (c @ c.T).astype(np.float32)
    want = np.asarray(jdist.dist_rayleigh_ritz(jnp.asarray(q), jnp.asarray(a @ q), None))
    got = tdist.dist_rayleigh_ritz(torch.from_numpy(q), torch.from_numpy(a @ q))
    assert _rel(got, want) <= 1e-5
    assert tdist._default_oversample(50, 200) == jdist._default_oversample(50, 200) == 8
    assert tdist._default_oversample(4, 6) == jdist._default_oversample(4, 6) == 2


def test_mesh_solves_name_the_roadmap():
    tc = torch.zeros((8, 2))
    # the mesh solves are ported (tests/test_torch_mesh_solvers.py); an axis
    # name resolves against the active mesh; the wire codecs refuse the
    # ring collectives and an unknown codec, as the reference does
    with pytest.raises(RuntimeError, match="mesh_scope"):
        tdist.dist_subspace_eig(tdist.factor_matvec(tc), 8, 1, axis_name="features",
                                device="cpu")
    with pytest.raises(ValueError, match="collectives='xla'"):
        tdist.dist_merged_top_k(tc[None], 1, wire_dtype="bf16", collectives="ring")
    with pytest.raises(ValueError, match="unknown wire dtype"):
        with pmesh.mesh_scope(pmesh.local_mesh("cpu")):
            tdist.dist_merged_top_k(tc[None], 1, wire_dtype="fp8")
    with pytest.raises(ValueError, match="axis_name=None"):
        tdist.dist_subspace_eig(tdist.factor_matvec(tc), 8, 1, axis_name="features",
                                matvec_gram=tdist.fused_factor_matvec(tc))
    with pytest.raises(ValueError, match="v_init"):
        tdist.dist_subspace_eig(tdist.factor_matvec(tc), 8, 1, v_init=torch.zeros((8, 3)))


# -- the whole slice at a small size ------------------------------------------

SLICE = dict(dim=128, k=4, num_workers=4, rows_per_worker=256, num_steps=4,
             solver="distributed", eigh_crossover_d=64, backend="local")


def _slice_steps(seed=0):
    spec = jsyn.planted_spectrum(128, k_planted=4, seed=seed)
    rng = np.random.default_rng(seed + 1)
    z = rng.standard_normal((4, 4, 256, 128)).astype(np.float32)
    x = (z * np.sqrt(np.asarray(spec.eigenvalues))) @ np.asarray(spec.basis).T
    return x.astype(np.float32), np.asarray(spec.top_k(4))


def test_slice_train_step_matches(monkeypatch):
    """Cold then warm steps with the crossover merge on both sides: the
    same cold start ``v0`` and merge start ``v_init`` bits."""
    x, truth = _slice_steps()
    jcfg = JaxConfig(**SLICE)
    cfg = PCAConfig(**SLICE)
    assert cfg.uses_distributed_solve() and jcfg.uses_distributed_solve()
    merges = []
    real = tstep.merged_top_k_distributed
    monkeypatch.setattr(tstep, "merged_top_k_distributed",
                        lambda *a, **kw: merges.append(kw["iters"]) or real(*a, **kw))
    jstep = jax_train_step(jcfg, mesh=None, donate=False)
    step = dett.make_train_step(cfg, device="cpu", v0=_normal((128, 4)),
                                v_init=_normal((128, 12)))
    js, ts = jon.OnlineState.initial(128), ton.OnlineState.initial(128, device="cpu")
    jv = tv = None
    for t in range(4):
        js, jv = jstep(js, jnp.asarray(x[t])) if jv is None else jstep(js, jnp.asarray(x[t]), jv)
        ts, tv = step(ts, torch.from_numpy(x[t]), tv)
        assert _angle(tv, np.asarray(jv)) <= SLICE_DEG
    # every merge, warm ones too, runs cfg.subspace_iters iterations
    assert merges == [16] * 4
    np.testing.assert_allclose(ts.sigma_tilde.numpy(), np.asarray(js.sigma_tilde),
                               atol=SIGMA_ATOL, rtol=0)
    w = extract_dense(cfg, ts.sigma_tilde, v0=_normal((128, 4)))
    jw = np.asarray(jax_extract_dense(jcfg, js.sigma_tilde))
    assert _angle(w, jw) <= SLICE_DEG
    assert _angle(w, truth) <= 1.0


def test_slice_estimator_fits_through_the_crossover_merge(monkeypatch):
    x, truth = _slice_steps(seed=2)
    data = x.reshape(-1, 128)
    merges = []
    real = tstep.merged_top_k_distributed
    monkeypatch.setattr(tstep, "merged_top_k_distributed",
                        lambda *a, **kw: merges.append(1) or real(*a, **kw))
    est = dett.OnlineDistributedPCA(PCAConfig(**SLICE), device="cpu",
                                    v0=_normal((128, 4)), v_init=_normal((128, 12)))
    w = est.fit(data).components_
    assert est.trainer_used_ == "scan" and len(merges) == 4
    assert _angle(w, truth) <= 1.0
    # at the crossover itself the exact merge runs (strictly above, as in the reference)
    merges.clear()
    at = dett.OnlineDistributedPCA(PCAConfig(**{**SLICE, "eigh_crossover_d": 128}),
                                   device="cpu", v0=_normal((128, 4)))
    assert _angle(at.fit(data).components_, w) <= SLICE_DEG and merges == []


# -- configuration -----------------------------------------------------------

BASE = dict(dim=128, k=2, num_workers=2, rows_per_worker=8, num_steps=1)


def test_crossover_policy_is_config_resolved():
    hi = PCAConfig(solver="distributed", eigh_crossover_d=64, **BASE)
    assert hi.uses_distributed_solve() and hi.resolved_local_solver() == "subspace"
    assert hi.resolved_warm_start() == 2
    assert not PCAConfig(solver="distributed", eigh_crossover_d=128, **BASE).uses_distributed_solve()
    assert not PCAConfig(solver="eigh", eigh_crossover_d=64, **BASE).uses_distributed_solve()
    for bad in (0, -1, True, "big"):
        with pytest.raises(ValueError, match="eigh_crossover_d"):
            PCAConfig(eigh_crossover_d=bad, **BASE)


@pytest.mark.parametrize(
    "kw",
    [dict(solver_tol=0.0), dict(solver_tol=1.0), dict(solver_tol=True),
     dict(solver_tol="1e-3"), dict(components_axis_size=0),
     dict(components_axis_size=True), dict(components_axis_size=2, solver="distributed"),
     dict(components_axis_size=3, solver="deflation"),
     dict(components_axis_size=4, k=2, solver="deflation")],
)
def test_solver_knobs_reject_like_the_reference(kw):
    kw = {**BASE, **kw}
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        PCAConfig(**kw)


@pytest.mark.parametrize(
    "kw", [dict(solver="deflation"), dict(solver="deflation", components_axis_size=2)]
)
def test_deflation_names_the_roadmap(kw):
    # solvers/deflation.py is ported: the configuration builds and resolves
    # its dispatch as the reference's does
    jcfg, cfg = JaxConfig(**BASE, **kw), PCAConfig(**BASE, **kw)
    for name in ("uses_deflation_solve", "uses_distributed_solve",
                 "resolved_local_solver", "resolved_warm_start"):
        assert getattr(cfg, name)() == getattr(jcfg, name)(), name


def test_interop_carries_the_solver_fields():
    jcfg = JaxConfig(**{**SLICE, "solver_tol": 1e-4, "subspace_iters": 12})
    cfg = interop.config_from_jax(dataclasses.asdict(jcfg))
    assert (cfg.solver, cfg.eigh_crossover_d, cfg.solver_tol, cfg.components_axis_size) == (
        "distributed", 64, 1e-4, 1)
    for d in (64, 65, 128):
        j = dataclasses.replace(jcfg, dim=d)
        t = interop.config_from_jax(dataclasses.asdict(j))
        assert t.uses_distributed_solve() == j.uses_distributed_solve() == (d > 64)
        assert t.resolved_warm_start() == j.resolved_warm_start()


@pytest.mark.parametrize("entry", ["fit", "fit_stream"])
@pytest.mark.parametrize("backend", ["auto", "local", "feature_sharded"])
@pytest.mark.parametrize("dim,k", [(64, 2), (64, 32), (2048, 32), (4096, 2)])
def test_refuses_exactly_where_the_reference_goes_feature_sharded(entry, backend, dim, k):
    whole = entry == "fit"
    kw = dict(dim=dim, k=k, num_workers=2, rows_per_worker=8, num_steps=1,
              solver="subspace", subspace_iters=2, backend=backend)
    from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import (
        LowRankState,
        SketchState,
    )

    # the port no longer refuses: it goes feature-sharded exactly where the
    # reference does, and stays dense elsewhere
    refuse = jax_resolves_feature_sharded(JaxConfig(**kw), whole_fit=whole)
    cfg = PCAConfig(**kw)
    assert resolves_feature_sharded(cfg, whole_fit=whole) == refuse
    data = np.random.default_rng(0).standard_normal((16, dim)).astype(np.float32)
    est = dett.OnlineDistributedPCA(cfg, device="cpu")
    if whole:
        run = lambda: est.fit(data)  # noqa: E731
    else:
        run = lambda: est.fit_stream(iter(torch.from_numpy(data).reshape(1, 2, 8, dim)))  # noqa: E731
    assert run().components_.shape == (dim, k)
    if not refuse:
        assert isinstance(est.state, ton.OnlineState)
    elif whole and dim * k >= 65536:
        assert isinstance(est.state, SketchState) and est.trainer_used_ == "sketch"
    else:
        assert isinstance(est.state, LowRankState)
        assert est.trainer_used_ == ("scan" if whole else "step")
