"""The port's parallel-deflation solve and elastic k (solvers/deflation.py),
``solver="deflation"`` and ``publish_grown`` against the reference's, on the
CPU.

Inputs are made with numpy from a seed and handed to both packages. Random
starts cross over as numbers: the reference draws ``jax.random.normal(key,
(d, k))`` and the port takes that block as ``v_init``. Tolerances, each
with its reason:

- the same converged solve in both packages: 1e-3 degrees (the port's
  float64 re-orthonormalized principal angles) and 1e-4 absolute in the
  entries (fp32 products summed in another order);
- a ``tol``-stopped solve: per-lane ``iters_used`` within one sweep of the
  reference's (a residual on the ``tol`` edge can fall on either side), and
  0.5 degrees between the packages: the stop leaves the last lanes short of
  convergence (residual up to ``tol``), where the two packages' fp32
  rounding moves the iterate by up to 0.17 degrees (measured at 4 lanes);
- each lane against the dense eigh on the geometric operand: 0.5 degrees
  (the reference's per-lane budget, ``tests/test_deflation.py``);
- the deflation merge against the exact low-rank merge: 0.5 degrees of
  the whole k-subspace (the mean projector's top block is near degenerate,
  so per-lane blocks are not defined there);
- whole fits: 0.05 degrees and 1e-4 absolute in ``sigma_tilde`` to the
  reference's fit on the same blocks and starts, 1 degree to the planted
  truth;
- the grown basis: its prefix bit-equal to the parent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu.algo import online as jon
from distributed_eigenspaces_tpu.algo.step import make_train_step as jax_train_step
from distributed_eigenspaces_tpu.api.estimator import OnlineDistributedPCA as JaxPCA
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data.synthetic import planted_spectrum as jax_planted
from distributed_eigenspaces_tpu.serving.registry import EigenbasisRegistry as JaxRegistry
from distributed_eigenspaces_tpu.solvers import deflation as jdefl
from distributed_eigenspaces_tpu.solvers.distributed import lowrank_matvec as jax_lowrank_matvec
from distributed_eigenspaces_tpu_torch.algo import online as ton
from distributed_eigenspaces_tpu_torch.algo import step as tstep
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import (
    merged_top_k_lowrank,
    principal_angles_degrees,
)
from distributed_eigenspaces_tpu_torch.serving import EigenbasisRegistry
from distributed_eigenspaces_tpu_torch.solvers import deflation as tdefl
from distributed_eigenspaces_tpu_torch.solvers.distributed import lowrank_matvec

D, K, LANES, R = 128, 8, 4, 16
KB = K // LANES
ITERS = 64
TOL = 1e-3
SAME_DEG = 1e-3
SAME_ABS = 1e-4
BUDGET_DEG = 0.5
FIT_DEG = 0.05
SIGMA_ATOL = 1e-4


def _normal(shape, seed=0):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def _angle(a, b) -> float:
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _lane_angles(v, u, lanes=LANES, kb=KB):
    return [_angle(np.asarray(v)[:, i * kb:(i + 1) * kb], np.asarray(u)[:, i * kb:(i + 1) * kb])
            for i in range(lanes)]


@pytest.fixture(scope="module")
def operand():
    """The reference test's operand: ``U diag(s) U^T`` with a geometric
    spectrum, a 2x gap at every lane boundary."""
    rng = np.random.default_rng(42)
    u = np.linalg.qr(rng.standard_normal((D, R)))[0].astype(np.float32)
    s = (8.0 * 0.5 ** np.arange(R)).astype(np.float32)
    return u, s


def _both_matvecs(u, s):
    return (jax_lowrank_matvec(jnp.asarray(u), jnp.asarray(s)),
            lowrank_matvec(torch.from_numpy(u), torch.from_numpy(s)))


# -- the batched lanes --------------------------------------------------------


@pytest.mark.parametrize("tol", [None, TOL])
@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_deflation_eig_matches_the_reference(operand, lanes, tol):
    u, s = operand
    jmv, tmv = _both_matvecs(u, s)
    jv, jinfo = jdefl.deflation_eig(jmv, D, K, lanes=lanes, iters=ITERS, tol=tol,
                                    key=jax.random.PRNGKey(0), with_info=True)
    tv, tinfo = tdefl.deflation_eig(tmv, D, K, lanes=lanes, iters=ITERS, tol=tol,
                                    v_init=_normal((D, K)), device="cpu", with_info=True)
    assert tv.shape == (D, K) and tv.dtype == torch.float32
    assert (tinfo["lanes"], tinfo["lane_width"]) == (jinfo["lanes"], jinfo["lane_width"])
    want = [int(x) for x in np.asarray(jinfo["iters_used"])]
    assert all(abs(a - b) <= 1 for a, b in zip(tinfo["iters_used"], want))
    if tol is None:
        assert _angle(tv, jv) <= SAME_DEG
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=SAME_ABS, rtol=0)
        assert tinfo["iters_used"] == [ITERS] * lanes and tinfo["syncs"] == 0
        assert all(np.isnan(tinfo["residual"]))
        assert max(_lane_angles(tv, u, lanes, K // lanes)) < BUDGET_DEG
    else:
        assert _angle(tv, jv) <= BUDGET_DEG
        # one host read of the residuals per sweep, every lane stopped early
        assert tinfo["syncs"] == max(tinfo["iters_used"])
        assert max(tinfo["residual"]) <= tol and max(tinfo["iters_used"]) < ITERS
        if lanes == LANES:  # the reference's per-lane gate (narrow lanes)
            assert max(_lane_angles(tv, u)) < BUDGET_DEG


def test_deflation_warm_start_matches_the_reference(operand):
    u, s = operand
    jmv, tmv = _both_matvecs(u, s)
    rng = np.random.default_rng(7)
    v0 = np.linalg.qr(u[:, :K].astype(np.float64)
                      + 0.02 * rng.standard_normal((D, K)))[0].astype(np.float32)
    jv = jdefl.deflation_eig(jmv, D, K, lanes=LANES, iters=12,
                             key=jax.random.PRNGKey(0), v0=jnp.asarray(v0))
    tv = tdefl.deflation_eig(tmv, D, K, lanes=LANES, iters=12, v_init=_normal((D, K)),
                             v0=torch.from_numpy(v0))
    assert _angle(tv, jv) <= SAME_DEG
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=SAME_ABS, rtol=0)
    assert max(_lane_angles(tv, u)) < BUDGET_DEG
    # the caller's start is not written to
    v_init = torch.from_numpy(_normal((D, K)))
    before = v_init.clone()
    tdefl.deflation_eig(tmv, D, K, lanes=LANES, iters=2, v_init=v_init, v0=torch.from_numpy(v0))
    assert torch.equal(v_init, before)


def test_deflation_rejects_bad_lanes_like_the_reference(operand):
    u, s = operand
    jmv, tmv = _both_matvecs(u, s)
    for lanes in (0, 16, 3):
        with pytest.raises(ValueError) as ours:
            tdefl.deflation_eig(tmv, D, K, lanes=lanes, device="cpu")
        with pytest.raises(ValueError) as theirs:
            jdefl.deflation_eig(jmv, D, K, lanes=lanes)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="v_init"):
        tdefl.deflation_eig(tmv, D, K, lanes=2, v_init=np.zeros((D, K + 1), np.float32),
                            device="cpu")


# -- the merge twins ----------------------------------------------------------


def _factor_stack(rng, m=4, noise=0.05):
    truth = np.linalg.qr(rng.standard_normal((D, K)))[0]
    return np.stack([np.linalg.qr(truth + noise * rng.standard_normal((D, K)))[0]
                     for _ in range(m)]).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_merged_top_k_deflation_matches_the_reference_and_the_exact_merge(rng, masked):
    vs = _factor_stack(rng)
    mask = np.array([1, 0, 1, 1], np.float32) if masked else None
    jv = jdefl.merged_top_k_deflation(jnp.asarray(vs), K, lanes=LANES, iters=24,
                                      mask=None if mask is None else jnp.asarray(mask))
    tv = tdefl.merged_top_k_deflation(torch.from_numpy(vs), K, lanes=LANES, iters=24,
                                      mask=mask, v_init=_normal((D, K)))
    assert _angle(tv, jv) <= SAME_DEG
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=SAME_ABS, rtol=0)
    exact = merged_top_k_lowrank(torch.from_numpy(vs), K,
                                 None if mask is None else torch.from_numpy(mask))
    assert _angle(tv, exact) < BUDGET_DEG


def test_merged_top_k_deflation_all_masked_zeros(rng):
    vs = torch.from_numpy(_factor_stack(rng, noise=1.0))
    got = tdefl.merged_top_k_deflation(vs, K, lanes=LANES, mask=torch.zeros(4), iters=8)
    assert torch.equal(got, torch.zeros((D, K)))
    got, info = tdefl.merged_top_k_deflation(vs, K, lanes=LANES, mask=np.zeros(4), iters=8,
                                             tol=TOL, with_info=True)
    assert torch.equal(got, torch.zeros((D, K)))
    # a dead operator reads converged on every lane after one sweep
    assert info["iters_used"] == [1] * LANES


def test_mesh_variants_name_the_roadmap():
    # the mesh variants are ported (tests/test_torch_mesh_solvers.py), their
    # wire codecs and ring collectives too; a codec with the ring is
    # refused and an unknown codec named, as in the reference
    with pytest.raises(ValueError, match="unknown wire dtype"):
        tdefl.dist_deflation_eig(None, D, K, lanes=LANES, wire_dtype="fp8")
    with pytest.raises(ValueError, match="collectives='xla'"):
        tdefl.dist_merged_top_k_deflation(torch.zeros((4, D, K)), K, lanes=LANES,
                                          collectives="ring", wire_dtype="int8")


# -- elastic k ----------------------------------------------------------------


@pytest.mark.parametrize("tol", [None, TOL])
def test_grow_basis_matches_the_reference_with_a_bit_equal_prefix(operand, tol):
    u, s = operand
    jmv, tmv = _both_matvecs(u, s)
    k0 = 4
    parent = u[:, :k0]
    iters = ITERS if tol is not None else 32
    jg, jinfo = jdefl.grow_basis(jmv, jnp.asarray(parent), K, iters=iters, tol=tol,
                                 key=jax.random.PRNGKey(5), with_info=True)
    tg, tinfo = tdefl.grow_basis(tmv, torch.from_numpy(parent), K, iters=iters, tol=tol,
                                 v_init=_normal((D, K - k0), seed=5), with_info=True)
    assert tg.shape == (D, K)
    np.testing.assert_array_equal(tg[:, :k0].numpy(), parent)
    assert _angle(tg[:, k0:], np.asarray(jg)[:, k0:]) <= SAME_DEG
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=SAME_ABS, rtol=0)
    assert _angle(tg[:, k0:], u[:, k0:K]) < BUDGET_DEG
    assert np.abs(tg.numpy().T @ tg.numpy() - np.eye(K)).max() < 1e-5
    assert abs(tinfo["iters_used"] - int(jinfo["iters_used"])) <= 1
    if tol is not None:
        assert tinfo["iters_used"] < iters and tinfo["residual"] <= tol
        assert tinfo["syncs"] == tinfo["iters_used"]
    # grow_directions alone is the suffix
    d_new = tdefl.grow_directions(tmv, torch.from_numpy(parent), K - k0, iters=iters, tol=tol,
                                  v_init=_normal((D, K - k0), seed=5))
    assert torch.equal(d_new, tg[:, k0:])


def test_grow_keeps_orthogonal_where_the_new_spectrum_is_at_rounding():
    """A grow on a fit's ``sigma_tilde`` (the CLI's ``--grow-k`` operand:
    eigenvalues ~1 on the parent's span, ~5e-7 past it) deflates a block
    whose new part sits at fp32 rounding of the parent's. The reference's
    single deflation leaves the grown basis ~8e-3 off orthonormal here; the
    port's finish deflates once more and keeps ||V^T V - I|| under 1e-5."""
    d, k = 128, 5
    cfg = PCAConfig(dim=d, k=k, num_workers=4, rows_per_worker=128, num_steps=10,
                    solver="subspace", subspace_iters=12, backend="local")
    spec = dett.planted_subspace(d, k_planted=k, gap=20.0, decay=0.8, noise=0.01, seed=0)
    est = dett.OnlineDistributedPCA(cfg, device="cpu", v0=_normal((d, k))).fit(
        spec.sample(np.random.default_rng(0), 10 * 4 * 128))
    sig, parent = est.state.sigma_tilde.float(), est.components_
    jsig = jnp.asarray(sig.numpy())
    jg = np.asarray(jdefl.grow_basis(
        lambda v: jnp.matmul(jsig, v, precision=jax.lax.Precision.HIGHEST),
        jnp.asarray(parent.numpy()), 2 * k, iters=12, key=jax.random.PRNGKey(7)))
    tg = tdefl.grow_basis(lambda v: sig @ v, parent, 2 * k, iters=12,
                          v_init=_normal((d, k), seed=7))
    assert torch.equal(tg[:, :k], parent)
    tg = tg.numpy()
    assert np.abs(tg.T @ tg - np.eye(2 * k)).max() <= 1e-5
    assert np.abs(jg.T @ jg - np.eye(2 * k)).max() > 1e-5  # the reference's fault


def test_grow_basis_rejects_shrink_like_the_reference(operand):
    u, s = operand
    jmv, tmv = _both_matvecs(u, s)
    for k_prime in (4, 3):
        with pytest.raises(ValueError) as ours:
            tdefl.grow_basis(tmv, torch.from_numpy(u[:, :4]), k_prime)
        with pytest.raises(ValueError) as theirs:
            jdefl.grow_basis(jmv, jnp.asarray(u[:, :4]), k_prime)
        assert str(ours.value) == str(theirs.value)


# -- configuration ------------------------------------------------------------

CFG = dict(dim=D, k=K, num_workers=4, rows_per_worker=32, num_steps=2)


@pytest.mark.parametrize("kw,match", [
    (dict(solver="subspace", components_axis_size=4), "requires solver='deflation'"),
    (dict(solver="deflation", components_axis_size=16), "exceeds k"),
    (dict(solver="deflation", components_axis_size=4, k=6), "divide evenly"),
    (dict(solver="deflation", solver_tol=2.0), "solver_tol"),
    (dict(solver="deflation", components_axis_size=0), "components_axis_size"),
])
def test_config_errors_match_the_reference(kw, match):
    kw = {**CFG, **kw}
    with pytest.raises(ValueError, match=match):
        JaxConfig(**kw)
    with pytest.raises(ValueError, match=match):
        PCAConfig(**kw)


@pytest.mark.parametrize("solver", ["deflation", "distributed", "subspace", "eigh"])
@pytest.mark.parametrize("crossover", [32, 128, 4096])
def test_config_dispatch_matches_the_reference(solver, crossover):
    kw = {**CFG, "solver": solver, "eigh_crossover_d": crossover}
    if solver == "deflation":
        kw["components_axis_size"] = LANES
    ours, theirs = PCAConfig(**kw), JaxConfig(**kw)
    for name in ("uses_deflation_solve", "uses_distributed_solve",
                 "resolved_local_solver", "resolved_warm_start"):
        assert getattr(ours, name)() == getattr(theirs, name)(), name
    knobs = tstep.merge_knobs(ours)
    assert knobs["deflate_lanes"] == (LANES if ours.uses_deflation_solve() else None)
    start = tstep.merge_start(ours, device="cpu")
    if ours.uses_deflation_solve():  # the lanes take no oversample
        assert tuple(start.shape) == (D, K)
    elif ours.uses_distributed_solve():
        assert tuple(start.shape) == (D, K + 8)
    else:
        assert start is None


# -- the fits -----------------------------------------------------------------

FIT = dict(dim=D, k=K, num_workers=4, rows_per_worker=64, num_steps=4, backend="local",
           eigh_crossover_d=32, subspace_iters=24, solver="deflation",
           components_axis_size=LANES)


def _fit_data():
    spec = jax_planted(D, k_planted=K, gap=20.0, noise=0.01, seed=0)
    data = np.asarray(spec.sample(jax.random.PRNGKey(1), 4 * 4 * 64))
    return data, np.asarray(spec.top_k(K))


def test_estimator_fit_takes_the_deflation_merge_like_the_reference(monkeypatch):
    """The reference test's fit (``tests/test_deflation.py``): the whole
    fit above the crossover runs the lanes on every merge and lands where
    the reference's does."""
    data, truth = _fit_data()
    merges = []
    real = tstep.merged_top_k_deflation
    monkeypatch.setattr(tstep, "merged_top_k_deflation",
                        lambda *a, **kw: merges.append(kw["lanes"]) or real(*a, **kw))
    jest = JaxPCA(JaxConfig(**FIT)).fit(data)
    est = dett.OnlineDistributedPCA(PCAConfig(**FIT), device="cpu", v0=_normal((D, K)),
                                    v_init=_normal((D, K)))
    est.fit(data)
    assert est.trainer_used_ == jest.trainer_used_ == "scan"
    assert merges == [LANES] * 4
    np.testing.assert_allclose(est.state.sigma_tilde.numpy(),
                               np.asarray(jest.state.sigma_tilde), atol=SIGMA_ATOL, rtol=0)
    assert _angle(est.components_, jest.components_) <= FIT_DEG
    assert _angle(est.components_, truth) < 1.0
    # the distributed twin at the same knobs agrees within the budget
    twin = dett.OnlineDistributedPCA(PCAConfig(**{**FIT, "solver": "distributed",
                                                 "components_axis_size": 1}),
                                     device="cpu", v0=_normal((D, K)))
    assert _angle(est.components_, twin.fit(data).components_) < BUDGET_DEG


def test_train_step_takes_the_deflation_merge_like_the_reference():
    data, truth = _fit_data()
    x = data.reshape(4, 4, 64, D)
    cfg, jcfg = PCAConfig(**FIT), JaxConfig(**FIT)
    jstep = jax_train_step(jcfg, mesh=None, donate=False)
    step = dett.make_train_step(cfg, device="cpu", v0=_normal((D, K)), v_init=_normal((D, K)))
    js, ts = jon.OnlineState.initial(D), ton.OnlineState.initial(D, device="cpu")
    jv = tv = None
    for t in range(4):
        js, jv = jstep(js, jnp.asarray(x[t])) if jv is None else jstep(js, jnp.asarray(x[t]), jv)
        ts, tv = step(ts, torch.from_numpy(x[t]), tv)
        assert _angle(tv, np.asarray(jv)) <= FIT_DEG
    np.testing.assert_allclose(ts.sigma_tilde.numpy(), np.asarray(js.sigma_tilde),
                               atol=SIGMA_ATOL, rtol=0)


def test_segmented_fit_takes_the_deflation_merge(monkeypatch, tmp_path):
    data, truth = _fit_data()
    merges = []
    real = tstep.merged_top_k_deflation
    monkeypatch.setattr(tstep, "merged_top_k_deflation",
                        lambda *a, **kw: merges.append(1) or real(*a, **kw))
    kw = dict(device="cpu", v0=_normal((D, K)), v_init=_normal((D, K)))
    scan = dett.OnlineDistributedPCA(PCAConfig(**FIT), **kw).fit(data)
    seg = dett.OnlineDistributedPCA(PCAConfig(**FIT), checkpoint_dir=str(tmp_path),
                                    segment=2, **kw).fit(data)
    assert seg.trainer_used_ == "segmented" and len(merges) == 8
    assert torch.equal(seg.state.sigma_tilde, scan.state.sigma_tilde)


# -- publish_grown ------------------------------------------------------------


def _grown(operand, k0=4):
    u, s = operand
    parent = u[:, :k0].copy()
    _, tmv = _both_matvecs(u, s)
    grown = tdefl.grow_basis(tmv, torch.from_numpy(parent), K, iters=32,
                             v_init=_normal((D, K - k0), seed=5))
    return parent, grown


def test_publish_grown_links_the_lineage_and_recovers_it(operand, tmp_path):
    parent, grown = _grown(operand)
    reg = EigenbasisRegistry(keep=4, registry_dir=str(tmp_path))
    bv0 = reg.publish(parent, step=7, lineage={"producer": "OnlineDistributedPCA"})
    bv1 = reg.publish_grown(bv0, grown, lineage={"note": "widened"})
    assert bv1.signature == (D, K) and bv1.step == 7
    assert bv1.lineage == {"producer": "grow_basis", "grew_from": bv0.version,
                           "k_from": 4, "k_to": K, "note": "widened"}
    np.testing.assert_array_equal(bv1.v, grown.numpy())
    # by id too
    assert reg.publish_grown(bv0.version, grown).lineage["grew_from"] == bv0.version
    # a fresh registry of either package recovers the lineage and the bits
    for fresh in (EigenbasisRegistry(registry_dir=str(tmp_path)),
                  JaxRegistry(registry_dir=str(tmp_path))):
        got = fresh.get(bv1.version)
        assert {k: got.lineage[k] for k in ("grew_from", "k_from", "k_to")} == {
            "grew_from": bv0.version, "k_from": 4, "k_to": K}
        np.testing.assert_array_equal(np.asarray(got.v), grown.numpy())


def test_publish_grown_refuses_like_the_reference(operand):
    parent, grown = _grown(operand)
    ours, theirs = EigenbasisRegistry(), JaxRegistry()
    p_ours, p_theirs = ours.publish(parent), theirs.publish(parent)
    drifted = grown.numpy().copy()
    drifted[:, 0] += 1e-3
    cases = (drifted, parent, np.zeros((D + 1, K), np.float32))
    for bad in cases:
        with pytest.raises(ValueError) as e_ours:
            ours.publish_grown(p_ours, bad)
        with pytest.raises(ValueError) as e_theirs:
            theirs.publish_grown(p_theirs, bad)
        assert str(e_ours.value) == str(e_theirs.value)
    assert "prefix drifts" in str(pytest.raises(
        ValueError, ours.publish_grown, p_ours, drifted).value)
    assert ours.versions() == [p_ours.version]
    # within prefix_atol is accepted
    near = grown.numpy().copy()
    near[:, 0] += 1e-6
    assert ours.publish_grown(p_ours, near).lineage["k_to"] == K
