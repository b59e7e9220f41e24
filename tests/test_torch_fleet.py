"""The port's multi-tenant fleet against the reference's.

``parallel/fleet.py`` (fit_fleet, FleetPCA, FleetServer, stage_fleet, the
signatures), ``OnlineDistributedPCA(trainer="fleet")``,
``EigenbasisRegistry.publish_fleet`` and ``runtime/prewarm.py``, each fed
the same numpy inputs as the JAX package's (``tests/test_fleet.py``'s
cases that need no supervisor or metrics logger). The cold start is the
reference's own ``jax.random.normal(PRNGKey(0), (d, k))``, handed to the
port as ``v0``. Tolerances are the reference test's: ``sigma_tilde`` at
``rtol=1e-5, atol=1e-6``, components within 0.2 degrees of the JAX result
and 1 degree of the planted top-k (the port's float64 angles). Added: a
padding tenant changes no real tenant, one unmasked fleet fit calls the
Gram once, a fleet on two gloo ranks makes no collective inside its fit,
and ``publish_fleet``'s lineage is the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.api.estimator import OnlineDistributedPCA as JaxPCA
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data.synthetic import planted_spectrum
from distributed_eigenspaces_tpu.parallel import fleet as jfleet
from distributed_eigenspaces_tpu.serving.registry import EigenbasisRegistry as JaxRegistry
import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
from distributed_eigenspaces_tpu_torch.algo.scan import make_scan_fit
from distributed_eigenspaces_tpu_torch.api.runner import extract_dense
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import fleet
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel import worker_pool
from distributed_eigenspaces_tpu_torch.runtime.prewarm import Prewarmer, registry_signatures
from distributed_eigenspaces_tpu_torch.serving.registry import EigenbasisRegistry
from distributed_eigenspaces_tpu_torch.serving.transform import TransformEngine

import torch_fleet_ranks as ranks

D, K, M, N, T = 64, 3, 4, 32, 6
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
DEG_JAX = 0.2
DEG_TRUTH = 1.0


def _base(**kw):
    base = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
                solver="subspace", subspace_iters=10, backend="local")
    base.update(kw)
    return base


def _cfgs(**kw):
    base = _base(**kw)
    return PCAConfig(**base), JaxConfig(**base)


def _v0(k=K):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (D, k), jnp.float32))


@pytest.fixture(scope="module")
def spec():
    return planted_spectrum(D, k_planted=K, gap=20.0, noise=0.01, seed=0)


def _problem(spec, b, t=T):
    return np.stack([
        np.asarray(spec.sample(jax.random.PRNGKey(1000 * b + i), M * N)).reshape(M, N, D)
        for i in range(t)
    ]).astype(np.float32)


def _angle(a, b):
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _sigma(st, b=None):
    s = st.sigma_tilde if b is None else st.sigma_tilde[b]
    return s.detach().cpu().numpy() if isinstance(s, torch.Tensor) else np.asarray(s)


def _fit(cfg, probs, **kw):
    return fleet.fit_fleet(cfg, probs, mesh=None, device=CPU, v0=_v0(cfg.k), **kw)


def _solo(cfg, problem, masks=None):
    fit = make_scan_fit(cfg, device=CPU, v0=_v0(cfg.k), masked=masks is not None)
    st0 = OnlineState.initial(cfg.dim, device=CPU)
    x = torch.from_numpy(problem)
    return fit(st0, x)[0] if masks is None else fit(st0, x, masks)[0]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- numerical equivalence -------------------------------------------------------


def test_fleet_matches_solo_per_tenant(spec):
    cfg, jcfg = _cfgs()
    probs = [_problem(spec, b) for b in range(4)]
    res = _fit(cfg, probs)
    jres = jfleet.fit_fleet(jcfg, probs, mesh=None)
    assert res.components.shape == (4, D, K) and res.v_bars.shape == (4, T, D, K)
    for b in range(4):
        _close(_sigma(res.states, b), np.asarray(jres.states.sigma_tilde[b]))
        assert int(res.states.step[b]) == int(jres.states.step[b]) == T
        assert _angle(res.components[b], jres.components[b]) < DEG_JAX
        for t in range(T):
            assert _angle(res.v_bars[b, t], jres.v_bars[b, t]) < DEG_JAX
        # the port's own solo fit on the same blocks and start
        st = _solo(cfg, probs[b])
        _close(_sigma(res.states, b), _sigma(st))
        w_solo = extract_dense(cfg, st.sigma_tilde, v0=torch.from_numpy(_v0()))
        assert _angle(res.components[b], w_solo) < DEG_JAX
        assert _angle(res.components[b], spec.top_k(K)) < DEG_TRUTH


def test_fleet_ragged_t_freezes_carry(spec):
    """An early-finishing tenant's result is exactly its own shorter fit:
    the active mask freezes state, step counter and warm carry."""
    cfg, jcfg = _cfgs()
    t_short = 4
    probs = [_problem(spec, 0), _problem(spec, 1, t_short), _problem(spec, 2)]
    res = _fit(cfg, probs)
    jres = jfleet.fit_fleet(jcfg, probs, mesh=None)
    assert [int(s) for s in res.states.step] == [T, t_short, T]
    assert [int(s) for s in jres.states.step] == [T, t_short, T]
    for b in range(3):
        _close(_sigma(res.states, b), np.asarray(jres.states.sigma_tilde[b]))
    _close(_sigma(res.states, 1), _sigma(_solo(cfg, probs[1])))
    # the frozen tail reports the carried basis, not padding results
    assert np.isfinite(res.v_bars).all()
    np.testing.assert_array_equal(res.v_bars[1, t_short], res.v_bars[1, T - 1])
    np.testing.assert_array_equal(res.v_bars[1, t_short - 1], res.v_bars[1, T - 1])


def test_fleet_masked_matches_solo_masked(spec):
    """Per-tenant worker masks run the solo masked body's semantics, tenant
    by tenant; an all-live tenant in the masked build equals the unmasked
    solo fit, and a ragged tenant its own shorter fit."""
    cfg, jcfg = _cfgs()
    probs = [_problem(spec, b) for b in range(3)] + [_problem(spec, 3, 4)]
    masks0 = np.ones((T, M), np.float32)
    masks0[1, 0] = 0.0
    masks0[3, :] = 0.0
    masks = [masks0, None, None, None]
    res = _fit(cfg, probs, worker_masks=masks)
    jres = jfleet.fit_fleet(jcfg, probs, mesh=None, worker_masks=masks)
    assert res.batch.masks is not None and res.batch.masks.shape == (4, T, M)
    for b in range(4):
        _close(_sigma(res.states, b), np.asarray(jres.states.sigma_tilde[b]))
        assert _angle(res.components[b], jres.components[b]) < DEG_JAX
    # the all-masked step merges to zeros in both
    assert not res.v_bars[0, 3].any() and not np.asarray(jres.v_bars[0, 3]).any()
    _close(_sigma(res.states, 0), _sigma(_solo(cfg, probs[0], masks0)))
    _close(_sigma(res.states, 2), _sigma(_solo(cfg, probs[2])))
    _close(_sigma(res.states, 3), _sigma(_solo(cfg, probs[3])))
    assert int(res.states.step[3]) == 4


def test_fleet_eigh_solver_path(spec):
    """The all-cold (eigh) fleet body: same equivalence, no warm carry."""
    cfg, jcfg = _cfgs(solver="eigh")
    probs = [_problem(spec, b) for b in range(2)]
    res = _fit(cfg, probs)
    jres = jfleet.fit_fleet(jcfg, probs, mesh=None)
    for b in range(2):
        _close(_sigma(res.states, b), np.asarray(jres.states.sigma_tilde[b]))
        _close(_sigma(res.states, b), _sigma(_solo(cfg, probs[b])))
        assert _angle(res.components[b], jres.components[b]) < DEG_JAX


@pytest.mark.parametrize("discount", ["1/t", "notebook"])
def test_fleet_discount_rules_fold_at_each_tenants_step(spec, discount):
    """The step-dependent discounts: each tenant folds at its own step
    count's weight (a ragged tenant included), as its solo fit does."""
    cfg, jcfg = _cfgs(discount=discount)
    probs = [_problem(spec, 0), _problem(spec, 1, 3)]
    res = _fit(cfg, probs)
    jres = jfleet.fit_fleet(jcfg, probs, mesh=None)
    for b in range(2):
        _close(_sigma(res.states, b), np.asarray(jres.states.sigma_tilde[b]))
        _close(_sigma(res.states, b), _sigma(_solo(cfg, probs[b])))


def test_fleet_eval_settings_bf16_ns(spec):
    """The evals' settings (bf16 compute, ns warm rounds) in the fleet:
    each tenant equal to its solo fit on the same fp32 blocks, and within
    0.2 degrees of the JAX fleet (``sigma_tilde`` to the bf16 roundings'
    1e-4, the port's scan parity bound)."""
    kw = dict(compute_dtype="bfloat16", warm_orth_method="ns")
    cfg, jcfg = _cfgs(**kw)
    probs = [_problem(spec, b) for b in range(3)]
    res = _fit(cfg, probs)
    jres = jfleet.fit_fleet(jcfg, probs, mesh=None)
    for b in range(3):
        _close(_sigma(res.states, b), _sigma(_solo(cfg, probs[b])))
        np.testing.assert_allclose(_sigma(res.states, b),
                                   np.asarray(jres.states.sigma_tilde[b]), atol=1e-4, rtol=0)
        assert _angle(res.components[b], jres.components[b]) < DEG_JAX
        assert _angle(res.components[b], spec.top_k(K)) < DEG_TRUTH


def test_padding_tenants_leave_real_tenants_alone(spec):
    """``pad_to`` adds inactive tenants (placeholder blocks, a zero carry
    solved from the cold start and discarded): nothing raises, and every
    real tenant's results are its unpadded ones."""
    cfg, _ = _cfgs()
    probs = [_problem(spec, b) for b in range(2)]
    plain = _fit(cfg, probs)
    padded = _fit(cfg, probs, pad_to=5)
    assert padded.batch.fleet_size == 5 and padded.batch.n_tenants == 2
    assert len(padded) == 2 and padded.states.sigma_tilde.shape[0] == 2
    assert not padded.batch.actives[2:].any()
    for b in range(2):
        _close(_sigma(padded.states, b), _sigma(plain.states, b))
        np.testing.assert_allclose(padded.components[b], plain.components[b],
                                   rtol=RTOL, atol=ATOL)
    # masked padding too (the carry's liveness sends padding lanes cold)
    masks = [np.ones((T, M), np.float32), None]
    pm = _fit(cfg, probs, worker_masks=masks, pad_to=4)
    for b in range(2):
        _close(_sigma(pm.states, b), _sigma(plain.states, b))


def test_one_gram_call_per_unmasked_fleet_fit(spec, monkeypatch):
    """The batching is real: one unmasked fleet fit of B tenants calls the
    Gram route once (its cold step, one ``(B m, n, d)`` batch), as one solo
    fit does; the warm steps stream."""
    calls = []
    real = worker_pool.gram_auto

    def counted(x, **kw):
        calls.append(tuple(x.shape))
        return real(x, **kw)

    monkeypatch.setattr(worker_pool, "gram_auto", counted)
    cfg, _ = _cfgs()
    probs = [_problem(spec, b) for b in range(4)]
    _fit(cfg, probs, pad_to=5)
    assert calls == [(5 * M, N, D)]
    calls.clear()
    _solo(cfg, probs[0])
    assert calls == [(M, N, D)]


def test_cusolver_eigh_is_torch_eigh_off_the_card():
    """The port's eigensolver (``ops.cusolver.eigh``): ``torch.linalg.eigh``
    itself on the CPU, batched or not and in any dtype (the cuSOLVER batch
    is for the card, where ``tests/test_torch_cuda.py`` holds it against
    float64 truth), and the ctypes call refuses a CPU tensor."""
    from distributed_eigenspaces_tpu_torch.ops.cusolver import eigh, syev_batched

    a = torch.randn((3, 40, 40), generator=torch.Generator().manual_seed(0))
    a = a @ a.mT
    for x in (a, a[0], a.double()):
        w, v = eigh(x)
        ww, vv = torch.linalg.eigh(x)
        assert torch.equal(w, ww) and torch.equal(v, vv)
    with pytest.raises(ValueError, match="CUDA"):
        syev_batched(a)


def test_merge_of_a_tenant_stack_is_each_tenants_merge():
    """``merged_top_k_lowrank`` over a leading tenant axis, each tenant on
    its own mask (one all masked), equals the merge of each tenant alone:
    both routes, the factor Gram and the dense."""
    from distributed_eigenspaces_tpu_torch.ops.linalg import merged_top_k_lowrank

    g = torch.Generator().manual_seed(4)
    for d in (64, 8):  # 4 x 4 < 64: the factor Gram; 4 x 4 >= 8: dense
        vs = torch.linalg.qr(torch.randn((3, 4, d, 4), generator=g))[0]
        mask = torch.tensor([[1, 1, 0, 1], [0, 0, 0, 0], [1, 1, 1, 1]], dtype=torch.float32)
        got = merged_top_k_lowrank(vs, 3, mask)
        for b in range(3):
            want = merged_top_k_lowrank(vs[b], 3, mask[b])
            torch.testing.assert_close(got[b], want, rtol=1e-5, atol=1e-6)
        assert float(got[1].abs().max()) == 0.0


# -- one tenant's failure ----------------------------------------------------------

PB, PD, PK, PM, PN, PT = 2, 32, 3, 2, 32, 3


def _poisoned_fleet():
    """Two tenants on numpy draws, one NaN in tenant 1's first block."""
    base = dict(dim=PD, k=PK, num_workers=PM, rows_per_worker=PN, num_steps=PT,
                solver="subspace", subspace_iters=10, backend="local")
    scale = np.linspace(3.0, 0.1, PD, dtype=np.float32)
    xs = np.random.default_rng(0).standard_normal((PB, PT, PM, PN, PD)).astype(np.float32)
    xs *= scale
    xs[1, 0, 0, 0, 0] = np.nan
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (PD, PK), jnp.float32))
    return PCAConfig(**base), JaxConfig(**base), xs, v0


@pytest.mark.parametrize("masked", [False, True])
def test_one_tenants_failed_factorization_fails_that_tenant_alone(masked):
    """A tenant whose Gram is not finite fails in its own lane: its
    ``sigma_tilde`` is non-finite in both packages, and the healthy tenant
    beside it matches the reference's and equals its own fit in a fleet
    without the poisoned tenant (the reference's lanes are independent; the
    port's batched Cholesky and eigensolves fail per batch element)."""
    cfg, jcfg, xs, v0 = _poisoned_fleet()
    act = np.ones((PB, PT), np.float32)
    masks = np.ones((PB, PT, PM), np.float32)

    def port(x):
        fit = fleet.make_fleet_fit(cfg, masked=masked, device=CPU, v0=v0)
        st0 = fleet.init_fleet_states(cfg, x.shape[0], device=CPU)
        args = (torch.from_numpy(x),) + ((masks[: x.shape[0]],) if masked else ())
        return _sigma(fit(st0, *args, act[: x.shape[0]])[0])

    jfit = jfleet.make_fleet_fit(jcfg, masked=masked)
    jargs = (jnp.asarray(xs),) + ((jnp.asarray(masks),) if masked else ())
    want = np.asarray(jfit(jfleet.init_fleet_states(jcfg, PB), *jargs, jnp.asarray(act))[0]
                      .sigma_tilde)
    got = port(xs)
    assert np.isfinite(want[0]).all() and not np.isfinite(want[1]).all()
    assert np.isfinite(got[0]).all() and not np.isfinite(got[1]).all()
    _close(got[0], want[0])
    _close(got[0], port(xs[:1])[0])


def test_fleet_server_resolves_the_healthy_tenant_beside_a_failed_one():
    """The server's bucket holds both tenants: the healthy request resolves
    with ``fit_fleet``'s components, the poisoned one with non-finite ones."""
    cfg, _, xs, v0 = _poisoned_fleet()
    cfg = dataclasses.replace(cfg, fleet_bucket_size=2, fleet_flush_s=30.0)
    with fleet.FleetServer(cfg, device=CPU, v0=v0) as srv:
        ws = [t.result(timeout=300) for t in [srv.submit(x) for x in xs]]
    ref = fleet.fit_fleet(cfg, list(xs), mesh=None, device=CPU, v0=v0)
    np.testing.assert_array_equal(ws[0], ref.components[0])
    assert np.isfinite(ws[0]).all() and not np.isfinite(ws[1]).all()
    assert not np.isfinite(ref.components[1]).all()


def test_eigh_and_cholesky_fail_per_batch_element(monkeypatch):
    """The factorizations under the fleet: a matrix that is not finite, that
    torch's solver fails to converge on, or that is not positive definite, is
    NaN in its own batch element, and the others are what a batch without it
    gives."""
    from distributed_eigenspaces_tpu_torch.ops.cusolver import eigh
    from distributed_eigenspaces_tpu_torch.ops.linalg import chol_qr

    g = torch.Generator().manual_seed(1)
    a = torch.randn((3, 40, 40), generator=g)
    a = a @ a.mT
    a[1, 3, 5] = float("nan")
    w, v = eigh(a)
    assert torch.isnan(w[1]).all() and torch.isnan(v[1]).all()
    for b in (0, 2):
        ww, vv = torch.linalg.eigh(a[b])
        assert torch.equal(w[b], ww) and torch.equal(v[b], vv)
    # a matrix torch's solver fails to converge on: the batch is solved again
    # matrix by matrix, the failed one NaN
    real_eigh = torch.linalg.eigh

    def fails_on_the_marked(m):
        if bool((m[..., 0, 0] == -7.0).any()):
            raise torch.linalg.LinAlgError("failed to converge")
        return real_eigh(m)

    monkeypatch.setattr(torch.linalg, "eigh", fails_on_the_marked)
    marked = a.nan_to_num(0.0)
    marked[1, 0, 0] = -7.0
    w, v = eigh(marked)
    monkeypatch.undo()
    assert torch.isnan(w[1]).all() and torch.isnan(v[1]).all()
    for i in (0, 2):
        ww, vv = real_eigh(marked[i])
        assert torch.equal(w[i], ww) and torch.equal(v[i], vv)
    x = torch.randn((3, 16, 4), generator=g)
    x[2] = 0.0  # a zero Gram under zero jitter: not positive definite
    q = chol_qr(x)
    assert torch.isnan(q[2]).all() and torch.isfinite(q[:2]).all()
    torch.testing.assert_close(q[:2], chol_qr(x[:2]), rtol=0, atol=0)


# -- the mesh of ranks -------------------------------------------------------------


def test_fleet_on_two_gloo_ranks(spec):
    """Two gloo ranks, two tenants a rank: the fit makes no collective, one
    all-gather of the results follows it, every rank holds every tenant's
    results (equal to the one-process fleet), and a fleet the mesh does not
    divide is refused."""
    cfg, _ = _cfgs()
    probs = [_problem(spec, b) for b in range(4)]
    out = pmesh.launch(ranks.fleet_rank, 2, _base(), probs, _v0(), backend="gloo",
                       timeout=240)
    one = _fit(cfg, probs)
    for r, o in enumerate(out):
        assert o["mesh"] == {"workers": 2, "features": 1}
        assert o["fit_log"] == []
        assert [rec[0] for rec in o["log"]] == ["all_gather"]
        assert o["log"][0][1] == "workers" and o["log"][0][2] == "float32"
        # the reference's refusal (fleet.py:653-657), word for word
        assert o["indivisible"] == "fleet size 3 not divisible by the mesh fleet axis 2"
        np.testing.assert_array_equal(o["steps"], [T] * 4)
        for b in range(4):
            _close(o["sigma"][b], _sigma(one.states, b))
            assert _angle(o["components"][b], one.components[b]) < 0.01
        _close(o["local_sigma"], o["sigma"][2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["sigma"], out[0]["sigma"])


# -- API surface ---------------------------------------------------------------------


def test_estimator_fleet_trainer_is_b1_fleet(spec):
    cfg, jcfg = _cfgs()
    data = _problem(spec, 0).reshape(-1, D)
    est = dett.OnlineDistributedPCA(cfg, device=CPU, trainer="fleet", v0=_v0()).fit(data)
    assert est.trainer_used_ == "fleet"
    assert isinstance(est.state.step, int) and est.state.step == T
    jest = JaxPCA(jcfg, trainer="fleet").fit(data)
    _close(_sigma(est.state), np.asarray(jest.state.sigma_tilde))
    assert _angle(est.components_, jest.components_) < DEG_JAX
    ref = dett.OnlineDistributedPCA(cfg, device=CPU, trainer="scan", v0=_v0()).fit(data)
    _close(_sigma(est.state), _sigma(ref.state))
    assert _angle(est.components_, ref.components_) < DEG_JAX

    # masked route too
    masks = np.ones((T, M), np.float32)
    masks[2, 1] = 0.0
    est_m = dett.OnlineDistributedPCA(cfg, device=CPU, trainer="fleet", v0=_v0()).fit(
        data, worker_masks=masks)
    jest_m = JaxPCA(jcfg, trainer="fleet").fit(data, worker_masks=masks)
    ref_m = dett.OnlineDistributedPCA(cfg, device=CPU, trainer="scan", v0=_v0()).fit(
        data, worker_masks=masks)
    _close(_sigma(est_m.state), np.asarray(jest_m.state.sigma_tilde))
    _close(_sigma(est_m.state), _sigma(ref_m.state))

    # fleet fits do not checkpoint: the reference's refusal, word for word
    with pytest.raises(ValueError, match="checkpoint") as err:
        dett.OnlineDistributedPCA(cfg, device=CPU, trainer="fleet",
                                  checkpoint_dir="/nonexistent/nope").fit(data)
    with pytest.raises(ValueError, match="checkpoint") as jerr:
        JaxPCA(jcfg, trainer="fleet", checkpoint_dir="/nonexistent/nope").fit(data)
    assert str(err.value) == str(jerr.value)


def test_fleet_rejects_steady_state_knobs():
    for kw, match in ((dict(pipeline_merge=True, warm_start_iters=2), "pipeline_merge"),
                      (dict(merge_interval=2), "merge_interval")):
        cfg, jcfg = _cfgs(**kw)
        with pytest.raises(ValueError, match=match) as err:
            fleet.make_fleet_fit(cfg, device=CPU)
        with pytest.raises(ValueError, match=match) as jerr:
            jfleet.make_fleet_fit(jcfg)
        assert str(err.value) == str(jerr.value)


def test_fleet_refuses_what_waits_for_item_16(spec):
    # the supervisor's screen and the logger sink are ported; the
    # persistent compile cache still waits
    cfg, _ = _cfgs()
    with pytest.raises(NotImplementedError, match="item 16"):
        fleet.FleetServer(cfg, device=CPU, compile_cache=object())
    with pytest.raises(NotImplementedError, match="item 16"):
        fleet.acquire_fleet_programs(cfg, None, masked=False, b_pad=1,
                                     compile_cache=object(), device=CPU)


def test_fleetpca_components_and_transform(spec):
    cfg, jcfg = _cfgs()
    datasets = [_problem(spec, b).reshape(-1, D) for b in range(2)]
    fl = fleet.FleetPCA(cfg, mesh=None, device=CPU, v0=_v0()).fit(datasets)
    jfl = jfleet.FleetPCA(jcfg, mesh=None).fit(datasets)
    assert fl.components_.shape == (2, D, K)
    z = fl.transform(1, datasets[1][:10])
    assert tuple(z.shape) == (10, K)
    np.testing.assert_allclose(z.numpy(), datasets[1][:10] @ fl.components_[1],
                               rtol=1e-5, atol=1e-5)
    assert tuple(jfl.transform(1, datasets[1][:10]).shape) == (10, K)
    for b in range(2):
        assert _angle(fl.components_[b], jfl.components_[b]) < DEG_JAX
    with pytest.raises(RuntimeError, match="fit"):
        fleet.FleetPCA(cfg, device=CPU).components_


def test_stage_fleet_validation(spec):
    """The reference's refusals, each with the reference's message."""
    cfg, jcfg = _cfgs()
    bad = np.ones((T, M + 1), np.float32)
    short = np.ones((2, M), np.float32)
    cases = (
        ([], {}, "at least one"),
        ([_problem(spec, 0)], dict(worker_masks=[]), "worker_masks covers"),
        ([_problem(spec, 0)], dict(worker_masks=[bad]), "worker_masks shape"),
        ([_problem(spec, 0)], dict(worker_masks=[short]), "mask row"),
        ([np.zeros((T, M, N + 1, D), np.float32)], {}, "block shape"),
        ([np.zeros((0, M, N, D), np.float32)], {}, "zero full steps"),
        ([np.zeros((T, D), np.float32)[None]], {}, "must be"),
    )
    for probs, kw, match in cases:
        with pytest.raises(ValueError, match=match) as err:
            fleet.stage_fleet(cfg, probs, **kw)
        with pytest.raises(ValueError, match=match) as jerr:
            jfleet.stage_fleet(jcfg, probs, **kw)
        assert str(err.value) == str(jerr.value)
    # a dataset streams as the solo estimator streams it; staging is fp32
    data = _problem(spec, 0).reshape(-1, D)
    batch = fleet.stage_fleet(cfg, [data, torch.from_numpy(data[: 2 * M * N])], pad_to=3)
    jbatch = jfleet.stage_fleet(jcfg, [data, data[: 2 * M * N]], pad_to=3)
    assert batch.xs.dtype == np.float32 and batch.fleet_size == 3
    np.testing.assert_array_equal(batch.xs, jbatch.xs)
    np.testing.assert_array_equal(batch.actives, jbatch.actives)
    assert batch.masks is None and batch.signature == jbatch.signature


def test_fleet_signature_is_the_bucket_shape_key():
    cfg, jcfg = _cfgs()
    assert fleet.fleet_signature(cfg) == jfleet.fleet_signature(jcfg) == (D, K, M, N, T)
    assert fleet.fleet_signature(_cfgs(k=2)[0]) != fleet.fleet_signature(cfg)


def test_padded_fleet_cfg_widths():
    """k pads to the next power of two, stays a multiple of the deflation
    lane count, caps at dim; padding that changes nothing returns the same
    config object: the reference's widths, case by case."""
    cases = (dict(k=5), dict(k=7), dict(k=6, solver="deflation", components_axis_size=3),
             dict(dim=6, k=5, num_workers=1, rows_per_worker=8), dict(k=8))
    for kw in cases:
        cfg, jcfg = _cfgs(**kw)
        assert fleet.padded_fleet_cfg(cfg).k == jfleet.padded_fleet_cfg(jcfg).k
    assert [fleet.padded_fleet_cfg(_cfgs(**kw)[0]).k for kw in cases] == [8, 8, 9, 6, 8]
    c8 = _cfgs(k=8)[0]
    assert fleet.padded_fleet_cfg(c8) is c8


@pytest.mark.parametrize("field,value,match", [
    ("fleet_bucket_size", 0, "fleet_bucket_size"),
    ("fleet_bucket_size", True, "fleet_bucket_size"),
    ("fleet_flush_s", -1.0, "fleet_flush_s"),
    ("fleet_pad_k", 1, "fleet_pad_k"),
    ("fleet_slo_p99_ms", 0, "fleet_slo_p99_ms"),
    ("cohort_size", 0, "cohort_size"),
    ("max_poison_frac", 0.5, "max_poison_frac"),
    ("max_poison_frac", True, "max_poison_frac"),
])
def test_config_rejects_bad_fleet_fields(field, value, match):
    """The fleet and cohort fields' validation, message for message."""
    with pytest.raises(ValueError, match=match) as err:
        PCAConfig(**_base(**{field: value}))
    with pytest.raises(ValueError, match=match) as jerr:
        JaxConfig(**_base(**{field: value}))
    assert str(err.value) == str(jerr.value)


# -- admission and serving ---------------------------------------------------------


def test_fleet_server_full_bucket_and_deadline_flush(spec):
    """5 requests into bucket-4 admission: one full bucket dispatches at
    once, the leftover resolves on the deadline, padded to 4; every served
    result equals the direct ``fit_fleet`` call's and lies within 0.2
    degrees of the JAX server's."""
    cfg, jcfg = _cfgs(fleet_bucket_size=4, fleet_flush_s=0.15)
    probs = [_problem(spec, b) for b in range(5)]
    with fleet.FleetServer(cfg, device=CPU, v0=_v0()) as srv:
        tickets = [srv.submit(p) for p in probs]
        ws = [t.result(timeout=300) for t in tickets]
        log = [r for r in srv.metrics.fleet_records if r["fleet"] == "bucket"]
    with jfleet.FleetServer(jcfg, mesh=None) as jsrv:
        jws = [t.result(timeout=300) for t in [jsrv.submit(p) for p in probs]]
    ref = _fit(cfg, probs[:4])
    last = _fit(cfg, [probs[4]], pad_to=cfg.fleet_bucket_size)
    assert [b["tenants"] for b in log] == [4, 1]
    assert log[0]["compile_stall_ms"] > 0.0 and log[1]["compile_stall_ms"] == 0.0
    for b in range(5):
        want = last.components[0] if b == 4 else ref.components[b]
        np.testing.assert_allclose(ws[b], want, rtol=RTOL, atol=ATOL)
        assert _angle(ws[b], jws[b]) < DEG_JAX
        assert _angle(ws[b], spec.top_k(K)) < DEG_TRUTH


def test_prewarmed_fleet_dispatch_acquires_nothing(spec):
    cfg, _ = _cfgs(fleet_bucket_size=2, fleet_flush_s=0.05)
    probs = [_problem(spec, b) for b in range(2)]
    with fleet.FleetServer(cfg, device=CPU) as srv:
        pw = srv.prewarm()
        assert srv.wait_warm(timeout=300)
        assert pw.ready(("fleet", repr(cfg), False)) and pw.stats()["compiled"] == 1
        ws = [t.result(timeout=300) for t in [srv.submit(p) for p in probs]]
        log = [r for r in srv.metrics.fleet_records if r["fleet"] == "bucket"]
    assert all(w.shape == (D, K) for w in ws)
    assert [b["compile_stall_ms"] for b in log] == [0.0]


def test_acquire_is_idempotent_via_fit_cache():
    cfg, _ = _cfgs()
    cache: dict = {}
    fit, ext, ms = fleet.acquire_fleet_programs(cfg, None, masked=False, b_pad=2,
                                                fit_cache=cache, device=CPU)
    assert ms > 0.0
    fit2, ext2, ms2 = fleet.acquire_fleet_programs(cfg, None, masked=False, b_pad=2,
                                                   fit_cache=cache, device=CPU)
    assert ms2 == 0.0 and fit2 is fit and ext2 is ext


def test_fleet_hetero_k_shares_bucket_and_slices(spec):
    """Tenants with k=5 and k=7 under ``fleet_pad_k`` share one k=8 bucket,
    and each gets its own k columns of the shared fit: the served slices
    equal the direct k=8 fleet's (the port's and, within 0.2 degrees, the
    JAX package's)."""
    base = dict(fleet_pad_k=True, fleet_bucket_size=2)
    cfg5, cfg7, cfg8 = (_cfgs(k=k, **base)[0] for k in (5, 7, 8))
    probs = [_problem(spec, 0), _problem(spec, 1)]
    with fleet.FleetServer(cfg5, device=CPU, v0=_v0(8)) as srv:
        t5 = srv.submit(probs[0], cfg=cfg5)
        t7 = srv.submit(probs[1], cfg=cfg7)
        w5, w7 = t5.result(timeout=300), t7.result(timeout=300)
        log = [r for r in srv.metrics.fleet_records if r["fleet"] == "bucket"]
    assert w5.shape == (D, 5) and w7.shape == (D, 7)
    assert [b["tenants"] for b in log] == [2] and log[0]["padded_lanes"] == 4
    assert fleet.fleet_signature(cfg8) == (D, 8, M, N, T)
    ref = _fit(cfg8, probs)
    np.testing.assert_allclose(w5, ref.components[0][:, :5], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w7, ref.components[1][:, :7], rtol=RTOL, atol=ATOL)
    jref = jfleet.fit_fleet(_cfgs(k=8, **base)[1], probs, mesh=None)
    assert _angle(w5[:, :K], np.asarray(jref.components[0])[:, :K]) < DEG_JAX
    assert _angle(w5[:, :K], spec.top_k(K)) < DEG_TRUTH
    assert _angle(w7[:, :K], spec.top_k(K)) < DEG_TRUTH


def test_fleet_server_sheds_and_closes(spec):
    from distributed_eigenspaces_tpu_torch.serving.server import ServerClosed, ServerOverloaded

    cfg, _ = _cfgs(fleet_bucket_size=4, fleet_flush_s=30.0, serve_queue_depth=1)
    srv = fleet.FleetServer(cfg, device=CPU)
    first = srv.submit(_problem(spec, 0))
    with pytest.raises(ServerOverloaded, match="shed"):
        srv.submit(_problem(spec, 1))
    srv.close()  # flushes the partial bucket
    assert first.result(timeout=300).shape == (D, K)
    with pytest.raises(ServerClosed, match="closed"):
        srv.submit(_problem(spec, 2))


def test_publish_fleet_lineage_is_the_references(spec):
    cfg, jcfg = _cfgs()
    probs = [_problem(spec, b) for b in range(2)]
    res = _fit(cfg, probs)
    jres = jfleet.fit_fleet(jcfg, probs, mesh=None)
    reg, jreg = EigenbasisRegistry(), JaxRegistry()
    bv = reg.publish_fleet(res, 1, lineage={"note": "x"})
    jbv = jreg.publish_fleet(jres, 1, lineage={"note": "x"})
    assert bv.lineage == jbv.lineage
    assert bv.lineage["producer"] == "fit_fleet" and bv.lineage["tenant"] == 1
    assert bv.step == jbv.step == T and bv.signature == jbv.signature
    np.testing.assert_array_equal(bv.v, res.components[1])
    _close(bv.sigma_tilde, np.asarray(jbv.sigma_tilde))
    assert reg.publish_fleet(res, 0, include_state=False).sigma_tilde is None
    with pytest.raises(ValueError, match="out of range") as err:
        reg.publish_fleet(res, 5)
    with pytest.raises(ValueError, match="out of range") as jerr:
        jreg.publish_fleet(jres, 5)
    assert str(err.value) == str(jerr.value)


# -- the prewarm lane ----------------------------------------------------------------


class TestPrewarmer:
    def test_submit_ready_wait(self):
        done = []
        with Prewarmer() as pw:
            pw.submit("a", lambda: done.append("a"))
            pw.submit("b", lambda: done.append("b"))
            assert pw.wait(timeout=30)
            assert pw.ready("a") and pw.ready("b")
        assert sorted(done) == ["a", "b"]
        assert pw.stats()["compiled"] == 2
        assert pw.stats()["pending"] == 0

    def test_duplicate_labels_skipped(self):
        calls = []
        with Prewarmer() as pw:
            pw.submit("x", lambda: calls.append(1))
            pw.wait(timeout=30)
            pw.submit("x", lambda: calls.append(2))  # already ready
            assert pw.wait(timeout=30)
        assert calls == [1]

    def test_failed_thunk_degrades_not_crashes(self):
        def boom():
            raise RuntimeError("no kernels today")

        with Prewarmer() as pw:
            pw.submit("bad", boom)
            pw.submit("good", lambda: None)
            assert pw.wait(timeout=30)
            assert not pw.ready("bad")
            assert pw.ready("good")
        assert pw.stats()["failed"] == 1
        assert pw.stats()["compiled"] == 1

    def test_closed_prewarmer_rejects_submissions(self):
        pw = Prewarmer()
        pw.close()
        with pytest.raises(RuntimeError, match="closed"):
            pw.submit("late", lambda: None)
        pw.close()  # idempotent

    def test_warmup_runs_declared_signatures(self):
        seen = []
        with Prewarmer() as pw:
            pw.warmup([(8, 2), (16, 2)], compiler=seen.append)
            assert pw.wait(timeout=30)
        assert sorted(seen) == [(8, 2), (16, 2)]

    def test_registry_feed_warms_the_engines_buckets(self):
        reg = EigenbasisRegistry(keep=4)
        v = np.linalg.qr(np.random.default_rng(0).standard_normal((D, K)))[0]
        reg.publish(v.astype(np.float32))
        reg.publish(v.astype(np.float32))  # the same signature: deduplicated
        assert registry_signatures(reg) == [(D, K)]
        eng = TransformEngine(D, K, device=CPU)
        with Prewarmer() as pw:
            labels = pw.warm_registry(reg, make_engine=lambda d, k: eng, rows=(3, 5, 40))
            assert pw.wait(timeout=30)
        assert sorted(set(labels)) == sorted(
            ("engine", D, K, kind, p) for kind in ("project", "residual") for p in (8, 64))
        assert eng.compile_misses == 4
