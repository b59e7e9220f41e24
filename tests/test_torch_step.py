"""The port's online fit as a whole against the reference's.

The round (``entry()``'s step), the 4-step scan fit (cold then warm), the
per-step loop, and a reference state carried across by ``interop.py`` and
advanced on both sides. Inputs are made with numpy from a seed; the cold
start is the reference's own ``jax.random.normal(PRNGKey(0), (d, k))``,
handed to the port as ``v0``. Tolerances: ``sigma_tilde`` within 1e-4
absolute at fp32, merged bases within 0.05 degrees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu.algo import online as jon
from distributed_eigenspaces_tpu.algo.scan import make_scan_fit as jax_scan_fit
from distributed_eigenspaces_tpu.algo.step import make_train_step as jax_train_step
from distributed_eigenspaces_tpu.algo.step import mean_projector as jax_mean_projector
from distributed_eigenspaces_tpu.api.estimator import OnlineDistributedPCA as JaxPCA
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import stream as jstream
from distributed_eigenspaces_tpu.data import synthetic as jsyn
from distributed_eigenspaces_tpu_torch import interop
from distributed_eigenspaces_tpu_torch.algo import online as ton
from distributed_eigenspaces_tpu_torch.algo.step import mean_projector
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.data import stream as tstream
from distributed_eigenspaces_tpu_torch.data import synthetic as tsyn
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

SIGMA_ATOL = 1e-4
ANGLE_DEG = 0.05


def _v0(d, k):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (d, k), jnp.float32))


def _angle(a, b):
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _steps(T, m, n, d, k, seed=0):
    spec = jsyn.planted_spectrum(d, k_planted=k, seed=seed)
    rng = np.random.default_rng(seed + 1)
    z = rng.standard_normal((T, m, n, d)).astype(np.float32)
    x = (z * np.sqrt(np.asarray(spec.eigenvalues))) @ np.asarray(spec.basis).T
    return x.astype(np.float32), np.asarray(spec.top_k(k))


SMALL = dict(dim=96, k=4, num_workers=4, rows_per_worker=64, num_steps=4,
             solver="subspace", subspace_iters=12, warm_start_iters=2)


def test_entry_step_matches_graft_entry():
    jfn, (jstate, jx) = __graft_entry__.entry()
    jst, jv = jfn(jstate, jx)
    step, (state, x) = dett.entry(device="cpu", v0=_v0(256, 8))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    st, v = step(state, x)
    assert st.step == int(jst.step) == 1
    np.testing.assert_allclose(
        st.sigma_tilde.numpy(), np.asarray(jst.sigma_tilde), atol=SIGMA_ATOL, rtol=0
    )
    assert _angle(v, np.asarray(jv)) <= ANGLE_DEG


def test_scan_fit_cold_then_warm_matches():
    x, _ = _steps(4, 4, 64, 96, 4)
    jcfg = JaxConfig(**SMALL, backend="local")
    jst, jvb = jax_scan_fit(jcfg)(jon.OnlineState.initial(96), jnp.asarray(x))
    fit = dett.make_scan_fit(PCAConfig(**SMALL), device="cpu", v0=_v0(96, 4))
    st, vb = fit(ton.OnlineState.initial(96, device="cpu"), torch.from_numpy(x))
    assert st.step == int(jst.step) == 4
    assert vb.shape == (4, 96, 4)
    np.testing.assert_allclose(
        st.sigma_tilde.numpy(), np.asarray(jst.sigma_tilde), atol=SIGMA_ATOL, rtol=0
    )
    for t in range(4):
        assert _angle(vb[t], np.asarray(jvb[t])) <= ANGLE_DEG


def test_state_carried_across_by_interop_matches():
    """Two reference steps, then the state and warm basis cross over and
    both sides run steps 3 and 4 warm."""
    x, _ = _steps(4, 4, 64, 96, 4, seed=3)
    jcfg = JaxConfig(**SMALL, backend="local")
    jstep = jax_train_step(jcfg, mesh=None, donate=False)
    js, jv = jstep(jon.OnlineState.initial(96), jnp.asarray(x[0]))
    js, jv = jstep(js, jnp.asarray(x[1]), jv)
    cfg = interop.config_from_jax(dataclasses.asdict(jcfg))
    assert cfg == PCAConfig(**SMALL, backend="local")
    ts = interop.state_from_numpy(
        {"sigma_tilde": np.asarray(js.sigma_tilde), "step": np.asarray(js.step)},
        device="cpu",
    )
    tv = interop.basis_from_numpy(np.asarray(jv), device="cpu")
    tstep = dett.make_train_step(cfg, device="cpu")
    for t in (2, 3):
        js, jv = jstep(js, jnp.asarray(x[t]), jv)
        ts, tv = tstep(ts, torch.from_numpy(x[t]), tv)
    out = interop.state_to_numpy(ts)
    assert out["step"] == int(js.step) == 4 and out["sigma_tilde"].dtype == np.float32
    np.testing.assert_allclose(
        out["sigma_tilde"], np.asarray(js.sigma_tilde), atol=SIGMA_ATOL, rtol=0
    )
    assert _angle(tv, np.asarray(jv)) <= ANGLE_DEG


def test_config_from_jax_refuses_unported_settings():
    jcfg = JaxConfig(**SMALL, compile_cache_dir="cache")
    with pytest.raises(NotImplementedError, match="compile_cache_dir"):
        interop.config_from_jax(dataclasses.asdict(jcfg))
    # the hierarchical merge's knobs carry over in the reference's normal form
    jcfg = JaxConfig(**SMALL, merge_topology=(("chip", 2), ("host", 2)),
                     merge_wire_dtype={"host": "int8"})
    got = interop.config_from_jax(dataclasses.asdict(jcfg))
    assert got.merge_topology == jcfg.merge_topology
    assert got.merge_wire_dtype == jcfg.merge_wire_dtype == (("host", "int8"),)
    # the steady-state knobs carry over (ported with the whole-fit trainers),
    # and so does the per-step loop's prefetch depth
    got = interop.config_from_jax(dataclasses.asdict(JaxConfig(
        **SMALL, merge_interval=2, pipeline_merge=True, prefetch_depth=0)))
    assert (got.merge_interval, got.pipeline_merge) == (2, True)
    assert got.prefetch_depth == 0
    # the int8 stage and the ns warm orthonormalization carry over
    got = interop.config_from_jax(dataclasses.asdict(JaxConfig(
        **SMALL, stage_dtype="int8", compute_dtype="bfloat16", warm_orth_method="ns")))
    assert (got.stage_dtype, got.resolved_warm_orth()) == ("int8", "ns")
    got = interop.config_from_jax(
        dataclasses.asdict(JaxConfig(**SMALL, compute_dtype=jnp.bfloat16))
    )
    assert got.compute_dtype == "bfloat16" and got.state_dtype == "float32"


def test_per_step_loop_matches():
    x, _ = _steps(3, 4, 64, 96, 4, seed=5)
    jcfg = JaxConfig(**{**SMALL, "num_steps": 3}, backend="local", prefetch_depth=0)
    jw, jst = jon.online_distributed_pca(iter(jnp.asarray(x)), jcfg)
    cfg = PCAConfig(**{**SMALL, "num_steps": 3})
    seen = []
    tw, tst = ton.online_distributed_pca(
        iter(torch.from_numpy(x)), cfg, device="cpu", v0=_v0(96, 4),
        on_step=lambda t, s, v: seen.append(t),
    )
    assert seen == [1, 2, 3] and tst.step == 3
    np.testing.assert_allclose(
        tst.sigma_tilde.numpy(), np.asarray(jst.sigma_tilde), atol=SIGMA_ATOL, rtol=0
    )
    assert _angle(tw, np.asarray(jw)) <= ANGLE_DEG


@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
def test_mean_projector_matches(rng, mask):
    vs = rng.standard_normal((3, 20, 4)).astype(np.float32)
    want = np.asarray(jax_mean_projector(
        jnp.asarray(vs), None if mask is None else jnp.asarray(mask, jnp.float32)
    ))
    got = mean_projector(
        torch.from_numpy(vs), None if mask is None else torch.tensor(mask)
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if mask == [0.0, 0.0, 0.0]:
        assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("rule", ["1/T", "1/t", "notebook"])
def test_discount_and_update_match(rule, rng):
    for step in (1, 2, 7):
        want = np.asarray(jon._discount(rule, jnp.asarray(step, jnp.int32), 10))
        assert np.float32(ton._discount(rule, step, 10)) == want
    p = [rng.standard_normal((6, 6)).astype(np.float32) for _ in range(3)]
    js = jon.OnlineState.initial(6)
    ts = ton.OnlineState.initial(6, device="cpu")
    for pi in p:
        js = jon.update_state_projector(js, jnp.asarray(pi), discount=rule, num_steps=3)
        ts = ton.update_state_projector(ts, torch.from_numpy(pi), discount=rule, num_steps=3)
    np.testing.assert_allclose(ts.sigma_tilde.numpy(), np.asarray(js.sigma_tilde), rtol=1e-6, atol=1e-7)
    assert ts.step == int(js.step) == 3
    with pytest.raises(ValueError):
        ton._discount("1/x", 1, 10)


def test_planted_spectrum_and_block_stream_match():
    j = jsyn.planted_spectrum(48, k_planted=3, seed=2)
    t = tsyn.planted_spectrum(48, k_planted=3, seed=2)
    np.testing.assert_allclose(t.basis, np.asarray(j.basis), atol=1e-6)
    np.testing.assert_allclose(t.eigenvalues, np.asarray(j.eigenvalues), rtol=1e-6)
    np.testing.assert_array_equal(t.top_k(3), t.basis[:, :3])
    xs = t.sample(np.random.default_rng(0), 700)
    xt = t.sample(torch.Generator().manual_seed(0), 700)
    assert xs.shape == xt.shape == (700, 48) and xt.dtype == torch.float32
    for x in (xs, xt):  # both draw from the planted covariance
        cov = np.asarray(x, np.float64).T @ np.asarray(x, np.float64) / 700
        assert _angle(np.linalg.eigh(cov)[1][:, -3:], t.top_k(3)) < 10.0
    data = np.arange(50 * 3, dtype=np.float32).reshape(50, 3)
    for remainder in ("drop", "pad"):
        want = list(jstream.block_stream(data, num_workers=2, rows_per_worker=4,
                                         remainder=remainder, device=False))
        got = list(tstream.block_stream(data, num_workers=2, rows_per_worker=4,
                                        remainder=remainder, device="cpu"))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="remainder"):
        list(tstream.block_stream(data, num_workers=2, rows_per_worker=4,
                                  remainder="error", device="cpu"))


def test_estimator_recovers_planted_top_k_and_matches_reference():
    d, k, m, n, T = 64, 3, 4, 128, 6
    spec = tsyn.planted_spectrum(d, k_planted=k, seed=0)
    data = spec.sample(np.random.default_rng(0), m * n * T)
    kw = dict(dim=d, k=k, num_workers=m, rows_per_worker=n, num_steps=T,
              solver="subspace", subspace_iters=12)
    est = dett.OnlineDistributedPCA(PCAConfig(**kw), device="cpu", v0=_v0(d, k))
    w = est.fit(data).components_
    assert est.trainer_used_ == "scan" and w.shape == (d, k)
    assert _angle(w, spec.top_k(k)) <= 1.0
    ref = JaxPCA(JaxConfig(**kw, backend="local"), trainer="scan").fit(data)
    assert _angle(w, np.asarray(ref.components_)) <= ANGLE_DEG
    z = est.transform(data[:5])
    np.testing.assert_allclose(z.numpy(), data[:5] @ w.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="feature width"):
        est.transform(data[:5, :10])
    # the per-step trainer over the same stream lands on the same subspace
    step_est = dett.OnlineDistributedPCA(PCAConfig(**kw), device="cpu", trainer="step")
    assert _angle(step_est.fit(data).components_, spec.top_k(k)) <= 1.0
    assert step_est.trainer_used_ == "step"
    assert dett.OnlineDistributedPCA(PCAConfig(**kw), device="cpu").fit_transform(data).shape == (len(data), k)
    with pytest.raises(RuntimeError, match="fit"):
        dett.OnlineDistributedPCA(PCAConfig(**kw), device="cpu").components_
