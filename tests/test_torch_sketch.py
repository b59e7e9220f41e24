"""The Nystrom-sketch trainer, its online continuation and the estimator's
feature-sharded routes, against the reference's.

The counterparts of ``tests/test_sketch_drift.py`` and
``tests/test_sketch_online.py``: the sketch fit against the reference's on
the same starts (the reference's ``fold_in`` shards of ``omega`` and of the
worker start, stacked, handed to the port); its drift from the exact rank-r
scan bounded over a long horizon; masks, the all-masked step and the
all-masked cold-step recovery; ``_continue_sketch`` equal to the windowed
fit bit for bit; a trainer rebuilt after a restore; the ``lowrank`` and
``sketch`` checkpoints crossing both ways and restoring as each rank's
rows; the estimator's routes on two gloo ranks (one ``parallel.mesh.
launch``). Tolerances: steps and shapes exact; the extract with the same
``omega`` and starts within 0.01 degrees; all-live masks within 1e-6 of
no masks; windowed against incremental bit for bit.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_fs_ranks as ranks

from distributed_eigenspaces_tpu.api.estimator import OnlineDistributedPCA as JaxPCA
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import synthetic as jsyn
from distributed_eigenspaces_tpu.parallel import feature_sharded as jfs
from distributed_eigenspaces_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_eigenspaces_tpu.utils import checkpoint as jckpt
from distributed_eigenspaces_tpu_torch.api.estimator import OnlineDistributedPCA
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as tfs
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.utils import checkpoint as tckpt

SKETCH_DEG = 0.01
TRUTH_DEG = 1.0
TIMEOUT = 180.0
D, K, M, N = 64, 3, 4, 128
P_W = K + 16
BASE = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=8,
            subspace_iters=30, warm_start_iters=1, solver="subspace",
            discount="1/t", backend="feature_sharded")


def _spec(gap=25.0, noise=0.01, seed=3):
    return jsyn.planted_spectrum(D, k_planted=K, gap=gap, noise=noise, seed=seed)


def _blocks(spec, b=4, seed=7):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, M, N, D)).astype(np.float32)
    return ((z * np.sqrt(np.asarray(spec.eigenvalues))) @ np.asarray(spec.basis).T
            ).astype(np.float32)


def _starts(f=1, seed=4):
    """The reference's sketch starts (``omega``, the worker start) stacked
    over ``f`` feature shards."""
    ok, sk = jax.random.split(jax.random.PRNGKey(seed))
    omega = np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(ok, i), (D // f, P_W), jnp.float32)) for i in range(f)])
    v_rand = np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(sk, i), (M, D // f, K), jnp.float32)) for i in range(f)],
        axis=1)
    return dict(omega=omega, v_rand=v_rand)


def _angle(a, b):
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _port(cfg_kw, **kw):
    return tfs.make_feature_sharded_sketch_fit(PCAConfig(**cfg_kw), device="cpu",
                                               **_starts(), **kw)


def _jax(cfg_kw):
    mesh = jax_make_mesh(num_workers=1, num_feature_shards=1, devices=jax.devices()[:1])
    return jfs.make_feature_sharded_sketch_fit(JaxConfig(**cfg_kw), mesh, seed=4)


def _run(fit, xs, idx, masks=None, jax_fit=False):
    if jax_fit:
        st = fit(fit.init_state(), jnp.asarray(xs), jnp.asarray(idx, jnp.int32),
                 worker_masks=masks)
        return st, np.asarray(fit.extract(st))
    st = fit(fit.init_state(), torch.from_numpy(xs), idx, worker_masks=masks)
    return st, fit.extract(st).numpy()


# -- the sketch fit ------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["fp32", "bf16_warm2"])
def test_sketch_fit_matches_the_reference(variant):
    kw = BASE if variant == "fp32" else dict(BASE, compute_dtype="bfloat16",
                                             warm_start_iters=2)
    xs = _blocks(_spec())
    idx = np.arange(6) % 4
    st, w = _run(_port(kw), xs, idx)
    jst, jw = _run(_jax(kw), xs, idx, jax_fit=True)
    assert st.step == int(jst.step) == 6 and st.y.shape == (D, P_W)
    assert _angle(w, jw) <= SKETCH_DEG
    assert _angle(w, _spec().top_k(K)) <= TRUTH_DEG


@pytest.mark.parametrize("gap,noise,bound", [(25.0, 0.01, 1.0), (4.0, 0.05, 3.0)])
def test_sketch_drift_bounded_over_long_horizon(gap, noise, bound):
    """The reference's bound: the sketch's angle from the exact rank-r scan
    at T=120 within ``bound`` and within 0.75 degrees of the angle at
    T=30 (the port's own trainers, same starts)."""
    spec = _spec(gap, noise, seed=21)
    xs = _blocks(spec)

    def drift(t):
        kw = dict(BASE, num_steps=t)
        idx = np.arange(t) % 4
        _, w_s = _run(_port(kw), xs, idx)
        ex = tfs.make_feature_sharded_scan_fit(PCAConfig(**kw), device="cpu",
                                               v_rand=_starts()["v_rand"])
        st = ex(ex.init_state(), torch.from_numpy(xs), idx)
        return _angle(w_s, st.u[:, :K])

    short, long = drift(30), drift(120)
    assert long <= bound and long <= short + 0.75, (short, long)


def test_sketch_masks_match_the_reference():
    """All-live masks are the unmasked fit; a worker masked on the cold
    step and on two warm steps changes the result and keeps it accurate;
    each against the reference's masked fit."""
    spec = _spec()
    xs = _blocks(spec)
    idx = np.arange(6) % 4
    kw = dict(BASE, num_steps=6)
    fit = _port(kw)
    plain, _ = _run(fit, xs, idx)
    ones, _ = _run(fit, xs, idx, np.ones((6, M), np.float32))
    np.testing.assert_allclose(ones.y.numpy(), plain.y.numpy(), atol=1e-6, rtol=0)
    masks = np.ones((6, M), np.float32)
    masks[0, 0] = masks[2, 0] = masks[3, 1] = 0.0
    st, w = _run(fit, xs, idx, masks)
    jst, jw = _run(_jax(kw), xs, idx, masks, jax_fit=True)
    assert not np.allclose(st.y.numpy(), plain.y.numpy())
    assert _angle(w, jw) <= SKETCH_DEG
    assert _angle(w, spec.top_k(K)) <= TRUTH_DEG


def test_sketch_all_masked_steps_keep_state_and_cold_step_recovers():
    """An all-masked warm step counts the round and keeps ``y`` and ``v``;
    an all-masked FIRST step leaves the carry zero, and the next step runs
    the cold machinery again and recovers the planted subspace; both
    against the reference."""
    spec = _spec()
    xs = _blocks(spec)
    kw2 = dict(BASE, num_steps=2)
    masks2 = np.ones((2, M), np.float32)
    masks2[1] = 0.0
    st2, _ = _run(_port(kw2), xs, [0, 1], masks2)
    st1, _ = _run(_port(dict(BASE, num_steps=1)), xs, [0])
    assert st2.step == 2
    assert torch.equal(st2.y, st1.y) and torch.equal(st2.v, st1.v)
    masks = np.ones((5, M), np.float32)
    masks[0] = 0.0
    kw5 = dict(BASE, num_steps=5)
    idx = np.arange(5) % 4
    st, w = _run(_port(kw5), xs, idx, masks)
    jst, jw = _run(_jax(kw5), xs, idx, masks, jax_fit=True)
    assert st.step == int(jst.step) == 5 and np.linalg.norm(w) > 0
    assert _angle(w, jw) <= SKETCH_DEG
    assert _angle(w, spec.top_k(K)) <= TRUTH_DEG


def test_nystrom_extract_of_a_rank_deficient_sketch():
    """A sketch of an exactly rank-k matrix: ``B`` is rank-deficient, and the
    pseudo-inverse square root still gives finite columns spanning it
    (the reference's ``tests/test_feature_sharded.py:534``)."""
    rng = np.random.default_rng(0)
    u = np.linalg.qr(rng.standard_normal((D, K)))[0].astype(np.float32)
    a = (u * np.array([3.0, 2.0, 1.0], np.float32)) @ u.T
    omega = rng.standard_normal((D, P_W)).astype(np.float32)
    got = tfs._nystrom_top_k(torch.from_numpy(a @ omega), torch.from_numpy(omega), K)
    want = np.asarray(jfs._nystrom_top_k(jnp.asarray(a @ omega), jnp.asarray(omega), K))
    assert bool(torch.isfinite(got).all())
    assert _angle(got, u) <= SKETCH_DEG and _angle(got, want) <= SKETCH_DEG


# -- the online continuation --------------------------------------------------------


def _rows(xs):
    return xs.reshape(-1, D)


def test_continue_sketch_equals_the_windowed_fit():
    """A sketch fit of 2 steps continued one block at a time by
    ``partial_fit`` is the windowed fit of all the steps bit for bit; the
    step caps are the per-step loop's (``"auto"`` is ``cfg.num_steps`` in
    all, an int the total)."""
    xs = _blocks(_spec(), b=6)
    cfg = PCAConfig(**dict(BASE, num_steps=6))
    est = OnlineDistributedPCA(cfg, device="cpu", trainer="sketch").fit(_rows(xs[:2]))
    assert est.state.step == 2
    for t in range(2, 6):
        est.partial_fit(torch.from_numpy(xs[t]))
    assert est.state.step == 6 and est.trainer_used_ == "sketch"
    fit = tfs.make_feature_sharded_sketch_fit(cfg, device="cpu")
    windowed = fit.fit_windows(fit.init_state(),
                               (torch.from_numpy(xs[t:t + 2]) for t in range(0, 6, 2)))
    assert torch.equal(est.state.y, windowed.y) and torch.equal(est.state.v, windowed.v)
    capped = OnlineDistributedPCA(PCAConfig(**dict(BASE, num_steps=6, discount="1/T")),
                                  device="cpu", trainer="sketch").fit(_rows(xs))
    capped.fit_stream(iter(torch.from_numpy(xs)))
    assert capped.state.step == 6
    capped.fit_stream(iter(torch.from_numpy(xs)), max_steps=8)
    assert capped.state.step == 8


def test_on_step_hook_masks_and_a_rebuilt_trainer_after_restore(tmp_path):
    """``fit_stream`` on a sketch state: ``on_step`` sees every round (one
    step a window) with the state's ``v``; mask rows running out raise; a
    restored checkpoint continues through a trainer rebuilt from the
    config, bit for bit the uninterrupted continuation."""
    xs = _blocks(_spec(), b=6)
    cfg = PCAConfig(**dict(BASE, num_steps=6))
    est = OnlineDistributedPCA(cfg, device="cpu", trainer="sketch").fit(_rows(xs[:2]))
    tckpt.save_checkpoint(str(tmp_path / "c"), est.state, cursor=2 * M * N)
    seen = []
    est.fit_stream(iter(torch.from_numpy(xs[2:4])),
                   on_step=lambda t, st, v: seen.append((t, torch.equal(v, st.v))))
    assert seen == [(3, True), (4, True)]
    after = est.state
    with pytest.raises(ValueError, match="exhausted"):
        est.fit_stream(iter(torch.from_numpy(xs[4:6])), worker_masks=[np.ones(M)])
    state, cursor = tckpt.restore_checkpoint(str(tmp_path / "c"), device="cpu")
    assert cursor == 2 * M * N and isinstance(state, tfs.SketchState)
    fresh = OnlineDistributedPCA(cfg, device="cpu", trainer="sketch")
    fresh.state = state
    fresh.fit_stream(iter(torch.from_numpy(xs[2:4])))
    assert fresh._sketch_fit is not None and fresh.state.step == 4
    assert torch.equal(fresh.state.y, after.y) and torch.equal(fresh.state.v, after.v)


# -- checkpoints ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lowrank", "sketch"])
def test_feature_sharded_checkpoints_cross_both_ways(kind, tmp_path):
    """A reference checkpoint of a mesh fit (its leaves row-sharded, the
    layout recorded in the marker) restores in the port whole and, on a
    features mesh, as each rank's rows; the port's restores in the
    reference with the same leaf layout."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((D, 6)).astype(np.float32)
    b = rng.standard_normal((D, K) if kind == "sketch" else (6,)).astype(np.float32)
    cls, jcls = ((tfs.LowRankState, jfs.LowRankState) if kind == "lowrank"
                 else (tfs.SketchState, jfs.SketchState))
    jst = jcls(jnp.asarray(a), jnp.asarray(b), jnp.int32(5))
    jckpt.save_checkpoint(str(tmp_path / "j"), jst)
    st, _ = tckpt.restore_checkpoint(str(tmp_path / "j"), device="cpu")
    assert type(st) is cls and st.step == 5
    np.testing.assert_array_equal(st[0].numpy(), a)
    # a one-process mesh: the rows of the only rank are all of them
    rows, _ = tckpt.restore_checkpoint(str(tmp_path / "j"), device="cpu",
                                       mesh=pmesh.local_mesh("cpu"))
    assert torch.equal(rows[0], st[0]) and torch.equal(rows[1], st[1])
    tckpt.save_checkpoint(str(tmp_path / "t"), st)
    meta = __import__("json").load(open(tmp_path / "t" / "meta.json"))
    row_leaf = "u" if kind == "lowrank" else "y"
    assert meta["state_type"] == kind and meta["leaf_specs"][row_leaf] == ["features", None]
    back, _ = jckpt.restore_checkpoint(str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(back[0]), a)
    np.testing.assert_array_equal(np.asarray(back[1]), b)


# -- the estimator -------------------------------------------------------------------


def test_auto_backend_routes_as_the_reference():
    """``backend="auto"``: the sketch at ``d k >= 65536`` (warned once a
    call site), the rank-r scan at ``d >= 4096`` below it, a
    ``LowRankState`` per-step loop at ``d >= 4096``; the same trainers the
    reference's estimator picks."""
    from distributed_eigenspaces_tpu.api.estimator import choose_trainer as jax_choose
    from distributed_eigenspaces_tpu_torch.api.estimator import choose_trainer

    for dim, k, want in ((4096, 2, "scan"), (2048, 32, "sketch"), (1024, 8, "scan")):
        kw = dict(dim=dim, k=k, num_workers=2, rows_per_worker=8, num_steps=2,
                  subspace_iters=3, solver="subspace")
        assert choose_trainer(PCAConfig(**kw)) == jax_choose(JaxConfig(**kw)) == want
        x = np.random.default_rng(0).standard_normal((32, dim)).astype(np.float32)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            est = OnlineDistributedPCA(PCAConfig(**kw), device="cpu").fit(x)
        assert est.trainer_used_ == want and est.components_.shape == (dim, k)
        fs = dim >= 4096 or dim * k >= 65536
        assert isinstance(est.state, tfs.SketchState if want == "sketch" else (
            tfs.LowRankState if fs else object))
        assert sum("Nystrom" in str(w.message) for w in caught) == (want == "sketch")


def test_estimator_feature_sharded_routes_on_two_ranks(tmp_path):
    """The estimator on a ``(1, 2)`` features mesh of two gloo ranks (the
    ``auto_feature_mesh`` of a group of two): the rank-r scan, the sketch
    staged and windowed with checkpoints (restored as each rank's rows),
    the per-step loop, and ``partial_fit`` on a sketch fit; every rank's
    basis is rank 0's, each within 1 degree of the planted subspace and of
    the reference's estimator on its own mesh."""
    spec = _spec()
    kw = dict(BASE, num_steps=6, discount="1/T")
    x = _rows(_blocks(spec, b=6))
    ckdir = tmp_path / "ckpt"
    out = pmesh.launch(ranks.fs_estimator, 2, kw, x, str(ckdir),
                       workdir=str(tmp_path), timeout=TIMEOUT)
    truth = np.asarray(spec.top_k(K))
    for trainer in ("scan", "sketch", "step"):
        want = np.asarray(JaxPCA(JaxConfig(**kw), trainer=trainer).fit(x).components_)
        for r in range(2):
            used, comps, steps = out[r][trainer]
            assert used == trainer and steps == 6
            np.testing.assert_array_equal(comps, out[0][trainer][1])
            assert _angle(comps, truth) <= TRUTH_DEG
            assert _angle(comps, want) <= TRUTH_DEG
    for r in range(2):
        o = out[r]
        assert o["mesh"] == {"workers": 1, "features": 2}
        # the staged and windowed sketch fits are the same fit
        np.testing.assert_array_equal(o["windowed"], o["sketch"][1])
        step, cursor, restored, final = o["restored"]
        assert step == 6 and cursor == 6 * M * N
        for f in ("y", "v"):
            np.testing.assert_array_equal(restored[f], final[f])
        assert o["partial"][0] == 6
        np.testing.assert_array_equal(o["partial"][1], out[0]["partial"][1])
        assert _angle(o["partial"][1], truth) <= TRUTH_DEG
    assert sorted(p.name for p in ckdir.iterdir()) == ["step_00000004", "step_00000006"]
