"""The feature-sharded rank-r trainers against the reference's.

``parallel/feature_sharded.py`` of the port against the JAX package's, on
the same numpy inputs made from a seed: the CholeskyQR2 / Newton-Schulz /
rank-r update helpers, ``worker_subspace_sharded`` and both routes of
``merged_lowrank_sharded``, the per-step trainer (plain, masked, at
``merge_interval=2``, bf16 over an int8 block, the distributed and the
deflation merges on the features axis) and the whole-fit scan (plain,
masked, all-cold, at ``merge_interval=2``), in one process (the ``(1, 1)`` layout) against the
reference on a ``(1, 1)`` mesh, and on two gloo ranks (one
``parallel.mesh.launch``, programs in ``tests/torch_fs_ranks.py``) against
the reference on a ``(1, 2)`` mesh of its virtual CPU devices.

Random starts cross over as numbers: the reference draws each feature
shard's ``(m, d / f, k)`` start from ``fold_in(PRNGKey(0), f)``; those
shards stacked along ``d`` are the port's ``v_rand`` (and the crossover
merges' ``(d / f, k')`` shards its ``v_init``).

The interval step is held against a float64 numpy oracle first (converged
worker solves, exact merges, the dense running average), since the
reference's own interval-step test fails under jax 0.9.0
(``tests/test_pipeline_interval.py::test_feature_sharded_interval_step_scan_equivalent``).

Tolerances: steps, shapes and masks exact; fp32 paths within 1e-5 relative
and 1e-3 degrees; the bf16 route within 0.05 degrees; every rank's state
bit-equal to rank 0's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_fs_ranks as ranks
from jax.sharding import PartitionSpec as P

from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import synthetic as jsyn
from distributed_eigenspaces_tpu.parallel import feature_sharded as jfs
from distributed_eigenspaces_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_eigenspaces_tpu.parallel.mesh import shard_map
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as tfs
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

ANGLE_DEG = 1e-3
BF16_DEG = 0.05
REL = 1e-5
TIMEOUT = 180.0
D, K, M, N, T = 64, 4, 4, 64, 5
BASE = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
            subspace_iters=12, solver="subspace", backend="feature_sharded")
MASKS = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 0, 0],
                  [1, 1, 1, 0]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small CPU tensors: intra-op threads only contend with the other test
    # workers for the cores (a loaded run spent ten times its time alone)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(steps=T, seed=11):
    spec = jsyn.planted_spectrum(D, k_planted=K, gap=25.0, noise=0.01, seed=seed)
    rng = np.random.default_rng(seed + 1)
    z = rng.standard_normal((steps, M, N, D)).astype(np.float32)
    return ((z * np.sqrt(np.asarray(spec.eigenvalues))) @ np.asarray(spec.basis).T
            ).astype(np.float32)


def _int8(xs):
    return np.stack([np.clip(np.round(x * np.float32(127.0 / np.abs(x).max())),
                             -127, 127).astype(np.int8) for x in xs])


def _v_rand(f, seed=0, m=M, k=K):
    """The reference's per-shard worker start, stacked along d."""
    key = jax.random.PRNGKey(seed)
    return np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (m, D // f, k), jnp.float32)) for i in range(f)],
        axis=1)


def _jmesh(f):
    return jax_make_mesh(num_workers=1, num_feature_shards=f, devices=jax.devices()[:f])


def _angle(a, b):
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- the helpers ----------------------------------------------------------------


def test_chol_qr2_ns_orth_and_lowrank_update_match_the_reference():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((40, 5)).astype(np.float32)
    q = tfs.chol_qr2(torch.from_numpy(v)).numpy()
    assert _rel(q, np.asarray(jfs.chol_qr2(jnp.asarray(v)))) <= REL
    np.testing.assert_allclose(q.T @ q, np.eye(5), atol=1e-5)
    w = np.linalg.qr(v)[0].astype(np.float32) + 0.01 * v
    got = tfs.ns_orth(torch.from_numpy(w)).numpy()
    assert _rel(got, np.asarray(jfs.ns_orth(jnp.asarray(w)))) <= REL
    u = np.linalg.qr(rng.standard_normal((D, 8)))[0].astype(np.float32)
    s = np.linspace(3.0, 0.5, 8).astype(np.float32)
    vb = np.linalg.qr(rng.standard_normal((D, K)))[0].astype(np.float32)
    jst = jfs.lowrank_update(jfs.LowRankState(jnp.asarray(u), jnp.asarray(s),
                                              jnp.int32(2)), jnp.asarray(vb), 0.25, 0.5)
    tst = tfs.lowrank_update(tfs.LowRankState(torch.from_numpy(u), torch.from_numpy(s), 2),
                             torch.from_numpy(vb), 0.25, 0.5)
    assert tst.step == int(jst.step) == 3
    assert _rel(tst.s.numpy(), np.asarray(jst.s)) <= REL
    assert _angle(tst.u[:, :K], np.asarray(jst.u)[:, :K]) <= ANGLE_DEG


def test_worker_subspace_and_merge_routes_match_the_reference():
    """``worker_subspace_sharded`` (cold and warm, with its Rayleigh-Ritz
    columns) and both routes of ``merged_lowrank_sharded`` (the factor Gram
    at ``m kf < d``, the dense projector at ``m kf >= d``), masked."""
    xs = _data(1)[0]
    mesh = _jmesh(1)
    key = jax.random.PRNGKey(0)
    v_rand = torch.from_numpy(_v_rand(1))
    v0 = np.linalg.qr(np.random.default_rng(4).standard_normal((D, K)))[0].astype(np.float32)
    xspec = P("workers", None, "features")
    for warm in (None, v0):
        jv = shard_map(
            lambda x, w=warm: jfs.worker_subspace_sharded(
                x, K, 12, N, key, v0=None if w is None else jnp.asarray(w)),
            mesh=mesh, in_specs=(xspec,), out_specs=P("workers", "features", None),
            check_vma=False)(jnp.asarray(xs))
        with pmesh.mesh_scope(pmesh.local_mesh("cpu")):
            tv = tfs.worker_subspace_sharded(
                torch.from_numpy(xs), K, 12, N, v_rand,
                v0=None if warm is None else torch.from_numpy(warm))
        for w in range(M):
            assert _angle(tv[w], np.asarray(jv)[w]) <= ANGLE_DEG
    vs = np.stack([np.linalg.qr(np.random.default_rng(i).standard_normal((D, K)))[0]
                   for i in range(M)]).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)
    for dim_total in (None, 8):  # the factor Gram; the dense route (m kf >= 8)
        want = shard_map(
            lambda v, mk, dt=dim_total: jfs.merged_lowrank_sharded(
                v, K, mask=mk, dim_total=dt),
            mesh=mesh, in_specs=(P("workers", "features", None), P("workers")),
            out_specs=P("features", None), check_vma=False)(
                jnp.asarray(vs), jnp.asarray(mask))
        with pmesh.mesh_scope(pmesh.local_mesh("cpu")):
            got = tfs.merged_lowrank_sharded(torch.from_numpy(vs), K,
                                             mask=torch.from_numpy(mask),
                                             dim_total=dim_total)
            dead = tfs.merged_lowrank_sharded(torch.from_numpy(vs), K,
                                              mask=torch.zeros(M), dim_total=dim_total)
        assert _angle(got, want) <= ANGLE_DEG
        assert not torch.any(dead)


# -- the numpy oracle of the interval step ------------------------------------------


def _oracle(xs, cfg_kw, interval):
    """The merge-interval step in float64 numpy: each worker's exact top-k
    eigenspace, the exact top-k of the mean projector on merge rounds, the
    mean projector itself on the rounds between, folded into the dense
    running average at the 1/T weight."""
    sigma = np.zeros((D, D))
    for t, x in enumerate(xs.astype(np.float64)):
        ps = []
        for w in range(M):
            ev, evec = np.linalg.eigh(x[w].T @ x[w] / N)
            ps.append(evec[:, -K:] @ evec[:, -K:].T)
        mean_p = sum(ps) / M
        if t % interval == 0:
            ev, evec = np.linalg.eigh(mean_p)
            p = evec[:, -K:] @ evec[:, -K:].T
        else:
            p = mean_p
        sigma += p / cfg_kw["num_steps"]
    return sigma


@pytest.mark.parametrize("kind", ["step", "scan"])
def test_interval_step_against_a_numpy_oracle(kind):
    """``merge_interval=2`` with converged worker solves (40 cold
    iterations every step): the rank-r state ``U S U^T`` (rank ``2k + 8``
    holds all ``T k`` directions exactly) is the oracle's dense average."""
    kw = dict(BASE, subspace_iters=40, warm_start_iters=None, merge_interval=2,
              num_steps=4)
    xs = _data(4)
    cfg = PCAConfig(**kw)
    if kind == "step":
        step = tfs.make_feature_sharded_step(cfg, device="cpu")
        st = step.init_state()
        for x in xs:
            st, _ = step(st, torch.from_numpy(x))
    else:
        fit = tfs.make_feature_sharded_scan_fit(cfg, device="cpu")
        st = fit(fit.init_state(), torch.from_numpy(xs))
    assert st.step == 4 and st.u.shape == (D, 2 * K + 8)
    got = (st.u * st.s) @ st.u.T
    np.testing.assert_allclose(got.numpy(), _oracle(xs, kw, 2), atol=1e-5, rtol=0)


# -- the trainers in one process --------------------------------------------------


def _stacked(f, cols, seed=0):
    """The reference's crossover-merge start on ``f`` feature shards: shard
    ``i`` drawn from ``fold_in(PRNGKey(seed), i)``, stacked along d."""
    key = jax.random.PRNGKey(seed)
    return np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (D // f, cols), jnp.float32)) for i in range(f)])


def _cases(f):
    """``(name, kind, cfg_kw, xs, masks, starts)`` of the trainer cases at
    ``f`` feature shards (the reference's start stacked as ``v_rand``; the
    crossover merges' as ``v_init``: ``k`` plus the default oversample of
    the ``m k``-wide factor operator, ``k`` for the lanes)."""
    xs = _data()
    starts = dict(v_rand=_v_rand(f))
    bf16 = dict(BASE, compute_dtype="bfloat16", stage_dtype="int8")
    dist = dict(BASE, solver="distributed", eigh_crossover_d=32)
    lanes = dict(BASE, solver="deflation", eigh_crossover_d=32, components_axis_size=2)
    return [
        ("step", "step", BASE, xs, None, starts),
        ("step_masked", "step", BASE, xs, MASKS, starts),
        ("step_interval", "step", dict(BASE, merge_interval=2), xs, None, starts),
        ("step_1t", "step", dict(BASE, discount="1/t"), xs, None, starts),
        ("step_bf16_int8", "step", bf16, _int8(xs), None, starts),
        ("scan", "scan", BASE, xs, None, starts),
        ("scan_masked", "scan", BASE, xs, MASKS, starts),
        ("scan_cold", "scan", dict(BASE, warm_start_iters=None), xs, None, starts),
        ("scan_interval", "scan", dict(BASE, merge_interval=2), xs, MASKS, starts),
        ("step_distributed", "step", dist, xs, None,
         dict(starts, v_init=_stacked(f, K + min(8, M * K - K)))),
        ("step_deflation", "step", lanes, xs, MASKS, dict(starts, v_init=_stacked(f, K))),
    ]


def _jax_case(kind, kw, xs, masks, f):
    """The reference's trainer of ``kind`` on a ``(1, f)`` mesh: the whole
    final state, and the per-step bases (step) or the final top-k (scan)."""
    jcfg = JaxConfig(**kw)
    mesh = _jmesh(f)
    if kind == "step":
        step = jfs.make_feature_sharded_step(jcfg, mesh, seed=0)
        st, vbs = step.init_state(), []
        for t in range(xs.shape[0]):
            st, vb = step(st, jnp.asarray(xs[t]),
                          None if masks is None else masks[t])
            vbs.append(np.asarray(vb))
        return st, np.stack(vbs)
    fit = jfs.make_feature_sharded_scan_fit(jcfg, mesh, seed=0)
    st = fit(fit.init_state(), jnp.asarray(xs), jnp.arange(xs.shape[0], dtype=jnp.int32),
             worker_masks=masks)
    return st, np.asarray(st.u)[:, :kw["k"]]


def _assert_case(name, kind, kw, got, want):
    gst, gout = got[0], got[1]
    jst, jout = want
    tol = BF16_DEG if kw.get("compute_dtype") == "bfloat16" else ANGLE_DEG
    assert gst["step"] == int(jst.step), name
    assert gst["u"].shape == np.asarray(jst.u).shape
    assert _rel(gst["s"], np.asarray(jst.s)) <= (1e-3 if tol == BF16_DEG else REL), name
    assert _angle(gst["u"][:, :K], np.asarray(jst.u)[:, :K]) <= tol, name
    if kind == "step":
        for t in range(jout.shape[0]):
            if not np.any(jout[t]):  # an all-masked round merges to zeros
                assert not np.any(gout[t]), (name, t)
            else:
                assert _angle(gout[t], jout[t]) <= tol, (name, t)
    else:
        assert _angle(gout, jout) <= tol, name


@pytest.mark.parametrize("case", [c[0] for c in _cases(1)])
def test_trainers_on_one_rank_match_the_reference(case):
    """Each trainer case in one process, no group (the ``(1, 1)``
    layout), against the reference on a ``(1, 1)`` mesh."""
    name, kind, kw, xs, masks, starts = next(c for c in _cases(1) if c[0] == case)
    cfg = PCAConfig(**kw)
    mesh = pmesh.local_mesh("cpu")
    if kind == "step":
        step = tfs.make_feature_sharded_step(cfg, device="cpu", **starts)
        st, vbs = step.init_state(), []
        for t in range(xs.shape[0]):
            st, vb = step(st, torch.from_numpy(xs[t]), None if masks is None else masks[t])
            vbs.append(vb.numpy())
        got = (ranks._whole(mesh, st), np.stack(vbs))
    else:
        fit = tfs.make_feature_sharded_scan_fit(cfg, device="cpu", **starts)
        st = fit(fit.init_state(), torch.from_numpy(xs), worker_masks=masks)
        got = (ranks._whole(mesh, st), fit.extract(st).numpy())
    _assert_case(name, kind, kw, got, _jax_case(kind, kw, xs, masks, 1))


def test_trainers_on_two_ranks_match_the_reference(tmp_path):
    """Every trainer case on a ``(1, 2)`` mesh of two gloo ranks (32 of the
    64 columns a rank) against the reference on a ``(1, 2)`` mesh; every
    rank's whole state is rank 0's, bit for bit."""
    cases = _cases(2)
    out = pmesh.launch(ranks.fs_trainers, 2, cases, workdir=str(tmp_path),
                       timeout=TIMEOUT)
    for r in range(2):
        assert out[r]["shape"] == {"workers": 1, "features": 2}
    for name, kind, kw, xs, masks, _ in cases:
        want = _jax_case(kind, kw, xs, masks, 2)
        _assert_case(name, kind, kw, out[0][name], want)
        for a, b in zip(out[1][name][0].values(), out[0][name][0].values()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(out[1][name][1], out[0][name][1])


def test_auto_feature_mesh_and_refusals():
    """No group: the ``(1, 1)`` layout (None); an explicit multi-rank
    ``mesh_shape`` without a group is refused loudly; the ring collectives
    are accepted; a rank below k is refused as in the reference."""
    cfg = PCAConfig(**BASE)
    assert pmesh.auto_feature_mesh(cfg, "cpu") is None
    with pytest.raises(ValueError, match="process group"):
        pmesh.auto_feature_mesh(PCAConfig(**BASE, mesh_shape={"features": 2}), "cpu")
    assert PCAConfig(**BASE, collectives="ring").collectives == "ring"
    with pytest.raises(ValueError, match="rank=2 must be >= k"):
        tfs.make_feature_sharded_step(cfg, device="cpu", rank=2)
    with pytest.raises(ValueError, match="unknown collectives"):
        PCAConfig(**BASE, collectives="mpi")
    JaxConfig(**BASE, collectives="ring")  # legal in the reference


def test_interop_starts_both_packages_from_the_same_state():
    """A reference ``LowRankState`` carried across as numpy arrays
    (``interop.fs_state_from_numpy``) continues in the port as it does in
    the reference; ``fs_state_to_numpy`` carries it back."""
    from distributed_eigenspaces_tpu_torch import interop

    xs = _data()
    jcfg = JaxConfig(**BASE)
    jstep = jfs.make_feature_sharded_step(jcfg, _jmesh(1), seed=0)
    jst = jstep.init_state()
    for t in range(2):
        jst, _ = jstep(jst, jnp.asarray(xs[t]))
    host = {"u": np.asarray(jst.u), "s": np.asarray(jst.s), "step": np.asarray(jst.step)}
    st = interop.fs_state_from_numpy("lowrank", host, device="cpu")
    assert isinstance(st, tfs.LowRankState) and st.step == 2
    step = tfs.make_feature_sharded_step(PCAConfig(**BASE), device="cpu",
                                         v_rand=_v_rand(1))
    for t in range(2, T):
        st, _ = step(st, torch.from_numpy(xs[t]))
        jst, _ = jstep(jst, jnp.asarray(xs[t]))
    assert st.step == int(jst.step) == T
    assert _rel(st.s.numpy(), np.asarray(jst.s)) <= REL
    assert _angle(st.u[:, :K], np.asarray(jst.u)[:, :K]) <= ANGLE_DEG
    back = interop.fs_state_to_numpy(st)
    assert back["step"].dtype == np.int32 and back["u"].shape == (D, 2 * K + 8)
    sk = interop.fs_state_from_numpy(
        "sketch", {"y": np.ones((D, 5)), "v": np.zeros((D, K)), "step": 1},
        device="cpu", mesh=pmesh.local_mesh("cpu"))
    assert isinstance(sk, tfs.SketchState) and sk.y.dtype == torch.float32
