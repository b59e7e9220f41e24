"""The explicit ring collectives (``parallel/ring.py``) and the
``collectives="ring"`` route of the feature-sharded trainers against the
process group's collectives and the reference's ring build.

On four gloo ranks (one ``parallel.mesh.launch``, programs in
``tests/torch_tree_ranks.py``): ``ring_psum`` / ``ring_all_gather`` against
``psum`` / ``all_gather`` on a ``(1, 4)`` features mesh; the rank-r step,
scan and sketch (and the crossover merge's worker gather on a ``(2, 2)``
mesh) with ``collectives="ring"`` against ``"xla"`` and against the
reference on a mesh of the same shape (its ring build on two-rank rings,
its xla build on the four-rank ring, where its own ring drifts degrees
from its xla build: checked here first); the estimator with
``collectives="ring"``. In one process, the ring route is the xla route bit
for bit (every ring is one rank).

Random starts cross over as numbers: the reference draws each feature
shard's start from ``fold_in(PRNGKey(0), f)`` (the same draw on every
workers rank); those shards, stacked along ``d`` and repeated over the
workers ranks, are the port's ``v_rand`` (and ``omega`` for the sketch).

Tolerances: ring against xla within the reference's ``atol=5e-4``
(``tests/test_ring.py``) on the state and the basis (as projectors: within
a near-degenerate top-k ``eigh`` leaves the eigenvectors free up to a
rotation), and 0.01 degrees; the
port's ring build against the reference's within 1e-3 degrees and 1e-5
relative in ``s`` (the feature-sharded tests' tolerances); the ring sum's
result bit-equal on every rank (its design: a gather, then a sum in
source order); the estimator within 1 degree of the planted top-k (the
reference's gate) and 0.05 degrees of the reference's estimator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tree_ranks as ranks

from distributed_eigenspaces_tpu.api.estimator import OnlineDistributedPCA as JaxPCA
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import synthetic as jsyn
from distributed_eigenspaces_tpu.parallel import feature_sharded as jfs
from distributed_eigenspaces_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as tfs
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel import ring

RING_ATOL = 5e-4
RING_DEG = 0.01
SAME_DEG = 1e-3
REL = 1e-5
FIT_DEG = 0.05
TIMEOUT = 240.0
D, K, M, N, T = 64, 3, 4, 64, 4
BASE = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
            subspace_iters=16, solver="subspace", backend="feature_sharded")


def _angle(a, b) -> float:
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _proj(v):
    v = np.asarray(v, np.float64)
    return v @ v.T


def _data(steps=T, seed=2):
    spec = jsyn.planted_spectrum(D, k_planted=K, gap=25.0, noise=0.01, seed=seed)
    x = np.asarray(spec.sample(jax.random.PRNGKey(0), steps * M * N))
    return spec, x.reshape(steps, M, N, D).astype(np.float32)


def _stacked(shape, cols, lead=None, key=None):
    """The reference's per-feature-shard draws ``fold_in(key, f)`` (default
    ``key = PRNGKey(0)``) of shape ``lead / W + (d / F, cols)``, stacked
    along d and repeated over the ``W`` workers ranks (each draws the same)."""
    w, f = shape
    key = jax.random.PRNGKey(0) if key is None else key
    per = () if lead is None else (lead // w,)
    rows = np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), per + (D // f, cols), jnp.float32)) for i in range(f)],
        axis=-2)
    return rows if lead is None else np.concatenate([rows] * w, axis=0)


def _cases():
    _, xs = _data()
    one = (1, 4)
    sketch_key = jax.random.split(jax.random.PRNGKey(0))
    p = K + 16
    return [
        ("step", "step", one, BASE, xs, dict(v_rand=_stacked(one, K, M))),
        ("scan", "scan", one, BASE, xs, dict(v_rand=_stacked(one, K, M))),
        ("scan_interval", "scan", one, dict(BASE, merge_interval=2), xs,
         dict(v_rand=_stacked(one, K, M))),
        ("sketch", "sketch", one, dict(BASE, warm_start_iters=2), xs,
         dict(omega=_stacked(one, p, key=sketch_key[0]),
              v_rand=_stacked(one, K, M, key=sketch_key[1]))),
        ("step_workers", "step", (2, 2), BASE, xs, dict(v_rand=_stacked((2, 2), K, M))),
        ("step_distributed", "step", (2, 2),
         dict(BASE, solver="distributed", eigh_crossover_d=32), xs,
         dict(v_rand=_stacked((2, 2), K, M),
              v_init=_stacked((2, 2), K + min(8, M * K - K)))),
    ]


def _jax_case(kind, shape, kw, xs, collectives):
    """The reference's build of ``kind`` on a mesh of ``shape``: the whole
    final state and the final basis."""
    jcfg = JaxConfig(**kw)
    mesh = jax_make_mesh(num_workers=shape[0], num_feature_shards=shape[1],
                         devices=jax.devices()[:shape[0] * shape[1]])
    if kind == "step":
        step = jfs.make_feature_sharded_step(jcfg, mesh, seed=0, collectives=collectives)
        st = step.init_state()
        for t in range(xs.shape[0]):
            st, vb = step(st, jnp.asarray(xs[t]))
        return st, np.asarray(vb)
    make = (jfs.make_feature_sharded_sketch_fit if kind == "sketch"
            else jfs.make_feature_sharded_scan_fit)
    fit = make(jcfg, mesh, seed=0, collectives=collectives)
    st = fit(fit.init_state(), jnp.asarray(xs), jnp.arange(xs.shape[0], dtype=jnp.int32))
    if kind == "sketch":
        return st, np.asarray(fit.extract(st))
    return st, np.asarray(st.u)[:, :kw["k"]]


def _reference_collectives(shape):
    """The reference build the port's ring is held to: its own ring on
    rings of at most two ranks, its xla build on longer ones, where its
    ring leaves each device its own bits of every replicated value and the
    fits drift apart (:func:`test_the_references_ring_drifts_on_four_shards`)."""
    return "ring" if shape[1] <= 2 else "xla"


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((4, 16, 5)).astype(np.float32)
    spec, x = _data(seed=6)
    est_kw = dict(BASE, subspace_iters=24, collectives="ring",
                  mesh_shape={"workers": 1, "features": 4})
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (D, K), jnp.float32))
    out = pmesh.launch(ranks.ring_suite, 4, xs, _cases(), est_kw, x.reshape(-1, D), v0,
                       workdir=str(tmp_path_factory.mktemp("ring")), timeout=TIMEOUT)
    return xs, out, (spec, x, est_kw)


def test_ring_sum_and_gather_on_four_ranks(four_ranks):
    xs, out, _ = four_ranks
    want = xs.sum(axis=0)
    for r in range(4):
        ops = out[r]["ops"]
        np.testing.assert_allclose(ops["ring_psum"], ops["psum"], atol=RING_ATOL, rtol=0)
        np.testing.assert_allclose(ops["ring_psum"], want, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(ops["ring_gather"], ops["gather"])
        np.testing.assert_array_equal(ops["ring_gather"], xs.reshape(-1, 5))
        # one result on every rank, bit for bit
        np.testing.assert_array_equal(ops["ring_psum"], out[0]["ops"]["ring_psum"])
        # each op is size - 1 = 3 hops of this rank's block, over features
        assert ops["hops"] == [("ppermute", "features", "float32", 16 * 5, 4, None)] * 6


@pytest.mark.parametrize("name", [c[0] for c in _cases()])
def test_ring_trainers_match_xla_and_the_references_ring(four_ranks, name):
    _, out, _ = four_ranks
    _, kind, shape, kw, xs, _ = next(c for c in _cases() if c[0] == name)
    ring_st, ring_v = out[0]["trainers"][(name, "ring")]
    xla_st, xla_v = out[0]["trainers"][(name, "xla")]
    if kind == "sketch":  # no eigensolve in the carry: the sketch as it is
        np.testing.assert_allclose(ring_st["y"], xla_st["y"], atol=RING_ATOL, rtol=0)
    else:  # the top-k projector: eigenvectors are free up to a rotation
        np.testing.assert_allclose(_proj(ring_st["u"][:, :K]), _proj(xla_st["u"][:, :K]),
                                   atol=RING_ATOL, rtol=0)
        np.testing.assert_allclose(ring_st["s"], xla_st["s"], atol=RING_ATOL, rtol=0)
        assert _angle(ring_st["u"][:, :K], xla_st["u"][:, :K]) <= RING_DEG
    np.testing.assert_allclose(_proj(ring_v), _proj(xla_v), atol=RING_ATOL, rtol=0)
    assert _angle(ring_v, xla_v) <= RING_DEG
    jst, jv = _jax_case(kind, shape, kw, xs, _reference_collectives(shape))
    assert ring_st["step"] == int(jst.step) == T
    assert _angle(ring_v, jv) <= SAME_DEG
    if kind != "sketch":
        assert _rel(ring_st["s"], np.asarray(jst.s)) <= REL
    for r in range(1, 4):  # the ring's replicated values: rank 0's bits
        for a, b in zip(out[r]["trainers"][(name, "ring")][0].values(), ring_st.values()):
            np.testing.assert_array_equal(a, b)


def test_the_references_ring_drifts_on_four_shards(four_ranks):
    """Checked before the reference is taken as ground truth: on a ``(1,
    4)`` mesh the reference's ring build of the scan and the sketch lands
    degrees from its own xla build (each device sums the ring in its own
    order, so replicated values differ in their last bits and the host-free
    SPMD loop amplifies that), while the port's ring stays with its xla
    route and with the reference's xla build."""
    _, out, _ = four_ranks
    spec, _ = _data()
    for name in ("scan", "sketch"):
        _, kind, shape, kw, xs, _ = next(c for c in _cases() if c[0] == name)
        _, jring = _jax_case(kind, shape, kw, xs, "ring")
        _, jxla = _jax_case(kind, shape, kw, xs, "xla")
        ring_v = out[0]["trainers"][(name, "ring")][1]
        assert _angle(jring, jxla) > 1.0, name
        assert _angle(ring_v, jxla) <= SAME_DEG, name
        assert _angle(jxla, spec.top_k(K)) < 1.0 < _angle(jring, spec.top_k(K)), name


def test_estimator_with_ring_collectives(four_ranks):
    _, out, (spec, x, est_kw) = four_ranks
    jest = JaxPCA(JaxConfig(**{k: v for k, v in est_kw.items() if k != "mesh_shape"}))
    jest.fit(x.reshape(-1, D))
    for r in range(4):
        w = out[r]["estimator"]["w"]
        assert w.shape == (D, K)
        assert _angle(w, spec.top_k(K)) <= 1.0
        assert _angle(w, np.asarray(jest.components_)) <= FIT_DEG
        np.testing.assert_array_equal(w, out[0]["estimator"]["w"])


def test_ring_on_one_process_is_the_xla_route_bit_for_bit():
    _, xs = _data()
    for kind, make in (("scan", tfs.make_feature_sharded_scan_fit),
                       ("sketch", tfs.make_feature_sharded_sketch_fit)):
        cfg = PCAConfig(**BASE)
        got = {}
        for coll in ("xla", "ring"):
            fit = make(cfg, device="cpu", collectives=coll)
            got[coll] = fit.extract(fit(fit.init_state(), torch.from_numpy(xs)))
        assert torch.equal(got["ring"], got["xla"]), kind
    with pmesh.mesh_scope(pmesh.local_mesh("cpu")):
        x = torch.randn(3, 2)
        assert torch.equal(ring.ring_psum(x, pmesh.FEATURE_AXIS), x)
        assert torch.equal(ring.ring_all_gather(x, pmesh.WORKER_AXIS), x)


def test_unknown_collectives_are_refused():
    cfg = PCAConfig(**BASE)
    for make in (tfs.make_feature_sharded_step, tfs.make_feature_sharded_scan_fit,
                 tfs.make_feature_sharded_sketch_fit):
        with pytest.raises(ValueError, match="unknown collectives"):
            make(cfg, device="cpu", collectives="nccl")
    assert PCAConfig(**dict(BASE, collectives="ring")).collectives == JaxConfig(
        **dict(BASE, collectives="ring")).collectives
