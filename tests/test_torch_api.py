"""The port's one-device public API against the reference's, name by name,
on the CPU: the estimator's ``partial_fit`` / ``inverse_transform`` /
``score`` / ``matrix_w``, ``one_shot_round``, ``merge_projectors``,
``grassmann_distance``, ``top_k_eigvecs_streaming``, ``make_batches``,
``synthetic_stream``, the namespaces' exports, and the estimator's two
trainer faults (the per-step route must not quantize; ``"sketch"`` /
``"fleet"`` name their ROADMAP items).

Inputs are made with numpy from a seed; random starts are the reference's
own ``jax.random`` draw, handed to the port. Tolerances:

- fp32 products of the same inputs: 1e-5 relative (another summation
  order); bases within 1e-3 degrees (the port's float64 angles);
- the per-step fits: 1e-4 absolute in ``sigma_tilde`` and 0.05 degrees in
  bases (the slices' parity tolerances, ``tests/test_torch_step.py``);
- the reference's fp32 principal angles against the port's float64 ones:
  0.05 degrees (``ROADMAP.md``: the reference reads ~0.05 degrees on spans
  that agree to 1e-5), 1e-4 radians on spans far apart;
- the per-step fit with an int8 stage against the same fit without one:
  bit for bit (the reference's pair differs by 0.0).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_eigenspaces_tpu as jdet
import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu import algo as jalgo
from distributed_eigenspaces_tpu import data as jdata
from distributed_eigenspaces_tpu import ops as jops
from distributed_eigenspaces_tpu import serving as jserving
from distributed_eigenspaces_tpu import solvers as jsolvers
from distributed_eigenspaces_tpu.api.estimator import OnlineDistributedPCA as JaxPCA
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import stream as jstream
from distributed_eigenspaces_tpu.data.synthetic import planted_spectrum as jax_planted
from distributed_eigenspaces_tpu.ops import linalg as jl
from distributed_eigenspaces_tpu_torch import algo as talgo
from distributed_eigenspaces_tpu_torch import data as tdata
from distributed_eigenspaces_tpu_torch import ops as tops
from distributed_eigenspaces_tpu_torch import serving as tserving
from distributed_eigenspaces_tpu_torch import solvers as tsolvers
from distributed_eigenspaces_tpu_torch.api.estimator import TRAINERS
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.data import stream as tstream
from distributed_eigenspaces_tpu_torch.ops import linalg as tl

ROOT = Path(__file__).resolve().parents[1]
D, K, M, N, T = 48, 3, 4, 32, 4
REL = 1e-5
SAME_DEG = 1e-3
FIT_DEG = 0.05
SIGMA_ATOL = 1e-4
REF_ANGLE_DEG = 0.05


def _v0(d=D, k=K):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (d, k), jnp.float32))


def _angle(a, b) -> float:
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(tl.principal_angles_degrees(a, b).max())


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _data(seed=3, rows=T * M * N):
    spec = jax_planted(D, k_planted=K, gap=20.0, noise=0.01, seed=seed)
    return spec, np.asarray(spec.sample(jax.random.PRNGKey(seed), rows))


def _kw(**kw):
    return dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
                solver="subspace", subspace_iters=10, backend="local", **kw)


def _both_step_fits(data, **kw):
    jest = JaxPCA(JaxConfig(**_kw(**kw)), trainer="step").fit(data)
    est = dett.OnlineDistributedPCA(PCAConfig(**_kw(**kw)), device="cpu", trainer="step",
                                    v0=_v0()).fit(data)
    return jest, est


# -- the estimator --------------------------------------------------------------


def test_partial_fit_matches_the_reference():
    spec, data = _data(rows=(T + 2) * M * N)
    fit_rows, extra = data[: T * M * N], data[T * M * N:].reshape(2, M, N, D)
    jest, est = _both_step_fits(fit_rows)
    for block in extra:  # past T: no step cap
        jest.partial_fit(block)
        est.partial_fit(torch.from_numpy(block))
    assert int(est.state.step) == int(jest.state.step) == T + 2
    np.testing.assert_allclose(est.state.sigma_tilde.numpy(),
                               np.asarray(jest.state.sigma_tilde), atol=SIGMA_ATOL, rtol=0)
    assert _angle(est.components_, jest.components_) <= FIT_DEG
    # from a fresh estimator: one step
    fresh = dett.OnlineDistributedPCA(PCAConfig(**_kw()), device="cpu", v0=_v0())
    jfresh = JaxPCA(JaxConfig(**_kw()))
    fresh.partial_fit(extra[0])
    jfresh.partial_fit(extra[0])
    assert int(fresh.state.step) == 1 and fresh.trainer_used_ == "step"
    assert _angle(fresh.components_, jfresh.components_) <= FIT_DEG


def test_inverse_transform_score_and_matrix_w_match_the_reference():
    spec, data = _data()
    jest, est = _both_step_fits(data)
    assert est.matrix_w is est.components_
    assert np.array_equal(np.asarray(jest.matrix_w), np.asarray(jest.components_))
    assert _angle(est.components_, jest.components_) <= FIT_DEG
    # the functions themselves, on the same basis: the reference's
    est._w = torch.from_numpy(np.array(jest.components_))
    z = data[:40] @ est.components_.numpy()
    back = est.inverse_transform(z)
    assert back.shape == (40, D) and back.dtype == torch.float32
    assert _rel(back.numpy(), np.asarray(jest.inverse_transform(z))) <= REL
    ours, theirs = est.score(data), jest.score(data)
    assert set(ours) == set(theirs) == {"explained_variance_ratio"}
    assert abs(ours["explained_variance_ratio"] - theirs["explained_variance_ratio"]) <= REL
    truth = np.asarray(spec.top_k(K))
    ours, theirs = est.score(data, exact_w=truth), jest.score(data, exact_w=truth)
    assert abs(ours["max_principal_angle_deg"] - theirs["max_principal_angle_deg"]) <= REF_ANGLE_DEG
    assert ours["max_principal_angle_deg"] == pytest.approx(_angle(est.components_, truth))
    with pytest.raises(RuntimeError, match="fit"):
        dett.OnlineDistributedPCA(PCAConfig(**_kw()), device="cpu").inverse_transform(z)


# -- algo / ops -----------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 3])  # within the planted rank: defined eigenvectors
def test_one_shot_round_matches_the_reference(k):
    _, data = _data()
    x = data[: M * N].reshape(M, N, D)
    js, jv = jdet.one_shot_round(jnp.asarray(x), k, backend="local")
    ts, tv = dett.one_shot_round(torch.from_numpy(x), k, device="cpu")
    assert tuple(ts.shape) == (D, D) and tuple(tv.shape) == (D, k)
    assert _rel(ts.numpy(), js) <= REL
    assert _angle(tv, jv) <= SAME_DEG
    # and through an explicit pool
    pool = dett.WorkerPool(M, solver="subspace", subspace_iters=12, device="cpu")
    s2, v2 = talgo.one_shot_round(x, k, pool=pool)
    assert _angle(v2, tv) < 1.0 and tuple(s2.shape) == (D, D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_projectors_matches_the_reference(rng, dtype):
    vs = np.stack([np.linalg.qr(rng.standard_normal((D, K)))[0] for _ in range(M)])
    vs = vs.astype(np.float32)
    got = tl.merge_projectors(torch.from_numpy(vs).to(getattr(torch, dtype)))
    want = jl.merge_projectors(jnp.asarray(vs).astype(getattr(jnp, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (D, D)
    tol = REL if dtype == "float32" else 1e-2  # one bf16 rounding of the result
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= tol
    assert _rel(got.float().numpy(), np.einsum("mik,mjk->ij", vs, vs) / M) <= tol


def test_grassmann_distance_matches_the_reference(rng):
    u = np.linalg.qr(rng.standard_normal((D, K)))[0].astype(np.float32)
    v = np.linalg.qr(rng.standard_normal((D, K)))[0].astype(np.float32)
    got = float(tl.grassmann_distance(torch.from_numpy(u), torch.from_numpy(v)))
    want = float(jl.grassmann_distance(jnp.asarray(u), jnp.asarray(v)))
    assert abs(got - want) <= 1e-4
    angles = tl.principal_angles(torch.from_numpy(u), torch.from_numpy(v))
    assert got == pytest.approx(float(torch.linalg.vector_norm(angles)))
    assert float(tl.grassmann_distance(torch.from_numpy(u), torch.from_numpy(u))) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_eigvecs_streaming_matches_the_reference(dtype):
    _, data = _data()
    x = data.reshape(T * M, N, D)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jl.top_k_eigvecs_streaming(jx, K, iters=24, key=jax.random.PRNGKey(0))
    got = tl.top_k_eigvecs_streaming(torch.from_numpy(x).to(getattr(torch, dtype)), K,
                                     iters=24, v0=_v0())
    assert got.shape == (D, K) and got.dtype == torch.float32
    assert _angle(got, want) <= SAME_DEG
    dense = tl.top_k_eigvecs(torch.from_numpy(x.reshape(-1, D).T @ x.reshape(-1, D)), K)
    assert _angle(got, dense) < 1.0
    # the default start is the seeded draw
    assert torch.equal(tl.top_k_eigvecs_streaming(torch.from_numpy(x), K, iters=3),
                       tl.top_k_eigvecs_streaming(torch.from_numpy(x), K, iters=3,
                                                  v0=tl.initial_basis(D, K)))


# -- data -----------------------------------------------------------------------


@pytest.mark.parametrize("n_rows,batch,keep", [(10, 3, True), (10, 3, False), (9, 3, False),
                                               (0, 4, True), (2, 5, False), (2, 5, True)])
def test_make_batches_matches_the_reference(n_rows, batch, keep):
    assert tstream.make_batches(n_rows, batch, keep_tail=keep) == jstream.make_batches(
        n_rows, batch, keep_tail=keep)


def test_synthetic_stream_draws_fresh_planted_blocks():
    spec = dett.planted_spectrum(D, k_planted=K, gap=20.0, noise=0.01, seed=1)
    blocks = list(tdata.synthetic_stream(spec, num_workers=M, rows_per_worker=N,
                                         num_steps=T, seed=4))
    assert len(blocks) == T
    assert all(b.shape == (M, N, D) and b.dtype == torch.float32 for b in blocks)
    assert not torch.equal(blocks[0], blocks[1])  # every step a fresh draw
    again = list(tdata.synthetic_stream(spec, num_workers=M, rows_per_worker=N,
                                        num_steps=T, seed=4))
    assert all(torch.equal(a, b) for a, b in zip(blocks, again))
    # the rows' covariance is the spectrum's: its top-k within 5 degrees
    rows = torch.cat([b.reshape(-1, D) for b in tdata.synthetic_stream(
        spec, num_workers=M, rows_per_worker=512, num_steps=4, seed=4)])
    assert _angle(tl.top_k_eigvecs(rows.T @ rows, K), spec.top_k(K)) < 5.0
    gen = torch.Generator().manual_seed(0)
    bf = list(tdata.synthetic_stream(spec, num_workers=M, rows_per_worker=N, num_steps=2,
                                     generator=gen, dtype="bfloat16"))
    assert [b.dtype for b in bf] == [torch.bfloat16] * 2
    # a fit on the stream recovers the planted subspace, as the reference's does
    est = dett.OnlineDistributedPCA(PCAConfig(**_kw()), device="cpu", v0=_v0())
    est.fit_stream(tdata.synthetic_stream(spec, num_workers=M, rows_per_worker=256,
                                          num_steps=T, seed=2))
    jfit = JaxPCA(JaxConfig(**_kw())).fit_stream(jstream.synthetic_stream(
        jax_planted(D, k_planted=K, gap=20.0, noise=0.01, seed=1), num_workers=M,
        rows_per_worker=256, num_steps=T, seed=2))
    assert _angle(est.components_, spec.top_k(K)) < 1.0
    assert _angle(jfit.components_, spec.top_k(K)) < 1.0


# -- the namespaces -------------------------------------------------------------

@pytest.mark.parametrize("ours,theirs,missing", [
    (dett, jdet, {"__version__"}),
    # ops.gram is the port's Gram kernel module; the function is ops.linalg.gram
    (tops, jops, {"gram"}),
    (talgo, jalgo, set()),
    (tdata, jdata, set()),
    (tsolvers, jsolvers, set()),
    (tserving, jserving, set()),
], ids=["top", "ops", "algo", "data", "solvers", "serving"])
def test_namespaces_export_the_references_names(ours, theirs, missing):
    want = set(theirs.__all__) - missing
    assert want <= set(ours.__all__), sorted(want - set(ours.__all__))
    for name in ours.__all__:
        assert hasattr(ours, name), name
    if ours is not dett and ours is not tserving:
        assert set(ours.__all__) == want
    if ours is tops:
        from distributed_eigenspaces_tpu_torch.ops import gram, linalg

        assert gram.__name__ == "distributed_eigenspaces_tpu_torch.ops.gram"
        assert dett.gram is linalg.gram


def test_new_modules_import_without_jax():
    code = (
        "import sys\n"
        "import distributed_eigenspaces_tpu_torch.solvers.deflation\n"
        "import distributed_eigenspaces_tpu_torch.serving.drift\n"
        "import distributed_eigenspaces_tpu_torch.serving.replication\n"
        "from distributed_eigenspaces_tpu_torch.parallel import multihost, ring, topology, wire\n"
        "from distributed_eigenspaces_tpu_torch.parallel import clients, fleet\n"
        "from distributed_eigenspaces_tpu_torch.runtime import prewarm\n"
        "from distributed_eigenspaces_tpu_torch.ops import cusolver\n"
        "from distributed_eigenspaces_tpu_torch import algo, data, ops\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'distributed_eigenspaces_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_new_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((M, N, D), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        dett.one_shot_round(x, K)
    with pytest.raises(RuntimeError, match="cuda"):
        tsolvers.deflation_eig(lambda v: v, D, K, lanes=1)
    from distributed_eigenspaces_tpu_torch.parallel import topology

    with pytest.raises(RuntimeError, match="cuda"):
        topology.init_wire_residuals(topology.MergeTopology((("a", 2),)), ("int8",), 8, 2, 2)
    from distributed_eigenspaces_tpu_torch.serving import DriftMonitor, EigenbasisRegistry

    reg = EigenbasisRegistry()
    reg.publish(np.eye(D, K, dtype=np.float32))
    mon = DriftMonitor(reg, PCAConfig(**_kw()), supervise=False, auto=False)
    mon.observe(9.0, 10.0, rows=np.random.default_rng(0).standard_normal(
        (M * N, D)).astype(np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        mon.refresh_now()
    from distributed_eigenspaces_tpu_torch.parallel import fleet

    cfg = PCAConfig(**_kw())
    with pytest.raises(RuntimeError, match="cuda"):
        fleet.fit_fleet(cfg, [np.zeros((T, M, N, D), np.float32)])
    with pytest.raises(RuntimeError, match="cuda"):
        fleet.FleetServer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        fleet.FleetPCA(cfg)
    from distributed_eigenspaces_tpu_torch.parallel import clients

    with pytest.raises(RuntimeError, match="cuda"):
        clients.make_population_merge(cfg)


# -- the two faults -------------------------------------------------------------


@pytest.mark.parametrize("trainer,item", [("sketch", "items 15 and 9f"),
                                          ("fleet", "items 15b and 9f")])
def test_unported_trainers_name_their_items(trainer, item):
    assert trainer in TRAINERS
    JaxPCA(JaxConfig(**_kw()), trainer=trainer)  # the reference accepts the name
    # both are ported: the feature-sharded sketch trainer and the
    # one-tenant fleet program (items 15b and 9f; its parity:
    # tests/test_torch_fleet.py)
    est = dett.OnlineDistributedPCA(PCAConfig(**_kw()), device="cpu",
                                    trainer=trainer)
    assert est.trainer == trainer
    with pytest.raises(ValueError, match="unknown trainer"):
        dett.OnlineDistributedPCA(PCAConfig(**_kw()), device="cpu", trainer="nope")


INT8 = dict(compute_dtype="bfloat16", stage_dtype="int8", warm_start_iters=2)


@pytest.mark.parametrize("route", ["trainer_step", "on_step", "mask_generator", "fit_stream"])
def test_per_step_route_takes_float_blocks_under_an_int8_stage(route):
    """Every per-step route fits the same float blocks with or without an
    int8 stage (only the whole-fit trainers stage), as the reference's."""
    _, data = _data()
    blocks = torch.from_numpy(data).reshape(T, M, N, D)

    def run(stage):
        kw = dict(INT8) if stage else {"compute_dtype": "bfloat16", "warm_start_iters": 2}
        est = dett.OnlineDistributedPCA(PCAConfig(**_kw(**kw)), device="cpu", v0=_v0(),
                                        trainer="step" if route == "trainer_step" else "auto")
        if route == "trainer_step":
            est.fit(data)
        elif route == "on_step":
            est.fit(data, on_step=lambda t, st, v: None)
        elif route == "mask_generator":
            est.fit(data, worker_masks=(np.ones(M, np.float32) for _ in range(T)))
        else:
            est.fit_stream(iter(blocks))
        assert est.trainer_used_ == "step"
        return est

    staged, plain = run(True), run(False)
    assert torch.equal(staged.state.sigma_tilde, plain.state.sigma_tilde)
    assert torch.equal(staged.components_, plain.components_)


# -- the hierarchical merge through the estimator ----------------------------------

TREE = (("chip", 2), ("host", 2))


@pytest.mark.parametrize("trainer", ["scan", "step"])
def test_estimator_with_a_merge_topology_matches_the_reference(trainer):
    """The stacked route (``backend="local"``): every merge the tree of
    ``parallel/topology.py``, against the reference's estimator with the
    same topology (fit tolerances)."""
    spec, data = _data()
    kw = _kw(merge_topology=TREE)
    jest = JaxPCA(JaxConfig(**kw), trainer=trainer).fit(data)
    est = dett.OnlineDistributedPCA(PCAConfig(**kw), device="cpu", trainer=trainer,
                                    v0=_v0()).fit(data)
    assert est.trainer_used_ == trainer
    np.testing.assert_allclose(est.state.sigma_tilde.numpy(),
                               np.asarray(jest.state.sigma_tilde), atol=SIGMA_ATOL, rtol=0)
    assert _angle(est.components_, jest.components_) <= FIT_DEG
    assert _angle(est.components_, spec.top_k(K)) < 1.0


def test_estimator_without_a_topology_is_the_flat_fit_bit_for_bit():
    """``merge_topology=None`` and a one-tier topology both run the flat
    merge: the same bits as the estimator without the field set."""
    _, data = _data()
    fits = {}
    for name, kw in (("default", _kw()), ("none", _kw(merge_topology=None)),
                     ("one_tier", _kw(merge_topology=(("all", M),)))):
        est = dett.OnlineDistributedPCA(PCAConfig(**kw), device="cpu", v0=_v0()).fit(data)
        fits[name] = (est.state.sigma_tilde, est.components_)
    for name in ("none", "one_tier"):
        assert torch.equal(fits[name][0], fits["default"][0]), name
        assert torch.equal(fits[name][1], fits["default"][1]), name


def test_estimator_with_a_merge_topology_on_two_ranks_matches_the_reference(tmp_path):
    """``backend="shard_map"`` on two gloo ranks (each solving two of the
    four workers, the factors gathered, then the stacked tree) against the
    reference's estimator on a workers mesh, and every rank's state equal
    to rank 0's."""
    import torch_tree_ranks as ranks
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    spec, data = _data()
    kw = _kw(merge_topology=TREE)
    out = pmesh.launch(ranks.shard_map_estimator, 2, dict(kw, backend="shard_map"), data,
                       _v0(), workdir=str(tmp_path), timeout=180.0)
    jest = JaxPCA(JaxConfig(**dict(kw, backend="shard_map"))).fit(data)
    for got in out:
        assert got["trainer"] == "scan"
        np.testing.assert_allclose(got["sigma"], np.asarray(jest.state.sigma_tilde),
                                   atol=SIGMA_ATOL, rtol=0)
        assert _angle(got["w"], jest.components_) <= FIT_DEG
        np.testing.assert_array_equal(got["sigma"], out[0]["sigma"])
