"""The port's worker round (parallel/worker_pool.py, config.py) against the
reference's.

Both routes of ``_local_eigenspaces`` (the Gram route and the streaming
route) take the reference's own cold start, ``jax.random.normal(PRNGKey(0),
(d, k))``, handed to the port as ``v0``. Subspaces are compared by
principal angle (degrees, float64), vectors after sign canonicalization.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.parallel import worker_pool as jwp
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops import gram as tgram
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import worker_pool as twp


def _v0(d, k):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (d, k), jnp.float32))


def _planted_blocks(rng, m, n, d, k):
    """Worker blocks with a clear top-k (so the solves converge and the
    bases are comparable vector by vector)."""
    q = np.linalg.qr(rng.standard_normal((d, d)))[0]
    lam = np.concatenate([8.0 * 0.8 ** np.arange(k), 0.05 * np.ones(d - k)])
    z = rng.standard_normal((m, n, d))
    return ((z * np.sqrt(lam)) @ q.T).astype(np.float32)


def _angles(a, b):
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


@pytest.mark.parametrize(
    "solver,iters,route",
    [("subspace", 12, "gram"), ("subspace", 2, "streaming"), ("eigh", 12, "gram")],
)
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_local_eigenspaces_both_routes(rng, solver, iters, route, compute_dtype):
    m, n, d, k = 3, 96, 64, 4
    streaming = solver == "subspace" and (2 * k * iters < d and iters <= 6)
    assert streaming == (route == "streaming")
    x = _planted_blocks(rng, m, n, d, k)
    v0 = _v0(d, k)
    want = np.asarray(jwp._local_eigenspaces(
        jnp.asarray(x), k, solver, iters, "cholqr2",
        None if compute_dtype is None else jnp.bfloat16, v0=jnp.asarray(v0),
    ))
    before = tgram.launches
    got = twp._local_eigenspaces(
        torch.from_numpy(x), k, solver, iters, "cholqr2", compute_dtype,
        v0=torch.from_numpy(v0),
    )
    assert tgram.launches == before  # CPU tensors never launch the kernel
    assert got.shape == (m, d, k) and got.dtype == torch.float32
    tol = 1e-3 if compute_dtype is None else 2e-3
    for w in range(m):
        assert _angles(got[w], want[w]) <= 0.05
        np.testing.assert_allclose(got[w].numpy(), want[w], atol=tol)


def test_local_eigenspaces_subspace_needs_v0():
    with pytest.raises(ValueError, match="v0"):
        twp._local_eigenspaces(torch.zeros((2, 8, 16)), 2, "subspace", 12)
    with pytest.raises(ValueError, match="v0"):
        twp._local_eigenspaces(
            torch.zeros((2, 8, 16), dtype=torch.int8), 2, "subspace", 12
        )
    # int8 blocks take the Gram route of eigh (the s8 Gram's plain version)
    xi = torch.from_numpy(np.random.default_rng(0).integers(-127, 128, (2, 8, 16)).astype(np.int8))
    assert twp._local_eigenspaces(xi, 2, "eigh", 12).shape == (2, 16, 2)


def test_masked_projector_mean_matches(rng):
    vs = rng.standard_normal((4, 20, 3)).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)
    jp, jc = jwp._masked_projector_mean(jnp.asarray(vs), jnp.asarray(mask))
    tp, tc = twp._masked_projector_mean(torch.from_numpy(vs), torch.from_numpy(mask))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
    assert float(tc) == float(jc) == 3.0


@pytest.mark.parametrize("mask", [None, [1.0, 1.0, 0.0, 1.0]])
def test_pool_round_matches(rng, mask):
    m, n, d, k = 4, 64, 48, 3
    x = _planted_blocks(rng, m, n, d, k)
    v0 = _v0(d, k)
    jpool = jwp.WorkerPool(m, backend="local", solver="subspace", subspace_iters=12)
    js, jv = jpool.round(
        jnp.asarray(x), k,
        worker_mask=None if mask is None else jnp.asarray(mask), v0=jnp.asarray(v0),
    )
    tpool = twp.WorkerPool(m, solver="subspace", subspace_iters=12, device="cpu")
    ts, tv = tpool.round(x, k, worker_mask=mask, v0=v0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    assert _angles(tv, np.asarray(jv)) <= 0.05
    assert tpool.local_eigenspaces(x, k, v0=v0).shape == (m, d, k)
    with pytest.raises(ValueError, match="workers"):
        tpool.round(x[:2], k, v0=v0)


def test_pool_refuses_unported_backends(rng):
    with pytest.raises(ValueError, match="unknown WorkerPool backend"):
        twp.WorkerPool(4, backend="feature_sharded", device="cpu")
    with pytest.raises(ValueError, match="warm-only"):
        twp.WorkerPool(4, orth_method="ns", device="cpu")
    # shard_map (and its alias) is ported: a process with no group is a
    # world of one rank, whose round is the local round bit for bit (the
    # multi-rank meshes: tests/test_torch_mesh.py)
    x = _planted_blocks(rng, 4, 32, 24, 2)
    v0 = _v0(24, 2)
    local = twp.WorkerPool(4, solver="subspace", device="cpu").round(x, 2, v0=v0)
    for backend in ("shard_map", "tpu"):
        pool = twp.WorkerPool(4, backend=backend, solver="subspace", device="cpu")
        assert pool.backend == "shard_map" and pool.mesh is None
        got = pool.round(x, 2, v0=v0)
        assert torch.equal(got[0], local[0]) and torch.equal(got[1], local[1])


# -- config ------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        dict(discount="1/x"), dict(solver="lanczos"), dict(orth_method="ns"),
        dict(warm_orth_method="svd"), dict(warm_start_iters=0),
        dict(warm_start_iters="often"), dict(remainder="wrap"),
        dict(compute_dtype="not-a-dtype"), dict(k=0), dict(k=99),
        dict(merge_interval=0), dict(backend="gpu"),
        dict(merge_interval=True), dict(pipeline_merge=True),
        dict(pipeline_merge=True, solver="subspace", warm_start_iters=None),
    ],
)
def test_config_rejects_like_the_reference(kw):
    kw = {"dim": 32, "k": 4, **kw}
    with pytest.raises((ValueError, TypeError)):  # jnp.dtype raises TypeError
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        PCAConfig(**kw)


@pytest.mark.parametrize(
    "kw",
    [
        dict(plan_path="plan.json"),
        dict(merge_topology=(("chip", 2),), merge_interval=2),
        dict(collectives="ring", solver="subspace", pipeline_merge=True),
        dict(merge_topology=(("chip", 2),)),
        dict(solver="deflation", merge_topology=(("chip", 2),)),
        dict(collectives="ring"),
    ],
)
def test_config_names_the_roadmap_for_unported_settings(kw):
    j = JaxConfig(dim=32, k=4, num_workers=2, **kw)  # legal in the reference
    if "plan_path" in kw:  # the planner is ported: accepted as given
        assert PCAConfig(dim=32, k=4, num_workers=2, **kw).plan_path == j.plan_path
        return
    # the ring collectives and the tree merge are ported: accepted, in the
    # reference's normal form
    t = PCAConfig(dim=32, k=4, num_workers=2, **kw)
    assert (t.collectives, t.merge_topology, t.merge_interval, t.pipeline_merge) == (
        j.collectives, j.merge_topology, j.merge_interval, j.pipeline_merge)


@pytest.mark.parametrize(
    "kw",
    [
        # the mesh backend and its alias, and the deflation lanes under it
        dict(backend="tpu"), dict(backend="shard_map"),
        dict(solver="deflation", components_axis_size=2, backend="shard_map"),
    ],
)
def test_config_accepts_the_mesh_backends(kw):
    j = JaxConfig(dim=32, k=4, num_workers=2, **kw)
    t = PCAConfig(dim=32, k=4, num_workers=2, **kw)
    assert (t.backend, t.components_axis_size) == (j.backend, j.components_axis_size)


@pytest.mark.parametrize(
    "kw",
    [
        dict(), dict(solver="subspace"), dict(solver="subspace", warm_start_iters=3),
        dict(solver="subspace", warm_start_iters=None),
        dict(solver="subspace", warm_orth_method="qr"),
        dict(compute_dtype="bfloat16"), dict(stage_dtype="float32"),
        dict(solver="distributed"), dict(solver="distributed", warm_start_iters=1),
        dict(solver="distributed", eigh_crossover_d=16, solver_tol=1e-3),
        dict(compute_dtype="bfloat16", stage_dtype="int8"),
        dict(solver="subspace", warm_orth_method="ns"),
        dict(solver="distributed", compute_dtype="bfloat16", stage_dtype="int8",
             warm_orth_method="ns"),
        dict(solver="subspace", merge_interval=2),
        dict(solver="subspace", pipeline_merge=True),
        dict(solver="distributed", merge_interval=3, pipeline_merge=True),
        dict(solver="subspace", merge_interval=2, warm_start_iters=None),
    ],
)
def test_config_resolvers_match(kw):
    j = JaxConfig(dim=32, k=4, **kw)
    t = PCAConfig(dim=32, k=4, **kw)
    assert t.resolved_warm_start() == j.resolved_warm_start()
    assert t.resolved_local_solver() == j.resolved_local_solver()
    assert t.resolved_warm_orth() == j.resolved_warm_orth()
    assert t.resolved_stage_dtype() == str(j.resolved_stage_dtype())
    assert t.uses_distributed_solve() == j.uses_distributed_solve()
    shared = {f.name for f in dataclasses.fields(PCAConfig)}
    for name in shared - {"dtype", "state_dtype", "compute_dtype", "stage_dtype"}:
        assert getattr(t, name) == getattr(j, name), name
