"""The mesh solvers (``solvers/distributed.py`` and ``solvers/deflation.py``
with ``axis_name`` and on ``components``) against the reference's inside
``shard_map`` on a JAX mesh of the same shape.

Gloo groups of 2 and 4 ranks (``parallel.mesh.launch``; programs in
``tests/torch_mesh_ranks.py``) run each solve on meshes of (2, 2), (4, 1),
(2, 1) and, for the lanes, components meshes (4, 1), (2, 2) and (2, 1);
the parent runs the JAX solve on the same numpy operands. The reference
draws its start per row shard (and per lane) from ``fold_in`` of
``PRNGKey(0)``; those shards, stacked into the whole block, are the port's
``v_init``, of which each rank takes its rows (and its lane's columns).
Tolerances: lane staircases (``iters_used``) and sign flips exact, a dead
merge exactly zero, every rank's rows bit-equal along the axes that
replicate them, principal angles within 0.05 degrees of the reference.
One exception to the exact staircase: on four cold lanes at one row shard
the upper lanes' transient amplifies rounding (the reference's own count
for the last lane moves from 24 to 27 at tol 1e-3 when the operand is
scaled by 1 + 1e-6, which leaves its eigenvectors as they are), so where
the reference's staircase moves under that rescale each lane is held
within 6 sweeps of it; where it does not, the counts are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_eigenspaces_tpu.ops.linalg import canonicalize_signs
from distributed_eigenspaces_tpu.parallel.mesh import (
    COMPONENT_AXIS,
    FEATURE_AXIS,
    WORKER_AXIS,
    make_component_mesh,
    make_mesh,
    shard_map,
)
from distributed_eigenspaces_tpu.solvers import deflation as jdefl
from distributed_eigenspaces_tpu.solvers import distributed as jdist
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

ANGLE_DEG = 0.05
TIMEOUT = 180.0
D, K, M, R = 64, 4, 4, 8
ITERS, TOL = 24, 1e-4


def _angle(a, b):
    a = torch.as_tensor(np.array(a, dtype=np.float64))
    b = torch.as_tensor(np.array(b, dtype=np.float64))
    return float(principal_angles_degrees(a, b).max())


def _shards(d, cols, f, lanes=None):
    """The reference's start on a mesh: row shard ``i`` drawn from
    ``fold_in(PRNGKey(0), i)`` (then lane ``l``'s columns from ``fold_in``
    of that by ``l``), stacked into the whole ``(d, cols)`` block."""
    key = jax.random.PRNGKey(0)
    rows = []
    for i in range(f):
        ki = jax.random.fold_in(key, i)
        if lanes is None:
            rows.append(np.asarray(jax.random.normal(ki, (d // f, cols), jnp.float32)))
        else:
            rows.append(np.concatenate([np.asarray(jax.random.normal(
                jax.random.fold_in(ki, lane), (d // f, cols // lanes), jnp.float32))
                for lane in range(lanes)], axis=1))
    return np.concatenate(rows, axis=0)


def _sharded(fn, mesh, in_specs, out_specs):
    return jax.jit(
        shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False),
        in_shardings=tuple(NamedSharding(mesh, s) for s in in_specs),
    )


def _rows_of(out, d, axis_index, key):
    """The whole ``(d, .)`` result from the ranks' row blocks, checking
    every rank that holds the same rows holds the same bits."""
    blocks = {}
    for o in out:
        f = o["coords"][axis_index] if axis_index is not None else 0
        if f in blocks:
            np.testing.assert_array_equal(o[key], blocks[f])
        else:
            blocks[f] = o[key]
    return np.concatenate([blocks[f] for f in sorted(blocks)], axis=0)


def _worker_stack(rng, m=M, d=D, k=K, noise=0.05):
    truth = np.linalg.qr(rng.standard_normal((d, k)))[0]
    return np.stack([np.linalg.qr(truth + noise * rng.standard_normal((d, k)))[0]
                     for _ in range(m)]).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_dist_solvers_on_a_mesh_match(shape, tmp_path):
    """``test_dist_solver.py:100, 138, 161`` with the port on both sides of
    the mesh: the masked merge, the all-ones and dead merges, the ``tol``
    merge, ``dist_subspace_eig`` and ``dist_extract_top_k`` on the sharded
    low-rank operator, and the sign rule, each against the JAX solve."""
    w, f = shape
    rng = np.random.default_rng(11)
    vs = _worker_stack(rng)
    vs[0] = np.linalg.qr(rng.standard_normal((D, K)))[0]  # a corrupted worker
    mask = np.array([0.0, 1.0, 1.0, 1.0], np.float32)
    u = np.linalg.qr(rng.standard_normal((D, R)))[0].astype(np.float32)
    s = (8.0 * 0.6 ** np.arange(R)).astype(np.float32)
    vsign = rng.standard_normal((D, K)).astype(np.float32)
    kk = K + jdist._default_oversample(K, M * K)
    v_init = _shards(D, kk, f)
    v_init_u = _shards(D, K + 2, f)
    out = pmesh.launch(ranks.dist_solvers, w * f, shape, vs, mask, v_init, u, s,
                       v_init_u, vsign, K, ITERS, TOL, workdir=str(tmp_path),
                       timeout=TIMEOUT)

    jm = make_mesh(num_workers=w, num_feature_shards=f, devices=jax.devices()[: w * f])
    merge_specs = (P(WORKER_AXIS, FEATURE_AXIS, None), P(WORKER_AXIS))
    rows = P(FEATURE_AXIS, None)

    def jmerge(tol):
        return _sharded(lambda v, m: jdist.dist_merged_top_k(v, K, mask=m, iters=ITERS,
                                                             tol=tol),
                        jm, merge_specs, rows)

    for key, m_, tol in (("masked", mask, None), ("ones", np.ones(M, np.float32), None),
                         ("tol", mask, TOL)):
        got = _rows_of(out, D, 1, key)
        want = np.asarray(jmerge(tol)(jnp.asarray(vs), jnp.asarray(m_)))
        assert _angle(got, want) <= ANGLE_DEG, key
    assert not _rows_of(out, D, 1, "dead").any()

    def jsub(uu, ss):
        return jdist.dist_subspace_eig(
            jdist.lowrank_matvec(uu, ss, FEATURE_AXIS), uu.shape[0], K, iters=ITERS,
            axis_name=FEATURE_AXIS, oversample=2, tol=TOL, with_info=True)

    jv, jinfo = _sharded(jsub, jm, (rows, P()), (rows, {"iters_used": P(), "residual": P()})
                         )(jnp.asarray(u), jnp.asarray(s))
    assert _angle(_rows_of(out, D, 1, "subspace"), np.asarray(jv)) <= ANGLE_DEG
    for o in out:
        assert o["subspace_info"]["iters_used"] == int(jinfo["iters_used"])
    jx = _sharded(lambda uu, ss: jdist.dist_extract_top_k(uu, ss, K, iters=ITERS),
                  jm, (rows, P()), rows)(jnp.asarray(u), jnp.asarray(s))
    got = _rows_of(out, D, 1, "extract")
    assert _angle(got, np.asarray(jx)) <= ANGLE_DEG
    # descending Rayleigh quotients, the published column order
    quot = np.diag(got.T @ ((u * s) @ u.T) @ got)
    assert np.all(np.diff(quot) <= 1e-4), quot
    np.testing.assert_array_equal(_rows_of(out, D, 1, "signs"),
                                  np.asarray(canonicalize_signs(jnp.asarray(vsign))))


LANES_K = 8
DEFL_R = 16
#: the lanes' stop: tight enough that every lane is past its transient, so
#: two solves that stop there agree to 0.05 degrees (at 1e-3 the last lane
#: stops where rounding puts it, ~0.2 degrees apart)
LANE_TOL = 1e-5
#: sweeps a lane's count may differ by where the reference's own count
#: moves under a 1e-6 rescale of the operand (four cold lanes: its last
#: lane moves by 2 to 3 sweeps, the port's lies 4 off at one row split)
STAIR_SPREAD = 6


def _operand():
    rng = np.random.default_rng(42)
    u = np.linalg.qr(rng.standard_normal((D, DEFL_R)))[0].astype(np.float32)
    s = (8.0 * 0.5 ** np.arange(DEFL_R)).astype(np.float32)
    return u, s


def _assert_staircase(counts, ref, ref_rescaled):
    """The port's per-lane sweep counts against the reference's: equal where
    the reference's own staircase is the same on the operand scaled by
    1 + 1e-6 (the same eigenvectors); where that rescale moves it, rounding
    sets the counts, and each lane is held within ``STAIR_SPREAD`` sweeps."""
    ref, ref2 = np.asarray(ref).tolist(), np.asarray(ref_rescaled).tolist()
    if ref == ref2:
        assert counts == ref, (counts, ref)
    else:
        assert all(abs(c - r) <= STAIR_SPREAD for c, r in zip(counts, ref)), (
            counts, ref, ref2)


def _lane_angles(v, u, lanes):
    kb = LANES_K // lanes
    return [_angle(v[:, i * kb:(i + 1) * kb], u[:, i * kb:(i + 1) * kb])
            for i in range(lanes)]


@pytest.mark.parametrize("world", [2, 4])
def test_deflation_lanes_on_a_components_mesh_match(world, tmp_path):
    """``test_deflation.py:162, 303``: the lanes sharded over
    ``components`` (one lane a rank, rows over ``features``) with ``tol``
    and at a fixed count, the batched lanes with rows over ``features``,
    the mesh deflation merge (masked) and ``grow_directions(axis_name=)``,
    each against the JAX solve on a mesh of the same shape; every lane
    within 0.05 degrees of the reference's and its staircase the same."""
    u, s = _operand()
    comp_shapes = [(4, 1), (2, 2)] if world == 4 else [(2, 1)]
    work = (2, 2) if world == 4 else (2, 1)
    rng = np.random.default_rng(5)
    vs = _worker_stack(rng, k=LANES_K)
    vs[0] = np.linalg.qr(rng.standard_normal((D, LANES_K)))[0]
    mask = np.array([0.0, 1.0, 1.0, 1.0], np.float32)
    parent = u[:, : LANES_K // 2]
    lane_inits = [_shards(D, LANES_K, f, lanes=lanes) for lanes, f in comp_shapes]
    wf = work[1]
    out = pmesh.launch(
        ranks.deflation_lanes, world, comp_shapes, work, u, s, lane_inits,
        _shards(D, LANES_K, wf), vs, mask, _shards(D, LANES_K, wf), parent,
        _shards(D, LANES_K // 2, wf), LANES_K, 64, LANE_TOL,
        workdir=str(tmp_path), timeout=TIMEOUT)
    rows = P(FEATURE_AXIS, None)
    for lanes, f in comp_shapes:
        cm = make_component_mesh(lanes, f, devices=jax.devices()[: lanes * f])

        def solve(uu, ss, tol, iters):
            v, info = jdefl.dist_deflation_eig(
                jdist.lowrank_matvec(uu, ss, FEATURE_AXIS), uu.shape[0], LANES_K,
                lanes=lanes, iters=iters, tol=tol, key=jax.random.PRNGKey(0),
                with_info=True)
            return v, info["iters_used"][None]

        res = [o[(lanes, f)] for o in out]
        got = _rows_of(res, D, 1, "v")
        cold = _sharded(lambda a, b: solve(a, b, LANE_TOL, 64), cm, (rows, P()),
                        (rows, P(COMPONENT_AXIS)))
        jv, jiters = cold(jnp.asarray(u), jnp.asarray(s))
        # the reference's staircase once more on the operand scaled by
        # 1 + 1e-6 (the same eigenvectors): where that moves a lane's count,
        # the count is set by rounding, not by the schedule
        _, jiters2 = cold(jnp.asarray(u), jnp.asarray(s * np.float32(1 + 1e-6)))
        angles = [_angle(a, b) for a, b in zip(
            np.split(got, lanes, axis=1), np.split(np.asarray(jv), lanes, axis=1))]
        assert max(angles) <= ANGLE_DEG, angles
        assert max(_lane_angles(got, u, lanes)) <= 0.5
        for o in res:  # the staircase gathered over the lanes
            _assert_staircase([int(i) for i in o["iters_used"]], jiters, jiters2)
        fixed, _ = _sharded(lambda a, b: solve(a, b, None, 40), cm, (rows, P()),
                            (rows, P(COMPONENT_AXIS)))(jnp.asarray(u), jnp.asarray(s))
        assert _angle(_rows_of(res, D, 1, "fixed"), np.asarray(fixed)) <= ANGLE_DEG

    wm = make_mesh(num_workers=work[0], num_feature_shards=wf,
                   devices=jax.devices()[: world])
    work_out = [o["work"] for o in out]

    def batched(uu, ss):
        v, info = jdefl.deflation_eig(
            jdist.lowrank_matvec(uu, ss, FEATURE_AXIS), uu.shape[0], LANES_K,
            lanes=comp_shapes[0][0], iters=64, tol=LANE_TOL, axis_name=FEATURE_AXIS,
            with_info=True)
        return v, info["iters_used"]

    run = _sharded(batched, wm, (rows, P()), (rows, P()))
    jv, jiters = run(jnp.asarray(u), jnp.asarray(s))
    _, jiters2 = run(jnp.asarray(u), jnp.asarray(s * np.float32(1 + 1e-6)))
    assert _angle(_rows_of(work_out, D, 1, "batched"), np.asarray(jv)) <= ANGLE_DEG
    for o in work_out:
        _assert_staircase(o["batched_iters"], jiters, jiters2)
    jmerged = _sharded(
        lambda v, m: jdefl.dist_merged_top_k_deflation(
            v, LANES_K, lanes=comp_shapes[0][0], mask=m, iters=24),
        wm, (P(WORKER_AXIS, FEATURE_AXIS, None), P(WORKER_AXIS)), rows,
    )(jnp.asarray(vs), jnp.asarray(mask))
    assert _angle(_rows_of(work_out, D, 1, "merged"), np.asarray(jmerged)) <= ANGLE_DEG
    jgrown = _sharded(
        lambda uu, ss, pp: jdefl.grow_directions(
            jdist.lowrank_matvec(uu, ss, FEATURE_AXIS), pp, LANES_K // 2, iters=64,
            axis_name=FEATURE_AXIS),
        wm, (rows, P(), rows), rows,
    )(jnp.asarray(u), jnp.asarray(s), jnp.asarray(parent))
    grown = _rows_of(work_out, D, 1, "grown")
    assert _angle(grown, np.asarray(jgrown)) <= ANGLE_DEG
    assert np.abs(parent.T @ grown).max() <= 1e-5  # orthogonal to the parent
