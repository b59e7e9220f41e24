"""The port's mesh (``parallel/mesh.py``) and the shard_map worker pool,
against the reference's on a JAX mesh of the same shape.

Ranks run as gloo groups of 1, 2 and 4 processes started by
``parallel.mesh.launch`` (spawn, file rendezvous under ``tmp_path``, one
thread a rank, every group under a timeout), on the CPU; their programs are
in ``tests/torch_mesh_ranks.py``, which imports no JAX. The parent runs the
JAX package on the same numpy inputs on its 8 virtual CPU devices.
Tolerances: layouts, gathers, masks exact; a one-rank mesh bit-equal to
the local backend; ``sigma_bar`` within 1e-4 absolute and ``v_bar`` within
0.05 degrees of the reference (the port's float64 angles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks

from distributed_eigenspaces_tpu.parallel import worker_pool as jwp
from distributed_eigenspaces_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

SIGMA_ATOL = 1e-4
ANGLE_DEG = 0.05
TIMEOUT = 120.0


def _launch(fn, world, *args, tmp_path, **kw):
    return pmesh.launch(fn, world, *args, workdir=str(tmp_path), timeout=TIMEOUT, **kw)


def _angle(a, b):
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _jmesh(w, f=1):
    return jax_make_mesh(num_workers=w, num_feature_shards=f, devices=jax.devices()[: w * f])


# -- layout and collectives -----------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_layout_and_collectives(world, tmp_path):
    shapes = [(world, 1), (1, world)] + ([(2, 2)] if world == 4 else [])
    out = _launch(ranks.layout, world, shapes, tmp_path=tmp_path)
    for r, o in enumerate(out):
        assert (o["world"], o["rank"]) == (world, r)
        for w, f in shapes:
            got = o[(w, f)]
            # row-major, the reference's devices.reshape(W, F)
            rw, rf = divmod(r, f)
            assert got["shape"] == {"workers": w, "features": f}
            assert got["coords"] == (rw, rf)
            assert got["rows"] == (rw * 8 // w, (rw + 1) * 8 // w)
            # the placements: workers split, features split in the 2-D layout
            xg = np.arange(8 * 3 * 4, dtype=np.float32).reshape(8, 3, 4)
            wrows = slice(rw * 8 // w, (rw + 1) * 8 // w)
            np.testing.assert_array_equal(got["worker_shard"], xg[wrows])
            np.testing.assert_array_equal(
                got["feature_shard"], xg[wrows][..., rf * 4 // f:(rf + 1) * 4 // f])
            np.testing.assert_array_equal(got["replicated"], xg)
            # gathers in group-rank order: the ranks along the axis
            assert got["gather_workers"] == [float(i * f + rf) for i in range(w)]
            assert got["gather_features"] == [float(rw * f + j) for j in range(f)]
            assert got["psum_features"] == float(sum(rw * f + j for j in range(f)))
            assert got["pmax_workers"] == float((w - 1) * f + rf)
            np.testing.assert_array_equal(
                got["stacked"], np.repeat([[float(i * f + rf)] for i in range(w)], 2, 1))
            np.testing.assert_array_equal(got["placed"], xg[wrows])
            np.testing.assert_array_equal(got["placed_share"], xg[wrows])
            assert got["one_rank_psum_is_x"] == [True] * ((w == 1) + (f == 1))
            assert "block holds 3 workers" in got["place_error"]
        assert o["components"] == ({"components": world, "features": 1}, r)
        # the fit's workers mesh: the largest divisor of m up to the group;
        # none when only a one-wide axis divides m in a group of several
        assert o["workers_mesh"] == [{"workers": world, "features": 1},
                                     {"workers": 1, "features": 1} if world == 1 else None]
        # a host side effect runs on the writer rank only
        assert o["on_writer"] == ([0] if r == 0 else [])
        # oversubscribed and empty layouts are refused loudly, as the reference's
        assert f"needs {world + 1} ranks, have {world}" in o["errors"][0]
        assert f"needs {2 * world} ranks, have {world}" in o["errors"][1]
        assert "must be >= 1" in o["errors"][2]
        # a rank imports neither JAX nor the JAX package
        assert o["jax_modules"] == []


def test_mesh_needs_a_group_and_an_active_mesh():
    assert pmesh.world_size() == 1 and pmesh.rank() == 0 and pmesh.is_writer()
    with pytest.raises(RuntimeError, match="initialize"):
        pmesh.make_mesh(1, device="cpu")
    with pytest.raises(RuntimeError, match="mesh_scope"):
        pmesh.psum(torch.ones(2), pmesh.FEATURE_AXIS)
    with pytest.raises(ValueError, match="nccl"):
        pmesh.initialize("mpi", rank=0, world_size=1, init_method="file:///nonexistent")
    assert pmesh.largest_divisor_leq(8, 3) == 2 and pmesh.largest_divisor_leq(7, 4) == 1
    # without a group: no workers mesh, the caller's device, everything placed
    assert pmesh.workers_mesh(8, "cpu") is None
    assert pmesh.mesh_device(None, "cpu") == torch.device("cpu")
    x = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    np.testing.assert_array_equal(pmesh.place_workers(None, x, 4, "cpu").numpy(), x)
    ran = []
    pmesh.on_writer(None, ran.append, 1)
    assert ran == [1]
    pmesh.barrier()  # a world of one waits for nobody


def test_launch_reraises_a_rank_exception_and_kills_the_rest(tmp_path):
    with pytest.raises(ValueError, match="fails on purpose") as info:
        _launch(ranks.raise_on, 2, 1, tmp_path=tmp_path)
    assert any("raised on rank 1 of 2" in note for note in info.value.__notes__)


def test_launch_kills_every_rank_at_its_timeout(tmp_path):
    with pytest.raises(pmesh.RankTimeout, match="did not finish within"):
        pmesh.launch(ranks.sleep_forever, 2, workdir=str(tmp_path), timeout=4.0)


# -- the shard_map worker pool ------------------------------------------------------


def _planted_blocks(rng, m, n, d, k):
    q = np.linalg.qr(rng.standard_normal((d, d)))[0]
    lam = np.concatenate([8.0 * 0.8 ** np.arange(k), 0.05 * np.ones(d - k)])
    z = rng.standard_normal((m, n, d))
    return ((z * np.sqrt(lam)) @ q.T).astype(np.float32)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_pool_round_shard_map_matches(world, tmp_path):
    """The reference's ``tests/test_worker_pool.py`` shard_map cases: the
    round masked and unmasked and the fold-only round, each against the
    JAX shard_map pool on a mesh of ``world`` devices; a one-rank mesh
    equals the local pool bit for bit."""
    rng = np.random.default_rng(7)
    m, n, d, k = 4, 64, 48, 3
    x = _planted_blocks(rng, m, n, d, k)
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (d, k), jnp.float32))
    masks = [None, np.array([1.0, 1.0, 0.0, 1.0], np.float32),
             np.zeros(m, np.float32)]
    out = _launch(ranks.pool_rounds, world, x, v0, masks, k, tmp_path=tmp_path)
    jpool = jwp.WorkerPool(m, backend="shard_map", solver="subspace",
                           subspace_iters=12, mesh=_jmesh(world))
    for r, o in enumerate(out):
        assert o["auto"] == ("shard_map" if world > 1 else "local")
        assert o["mesh"] == {"workers": world, "features": 1}
        for mask, got, first in zip(masks, o["rounds"], out[0]["rounds"]):
            jm = None if mask is None else jnp.asarray(mask)
            js, jv = jpool.round(jnp.asarray(x), k, worker_mask=jm, v0=jnp.asarray(v0))
            jf, _ = jpool.round(jnp.asarray(x), k, worker_mask=jm, v0=jnp.asarray(v0),
                                merge=False)
            np.testing.assert_allclose(got["sigma"], np.asarray(js), atol=SIGMA_ATOL)
            np.testing.assert_allclose(got["fold"], np.asarray(jf), atol=SIGMA_ATOL)
            assert got["fold_v"] is None
            if mask is not None and not mask.any():
                assert not got["v"].any()  # an all-masked round merges to zeros
            else:
                assert _angle(got["v"], np.asarray(jv)) <= ANGLE_DEG
            # every rank holds the same bits
            np.testing.assert_array_equal(got["sigma"], first["sigma"])
            np.testing.assert_array_equal(got["v"], first["v"])
            if world == 1:
                np.testing.assert_array_equal(got["sigma"], got["local_sigma"])
                np.testing.assert_array_equal(got["v"], got["local_v"])
