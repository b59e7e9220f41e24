"""The row-sharded basis, against the reference's: sharded publish, its
recovery, replicas, grown lineage and the features-mesh serve engine.

The counterparts of ``tests/test_sharded_basis.py``: a sharded publish
round-trips bit for bit per shard (written by either package, read by
either), ``num_shards`` splits rows as the reference does, a torn or
missing shard quarantines its version loudly, a replica skips a rotted
shard and installs a good sharded version with its spec and shard sizes,
sharded grown lineage survives recovery, and on two gloo ranks (one
``parallel.mesh.launch``, ``tests/torch_fs_ranks.py``) the row-sharded
engine equals the dense one with ``project`` as its only reduction and
the query server serves a sharded version at fp32, bf16 and int8; during
a hot swap every rank serves one agreed version and sheds alike. An
indivisible ``d`` is refused loudly. Tolerances: bytes and shard sizes
exact; served rows as the reference's tests hold them (fp32 within 1e-5,
the quantized routes within 0.2 degrees a row).
"""

import glob
import os

import numpy as np
import pytest
import torch
import torch_fs_ranks as ranks

from distributed_eigenspaces_tpu.serving.registry import EigenbasisRegistry as JaxRegistry
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.serving.registry import EigenbasisRegistry
from distributed_eigenspaces_tpu_torch.serving.replication import ReplicaRegistry
from distributed_eigenspaces_tpu_torch.serving.transform import TransformEngine

D, K = 32, 3
TIMEOUT = 180.0
REGISTRIES = {"port": EigenbasisRegistry, "jax": JaxRegistry}


def _shards(seed=0, d=D, k=K, parts=2):
    rng = np.random.default_rng(seed)
    v = np.linalg.qr(rng.standard_normal((d, k)))[0].astype(np.float32)
    rows = d // parts
    return [v[i * rows:(i + 1) * rows] for i in range(parts)], v


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_roundtrip_bit_exact_per_shard(tmp_path, writer, reader):
    td = str(tmp_path / "reg")
    parts, full = _shards()
    bv = REGISTRIES[writer](registry_dir=td).publish(parts, spec=("features", None),
                                                     step=3)
    assert bv.shard_sizes == (16, 16) and bv.num_shards == 2
    assert bv.spec == ("features", None)
    lv = REGISTRIES[reader](registry_dir=td).latest()
    assert lv.version == bv.version and lv.step == 3
    assert lv.spec == ("features", None) and lv.shard_sizes == (16, 16)
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(np.asarray(lv.shard(i)), p)
    np.testing.assert_array_equal(np.asarray(lv.v), full)
    files = sorted(os.path.basename(f) for f in glob.glob(os.path.join(td, "v*", "*")))
    assert files == ["basis.shard00.npz", "basis.shard01.npz", "meta.json"]


def test_num_shards_balanced_split_and_one_shard_replicated(tmp_path):
    v = np.random.default_rng(7).standard_normal((33, 2)).astype(np.float32)
    got = EigenbasisRegistry(registry_dir=str(tmp_path / "a")).publish(v, num_shards=4)
    want = JaxRegistry(registry_dir=str(tmp_path / "b")).publish(v, num_shards=4)
    assert got.shard_sizes == want.shard_sizes == (9, 8, 8, 8)
    assert got.spec == want.spec == ("features", None)
    np.testing.assert_array_equal(np.concatenate([got.shard(i) for i in range(4)]), v)
    rep = EigenbasisRegistry().publish(_shards()[1])
    assert rep.shard_sizes is None and rep.spec is None and rep.num_shards == 1
    with pytest.raises(IndexError, match="1 shard"):
        rep.shard(1)
    with pytest.raises(ValueError, match="num_shards"):
        EigenbasisRegistry().publish(v, num_shards=40)
    # tensors publish as shards too (a rank's rows, wherever they lie)
    parts, full = _shards()
    bv = EigenbasisRegistry().publish([torch.from_numpy(p) for p in parts])
    np.testing.assert_array_equal(bv.v, full)


@pytest.mark.parametrize("damage", ["torn", "missing"])
def test_torn_or_missing_shard_quarantined_loudly(tmp_path, damage):
    td = str(tmp_path / "reg")
    parts, _ = _shards()
    EigenbasisRegistry(registry_dir=td).publish(parts, spec=("features", None))
    (shard_file,) = glob.glob(os.path.join(
        td, "v*", "basis.shard01.npz" if damage == "torn" else "basis.shard00.npz"))
    if damage == "torn":
        with open(shard_file, "r+b") as f:
            f.truncate(32)
    else:
        os.remove(shard_file)
    reg2 = EigenbasisRegistry(registry_dir=td)
    assert reg2.latest() is None and len(reg2.quarantined) == 1
    assert glob.glob(os.path.join(td, "v*.quarantined"))
    # the burned id is never reused
    nxt = reg2.publish(parts, spec=("features", None))
    assert nxt.version > 1


def test_replica_installs_sharded_and_skips_a_rotted_shard(tmp_path):
    td = str(tmp_path / "reg")
    parts, full = _shards()
    reg = EigenbasisRegistry(registry_dir=td)
    good = reg.publish(parts, spec=("features", None), step=9)
    with ReplicaRegistry(td, start=False) as rep:
        got = rep.latest()
        assert got.version == good.version and got.spec == ("features", None)
        assert got.shard_sizes == good.shard_sizes
        np.testing.assert_array_equal(got.v, full)
    bad = reg.publish(_shards(seed=1)[0], spec=("features", None))
    (shard_file,) = glob.glob(os.path.join(td, f"v{bad.version:08d}",
                                           "basis.shard01.npz"))
    with open(shard_file, "r+b") as f:
        f.truncate(32)
    with ReplicaRegistry(td, start=False) as rep:
        assert rep.latest().version == good.version  # the rotted one skipped
        assert rep.corrupt_skipped == 1
        assert os.path.exists(shard_file)  # evidence untouched


def _grown_pair(seed=0, d=D, k0=K, k1=K + 2, parts=2):
    rng = np.random.default_rng(seed)
    full = np.linalg.qr(rng.standard_normal((d, k1)))[0].astype(np.float32)
    rows = d // parts
    split = lambda v: [v[i * rows:(i + 1) * rows] for i in range(parts)]  # noqa: E731
    return split(full[:, :k0]), split(full), full[:, :k0], full


def test_sharded_grown_lineage_survives_recovery(tmp_path):
    """``publish_grown`` on row shards: lineage and prefix survive the
    recovery (by either package); a rotted shard of the grown version
    quarantines it and the parent serves on."""
    td = str(tmp_path / "reg")
    pp, gp, parent, grown = _grown_pair()
    reg = EigenbasisRegistry(registry_dir=td)
    bv0 = reg.publish(pp, spec=("features", None))
    bv1 = reg.publish_grown(bv0, gp, spec=("features", None), lineage={"tenant": "t7"})
    assert bv1.lineage == {"producer": "grow_basis", "grew_from": bv0.version,
                           "k_from": K, "k_to": K + 2, "tenant": "t7"}
    for cls in (EigenbasisRegistry, JaxRegistry):
        lv = cls(registry_dir=td).latest()
        assert lv.version == bv1.version and lv.lineage["grew_from"] == bv0.version
        assert lv.spec == ("features", None)
        np.testing.assert_array_equal(np.asarray(lv.v)[:, :K], parent)
        np.testing.assert_array_equal(np.asarray(lv.v), grown)
    (shard_file,) = glob.glob(os.path.join(td, f"v{bv1.version:08d}",
                                           "basis.shard01.npz"))
    with open(shard_file, "r+b") as f:
        f.truncate(16)
    reg2 = EigenbasisRegistry(registry_dir=td)
    assert reg2.latest().version == bv0.version and len(reg2.quarantined) == 1


def test_engine_refusals():
    """A ``basis_spec`` without a features mesh, or one that is not rows
    over ``features``, is refused loudly; on one feature shard any ``d``
    divides."""
    with pytest.raises(ValueError, match="features"):
        TransformEngine(D, K, basis_spec=("features", None), device="cpu")
    mesh = pmesh.local_mesh("cpu")
    with pytest.raises(ValueError, match="rows over the"):
        TransformEngine(D, K, mesh=mesh, basis_spec=(None, "features"))
    eng = TransformEngine(33, 2, mesh=mesh, basis_spec=("features", None))
    assert eng.d_local == 33  # one feature shard divides anything


def test_indivisible_d_rejected_loudly(tmp_path):
    out = pmesh.launch(ranks.indivisible_engine, 2, 33, workdir=str(tmp_path),
                       timeout=TIMEOUT)
    assert out == ["d=33 does not divide over 2 feature shards"] * 2


@pytest.fixture(scope="module")
def two_rank_serving(tmp_path_factory):
    """One ``parallel.mesh.launch`` of ``torch_fs_ranks.sharded_serving``
    on two gloo ranks (the hot-swap phases included), with its inputs."""
    tmp_path = tmp_path_factory.mktemp("serving")
    rng = np.random.default_rng(5)
    d, k = 64, 4
    v = np.linalg.qr(rng.standard_normal((d, k)))[0].astype(np.float32)
    queries = []
    for rows in (1, 8, 64) * 3:
        c = rng.standard_normal((rows, k))
        noise = rng.standard_normal((rows, d))
        noise *= 0.3 * np.linalg.norm(c, axis=1, keepdims=True) / np.linalg.norm(
            noise, axis=1, keepdims=True)
        queries.append((c @ v.T + noise).astype(np.float32))
    dtypes = ("float32", "bfloat16", "int8")
    out = pmesh.launch(ranks.sharded_serving, 2, v, queries, str(tmp_path / "reg"),
                       dtypes, workdir=str(tmp_path), timeout=TIMEOUT)
    return out, v, queries, dtypes


def test_sharded_engine_and_server_on_two_ranks(two_rank_serving):
    """Two gloo ranks, a ``(1, 2)`` features mesh: rank 0 publishes the
    basis in two shards and a replica on each rank installs it; the
    row-sharded engine's ``project`` equals the dense engine's (its one
    reduction), ``reconstruct`` is each rank's columns of the dense
    reconstruction (none), ``residual_energy`` sums the input energy (one);
    ``TransformEngine(mesh=)`` alone on a ``(2, 1)`` mesh projects each
    rank's rows with none; a burst of 1-, 8- and 64-row queries served through ``QueryServer(mesh=)``
    at fp32 / bf16 / int8 on every rank, one reduction a batch."""
    out, v, queries, dtypes = two_rank_serving
    d, k = v.shape
    dense = TransformEngine(d, k, device="cpu")
    x = queries[-1]
    z_dense = dense.project(x, v).numpy()
    xr_dense = dense.reconstruct(z_dense, v).numpy()
    for r in range(2):
        o = out[r]
        assert o["installed"] == (1, ("features", None), (32, 32))
        e = o["engine"]
        assert e["placed_rows"] == (32, k)
        assert e["psums"] == (1, 0, 1)
        np.testing.assert_allclose(e["z"], z_dense, atol=1e-5, rtol=0)
        np.testing.assert_allclose(e["xr"], xr_dense[:, r * 32:(r + 1) * 32],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(e["e"], np.sum(x.astype(np.float64) ** 2, axis=1),
                                   rtol=1e-5)
        assert np.all(e["r"] >= 0)
        # mesh= alone: zero reductions, the one-device bucket
        rows = o["rows_engine"]
        assert rows["psums"] == 0 and rows["buckets"] == [8]
        np.testing.assert_array_equal(rows["z"], dense.project(x[:3], v).numpy())
        for dt in dtypes:
            zs, psums = o[dt]
            np.testing.assert_array_equal(np.concatenate(zs),
                                          np.concatenate(out[0][dt][0]))
            # one reduction a batch: at most one a query, at least one
            # a full bucket of 8
            assert len(queries) // 8 <= psums <= len(queries)
            for z, q in zip(zs, queries):
                want = q @ v
                if dt == "float32":
                    np.testing.assert_allclose(z, want, atol=1e-5, rtol=0)
                else:
                    cos = np.sum(z * want, 1) / (np.linalg.norm(z, axis=1)
                                                 * np.linalg.norm(want, axis=1))
                    assert np.degrees(np.arccos(np.clip(cos, -1, 1))).max() <= 0.2


def test_engine_report_of_a_sharded_basis_engine_on_two_ranks(devices, two_rank_serving):
    """``analysis.report.engine_report`` of the row-sharded engine on each
    of the two ranks against the reference's report of the same engine (a
    ``(1, 2)`` features mesh of two JAX devices, the same calls): the same
    contract (``dist_serve``), the same bucket programs (8 and 64 rows) with
    the same collectives, every one ``ok``; on the 8-row buckets each rank's
    sharding pass finds its ``(rows, d / 2)`` shard and ``(d / 2, k)`` basis
    rows held sharded (at 64 rows = d the shape rules are skipped, as the
    memory pass is in both packages), and the audit acquires nothing.
    Exact."""
    import jax

    from distributed_eigenspaces_tpu.analysis import report as jreport
    from distributed_eigenspaces_tpu.parallel.mesh import make_mesh
    from distributed_eigenspaces_tpu.serving.transform import TransformEngine as JEngine

    out, v, queries, _ = two_rank_serving
    d, k = v.shape
    jeng = JEngine(d, k, mesh=make_mesh(num_workers=1, num_feature_shards=2,
                                        devices=jax.devices()[:2]),
                   basis_spec=("features", None))
    for x in (queries[-1], queries[-1][:8]):
        jz = jeng.project(x, v)
        jeng.reconstruct(jz, v)
        jeng.residual_energy(x, jz)
    ref = jreport.engine_report(jeng)
    assert (ref["contract"], ref["ok"], ref["n_violations"]) == ("dist_serve", True, 0)
    for o in out:
        rep, untouched = o["engine_report"]
        assert untouched
        assert (rep["contract"], rep["ok"], rep["n_violations"]) == ("dist_serve", True, 0)
        assert sorted(rep["programs"]) == sorted(ref["programs"]) == sorted(
            f"serve_{kind}_rows{rows}" for kind in ("project", "reconstruct", "residual")
            for rows in (8, 64))
        for name, entry in rep["programs"].items():
            assert entry["ok"] and entry["violations"] == []
            assert entry["collectives"]["ops"] == ref["programs"][name]["collectives"]["ops"]
            assert ("memory" in entry) == ("memory" in ref["programs"][name])
            shard = entry["shardings"]
            if name.endswith("rows8"):
                assert shard["checked"] and shard["n_sharded_ok"] >= 1, (name, shard)
                assert all(row["ok"] for row in shard["buffers"]) and shard["buffers"]
            else:
                assert not shard["checked"]


def test_sharded_server_agrees_on_one_version_and_one_shed(two_rank_serving):
    """Each rank serves through its own replica of one store while rank 0
    publishes. Every served row equals the direct fp32 projection at the
    version it is labelled with, on both ranks alike: while rank 0's replica
    is ahead, both serve the older version rank 1 still reads; once rank 0
    no longer holds that version, both fail the requests loudly instead of
    adding the shards of two versions; and a request that rank 0 sheds for
    its deadline is shed on rank 1 too."""
    out = [o["swap"] for o in two_rank_serving[0]]
    vs, queries = out[0]["vs"], out[0]["queries"]
    want = {"both_v1": 1, "rank0_ahead": 1, "both_v2": 2}
    for o in out:
        for name, version in want.items():
            for (ver, z), q in zip(o[name], queries):
                assert ver == version, (name, ver, z)
                np.testing.assert_allclose(z, q @ vs[ver - 1], atol=1e-5, rtol=0)
        for cls, msg in o["rank0_retired_v2"]:
            assert cls == "RuntimeError" and "no longer held on every rank" in msg
        assert [cls for cls, _ in o["shed_on_rank0"]] == ["DeadlineExceeded"] * len(queries)
        assert o["sheds"] == len(queries)
        assert o["swap_count"] == 1
    for name in want:
        for (_, z0), (_, z1) in zip(out[0][name], out[1][name]):
            np.testing.assert_array_equal(z0, z1)
