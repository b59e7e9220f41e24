"""Rank programs of the feature-sharded tests (``tests/test_torch_feature_
sharded.py``, ``tests/test_torch_sketch.py``, ``tests/test_torch_sharded_
basis.py``).

Each function runs in every rank of a gloo group that
``parallel.mesh.launch`` starts, on the CPU, and returns numpy arrays and
plain values for the test to hold against the JAX package. This module
imports torch and the port only, so no rank ever imports JAX; it is not a
test file itself (pytest collects ``test_*.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as fs
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy().copy()


def _whole(mesh, state):
    """The whole state as numpy arrays (row-sharded fields gathered)."""
    with pmesh.mesh_scope(mesh):
        st = fs.gather_state(state)
    return {f: (int(v) if f == "step" else _np(v)) for f, v in zip(st._fields, st)}


def _rows(mesh, t):
    with pmesh.mesh_scope(mesh):
        return _np(pmesh.all_gather(t.contiguous(), pmesh.FEATURE_AXIS))


def fs_trainers(rank, world, cases):
    """Each case ``(name, kind, cfg_kw, xs, masks, starts)`` on a ``(1,
    world)`` features mesh: ``kind`` one of ``"step"`` (the per-step
    trainer, one ``v_bar`` a step), ``"scan"``, ``"sketch"`` (whole fits),
    ``"sketch_windows"`` (the windowed sketch in windows of 2 steps, the
    whole state after each window); returns the whole final state (and
    the per-step bases / window states) on every rank."""
    mesh = pmesh.make_mesh(1, world, device=CPU)
    out = {"shape": mesh.shape}
    for name, kind, kw, xs, masks, starts in cases:
        cfg = PCAConfig(**kw)
        xs_t = torch.from_numpy(xs)
        if kind == "step":
            step = fs.make_feature_sharded_step(cfg, mesh, **starts)
            st, vbs = step.init_state(), []
            for t in range(xs.shape[0]):
                st, vb = step(st, xs_t[t], None if masks is None else masks[t])
                vbs.append(_rows(mesh, vb))
            out[name] = (_whole(mesh, st), np.stack(vbs))
        elif kind == "scan":
            fit = fs.make_feature_sharded_scan_fit(cfg, mesh, **starts)
            st = fit(fit.init_state(), xs_t, worker_masks=masks)
            out[name] = (_whole(mesh, st), _rows(mesh, fit.extract(st)))
        elif kind == "sketch":
            fit = fs.make_feature_sharded_sketch_fit(cfg, mesh, **starts)
            st = fit(fit.init_state(), xs_t, worker_masks=masks)
            out[name] = (_whole(mesh, st), _rows(mesh, fit.extract(st)))
        else:  # sketch_windows
            fit = fs.make_feature_sharded_sketch_fit(cfg, mesh, **starts)
            seen = []
            st = fit.fit_windows(
                fit.init_state(), (xs_t[t:t + 2] for t in range(0, xs.shape[0], 2)),
                on_segment=lambda t, s: seen.append(
                    (t, {f: (int(v) if f == "step" else _np(v))
                         for f, v in zip(s._fields, s)})))
            out[name] = (_whole(mesh, st), _rows(mesh, fit.extract(st)), seen)
    return out


def fs_estimator(rank, world, kw, x, ckdir):
    """The estimator under ``backend="feature_sharded"`` on the group's
    ``auto_feature_mesh``: the rank-r scan, the sketch (staged, and
    windowed with checkpoints, then resumed from the first checkpoint), the
    per-step loop, and a sketch continued by ``partial_fit``."""
    from distributed_eigenspaces_tpu_torch.api.estimator import OnlineDistributedPCA
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import Checkpointer

    cfg = PCAConfig(**kw)
    out = {"mesh": pmesh.auto_feature_mesh(cfg, CPU).shape}
    for trainer in ("scan", "sketch", "step"):
        est = OnlineDistributedPCA(cfg, device=CPU, trainer=trainer).fit(x)
        out[trainer] = (est.trainer_used_, _np(est.components_), int(est.state.step))
    est = OnlineDistributedPCA(cfg, device=CPU, trainer="sketch", checkpoint_dir=ckdir,
                               segment=2).fit(x)
    out["windowed"] = _np(est.components_)
    mesh = est._sketch_fit.raw.mesh
    st, cursor = Checkpointer(ckdir, device=CPU, mesh=mesh).latest()
    out["restored"] = (st.step, cursor, _whole(mesh, st), _whole(mesh, est.state))
    steps = kw["num_workers"] * kw["rows_per_worker"]
    part = OnlineDistributedPCA(cfg, device=CPU, trainer="sketch").fit(x[:2 * steps])
    for t in range(2, kw["num_steps"]):
        part.partial_fit(torch.from_numpy(x[t * steps:(t + 1) * steps]).reshape(
            kw["num_workers"], kw["rows_per_worker"], -1))
    out["partial"] = (int(part.state.step), _np(part.components_))
    return out


def sharded_serving(rank, world, v, queries, regdir, dtypes):
    """Rank 0 publishes ``v`` in ``world`` row shards; a replica on every
    rank installs it; each rank serves ``queries`` through a ``QueryServer``
    on a ``(1, world)`` mesh with a row-sharded engine, at each of
    ``dtypes``. Also the sharded engine's own project / reconstruct /
    residual against the dense engine, with the reductions each made."""
    from distributed_eigenspaces_tpu_torch.serving.registry import EigenbasisRegistry
    from distributed_eigenspaces_tpu_torch.serving.replication import ReplicaRegistry
    from distributed_eigenspaces_tpu_torch.serving.server import QueryServer
    from distributed_eigenspaces_tpu_torch.serving.transform import TransformEngine

    mesh = pmesh.make_mesh(1, world, device=CPU)
    d, k = v.shape
    if pmesh.is_writer():
        EigenbasisRegistry(registry_dir=regdir).publish(
            [v[i * d // world:(i + 1) * d // world] for i in range(world)], step=3)
    pmesh.barrier()
    replica = ReplicaRegistry(regdir, name=f"r{rank}", start=False)
    live = replica.latest()
    out = {"installed": (live.version, live.spec, live.shard_sizes)}
    eng = TransformEngine(d, k, mesh=mesh, basis_spec=("features", None), device=CPU)
    x = queries[-1]
    placed = eng.place_basis(live)
    p0 = eng.psums
    z = eng.project(x, placed)
    p1 = eng.psums
    xr = eng.reconstruct(z, placed)
    p2 = eng.psums
    r, e = eng.residual_energy(x, z)
    out["engine"] = dict(z=_np(z), xr=_np(xr), r=_np(r), e=_np(e),
                         placed_rows=tuple(placed.shape),
                         psums=(p1 - p0, p2 - p1, eng.psums - p2))
    # mesh= alone: each rank projects its own rows against the whole basis
    rows_eng = TransformEngine(d, k, mesh=pmesh.make_mesh(world, 1, device=CPU))
    zr = rows_eng.project(x[:3], v)
    out["rows_engine"] = dict(z=_np(zr), psums=rows_eng.psums,
                              buckets=rows_eng.stats()["buckets"])
    for dt in dtypes:
        eng = TransformEngine(d, k, mesh=mesh, basis_spec=("features", None),
                              serve_dtype=dt, device=CPU)
        with QueryServer(replica, d=d, k=k, mesh=mesh, engine=eng, serve_dtype=dt,
                         device=CPU) as srv:
            p0 = eng.psums
            tickets = [srv.submit(q) for q in queries]
            zs = [t.result(timeout=120).z for t in tickets]
        out[dt] = (zs, eng.psums - p0)
    replica.close()
    out["swap"] = sharded_swap(rank, world, mesh, regdir + "-swap")
    return out


def _served(tickets):
    """Each ticket's ``(version, z)``, or ``(error class, message)``."""
    got = []
    for t in tickets:
        try:
            p = t.result(timeout=120)
            got.append((p.version, p.z))
        except Exception as e:  # noqa: BLE001 - the test reads the class
            got.append((type(e).__name__, str(e)))
    return got


def sharded_swap(rank, world, mesh, regdir):
    """A hot swap during sharded serving, each rank on its own replica of
    one store (rank 0 keeps 2 versions, the others 4). Bases ``v1..v4`` are
    seeded ``(64, 4)``; the same queries are served in phases: both ranks
    at ``v1``; rank 0's replica at ``v2``, the others' still at ``v1``;
    every rank at ``v2``; rank 0 at ``v4`` (no longer holding ``v2``), the
    others at ``v2``; and, every rank at ``v4``, a server whose deadline
    sheds every request on rank 0 only. Returns the bases, the queries, each
    phase's :func:`_served` and the server's counters."""
    from distributed_eigenspaces_tpu_torch.serving.registry import EigenbasisRegistry
    from distributed_eigenspaces_tpu_torch.serving.replication import ReplicaRegistry
    from distributed_eigenspaces_tpu_torch.serving.server import QueryServer
    from distributed_eigenspaces_tpu_torch.serving.transform import TransformEngine

    rng = np.random.default_rng(9)
    d, k = 64, 4
    vs = [np.linalg.qr(rng.standard_normal((d, k)))[0].astype(np.float32)
          for _ in range(4)]
    queries = [rng.standard_normal((rows, d)).astype(np.float32)
               for rows in (1, 8, 3, 16, 5, 2)]
    store = EigenbasisRegistry(registry_dir=regdir) if pmesh.is_writer() else None

    def publish(*which):
        if store is not None:
            for i in which:
                store.publish(np.split(vs[i], world), step=i + 1)
        pmesh.barrier()

    publish(0)
    replica = ReplicaRegistry(regdir, name=f"swap{rank}", keep=2 if rank == 0 else 4,
                              start=False)
    eng = TransformEngine(d, k, mesh=mesh, basis_spec=("features", None), device=CPU)
    out = {"vs": vs, "queries": queries}
    with QueryServer(replica, d=d, k=k, mesh=mesh, engine=eng, device=CPU) as srv:
        def phase(name, poll_on):
            if rank in poll_on:
                replica._poll_once()
            pmesh.barrier()
            out[name] = _served([srv.submit(q) for q in queries])

        phase("both_v1", ())
        publish(1)
        phase("rank0_ahead", (0,))
        phase("both_v2", tuple(range(1, world)))
        publish(2, 3)
        phase("rank0_retired_v2", (0,))
        out["swap_count"] = srv.swap_count
    replica._poll_once()
    pmesh.barrier()
    cfg = PCAConfig(dim=d, k=k, serve_queue_depth=64,
                    serve_slo_p99_ms=1e-3 if rank == 0 else 1e6)
    with QueryServer(replica, cfg, mesh=mesh, engine=eng, device=CPU) as srv:
        out["shed_on_rank0"] = _served([srv.submit(q) for q in queries])
        out["sheds"] = srv.health()["sheds"]["deadline"]
    return out


def indivisible_engine(rank, world, d):
    """The message of the row-sharded engine refusing a ``d`` that does not
    divide over a ``(1, world)`` mesh, or None."""
    from distributed_eigenspaces_tpu_torch.serving.transform import TransformEngine

    mesh = pmesh.make_mesh(1, world, device=CPU)
    try:
        TransformEngine(d, 2, mesh=mesh, basis_spec=("features", None))
    except ValueError as e:
        return str(e)
    return None
