"""Rank programs of the hierarchical-merge tests (``tests/test_torch_wire.py``,
``tests/test_torch_topology.py``, ``tests/test_torch_ring.py``,
``tests/test_torch_multihost.py``, ``tests/test_torch_api.py``).

Each function runs in every rank of a gloo group that
``parallel.mesh.launch`` starts, on the CPU, and returns numpy arrays and
plain values for the test to hold against the JAX package. This module
imports torch and the port only, so no rank ever imports JAX; it is not a
test file itself (pytest collects ``test_*.py``).
"""

from __future__ import annotations

import torch

import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
from distributed_eigenspaces_tpu_torch.algo.scan import make_scan_fit
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as fs
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel import multihost as mh
from distributed_eigenspaces_tpu_torch.parallel import ring
from distributed_eigenspaces_tpu_torch.parallel import topology as tp
from distributed_eigenspaces_tpu_torch.parallel import wire

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy().copy()


def _summary(log) -> list:
    """A recorder log as ``(op, axis, dtype, elements, group_size, tag)``
    tuples, in call order."""
    return [(r["op"], r["axis"], r["dtype"], r["elements"], r["group_size"], r["tag"])
            for r in log]


def wire_collectives(rank, world, panels, stacks, slots):
    """The wire collectives on a flat ``("w",)`` mesh of ``world`` ranks, each
    codec: this rank's ``(rows, k)`` panel gathered tiled and stacked, its
    ``(m_local, rows, k)`` stack gathered tiled, and its ``(world, rows, k)``
    slots exchanged all-to-all; with the recorder's log of each codec."""
    mesh = pmesh.grid_mesh(("w",), (world,), device=CPU)
    p, s, c = (torch.from_numpy(a[rank]) for a in (panels, stacks, slots))
    out = {}
    with pmesh.mesh_scope(mesh):
        for dtype in wire.WIRE_DTYPES:
            with pmesh.recording_collectives() as log:
                out[dtype] = {
                    "gather": _np(wire.wire_all_gather(p, "w", dtype)),
                    "gather_stacked": _np(wire.wire_all_gather(p, "w", dtype, tiled=False)),
                    "gather_stack": _np(wire.wire_all_gather(s, "w", dtype)),
                    "all_to_all": _np(wire.wire_all_to_all(c, "w", dtype)),
                }
            out[dtype]["log"] = _summary(log)
    return out


def tier_merges(rank, world, topo_tiers, vs, mask):
    """On the tiered mesh of ``topo_tiers``: one tier of the sharded update
    over the leaf tier (rank ``r`` holding ``vs[r]``), and the whole sharded
    tree, plain and under an all-fp32 wire policy; the leaf worker index."""
    topo = tp.MergeTopology(tuple(topo_tiers))
    mesh = tp.make_tiered_mesh(topo, device=CPU)
    name, f = topo.tiers[0]
    v = torch.from_numpy(vs[rank])
    w = torch.tensor(float(mask[rank]))
    with pmesh.mesh_scope(mesh):
        leaf = tp.flat_worker_index(topo)
        tier, cnt = tp.tier_merge_sharded(v, w, vs.shape[2], name, f)
        tree = tp.tree_merge_sharded(v, w, vs.shape[2], topo)
        fp32 = ("fp32",) * len(topo.tiers)
        tree_fp32, _, norms = tp.tree_merge_sharded(
            v, w, vs.shape[2], topo, wire=fp32,
            residuals=tp.init_wire_residuals(topo, fp32, vs.shape[1], vs.shape[2],
                                             vs.shape[2], device=CPU))
    return {"leaf": leaf, "tier": _np(tier), "cnt": float(cnt), "tree": _np(tree),
            "tree_fp32": _np(tree_fp32), "norms": _np(norms),
            "shape": mesh.shape, "axes": mesh.axis_names}


def tree_fits(rank, world, cases):
    """Each case ``(name, cfg_kw, xs, v0, masks, wire_stats)`` through the
    tier-local trainer on the config's tiered mesh (``make_scan_fit``'s
    dispatch, or ``make_tree_scan_fit`` for the wire stats), under the
    recorder: the per-step bases, the final ``sigma_tilde``, the residual
    norms and the log. Then the trainer's refusals, as messages."""
    out = {}
    for name, kw, xs, v0, masks, stats in cases:
        cfg = PCAConfig(**kw)
        mesh = tp.make_tiered_mesh(tp.resolve_topology(cfg), device=CPU)
        st0 = OnlineState.initial(cfg.dim, device=CPU)
        v0 = torch.from_numpy(v0)
        if stats:
            fit = tp.make_tree_scan_fit(cfg, mesh, masked=masks is not None,
                                        with_wire_stats=True, v0=v0)
        else:
            fit = make_scan_fit(cfg, mesh=mesh, device=CPU, v0=v0,
                                masked=masks is not None)
        args = (st0, torch.from_numpy(xs)) + (() if masks is None else (masks,))
        with pmesh.recording_collectives() as log:
            res = fit(*args)
        out[name] = {"sigma": _np(res[0].sigma_tilde), "v_bars": _np(res[1]),
                     "norms": _np(res[2]) if stats else None, "log": _summary(log)}
    kw = cases[0][1]
    cfg = PCAConfig(**kw)
    mesh = tp.make_tiered_mesh(tp.resolve_topology(cfg), device=CPU)
    errors = {}
    for what, call in (
        ("interval", lambda: tp.make_tree_scan_fit(
            PCAConfig(**dict(kw, merge_interval=2)), mesh)),
        ("stats", lambda: tp.make_tree_scan_fit(
            PCAConfig(**dict(kw, merge_wire_dtype=None)), mesh, with_wire_stats=True)),
        ("gather", lambda: make_scan_fit(cfg, mesh=mesh, device=CPU, gather=True)),
        ("mesh", lambda: tp.make_tree_scan_fit(cfg, pmesh.make_mesh(world, device=CPU))),
    ):
        try:
            call()
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors
    return out


def ring_ops(rank, world, xs):
    """``ring_psum`` / ``ring_all_gather`` against ``psum`` / ``all_gather``
    on a ``(1, world)`` features mesh, this rank holding ``xs[rank]``; with
    the permutes' log."""
    mesh = pmesh.make_mesh(1, world, device=CPU)
    x = torch.from_numpy(xs[rank])
    with pmesh.mesh_scope(mesh), pmesh.recording_collectives() as log:
        got = {"ring_psum": _np(ring.ring_psum(x, pmesh.FEATURE_AXIS)),
               "ring_gather": _np(ring.ring_all_gather(x, pmesh.FEATURE_AXIS))}
        hops = _summary(log)
        got["psum"] = _np(pmesh.psum(x, pmesh.FEATURE_AXIS))
        got["gather"] = _np(pmesh.all_gather(x, pmesh.FEATURE_AXIS))
    got["hops"] = hops
    return got


def _whole(mesh, state):
    with pmesh.mesh_scope(mesh):
        st = fs.gather_state(state)
    return {f: (int(v) if f == "step" else _np(v)) for f, v in zip(st._fields, st)}


def _rows(mesh, t):
    with pmesh.mesh_scope(mesh):
        return _np(pmesh.all_gather(t.contiguous(), pmesh.FEATURE_AXIS))


def ring_trainers(rank, world, cases):
    """Each case ``(name, kind, (W, F), cfg_kw, xs, starts)`` on a ``(W,
    F)`` mesh under ``collectives="xla"`` and ``"ring"``: ``kind``
    ``"step"`` (the per-step trainer), ``"scan"`` or ``"sketch"`` (whole
    fits); the whole final state and the final basis of each."""
    out = {}
    for name, kind, shape, kw, xs, starts in cases:
        mesh = pmesh.make_mesh(*shape, device=CPU)
        cfg = PCAConfig(**kw)
        xs_t = torch.from_numpy(xs)
        for coll in ("xla", "ring"):
            if kind == "step":
                step = fs.make_feature_sharded_step(cfg, mesh, collectives=coll, **starts)
                st = step.init_state()
                for t in range(xs.shape[0]):
                    st, vb = step(st, xs_t[t])
                out[(name, coll)] = (_whole(mesh, st), _rows(mesh, vb))
            else:
                make = (fs.make_feature_sharded_sketch_fit if kind == "sketch"
                        else fs.make_feature_sharded_scan_fit)
                fit = make(cfg, mesh, collectives=coll, **starts)
                st = fit(fit.init_state(), xs_t)
                out[(name, coll)] = (_whole(mesh, st), _rows(mesh, fit.extract(st)))
    return out


def ring_estimator(rank, world, kw, x, v0):
    """The estimator under ``backend="feature_sharded"`` and
    ``collectives="ring"`` on the group's ranks: the whole basis."""
    est = dett.OnlineDistributedPCA(PCAConfig(**kw), device=CPU, v0=torch.from_numpy(v0))
    est.fit(torch.from_numpy(x))
    return {"w": _np(est.components_), "trainer": est.trainer_used_}


def multihost(rank, world, path, read_kw, step_kw, xs, v0):
    """This rank's workers read from a shared row file with
    ``bin_block_stream(worker_range=host_worker_range(...))``, and the
    multi-host train step fed this rank's workers only."""
    from distributed_eigenspaces_tpu_torch.data.bin_stream import bin_block_stream

    shard = mh.host_worker_range(read_kw["num_workers"])
    blocks = [_np(b) for b in bin_block_stream(path, worker_range=(shard.lo, shard.hi),
                                               **read_kw)]
    cfg = PCAConfig(**step_kw)
    mesh = mh.global_mesh(device=CPU)
    step = mh.make_multihost_train_step(cfg, mesh, v0=torch.from_numpy(v0))
    st, vp = OnlineState.initial(cfg.dim, device=CPU), None
    mine = mh.host_worker_range(cfg.num_workers)
    for x in xs:
        st, vp = step(st, torch.from_numpy(x[mine.lo:mine.hi]), vp)
    return {"shard": (shard.lo, shard.hi), "blocks": blocks, "sigma": _np(st.sigma_tilde),
            "v": _np(vp), "rect": mh.host_block_rect(mesh)}


def shard_map_estimator(rank, world, kw, x, v0):
    """The estimator under ``backend="shard_map"`` on the group's ranks:
    the final ``sigma_tilde`` and basis."""
    est = dett.OnlineDistributedPCA(PCAConfig(**kw), device=CPU, v0=torch.from_numpy(v0))
    est.fit(torch.from_numpy(x))
    return {"w": _np(est.components_), "sigma": _np(est.state.sigma_tilde),
            "trainer": est.trainer_used_}


def topology_suite(rank, world, tiers, vs, mask, cases):
    """:func:`tier_merges` and :func:`tree_fits` in one group."""
    return {"merges": tier_merges(rank, world, tiers, vs, mask),
            "fits": tree_fits(rank, world, cases)}


def ring_suite(rank, world, xs, cases, est_kw, est_x, est_v0):
    """:func:`ring_ops`, :func:`ring_trainers` and :func:`ring_estimator`
    in one group."""
    return {"ops": ring_ops(rank, world, xs), "trainers": ring_trainers(rank, world, cases),
            "estimator": ring_estimator(rank, world, est_kw, est_x, est_v0)}
