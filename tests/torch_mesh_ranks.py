"""Rank programs of the mesh tests (``tests/test_torch_mesh*.py``).

Each function runs in every rank of a gloo group that
``parallel.mesh.launch`` starts, on the CPU, and returns numpy arrays and
plain values for the test to hold against the JAX package. This module
imports torch and the port only, so no rank ever imports JAX; it is not a
test file itself (pytest collects ``test_*.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
from distributed_eigenspaces_tpu_torch.algo.scan import (
    SegmentState,
    make_scan_fit,
    make_segmented_fit,
)
from distributed_eigenspaces_tpu_torch.algo.step import make_train_step
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel.worker_pool import WorkerPool

CPU = "cpu"


class Killed(Exception):
    """The deliberate death of a rank in the kill / resume test."""


def _np(t):
    if t is None:
        return None
    return t.detach().cpu().numpy().copy()


def _gather_of(values, axis):
    return _np(pmesh.all_gather(torch.tensor([float(values)]), axis)).tolist()


# -- the mesh and its collectives ----------------------------------------------


def layout(rank, world, shapes):
    """Each ``(W, F)`` mesh's shape, this rank's coordinates, its workers of
    8, and gathers / sums / maxima of the rank number along both axes."""
    out = {"world": pmesh.world_size(), "rank": pmesh.rank()}
    xg = np.arange(8 * 3 * 4, dtype=np.float32).reshape(8, 3, 4)
    for w, f in shapes:
        mesh = pmesh.make_mesh(w, f, device=CPU)
        rows = pmesh.worker_rows(mesh, 8)
        with pmesh.mesh_scope(mesh):
            out[(w, f)] = dict(
                worker_shard=_np(pmesh.worker_shard(mesh, xg)),
                feature_shard=_np(pmesh.feature_shard(mesh, xg)),
                replicated=_np(pmesh.replicated(mesh, xg)),
                shape=mesh.shape,
                coords=(mesh.axis_index(pmesh.WORKER_AXIS),
                        mesh.axis_index(pmesh.FEATURE_AXIS)),
                rows=(rows.start, rows.stop),
                gather_workers=_gather_of(rank, pmesh.WORKER_AXIS),
                gather_features=_gather_of(rank, pmesh.FEATURE_AXIS),
                psum_features=float(pmesh.psum(torch.tensor(float(rank)),
                                               pmesh.FEATURE_AXIS)),
                pmax_workers=float(pmesh.pmax(torch.tensor(float(rank)),
                                              pmesh.WORKER_AXIS)),
                stacked=_np(pmesh.all_gather(torch.full((2,), float(rank)),
                                             pmesh.WORKER_AXIS, tiled=False)),
                # a whole block and this rank's share place alike
                placed=_np(pmesh.place_workers(mesh, xg, 8, CPU)),
                placed_share=_np(pmesh.place_workers(mesh, xg[rows], 8, CPU)),
                # a reduction over a one-rank axis is its operand, no collective
                one_rank_psum_is_x=[
                    pmesh.psum(t, ax) is t
                    for ax in (pmesh.WORKER_AXIS, pmesh.FEATURE_AXIS)
                    if mesh.axis_size(ax) == 1
                    for t in (torch.tensor([float(rank)]),)],
            )
            try:
                pmesh.place_workers(mesh, xg[:3], 8, CPU)
            except ValueError as e:
                out[(w, f)]["place_error"] = str(e)
    wm = [pmesh.workers_mesh(m, CPU) for m in (8, 7)]
    out["workers_mesh"] = [None if x is None else x.shape for x in wm]
    ran = []
    pmesh.on_writer(wm[0], ran.append, rank)
    out["on_writer"] = ran
    comp = pmesh.make_component_mesh(world, 1, device=CPU)
    out["components"] = (comp.shape, comp.axis_index(pmesh.COMPONENT_AXIS))
    errors = []
    for bad in ((world + 1, 1), (world, 2), (0, 1)):
        try:
            pmesh.make_mesh(*bad, device=CPU)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    import sys

    out["jax_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "distributed_eigenspaces_tpu"))
    return out


def raise_on(rank, world, bad_rank):
    """Rank ``bad_rank`` raises; the others wait at a barrier it never
    reaches."""
    if rank == bad_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    pmesh.barrier()
    return rank


def sleep_forever(rank, world):
    import time

    time.sleep(600)


# -- the worker pool ---------------------------------------------------------------


def pool_rounds(rank, world, x, v0, masks, k):
    """The shard_map pool's round, merged and fold-only, per mask, beside
    the local pool's on the same blocks in this rank; and what ``"auto"``
    resolves to."""
    m = x.shape[0]
    kw = dict(solver="subspace", subspace_iters=12, device=CPU)
    pool = WorkerPool(m, backend="shard_map", **kw)
    local = WorkerPool(m, backend="local", **kw)
    out = {"auto": WorkerPool(m, backend="auto", **kw).backend,
           "mesh": None if pool.mesh is None else pool.mesh.shape, "rounds": []}
    for mask in masks:
        s, v = pool.round(x, k, worker_mask=mask, v0=v0)
        fold, none = pool.round(x, k, worker_mask=mask, v0=v0, merge=False)
        ls, lv = local.round(x, k, worker_mask=mask, v0=v0)
        out["rounds"].append(dict(sigma=_np(s), v=_np(v), fold=_np(fold),
                                  fold_v=none, local_sigma=_np(ls), local_v=_np(lv)))
    return out


# -- the train step and the whole-fit trainers ---------------------------------------


def _state0(cfg):
    return OnlineState.initial(cfg.dim, device=CPU)


def _run(cfg, kind, xs, v0, masks, mesh, rows=None):
    """One trainer on ``xs`` ``(T, m, n, d)``: ``"step_cold"`` (every step
    cold), ``"step_warm"`` (each step from the last basis), ``"scan"`` (the
    whole fit; with ``rows`` on this rank's workers only), ``"gather"``,
    ``"masked"``. Returns ``(sigma_tilde, step, v_bars)``."""
    if kind.startswith("step"):
        step = make_train_step(cfg, mesh=mesh, device=CPU, v0=v0)
        st, vp, vbs = _state0(cfg), None, []
        for x in xs:
            st, v = step(st, x, v_prev=vp)
            if kind == "step_warm":
                vp = v
            vbs.append(v)
        return _np(st.sigma_tilde), int(st.step), _np(torch.stack(vbs))
    if kind == "masked":
        fit = make_scan_fit(cfg, mesh=mesh, device=CPU, v0=v0, masked=True)
        st, vbs = fit(_state0(cfg), xs, masks)
    elif kind == "gather":
        fit = make_scan_fit(cfg, mesh=mesh, device=CPU, v0=v0, gather=True)
        blocks, idx = xs
        st, vbs = fit(_state0(cfg), blocks, idx)
    else:
        fit = make_scan_fit(cfg, mesh=mesh, device=CPU, v0=v0)
        st, vbs = fit(_state0(cfg), xs if rows is None else xs[:, rows])
    return _np(st.sigma_tilde), int(st.step), _np(vbs)


def trainers(rank, world, cases):
    """``cases``: ``(name, cfg_kw, kind, xs, v0, masks)``, each run on a
    ``(world, 1)`` mesh (and, in a world of one, without a mesh too, for
    bit-equality); returns ``{name: (mesh_run, local_run or None)}`` and the
    gathers made."""
    mesh = pmesh.make_mesh(device=CPU)
    rows = pmesh.worker_rows(mesh, cases[0][1]["num_workers"])
    out = {}
    g0 = pmesh.gathers
    for name, kw, kind, xs, v0, masks in cases:
        cfg = PCAConfig(**kw)
        sharded = rows if kind == "scan_local" else None
        kind = "scan" if kind == "scan_local" else kind
        got = _run(cfg, kind, xs, v0, masks, mesh, sharded)
        ref = _run(cfg, kind, xs, v0, masks, None) if world == 1 else None
        out[name] = (got, ref)
    out["gathers"] = pmesh.gathers - g0
    return out


def segmented_killed(rank, world, kw, xs, v0, segment, ckdir, kill_after):
    """A checkpointed segmented fit on a ``(world, 1)`` mesh that dies (rank
    0 raises in its hook) after ``kill_after`` steps are committed."""
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import Checkpointer

    cfg = PCAConfig(**kw)
    mesh = pmesh.make_mesh(device=CPU)
    fit = make_segmented_fit(cfg, segment=segment, mesh=mesh, device=CPU, v0=v0)
    ck = Checkpointer(ckdir, rows_per_step=cfg.num_workers * cfg.rows_per_worker,
                      device=CPU)

    def on_segment(t, st):
        ck.on_step(t, st)
        if t >= kill_after:
            raise Killed(f"killed after step {t}")

    fit(SegmentState.initial(cfg.dim, cfg.k, device=CPU), xs, on_segment=on_segment)
    raise AssertionError("the run was not killed")


def segmented_resumed(rank, world, kw, xs, v0, segment, ckdir, masks):
    """On a fresh ``(world, 1)`` mesh: every rank restores the newest
    checkpoint and finishes the fit; beside it the unkilled fit, the same
    fit with a mask window sequence, and the scan of the same steps."""
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import Checkpointer

    cfg = PCAConfig(**kw)
    mesh = pmesh.make_mesh(device=CPU)
    fit = make_segmented_fit(cfg, segment=segment, mesh=mesh, device=CPU, v0=v0)
    restored, cursor = Checkpointer(ckdir, device=CPU).latest()
    done = cursor // (cfg.num_workers * cfg.rows_per_worker)
    seen = []
    resumed = fit(restored, xs[done:], on_segment=lambda t, st: seen.append(t))
    unkilled = fit(SegmentState.initial(cfg.dim, cfg.k, device=CPU), xs)
    windows = (xs[t:t + segment] for t in range(0, len(xs), segment))
    mwins = (masks[t:t + segment] for t in range(0, len(masks), segment))
    masked = fit.fit_windows(SegmentState.initial(cfg.dim, cfg.k, device=CPU), windows,
                             worker_masks=mwins)
    scan_st, _ = make_scan_fit(cfg, mesh=mesh, device=CPU, v0=v0)(_state0(cfg), xs)
    masked_scan, _ = make_scan_fit(cfg, mesh=mesh, device=CPU, v0=v0, masked=True)(
        _state0(cfg), xs, masks)

    def seg(s):
        return dict(sigma=_np(s.sigma_tilde), step=int(s.step), v_prev=_np(s.v_prev))

    return dict(done=done, restored=seg(restored), resumed=seg(resumed),
                unkilled=seg(unkilled), masked=seg(masked), seen=seen,
                scan=_np(scan_st.sigma_tilde), masked_scan=_np(masked_scan.sigma_tilde))


# -- the estimator ---------------------------------------------------------------


def estimator_fits(rank, world, kw, data, v0, ckdir):
    """``OnlineDistributedPCA`` under ``backend="shard_map"``: the whole-fit
    scan, the checkpointed segmented fit, ``fit_stream`` then
    ``partial_fit`` (the per-step loop), and the local estimator's scan
    beside them in this rank."""
    from distributed_eigenspaces_tpu_torch.api.estimator import (
        OnlineDistributedPCA,
        _scan_mesh,
    )

    cfg = PCAConfig(**kw, backend="shard_map")
    mesh = _scan_mesh(cfg, CPU)
    out = {"mesh": None if mesh is None else mesh.shape}
    g0 = pmesh.gathers
    est = OnlineDistributedPCA(cfg, device=CPU, v0=v0).fit(data)
    out["scan"] = (est.trainer_used_, _np(est.components_), _np(est.state.sigma_tilde))
    out["scan_gathers"] = pmesh.gathers - g0
    seg = OnlineDistributedPCA(cfg, device=CPU, v0=v0, checkpoint_dir=ckdir,
                               segment=2).fit(data)
    out["segmented"] = (seg.trainer_used_, _np(seg.components_),
                        _np(seg.state.sigma_tilde))
    steps = []
    stream = OnlineDistributedPCA(cfg, device=CPU, v0=v0, trainer="step")
    stream.fit(data, on_step=lambda t, st, v: steps.append(int(t)))
    out["step"] = (stream.trainer_used_, _np(stream.components_),
                   _np(stream.state.sigma_tilde), steps)
    m, n = cfg.num_workers, cfg.rows_per_worker
    stream.partial_fit(np.asarray(data[: m * n]).reshape(m, n, cfg.dim))
    out["partial"] = (int(stream.state.step), _np(stream.state.sigma_tilde))
    local = OnlineDistributedPCA(PCAConfig(**kw, backend="local"), device=CPU,
                                 v0=v0).fit(data)
    out["local"] = (_np(local.components_), _np(local.state.sigma_tilde))
    return out


# -- the solvers -------------------------------------------------------------------


def dist_solvers(rank, world, shape, vs, mask, v_init, u, s, v_init_u, vsign, k,
                 iters, tol):
    """On a ``shape`` = ``(W, F)`` mesh: ``dist_merged_top_k`` (masked, all
    ones, and with ``tol``), ``dist_subspace_eig`` and ``dist_extract_top_k``
    on the low-rank operator of ``u``, ``dist_canonicalize_signs``; each
    this rank's ``(d_local, k)`` rows, with its coordinates."""
    from distributed_eigenspaces_tpu_torch.solvers import distributed as sd

    mesh = pmesh.make_mesh(*shape, device=CPU)
    rw = pmesh.worker_rows(mesh, vs.shape[0])
    rf = pmesh.feature_rows(mesh, vs.shape[1])
    t = torch.from_numpy
    with pmesh.mesh_scope(mesh):
        local = t(vs[rw, rf])
        v_init, v_init_u = v_init[rf], v_init_u[rf]  # each rank's rows of the starts
        out = dict(coords=(mesh.axis_index(pmesh.WORKER_AXIS),
                           mesh.axis_index(pmesh.FEATURE_AXIS)))
        out["masked"] = _np(sd.dist_merged_top_k(local, k, mask=t(mask[rw]), iters=iters,
                                                 v_init=v_init))
        out["ones"] = _np(sd.dist_merged_top_k(local, k, iters=iters, v_init=v_init))
        out["dead"] = _np(sd.dist_merged_top_k(local, k, mask=torch.zeros(len(mask[rw])),
                                               iters=iters, v_init=v_init))
        out["tol"] = _np(sd.dist_merged_top_k(local, k, mask=t(mask[rw]), iters=iters,
                                              v_init=v_init, tol=tol))
        ur = t(u[rf])
        sub, info = sd.dist_subspace_eig(
            sd.lowrank_matvec(ur, t(s), pmesh.FEATURE_AXIS), ur.shape[0], k,
            iters=iters, v_init=v_init_u, device=CPU, axis_name=pmesh.FEATURE_AXIS,
            oversample=2, tol=tol, with_info=True)
        out["subspace"], out["subspace_info"] = _np(sub), info
        out["extract"] = _np(sd.dist_extract_top_k(
            ur, t(s), k, iters=iters, v_init=v_init_u, axis_name=pmesh.FEATURE_AXIS,
            oversample=2))
        out["signs"] = _np(sd.dist_canonicalize_signs(t(vsign[rf]), pmesh.FEATURE_AXIS))
    return out


def deflation_lanes(rank, world, comp_shapes, work_shape, u, s, lane_inits, batched_init,
                    vs, mask, merge_init, parent, grow_init, k, iters, tol):
    """``dist_deflation_eig`` on each ``(L, F)`` components mesh (``tol`` and
    a fixed count), then on a ``work_shape`` workers mesh the batched lanes
    with rows over ``features`` (``deflation_eig(axis_name=)``), the mesh
    deflation merge and ``grow_directions(axis_name=)``; each this rank's
    rows with its coordinates."""
    from distributed_eigenspaces_tpu_torch.solvers import deflation as sdf
    from distributed_eigenspaces_tpu_torch.solvers import distributed as sd

    t = torch.from_numpy
    out = {}
    for (lanes, f), init in zip(comp_shapes, lane_inits):
        cm = pmesh.make_component_mesh(lanes, f, device=CPU)
        rf = pmesh.feature_rows(cm, u.shape[0])
        init = init[rf]  # this rank's rows of the start
        with pmesh.mesh_scope(cm):
            mv = sd.lowrank_matvec(t(u[rf]), t(s), pmesh.FEATURE_AXIS)
            got, info = sdf.dist_deflation_eig(
                mv, rf.stop - rf.start, k, lanes=lanes, iters=iters, tol=tol,
                v_init=init, device=CPU, with_info=True)
            fixed = sdf.dist_deflation_eig(mv, rf.stop - rf.start, k, lanes=lanes,
                                           iters=40, v_init=init, device=CPU)
            lane_iters = _gather_of(info["iters_used"], pmesh.COMPONENT_AXIS)
        out[(lanes, f)] = dict(
            coords=(cm.axis_index(pmesh.COMPONENT_AXIS), cm.axis_index(pmesh.FEATURE_AXIS)),
            v=_np(got), fixed=_np(fixed), iters_used=lane_iters)
    mesh = pmesh.make_mesh(*work_shape, device=CPU)
    rw = pmesh.worker_rows(mesh, vs.shape[0])
    rf = pmesh.feature_rows(mesh, u.shape[0])
    batched_init, merge_init, grow_init = batched_init[rf], merge_init[rf], grow_init[rf]
    with pmesh.mesh_scope(mesh):
        mv = sd.lowrank_matvec(t(u[rf]), t(s), pmesh.FEATURE_AXIS)
        batched, info = sdf.deflation_eig(
            mv, rf.stop - rf.start, k, lanes=comp_shapes[0][0], iters=iters, tol=tol,
            v_init=batched_init, device=CPU, axis_name=pmesh.FEATURE_AXIS,
            with_info=True)
        merged = sdf.dist_merged_top_k_deflation(
            t(vs[rw, rf]), k, lanes=comp_shapes[0][0], mask=t(mask[rw]), iters=24,
            v_init=merge_init)
        grown = sdf.grow_directions(mv, t(parent[rf]), k // 2, iters=iters,
                                    v_init=grow_init, axis_name=pmesh.FEATURE_AXIS)
    out["work"] = dict(
        coords=(mesh.axis_index(pmesh.WORKER_AXIS), mesh.axis_index(pmesh.FEATURE_AXIS)),
        batched=_np(batched), batched_iters=info["iters_used"], merged=_np(merged),
        grown=_np(grown))
    return out
