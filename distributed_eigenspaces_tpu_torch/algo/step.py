"""One online round plus the state update, on one device or a mesh.

Counterpart of ``distributed_eigenspaces_tpu/algo/step.py``: the
per-worker solves, the merge (exact low-rank, or above the crossover the
distributed factor-operator solve or its parallel-deflation lanes) and the
fold into ``sigma_tilde``. PyTorch runs eagerly, so the reference's jitted
cold and warm executables are two plain functions here. With a ``(workers,
features)`` mesh (``parallel/mesh.py``) each rank solves its ``m / W``
workers and all-gathers the ``(m, d, k)`` factors over ``workers``; the
merge and the fold then run on every rank on the same bits, so the state
is replicated. With ``cfg.merge_topology`` the merge is the stacked tree
of ``parallel/topology.py`` (the tier-local route on a tiered mesh is
``algo.scan.make_scan_fit``'s). Worker solves, the gather and the merge run
under the profiler regions the reference's traces name
(``det_worker_solve`` / ``det_factor_gather`` / ``det_merge`` /
``det_dist_merge`` / ``det_deflation_merge`` / ``det_tree_merge``).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from distributed_eigenspaces_tpu_torch.algo.online import (
    OnlineState,
    update_state,
    update_state_projector,
)
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import (
    initial_basis,
    merged_top_k_lowrank,
    start_rows,
)
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel.topology import (
    resolve_topology,
    tree_merge_stacked,
)
from distributed_eigenspaces_tpu_torch.parallel.worker_pool import (
    _local_eigenspaces,
    _masked_projector_mean,
)
from distributed_eigenspaces_tpu_torch.solvers.deflation import merged_top_k_deflation
from distributed_eigenspaces_tpu_torch.solvers.distributed import (
    _default_oversample,
    merged_top_k_distributed,
)
from distributed_eigenspaces_tpu_torch.utils.guards import checked


def make_solve_core(
    cfg: PCAConfig, iters: int | None = None, orth: str | None = None,
    mesh: pmesh.Mesh | None = None,
):
    """``solve_core(x_blocks, v0) -> vs (m, d, k)``: the per-worker local
    eigenspaces of one round, without the merge. With ``mesh``,
    ``x_blocks`` is this rank's ``(m / W, n, d)`` and the factors are
    all-gathered over ``workers`` (in worker order) into the whole stack."""
    k, solver = cfg.k, cfg.resolved_local_solver()
    iters = cfg.subspace_iters if iters is None else iters
    orth = cfg.orth_method if orth is None else orth

    def solve_core(x_blocks, v0=None):
        with record_function("det_worker_solve"):
            vs = _local_eigenspaces(
                x_blocks, k, solver, iters, orth, cfg.compute_dtype, v0
            )
        if mesh is None:
            return vs
        # the reference's whole wire protocol: one gather of m d x k
        # factors, never a d x d psum
        with record_function("det_factor_gather"), pmesh.mesh_scope(mesh):
            return pmesh.all_gather(vs, pmesh.WORKER_AXIS)

    return solve_core


def make_warm_solve_core(cfg: PCAConfig, mesh: pmesh.Mesh | None = None):
    """The warm-round solves (short iteration count, warm
    orthonormalization) without the merge, or None when warm starts are
    off: the solve-only twin of :func:`make_warm_core`."""
    warm_iters = cfg.resolved_warm_start()
    if warm_iters is None:
        return None
    return make_solve_core(cfg, iters=warm_iters, orth=cfg.resolved_warm_orth(),
                           mesh=mesh)


def merge_knobs(cfg: PCAConfig) -> dict:
    """The merge arguments of :func:`merge_core` for ``cfg``, resolved once
    where a trainer is built: ``topology`` (``cfg.merge_topology``
    resolved, or None for the flat merge); ``dist_iters`` and ``dist_tol``
    set when ``cfg.uses_distributed_solve()``, ``deflate_lanes``
    (``cfg.components_axis_size``) when also ``cfg.uses_deflation_solve()``;
    None below the crossover (the exact low-rank merge)."""
    dist_iters = cfg.subspace_iters if cfg.uses_distributed_solve() else None
    lanes = (cfg.components_axis_size
             if dist_iters is not None and cfg.uses_deflation_solve() else None)
    return {"dist_iters": dist_iters, "deflate_lanes": lanes,
            "dist_tol": cfg.solver_tol if dist_iters is not None else None,
            "topology": resolve_topology(cfg)}


def merge_core(vs: torch.Tensor, k: int, mask=None, dist_iters=None,
               dist_tol=None, v_init=None, deflate_lanes=None,
               topology=None) -> torch.Tensor:
    """Masked top-k of the mean of the workers' projectors (the flat
    merge); an all-masked round merges to zeros. ``topology`` (a resolved
    ``parallel.topology.MergeTopology``) runs the stacked tree instead
    (``tree_merge_stacked``: exact merges a group, weighted by live
    counts), with the distributed solve at the root tier only when
    ``dist_iters`` is set; None is the flat merge. ``dist_iters`` (set when
    ``cfg.uses_distributed_solve()``) runs the distributed subspace solve
    of the factor operator from the start ``v_init (d, k')`` instead of
    the exact low-rank route, stopping early at ``dist_tol``;
    ``deflate_lanes`` runs that solve as parallel-deflation lanes from
    ``v_init (d, k)``."""
    if topology is not None:
        with record_function("det_tree_merge"):
            return tree_merge_stacked(vs, k, topology, mask=mask,
                                      root_dist_iters=dist_iters, root_v_init=v_init)
    if dist_iters is not None and deflate_lanes is not None:
        with record_function("det_deflation_merge"):
            return merged_top_k_deflation(
                vs, k, lanes=deflate_lanes, mask=mask, iters=dist_iters,
                tol=dist_tol, v_init=v_init,
            )
    if dist_iters is not None:
        with record_function("det_dist_merge"):
            return merged_top_k_distributed(
                vs, k, mask=mask, iters=dist_iters, tol=dist_tol, v_init=v_init,
            )
    with record_function("det_merge"):
        return merged_top_k_lowrank(vs, k, mask=mask)


def merge_start(cfg: PCAConfig, *, device, v_init=None, rows: slice | None = None):
    """Rows ``rows`` (default: all ``d``) of the ``(d, k')`` start of the
    crossover merge (``k' = k`` plus the default oversample of the ``m
    k``-wide factor operator; the deflation lanes take no oversample, ``k'
    = k``; under a merge topology the root tier's ``f k``-wide operator,
    which the distributed solve takes in either case), or None below the
    crossover: those rows of ``v_init (d, k')`` when given, else drawn
    from ``cfg.seed`` by ``ops.linalg.start_rows`` (the reference draws it
    from ``jax.random.PRNGKey(0)`` every round, each row shard from its own
    key). A feature-sharded rank asks for its rows and draws those only."""
    if not cfg.uses_distributed_solve():
        return None
    kk = cfg.k
    topo = resolve_topology(cfg)
    if topo is not None:
        kk += _default_oversample(cfg.k, topo.fan_ins[-1] * cfg.k)
    elif not cfg.uses_deflation_solve():
        kk += _default_oversample(cfg.k, cfg.num_workers * cfg.k)
    rows = slice(0, cfg.dim) if rows is None else rows
    if v_init is None:
        return start_rows(rows.start, rows.stop, kk, seed=cfg.seed, device=device)
    v = torch.as_tensor(v_init, dtype=torch.float32)
    if tuple(v.shape) != (cfg.dim, kk):
        raise ValueError(f"v_init must be ({cfg.dim}, {kk}), got {tuple(v.shape)}")
    return v[rows].contiguous().to(device)


def mean_projector(vs: torch.Tensor, mask=None) -> torch.Tensor:
    """Masked mean ``(1/sum w) sum_l w_l V_l V_l^T`` of the workers'
    projectors (zeros when every worker is masked)."""
    if mask is None:
        mask = torch.ones((vs.shape[0],), dtype=torch.float32, device=vs.device)
    with record_function("det_mean_projector"):
        psum, cnt = _masked_projector_mean(vs, mask)
        return psum / torch.clamp(cnt, min=1.0)


def make_round_core(
    cfg: PCAConfig, iters: int | None = None, orth: str | None = None,
    v_init=None, mesh: pmesh.Mesh | None = None,
):
    """``round_core(x_blocks, v0, mask=None) -> v_bar (d, k)``: solves then
    merge, one round of the train step (the whole-fit trainers fold their
    solves through ``algo/scan.py``'s merge-or-fold instead). Above the crossover the merge runs
    ``cfg.subspace_iters`` iterations, cold or warm (as the reference's),
    from ``v_init`` (see :func:`merge_start`)."""
    solve_core = make_solve_core(cfg, iters=iters, orth=orth, mesh=mesh)
    k = cfg.k
    knobs = merge_knobs(cfg)

    def round_core(x_blocks, v0=None, mask=None):
        return merge_core(solve_core(x_blocks, v0), k, mask=mask,
                          v_init=v_init, **knobs)

    return round_core


def make_warm_core(cfg: PCAConfig, v_init=None, mesh: pmesh.Mesh | None = None):
    """The warm-round core (short iteration count, warm orthonormalization),
    or None when warm starts are off."""
    warm_iters = cfg.resolved_warm_start()
    if warm_iters is None:
        return None
    return make_round_core(
        cfg, iters=warm_iters, orth=cfg.resolved_warm_orth(), v_init=v_init,
        mesh=mesh,
    )


def make_train_step(cfg: PCAConfig, *, mesh: pmesh.Mesh | None = None,
                    device="cuda", v0=None, v_init=None):
    """Build ``step(state, x_blocks, v_prev=None, merge=True) ->
    (state, v_bar)``.

    Without ``v_prev`` (or without warm starts in ``cfg``) the step runs the
    cold core at ``cfg.subspace_iters`` from the cold start ``v0 (d, k)``
    (default: :func:`~..ops.linalg.initial_basis` from ``cfg.seed``). With
    ``v_prev``, the previous round's merged basis, it runs the warm core.
    Above the crossover every merge starts from ``v_init (d, k')`` (default:
    :func:`merge_start` from ``cfg.seed``).

    With ``cfg.merge_interval > 1``, ``merge=False`` is the fold-only step
    of the rounds between merges: the same solves, then the mean of the
    worker projectors folded at the step's weight, and no merged
    eigensolve at all; it returns ``(state, v_prev)`` (a fold round makes
    no merged basis). Callers schedule the phase with
    :func:`~.online.merge_phase` on ``state.step``, as the reference's
    callers pass ``merge=``, and advance their warm carry with
    :func:`~.online.carry_after`.

    With a ``(workers, features)`` ``mesh`` the step runs on every rank of
    it, on the mesh's device (``device`` is not used): ``x_blocks`` is the
    whole ``(m, n, d)`` block, of which each rank solves its ``m / W``
    workers, or already that rank's share; the factors are all-gathered
    over ``workers`` and the returned state and basis are the same on every
    rank (a one-rank mesh's gather is a copy, so its step is the local
    step bit for bit).

    Under ``DET_CHECKIFY=1`` (read here, when the step is built) every
    branch runs inside ``utils.guards.checked``: a non-finite input or
    output raises ``CheckError``, on every rank of ``mesh`` alike.
    """
    dev = pmesh.mesh_device(mesh, device)
    v_merge = merge_start(cfg, device=dev, v_init=v_init)
    round_core = make_round_core(cfg, v_init=v_merge, mesh=mesh)
    warm_core = make_warm_core(cfg, v_init=v_merge, mesh=mesh)
    v_cold = initial_basis(cfg.dim, cfg.k, seed=cfg.seed, device=dev, v0=v0)
    s_int = cfg.merge_interval
    solve_cold = make_solve_core(cfg, mesh=mesh) if s_int > 1 else None
    solve_warm = make_warm_solve_core(cfg, mesh=mesh) if s_int > 1 else None

    def fold(state, v_bar):
        return (
            update_state(
                state, v_bar, discount=cfg.discount, num_steps=cfg.num_steps
            ),
            v_bar,
        )

    def fold_p(state, p):
        return update_state_projector(
            state, p, discount=cfg.discount, num_steps=cfg.num_steps
        )

    def step(state: OnlineState, x_blocks, v_prev=None, merge=True):
        x = pmesh.place_workers(mesh, x_blocks, cfg.num_workers, dev)
        if not merge:
            if s_int == 1:
                raise ValueError(
                    "step(merge=False) needs cfg.merge_interval > 1 "
                    "(the fold-only steps are built from the interval "
                    "config)"
                )
            if solve_warm is not None and v_prev is not None:
                return fold_p(state, mean_projector(solve_warm(x, v_prev))), v_prev
            return fold_p(state, mean_projector(solve_cold(x, v_cold))), v_prev
        if warm_core is not None and v_prev is not None:
            return fold(state, warm_core(x, v0=v_prev))
        return fold(state, round_core(x, v0=v_cold))

    return checked(step, mesh=mesh)
