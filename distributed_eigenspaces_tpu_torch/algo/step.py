"""One online round plus the state update, on one device.

Counterpart of ``distributed_eigenspaces_tpu/algo/step.py`` with
``mesh=None``: the per-worker solves, the merge (exact low-rank, or above
the crossover the distributed factor-operator solve) and the fold into
``sigma_tilde``. PyTorch runs eagerly, so the reference's jitted cold and
warm executables are two plain functions here. Worker solves and the merge
run under the profiler regions the reference's traces name
(``det_worker_solve`` / ``det_merge`` / ``det_dist_merge``).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from distributed_eigenspaces_tpu_torch.algo.online import (
    OnlineState,
    update_state,
)
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.device import resolve_device
from distributed_eigenspaces_tpu_torch.ops.linalg import (
    initial_basis,
    merged_top_k_lowrank,
)
from distributed_eigenspaces_tpu_torch.parallel.worker_pool import (
    _local_eigenspaces,
    _masked_projector_mean,
)
from distributed_eigenspaces_tpu_torch.solvers.distributed import (
    _default_oversample,
    merged_top_k_distributed,
)


def make_solve_core(
    cfg: PCAConfig, iters: int | None = None, orth: str | None = None
):
    """``solve_core(x_blocks, v0) -> vs (m, d, k)``: the per-worker local
    eigenspaces of one round, without the merge."""
    k, solver = cfg.k, cfg.resolved_local_solver()
    iters = cfg.subspace_iters if iters is None else iters
    orth = cfg.orth_method if orth is None else orth

    def solve_core(x_blocks, v0=None):
        with record_function("det_worker_solve"):
            return _local_eigenspaces(
                x_blocks, k, solver, iters, orth, cfg.compute_dtype, v0
            )

    return solve_core


def merge_core(vs: torch.Tensor, k: int, mask=None, dist_iters=None,
               dist_tol=None, v_init=None) -> torch.Tensor:
    """Masked top-k of the mean of the workers' projectors (the flat
    merge); an all-masked round merges to zeros. ``dist_iters`` (set when
    ``cfg.uses_distributed_solve()``) runs the distributed subspace solve
    of the factor operator from the start ``v_init (d, k')`` instead of
    the exact low-rank route, stopping early at ``dist_tol``."""
    if dist_iters is not None:
        with record_function("det_dist_merge"):
            return merged_top_k_distributed(
                vs, k, mask=mask, iters=dist_iters, tol=dist_tol, v_init=v_init,
            )
    with record_function("det_merge"):
        return merged_top_k_lowrank(vs, k, mask=mask)


def merge_start(cfg: PCAConfig, *, device, v_init=None):
    """The ``(d, k')`` start of the crossover merge (``k' = k`` plus the
    default oversample of the ``m k``-wide factor operator), or None below
    the crossover: ``v_init`` when given, else drawn from ``cfg.seed``
    (the reference draws it from ``jax.random.PRNGKey(0)`` every round)."""
    if not cfg.uses_distributed_solve():
        return None
    kk = cfg.k + _default_oversample(cfg.k, cfg.num_workers * cfg.k)
    return initial_basis(cfg.dim, kk, seed=cfg.seed, device=device, v0=v_init)


def mean_projector(vs: torch.Tensor, mask=None) -> torch.Tensor:
    """Masked mean ``(1/sum w) sum_l w_l V_l V_l^T`` of the workers'
    projectors (zeros when every worker is masked)."""
    if mask is None:
        mask = torch.ones((vs.shape[0],), dtype=torch.float32, device=vs.device)
    psum, cnt = _masked_projector_mean(vs, mask)
    return psum / torch.clamp(cnt, min=1.0)


def make_round_core(
    cfg: PCAConfig, iters: int | None = None, orth: str | None = None,
    v_init=None,
):
    """``round_core(x_blocks, v0, mask=None) -> v_bar (d, k)``: solves then
    merge, the one definition of a round shared by the per-step and the
    whole-fit trainers. Above the crossover the merge runs
    ``cfg.subspace_iters`` iterations, cold or warm (as the reference's),
    from ``v_init`` (see :func:`merge_start`)."""
    solve_core = make_solve_core(cfg, iters=iters, orth=orth)
    k = cfg.k
    dist_iters = cfg.subspace_iters if cfg.uses_distributed_solve() else None
    dist_tol = cfg.solver_tol if dist_iters is not None else None

    def round_core(x_blocks, v0=None, mask=None):
        return merge_core(
            solve_core(x_blocks, v0), k, mask=mask, dist_iters=dist_iters,
            dist_tol=dist_tol, v_init=v_init,
        )

    return round_core


def make_warm_core(cfg: PCAConfig, v_init=None):
    """The warm-round core (short iteration count, warm orthonormalization),
    or None when warm starts are off."""
    warm_iters = cfg.resolved_warm_start()
    if warm_iters is None:
        return None
    return make_round_core(
        cfg, iters=warm_iters, orth=cfg.resolved_warm_orth(), v_init=v_init
    )


def make_train_step(cfg: PCAConfig, *, device="cuda", v0=None, v_init=None):
    """Build ``step(state, x_blocks, v_prev=None) -> (state, v_bar)``.

    Without ``v_prev`` (or without warm starts in ``cfg``) the step runs the
    cold core at ``cfg.subspace_iters`` from the cold start ``v0 (d, k)``
    (default: :func:`~..ops.linalg.initial_basis` from ``cfg.seed``). With
    ``v_prev``, the previous round's merged basis, it runs the warm core.
    Above the crossover every merge starts from ``v_init (d, k')`` (default:
    :func:`merge_start` from ``cfg.seed``).
    """
    dev = resolve_device(device)
    v_merge = merge_start(cfg, device=dev, v_init=v_init)
    round_core = make_round_core(cfg, v_init=v_merge)
    warm_core = make_warm_core(cfg, v_init=v_merge)
    v_cold = initial_basis(cfg.dim, cfg.k, seed=cfg.seed, device=dev, v0=v0)

    def fold(state, v_bar):
        return (
            update_state(
                state, v_bar, discount=cfg.discount, num_steps=cfg.num_steps
            ),
            v_bar,
        )

    def step(state: OnlineState, x_blocks, v_prev=None):
        x = torch.as_tensor(x_blocks).to(dev)
        if warm_core is not None and v_prev is not None:
            return fold(state, warm_core(x, v0=v_prev))
        return fold(state, round_core(x, v0=v_cold))

    return step
