"""One online round plus the state update, on one device.

Counterpart of ``distributed_eigenspaces_tpu/algo/step.py`` with
``mesh=None``: the per-worker solves, the exact low-rank merge and the
fold into ``sigma_tilde``. PyTorch runs eagerly, so the reference's jitted
cold and warm executables are two plain functions here. Worker solves and
the merge run under the profiler regions the reference's traces name
(``det_worker_solve`` / ``det_merge``).
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


def merge_core(vs: torch.Tensor, k: int, mask=None) -> torch.Tensor:
    """Exact masked top-k of the mean of the workers' projectors (the flat
    merge); an all-masked round merges to zeros."""
    with record_function("det_merge"):
        return merged_top_k_lowrank(vs, k, mask=mask)


def mean_projector(vs: torch.Tensor, mask=None) -> torch.Tensor:
    """Masked mean ``(1/sum w) sum_l w_l V_l V_l^T`` of the workers'
    projectors (zeros when every worker is masked)."""
    if mask is None:
        mask = torch.ones((vs.shape[0],), dtype=torch.float32, device=vs.device)
    psum, cnt = _masked_projector_mean(vs, mask)
    return psum / torch.clamp(cnt, min=1.0)


def make_round_core(
    cfg: PCAConfig, iters: int | None = None, orth: str | None = None
):
    """``round_core(x_blocks, v0, mask=None) -> v_bar (d, k)``: solves then
    merge, the one definition of a round shared by the per-step and the
    whole-fit trainers."""
    solve_core = make_solve_core(cfg, iters=iters, orth=orth)
    k = cfg.k

    def round_core(x_blocks, v0=None, mask=None):
        return merge_core(solve_core(x_blocks, v0), k, mask=mask)

    return round_core


def make_warm_core(cfg: PCAConfig):
    """The warm-round core (short iteration count, warm orthonormalization),
    or None when warm starts are off."""
    warm_iters = cfg.resolved_warm_start()
    if warm_iters is None:
        return None
    return make_round_core(cfg, iters=warm_iters, orth=cfg.resolved_warm_orth())


def make_train_step(cfg: PCAConfig, *, device="cuda", v0=None):
    """Build ``step(state, x_blocks, v_prev=None) -> (state, v_bar)``.

    Without ``v_prev`` (or without warm starts in ``cfg``) the step runs the
    cold core at ``cfg.subspace_iters`` from the cold start ``v0 (d, k)``
    (default: :func:`~..ops.linalg.initial_basis` from ``cfg.seed``). With
    ``v_prev``, the previous round's merged basis, it runs the warm core.
    """
    dev = resolve_device(device)
    round_core = make_round_core(cfg)
    warm_core = make_warm_core(cfg)
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
