"""Online distributed PCA: the outer time loop over a worker pool.

Counterpart of ``distributed_eigenspaces_tpu/algo/online.py``:

    sigma_tilde(0) = 0
    for t = 1..T:
        per worker l: V_hat_l = top-k eigvecs of (1/n) X_l^T X_l
        v_bar = top-k eigvecs of (1/m) sum_l V_hat_l V_hat_l^T
        sigma_tilde += discount * v_bar v_bar^T
    output: top-k eigvecs of sigma_tilde
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype
from distributed_eigenspaces_tpu_torch.ops.linalg import (
    initial_basis,
    projector,
    top_k_eigvecs,
)
from distributed_eigenspaces_tpu_torch.parallel.worker_pool import WorkerPool


class OnlineState(NamedTuple):
    """``sigma_tilde (d, d)``, the running projector average, and ``step``,
    the 1-based count of rounds folded in (a host int)."""

    sigma_tilde: torch.Tensor
    step: int

    @classmethod
    def initial(cls, dim: int, dtype="float32", *, device="cuda") -> "OnlineState":
        dev = resolve_device(device)
        return cls(
            sigma_tilde=torch.zeros(
                (dim, dim), dtype=torch_dtype(dtype), device=dev
            ),
            step=0,
        )


def _discount(rule: str, step: int, num_steps: int) -> np.float32:
    """Per-step weight of the new projector (``step`` is 1-based), computed
    in float32 as the reference computes it."""
    if rule == "1/T":
        return np.float32(1.0 / num_steps)
    if rule == "1/t":
        return np.float32(1.0) / np.float32(step)
    if rule == "notebook":
        # bug-compatible 1/(t+1) additive weight (notebook cell 16)
        return np.float32(1.0) / (np.float32(step) + np.float32(1.0))
    raise ValueError(rule)


def update_state_projector(
    state: OnlineState, p: torch.Tensor, *, discount: str, num_steps: int
) -> OnlineState:
    """Fold one ``(d, d)`` projector-like matrix into the running average.
    The arithmetic is fp32 whatever the state dtype, then cast back."""
    step = state.step + 1
    w = _discount(discount, step, num_steps)
    sigma = state.sigma_tilde.float()
    p = p.to(state.sigma_tilde.dtype).float()
    if discount == "1/t":
        sigma = sigma * float(np.float32(1.0) - w) + p * float(w)
    else:
        sigma = sigma + p * float(w)
    return OnlineState(sigma.to(state.sigma_tilde.dtype), step)


def update_state(
    state: OnlineState, v_bar: torch.Tensor, *, discount: str, num_steps: int
) -> OnlineState:
    """Fold one merged eigenspace into the running average."""
    return update_state_projector(
        state, projector(v_bar), discount=discount, num_steps=num_steps
    )


def online_distributed_pca(
    stream: Iterable,
    cfg: PCAConfig,
    *,
    device="cuda",
    state: OnlineState | None = None,
    on_step: Callable[[int, OnlineState, torch.Tensor], None] | None = None,
    worker_masks=None,
    max_steps: int | None | str = "auto",
    v0: torch.Tensor | None = None,
):
    """Run the online algorithm over a stream of ``(m, n, d)`` blocks on the
    per-step loop; returns ``(w (d, k), state)``.

    ``max_steps``: ``"auto"`` caps the total step count at
    ``cfg.num_steps`` (open-ended under ``discount="1/t"``), ``None``
    consumes the whole stream, an int is an explicit cap. ``v0`` is the
    cold start basis (default: :func:`initial_basis` from ``cfg.seed``);
    after the first live round each step warm-starts from the previous
    merged basis with ``cfg.resolved_warm_start()`` iterations.
    """
    dev = resolve_device(device)
    if worker_masks is not None:
        worker_masks = iter(worker_masks)
    pool = WorkerPool(
        cfg.num_workers,
        backend="local",
        solver=cfg.resolved_local_solver(),
        subspace_iters=cfg.subspace_iters,
        orth_method=cfg.orth_method,
        compute_dtype=cfg.compute_dtype,
        device=dev,
        seed=cfg.seed,
    )
    if state is None:
        state = OnlineState.initial(cfg.dim, cfg.state_dtype, device=dev)
    v_cold = initial_basis(cfg.dim, cfg.k, seed=cfg.seed, device=dev, v0=v0)
    warm_iters = cfg.resolved_warm_start()
    v_prev = None
    cap = cfg.num_steps if max_steps == "auto" else max_steps
    open_ended = max_steps == "auto" and cfg.discount == "1/t"
    for x_blocks in stream:
        if cap is not None and state.step >= cap and not open_ended:
            break
        mask = next(worker_masks) if worker_masks is not None else None
        _, v_bar = pool.round(
            x_blocks, cfg.k, worker_mask=mask,
            v0=v_cold if v_prev is None else v_prev,
            iters=warm_iters if v_prev is not None else None,
            orth=cfg.resolved_warm_orth() if v_prev is not None else None,
        )
        # an all-masked round merges to zeros, a fixed point of the
        # solver: the warm carry keeps the last live basis
        if warm_iters is not None and (
            mask is None or bool(np.any(np.asarray(mask)))
        ):
            v_prev = v_bar
        state = update_state(
            state, v_bar, discount=cfg.discount, num_steps=cfg.num_steps
        )
        if on_step is not None:
            on_step(state.step, state, v_bar)
    w = top_k_eigvecs(state.sigma_tilde, cfg.k)
    return w, state
