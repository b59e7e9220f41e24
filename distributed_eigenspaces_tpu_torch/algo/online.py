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
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel.worker_pool import WorkerPool
from distributed_eigenspaces_tpu_torch.runtime.prefetch import device_placer
from distributed_eigenspaces_tpu_torch.utils.guards import checked
from distributed_eigenspaces_tpu_torch.utils.tracing import annotate_step


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
    sigma = fold_projector(state.sigma_tilde, p, float(w),
                           float(np.float32(1.0) - w), discount=discount)
    return OnlineState(sigma, step)


def fold_projector(sigma: torch.Tensor, p: torch.Tensor, w, one_minus_w, *,
                   discount: str) -> torch.Tensor:
    """The fold's arithmetic: ``sigma (..., d, d)`` and ``p`` in fp32
    whatever the state dtype, at weight ``w`` and ``one_minus_w`` (floats,
    or float32 tensors that broadcast against ``sigma``: a fleet's
    ``(B, 1, 1)``, one weight a tenant), cast back to ``sigma``'s dtype."""
    dtype = sigma.dtype
    s = sigma.float()
    p = p.to(dtype).float()
    if discount == "1/t":
        s = s * one_minus_w + p * w
    else:
        s = s + p * w
    return s.to(dtype)


def discount_schedule(rule: str, actives, num_steps: int):
    """The fold weights of B tenants over a ``(B, T)`` {0, 1} schedule of
    active steps: ``(w, one_minus_w)``, two ``(T, B)`` float32 arrays, each
    entry :func:`_discount` of the tenant's own 1-based step count at that
    step (the count of its active steps so far, this one included) and
    ``np.float32(1) - w``, so every tenant's fold rounds where its solo fold
    rounds (:func:`fold_projector` takes them). An inactive step's entry is
    the weight its next fold would take; the fleet discards that step's
    fold."""
    actives = np.asarray(actives) != 0
    steps = np.cumsum(actives, axis=1) + ~actives  # (B, T), >= 1
    w = np.array([[_discount(rule, int(s), num_steps) for s in row]
                  for row in steps], np.float32).T
    return w, np.float32(1.0) - w


def update_state(
    state: OnlineState, v_bar: torch.Tensor, *, discount: str, num_steps: int
) -> OnlineState:
    """Fold one merged eigenspace into the running average."""
    return update_state_projector(
        state, projector(v_bar), discount=discount, num_steps=num_steps
    )


def merge_phase(cfg: PCAConfig, step: int) -> bool:
    """The merge-interval schedule of every trainer: whether the round
    after ``step`` folded rounds runs the merged eigensolve. Under
    ``cfg.merge_interval = s`` the 1-based steps 1, s+1, 2s+1, ... merge
    (``step % s == 0``) and the rounds between fold the mean of the worker
    projectors; at ``s = 1`` every round merges."""
    return step % cfg.merge_interval == 0


def carry_after(v_prev, v_new, merge_now: bool, mask=None):
    """The warm carry after a round: ``v_new`` on a live merge round, else
    ``v_prev``. A fold round makes no merged basis, and an all-masked
    round merges to zeros, a fixed point of the warm solver; liveness is
    read from the host mask row (None: every worker live)."""
    live = mask is None or bool(np.any(np.asarray(mask)))
    return v_new if merge_now and live else v_prev


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
    step_hook: Callable | None = None,
    ingest_stats=None,
):
    """Run the online algorithm over a stream of ``(m, n, d)`` blocks on the
    per-step loop; returns ``(w (d, k), state)``.

    ``max_steps``: ``"auto"`` caps the total step count at
    ``cfg.num_steps`` (open-ended under ``discount="1/t"``), ``None``
    consumes the whole stream, an int is an explicit cap. A capped loop
    stops on the block after the cap, as the reference's does, and under
    ``cfg.prefetch_depth > 0`` the producer may have taken up to
    ``prefetch_depth + 1`` blocks more; every block read past the cap is
    dropped, so an iterator shared across capped calls does not resume
    where a fit stopped (give each call its own stream, e.g.
    ``block_stream(start_row=)``). ``v0`` is the
    cold start basis (default: :func:`initial_basis` from ``cfg.seed``);
    after the first live round each step warm-starts from the previous
    merged basis with ``cfg.resolved_warm_start()`` iterations. Under
    ``cfg.merge_interval = s > 1`` only steps 1, s+1, ... merge; the
    others fold the mean of the worker projectors (``WorkerPool.round(
    merge=False)``).

    ``step_hook(step, state, x_blocks, t)`` wraps each step's execution
    (the supervisor's retry hook, ``runtime/supervisor.py``): it calls
    ``step(state, x_blocks) -> (state, v_bar)`` as often as it likes, and a
    retried step pulls its ``worker_masks`` row again. Under
    ``cfg.prefetch_depth > 0`` a producer thread reads the stream and
    copies each block to the device that many steps ahead
    (``runtime/prefetch.prefetch_stream``), counting its stalls into
    ``ingest_stats`` (a ``PrefetchStats``) when given.

    Under ``backend="feature_sharded"`` the loop runs the rank-r trainer
    of ``parallel/feature_sharded.py`` instead (:func:`_fit_feature_sharded`).
    Otherwise the pool's backend is ``cfg.backend``'s: under ``"shard_map"`` (or
    ``"auto"`` in a group of more than one rank) every rank runs the loop on
    the same blocks, solves its workers and holds the same state; ``on_step``
    then runs on rank 0 and the ranks meet at a barrier after it.
    """
    if worker_masks is not None:
        worker_masks = iter(worker_masks)
    if cfg.backend == "feature_sharded":
        return _fit_feature_sharded(stream, cfg, device=device, state=state,
                                    on_step=on_step, worker_masks=worker_masks,
                                    max_steps=max_steps, step_hook=step_hook,
                                    ingest_stats=ingest_stats)
    pool = WorkerPool(
        cfg.num_workers,
        backend=cfg.backend,
        solver=cfg.resolved_local_solver(),
        subspace_iters=cfg.subspace_iters,
        orth_method=cfg.orth_method,
        compute_dtype=cfg.compute_dtype,
        device=device,
        seed=cfg.seed,
    )
    dev = pool.device
    if state is None:
        state = OnlineState.initial(cfg.dim, cfg.state_dtype, device=dev)
    v_cold = initial_basis(cfg.dim, cfg.k, seed=cfg.seed, device=dev, v0=v0)
    warm_iters = cfg.resolved_warm_start()
    v_prev = None

    def step(st: OnlineState, x_blocks):
        # the warm carry is host state committed only when a step returns,
        # so a step the hook retries re-runs the same phase and start
        nonlocal v_prev
        merge_now = merge_phase(cfg, st.step)
        mask = next(worker_masks) if worker_masks is not None else None
        sigma_bar, v_bar = pool.round(
            x_blocks, cfg.k, worker_mask=mask,
            v0=v_cold if v_prev is None else v_prev,
            iters=warm_iters if v_prev is not None else None,
            orth=cfg.resolved_warm_orth() if v_prev is not None else None,
            merge=merge_now,
        )
        if merge_now:
            st = update_state(
                st, v_bar, discount=cfg.discount, num_steps=cfg.num_steps
            )
        else:
            # between merges: fold this round's (masked) mean projector;
            # the hook sees the carried basis (zeros before any live merge)
            st = update_state_projector(
                st, sigma_bar, discount=cfg.discount, num_steps=cfg.num_steps
            )
            v_bar = v_prev if v_prev is not None else torch.zeros(
                (cfg.dim, cfg.k), dtype=torch.float32, device=dev
            )
        if warm_iters is not None:
            v_prev = carry_after(v_prev, v_bar, merge_now, mask)
        return st, v_bar

    hook = None
    if on_step is not None:
        def hook(t, st, v_bar):
            pmesh.on_writer(pool.mesh, on_step, t, st, v_bar)

    state = _drive_stream(
        stream, cfg, device=dev, step=checked(step, mesh=pool.mesh),
        state=state, on_step=hook, max_steps=max_steps,
        step_hook=step_hook, ingest_stats=ingest_stats,
    )
    w = top_k_eigvecs(state.sigma_tilde, cfg.k)
    return w, state


def _drive_stream(stream, cfg: PCAConfig, *, device, step, state, on_step,
                  max_steps, step_hook=None, ingest_stats=None):
    """The loop every per-step backend shares: prefetch wiring, the step
    cap (open-ended for a ``1/t`` running mean under ``"auto"``), step
    bookkeeping and the producer's cleanup.

    ``step(state, x) -> (state, v_bar)``; the prefetch producer moves each
    block to ``device`` ahead of the loop (``runtime/prefetch.
    device_placer``: a block already there passes through). ``step_hook`` wraps each step's
    execution (:func:`online_distributed_pca`). The stream is closed when
    the loop ends, early or not."""
    if cfg.prefetch_depth > 0:
        # overlap block reads and host-to-device copies with the steps; the
        # producer reads ahead of the consumer
        from distributed_eigenspaces_tpu_torch.runtime.prefetch import (
            prefetch_stream,
        )

        stream = prefetch_stream(stream, depth=cfg.prefetch_depth,
                                 place=device_placer(device), stats=ingest_stats)
    cap = cfg.num_steps if max_steps == "auto" else max_steps
    # an explicit integer cap is honored under every discount rule
    open_ended = max_steps == "auto" and cfg.discount == "1/t"
    steps_done = int(state.step)
    try:
        for x_blocks in stream:
            if cap is not None and steps_done >= cap and not open_ended:
                break
            with annotate_step(steps_done + 1):
                if step_hook is None:
                    state, v_bar = step(state, x_blocks)
                else:
                    state, v_bar = step_hook(step, state, x_blocks,
                                             steps_done + 1)
            steps_done += 1
            if on_step is not None:
                on_step(steps_done, state, v_bar)
    finally:
        # stop the prefetch producer (and release its device blocks) when
        # the loop ends early
        close = getattr(stream, "close", None)
        if close is not None:
            close()
    return state


def _fit_feature_sharded(stream, cfg: PCAConfig, *, device, state, on_step,
                         worker_masks, max_steps, step_hook=None,
                         ingest_stats=None):
    """The per-step loop of the feature-sharded backend: each ``(m, n, d)``
    block through ``make_feature_sharded_step`` on
    ``parallel.mesh.auto_feature_mesh(cfg)`` (the ``(1, 1)`` layout in one
    process), the state rank-r (``LowRankState``, this rank's rows), driven
    by :func:`_drive_stream`. Returns ``(w, state)``, ``w`` the whole
    ``(d, k)`` ``u[:, :k]`` with canonical signs on every rank;
    ``on_step(t, state, v_bar)`` sees the whole state and basis on rank 0,
    then every rank meets at a barrier."""
    from distributed_eigenspaces_tpu_torch.ops.linalg import canonicalize_signs
    from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as fs

    mesh = pmesh.auto_feature_mesh(cfg, device)
    fstep = fs.make_feature_sharded_step(cfg, mesh, device=device,
                                         collectives=cfg.collectives)
    mesh = fstep.mesh
    if state is None:
        state = fstep.init_state()

    def step(st, x_blocks):
        mask = next(worker_masks) if worker_masks is not None else None
        return fstep(st, x_blocks, worker_mask=mask)

    hook = None
    if on_step is not None:
        def hook(t, st, v_bar):
            with pmesh.mesh_scope(mesh):
                whole = fs.gather_state(st)
                v_whole = pmesh.all_gather(v_bar, pmesh.FEATURE_AXIS)
            pmesh.on_writer(mesh, on_step, t, whole, v_whole)

    state = _drive_stream(
        stream, cfg, device=pmesh.mesh_device(mesh, device), step=step, state=state, on_step=hook, max_steps=max_steps,
        step_hook=step_hook, ingest_stats=ingest_stats,
    )
    with pmesh.mesh_scope(mesh):
        u_k = pmesh.all_gather(state.u[:, :cfg.k].contiguous(), pmesh.FEATURE_AXIS)
    return canonicalize_signs(u_k), state


def one_shot_round(x_blocks, k: int, *, pool: WorkerPool | None = None,
                   backend: str = "auto", device="cuda"):
    """One distributed round, as the reference's ``one_shot_round`` (the
    CLI's one-shot mode): ``(m, n, d)`` blocks -> ``(sigma_bar (d, d),
    v_bar (d, k))``, the merged projector average and its top-k. ``pool``
    defaults to an ``m``-worker ``WorkerPool`` (eigh workers) on
    ``device``."""
    x = torch.as_tensor(x_blocks)
    if pool is None:
        pool = WorkerPool(x.shape[0], backend=backend, device=device)
    return pool.round(pool.shard(x), k)
