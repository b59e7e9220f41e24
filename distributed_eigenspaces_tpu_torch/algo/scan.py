"""The whole-fit trainers: T online steps, cold first, warm after.

Counterpart of ``distributed_eigenspaces_tpu/algo/scan.py``: the unmasked
scan, the masked scan (§5.3 worker masks), the merge-interval and
pipelined steady states, and the segmented, checkpointable trainer with
its out-of-core ``fit_windows``, each on one device or on a ``(workers,
features)`` mesh. The reference compiles each body into one ``lax.scan``;
here a body is a Python loop over the same step functions
(``algo/step.py``). Its ``lax.cond``s become host branches: on the step
counter and the mask row, which the host holds, and on the warm carry's
liveness, which is read from the tensor (one device sync) where the
reference reads it on the device.

On a mesh the ``(T, m, n, d)`` steps shard over axis 1 (the reference's
``P(None, WORKER_AXIS)``): each rank is given every step's block, whole or
already its ``m / W`` workers, solves its workers and all-gathers the
factors, so the merge, the fold and the carry are the same bits on every
rank, and every host branch reads a replicated value. Host hooks
(``on_segment``) run on rank 0, then every rank waits at a barrier.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.algo.online import (
    OnlineState,
    carry_after,
    merge_phase,
    update_state,
    update_state_projector,
)
from distributed_eigenspaces_tpu_torch.algo.step import (
    make_solve_core,
    make_warm_solve_core,
    mean_projector,
    merge_core,
    merge_knobs,
    merge_start,
)
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype
from distributed_eigenspaces_tpu_torch.ops.linalg import initial_basis, projector
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh


@dataclasses.dataclass(frozen=True)
class _Cores:
    """The step functions every trainer here shares, built once per
    trainer: the cold and warm solves, the seeded starts and the state
    update."""

    cfg: PCAConfig
    dev: torch.device
    v_cold: torch.Tensor  # (d, k) cold start of every cold solve
    v_merge: torch.Tensor | None  # (d, k') crossover-merge start, or None
    solve_cold: Callable
    solve_warm: Callable | None  # None without warm starts
    mesh: pmesh.Mesh | None = None

    def place(self, x) -> torch.Tensor:
        """A step's block on this rank's device: all of it, or on a mesh
        this rank's workers (the block whole or already sharded)."""
        return pmesh.place_workers(self.mesh, x, self.cfg.num_workers, self.dev)

    def update(self, st: OnlineState, v_bar: torch.Tensor) -> OnlineState:
        return update_state(st, v_bar, discount=self.cfg.discount,
                            num_steps=self.cfg.num_steps)

    def cold_round(self, x) -> torch.Tensor:
        """The cold round at the full iteration count, always merged: the
        first step of a run, which seeds the warm carry."""
        return merge_core(self.solve_cold(x, self.v_cold), self.cfg.k,
                          v_init=self.v_merge, **merge_knobs(self.cfg))


def _cores(cfg: PCAConfig, device, v0, v_init, mesh=None) -> _Cores:
    dev = pmesh.mesh_device(mesh, device)
    return _Cores(
        cfg=cfg,
        dev=dev,
        v_cold=initial_basis(cfg.dim, cfg.k, seed=cfg.seed, device=dev, v0=v0),
        v_merge=merge_start(cfg, device=dev, v_init=v_init),
        solve_cold=make_solve_core(cfg, mesh=mesh),
        solve_warm=make_warm_solve_core(cfg, mesh=mesh),
        mesh=mesh,
    )


def _live(vp: torch.Tensor) -> bool:
    """Whether the warm carry holds a basis (any nonzero entry): the
    reference's on-device ``jnp.any(vp != 0)``, read on the host."""
    return bool(torch.any(vp != 0))


def _merge_or_fold_factory(cfg: PCAConfig, cores: _Cores):
    """The round fold shared by every body here (unmasked and masked scan,
    pipelined scan, segmented): ``fold_round(st, vs, vp, mask=None) ->
    (st, v_new, merge_now)``. On merge rounds (:func:`~.online.merge_phase`:
    every round at ``s = 1``, else 1-based steps 1, s+1, 2s+1, ...) the
    factors run the merge and the merged projector is folded; between
    merges the masked mean of the worker projectors is folded at the same
    weight and ``v_new`` is the carried basis. ``mask`` is this round's
    mask: a worker drop takes effect in this round's fold and at the next
    merge."""
    knobs = merge_knobs(cfg)

    def fold_round(st, vs, vp, mask=None):
        merge_now = merge_phase(cfg, st.step)
        if merge_now:
            v_new = merge_core(vs, cfg.k, mask=mask, v_init=cores.v_merge, **knobs)
            p = projector(v_new)
        else:
            v_new, p = vp, mean_projector(vs, mask)
        st = update_state_projector(
            st, p, discount=cfg.discount, num_steps=cfg.num_steps
        )
        return st, v_new, merge_now

    return fold_round


def _masked_body_factory(cfg: PCAConfig, cores: _Cores):
    """The masked step body shared by the masked scan and the segmented
    trainer: ``body((st, vp), x, mask_row) -> ((st, vp), v_out)``, with
    ``mask_row`` a host ``(m,)`` array. Every round solves, cold until the
    carry holds a basis and warm after, so a killed-and-resumed masked run
    is the unkilled one and an all-masked first round recovers instead of
    freezing a zero basis (zeros are a fixed point of the warm solver).
    Then the shared merge-or-fold runs with this round's mask (an
    all-masked merge round folds zeros), and the warm carry advances only
    on live merge rounds (:func:`~.online.carry_after`)."""
    warm = cores.solve_warm is not None
    fold_round = _merge_or_fold_factory(cfg, cores)

    def body(carry, x, row):
        st, vp = carry
        if warm and _live(vp):
            vs = cores.solve_warm(x, vp)
        else:
            vs = cores.solve_cold(x, cores.v_cold)
        mk = torch.as_tensor(np.asarray(row, np.float32)).to(cores.dev)
        st, v_new, merge_now = fold_round(st, vs, vp, mask=mk)
        return (st, carry_after(vp, v_new, merge_now, row)), v_new

    return body


def make_masked_step_body(cfg: PCAConfig, *, mesh=None, device="cuda", v0=None,
                          v_init=None):
    """The masked per-step body (:func:`_masked_body_factory`) for trainers
    outside this module, built from ``cfg`` with the cold start ``v0`` and
    the crossover-merge start ``v_init``; its carry is ``(OnlineState,
    v_prev (d, k))``, zeros before any live round."""
    return _masked_body_factory(cfg, _cores(cfg, device, v0, v_init, mesh))


def _segment_factory(cfg: PCAConfig, cores: _Cores):
    """The unmasked steps, shared by the scan and the segmented trainer:
    ``seg(st, vp, blocks, first) -> (st, vp, v_bars)``. With warm starts,
    ``first`` runs the first block as the cold round (always merged: it
    seeds the carry) and every later step solves warm from the carry;
    without, every step solves cold. Each step then folds through the
    shared merge-or-fold; ``v_bars[t]`` is the merged basis as of that
    step (the carry on fold rounds)."""
    warm = cores.solve_warm is not None
    fold_round = _merge_or_fold_factory(cfg, cores)

    def seg(st, vp, blocks, first: bool):
        out = []
        if warm and first and blocks:
            vp = cores.cold_round(cores.place(blocks[0]))
            st = cores.update(st, vp)
            out.append(vp)
            blocks = blocks[1:]
        for x in blocks:
            x = cores.place(x)
            vs = cores.solve_warm(x, vp) if warm else cores.solve_cold(x, cores.v_cold)
            st, vp, _ = fold_round(st, vs, vp)
            out.append(vp)
        return st, vp, out

    return seg


def _zeros_carry(cfg: PCAConfig, dev) -> torch.Tensor:
    return torch.zeros((cfg.dim, cfg.k), dtype=torch.float32, device=dev)


def _steps_of(x_steps, idx=None) -> list:
    """The schedule's blocks, in order: each step of ``x_steps`` (a stacked
    tensor or any iterable of blocks), or ``x_steps[idx[t]]`` under a
    gather schedule."""
    if idx is None:
        return list(x_steps)
    return [x_steps[int(i)] for i in np.asarray(torch.as_tensor(idx).cpu())]


def _schedule(x_steps, idx=None) -> list:
    """:func:`_steps_of`, refusing an empty schedule."""
    steps = _steps_of(x_steps, idx)
    if not steps:
        raise ValueError("make_scan_fit: the schedule holds no step")
    return steps


def _make_pipelined_fit(cfg: PCAConfig, cores: _Cores):
    """The pipelined steady state (``cfg.pipeline_merge``): each round runs
    the merge-or-fold of step ``t - 1``'s pending factors and step ``t``'s
    warm solves from the one-step-stale merged basis (merges through step
    ``t - 2``). Step 1 runs cold and merges unpipelined (it seeds the
    carry); step 2's solves use step 1's fresh merge; steps >= 3 are
    pipelined; an epilogue merges or folds the last pending round.
    Composes with ``merge_interval`` (the pending fold goes through
    :func:`_merge_or_fold_factory`). The reference puts both halves of a
    round in one program so XLA may overlap them; eagerly they run in
    turn, with the same numbers."""
    fold_round = _merge_or_fold_factory(cfg, cores)

    def run(state, blocks):
        T = len(blocks)
        v1 = cores.cold_round(cores.place(blocks[0]))
        state = cores.update(state, v1)
        out = [v1]
        if T == 1:
            return state, out
        vs_p = cores.solve_warm(cores.place(blocks[1]), v1)
        vp = v1
        for x in blocks[2:]:
            # this round's solves read the stale carry vp, not the
            # pending round's merge
            vs = cores.solve_warm(cores.place(x), vp)
            state, vp, _ = fold_round(state, vs_p, vp)
            vs_p = vs
            out.append(vp)
        state, v_last, _ = fold_round(state, vs_p, vp)
        out.append(v_last)
        return state, out

    return run


def make_scan_fit(cfg: PCAConfig, *, mesh=None, device="cuda", v0=None,
                  v_init=None, gather: bool = False, masked: bool = False):
    """Build the whole-fit trainer.

    ``gather=False``: ``fit(state, x_steps) -> (state, v_bars)``, with
    ``x_steps`` a ``(T, m, n, d)`` tensor or a sequence of ``(m, n, d)``
    blocks and ``v_bars (T, d, k)`` the merged eigenspace after every step.
    ``gather=True``: ``fit(state, blocks, idx)``, each step taking
    ``blocks[idx[t]]`` of ``B`` distinct blocks (the cycled-blocks schedule
    without materializing it).

    Step 1 runs the cold core at ``cfg.subspace_iters`` from ``v0``
    (default: :func:`~..ops.linalg.initial_basis` from ``cfg.seed``); with
    warm starts on, every later step starts from the previous ``v_bar`` at
    ``cfg.resolved_warm_start()`` iterations, otherwise every step is cold.
    Above the crossover (``cfg.uses_distributed_solve()``) every merge is
    the distributed solve from ``v_init (d, k')`` (default: drawn from
    ``cfg.seed``). The steps are the segmented trainer's
    (:func:`_segment_factory`) over one window holding the whole schedule.

    ``masked=True`` builds the §5.3 variant instead: ``fit(state, x_steps,
    masks, membership_masks=None) -> (state, v_bars)`` with ``masks`` a
    ``(T, m)`` {0, 1} array (times ``membership_masks`` when given), each
    step through :func:`_masked_body_factory`, equal to the per-step masked
    loop. ``gather`` is not offered masked.

    ``cfg.merge_interval = s > 1`` runs the merged eigensolve every s
    steps and folds the mean worker projector between
    (:func:`_merge_or_fold_factory`); ``cfg.pipeline_merge`` overlaps step
    ``t - 1``'s merge or fold with step ``t``'s warm solves from a
    one-step-stale basis (:func:`_make_pipelined_fit`). Masked fits honour
    ``merge_interval`` and run unpipelined.

    With a ``(workers, features)`` ``mesh`` the fit runs on every rank of it
    (on the mesh's device): each step's block is given whole or as this
    rank's workers, ``masks`` whole, and the returned state and bases are
    the same on every rank.

    With ``cfg.merge_topology`` every merge is the stacked tree
    (``algo.step.merge_core``), and a tiered ``mesh``
    (``parallel.topology.make_tiered_mesh``) dispatches to the tier-local
    trainer, ``parallel.topology.make_tree_scan_fit`` (no ``gather``).
    """
    if masked and gather:
        raise ValueError("masked scan fits take a dense (T, ...) stack")
    from distributed_eigenspaces_tpu_torch.parallel.topology import (
        is_tiered_mesh,
        make_tree_scan_fit,
        resolve_topology,
    )

    if is_tiered_mesh(mesh, resolve_topology(cfg)):
        if gather:
            raise ValueError(
                "gather staging is not supported on the tiered-mesh "
                "path (stage dense (T, ...) stacks, or use a flat "
                "worker-axis mesh)"
            )
        return make_tree_scan_fit(cfg, mesh, masked=masked, v0=v0)
    cores = _cores(cfg, device, v0, v_init, mesh)

    if masked:
        body = _masked_body_factory(cfg, cores)

        def fit_masked_elastic(state, x_steps, masks, membership_masks=None):
            """The masked whole fit, with an elastic run's ``(T, m)``
            per-round membership masks (``runtime/membership.
            ElasticStream``) combined with the quarantine ``masks`` by AND
            before the steps: membership and quarantine are one masked
            mean, so an elastic run replays through the masked steps."""
            masks = np.asarray(
                torch.as_tensor(masks).cpu() if isinstance(masks, torch.Tensor)
                else masks, np.float32)
            if membership_masks is not None:
                masks = masks * np.asarray(membership_masks, np.float32)
            blocks = _schedule(x_steps)
            if masks.shape != (len(blocks), cfg.num_workers):
                raise ValueError(
                    f"masks shape {masks.shape} != (T={len(blocks)}, "
                    f"num_workers={cfg.num_workers})"
                )
            carry, out = (state, _zeros_carry(cfg, cores.dev)), []
            for x, row in zip(blocks, masks):
                carry, v = body(carry, cores.place(x), row)
                out.append(v)
            return carry[0], torch.stack(out)

        return fit_masked_elastic

    if cfg.pipeline_merge:
        run = _make_pipelined_fit(cfg, cores)
    else:
        seg = _segment_factory(cfg, cores)

        def run(state, blocks):
            state, _, out = seg(state, _zeros_carry(cfg, cores.dev), blocks,
                                first=True)
            return state, out

    if gather:

        def fit_gather(state, blocks, idx):
            state, out = run(state, _schedule(blocks, idx))
            return state, torch.stack(out)

        return fit_gather

    def fit(state: OnlineState, x_steps):
        state, out = run(state, _schedule(x_steps))
        return state, torch.stack(out)

    return fit


class SegmentState(NamedTuple):
    """Checkpointable carry of the segmented trainer: the online state and
    the warm-start carry (the last merged estimate), so a resumed run
    continues bit for bit. ``step`` is the 1-based count of rounds folded
    in, a host int."""

    sigma_tilde: torch.Tensor
    step: int
    v_prev: torch.Tensor  # (d, k) last merged estimate; zeros before step 1

    @classmethod
    def initial(cls, dim: int, k: int, dtype="float32", *,
                device="cuda") -> "SegmentState":
        dev = resolve_device(device)
        return cls(
            sigma_tilde=torch.zeros((dim, dim), dtype=torch_dtype(dtype), device=dev),
            step=0,
            v_prev=torch.zeros((dim, k), dtype=torch.float32, device=dev),
        )


def make_segmented_fit(cfg: PCAConfig, *, segment: int = 50, mesh=None,
                       device="cuda", v0=None, v_init=None):
    """Checkpointable whole-fit trainer: ``fit(state, x_steps,
    on_segment=None) -> SegmentState`` runs the T steps as windows of
    ``segment`` steps, calling ``on_segment(steps_done, state)`` on the
    host between windows (checkpoints, metrics).

    The steps are those of :func:`make_scan_fit` on the same workload: with
    warm starts the cold first step runs only when the run starts (step 0,
    or a zero carry), and the warm carry crosses window and checkpoint
    boundaries in ``state.v_prev``, so a killed-and-resumed run is the
    unkilled run bit for bit. ``cfg.merge_interval > 1`` is resume-safe:
    the merge phase follows the step counter, which every checkpoint
    holds. ``cfg.pipeline_merge`` is refused: the pipelined carry's
    pending factors are no part of ``SegmentState``.

    ``fit.fit_windows(state, windows, on_segment=None, worker_masks=None)``
    consumes an iterator of ``(S, m, n, d)`` windows instead (the
    out-of-core route: wrap the source in
    :func:`~..runtime.prefetch.prefetch_stream` to read and move window
    t + 1 while window t runs); ``worker_masks``, an iterable of ``(S, m)``
    {0, 1} arrays zipped strictly with the windows, runs the masked body
    (:func:`_masked_body_factory`) on every window.

    With a ``(workers, features)`` ``mesh`` every rank runs the windows
    (each step's block whole or as its workers) and holds the same state;
    ``on_segment`` runs on rank 0 only, then every rank waits at a barrier,
    so a checkpoint it commits is on disk before any rank goes on.
    """
    if segment < 1:
        raise ValueError(f"segment must be >= 1, got {segment}")
    if cfg.pipeline_merge:
        raise ValueError(
            "pipeline_merge is not supported by the segmented trainer: "
            "the pending-factor carry is not checkpointable state, so "
            "kill/resume could not be bit-for-bit (use make_scan_fit, "
            "or merge_interval without pipelining)"
        )
    cores = _cores(cfg, device, v0, v_init, mesh)
    warm = cores.solve_warm is not None
    run_steps = _segment_factory(cfg, cores)
    masked_body = _masked_body_factory(cfg, cores)

    def seg(sstate: SegmentState, window, first: bool) -> SegmentState:
        st, vp, _ = run_steps(OnlineState(sstate.sigma_tilde, sstate.step),
                              sstate.v_prev, _steps_of(window), first)
        return SegmentState(st.sigma_tilde, st.step, vp)

    def seg_masked(sstate: SegmentState, window, masks) -> SegmentState:
        carry = (OnlineState(sstate.sigma_tilde, sstate.step), sstate.v_prev)
        blocks = _steps_of(window)
        masks = np.asarray(masks, np.float32)
        if masks.shape != (len(blocks), cfg.num_workers):
            raise ValueError(
                f"mask window shape {masks.shape} != (S={len(blocks)}, "
                f"num_workers={cfg.num_workers})"
            )
        for x, row in zip(blocks, masks):
            carry, _ = masked_body(carry, cores.place(x), row)
        st, vp = carry
        return SegmentState(st.sigma_tilde, st.step, vp)

    def fit_windows(state: SegmentState, windows, on_segment=None,
                    worker_masks=None) -> SegmentState:
        # a zero carry must run cold too: zeros are a fixed point of the
        # warm solver, so warm-starting a restored state that lacks v_prev
        # would discard every later step. Read once, up front: after the
        # first window the step is > 0 and the carry nonzero.
        first = warm and (int(state.step) == 0 or not _live(state.v_prev))
        pairs = (
            ((w, None) for w in windows) if worker_masks is None
            else zip(windows, worker_masks, strict=True)
        )
        for w, mk in pairs:
            state = seg(state, w, first) if mk is None else seg_masked(state, w, mk)
            first = False
            if on_segment is not None:
                pmesh.on_writer(mesh, on_segment, int(state.step), state)
        return state

    def fit(state: SegmentState, x_steps, on_segment=None) -> SegmentState:
        total = len(x_steps)
        return fit_windows(
            state,
            (x_steps[t:t + segment] for t in range(0, total, segment)),
            on_segment,
        )

    fit.segment = segment
    fit.fit_windows = fit_windows
    return fit
