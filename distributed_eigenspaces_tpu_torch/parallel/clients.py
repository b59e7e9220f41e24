"""Population-scale client aggregation: the cohort merge math.

Counterpart of ``distributed_eigenspaces_tpu/parallel/clients.py``. The
paper's merge, the average of per-worker projector summaries, is the shape
a transient client can contribute: a ``(d, k)`` factor summary of its own
data. This module is what a sampled cohort's contributions pass through
between "bytes arrived" and "basis updated", hardened by construction:

1. **Validation gauntlet** (:func:`validate_contribution`): a host-side
   screen of each contribution (shape, dtype, non-finite values,
   ``||W^T W - I||_F``). A scaled or garbage summary never reaches device
   memory; the caller quarantines it by client id and reason.
2. **Norm clip** (:func:`clip_factor_norms`): each surviving factor is
   Frobenius-clipped to ``clip_mult * sqrt(k)`` (an orthonormal summary's
   norm), so no client carries more than O(1) weight.
3. **Coordinate-wise trimmed mean** (:func:`trimmed_mean_factors`): the
   alpha-tails of each coordinate are dropped (alpha >=
   ``cfg.max_poison_frac``), so with at most that fraction of colluders
   the mean stays inside the honest envelope.
4. **Affinity screen and exact merge** (:func:`hardened_merge_body`): the
   trimmed mean, orthonormalized, is an anchor; contributions whose
   subspace affinity to it falls below ``screen_tau`` are excluded (the
   keep mask names them), and the survivors reduce through the exact
   masked merge (``ops.linalg.merged_top_k_lowrank``, or the tiered tree
   ``parallel.topology.tree_merge_stacked`` when a topology is set).

A round's cost and its one collective are functions of the cohort, never
the population: :func:`make_sharded_cohort_reduce` gathers the ``(cohort,
d, k)`` stack once over a workers mesh of ranks (in the root tier's wire
dtype, ``parallel/wire.py``) and the mask once in fp32, then runs the
hardened body on every rank. No hand kernel lies on this path.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.device import resolve_device
from distributed_eigenspaces_tpu_torch.ops.linalg import merged_top_k_lowrank
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

__all__ = [
    "REJECT_REASONS",
    "clip_factor_norms",
    "hardened_merge_body",
    "make_population_merge",
    "make_sharded_cohort_reduce",
    "naive_mean_basis",
    "population_topology",
    "trimmed_mean_factors",
    "validate_contribution",
]

#: the gauntlet's closed vocabulary of rejection reasons
REJECT_REASONS = (
    "bad_shape",
    "bad_dtype",
    "nonfinite",
    "not_orthonormal",
)


def validate_contribution(
    w, d: int, k: int, *, orth_tol: float = 0.25
) -> str | None:
    """Host-side validation gauntlet for ONE client contribution: None for
    a valid ``(d, k)`` factor summary, else the rejection reason (one of
    :data:`REJECT_REASONS`). Runs on numpy before the contribution can
    reach a device. ``orth_tol`` bounds ``||W^T W - I||_F``: honest
    summaries are QR outputs (~1e-6), while a uniform scale ``s`` alone
    costs ``sqrt(k) |s^2 - 1|``."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    arr = np.asarray(w)
    if arr.shape != (d, k):
        return "bad_shape"
    if not np.issubdtype(arr.dtype, np.floating):
        return "bad_dtype"
    arr = np.asarray(arr, np.float64)
    if not np.isfinite(arr).all():
        return "nonfinite"
    gram = arr.T @ arr
    if np.linalg.norm(gram - np.eye(k)) > orth_tol:
        return "not_orthonormal"
    return None


def clip_factor_norms(stack: torch.Tensor, *, clip_mult: float = 1.0) -> torch.Tensor:
    """Frobenius-clip each contribution of ``stack (c, d, k)`` to
    ``clip_mult * sqrt(k)``, the norm of an exactly orthonormal summary."""
    k = stack.shape[-1]
    cap = clip_mult * torch.sqrt(torch.tensor(float(k), dtype=stack.dtype))
    norms = torch.sqrt((stack * stack).sum(dim=(1, 2)) + 1e-30)
    scale = torch.clamp(cap.to(stack.device) / norms, max=1.0)
    return stack * scale[:, None, None]


def _align_signs(stack: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-column sign canonicalization across the cohort: the anchor row
    of each column is the argmax of the masked mean ``|entry|`` (a location
    statistic at most half the cohort cannot move; the first maximum on
    ties), and each contribution's column is flipped so its anchor entry
    is non-negative."""
    mf = mask.to(stack.dtype)
    cnt = torch.clamp(mf.sum(), min=1.0)
    absmean = (torch.abs(stack) * mf[:, None, None]).sum(dim=0) / cnt
    j0 = torch.argmax(absmean, dim=0)  # (k,) anchor row per column
    anchor = torch.take_along_dim(stack, j0[None, None, :].expand(stack.shape[0], 1, -1),
                                  dim=1)[:, 0, :]  # (c, k)
    s = torch.where(anchor < 0, -1.0, 1.0).to(stack.dtype)
    return stack * s[:, None, :]


def trimmed_mean_factors(stack: torch.Tensor, mask: torch.Tensor, alpha: float) -> torch.Tensor:
    """Masked coordinate-wise alpha-trimmed mean over the cohort axis: for
    each of the ``d k`` coordinates, sort the ``cnt = sum(mask)`` valid
    values, drop the lowest and highest ``t = floor(alpha cnt)``, average
    the rest. Masked-out entries sort to the tail (+inf) and never enter an
    average; an all-masked round returns zeros."""
    c = stack.shape[0]
    dt = stack.dtype
    mf = mask.to(device=stack.device, dtype=dt)
    cnt = mf.sum()
    guarded = torch.where(mf[:, None, None] > 0, stack,
                          torch.tensor(float("inf"), dtype=dt, device=stack.device))
    srt = torch.sort(guarded, dim=0).values
    pos = torch.arange(c, dtype=dt, device=stack.device)[:, None, None]
    t = torch.floor(alpha * cnt)
    keep = (pos >= t) & (pos <= cnt - 1.0 - t)
    vals = torch.where(keep & torch.isfinite(srt), srt, torch.zeros((), dtype=dt,
                                                                   device=stack.device))
    kept = torch.clamp(cnt - 2.0 * t, min=1.0)
    return vals.sum(dim=0) / kept


def naive_mean_basis(stack: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """The unhardened arm: the plain masked mean of the raw summaries,
    orthonormalized; no gauntlet, clip, trim or screen."""
    mf = mask.to(device=stack.device, dtype=stack.dtype)
    mean = (stack * mf[:, None, None]).sum(dim=0) / torch.clamp(mf.sum(), min=1.0)
    q, _ = torch.linalg.qr(mean)
    return q[:, :k]


def hardened_merge_body(
    stack: torch.Tensor,
    mask: torch.Tensor,
    *,
    k: int,
    alpha: float,
    clip_mult: float = 1.0,
    screen_tau: float = 0.5,
    topology=None,
):
    """The hardened cohort merge: clip, sign alignment, trimmed-mean
    anchor, affinity screen, then the exact masked merge of the survivors.
    Returns ``(v, keep, stats)``:

    - ``v (d, k)``: the merged basis (``tree_merge_stacked`` when
      ``topology`` is a resolved ``parallel.topology.MergeTopology``
      covering the cohort, else the flat ``merged_top_k_lowrank``);
    - ``keep (c,)``: which arrivals survived the screen;
    - ``stats``: 0-d tensors ``arrived``, ``kept``, ``trim_frac``,
      ``min_kept_aff`` and ``screen_fallback``.

    If the screen would exclude everyone (a degenerate anchor) it falls
    back to the arrival mask, and ``stats["screen_fallback"]`` is 1.
    """
    mf = mask.to(device=stack.device, dtype=stack.dtype)
    w = clip_factor_norms(stack, clip_mult=clip_mult)
    w = _align_signs(w, mf)
    anchor = trimmed_mean_factors(w, mf, alpha)
    q, _ = torch.linalg.qr(anchor)
    q = q[:, :k]
    proj = torch.einsum("dk,cdq->ckq", q, w)
    aff = (proj * proj).sum(dim=(1, 2)) / k
    keep = mf * (aff >= screen_tau).to(stack.dtype)
    fallback = keep.sum() == 0
    keep = torch.where(fallback, mf, keep)
    if topology is not None:
        from distributed_eigenspaces_tpu_torch.parallel.topology import (
            tree_merge_stacked,
        )

        v = tree_merge_stacked(w, k, topology, mask=keep)
    else:
        v = merged_top_k_lowrank(w, k, mask=keep)
    arrived = mf.sum()
    inf = torch.tensor(float("inf"), dtype=stack.dtype, device=stack.device)
    stats = {
        "arrived": arrived,
        "kept": keep.sum(),
        "trim_frac": 1.0 - keep.sum() / torch.clamp(arrived, min=1.0),
        "min_kept_aff": torch.where(keep > 0, aff, inf).min(),
        "screen_fallback": fallback.to(stack.dtype),
    }
    return v, keep, stats


def population_topology(cfg):
    """``cfg.merge_topology`` resolved against the COHORT (not
    ``num_workers``): the fan-ins must multiply to ``cohort_size`` and
    divide ``dim``. None when no topology is configured (flat merge)."""
    topo = getattr(cfg, "merge_topology", None)
    if topo is None:
        return None
    from distributed_eigenspaces_tpu_torch.parallel.topology import MergeTopology

    tiers = tuple((str(n), int(f)) for n, f in topo)
    product = 1
    for name, f in tiers:
        if cfg.dim % f:
            raise ValueError(
                f"population merge_topology tier {name!r} fan_in {f} "
                f"must divide dim={cfg.dim}"
            )
        product *= f
    if product != cfg.cohort_size:
        raise ValueError(
            f"population merge_topology fan-ins "
            f"{tuple(f for _, f in tiers)} multiply to {product}, but "
            f"cohort_size={cfg.cohort_size} — the tree must cover the "
            "cohort exactly"
        )
    return MergeTopology(tiers)


def make_population_merge(cfg, *, screen_tau: float = 0.5, device="cuda"):
    """The hardened cohort merge for ``cfg``: ``merge(stack (C, d, k),
    mask (C,)) -> (v, keep, stats)`` with ``C = cfg.cohort_size``. Alpha is
    ``cfg.max_poison_frac``: the declared Byzantine tolerance is the trim
    fraction. A ``merge_topology`` routes the survivors through the tiered
    tree. The stack and mask (tensors or arrays) are merged on ``device``,
    the card unless the caller asks for the CPU."""
    topo = population_topology(cfg)
    k, alpha = cfg.k, float(cfg.max_poison_frac)
    dev = resolve_device(device)

    def merge(stack, mask):
        stack = torch.as_tensor(stack, dtype=torch.float32).to(dev)
        mask = torch.as_tensor(mask, dtype=torch.float32).to(dev)
        return hardened_merge_body(
            stack, mask, k=k, alpha=alpha, screen_tau=screen_tau,
            topology=topo,
        )

    return merge


def make_sharded_cohort_reduce(
    cfg, mesh, *, screen_tau: float = 0.5, wire_dtype: str | None = None
):
    """The population-merge program on a workers mesh of ranks: each rank
    holds its shard ``(C / W, d, k)`` of the cohort stack and ``(C / W,)``
    of its mask; ONE all-gather over ``workers`` assembles the ``(C, d,
    k)`` stack (``C d k`` elements: a function of the cohort, never the
    population), one more the mask in fp32, and the hardened body runs on
    every rank on the same bits. Returns ``reduce(stack_shard, mask_shard)
    -> v (d, k)``.

    ``wire_dtype`` (default: the root tier of ``cfg.merge_wire_dtype``,
    ``parallel.wire.root_wire_dtype``: the cohort gather crosses every tier
    boundary at once, so it rides the slowest wire the policy names)
    compresses the stack gather through the ``parallel/wire.py`` codecs,
    one-shot. The mask stays fp32: screening and trim decisions are never
    made on quantized bits.
    """
    from distributed_eigenspaces_tpu_torch.parallel.wire import (
        root_wire_dtype,
        wire_all_gather,
    )

    topo = population_topology(cfg)
    k, alpha = cfg.k, float(cfg.max_poison_frac)
    if wire_dtype is None:
        wire_dtype = root_wire_dtype(cfg, topo)

    def reduce(stack_shard, mask_shard):
        stack_shard = torch.as_tensor(stack_shard, dtype=torch.float32).to(mesh.device)
        mask_shard = torch.as_tensor(mask_shard, dtype=torch.float32).to(mesh.device)
        with pmesh.mesh_scope(mesh):
            if wire_dtype == "fp32":
                stack = pmesh.all_gather(stack_shard, pmesh.WORKER_AXIS)
            else:
                stack = wire_all_gather(stack_shard, pmesh.WORKER_AXIS, wire_dtype)
            mask = pmesh.all_gather(mask_shard, pmesh.WORKER_AXIS)
        v, _, _ = hardened_merge_body(
            stack, mask, k=k, alpha=alpha, screen_tau=screen_tau,
            topology=topo,
        )
        return v

    return reduce
