"""Blocked subspace eigensolves from matvec access only.

Counterpart of ``distributed_eigenspaces_tpu/solvers/distributed.py``. With
``axis_name=None`` (the reference's single-device / root-tier degenerate)
everything runs on one device; with an axis name, inside
``parallel.mesh.mesh_scope(mesh)``, the rows of every ``(d_local, k)``
block are this rank's share along that axis, and each ``k``-wide Gram,
projection or norm is summed over it (``parallel/mesh.psum``), so every
rank of the axis holds the same small matrices and takes the same host
branches:

- :func:`dist_subspace_eig`: blocked subspace iteration on a symmetric PSD
  operator, orthonormalized by CholeskyQR2 and finished by one
  Rayleigh-Ritz solve; ``oversample``, ``tol``, ``with_info`` and the
  fused ``matvec_gram`` sweep as in the reference.
- :func:`dist_merged_top_k`: the crossover merge on a ``(workers,
  features)`` mesh: the factors all-gathered over ``workers``, the solve's
  rows over ``features``.
- :func:`merged_top_k_distributed`: the crossover MERGE, top-k of the
  masked mean of the workers' projectors from their factors, as subspace
  iteration on ``C C^T`` (``C`` the scaled factor concatenation). Never
  forms the d x d mean projector nor the ``(m k)^2`` factor Gram.
- :func:`dist_extract_top_k`: the serving extract, top-k of ``U diag(s)
  U^T`` from its factors.
- :func:`fused_factor_matvec`: the inner sweep ``(w, g) = (C (C^T v),
  w^T w)`` through ``ops.matvec_gram`` (the Hopper kernel on a CUDA
  tensor). As in the reference, only callers of :func:`dist_subspace_eig`
  that pass it reach it; the trainers' merge uses :func:`factor_matvec`.

Random starts are explicit: torch cannot draw ``jax.random``'s bits, so
every solve takes ``v_init (d, k')``, the standard-normal block the
reference draws with ``jax.random.normal(key, (d, k'))`` (``PRNGKey(0)``
by default; on a mesh it draws each row shard from ``fold_in(key,
axis_index)``, so the global start is those shards stacked). Without it
the block is drawn from ``torch.Generator().manual_seed(0)`` on the CPU
(:func:`~..ops.linalg.initial_basis`), the same start on every device; on
a mesh each rank takes its rows of the global start. The trainers pass one
drawn from ``cfg.seed`` (``algo.step.merge_start``). The merges'
worker factor-stack gather, the solve's one d-wide payload, takes
``collectives="ring"`` (``parallel/ring.py``) or a wire codec
(``wire_dtype``, ``parallel/wire.py``, one-shot lossy: every sum and the
mask gather stay fp32), not both.
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.device import resolve_device
from distributed_eigenspaces_tpu_torch.ops.linalg import (
    canonicalize_signs,
    chol_apply,
    chol_qr,
    chol_qr2,
    initial_basis,
    rayleigh_ritz,
)
from distributed_eigenspaces_tpu_torch.ops.matvec_gram import matvec_gram_auto
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import (
    _psum_if,
    _small_eigh_desc,
)
from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import (
    chol_qr2 as dist_chol_qr2,
)
from distributed_eigenspaces_tpu_torch.parallel.ring import ring_all_gather
from distributed_eigenspaces_tpu_torch.parallel.wire import wire_all_gather

__all__ = [
    "dist_canonicalize_signs",
    "dist_extract_top_k",
    "dist_merged_top_k",
    "dist_rayleigh_ritz",
    "dist_subspace_eig",
    "factor_matvec",
    "fused_factor_matvec",
    "lowrank_matvec",
    "merged_top_k_distributed",
    "subspace_residual",
]

def _gathered_worker_factors(v_workers, mask, collectives: str, wire_dtype: str):
    """The merges' prologue on a ``(workers, features)`` mesh: every
    worker's factors ``(m, d_local, kf)``, gathered over ``workers`` by
    the process group (``collectives="xla"``), the explicit ring, or in
    the wire dtype, and the ``(m,)`` fp32 weights (ones without a mask)."""
    if collectives not in ("xla", "ring"):
        raise ValueError(f"unknown collectives mode: {collectives!r}")
    if wire_dtype != "fp32" and collectives != "xla":
        raise ValueError(
            "wire_dtype compression needs collectives='xla' (the "
            "ring route has no codec path)"
        )
    gather = ring_all_gather if collectives == "ring" else pmesh.all_gather
    x = torch.as_tensor(v_workers).float()
    if wire_dtype != "fp32":
        c = wire_all_gather(x, pmesh.WORKER_AXIS, wire_dtype)
    else:
        c = gather(x, pmesh.WORKER_AXIS)
    if mask is None:
        w = torch.ones((c.shape[0],), dtype=torch.float32, device=c.device)
    else:
        w = gather(torch.as_tensor(mask, dtype=torch.float32).to(c.device),
                   pmesh.WORKER_AXIS)
    return c, w


def _qr2(v: torch.Tensor, axis_name) -> torch.Tensor:
    """CholeskyQR2 of a row-sharded block (``ops.linalg.chol_qr2`` at
    ``axis_name=None``)."""
    return chol_qr2(v) if axis_name is None else dist_chol_qr2(v, axis_name)


def _row_start(v_init, d_local: int, width: int, axis_name, device) -> torch.Tensor:
    """This rank's ``(d_local, width)`` rows of the whole ``(d, width)``
    start ``v_init`` along ``axis_name`` (default: drawn whole from seed 0)."""
    shards = 1 if axis_name is None else pmesh.axis_size(axis_name)
    v = initial_basis(d_local * shards, width, device=device, v0=v_init)
    if tuple(v.shape) != (d_local * shards, width):
        raise ValueError(
            f"v_init must be ({d_local * shards}, {width}), got {tuple(v.shape)}"
        )
    if shards == 1:
        return v
    i = pmesh.axis_index(axis_name)
    return v[i * d_local:(i + 1) * d_local]


def dist_canonicalize_signs(v: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Flip each column so its globally largest-|entry| element is positive.
    On a row-sharded ``v (d_local, k)`` only a ``(2, k)`` candidate per
    shard is gathered (never the basis); cross-shard ties go to the lowest
    shard, the one-device rule's first index."""
    if axis_name is None:
        return canonicalize_signs(v)
    idx = torch.argmax(torch.abs(v), dim=0, keepdim=True)
    pivot = torch.take_along_dim(v, idx, dim=0)[0]  # (k,)
    cand = torch.stack([torch.abs(pivot), pivot])  # (2, k)
    allc = pmesh.all_gather(cand, axis_name, tiled=False)  # (f, 2, k)
    shard = torch.argmax(allc[:, 0, :], dim=0, keepdim=True)
    gpivot = torch.take_along_dim(allc[:, 1, :], shard, dim=0)[0]
    signs = torch.where(gpivot >= 0, 1.0, -1.0).to(v.dtype)
    return v * signs[None, :]


def dist_rayleigh_ritz(v: torch.Tensor, av: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Rotate an orthonormal ``v (d, k)`` to eigenvector coordinates given
    ``av = A v``: descending, canonical signs. On one device this is
    ``ops.linalg.rayleigh_ritz`` (the reference's ``_small_eigh_desc`` of
    the symmetrized ``v^T A v``, then the rotation); row-sharded, the
    ``k x k`` projection is summed over ``axis_name``, the small ``eigh``
    runs on every rank and the rotation is row-local."""
    if axis_name is None:
        return rayleigh_ritz(v, av)
    small = _psum_if(torch.matmul(v.mT, av), axis_name)
    _, q = _small_eigh_desc(small)
    return dist_canonicalize_signs(torch.matmul(v, q), axis_name)


def _start_device(device, v_init, v0):
    if device is not None:
        return resolve_device(device)
    for t in (v_init, v0):
        if isinstance(t, torch.Tensor):
            return t.device
    return resolve_device("cuda")


def dist_subspace_eig(
    matvec,
    d_local: int,
    k: int,
    *,
    iters: int = 16,
    v_init=None,
    device=None,
    axis_name=None,
    v0=None,
    oversample: int = 0,
    matvec_gram=None,
    tol: float | None = None,
    with_info: bool = False,
):
    """Top-k invariant subspace of a symmetric PSD operator by blocked
    subspace iteration; returns ``(d, k)`` (and ``info`` with
    ``with_info``).

    ``matvec(v) -> A v`` on ``(d, k')`` blocks, ``k' = k + oversample``.
    The start is ``v_init (d, k')`` (default: drawn from seed 0), on
    ``device`` (default: ``v_init``'s or ``v0``'s device, else ``"cuda"``);
    with ``v0 (d, k)`` it is the reference's blend
    ``(1e-3 / sqrt(d)) v_init`` plus ``v0`` on the leading k columns. Per
    iteration one matvec and one CholeskyQR2; ``matvec_gram`` (e.g.
    :func:`fused_factor_matvec`) returns ``(A v, (A v)^T (A v))`` in one
    call and the first CholeskyQR pass finishes from that Gram. ``tol``
    stops as soon as :func:`subspace_residual` drops below it (at most
    ``iters`` sweeps); ``info = {"iters_used": int, "residual": float}``
    (``nan`` without ``tol``).

    With ``axis_name`` (inside ``mesh_scope``) ``matvec`` maps this rank's
    ``(d_local, k')`` rows to rows, ``v_init`` is the whole ``(d, k')``
    start (this rank takes its rows), ``v0`` this rank's rows
    of the warm basis, and every Gram and residual is summed over the axis,
    so the ``tol`` stop reads the same value on every rank. ``matvec_gram``
    fuses a local operator only (``axis_name=None``), as in the
    reference."""
    if matvec_gram is not None and axis_name is not None:
        raise ValueError(
            "matvec_gram fuses a LOCAL operator with its Gram; the "
            "sharded inner loop must psum between the matvec and the "
            "Gram, so fusion only applies with axis_name=None"
        )
    kk = k + max(int(oversample), 0)
    v = _row_start(v_init, d_local, kk, axis_name,
                   _start_device(device, v_init, v0))
    if v0 is not None:
        d_total = d_local * (1 if axis_name is None else pmesh.axis_size(axis_name))
        scale = 1e-3 * torch.rsqrt(torch.tensor(float(d_total), dtype=torch.float32))
        v = scale.to(v.device) * v
        v[:, :k] += torch.as_tensor(v0, dtype=torch.float32, device=v.device)
    v = _qr2(v, axis_name)

    if matvec_gram is None:

        def sweep(vi):
            w = matvec(vi)
            return w, _qr2(w, axis_name)

    else:

        def sweep(vi):
            w, g = matvec_gram(vi)
            # the first CholeskyQR pass reuses the fused Gram, the second
            # recomputes it from the orthogonalized block (QR2)
            return w, chol_qr(chol_apply(w, g))

    iters_used, res = iters, float("nan")
    if tol is None:
        for _ in range(iters):
            v = sweep(v)[1]
    else:
        iters_used, res = 0, float("inf")
        while iters_used < iters and res > tol:
            w, vn = sweep(v)
            # summed over the axis: every rank reads the same residual
            res = float(subspace_residual(v, w, axis_name))
            v, iters_used = vn, iters_used + 1
    out = dist_rayleigh_ritz(v, matvec(v), axis_name)[:, :k]
    if with_info:
        return out, {"iters_used": iters_used, "residual": res}
    return out


def subspace_residual(v: torch.Tensor, w: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Relative invariance residual ``||W - V (V^T W)||_F / ||W||_F`` of an
    orthonormal ``v (d, k')`` given ``w = A v``; zero for a zero ``w``.
    Row-sharded: one ``k' x k'`` and two scalar sums over ``axis_name``."""
    s = _psum_if(torch.matmul(v.mT, w), axis_name)
    r = w - torch.matmul(v, s)
    rn = _psum_if(torch.sum(r * r), axis_name)
    wn = _psum_if(torch.sum(w * w), axis_name)
    return torch.sqrt(rn) / torch.sqrt(torch.clamp(wn, min=1e-30))


def factor_matvec(c: torch.Tensor, axis_name=None, alive=None):
    """``matvec(v) = C (C^T v)`` for a factor concatenation ``C (d, f)``.
    ``alive`` (a bool tensor) guards the all-masked merge: a dead operator
    acts as the identity, so CholeskyQR2 never sees a zero Gram, and the
    caller zeroes the result. Row-sharded (``c`` this rank's ``(d_local,
    f)`` rows), the ``(f, k)`` inner product is summed over ``axis_name``."""

    def matvec(v):
        out = torch.matmul(c, _psum_if(torch.matmul(c.mT, v), axis_name))
        if alive is None:
            return out
        return torch.where(alive, out, v)

    return matvec


def fused_factor_matvec(c: torch.Tensor):
    """``matvec_gram(v) -> (w, g)`` for a factor operator ``C (d, f)``:
    ``w = C (C^T v)`` and ``g = w^T w`` from ``ops.matvec_gram`` (the Hopper
    kernel for CUDA tensors, the plain pair for CPU ones). Pass it to
    :func:`dist_subspace_eig` as ``matvec_gram=``."""
    c = c.float().contiguous()

    def matvec_gram(v):
        return matvec_gram_auto(c, v.contiguous())

    return matvec_gram


def lowrank_matvec(u: torch.Tensor, s: torch.Tensor, axis_name=None):
    """``matvec(v) = U diag(max(s, 0)) (U^T v)`` for a low-rank state
    ``U (d, r)``, ``s (r,)`` (row-sharded: ``U``'s rows, the ``(r, k)``
    product summed over ``axis_name``)."""

    def matvec(v):
        y = _psum_if(torch.matmul(u.mT, v), axis_name)
        return torch.matmul(u, torch.clamp(s, min=0.0)[:, None] * y)

    return matvec


def _default_oversample(k: int, width: int) -> int:
    """Extra iterated columns: up to 8, capped by the operator's width."""
    return max(min(8, width - k), 0)


def _scaled_factor_concat(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Scale a factor stack ``c (m, d, kf)`` by the masked-mean weights
    ``sqrt(w / max(sum w, 1))`` and flatten it to ``C (d, m kf)``."""
    cnt = torch.clamp(torch.sum(w), min=1.0)
    c = c * torch.sqrt(w / cnt)[:, None, None]
    return c.permute(1, 0, 2).reshape(c.shape[1], -1)


def dist_merged_top_k(
    v_workers: torch.Tensor,
    k: int,
    *,
    mask=None,
    iters: int = 16,
    v_init=None,
    collectives: str = "xla",
    v0=None,
    oversample: int | None = None,
    tol: float | None = None,
    wire_dtype: str = "fp32",
) -> torch.Tensor:
    """The crossover merge on a ``(workers, features)`` mesh, run by every
    rank inside ``mesh_scope(mesh)``: top-k of the masked mean of the
    workers' projectors, by subspace iteration on ``C C^T``.

    ``v_workers (m_local, d_local, kf)`` are this rank's workers' factors
    (its rows along ``features``) and ``mask (m_local,)`` their mask; both
    are all-gathered over ``workers``, and the solve runs with its rows over
    ``features`` (:func:`dist_subspace_eig`, ``axis_name="features"``), its
    start ``v_init`` the whole ``(d, k')`` block (default: drawn from seed
    0), ``v0`` this rank's rows of a warm basis.
    Returns this rank's ``(d_local, k)`` rows, the same on every workers
    rank; an all-masked round returns zeros. ``collectives="ring"`` gathers
    the factors and the mask over an explicit ring; ``wire_dtype`` (fp32,
    bf16 or int8, with ``collectives="xla"`` only) ships the factor gather
    in that codec (``parallel/wire.py``)."""
    c, w = _gathered_worker_factors(v_workers, mask, collectives, wire_dtype)
    d_local = c.shape[1]
    alive = torch.sum(w) > 0
    cc = _scaled_factor_concat(c, w)
    if oversample is None:
        oversample = _default_oversample(k, cc.shape[1])
    v = dist_subspace_eig(
        factor_matvec(cc, pmesh.FEATURE_AXIS, alive=alive), d_local, k,
        iters=iters, v_init=v_init, device=c.device,
        axis_name=pmesh.FEATURE_AXIS, v0=v0, oversample=oversample, tol=tol,
    )
    return v * alive.to(v.dtype)


def merged_top_k_distributed(
    v_stack: torch.Tensor,
    k: int,
    *,
    mask=None,
    iters: int = 16,
    v_init=None,
    v0=None,
    oversample: int | None = None,
    tol: float | None = None,
) -> torch.Tensor:
    """Top-k of the (masked) mean of the workers' projectors from the
    ``(m, d, kf)`` stack, by subspace iteration on ``C C^T``; an all-masked
    round returns exact zeros. ``v_init (d, k')`` is the start (default:
    drawn from seed 0, on the stack's device)."""
    m = v_stack.shape[0]
    if mask is None:
        w = torch.ones((m,), dtype=torch.float32, device=v_stack.device)
    else:
        w = torch.as_tensor(mask).to(device=v_stack.device, dtype=torch.float32)
    alive = torch.sum(w) > 0
    cc = _scaled_factor_concat(v_stack.float(), w)
    if oversample is None:
        oversample = _default_oversample(k, cc.shape[1])
    v = dist_subspace_eig(
        factor_matvec(cc, alive=alive), v_stack.shape[1], k, iters=iters,
        v_init=v_init, device=v_stack.device, v0=v0,
        oversample=oversample, tol=tol,
    )
    return v * alive.to(v.dtype)


def dist_extract_top_k(
    u: torch.Tensor,
    s: torch.Tensor,
    k: int,
    *,
    iters: int = 16,
    v_init=None,
    axis_name=None,
    oversample: int | None = None,
) -> torch.Tensor:
    """Top-k eigenbasis of ``U diag(s) U^T`` from ``u (d, r)``, ``s (r,)``:
    descending, canonical signs, warm-started from ``u[:, :k]``. With
    ``axis_name`` ``u`` is this rank's rows and so is the result (the
    published basis stays row-sharded)."""
    if oversample is None:
        oversample = _default_oversample(k, u.shape[1])
    return dist_subspace_eig(
        lowrank_matvec(u, s, axis_name), u.shape[0], k, iters=iters,
        v_init=v_init, device=u.device, axis_name=axis_name,
        v0=u[:, :k], oversample=oversample,
    )
