"""Blocked subspace eigensolves from matvec access only, on one device.

Counterpart of ``distributed_eigenspaces_tpu/solvers/distributed.py`` at
``axis_name=None`` (the reference's single-device / root-tier degenerate):

- :func:`dist_subspace_eig`: blocked subspace iteration on a symmetric PSD
  operator, orthonormalized by CholeskyQR2 and finished by one
  Rayleigh-Ritz solve; ``oversample``, ``tol``, ``with_info`` and the
  fused ``matvec_gram`` sweep as in the reference.
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
by default). Without it the block is drawn from
``torch.Generator().manual_seed(0)`` on the CPU
(:func:`~..ops.linalg.initial_basis`), the same start on every device;
the trainers pass one drawn from ``cfg.seed`` (``algo.step.merge_start``).
A sharded ``axis_name`` and the mesh merge (``dist_merged_top_k``) are not
ported yet (ROADMAP.md Queue 1 item 14).
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.config import _not_ported
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

_MESH = "Queue 1 item 14 (mesh and round collectives)"


def _single_device(axis_name) -> None:
    if axis_name is not None:
        raise _not_ported(f"the row-sharded solve (axis_name={axis_name!r})", _MESH)


def dist_canonicalize_signs(v: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Flip each column so its largest-|entry| element is positive."""
    _single_device(axis_name)
    return canonicalize_signs(v)


def dist_rayleigh_ritz(v: torch.Tensor, av: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Rotate an orthonormal ``v (d, k)`` to eigenvector coordinates given
    ``av = A v``: descending, canonical signs. On one device this is
    ``ops.linalg.rayleigh_ritz`` (the reference's ``_small_eigh_desc`` of
    the symmetrized ``v^T A v``, then the rotation)."""
    _single_device(axis_name)
    return rayleigh_ritz(v, av)


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
    (``nan`` without ``tol``)."""
    _single_device(axis_name)
    kk = k + max(int(oversample), 0)
    v = initial_basis(d_local, kk, device=_start_device(device, v_init, v0), v0=v_init)
    if tuple(v.shape) != (d_local, kk):
        raise ValueError(f"v_init must be ({d_local}, {kk}), got {tuple(v.shape)}")
    if v0 is not None:
        scale = 1e-3 * torch.rsqrt(torch.tensor(float(d_local), dtype=torch.float32))
        v = scale.to(v.device) * v
        v[:, :k] += torch.as_tensor(v0, dtype=torch.float32, device=v.device)
    v = chol_qr2(v)

    if matvec_gram is None:

        def sweep(vi):
            w = matvec(vi)
            return w, chol_qr2(w)

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
            res = float(subspace_residual(v, w))
            v, iters_used = vn, iters_used + 1
    out = dist_rayleigh_ritz(v, matvec(v))[:, :k]
    if with_info:
        return out, {"iters_used": iters_used, "residual": res}
    return out


def subspace_residual(v: torch.Tensor, w: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Relative invariance residual ``||W - V (V^T W)||_F / ||W||_F`` of an
    orthonormal ``v (d, k')`` given ``w = A v``; zero for a zero ``w``."""
    _single_device(axis_name)
    s = torch.matmul(v.mT, w)
    r = w - torch.matmul(v, s)
    rn = torch.sum(r * r)
    wn = torch.sum(w * w)
    return torch.sqrt(rn) / torch.sqrt(torch.clamp(wn, min=1e-30))


def factor_matvec(c: torch.Tensor, axis_name=None, alive=None):
    """``matvec(v) = C (C^T v)`` for a factor concatenation ``C (d, f)``.
    ``alive`` (a bool tensor) guards the all-masked merge: a dead operator
    acts as the identity, so CholeskyQR2 never sees a zero Gram, and the
    caller zeroes the result."""
    _single_device(axis_name)

    def matvec(v):
        out = torch.matmul(c, torch.matmul(c.mT, v))
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
    ``U (d, r)``, ``s (r,)``."""
    _single_device(axis_name)

    def matvec(v):
        y = torch.matmul(u.mT, v)
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


def dist_merged_top_k(*args, **kwargs):
    """The merge on the ``(workers, features)`` mesh: not ported yet."""
    raise _not_ported("dist_merged_top_k (the mesh merge)", _MESH)


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
    descending, canonical signs, warm-started from ``u[:, :k]``."""
    if oversample is None:
        oversample = _default_oversample(k, u.shape[1])
    return dist_subspace_eig(
        lowrank_matvec(u, s, axis_name), u.shape[0], k, iters=iters,
        v_init=v_init, device=u.device, axis_name=axis_name,
        v0=u[:, :k], oversample=oversample,
    )
