"""Parallel-deflation eigensolve and elastic k, on one device.

Counterpart of ``distributed_eigenspaces_tpu/solvers/deflation.py`` with
the lanes batched on one device (``axis_name=None``):

- :func:`deflation_eig`: the k eigenvector columns split into L equal
  lanes of width kb = k / L that iterate concurrently on one operator. A
  sweep applies the operator once to every lane (a ``(d, k)`` block),
  deflates lane ``l`` by the current estimates of lanes ``j < l`` with the
  strictly lower ``(L, L, kb, kb)`` correction panels, and runs CholeskyQR2
  on each lane; the finish is one cross-lane CholeskyQR2, Rayleigh-Ritz and
  sign canonicalization, so the output contract is
  :func:`~.distributed.dist_subspace_eig`'s.
- :func:`merged_top_k_deflation`: the crossover merge of
  ``solver="deflation"`` (``cfg.uses_deflation_solve()``), the lanes on the
  factor operator ``C C^T`` of the workers' factors.
- :func:`grow_directions` / :func:`grow_basis`: elastic k. Widening a basis
  k -> k' fits only the k' - k new directions against the frozen parent (a
  lane that is always converged); the first k columns of the result are
  the parent's, bit for bit.

Random starts are explicit, as in ``solvers/distributed.py``: the
reference draws ``jax.random.normal(key, (d, k))`` (``PRNGKey(0)`` by
default), which torch cannot reproduce, so every solve takes that block as
``v_init`` (default: drawn from ``torch.Generator().manual_seed(0)``).

``tol`` arms the per-lane stop: a lane whose residual drops below ``tol``
freezes, and the loop ends when every lane froze or at ``iters``. The
reference runs it as a ``lax.while_loop``; here it is a host loop that
reads the ``(L,)`` residual once per sweep, one device sync a sweep, which
the module counter :data:`syncs` counts (``grow_directions``' stop likewise).
Without ``tol`` the loop makes no deliberate sync.

The lanes sharded over a ``components`` mesh axis
(:func:`dist_deflation_eig`, :func:`dist_merged_top_k_deflation`) are not
ported yet (ROADMAP.md Queue 1 item 14).
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.config import _not_ported
from distributed_eigenspaces_tpu_torch.ops.linalg import chol_qr2, initial_basis
from distributed_eigenspaces_tpu_torch.solvers.distributed import (
    _MESH,
    _scaled_factor_concat,
    _single_device,
    _start_device,
    dist_rayleigh_ritz,
    factor_matvec,
    subspace_residual,
)

__all__ = [
    "deflation_eig",
    "dist_deflation_eig",
    "dist_merged_top_k_deflation",
    "grow_basis",
    "grow_directions",
    "merged_top_k_deflation",
]

#: host reads of a residual made by the ``tol`` loops (one per sweep)
syncs = 0


def _lane_widths(k: int, lanes: int) -> int:
    """The equal lane width kb = k / lanes, validated as the reference does."""
    if not isinstance(lanes, int) or lanes < 1:
        raise ValueError(f"lanes must be an int >= 1, got {lanes!r}")
    if lanes > k:
        raise ValueError(
            f"lanes={lanes} exceeds k={k}: each deflation lane owns at "
            "least one eigenvector column"
        )
    if k % lanes:
        raise ValueError(
            f"k={k} must split into {lanes} equal-width lanes "
            "(equal widths keep the correction blocks k x k and the "
            "lane layout static)"
        )
    return k // lanes


def _lanes_to_flat(vs: torch.Tensor) -> torch.Tensor:
    """``(L, d, kb) -> (d, L kb)``, lane ``l`` on columns ``[l kb, (l+1) kb)``."""
    return vs.permute(1, 0, 2).reshape(vs.shape[1], -1)


def _flat_to_lanes(v: torch.Tensor, lanes: int) -> torch.Tensor:
    """Inverse of :func:`_lanes_to_flat`."""
    d, k = v.shape
    return v.reshape(d, lanes, k // lanes).permute(1, 0, 2)


def _lane_residuals(vs: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Per-lane relative invariance residual ``||W_l - V_l (V_l^T W_l)||_F /
    ||W_l||_F`` of lane stacks ``(L, d, kb)``; a dead lane (zero ``W_l``)
    reads 0, converged."""
    s = torch.einsum("ldb,ldc->lbc", vs, ws)
    r = ws - torch.einsum("ldb,lbc->ldc", vs, s)
    rn = torch.sum(r * r, dim=(1, 2))
    wn = torch.sum(ws * ws, dim=(1, 2))
    return torch.sqrt(rn) / torch.sqrt(torch.clamp(wn, min=1e-30))


def _host_residuals(res: torch.Tensor) -> list[float]:
    global syncs
    syncs += 1
    return res.tolist()


def deflation_eig(
    matvec,
    d_local: int,
    k: int,
    *,
    lanes: int,
    iters: int = 16,
    tol: float | None = None,
    v_init=None,
    device=None,
    axis_name=None,
    v0=None,
    with_info: bool = False,
):
    """Top-k invariant subspace by parallel deflation, the ``L = lanes``
    lanes batched as a ``(L, d, kb)`` stack; returns ``(d, k)`` (and
    ``info`` with ``with_info``).

    The start is ``v_init (d, k)`` (default: drawn from seed 0) on
    ``device`` (default: ``v_init``'s or ``v0``'s device, else ``"cuda"``);
    with ``v0 (d, k0)`` it is the reference's warm blend ``(1e-3 /
    sqrt(d)) v_init`` plus ``v0`` on the leading k0 columns. One
    full-width CholeskyQR2 splits it into the lane stack. Each sweep: one
    ``matvec`` of the ``(d, k)`` block, ``W_l -= sum_{j<l} V_j (V_j^T W_l)``,
    the per-lane residuals, CholeskyQR2 per lane. ``tol`` freezes a lane
    once its residual is below it (frozen lower lanes keep feeding their
    corrections) and stops when all froze or at ``iters``; ``info =
    {"iters_used": [int] * L, "residual": [float] * L (nan without tol),
    "lanes": L, "lane_width": kb, "syncs": host residual reads}``."""
    _single_device(axis_name)
    kb = _lane_widths(k, lanes)
    dev = _start_device(device, v_init, v0)
    v = initial_basis(d_local, k, device=dev, v0=v_init)
    if tuple(v.shape) != (d_local, k):
        raise ValueError(f"v_init must be ({d_local}, {k}), got {tuple(v.shape)}")
    if v0 is not None:
        v0 = torch.as_tensor(v0, dtype=torch.float32).to(dev)
        scale = 1e-3 * torch.rsqrt(torch.tensor(float(d_local), dtype=torch.float32))
        v = scale.to(dev) * v
        v[:, : v0.shape[1]] += v0
    vs = _flat_to_lanes(chol_qr2(v), lanes)
    idx = torch.arange(lanes, device=dev)
    lower = (idx[:, None] < idx[None, :]).to(torch.float32)[:, :, None, None]

    def sweep(vs, active):
        # one operator application covers every lane (columns independent)
        ws = _flat_to_lanes(matvec(_lanes_to_flat(vs)), lanes)
        coef = torch.einsum("jdb,ldc->jlbc", vs, ws) * lower
        ws = ws - torch.einsum("jdb,jlbc->ldc", vs, coef)
        res = _lane_residuals(vs, ws)
        vn = chol_qr2(ws)
        if active is None:
            return vn, res
        return torch.where(active[:, None, None], vn, vs), res

    syncs0 = syncs
    if tol is None:
        for _ in range(iters):
            vs = sweep(vs, None)[0]
        iters_used = [iters] * lanes
        residual = [float("nan")] * lanes
    else:
        iters_used = [0] * lanes
        residual = [float("inf")] * lanes
        res = torch.full((lanes,), float("inf"), device=dev)
        for _ in range(iters):
            if not any(r > tol for r in residual):
                break
            vs, res = sweep(vs, res > tol)
            iters_used = [u + (r > tol) for u, r in zip(iters_used, residual)]
            residual = _host_residuals(res)
    flat = chol_qr2(_lanes_to_flat(vs))
    out = dist_rayleigh_ritz(flat, matvec(flat))[:, :k]
    if with_info:
        return out, {"iters_used": iters_used, "residual": residual,
                     "lanes": lanes, "lane_width": kb, "syncs": syncs - syncs0}
    return out


def dist_deflation_eig(*args, **kwargs):
    """The lanes sharded over the ``components`` mesh axis: not ported yet."""
    raise _not_ported("dist_deflation_eig (lanes over a components mesh axis)", _MESH)


def merged_top_k_deflation(
    v_stack: torch.Tensor,
    k: int,
    *,
    lanes: int,
    mask=None,
    iters: int = 16,
    tol: float | None = None,
    v_init=None,
    v0=None,
    with_info: bool = False,
):
    """Top-k of the (masked) mean of the workers' projectors from the
    ``(m, d, kf)`` factor stack by parallel-deflation lanes on ``C C^T``,
    the ``solver="deflation"`` twin of
    :func:`~.distributed.merged_top_k_distributed`: an all-masked round
    returns exact zeros. ``v_init (d, k)`` is the start (default: drawn
    from seed 0, on the stack's device), ``v0`` the warm basis; with
    ``with_info`` it returns ``(v, info)`` as :func:`deflation_eig`."""
    m = v_stack.shape[0]
    if mask is None:
        w = torch.ones((m,), dtype=torch.float32, device=v_stack.device)
    else:
        w = torch.as_tensor(mask).to(device=v_stack.device, dtype=torch.float32)
    alive = torch.sum(w) > 0
    cc = _scaled_factor_concat(v_stack.float(), w)
    out = deflation_eig(
        factor_matvec(cc, alive=alive), v_stack.shape[1], k, lanes=lanes,
        iters=iters, tol=tol, v_init=v_init, device=v_stack.device, v0=v0,
        with_info=with_info,
    )
    if with_info:
        v, info = out
        return v * alive.to(v.dtype), info
    return out * alive.to(out.dtype)


def dist_merged_top_k_deflation(*args, **kwargs):
    """The deflation merge on the ``(workers, features)`` mesh: not ported yet."""
    raise _not_ported("dist_merged_top_k_deflation (the mesh deflation merge)", _MESH)


def grow_directions(
    matvec,
    v_parent: torch.Tensor,
    k_new: int,
    *,
    iters: int = 16,
    tol: float | None = None,
    v_init=None,
    axis_name=None,
    with_info: bool = False,
):
    """Fit ``k_new`` directions orthogonal to a frozen parent basis
    ``v_parent (d, k0)``: subspace iteration on the operator deflated by
    the parent (``W -= V_p (V_p^T W)`` every sweep, a k0 x k_new
    correction), so the new block converges to eigenpairs ``k0+1 ..
    k0+k_new``. The start is ``v_init (d, k_new)`` (default: drawn from
    seed 0, on the parent's device). ``tol`` stops once
    :func:`~.distributed.subspace_residual` is below it; the finish
    deflates the block once more and orthonormalizes it (keeping it
    orthogonal to the parent to fp32 rounding), then Rayleigh-Ritz of the
    new block on the deflated operator: descending, canonical signs. ``info = {"iters_used": int, "residual": float,
    "syncs": host residual reads}``."""
    global syncs
    _single_device(axis_name)
    v_parent = torch.as_tensor(v_parent, dtype=torch.float32)
    d_local = v_parent.shape[0]
    v = initial_basis(d_local, k_new, device=v_parent.device, v0=v_init)
    if tuple(v.shape) != (d_local, k_new):
        raise ValueError(f"v_init must be ({d_local}, {k_new}), got {tuple(v.shape)}")

    def deflate(w):
        return w - torch.matmul(v_parent, torch.matmul(v_parent.mT, w))

    v = chol_qr2(deflate(v))

    def sweep(vi):
        w = deflate(matvec(vi))
        return w, chol_qr2(w)

    syncs0 = syncs
    iters_used, res = iters, float("nan")
    if tol is None:
        for _ in range(iters):
            v = sweep(v)[1]
    else:
        iters_used, res = 0, float("inf")
        while iters_used < iters and res > tol:
            w, vn = sweep(v)
            res = float(subspace_residual(v, w))
            syncs += 1
            v, iters_used = vn, iters_used + 1
    # one more pass against the parent before the finish: where the new
    # eigenvalues sit near fp32 rounding of the parent's (a grow on
    # sigma_tilde, whose spectrum past k is ~1e-6), one deflation leaves the
    # block ~1e-4 off orthogonal to the parent, a second leaves ~1e-7 (the
    # reference finishes after one: ROADMAP.md Queue 3)
    v = chol_qr2(deflate(v))
    out = dist_rayleigh_ritz(v, deflate(matvec(v)))
    if with_info:
        return out, {"iters_used": iters_used, "residual": res, "syncs": syncs - syncs0}
    return out


def grow_basis(
    matvec,
    v_parent,
    k_prime: int,
    *,
    iters: int = 16,
    tol: float | None = None,
    v_init=None,
    axis_name=None,
    with_info: bool = False,
):
    """Widen a converged parent basis ``(d, k0)`` to ``(d, k_prime)`` by
    fitting only the ``k_prime - k0`` new directions
    (:func:`grow_directions`, ``v_init (d, k_prime - k0)``) and
    concatenating: the first k0 columns of the result are the parent, bit
    for bit. Publish it with ``EigenbasisRegistry.publish_grown``."""
    v_parent = torch.as_tensor(v_parent, dtype=torch.float32)
    k0 = v_parent.shape[1]
    if not k0 < k_prime:
        raise ValueError(
            f"grow_basis needs k_prime > parent k, got k_prime="
            f"{k_prime} vs parent k={k0} (shrinking is a slice, not a "
            "fit)"
        )
    new = grow_directions(
        matvec, v_parent, k_prime - k0, iters=iters, tol=tol, v_init=v_init,
        axis_name=axis_name, with_info=with_info,
    )
    if with_info:
        new, info = new
        return torch.cat([v_parent, new], dim=1), info
    return torch.cat([v_parent, new], dim=1)
