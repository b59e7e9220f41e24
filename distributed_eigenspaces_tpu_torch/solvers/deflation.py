"""Parallel-deflation eigensolve and elastic k.

Counterpart of ``distributed_eigenspaces_tpu/solvers/deflation.py``: the
lanes batched on one device, their rows optionally sharded over an
``axis_name`` (inside ``parallel.mesh.mesh_scope``), or one lane a rank on
a ``components`` mesh axis:

- :func:`deflation_eig`: the k eigenvector columns split into L equal
  lanes of width kb = k / L that iterate concurrently on one operator. A
  sweep applies the operator once to every lane (a ``(d, k)`` block),
  deflates lane ``l`` by the current estimates of lanes ``j < l`` with the
  strictly lower ``(L, L, kb, kb)`` correction panels, and runs CholeskyQR2
  on each lane; the finish is one cross-lane CholeskyQR2, Rayleigh-Ritz and
  sign canonicalization, so the output contract is
  :func:`~.distributed.dist_subspace_eig`'s.
- :func:`dist_deflation_eig`: the same schedule with the lanes sharded over
  ``components`` (``make_component_mesh``), one lane a rank, rows over
  ``features``: each sweep all-gathers the ``(d_local, kb)`` lane blocks
  over ``components`` and sums the ``kb x kb`` panels over ``features``.
- :func:`dist_merged_top_k_deflation`: the deflation merge on a
  ``(workers, features)`` mesh.
- :func:`merged_top_k_deflation`: the crossover merge of
  ``solver="deflation"`` (``cfg.uses_deflation_solve()``), the lanes on the
  factor operator ``C C^T`` of the workers' factors.
- :func:`grow_directions` / :func:`grow_basis`: elastic k. Widening a basis
  k -> k' fits only the k' - k new directions against the frozen parent (a
  lane that is always converged); the first k columns of the result are
  the parent's, bit for bit.

Random starts are explicit, as in ``solvers/distributed.py``: the
reference draws ``jax.random.normal(key, (d, k))`` (``PRNGKey(0)`` by
default; per row shard and per lane from ``fold_in`` on a mesh), which
torch cannot reproduce, so every solve takes this rank's rows of the start
as ``v_init`` (default: those rows drawn from seed 0 by
``ops.linalg.start_rows``, never the whole block), and on a
``components`` axis each rank takes its lane's columns of them.

``tol`` arms the per-lane stop: a lane whose residual drops below ``tol``
freezes, and the loop ends when every lane froze or at ``iters``. The
reference runs it as a ``lax.while_loop``; here it is a host loop that
reads the ``(L,)`` residual once per sweep, one device sync a sweep, which
the module counter :data:`syncs` counts (``grow_directions``' stop likewise).
Without ``tol`` the loop makes no deliberate sync. On a mesh the residuals
it reads are already summed over ``features`` (and, for the sharded lanes,
their max taken over ``components``), so every rank stops on the same
sweep.
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import _psum_if
from distributed_eigenspaces_tpu_torch.parallel.wire import WIRE_DTYPES, wire_all_gather
from distributed_eigenspaces_tpu_torch.solvers.distributed import (
    _gathered_worker_factors,
    _qr2,
    _row_start,
    _scaled_factor_concat,
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


def _lane_residuals(vs: torch.Tensor, ws: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Per-lane relative invariance residual ``||W_l - V_l (V_l^T W_l)||_F /
    ||W_l||_F`` of lane stacks ``(L, d, kb)`` (``kb x kb`` and scalar sums
    over ``axis_name``); a dead lane (zero ``W_l``) reads 0, converged."""
    s = _psum_if(torch.einsum("ldb,ldc->lbc", vs, ws), axis_name)
    r = ws - torch.einsum("ldb,lbc->ldc", vs, s)
    rn = _psum_if(torch.sum(r * r, dim=(1, 2)), axis_name)
    wn = _psum_if(torch.sum(ws * ws, dim=(1, 2)), axis_name)
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

    The start is ``v_init (d, k)`` (default: drawn from seed 0 by
    ``ops.linalg.start_rows``) on ``device`` (default: ``v_init``'s or ``v0``'s device, else ``"cuda"``);
    with ``v0 (d, k0)`` it is the reference's warm blend ``(1e-3 /
    sqrt(d)) v_init`` plus ``v0`` on the leading k0 columns. One
    full-width CholeskyQR2 splits it into the lane stack. Each sweep: one
    ``matvec`` of the ``(d, k)`` block, ``W_l -= sum_{j<l} V_j (V_j^T W_l)``,
    the per-lane residuals, CholeskyQR2 per lane. ``tol`` freezes a lane
    once its residual is below it (frozen lower lanes keep feeding their
    corrections) and stops when all froze or at ``iters``; ``info =
    {"iters_used": [int] * L, "residual": [float] * L (nan without tol),
    "lanes": L, "lane_width": kb, "syncs": host residual reads}``.

    With ``axis_name`` (inside ``mesh_scope``) the rows are this rank's
    share: ``matvec`` maps rows to rows, ``v_init`` is this rank's
    ``(d_local, k)`` rows of the start, ``v0`` this rank's rows, and the correction panels,
    residuals and Grams are summed over the axis."""
    kb = _lane_widths(k, lanes)
    dev = _start_device(device, v_init, v0)
    v = _row_start(v_init, d_local, k, axis_name, dev)
    if v0 is not None:
        v0 = torch.as_tensor(v0, dtype=torch.float32).to(dev)
        d_total = d_local * (1 if axis_name is None else pmesh.axis_size(axis_name))
        scale = 1e-3 * torch.rsqrt(torch.tensor(float(d_total), dtype=torch.float32))
        v = scale.to(dev) * v
        v[:, : v0.shape[1]] += v0
    vs = _flat_to_lanes(_qr2(v, axis_name), lanes)
    idx = torch.arange(lanes, device=dev)
    lower = (idx[:, None] < idx[None, :]).to(torch.float32)[:, :, None, None]

    def sweep(vs, active):
        # one operator application covers every lane (columns independent)
        ws = _flat_to_lanes(matvec(_lanes_to_flat(vs)), lanes)
        coef = _psum_if(torch.einsum("jdb,ldc->jlbc", vs, ws), axis_name) * lower
        ws = ws - torch.einsum("jdb,jlbc->ldc", vs, coef)
        res = _lane_residuals(vs, ws, axis_name)
        vn = _qr2(ws, axis_name)
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
    flat = _qr2(_lanes_to_flat(vs), axis_name)
    out = dist_rayleigh_ritz(flat, matvec(flat), axis_name)[:, :k]
    if with_info:
        return out, {"iters_used": iters_used, "residual": residual,
                     "lanes": lanes, "lane_width": kb, "syncs": syncs - syncs0}
    return out


def dist_deflation_eig(
    matvec,
    d_local: int,
    k: int,
    *,
    lanes: int,
    iters: int = 16,
    tol: float | None = None,
    v_init=None,
    device=None,
    lane_axis: str = pmesh.COMPONENT_AXIS,
    axis_name=pmesh.FEATURE_AXIS,
    v0=None,
    with_info: bool = False,
    wire_dtype: str = "fp32",
):
    """:func:`deflation_eig` with the lanes sharded over ``lane_axis``, run
    by every rank of a ``(components, features)`` mesh inside
    ``mesh_scope(mesh)`` (``make_component_mesh``), one lane of width
    ``kb = k / lanes`` a components rank; ``lanes`` must be that axis's
    size. Returns this rank's ``(d_local, k)`` rows of the whole basis, the
    same on every components rank.

    Each sweep all-gathers the ``(d_local, kb)`` lane blocks over
    ``lane_axis``, applies ``matvec`` (this rank's rows to rows) to this
    lane, subtracts the corrections from the lanes below with ``kb x kb``
    panels summed over ``axis_name``, and runs this lane's CholeskyQR2. The
    finish gathers the lanes once more, then CholeskyQR2 across lanes and
    the shared Rayleigh-Ritz.

    The start is this lane's columns of ``v_init``, this rank's ``(d_local,
    k)`` rows of the start (default: those rows drawn from seed 0), or this
    lane's
    ``(d_local, kb)`` seed block ``v0``. ``tol`` freezes this lane once its
    residual is below it while lower lanes keep correcting; the loop runs
    until the largest residual over ``lane_axis`` (one ``pmax`` a sweep,
    read on the host, the same on every rank) is below ``tol``, or
    ``iters``. ``info`` holds this lane's own ``iters_used`` and
    ``residual``. ``wire_dtype`` (fp32, bf16 or int8) ships the lane
    gathers, each sweep's and the finishing one, in that codec
    (``parallel/wire.py``; one-shot lossy, every sum stays fp32)."""
    global syncs

    def lane_gather(x):
        return wire_all_gather(x, lane_axis, wire_dtype, tiled=False)

    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire_dtype!r}; one of {WIRE_DTYPES}")
    kb = _lane_widths(k, lanes)
    if pmesh.axis_size(lane_axis) != lanes:
        raise ValueError(
            f"lanes={lanes} must equal the {lane_axis!r} axis size "
            f"{pmesh.axis_size(lane_axis)} (one lane a rank)"
        )
    my = pmesh.axis_index(lane_axis)
    dev = _start_device(device, v_init, v0)
    if v0 is not None:
        v = _qr2(torch.as_tensor(v0, dtype=torch.float32).to(dev), axis_name)
    else:
        v = _row_start(v_init, d_local, k, axis_name, dev)
        v = _qr2(v[:, my * kb:(my + 1) * kb].contiguous(), axis_name)
    below = (torch.arange(lanes, device=dev) < my).to(torch.float32)[:, None, None]

    def sweep(v, active: bool):
        vs = lane_gather(v)  # (L, d_local, kb)
        w = matvec(v)
        coef = _psum_if(torch.einsum("jdb,dc->jbc", vs, w), axis_name) * below
        w = w - torch.einsum("jdb,jbc->dc", vs, coef)
        # this lane's residual: kb-wide and scalar sums over the rows
        s = _psum_if(torch.matmul(v.mT, w), axis_name)
        r = w - torch.matmul(v, s)
        rn = _psum_if(torch.sum(r * r), axis_name)
        wn = _psum_if(torch.sum(w * w), axis_name)
        res = torch.sqrt(rn) / torch.sqrt(torch.clamp(wn, min=1e-30))
        vn = _qr2(w, axis_name)
        return (vn if active else v), res

    syncs0 = syncs
    if tol is None:
        for _ in range(iters):
            v = sweep(v, True)[0]
        iters_used, residual = iters, float("nan")
    else:
        iters_used, residual, worst = 0, float("inf"), float("inf")
        for _ in range(iters):
            if not worst > tol:
                break
            active = residual > tol
            v, res = sweep(v, active)
            iters_used += int(active)
            residual, worst = _host_residuals(
                torch.stack([res, pmesh.pmax(res, lane_axis)]))
    vs = lane_gather(v)  # the finishing gather
    flat = _qr2(_lanes_to_flat(vs), axis_name)
    out = dist_rayleigh_ritz(flat, matvec(flat), axis_name)[:, :k]
    if with_info:
        return out, {"iters_used": iters_used, "residual": residual,
                     "lanes": lanes, "lane_width": kb, "syncs": syncs - syncs0}
    return out


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


def dist_merged_top_k_deflation(
    v_workers: torch.Tensor,
    k: int,
    *,
    lanes: int,
    mask=None,
    iters: int = 16,
    tol: float | None = None,
    v_init=None,
    collectives: str = "xla",
    v0=None,
    wire_dtype: str = "fp32",
    with_info: bool = False,
):
    """The deflation merge on a ``(workers, features)`` mesh, run by every
    rank inside ``mesh_scope(mesh)``: the factors ``v_workers (m_local,
    d_local, kf)`` and ``mask (m_local,)`` all-gathered over ``workers`` as
    in :func:`~.distributed.dist_merged_top_k`, then the lanes batched on
    each rank (:func:`deflation_eig`) with the rows over ``features``.
    Returns this rank's ``(d_local, k)`` rows; an all-masked round returns
    zeros. ``collectives`` and ``wire_dtype`` choose how the factors are
    gathered, as in ``dist_merged_top_k``; ``v_init`` is this rank's
    ``(d_local, k)`` rows of the start."""
    c, w = _gathered_worker_factors(v_workers, mask, collectives, wire_dtype)
    alive = torch.sum(w) > 0
    cc = _scaled_factor_concat(c, w)
    out = deflation_eig(
        factor_matvec(cc, pmesh.FEATURE_AXIS, alive=alive), c.shape[1], k,
        lanes=lanes, iters=iters, tol=tol, v_init=v_init, device=c.device,
        axis_name=pmesh.FEATURE_AXIS, v0=v0, with_info=with_info,
    )
    if with_info:
        v, info = out
        return v * alive.to(v.dtype), info
    return out * alive.to(out.dtype)


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
    "syncs": host residual reads}``. With ``axis_name`` the parent,
    ``matvec``, ``v_init`` and the result are this rank's rows, and the ``k0 x k_new`` correction is summed over the axis."""
    global syncs
    v_parent = torch.as_tensor(v_parent, dtype=torch.float32)
    d_local = v_parent.shape[0]
    v = _row_start(v_init, d_local, k_new, axis_name, v_parent.device)

    def deflate(w):
        return w - torch.matmul(
            v_parent, _psum_if(torch.matmul(v_parent.mT, w), axis_name))

    v = _qr2(deflate(v), axis_name)

    def sweep(vi):
        w = deflate(matvec(vi))
        return w, _qr2(w, axis_name)

    syncs0 = syncs
    iters_used, res = iters, float("nan")
    if tol is None:
        for _ in range(iters):
            v = sweep(v)[1]
    else:
        iters_used, res = 0, float("inf")
        while iters_used < iters and res > tol:
            w, vn = sweep(v)
            res = float(subspace_residual(v, w, axis_name))
            syncs += 1
            v, iters_used = vn, iters_used + 1
    # one more pass against the parent before the finish: where the new
    # eigenvalues sit near fp32 rounding of the parent's (a grow on
    # sigma_tilde, whose spectrum past k is ~1e-6), one deflation leaves the
    # block ~1e-4 off orthogonal to the parent, a second leaves ~1e-7 (the
    # reference finishes after one: ROADMAP.md Queue 3)
    v = _qr2(deflate(v), axis_name)
    out = dist_rayleigh_ritz(v, deflate(matvec(v)), axis_name)
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
