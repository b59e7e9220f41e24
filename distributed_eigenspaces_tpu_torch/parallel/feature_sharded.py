"""Feature-sharded online PCA: the rank-r and Nystrom-sketch trainers.

Counterpart of ``distributed_eigenspaces_tpu/parallel/feature_sharded.py``.
The feature dimension ``d`` is split over the ``features`` axis of a
``(workers, features)`` mesh of ranks (``parallel/mesh.py``) and no
``d x d`` matrix exists anywhere:

- per-worker top-k eigenspaces by block power iteration whose matvec is
  ``X^T (X V) / n`` with ``X`` column-sharded; the ``(m, n, k)`` inner
  product is summed over ``features``;
- CholeskyQR2 with its ``k x k`` Gram summed over ``features``;
- the worker merge exact from the factors (``merged_lowrank_sharded``: an
  all-gather over ``workers``, an ``(m k)^2`` Gram summed over
  ``features``, one replicated ``eigh``), or the crossover merges of
  ``solvers/`` with ``axis_name="features"``;
- the online state as a rank-r factorization ``U S U^T``
  (:class:`LowRankState`), or the sketch trainer's Nystrom sketch
  (:class:`SketchState`), whose steady state runs no eigensolve at all.

Every rank runs the same code inside ``parallel.mesh.mesh_scope(mesh)``;
each holds its workers' columns of a block, its rows of ``U`` / ``y`` /
``v``, and the replicated small matrices (``s``, the step count), so each
takes the same host branches. One process with no group is the ``(1, 1)``
layout (``parallel.mesh.local_mesh``): every collective is the identity.
The reference's on-device ``lax.cond`` dispatches (cold or warm step, merge
or fold round, the sketch's masked cold/warm choice) are host branches on
those replicated values.

Random starts are explicit. The reference draws each feature shard's
start from ``fold_in(key, axis_index)``, bits torch cannot draw; here the
whole start is one draw from ``torch.Generator().manual_seed(seed)`` on
the CPU and each rank takes its rows, so a result does not depend on the
number of feature shards (the reference's does). The draws: the worker
solves' ``(m, d, k)`` start ``v_rand`` (every step starts from the same
noise, as the reference's fixed key does), the sketch's ``(d, p)`` test
matrix ``omega``, and the crossover merge's ``(d, k')`` ``v_init``
(``algo.step.merge_start``, drawn by ``ops.linalg.start_rows``: each rank
draws only its rows); each can be passed in instead.

A bf16 product takes bf16 operands and returns fp32 (``torch.bmm(...,
out_dtype=torch.float32)`` on the card; widened operands on the CPU,
which is exact): the ``(m, n, k)`` partial is summed over ``features``
in fp32, then rounded to bf16 for the second product, as the reference
rounds it. An int8 block stays int8 in device memory and is widened to
bf16 inside each matvec.

``collectives="ring"`` (the factories' argument, ``cfg.collectives`` from
the estimator) sends every switchable reduction through the explicit rings
of ``parallel/ring.py`` instead of the process group's collectives: the
matvec's ``(m, n, k)`` sum over ``features``, the merge's factor and mask
gathers over ``workers`` and ``features`` and its Gram sum, the
between-merge fold's gathers, the crossover merges' worker gather, and the
sketch's fold and power-step sums (:func:`_collective_ops`, as the
reference's). CholeskyQR2, Newton-Schulz and the rank-r update keep the
group's sum, as in the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype
from distributed_eigenspaces_tpu_torch.ops import cusolver
from distributed_eigenspaces_tpu_torch.ops.linalg import (
    _sym,
    chol_apply,
    guarded_inv_sqrt,
    top_k_eigvecs,
)
from distributed_eigenspaces_tpu_torch.ops.linalg import ns_orth as _ns_orth
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel.mesh import (
    FEATURE_AXIS,
    WORKER_AXIS,
    psum,
)
from distributed_eigenspaces_tpu_torch.utils.guards import checked


def _psum_if(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``x`` summed over the ranks of ``axis_name``, or ``x`` itself."""
    return psum(x, axis_name) if axis_name else x


def _chol_qr(v: torch.Tensor, axis_name, eps: float = 1e-7) -> torch.Tensor:
    """One CholeskyQR pass on a row-sharded ``v``: the Gram reduced over
    ``axis_name``, then the same Cholesky and triangular solve on every
    rank's rows."""
    g = _psum_if(torch.matmul(v.mT, v), axis_name)
    return chol_apply(v, g, eps)


def chol_qr2(v: torch.Tensor, axis_name=None) -> torch.Tensor:
    """CholeskyQR2 of a row-sharded block: two passes, jitter ``1e-7 *
    trace`` (``ops.linalg.chol_qr2`` when ``axis_name`` is None)."""
    return _chol_qr(_chol_qr(v, axis_name), axis_name)


def _small_eigh_desc(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``eigh`` of a small replicated symmetric matrix, descending."""
    w, q = cusolver.eigh(_sym(g))
    return torch.flip(w, dims=(-1,)), torch.flip(q, dims=(-1,))


def ns_orth(v: torch.Tensor, axis_name=None, iters: int = 4,
            eps: float = 1e-20) -> torch.Tensor:
    """Newton-Schulz orthonormalization of a row-sharded block: every
    ``k x k`` Gram summed over ``axis_name`` (``ops.linalg.ns_orth``)."""
    return _ns_orth(v, iters=iters, eps=eps,
                    reduce=lambda t: _psum_if(t, axis_name))


def _psum_f(x: torch.Tensor) -> torch.Tensor:
    return psum(x, FEATURE_AXIS)


def _collective_ops(collectives: str):
    """``(psum, gather)``, each taking ``(tensor, axis_name)``: the process
    group's (``"xla"``) or the explicit rings (``"ring"``). Every
    collectives-switchable reduction of this module goes through here."""
    if collectives == "ring":
        from distributed_eigenspaces_tpu_torch.parallel.ring import (
            ring_all_gather,
            ring_psum,
        )

        return ring_psum, ring_all_gather
    if collectives != "xla":
        raise ValueError(f"unknown collectives mode: {collectives!r}")
    return psum, pmesh.all_gather




# -- states -------------------------------------------------------------------


class LowRankState(NamedTuple):
    """Rank-r factorization of the running average, ``sigma_tilde ~= U S
    U^T``: ``u`` this rank's ``(d_local, r)`` rows (orthonormal columns
    globally), ``s`` the ``(r,)`` eigenvalues (descending, replicated),
    ``step`` the 1-based round count (a host int)."""

    u: torch.Tensor
    s: torch.Tensor
    step: int

    @classmethod
    def initial(cls, dim: int, rank: int, *, device="cuda") -> "LowRankState":
        dev = resolve_device(device)
        return cls(u=torch.zeros((dim, rank), dtype=torch.float32, device=dev),
                   s=torch.zeros((rank,), dtype=torch.float32, device=dev), step=0)


class SketchState(NamedTuple):
    """Carry of the sketch trainer: ``y`` the Nystrom sketch ``sigma_tilde
    @ omega`` ``(d_local, p)``, ``v`` the previous merged top-k basis
    ``(d_local, k)`` (both this rank's rows), ``step`` the round count."""

    y: torch.Tensor
    v: torch.Tensor
    step: int

    @classmethod
    def initial(cls, dim: int, k: int, p: int, *, device="cuda") -> "SketchState":
        dev = resolve_device(device)
        return cls(y=torch.zeros((dim, p), dtype=torch.float32, device=dev),
                   v=torch.zeros((dim, k), dtype=torch.float32, device=dev), step=0)


#: the row-sharded fields of each state (the rest are replicated)
ROW_FIELDS = {LowRankState: ("u",), SketchState: ("y", "v")}


def gather_state(state):
    """The whole state from every rank's rows: each row-sharded field
    all-gathered over ``features`` (inside ``mesh_scope``); in one process
    the state itself."""
    rows = ROW_FIELDS[type(state)]
    return state._replace(**{f: pmesh.all_gather(getattr(state, f), FEATURE_AXIS)
                             for f in rows})


def shard_state(mesh, state):
    """This rank's rows of a whole state (its inverse: a restored
    checkpoint placed on a features mesh), on the mesh's device."""
    rows = ROW_FIELDS[type(state)]
    out = {}
    for f in state._fields:
        val = getattr(state, f)
        if f in rows:
            val = val[pmesh.feature_rows(mesh, val.shape[0])]
        out[f] = val.to(mesh.device) if isinstance(val, torch.Tensor) else val
    return type(state)(**out)


# -- placement ----------------------------------------------------------------


def _mesh_of(mesh, device):
    return pmesh.local_mesh(device) if mesh is None else mesh


def place_block(mesh, x, m: int, d: int) -> torch.Tensor:
    """This rank's ``(..., m_local, n, d_local)`` share of a block on the
    mesh's device: sliced from a block holding all ``m`` workers and all
    ``d`` features, or placed as it is when it is this rank's share
    already. The worker axis is the one before the last two."""
    wrows = pmesh.worker_rows(mesh, m)
    frows = pmesh.feature_rows(mesh, d)
    shape = tuple(x.shape)
    if shape[-3] == m and shape[-1] == d:
        x = x[..., wrows, :, :][..., frows]
    elif (shape[-3], shape[-1]) != (wrows.stop - wrows.start, frows.stop - frows.start):
        raise ValueError(
            f"block of shape {shape}: want all {m} workers x {d} features, "
            f"or this rank's {wrows.stop - wrows.start} x {frows.stop - frows.start}"
        )
    return torch.as_tensor(x).to(mesh.device)


def _mask_rows(mesh, mask, m: int):
    """``(m_local,)`` float32 rows of a whole ``(m,)`` mask, and whether any
    worker of the whole mask is live (every rank holds the whole mask, so
    every rank reads the same answer)."""
    if mask is None:
        return None, True
    mk = np.asarray(mask.detach().cpu() if isinstance(mask, torch.Tensor) else mask,
                    np.float32)
    if mk.shape != (m,):
        raise ValueError(f"worker mask shape {mk.shape} != (num_workers={m},)")
    local = torch.from_numpy(mk[pmesh.worker_rows(mesh, m)].copy()).to(mesh.device)
    return local, bool(np.any(mk))


def _draw(seed: int, shapes) -> list[torch.Tensor]:
    """Standard-normal float32 draws of ``shapes``, in order, from one
    ``torch.Generator().manual_seed(seed)`` on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen, dtype=torch.float32) for s in shapes]


def _rows_of(mesh, whole, shape, what: str) -> torch.Tensor:
    """This rank's rows (and workers, for a 3-D start) of a whole start."""
    whole = torch.as_tensor(whole, dtype=torch.float32)
    if tuple(whole.shape) != tuple(shape):
        raise ValueError(f"{what} must be {tuple(shape)}, got {tuple(whole.shape)}")
    frows = pmesh.feature_rows(mesh, shape[-2])
    if whole.dim() == 3:
        whole = whole[pmesh.worker_rows(mesh, shape[0])]
    return whole[..., frows, :].contiguous().to(mesh.device)


# -- the sharded pieces ---------------------------------------------------------


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32: fp32 operands as they are; bf16 ones through
    ``torch.bmm(..., out_dtype=torch.float32)`` on the card, widened (an
    exact cast) on the CPU."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _make_matvec(x: torch.Tensor, n_total_rows: int, compute_dtype=None,
                 collectives: str = "xla"):
    """``matvec(v) = X^T (X v) / n`` with the feature dim sharded, batched
    over the local workers: ``x (m_local, n, d_local)``, ``v (m_local,
    d_local, k)``; the ``(m_local, n, k)`` partial is summed over
    ``features``. ``compute_dtype`` (bf16) takes both products' operands in
    bf16 with fp32 results; an integer block without one is widened to
    fp32; an int8 block under bf16 stays int8 and is widened inside each
    call. ``collectives`` chooses the sum (:func:`_collective_ops`)."""
    psum_c, _ = _collective_ops(collectives)
    cdt = None if compute_dtype is None else torch_dtype(compute_dtype)
    if cdt is None and not x.is_floating_point():
        cdt = torch.float32
    int8_stream = x.dtype == torch.int8 and cdt == torch.bfloat16
    xc = x if (int8_stream or cdt is None) else x.to(cdt)

    def matvec(v):
        xw = xc.to(torch.bfloat16) if int8_stream else xc
        xv = psum_c(_mm_f32(xw, v.to(xw.dtype)), FEATURE_AXIS)
        return _mm_f32(xw.mT, xv.to(xw.dtype)) / n_total_rows

    return matvec


def worker_subspace_sharded(x, k: int, iters: int, n_total_rows: int, v_rand,
                            *, v0=None, compute_dtype=None, ritz: bool = True,
                            collectives: str = "xla"):
    """Per-worker top-k eigenspaces with the feature dim sharded: ``x
    (m_local, n, d_local)`` this rank's workers' columns; returns ``(m_local,
    d_local, k)`` shards, orthonormal globally over ``features``.

    ``v_rand (m_local, d_local, k)`` is this rank's share of the random
    start. ``v0 (d_local, k)`` warm-starts every worker: the start is
    ``v0 + (1e-3 / sqrt(d)) v_rand`` (a zero ``v0`` — the cold first step —
    leaves the random start, rescaled). ``ritz=False`` skips the closing
    Rayleigh-Ritz rotation (the merge consumes projectors only).
    ``collectives`` chooses the matvec's sum over ``features``."""
    matvec = _make_matvec(x, n_total_rows, compute_dtype, collectives)
    v = v_rand
    if v0 is not None:
        d_total = v_rand.shape[1] * pmesh.axis_size(FEATURE_AXIS)
        scale = 1e-3 * torch.rsqrt(torch.tensor(float(d_total), dtype=torch.float32))
        v = v0[None, :, :] + scale.to(v.device) * v
    v = chol_qr2(v, FEATURE_AXIS)
    for _ in range(iters):
        v = chol_qr2(matvec(v), FEATURE_AXIS)
    if not ritz:
        return v
    small = _psum_f(torch.matmul(v.mT, matvec(v)))
    _, q = _small_eigh_desc(small)
    return torch.matmul(v, q)


def _scaled_concat(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``c (m, d_local, kf)`` scaled by ``sqrt(w / max(sum w, 1))`` and
    flattened to ``C (d_local, m kf)``: ``C C^T`` is the masked mean of the
    workers' projectors."""
    cnt = torch.clamp(torch.sum(w), min=1.0)
    c = c * torch.sqrt(w / cnt)[:, None, None]
    return c.permute(1, 0, 2).reshape(c.shape[1], -1)


def _gathered_factors(v_workers, mask, gather=pmesh.all_gather):
    """Every worker's factors ``(m, d_local, kf)`` (gathered over
    ``workers`` by ``gather``) and the ``(m,)`` weights."""
    c = gather(v_workers.float(), WORKER_AXIS)
    if mask is None:
        w = torch.ones((c.shape[0],), dtype=torch.float32, device=c.device)
    else:
        w = gather(torch.as_tensor(mask, dtype=torch.float32).to(c.device), WORKER_AXIS)
    return c, w


def merged_lowrank_sharded(v_workers, k: int, mask=None, dim_total=None,
                           collectives: str = "xla"):
    """Exact top-k of the (masked) mean projector ``(1/sum w) sum_l w_l V_l
    V_l^T`` from the factors, fully sharded: ``v_workers (m_local, d_local,
    kf)`` and ``mask (m_local,)`` this rank's; returns this rank's ``(d_local,
    k)`` rows, the same on every workers rank.

    Below ``m kf < dim_total`` (or without ``dim_total``): the ``(m kf)^2``
    factor Gram summed over ``features``, one replicated ``eigh``, mapped
    back. From ``m kf >= dim_total`` on, the dense ``d x d`` projector is
    the smaller problem: the factors are gathered over ``features`` and
    solved densely (an all-masked round gives zeros there, as it does from
    the guarded inverse square root on the Gram route). ``collectives``
    chooses the gathers and the Gram's sum."""
    psum_c, gather_c = _collective_ops(collectives)
    c, w = _gathered_factors(v_workers, mask, gather_c)
    m_total, d_local, kf = c.shape
    cc = _scaled_concat(c, w)
    if dim_total is not None and m_total * kf >= dim_total:
        cf = gather_c(cc, FEATURE_AXIS)  # (dim_total, m kf)
        alive = (torch.sum(w) > 0).to(torch.float32)
        v = top_k_eigvecs(torch.matmul(cf, cf.mT), k) * alive
        i = pmesh.axis_index(FEATURE_AXIS)
        return v[i * d_local:(i + 1) * d_local]
    b = psum_c(torch.matmul(cc.mT, cc), FEATURE_AXIS)
    w_ev, q = _small_eigh_desc(b)
    inv = guarded_inv_sqrt(torch.clamp(w_ev[:k], min=0.0))
    return torch.matmul(cc, q[:, :k]) * inv[None, :]


def lowrank_update(state: LowRankState, v_bar, weight, keep=1.0) -> LowRankState:
    """Fold ``keep * sigma_tilde + weight * v_bar v_bar^T`` into the rank-r
    factorization (whole arrays, no mesh): ``C = [U sqrt(keep S), sqrt(w)
    V]``, the eigendecomposition of ``C^T C``, truncated to r."""
    return _lowrank_update(state, v_bar, weight, keep, axis_name=None)


def _lowrank_update(state, v_bar, weight, keep, axis_name) -> LowRankState:
    u, s, step = state
    r = u.shape[1]
    weight = torch.as_tensor(weight, dtype=torch.float32, device=u.device)
    c = torch.cat([u * torch.sqrt(torch.clamp(keep * s, min=0.0))[None, :],
                   torch.sqrt(weight) * v_bar], dim=1)
    g = _psum_if(torch.matmul(c.mT, c), axis_name)
    w, q = _small_eigh_desc(g)
    w = torch.clamp(w, min=0.0)
    inv = guarded_inv_sqrt(w)
    return LowRankState(u=torch.matmul(c, q[:, :r]) * inv[None, :r], s=w[:r],
                        step=int(step) + 1)


def _discount_weights(cfg: PCAConfig) -> Callable[[int], tuple[float, float]]:
    """``(add_weight, keep_scale)`` of the round after ``step`` folded
    rounds, in float32 as the reference computes them."""
    f32 = np.float32
    if cfg.discount == "1/T":
        return lambda step: (float(f32(1.0 / cfg.num_steps)), 1.0)
    if cfg.discount == "1/t":
        def weights(step):
            t = f32(step) + f32(1.0)
            return float(f32(1.0) / t), float((t - f32(1.0)) / t)
        return weights
    # "notebook": additive 1/(t+1)
    return lambda step: (float(f32(1.0) / (f32(step) + f32(2.0))), 1.0)


def _resolve_rank(cfg: PCAConfig, rank: int | None) -> int:
    if rank is not None and rank < cfg.k:
        raise ValueError(
            f"rank={rank} must be >= k={cfg.k} (the warm start and the "
            "final top-k both read state.u[:, :k])"
        )
    return rank if rank is not None else min(cfg.dim, 2 * cfg.k + 8)


def _live_rows(v: torch.Tensor) -> bool:
    """Whether a row-sharded basis is nonzero anywhere (summed over
    ``features``, so every rank reads the same answer)."""
    return bool(_psum_f(torch.sum(v * v)) > 0)


class _Starts(NamedTuple):
    v_rand: torch.Tensor  # this rank's (m_local, d_local, k)
    v_init: torch.Tensor | None  # this rank's (d_local, k') rows of the merge's start


def _make_step_core(cfg: PCAConfig, mesh, starts: _Starts, collectives: str = "xla"):
    """The per-step sharded body (worker solves, masked merge, discounted
    rank-r fold), shared by the per-step and whole-fit trainers:
    ``step_core(st, x, step_iters, mask=None) -> (state, v_bar)``, run
    inside ``mesh_scope(mesh)``; ``mask`` this rank's ``(m_local,)`` rows.

    ``cfg.merge_interval = s > 1``: merge rounds (``st.step % s == 0``) run
    the merge; the rounds between fold the masked scaled factor
    concatenation ``C`` (``C C^T`` is the masked mean projector) straight
    into the rank-r state and report its top-k. Above the crossover the
    merge is ``solvers.dist_merged_top_k`` (or the deflation lanes) with
    the rows over ``features``, warm-started from ``u[:, :k]``.
    ``collectives`` chooses every switchable reduction."""
    _, gather_c = _collective_ops(collectives)
    k, n = cfg.k, cfg.rows_per_worker
    weights = _discount_weights(cfg)
    s_int = cfg.merge_interval
    dist = cfg.uses_distributed_solve()
    deflate = dist and cfg.uses_deflation_solve()

    def merge_round(st, vws, mask):
        w, keep = weights(st.step)
        if deflate:
            from distributed_eigenspaces_tpu_torch.solvers.deflation import (
                dist_merged_top_k_deflation,
            )

            v_bar = dist_merged_top_k_deflation(
                vws, k, lanes=cfg.components_axis_size, mask=mask,
                iters=cfg.subspace_iters, tol=cfg.solver_tol, v_init=starts.v_init,
                collectives=collectives, v0=st.u[:, :k])
        elif dist:
            from distributed_eigenspaces_tpu_torch.solvers.distributed import (
                dist_merged_top_k,
            )

            v_bar = dist_merged_top_k(
                vws, k, mask=mask, iters=cfg.subspace_iters, v_init=starts.v_init,
                collectives=collectives, v0=st.u[:, :k], tol=cfg.solver_tol)
        else:
            v_bar = merged_lowrank_sharded(vws, k, mask=mask, dim_total=cfg.dim,
                                           collectives=collectives)
        return _lowrank_update(st, v_bar, w, keep, FEATURE_AXIS), v_bar

    def fold_round(st, vws, mask):
        w, keep = weights(st.step)
        c, wm = _gathered_factors(vws, mask, gather_c)
        new = _lowrank_update(st, _scaled_concat(c, wm), w, keep, FEATURE_AXIS)
        return new, new.u[:, :k]

    def step_core(st, x, step_iters, mask=None):
        vws = worker_subspace_sharded(
            x, k, step_iters, n, starts.v_rand, v0=st.u[:, :k],
            compute_dtype=cfg.compute_dtype, ritz=False, collectives=collectives)
        if s_int == 1 or st.step % s_int == 0:
            return merge_round(st, vws, mask)
        return fold_round(st, vws, mask)

    return step_core


def _starts(cfg: PCAConfig, mesh, *, v_rand=None, v_init=None, seed=None) -> _Starts:
    """The worker solves' start (``v_rand``, whole ``(m, d, k)``, default
    drawn from ``seed``, default ``cfg.seed``) as this rank's share, and
    this rank's rows of the crossover merge's start (``v_init`` whole, or
    by default only those rows drawn: ``algo.step.merge_start``)."""
    from distributed_eigenspaces_tpu_torch.algo.step import merge_start

    shape = (cfg.num_workers, cfg.dim, cfg.k)
    if v_rand is None:
        (v_rand,) = _draw(cfg.seed if seed is None else seed, [shape])
    return _Starts(_rows_of(mesh, v_rand, shape, "v_rand"),
                   merge_start(cfg, device=mesh.device, v_init=v_init,
                               rows=pmesh.feature_rows(mesh, cfg.dim)))


def make_feature_sharded_step(cfg: PCAConfig, mesh=None, *, rank: int | None = None,
                              device="cuda", v_rand=None, v_init=None,
                              collectives: str = "xla"):
    """The per-step trainer of the ``(workers, features)`` mesh:
    ``step(state, x_blocks, worker_mask=None) -> (state, v_bar)``, on every
    rank (``mesh=None``: the one-process ``(1, 1)`` layout on ``device``).

    ``x_blocks`` is the whole ``(m, n, d)`` block or this rank's ``(m_local,
    n, d_local)`` share; ``state.u`` and ``v_bar`` are this rank's rows;
    ``worker_mask`` the whole ``(m,)`` mask. With ``cfg.warm_start_iters``
    set, the first step runs ``cfg.subspace_iters`` and later steps the
    short count; the choice reads the replicated step count on the host.
    ``collectives`` (``"xla"`` or ``"ring"``) chooses the switchable
    reductions (:func:`_collective_ops`). ``step.init_state()`` is this
    rank's zero state. Under ``DET_CHECKIFY=1`` the step runs inside
    ``utils.guards.checked`` on the mesh: a non-finite share on one rank
    (its block's columns, its rows of ``u``) raises on every rank."""
    _collective_ops(collectives)
    mesh = _mesh_of(mesh, device)
    r = _resolve_rank(cfg, rank)
    core = _make_step_core(cfg, mesh, _starts(cfg, mesh, v_rand=v_rand, v_init=v_init),
                           collectives)
    warm_iters = cfg.resolved_warm_start()
    d_local = cfg.dim // mesh.axis_size(FEATURE_AXIS)

    def step(state: LowRankState, x_blocks, worker_mask=None):
        x = place_block(mesh, x_blocks, cfg.num_workers, cfg.dim)
        mask, _ = _mask_rows(mesh, worker_mask, cfg.num_workers)
        iters = cfg.subspace_iters
        if warm_iters is not None and state.step > 0:
            iters = warm_iters
        with pmesh.mesh_scope(mesh):
            return core(state, x, iters, mask)

    step = checked(step, mesh=mesh)
    step.init_state = lambda: LowRankState.initial(d_local, r, device=mesh.device)
    step.rank = r
    step.mesh = mesh
    return step


def _window_steps(mesh, window, m: int, d: int, idx=None) -> list:
    """The steps of a window as this rank's blocks (``idx`` a schedule of
    indices into it)."""
    blocks = place_block(mesh, window, m, d)
    order = range(blocks.shape[0]) if idx is None else [int(i) for i in idx]
    return [blocks[i] for i in order]


def _mask_window(masks, steps: int, m: int) -> np.ndarray:
    mk = np.asarray(masks.detach().cpu() if isinstance(masks, torch.Tensor) else masks,
                    np.float32)
    if mk.shape != (steps, m):
        raise ValueError(f"mask window shape {mk.shape} != (S={steps}, num_workers={m})")
    return mk


def _windowed_whole_fit(mesh, run_window, run_masked, carry_live):
    """The windowed entry shared by both trainers: ``fit_windows(state,
    windows, on_segment=None, worker_masks=None)`` runs each ``(S, m, n,
    d)`` window (whole, or this rank's share) as ``run_window(state,
    window, first)`` — ``first`` only for the first window of a run whose
    carry is zero — or, with ``worker_masks`` (an iterable of ``(S, m)``
    arrays zipped strictly with the windows), as ``run_masked(state,
    window, masks, first)``.
    ``on_segment(steps_done, state)`` sees the whole state (gathered over
    ``features`` on every rank) on rank 0, then every rank meets at a
    barrier, so a checkpoint it commits is on disk before any rank goes
    on. A killed run resumed from any committed checkpoint is the unkilled
    run bit for bit: a nonzero carry runs the all-warm program."""

    def fit_windows(state, windows, on_segment=None, worker_masks=None):
        with pmesh.mesh_scope(mesh):
            first = int(state.step) == 0 or not carry_live(state)
        pairs = (((w, None) for w in windows) if worker_masks is None
                 else zip(windows, worker_masks, strict=True))
        for w, mk in pairs:
            state = (run_window(state, w, first) if mk is None
                     else run_masked(state, w, mk, first))
            first = False
            if on_segment is not None:
                with pmesh.mesh_scope(mesh):
                    whole = gather_state(state)
                pmesh.on_writer(mesh, on_segment, int(state.step), whole)
        return state

    return fit_windows


def make_feature_sharded_scan_fit(cfg: PCAConfig, mesh=None, *, rank: int | None = None,
                                  device="cuda", v_rand=None, v_init=None,
                                  collectives: str = "xla"):
    """Whole-fit trainer of the rank-r state on the ``(workers, features)``
    mesh: ``fit(state, blocks, idx=None, worker_masks=None) -> state``.

    ``blocks`` is ``(B, m, n, d)`` (or this rank's ``(B, m_local, n,
    d_local)``) and ``idx`` a ``(T,)`` schedule into it (default: every
    block once). With warm starts step 1 runs ``cfg.subspace_iters`` cold
    and the rest the short count, the per-step trainer's semantics (the
    same core). ``worker_masks`` ``(T, m)`` excludes masked workers from
    each round's merge exactly; an all-masked round folds a zero ``v_bar``
    and ``u`` survives. ``fit.fit_windows`` is the windowed, checkpointable
    entry (:func:`_windowed_whole_fit`); ``fit.extract(state)`` is ``u[:,
    :k]`` with canonical signs (this rank's rows). ``collectives`` as in
    :func:`make_feature_sharded_step`."""
    _collective_ops(collectives)
    mesh = _mesh_of(mesh, device)
    r = _resolve_rank(cfg, rank)
    core = _make_step_core(cfg, mesh, _starts(cfg, mesh, v_rand=v_rand, v_init=v_init),
                           collectives)
    warm_iters = cfg.resolved_warm_start()
    m, d, k = cfg.num_workers, cfg.dim, cfg.k
    d_local = d // mesh.axis_size(FEATURE_AXIS)

    def run(state, steps, first, masks=None):
        with pmesh.mesh_scope(mesh):
            for t, x in enumerate(steps):
                iters = cfg.subspace_iters
                if warm_iters is not None and not (first and t == 0):
                    iters = warm_iters
                mask = None if masks is None else _mask_rows(mesh, masks[t], m)[0]
                state = core(state, x, iters, mask)[0]
        return state

    # every entry (the staged fit, each window, masked or not) runs its
    # placed, scheduled steps through one guard
    run = checked(run, mesh=mesh)

    def run_window(state, window, first):
        return run(state, _window_steps(mesh, window, m, d), first)

    def run_masked(state, window, masks, first):
        steps = _window_steps(mesh, window, m, d)
        return run(state, steps, first, _mask_window(masks, len(steps), m))

    def fit(state, blocks, idx=None, worker_masks=None):
        steps = _window_steps(mesh, blocks, m, d, idx)
        masks = None if worker_masks is None else _mask_window(
            worker_masks, len(steps), m)
        return run(state, steps, True, masks)

    def extract(state):
        from distributed_eigenspaces_tpu_torch.solvers.distributed import (
            dist_canonicalize_signs,
        )

        with pmesh.mesh_scope(mesh):
            return dist_canonicalize_signs(state.u[:, :k], FEATURE_AXIS)

    fit.fit_windows = _windowed_whole_fit(mesh, run_window, run_masked,
                                          lambda st: _live_rows(st.u))
    fit.init_state = lambda: LowRankState.initial(d_local, r, device=mesh.device)
    fit.extract = extract
    fit.rank = r
    fit.mesh = mesh
    return fit


def _nystrom_top_k(y, omega, k: int, axis_name=None) -> torch.Tensor:
    """Top-k eigenvectors of the PSD matrix behind a one-pass Nystrom sketch
    ``y = A omega``: ``A ~= Y B^+ Y^T`` with ``B = omega^T Y``, factored as
    ``F F^T`` for ``F = Y Q_B diag(lam_B)^{-1/2}`` from B's eigenpairs (the
    pseudo-inverse square root, dropping the numerically null tail: a
    converged sketch makes ``B`` rank-deficient), then F's top-k left
    singular vectors. ``y`` / ``omega`` are row shards with ``axis_name``."""
    b = _psum_if(torch.matmul(omega.mT, y), axis_name)
    b = 0.5 * (b + b.mT)
    wb, qb = _small_eigh_desc(b)
    tol = 1e-7 * torch.clamp(wb[0], min=0.0) + 1e-30
    f = torch.matmul(y, qb) * guarded_inv_sqrt(wb, tol)[None, :]
    gf = _psum_if(torch.matmul(f.mT, f), axis_name)
    w, q = _small_eigh_desc(gf)
    inv = guarded_inv_sqrt(torch.clamp(w[:k], min=0.0))
    return torch.matmul(f, q[:, :k]) * inv[None, :]


def sketch_draws(cfg: PCAConfig, oversample: int = 16, seed=None):
    """The sketch trainer's whole starts, ``(omega (d, p), v_rand (m, d,
    k))``, drawn in that order from ``seed`` (default ``cfg.seed``)."""
    p = min(cfg.dim, cfg.k + oversample)
    omega, v_rand = _draw(cfg.seed if seed is None else seed,
                          [(cfg.dim, p), (cfg.num_workers, cfg.dim, cfg.k)])
    return omega, v_rand


def make_feature_sharded_sketch_fit(cfg: PCAConfig, mesh=None, *, oversample: int = 16,
                                    device="cuda", omega=None, v_rand=None,
                                    collectives: str = "xla"):
    """Sketched whole-fit trainer on the ``(workers, features)`` mesh:
    ``fit(state, blocks, idx=None, worker_masks=None) -> state`` with a
    steady state that runs no eigensolve, Cholesky or triangular solve.

    - The cold step (the first, and any step while the carry is still
      zero): ``cfg.subspace_iters`` CholeskyQR2 iterations per worker and
      the exact factor merge (:func:`merged_lowrank_sharded`).
    - A warm step: ``w`` applications of each worker's covariance to the
      previous merged basis (``w = cfg.warm_start_iters``, 2 for None or
      ``"auto"``: this trainer is warm by construction), :func:`ns_orth`,
      then one power step of the projector mean from the previous basis,
      ``z = sum_l V_l (V_l^T v_prev)``, and :func:`ns_orth` again.
    - The state: ``y += w_t v_bar (v_bar^T omega)`` against a fixed
      ``(d, p)`` test matrix, ``p = min(d, k + oversample)``; the only
      spectral work is :func:`_nystrom_top_k` in ``fit.extract``.

    ``worker_masks`` ``(T, m)``: the cold step reweights the exact merge,
    warm steps zero-weight masked workers' terms (``ns_orth`` renormalizes);
    a step with every worker masked keeps the previous basis and folds
    nothing, and while no cold step has survived, each step runs the cold
    machinery again. ``cfg.merge_interval`` and ``cfg.pipeline_merge`` do
    not apply (no per-step eigensolve). ``omega`` / ``v_rand`` default to
    :func:`sketch_draws`. ``collectives`` as in
    :func:`make_feature_sharded_step` (here also the fold's and the power
    step's sums)."""
    psum_c, _ = _collective_ops(collectives)
    mesh = _mesh_of(mesh, device)
    d, k, n, m = cfg.dim, cfg.k, cfg.rows_per_worker, cfg.num_workers
    p = min(d, k + oversample)
    iters = cfg.subspace_iters
    warm_iters = 2 if cfg.warm_start_iters in (None, "auto") else cfg.warm_start_iters
    weights = _discount_weights(cfg)
    if omega is None or v_rand is None:
        drawn = sketch_draws(cfg, oversample)
        omega = drawn[0] if omega is None else omega
        v_rand = drawn[1] if v_rand is None else v_rand
    omega_l = _rows_of(mesh, omega, (d, p), "omega")
    v_rand_l = _rows_of(mesh, v_rand, (m, d, k), "v_rand")
    d_local = omega_l.shape[0]

    def fold(st, v_bar):
        w_t, keep = weights(st.step)
        g = psum_c(torch.matmul(v_bar.mT, omega_l), FEATURE_AXIS)
        y = keep * st.y + w_t * torch.matmul(v_bar, g)
        return SketchState(y=y, v=v_bar, step=int(st.step) + 1)

    def skipped(st):
        """Every worker masked: count the round, fold nothing, keep v."""
        return SketchState(y=st.y, v=st.v, step=int(st.step) + 1)

    def cold_step(st, x, mask=None, alive=True):
        vws = worker_subspace_sharded(x, k, iters, n, v_rand_l, v0=st.v,
                                      compute_dtype=cfg.compute_dtype, ritz=False,
                                      collectives=collectives)
        v_bar = merged_lowrank_sharded(vws, k, mask=mask, dim_total=d,
                                       collectives=collectives)
        return fold(st, v_bar) if alive else skipped(st)

    def warm_step(st, x, mask=None, alive=True):
        if not alive:
            return skipped(st)
        matvec = _make_matvec(x, n, cfg.compute_dtype, collectives)
        v = st.v[None].expand(x.shape[0], -1, -1)
        for _ in range(warm_iters):
            v = matvec(v)
        v = ns_orth(v, FEATURE_AXIS)
        yl = psum_c(torch.matmul(v.mT, st.v), FEATURE_AXIS)  # (m_local, k, k)
        if mask is not None:
            v = v * mask[:, None, None]
        z = psum_c(torch.sum(torch.matmul(v, yl), dim=0), WORKER_AXIS)
        return fold(st, ns_orth(z, FEATURE_AXIS))

    def masked_step(st, x, mask, alive):
        # the carry stays zero until a cold step survives its mask: warm
        # steps from a zero basis are a fixed point
        if _live_rows(st.v):
            return warm_step(st, x, mask, alive)
        return cold_step(st, x, mask, alive)

    def plain_steps(state, steps, first):
        with pmesh.mesh_scope(mesh):
            for t, x in enumerate(steps):
                state = (cold_step if first and t == 0 else warm_step)(state, x)
        return state

    def masked_steps(state, steps, masks, cold_first):
        with pmesh.mesh_scope(mesh):
            for t, x in enumerate(steps):
                mask, alive = _mask_rows(mesh, masks[t], m)
                if cold_first and t == 0:
                    state = cold_step(state, x, mask, alive)
                else:
                    state = masked_step(state, x, mask, alive)
        return state

    # every entry runs its placed, scheduled steps through one guard
    plain_steps = checked(plain_steps, mesh=mesh)
    masked_steps = checked(masked_steps, mesh=mesh)

    def run_window(state, window, first):
        return plain_steps(state, _window_steps(mesh, window, m, d), first)

    def run_masked(state, window, masks, first=False):
        # one program for every masked window: the cold / warm choice of
        # each step reads the carry, so ``first`` is not needed
        steps = _window_steps(mesh, window, m, d)
        return masked_steps(state, steps, _mask_window(masks, len(steps), m), False)

    def fit(state, blocks, idx=None, worker_masks=None):
        steps = _window_steps(mesh, blocks, m, d, idx)
        if worker_masks is None:
            return plain_steps(state, steps, True)
        # the staged masked fit runs its first step cold, as the reference
        return masked_steps(state, steps, _mask_window(worker_masks, len(steps), m), True)

    def extract(state):
        with pmesh.mesh_scope(mesh):
            return _nystrom_top_k(state.y, omega_l, k, FEATURE_AXIS)

    fit.fit_windows = _windowed_whole_fit(mesh, run_window, run_masked,
                                          lambda st: _live_rows(st.v))
    fit.init_state = lambda: SketchState.initial(d_local, k, p, device=mesh.device)
    fit.extract = extract
    fit.sketch_width = p
    fit.omega = omega_l  # this rank's rows of the test matrix
    fit.mesh = mesh
    return fit
