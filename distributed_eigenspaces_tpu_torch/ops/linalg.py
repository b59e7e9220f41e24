"""Linear algebra of the online-PCA round, in PyTorch.

Counterpart of ``distributed_eigenspaces_tpu/ops/linalg.py``. Functions
take a leading batch dimension wherever the reference ``vmap``-ed them
over workers. fp32 products run in full fp32 (the reference's
``Precision.HIGHEST``; the port never enables TF32). A bf16 x bf16
product is taken in fp32 with fp32 accumulation, as the reference's
``preferred_element_type=float32``: operands are widened before the
matmul, which is exact, so no result is ever rounded to bf16 unless the
reference rounds it too.

Random starts are never drawn inside a solver: every solver takes an
explicit ``v0``, and :func:`initial_basis` draws one from a seeded
``torch.Generator``.
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.ops import cusolver
from distributed_eigenspaces_tpu_torch.ops.gram import gram_plain, gram_s8_plain, widen_int
from distributed_eigenspaces_tpu_torch.utils.guards import check, checks_enabled


def initial_basis(d: int, k: int, *, seed: int = 0, device="cpu",
                  v0=None) -> torch.Tensor:
    """``(d, k)`` float32 cold start on ``device``: ``v0`` when given, else
    a standard-normal draw made on the CPU from
    ``torch.Generator().manual_seed(seed)``, so the same seed gives the
    same start on every device."""
    if v0 is not None:
        return torch.as_tensor(v0, dtype=torch.float32).to(device)
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((d, k), generator=gen, dtype=torch.float32).to(device)


def guarded_inv_sqrt(w: torch.Tensor, tol=1e-12) -> torch.Tensor:
    """``w^{-1/2}``, zero at or below ``tol`` (dead directions)."""
    return torch.where(w > tol, torch.rsqrt(torch.clamp(w, min=1e-30)), 0.0)


def gram(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """Plain ``(..., n, d) -> (..., d, d)`` second moment ``X^T X / n`` in
    fp32 (the reference's XLA ``linalg.gram``; the kernel route is
    ``ops.gram.gram_auto``). int8 within the reference's guard
    (``n * 127^2 < 2^31``) sums exactly (``ops.gram.gram_s8_plain``: the
    reference's int32 einsum, bit for bit); past it, and for other integer
    dtypes, x is widened to fp32 first."""
    x = widen_int(x)
    if x.dtype == torch.int8:
        return gram_s8_plain(x, normalize=normalize)
    return gram_plain(x, normalize=normalize)


def batched_xtxv(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(m, n, d), (m, d, k) -> (m, d, k)`` fp32 ``X^T (X V)`` per worker,
    unnormalized. As in the reference, ``v`` and the intermediate ``X V``
    are rounded to the dtype the products take x in before each product
    (bf16 rounding where the reference rounds), and both products come out
    in fp32. That dtype is x's own for floats, bf16 for int8 (the staged
    wire format, which the reference widens to bf16 inside the solver's
    loop) and fp32 for other integers; every widening of x is exact."""
    if x.dtype == torch.int8:
        wdt = torch.bfloat16
    elif not x.is_floating_point():
        wdt = torch.float32
    else:
        wdt = x.dtype
    xf = x.float()
    xv = torch.matmul(xf, v.to(wdt).float())
    return torch.matmul(xf.mT, xv.to(wdt).float())


def canonicalize_signs(v: torch.Tensor) -> torch.Tensor:
    """Flip column signs so each column's largest-|entry| element is
    positive (first maximum on ties). Works on ``(..., d, k)``."""
    idx = torch.argmax(torch.abs(v), dim=-2, keepdim=True)
    pivot = torch.take_along_dim(v, idx, dim=-2)
    signs = torch.where(pivot >= 0, 1.0, -1.0).to(v.dtype)
    return v * signs


def _sym(m: torch.Tensor) -> torch.Tensor:
    return 0.5 * (m + m.mT)


def top_k_eig(m: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k (eigenvalues, eigenvectors) of symmetric ``(..., d, d)``, both
    in descending order, signs canonicalized."""
    w, v = cusolver.eigh(_sym(m.float()))
    wk = torch.flip(w[..., -k:], dims=(-1,))
    vk = canonicalize_signs(torch.flip(v[..., -k:], dims=(-1,)))
    return wk, vk


def top_k_eigvecs(m: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k eigenvectors of symmetric ``(..., d, d)``, descending."""
    return top_k_eig(m, k)[1]


def chol_apply(v: torch.Tensor, g: torch.Tensor, eps: float = 1e-7,
               floor: float = 0.0) -> torch.Tensor:
    """Finish one CholeskyQR pass of ``(..., d, k)`` from its precomputed
    Gram ``g = V^T V``: Cholesky ``L`` of ``g`` jittered by
    ``eps * trace(g) + floor`` on the diagonal, then the right triangular
    solve ``X L^T = V`` (the reference's ``feature_sharded._chol_apply``,
    the half the fused matvec+Gram kernel leaves to do).

    A batch element whose factorization fails (a Gram that is not positive
    definite, or not finite) comes out NaN, and the others as they are:
    the reference's batched lanes, where ``jnp.linalg.cholesky`` is NaN in
    the failed lane alone. The flag is read on the device, with no sync."""
    k = g.shape[-1]
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    jitter = eps * torch.diagonal(g, dim1=-2, dim2=-1).sum(-1) + floor
    lower, info = torch.linalg.cholesky_ex(g + jitter[..., None, None] * eye)
    lower = torch.where(info.eq(0)[..., None, None], lower, float("nan"))
    return torch.linalg.solve_triangular(lower.mT, v, upper=True, left=False)


def chol_qr(v: torch.Tensor, eps: float = 1e-7, floor: float = 0.0) -> torch.Tensor:
    """One CholeskyQR pass: :func:`chol_apply` with the Gram of ``v``."""
    return chol_apply(v, torch.matmul(v.mT, v), eps, floor)


def chol_qr2(v: torch.Tensor) -> torch.Tensor:
    """CholeskyQR2 of the distributed solver (the reference's
    ``feature_sharded.chol_qr2`` on one device): two passes, jitter
    ``1e-7 * trace``."""
    return chol_qr(chol_qr(v))


def _cholqr2(v: torch.Tensor) -> torch.Tensor:
    """CholeskyQR2 of the dense solvers (the reference's
    ``ops.linalg._cholqr2``): two passes, jitter ``1e-7 * trace + 1e-30``."""
    return chol_qr(chol_qr(v, floor=1e-30), floor=1e-30)


def ns_orth(v: torch.Tensor, iters: int = 4, eps: float = 1e-20,
            reduce=None) -> torch.Tensor:
    """Orthonormalize tall-skinny fp32 ``v (..., d, k)`` by column scaling
    and Newton-Schulz iteration: matrix products only, so no Cholesky,
    triangular solve or error-flag sync (the reference's ``ns_orth``, in
    its order of operations). One d-sized Gram, then on k x k matrices the
    column scaling, the bound ``alpha^2`` that puts every singular value at
    or below 1, and ``iters`` steps of ``a = 1.5 I - 0.5 G; M <- M a;
    G <- G (a a)`` (G and a commute), then one ``(d, k) (k, k)`` product.
    Converges for the bounded condition numbers of warm rounds only, which
    is why ``PCAConfig`` takes it as ``warm_orth_method`` alone: under
    ``DET_CHECKIFY=1`` (``utils/guards.py``) it asserts the result's
    orthonormality residual ``||V^T V - I||_max < 5e-2``, as the
    reference's does, at the price of one more k x k Gram and a host read;
    with the guards off it launches nothing more. ``reduce`` sums the Gram
    of a row-sharded ``v`` over its shards (the feature-sharded trainers
    pass a ``features`` psum), so the block is orthonormalized globally."""
    g = torch.matmul(v.mT, v)
    if reduce is not None:
        g = reduce(g)
    dscale = torch.rsqrt(torch.clamp(torch.diagonal(g, dim1=-2, dim2=-1), min=eps))
    g = g * dscale[..., :, None] * dscale[..., None, :]
    # sigma_max^2 <= max abs row sum; after the scaling the diagonal is 1,
    # so the bound is >= 1 and alpha <= 1
    alpha2 = 1.0 / torch.clamp(torch.sum(torch.abs(g), dim=-1).amax(dim=-1), min=1.0)
    g = g * alpha2[..., None, None]
    k = g.shape[-1]
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    m_acc = eye * torch.sqrt(alpha2)[..., None, None]
    for _ in range(iters):
        a = 1.5 * eye - 0.5 * g
        m_acc = torch.matmul(m_acc, a)
        g = torch.matmul(g, torch.matmul(a, a))
    out = torch.matmul(v * dscale[..., None, :], m_acc)
    if checks_enabled():
        # NS converges only for a bounded condition number; a broken
        # assumption degrades the basis with no NaN anywhere, so a float
        # check never fires: assert the residual instead
        vtv = torch.matmul(out.mT, out)
        if reduce is not None:
            vtv = reduce(vtv)
        resid = torch.max(torch.abs(vtv - eye))
        check(resid < 5e-2,
              f"ns_orth left ||V^T V - I||_max = {float(resid):.4g}: input "
              "condition number outside the convergence regime (use cholqr2)")
    return out


ORTH_METHODS = ("qr", "cholqr2", "ns")


def validate_orth_method(method: str) -> None:
    """Raise on an unknown method, without running anything."""
    if method not in ORTH_METHODS:
        raise ValueError(
            f"unknown orthonormalization method: {method!r}; "
            f"one of {ORTH_METHODS}"
        )


def orthonormalize(v: torch.Tensor, method: str = "qr") -> torch.Tensor:
    """Orthonormalize the columns of ``(..., d, k)``: ``"cholqr2"``,
    Householder ``"qr"``, or ``"ns"`` (:func:`ns_orth`, warm rounds only)."""
    validate_orth_method(method)
    if method == "cholqr2":
        return _cholqr2(v)
    if method == "ns":
        return ns_orth(v)
    q, _ = torch.linalg.qr(v)
    return q


def rayleigh_ritz(v: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """Rotate an orthonormal ``(..., d, k)`` basis to the operator's
    eigenvector coordinates given ``av = A v``: descending, canonical signs."""
    small = torch.matmul(v.mT, av)
    _, r = cusolver.eigh(_sym(small))
    return canonicalize_signs(torch.matmul(v, torch.flip(r, dims=(-1,))))


def subspace_iteration(
    matvec, v0: torch.Tensor, *, iters: int = 16, orth: str = "cholqr2"
) -> torch.Tensor:
    """Top-k invariant subspace of a symmetric PSD operator by block power
    iteration from ``v0 (..., d, k)``, finished by Rayleigh-Ritz."""
    v = orthonormalize(v0.float(), orth)
    for _ in range(iters):
        v = orthonormalize(matvec(v), orth)
    return rayleigh_ritz(v, matvec(v))


def top_k_eigvecs_streaming(x_blocks: torch.Tensor, k: int, *, iters: int = 16,
                            v0=None, seed: int = 0,
                            orth: str = "cholqr2") -> torch.Tensor:
    """Top-k eigenvectors of ``(1/N) X^T X`` for ``x_blocks (b, n, d)``
    without forming the d x d Gram: each power step applies ``X^T (X V)``
    block by block in fp32 (a bf16 block is widened; ``V`` and ``X V`` stay
    fp32, as the reference's mixed-dtype matmuls promote them). The start is ``v0 (d, k)``, or drawn from ``seed``
    (:func:`initial_basis`; the reference draws it from
    ``jax.random.PRNGKey(0)``)."""
    b, n, d = x_blocks.shape
    v0 = initial_basis(d, k, seed=seed, device=x_blocks.device, v0=v0)

    def matvec(v):
        acc = torch.zeros((d, v.shape[-1]), dtype=torch.float32, device=v.device)
        for xb in x_blocks:
            xf = xb.float()
            acc = acc + torch.matmul(xf.mT, torch.matmul(xf, v))
        return acc / (b * n)

    return subspace_iteration(matvec, v0, iters=iters, orth=orth)


def merged_top_k(p: torch.Tensor, k: int, solver: str = "eigh",
                 iters: int = 16, orth: str = "cholqr2",
                 v0: torch.Tensor | None = None) -> torch.Tensor:
    """Top-k of a dense symmetric matrix by the configured solver; the
    subspace solver needs its start ``v0 (d, k)``."""
    if solver == "subspace":
        if v0 is None:
            raise ValueError("merged_top_k(solver='subspace') needs v0")
        return subspace_iteration(
            lambda v: torch.matmul(p, v), v0, iters=iters, orth=orth
        )
    return top_k_eigvecs(p, k)


def merged_top_k_lowrank(
    v_stack: torch.Tensor, k: int, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Exact top-k eigenvectors of the (masked) mean of projectors
    ``(1/sum w) sum_l w_l V_l V_l^T`` from the ``(..., m, d, k_f)`` factors
    and a ``(..., m)`` mask: a fleet's B tenants are a leading ``(B,)``,
    each merged on its own mask. ``m * k_f >= d`` takes the dense route
    (d x d eigh), otherwise the factor-Gram route ((m k_f)^2 eigh); the
    rule depends on the shape alone, so every tenant takes the same one,
    and the eigensolve is one call for all of them (``ops.cusolver.eigh``).
    All workers masked -> zeros."""
    m, d, kf = v_stack.shape[-3:]
    if mask is None:
        w = torch.ones(v_stack.shape[:-2], dtype=torch.float32, device=v_stack.device)
    else:
        w = mask.to(device=v_stack.device, dtype=torch.float32)
    cnt = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    if m * kf >= d:
        return _merged_top_k_dense(v_stack, k, w, cnt)
    return _merged_top_k_factor_gram(v_stack, k, w, cnt)


def _merged_top_k_dense(v_stack, k, w, cnt):
    vf = v_stack.float()
    p = torch.einsum("...mik,...mjk,...m->...ij", vf, vf, w / cnt[..., None])
    alive = (torch.sum(w, dim=-1) > 0).to(torch.float32)
    vk = torch.flip(cusolver.eigh(_sym(p))[1][..., -k:], dims=(-1,))
    return canonicalize_signs(vk) * alive[..., None, None]


def _merged_top_k_factor_gram(v_stack, k, w, cnt):
    c = v_stack.float() * torch.sqrt(w / cnt[..., None])[..., None, None]
    *lead, m, d, kf = c.shape
    c = c.movedim(-3, -2).reshape(*lead, d, m * kf)  # (..., d, m*k)
    b = torch.matmul(c.mT, c)
    ew, u = cusolver.eigh(_sym(b))
    wk = torch.flip(ew[..., -k:], dims=(-1,))
    uk = torch.flip(u[..., -k:], dims=(-1,))
    vb = torch.matmul(c, uk) * guarded_inv_sqrt(wk)[..., None, :]
    return canonicalize_signs(vb)


def projector(v: torch.Tensor) -> torch.Tensor:
    """``V V^T`` of ``(..., d, k)``, accumulated in fp32, in ``v.dtype``."""
    vf = v.float()
    return torch.matmul(vf, vf.mT).to(v.dtype)


def merge_projectors(v_stack: torch.Tensor) -> torch.Tensor:
    """``(m, d, k) -> (d, d)`` mean of the workers' projectors, accumulated
    in fp32, in ``v_stack.dtype``."""
    vf = v_stack.float()
    p = torch.einsum("mik,mjk->ij", vf, vf)
    return (p / v_stack.shape[0]).to(v_stack.dtype)


def principal_angles(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Principal angles (radians, ascending) between the column spans of
    ``u, v (d, k)``. Both are re-orthonormalized in float64 first: the
    cosines of fp32 bases sit ~1e-7 off one, which the arccos turns into
    a few hundredths of a degree on identical spans."""
    qu = torch.linalg.qr(u.double())[0]
    qv = torch.linalg.qr(v.double())[0]
    s = torch.linalg.svdvals(torch.matmul(qu.mT, qv))
    return torch.sort(torch.arccos(torch.clamp(s, 0.0, 1.0))).values


def principal_angles_degrees(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """:func:`principal_angles` in degrees."""
    return torch.rad2deg(principal_angles(u, v))


def grassmann_distance(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Grassmann (geodesic) distance: the l2 norm of the principal angles."""
    return torch.linalg.vector_norm(principal_angles(u, v))
