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

from distributed_eigenspaces_tpu_torch.ops.gram import gram_plain


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
    ``ops.gram.gram_auto``)."""
    if x.dtype == torch.int8:
        raise NotImplementedError(
            "the int8 Gram route is not ported yet (ROADMAP.md Queue 1 "
            "item 9a)"
        )
    return gram_plain(x, normalize=normalize)


def batched_xtxv(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(m, n, d), (m, d, k) -> (m, d, k)`` fp32 ``X^T (X V)`` per worker,
    unnormalized. As in the reference, ``v`` and the intermediate ``X V``
    are cast to ``x.dtype`` before each product (bf16 rounding where the
    reference rounds), and both products come out in fp32."""
    if x.dtype == torch.int8:
        raise NotImplementedError(
            "int8 staged matvecs are not ported yet (ROADMAP.md Queue 1 "
            "item 9a)"
        )
    xf = x.float()
    xv = torch.matmul(xf, v.to(x.dtype).float())
    return torch.matmul(xf.mT, xv.to(x.dtype).float())


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
    w, v = torch.linalg.eigh(_sym(m.float()))
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
    the half the fused matvec+Gram kernel leaves to do)."""
    k = g.shape[-1]
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    jitter = eps * torch.diagonal(g, dim1=-2, dim2=-1).sum(-1) + floor
    lower = torch.linalg.cholesky(g + jitter[..., None, None] * eye)
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


ORTH_METHODS = ("qr", "cholqr2", "ns")


def validate_orth_method(method: str) -> None:
    """Raise on an unknown method, or on ``"ns"`` (not ported yet)."""
    if method not in ORTH_METHODS:
        raise ValueError(
            f"unknown orthonormalization method: {method!r}; "
            f"one of {ORTH_METHODS}"
        )
    if method == "ns":
        raise NotImplementedError(
            "ns_orth is not ported yet (ROADMAP.md Queue 1 item 9b)"
        )


def orthonormalize(v: torch.Tensor, method: str = "qr") -> torch.Tensor:
    """Orthonormalize the columns of ``(..., d, k)``: ``"cholqr2"`` or
    Householder ``"qr"``."""
    validate_orth_method(method)
    if method == "cholqr2":
        return _cholqr2(v)
    q, _ = torch.linalg.qr(v)
    return q


def rayleigh_ritz(v: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """Rotate an orthonormal ``(..., d, k)`` basis to the operator's
    eigenvector coordinates given ``av = A v``: descending, canonical signs."""
    small = torch.matmul(v.mT, av)
    _, r = torch.linalg.eigh(_sym(small))
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
    ``(1/sum w) sum_l w_l V_l V_l^T`` from the ``(m, d, k_f)`` factors.
    ``m * k_f >= d`` takes the dense route (d x d eigh), otherwise the
    factor-Gram route ((m k_f)^2 eigh). All workers masked -> zeros."""
    m, d, kf = v_stack.shape
    if mask is None:
        w = torch.ones((m,), dtype=torch.float32, device=v_stack.device)
    else:
        w = mask.to(device=v_stack.device, dtype=torch.float32)
    cnt = torch.clamp(torch.sum(w), min=1.0)
    if m * kf >= d:
        return _merged_top_k_dense(v_stack, k, w, cnt)
    return _merged_top_k_factor_gram(v_stack, k, w, cnt)


def _merged_top_k_dense(v_stack, k, w, cnt):
    p = torch.einsum("mik,mjk,m->ij", v_stack.float(), v_stack.float(), w / cnt)
    alive = (torch.sum(w) > 0).to(torch.float32)
    return top_k_eigvecs(p, k) * alive


def _merged_top_k_factor_gram(v_stack, k, w, cnt):
    c = v_stack.float() * torch.sqrt(w / cnt)[:, None, None]
    d = c.shape[1]
    c = c.permute(1, 0, 2).reshape(d, -1)  # (d, m*k)
    b = torch.matmul(c.mT, c)
    ew, u = torch.linalg.eigh(_sym(b))
    wk = torch.flip(ew[-k:], dims=(-1,))
    uk = torch.flip(u[:, -k:], dims=(-1,))
    vb = torch.matmul(c, uk) * guarded_inv_sqrt(wk)[None, :]
    return canonicalize_signs(vb)


def projector(v: torch.Tensor) -> torch.Tensor:
    """``V V^T`` of ``(..., d, k)``, accumulated in fp32, in ``v.dtype``."""
    vf = v.float()
    return torch.matmul(vf, vf.mT).to(v.dtype)


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
