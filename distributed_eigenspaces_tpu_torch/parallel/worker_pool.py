"""The m-worker round on one device: workers are a batch dimension.

Counterpart of ``distributed_eigenspaces_tpu/parallel/worker_pool.py``
(the ``"local"`` backend). The reference ``vmap``-ed each worker's solve;
here the worker axis is written out, so the Gram route is one batched
kernel launch for all m workers and the Cholesky / triangular solves /
``eigh`` calls are batched too.
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype
from distributed_eigenspaces_tpu_torch.ops.gram import gram_auto
from distributed_eigenspaces_tpu_torch.ops.linalg import (
    batched_xtxv,
    initial_basis,
    merged_top_k_lowrank,
    orthonormalize,
    rayleigh_ritz,
    subspace_iteration,
    top_k_eigvecs,
    validate_orth_method,
)


def _batched_streaming_eigenspaces(
    x: torch.Tensor, k: int, iters: int, orth: str, v0: torch.Tensor
) -> torch.Tensor:
    """Per-worker subspace solves on the ``(m, n, d)`` stack that apply the
    covariance as ``X^T (X V) / n`` and never form the d x d Gram."""
    m, n, d = x.shape
    validate_orth_method(orth)

    def mv(vs):
        return batched_xtxv(x, vs) / n

    vs = orthonormalize(v0.float().expand(m, d, k), orth)
    for _ in range(iters):
        vs = orthonormalize(mv(vs), orth)
    return rayleigh_ritz(vs, mv(vs))


def _local_eigenspaces(
    x_blocks: torch.Tensor,
    k: int,
    solver: str,
    iters: int,
    orth: str = "cholqr2",
    compute_dtype=None,
    v0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-worker ``V_hat``: ``(m, n, d) -> (m, d, k)``.

    The route rule is the reference's (``worker_pool.py:153-155``): the
    subspace solver streams when ``d >= 4096`` or when the iteration count
    is low (``2 k iters < d and iters <= 6``); otherwise every worker's
    Gram is formed, by the Hopper kernel for a CUDA batch, and solved.
    ``v0 (d, k)`` starts every worker's subspace iteration; the subspace
    solver requires it (eigh ignores it).
    """
    if x_blocks.dtype == torch.int8:
        raise NotImplementedError(
            "int8 staged blocks are not ported yet (ROADMAP.md Queue 1 "
            "item 9a)"
        )
    cdtype = None if compute_dtype is None else torch_dtype(compute_dtype)
    if not x_blocks.is_floating_point():
        # integer einsums would wrap: widen as the reference does
        x_blocks = x_blocks.to(cdtype or torch.float32)
    if cdtype is not None:
        x_blocks = x_blocks.to(cdtype)
    m, _, d = x_blocks.shape
    if solver == "subspace" and v0 is None:
        raise ValueError("the subspace solver needs an explicit v0 (d, k)")

    streaming = solver == "subspace" and (
        d >= 4096 or (2 * k * iters < d and iters <= 6)
    )
    if streaming:
        return _batched_streaming_eigenspaces(x_blocks, k, iters, orth, v0)

    g = gram_auto(x_blocks.contiguous())  # (m, d, d) fp32
    if solver == "subspace":
        return subspace_iteration(
            lambda v: torch.matmul(g, v),
            v0.float().expand(m, d, k),
            iters=iters,
            orth=orth,
        )
    return top_k_eigvecs(g, k)


def _masked_projector_mean(
    v_stack: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum of masked projectors ``sum_l w_l V_l V_l^T`` and the mask count
    (callers divide, so means stay exact across reductions)."""
    w = mask.to(device=v_stack.device, dtype=torch.float32)
    vf = v_stack.float()
    p = torch.einsum("mik,mjk,m->ij", vf, vf, w)
    return p, torch.sum(w)


class WorkerPool:
    """Pool of ``m`` logical PCA workers on one device (``"local"``)."""

    def __init__(
        self,
        num_workers: int,
        *,
        backend: str = "local",
        solver: str = "eigh",
        subspace_iters: int = 16,
        orth_method: str = "cholqr2",
        compute_dtype=None,
        device="cuda",
        seed: int = 0,
    ):
        if orth_method == "ns":
            raise ValueError(
                "orth_method='ns' is warm-only: construct the pool with "
                "cholqr2/qr and pass orth='ns' to round() on warm rounds"
            )
        if backend == "auto":
            backend = "local"
        if backend != "local":
            raise NotImplementedError(
                f"WorkerPool backend {backend!r} is not ported yet "
                "(ROADMAP.md Queue 1 item 14)"
            )
        validate_orth_method(orth_method)
        self.num_workers = num_workers
        self.backend = backend
        self.solver = solver
        self.subspace_iters = subspace_iters
        self.orth_method = orth_method
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.seed = seed

    def shard(self, x_blocks) -> torch.Tensor:
        """Place ``(m, n, d)`` host data on the pool's device."""
        return torch.as_tensor(x_blocks).to(self.device)

    def _v0(self, d: int, k: int, v0):
        return initial_basis(d, k, seed=self.seed, device=self.device, v0=v0)

    def local_eigenspaces(self, x_blocks, k: int, v0=None) -> torch.Tensor:
        """Per-worker eigenspaces ``(m, d, k)`` without the merge."""
        x = self.shard(x_blocks)
        return _local_eigenspaces(
            x, k, self.solver, self.subspace_iters, self.orth_method,
            self.compute_dtype, v0=self._v0(x.shape[2], k, v0),
        )

    def round(
        self, x_blocks, k: int, worker_mask=None, v0=None,
        iters: int | None = None, orth: str | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One merge round: ``(m, n, d) -> (sigma_bar (d, d), v_bar (d, k))``.

        ``worker_mask (m,)`` in {0, 1} excludes workers from the merge;
        ``v0 (d, k)`` starts every worker's subspace iteration (the pool's
        seeded cold start when None); ``iters`` / ``orth`` override the
        pool's settings for this round (the warm-start levers).
        """
        x = self.shard(x_blocks)
        m = x.shape[0]
        if m != self.num_workers:
            raise ValueError(
                f"x_blocks has {m} workers, pool was built for "
                f"{self.num_workers}"
            )
        if worker_mask is None:
            mask = torch.ones((m,), dtype=torch.float32, device=self.device)
        else:
            mask = torch.as_tensor(worker_mask, dtype=torch.float32).to(
                self.device
            )
        vs = _local_eigenspaces(
            x, k, self.solver,
            self.subspace_iters if iters is None else iters,
            self.orth_method if orth is None else orth,
            self.compute_dtype, v0=self._v0(x.shape[2], k, v0),
        )
        psum, cnt = _masked_projector_mean(vs, mask)
        sigma_bar = psum / torch.clamp(cnt, min=1.0)
        return sigma_bar, merged_top_k_lowrank(vs, k, mask)
