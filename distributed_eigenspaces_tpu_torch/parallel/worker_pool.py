"""The m-worker round: workers as a batch dimension, on one device or
spread over the ranks of a mesh.

Counterpart of ``distributed_eigenspaces_tpu/parallel/worker_pool.py``.
The reference ``vmap``-ed each worker's solve; here the worker axis is
written out, so the Gram route is one batched kernel launch for a rank's
workers and the Cholesky / triangular solves / ``eigh`` calls are batched
too. The ``"local"`` backend holds all m workers on one device. The
``"shard_map"`` backend (alias ``"tpu"``) gives each rank of a
``(workers, features)`` mesh (``parallel/mesh.py``) its ``m / W`` workers:
a round solves them, all-gathers the ``(m, d, k)`` factors and the mask
over ``workers``, and merges on every rank, so every rank holds the same
result.
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.device import torch_dtype
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
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
    Gram is formed, by a Hopper kernel for a CUDA batch, and solved. int8
    blocks take the s8 Gram kernel on the Gram route, and stream as int8
    under bf16 compute (widened up front under any other).
    ``v0 (d, k)`` starts every worker's subspace iteration; the subspace
    solver requires it (eigh ignores it).
    """
    cdtype = None if compute_dtype is None else torch_dtype(compute_dtype)
    # int8 blocks (the int8 stage: one symmetric scale per block, which
    # cancels in eigenvectors) stay int8 where a native consumer exists:
    # the Gram route keeps them under any compute dtype (the s8 kernel's
    # exact int32 sums), the streaming route under bf16 compute only
    # (batched_xtxv widens them inside the loop); every other integer
    # dtype widens, as the reference's
    int8_wire = x_blocks.dtype == torch.int8
    int8_stream = int8_wire and cdtype == torch.bfloat16
    if not int8_wire and (cdtype is not None or not x_blocks.is_floating_point()):
        # other integer products would wrap: widen as the reference does
        x_blocks = x_blocks.to(cdtype or torch.float32)
    m, _, d = x_blocks.shape
    if solver == "subspace" and v0 is None:
        raise ValueError("the subspace solver needs an explicit v0 (d, k)")

    streaming = solver == "subspace" and (
        d >= 4096 or (2 * k * iters < d and iters <= 6)
    )
    if streaming:
        if int8_wire and not int8_stream:
            x_blocks = x_blocks.to(cdtype or torch.float32)
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
    """Pool of ``m`` logical PCA workers: ``"local"`` on one device, or
    ``"shard_map"`` over a mesh of ranks.

    ``backend="auto"`` is ``"shard_map"`` when a process group of more than
    one rank is initialized, else ``"local"`` (the reference's ``len(
    jax.devices()) > 1``). Under ``"shard_map"`` the mesh is ``mesh``, or,
    when a group is initialized, a ``(W, 1)`` mesh of all its ranks with
    ``W`` the largest divisor of ``m`` up to the group's size (a layout that
    leaves ranks out is refused). A process with no group is a world of one
    rank, which has nothing to gather: its shard_map pool solves all m
    workers on ``device``, as a one-rank mesh would, bit for bit.
    Every rank is given the same ``(m, n, d)`` blocks and solves its own.
    """

    def __init__(
        self,
        num_workers: int,
        *,
        backend: str = "local",
        mesh: pmesh.Mesh | None = None,
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
        if backend == "tpu":
            backend = "shard_map"
        if backend == "auto":
            backend = "shard_map" if pmesh.world_size() > 1 else "local"
        if backend not in ("local", "shard_map"):
            raise ValueError(f"unknown WorkerPool backend: {backend!r}")
        validate_orth_method(orth_method)
        if backend == "shard_map":
            if mesh is None:
                mesh = pmesh.workers_mesh(num_workers, device)
            if mesh is not None and num_workers % mesh.axis_size(pmesh.WORKER_AXIS):
                raise ValueError(
                    f"num_workers={num_workers} not divisible by mesh "
                    f"workers axis {mesh.axis_size(pmesh.WORKER_AXIS)}"
                )
        elif mesh is not None:
            raise ValueError("a mesh is for backend='shard_map'")
        self.num_workers = num_workers
        self.backend = backend
        self.mesh = mesh
        self.solver = solver
        self.subspace_iters = subspace_iters
        self.orth_method = orth_method
        self.compute_dtype = compute_dtype
        self.device = pmesh.mesh_device(mesh, device)
        self.seed = seed

    def shard(self, x_blocks) -> torch.Tensor:
        """This rank's workers of ``(m, n, d)`` host or device data, on the
        pool's device (all of them without a mesh)."""
        return pmesh.place_workers(self.mesh, x_blocks, self.num_workers,
                                   self.device)

    def _v0(self, d: int, k: int, v0):
        return initial_basis(d, k, seed=self.seed, device=self.device, v0=v0)

    def local_eigenspaces(self, x_blocks, k: int, v0=None) -> torch.Tensor:
        """Per-worker eigenspaces ``(m, d, k)`` of all m workers, on this
        rank, without the merge."""
        x = torch.as_tensor(x_blocks).to(self.device)
        return _local_eigenspaces(
            x, k, self.solver, self.subspace_iters, self.orth_method,
            self.compute_dtype, v0=self._v0(x.shape[2], k, v0),
        )

    def round(
        self, x_blocks, k: int, worker_mask=None, v0=None,
        iters: int | None = None, orth: str | None = None, merge: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """One merge round: ``(m, n, d) -> (sigma_bar (d, d), v_bar (d, k))``.

        ``worker_mask (m,)`` in {0, 1} excludes workers from the merge;
        ``v0 (d, k)`` starts every worker's subspace iteration (the pool's
        seeded cold start when None); ``iters`` / ``orth`` override the
        pool's settings for this round (the warm-start levers).
        ``merge=False`` is the merge-interval steady state's fold-only
        round: no merged eigensolve runs, and it returns ``(sigma_bar,
        None)``, the masked mean projector for the caller to fold. On a
        mesh each rank solves its workers, then the factors and the mask
        are all-gathered over ``workers`` and every rank merges them.
        """
        m = int(x_blocks.shape[0])
        if m != self.num_workers:
            raise ValueError(
                f"x_blocks has {m} workers, pool was built for "
                f"{self.num_workers}"
            )
        x = self.shard(x_blocks)
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
        if self.mesh is not None:
            with pmesh.mesh_scope(self.mesh):
                vs = pmesh.all_gather(vs, pmesh.WORKER_AXIS)
                rows = pmesh.worker_rows(self.mesh, m)
                mask = pmesh.all_gather(mask[rows], pmesh.WORKER_AXIS)
        psum, cnt = _masked_projector_mean(vs, mask)
        sigma_bar = psum / torch.clamp(cnt, min=1.0)
        if not merge:
            return sigma_bar, None
        return sigma_bar, merged_top_k_lowrank(vs, k, mask)
