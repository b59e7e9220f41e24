"""Several hosts: one program a rank, each rank reading only its own rows.

Counterpart of ``distributed_eigenspaces_tpu/parallel/multihost.py``. The
reference runs one SPMD program over a pod from one controller a host and
assembles each host's rows into global arrays. Here every rank is already
its own process holding its own rows (``parallel/mesh.py``), so there is
nothing to assemble:

- the control plane is :func:`initialize`, a process group joined from the
  standard ``torch.distributed`` environment (``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``);
- the data plane is :func:`host_worker_range` (which workers a rank owns)
  and ``data.bin_stream.bin_block_stream(worker_range=...)`` (read only
  their rows);
- the reference's assembly helpers (:func:`host_local_blocks_to_global`,
  :func:`feature_blocks_to_global`, :func:`feature_block_stack_to_global`,
  :func:`replicate_to_hosts`) keep their names and check that a rank's
  block has its share's shape, then place it on the rank's device.

One process with no environment is the one-host case: :func:`initialize`
does nothing and every helper reduces to the plain path.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel.mesh import (
    FEATURE_AXIS,
    WORKER_AXIS,
    make_mesh,
)

__all__ = [
    "HostRect",
    "HostShard",
    "feature_block_stack_to_global",
    "feature_blocks_to_global",
    "fetch_replicated",
    "global_mesh",
    "host_block_rect",
    "host_local_blocks_to_global",
    "host_worker_range",
    "initialize",
    "make_multihost_feature_fit",
    "make_multihost_train_step",
    "replicate_to_hosts",
]

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(backend: str = "nccl", *, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               timeout: float = 300.0, device=None) -> None:
    """Join the job's process group (``parallel.mesh.initialize``), safe to
    call in one process. Arguments not given come from the environment
    (``RANK``, ``WORLD_SIZE``; ``init_method`` defaults to
    ``env://``, which reads ``MASTER_ADDR`` / ``MASTER_PORT``). With no
    arguments and none of those variables set it does nothing: one
    process is a world of one. A group that is already up is left as it
    is; a bootstrap that fails with settings given raises."""
    if pmesh.world_size() > 1 or torch.distributed.is_initialized():
        return
    explicit = init_method is not None or rank is not None or world_size is not None
    present = [v for v in _ENV if v in os.environ]
    if not explicit and not present:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    pmesh.initialize(backend, rank=rank, world_size=world_size,
                     init_method=init_method or "env://", timeout=timeout, device=device)


@dataclasses.dataclass(frozen=True)
class HostShard:
    """A process's slice of the global worker axis."""

    lo: int  # first global worker owned (inclusive)
    hi: int  # last, exclusive
    num_workers: int  # global m

    @property
    def count(self) -> int:
        return self.hi - self.lo

    def row_range(self, rows_per_worker: int) -> tuple[int, int]:
        """The global rows ``[lo, hi)`` of one step this process loads. For
        a row file pass ``worker_range=(shard.lo, shard.hi)`` to
        ``data.bin_stream.bin_block_stream``: its strided reader seeks past
        the other processes' rows of every step."""
        return self.lo * rows_per_worker, self.hi * rows_per_worker


def host_worker_range(num_workers: int, *, process_index: int | None = None,
                      process_count: int | None = None) -> HostShard:
    """The contiguous run of global workers process ``process_index``
    (default this rank) of ``process_count`` (default the group's size)
    owns. ``num_workers`` must divide evenly: a ragged split is refused."""
    pc = pmesh.world_size() if process_count is None else process_count
    pi = pmesh.rank() if process_index is None else process_index
    if num_workers % pc:
        raise ValueError(f"num_workers={num_workers} not divisible by process_count={pc}")
    per = num_workers // pc
    return HostShard(lo=pi * per, hi=(pi + 1) * per, num_workers=num_workers)


def global_mesh(num_workers: int | None = None, num_feature_shards: int = 1, *,
                device="cuda") -> pmesh.Mesh:
    """The ``(workers, features)`` mesh over every rank of the job
    (``parallel.mesh.make_mesh``)."""
    return make_mesh(num_workers=num_workers, num_feature_shards=num_feature_shards,
                     device=device)


@dataclasses.dataclass(frozen=True)
class HostRect:
    """A process's rectangle of the ``(workers, features)`` mesh: its
    worker-axis and feature-axis slots."""

    w_lo: int
    w_hi: int  # exclusive, in worker-axis slots
    f_lo: int
    f_hi: int  # exclusive, in feature-axis slots
    mesh_workers: int
    mesh_features: int

    def block_slice(self, num_workers: int, dim: int):
        """Slices of the global ``(m, n, d)`` block this process loads: the
        workers of its worker slots, the columns of its feature slots."""
        if num_workers % self.mesh_workers or dim % self.mesh_features:
            raise ValueError(
                f"(m={num_workers}, d={dim}) not divisible by mesh "
                f"({self.mesh_workers}, {self.mesh_features})"
            )
        wper = num_workers // self.mesh_workers
        fper = dim // self.mesh_features
        return (slice(self.w_lo * wper, self.w_hi * wper),
                slice(self.f_lo * fper, self.f_hi * fper))


def host_block_rect(mesh: pmesh.Mesh, *, process_index: int | None = None) -> HostRect:
    """A process's rectangle of a ``(workers, features)`` mesh: one rank is
    one slot, so the rectangle is the rank's own coordinates. Another
    rank's (``process_index``) is read from the C-order layout."""
    shape = mesh.shape
    w, f = shape[WORKER_AXIS], shape[FEATURE_AXIS]
    if process_index is None:
        wi, fi = mesh.axis_index(WORKER_AXIS), mesh.axis_index(FEATURE_AXIS)
    else:
        if not 0 <= process_index < w * f:
            raise ValueError(f"process {process_index} owns no slot of a {w}x{f} mesh")
        wi, fi = divmod(process_index, f)
    return HostRect(w_lo=wi, w_hi=wi + 1, f_lo=fi, f_hi=fi + 1,
                    mesh_workers=w, mesh_features=f)


def _placed(x_local, mesh: pmesh.Mesh, want: tuple, what: str) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(x_local) if not isinstance(x_local, torch.Tensor)
                        else x_local)
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"{what}: this rank's block is {tuple(x.shape)}, its share "
                         f"of the mesh is {tuple(want)}")
    return x.to(mesh.device)


def host_local_blocks_to_global(x_local, mesh: pmesh.Mesh) -> torch.Tensor:
    """This rank's ``(m_local, n, d)`` workers on its device (the global
    ``m`` is ``m_local`` times the ``workers`` axis, as the reference infers
    it from the per-host blocks)."""
    if len(x_local.shape) != 3:
        raise ValueError(f"host_local_blocks_to_global: want an (m_local, n, d) "
                         f"block, got shape {tuple(x_local.shape)}")
    return _placed(x_local, mesh, tuple(x_local.shape), "host_local_blocks_to_global")


def feature_blocks_to_global(x_local, mesh: pmesh.Mesh, global_shape) -> torch.Tensor:
    """This rank's ``(m_local, n, d_local)`` share of the global ``(m, n, d)``
    block on its device, its shape checked against ``global_shape`` over the
    mesh (the reference's ``P(workers, None, features)``)."""
    m, n, d = global_shape
    want = (m // mesh.axis_size(WORKER_AXIS), n, d // mesh.axis_size(FEATURE_AXIS))
    return _placed(x_local, mesh, want, "feature_blocks_to_global")


def feature_block_stack_to_global(blocks_local, mesh: pmesh.Mesh,
                                  global_shape) -> torch.Tensor:
    """This rank's ``(B, m_local, n, d_local)`` share of a staged ``(B, m, n,
    d)`` stack on its device, its shape checked against ``global_shape``."""
    b, m, n, d = global_shape
    want = (b, m // mesh.axis_size(WORKER_AXIS), n, d // mesh.axis_size(FEATURE_AXIS))
    return _placed(blocks_local, mesh, want, "feature_block_stack_to_global")


def replicate_to_hosts(value, mesh: pmesh.Mesh) -> torch.Tensor:
    """A small host value (the ``(d, k)`` state) whole on this rank's
    device: every rank holds its own copy."""
    return pmesh.replicated(mesh, value)


def fetch_replicated(x: torch.Tensor) -> np.ndarray:
    """A replicated tensor as numpy on this host (a local copy)."""
    return x.detach().cpu().numpy()


def make_multihost_feature_fit(cfg, mesh: pmesh.Mesh, *, trainer: str = "scan",
                               collectives: str = "xla", **kw):
    """The feature-sharded whole-fit trainers driven from each rank's own
    rows: ``fit(state, blocks_local, idx=None, **kw)`` with ``blocks_local``
    this rank's ``(B, m_local, n, d_local)`` rectangle of the staged stack,
    and ``fit.fit_windows(state, windows_local, on_segment=None,
    worker_masks=None)`` with each window this rank's ``(S, m_local, n,
    d_local)`` (the masks are the whole ``(S, m)`` schedules, the same on
    every rank). ``trainer``: ``"scan"`` (the exact rank-r carry) or
    ``"sketch"`` (the Nystrom carry, with ``fit.extract``). ``kw`` go to
    the trainer (``device``, starts)."""
    from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import (
        make_feature_sharded_scan_fit,
        make_feature_sharded_sketch_fit,
    )

    if trainer not in ("scan", "sketch"):
        raise ValueError(f"unknown trainer {trainer!r} (scan|sketch)")
    make = make_feature_sharded_sketch_fit if trainer == "sketch" else (
        make_feature_sharded_scan_fit)
    inner = make(cfg, mesh, collectives=collectives, **kw)

    def _local(blocks_local):
        b, n = blocks_local.shape[0], blocks_local.shape[2]
        return feature_block_stack_to_global(blocks_local, mesh,
                                             (b, cfg.num_workers, n, cfg.dim))

    def fit(state, blocks_local, idx=None, **fkw):
        return inner(state, _local(blocks_local), idx, **fkw)

    def fit_windows(state, windows_local, on_segment=None, worker_masks=None):
        return inner.fit_windows(state, (_local(w) for w in windows_local),
                                 on_segment=on_segment, worker_masks=worker_masks)

    fit.fit_windows = fit_windows
    fit.init_state = inner.init_state
    fit.mesh = mesh
    for attr in ("extract", "rank", "sketch_width"):
        if hasattr(inner, attr):
            setattr(fit, attr, getattr(inner, attr))
    return fit


def make_multihost_train_step(cfg, mesh: pmesh.Mesh, **kw):
    """``step(state, x_local, v_prev=None) -> (state, v_bar)`` with
    ``x_local`` this rank's ``(m_local, n, d)`` workers: the train step of
    ``algo.step.make_train_step(cfg, mesh=mesh)`` (``kw``: its starts), the
    rank's block checked and placed first. ``v_prev`` forwards the warm
    start."""
    from distributed_eigenspaces_tpu_torch.algo.step import make_train_step

    inner = make_train_step(cfg, mesh=mesh, **kw)
    width = mesh.axis_size(WORKER_AXIS)

    def step(state, x_local, v_prev=None):
        if x_local.shape[0] * width != cfg.num_workers:
            raise ValueError(
                f"x_local holds {x_local.shape[0]} workers: this rank's share of "
                f"{cfg.num_workers} over a {width}-wide workers axis is "
                f"{cfg.num_workers // width}"
            )
        return inner(state, host_local_blocks_to_global(x_local, mesh), v_prev)

    return step
