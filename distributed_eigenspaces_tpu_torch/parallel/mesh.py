"""Meshes of ranks, their collectives, and a launcher for one host.

Counterpart of ``distributed_eigenspaces_tpu/parallel/mesh.py``. The
reference drives every device from one controller through a
``jax.sharding.Mesh``; here each rank is its own process on its own device
(SPMD), and a :class:`Mesh` wraps a ``torch.distributed`` ``DeviceMesh``
whose named dims stand in for the reference's axes: ``("workers",
"features")`` from :func:`make_mesh`, ``("components", "features")`` from
:func:`make_component_mesh`, one axis per merge tier from
``parallel.topology.make_tiered_mesh`` (any names: :func:`grid_mesh`). The
layout is row-major, the reference's ``devices.reshape(W, F)``, so worker
rank ``r`` holds workers ``[r m / W, (r + 1) m / W)``.

A reference ``psum`` / ``all_gather`` / ``all_to_all`` / ``ppermute`` over
an axis name runs on the DeviceMesh's group for that dim: :func:`psum`,
:func:`pmax`, :func:`all_gather`, :func:`all_to_all` and :func:`ppermute`
resolve the name against the mesh made active by :func:`mesh_scope` (the
counterpart of tracing inside ``shard_map``). The gather is the list form,
in group-rank order, concatenated on axis 0: the reference's
``all_gather(..., axis=0, tiled=True)``. :func:`recording_collectives` logs
each call's op, axis, dtype, elements and bytes: the port has no HLO, so
what was handed to ``torch.distributed`` is what a payload gate reads.

One process with no group is the ``(1, 1)`` layout, :func:`local_mesh`:
every collective over its axes is the identity.

The process-group backend is the caller's choice, never a reaction to an
error: ``"nccl"`` for ranks each on their own card, ``"gloo"`` for CPU ranks
and for ranks that share one card (NCCL refuses two ranks on one device).
Gloo collectives of CUDA tensors are staged through host memory because
the group is gloo.

:func:`launch` starts W ranks from one process (``spawn``, never ``fork``),
rendezvous through a file, joins them under a timeout, kills every rank on
a timeout or on the first rank that raises, and re-raises that rank's
exception in the caller.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from distributed_eigenspaces_tpu_torch.device import resolve_device

WORKER_AXIS = "workers"
FEATURE_AXIS = "features"
#: the deflation lanes' axis (model parallelism over k), composing with
#: ``features`` as ``workers`` does
COMPONENT_AXIS = "components"

#: all-gathers run by :func:`all_gather` in this process, and the bytes
#: each rank put on the wire for them (its own shard, once per gather)
gathers = 0
gather_bytes = 0

#: the open :func:`recording_collectives` logs; each call handed to
#: ``torch.distributed`` appends one record to every open log
_RECORDERS: list[list] = []


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named-axis mesh of ranks: a ``DeviceMesh`` (one rank per slot) and
    the device this rank computes on. ``shape`` maps each axis name to its
    size, as the reference's ``Mesh.shape`` does."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh, or None
    device: torch.device

    @property
    def axis_names(self) -> tuple:
        if self.device_mesh is None:
            return (WORKER_AXIS, FEATURE_AXIS)
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> dict:
        if self.device_mesh is None:
            return {WORKER_AXIS: 1, FEATURE_AXIS: 1}
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    def group(self, axis_name: str):
        """The process group of this rank's slice along ``axis_name``."""
        return self.device_mesh.get_group(self._checked(axis_name))

    def axis_size(self, axis_name: str) -> int:
        return self.shape[self._checked(axis_name)]

    def axis_index(self, axis_name: str) -> int:
        """This rank's coordinate along ``axis_name``."""
        if self.device_mesh is None:
            self._checked(axis_name)
            return 0
        dim = self.axis_names.index(self._checked(axis_name))
        return int(self.device_mesh.get_coordinate()[dim])

    def _checked(self, axis_name):
        if axis_name not in self.axis_names:
            raise ValueError(
                f"mesh axes are {self.axis_names}, not {axis_name!r}"
            )
        return axis_name


def initialize(backend: str, *, rank: int, world_size: int, init_method: str,
               timeout: float = 300.0, device=None) -> None:
    """Join the default process group: the counterpart of
    ``initialize_multihost``, with every setting explicit (nothing on the
    machine names a cluster). ``backend`` is ``"nccl"`` or ``"gloo"``;
    ``init_method`` a ``tcp://host:port`` or ``file://path`` rendezvous;
    ``timeout`` (seconds) bounds every collective of the group, so a rank
    that dies cannot hang the others forever. Under NCCL ``device`` (default:
    ``cuda:rank``) becomes this process's current card first."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    if backend == "nccl":
        torch.cuda.set_device(_mesh_device(device if device is not None else f"cuda:{rank}"))
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout),
    )


def shutdown() -> None:
    """Leave the default process group and forget the meshes built on it."""
    _DEVICE_MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Ranks in the default group; 1 when no group is initialized (one
    process is a world of one, as one device is the reference's)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def mesh_device(mesh: Mesh | None, device) -> torch.device:
    """The device a step computes on: the mesh's, or ``device`` without a
    mesh."""
    return mesh.device if mesh is not None else resolve_device(device)


def _mesh_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


#: DeviceMeshes built in this process, by default group, names and shape:
#: building one creates its groups (a collective of every rank), so the
#: same layout is built once and reused
_DEVICE_MESHES: dict = {}


def _device_mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    key = (id(dist.group.WORLD), names, shape)
    if key not in _DEVICE_MESHES:
        # the DeviceMesh's device type only decides how DTensors place; the
        # groups it builds take the default group's backend. An NCCL mesh
        # is a cuda mesh, a gloo one a cpu mesh (its CUDA tensors staged by
        # the collectives below)
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        _DEVICE_MESHES[key] = init_device_mesh(kind, shape, mesh_dim_names=names)
    return _DEVICE_MESHES[key]


def grid_mesh(names: tuple, sizes: tuple, device="cuda") -> Mesh:
    """A mesh of any number of named axes over the default group's ranks,
    row-major (C order: rank ``r``'s coordinates are ``r`` unravelled over
    ``sizes``, the last axis fastest). The product of ``sizes`` must equal
    the group's size."""
    names, sizes = tuple(names), tuple(int(s) for s in sizes)
    if len(names) != len(sizes) or len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} do not name sizes {sizes} one to one")
    if any(s < 1 for s in sizes):
        raise ValueError(
            "mesh axes must be >= 1, got "
            + ", ".join(f"{n}={s}" for n, s in zip(names, sizes))
        )
    need = 1
    for s in sizes:
        need *= s
    have = world_size()
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans the ranks of a process group: call "
            "parallel.mesh.initialize(...) (or run under parallel.mesh.launch) "
            "first"
        )
    if need != have:
        raise ValueError(
            f"mesh {'x'.join(map(str, sizes))} needs {need} ranks, have {have} "
            "(every rank of the group is one mesh slot)"
        )
    return Mesh(_device_mesh(sizes, names), _mesh_device(device))



def make_mesh(num_workers: int | None = None, num_feature_shards: int = 1, *,
              device="cuda") -> Mesh:
    """A ``(workers, features)`` mesh over the default group's ranks, this
    rank computing on ``device`` (a bare ``"cuda"`` is the current card).
    ``num_workers=None`` puts every rank not on ``features`` on
    ``workers``. The product must equal the group's size: a layout that
    does not fit is rejected loudly, never wrapped."""
    have = world_size()
    if num_workers is None:
        if have % num_feature_shards:
            raise ValueError(
                f"{have} ranks not divisible by features={num_feature_shards}"
            )
        num_workers = have // num_feature_shards
    return grid_mesh((WORKER_AXIS, FEATURE_AXIS), (num_workers, num_feature_shards),
                 device)


def make_component_mesh(num_components: int, num_feature_shards: int = 1, *,
                        device="cuda") -> Mesh:
    """A ``(components, features)`` mesh for the parallel-deflation lanes:
    one lane a components slot, rows over ``features``."""
    return grid_mesh((COMPONENT_AXIS, FEATURE_AXIS),
                 (num_components, num_feature_shards), device)


def local_mesh(device="cuda") -> Mesh:
    """The ``(1, 1)`` ``(workers, features)`` layout of one process with no
    process group: the reference's one-device mesh. Every collective over
    its axes is the identity and runs no communication, so a trainer written
    for a mesh runs unchanged on one device."""
    return Mesh(None, _mesh_device(device))


def auto_feature_mesh(cfg, device="cuda") -> Mesh | None:
    """The ``(workers, features)`` mesh of ``backend="feature_sharded"`` over
    the default group (the reference's ``auto_feature_mesh``): ``cfg.
    mesh_shape`` when given; otherwise a features axis of 2 when the group's
    size and ``cfg.dim`` are even, and the workers axis the largest divisor
    of ``cfg.num_workers`` that fits the remaining ranks. None without a
    process group (the ``(1, 1)`` layout, :func:`local_mesh`). The layout
    must use every rank of the group: one that leaves ranks out is refused
    by :func:`make_mesh`."""
    if not dist.is_initialized():
        if cfg.mesh_shape and (cfg.mesh_shape.get(WORKER_AXIS, 1),
                               cfg.mesh_shape.get(FEATURE_AXIS, 1)) != (1, 1):
            raise ValueError(
                f"mesh_shape={cfg.mesh_shape} needs a process group; one "
                "process is the (1, 1) layout"
            )
        return None
    if cfg.mesh_shape:
        return make_mesh(num_workers=cfg.mesh_shape.get(WORKER_AXIS),
                         num_feature_shards=cfg.mesh_shape.get(FEATURE_AXIS, 1),
                         device=device)
    have = world_size()
    feats = 2 if (have >= 2 and have % 2 == 0 and cfg.dim % 2 == 0) else 1
    workers = largest_divisor_leq(cfg.num_workers, max(have // feats, 1))
    return make_mesh(num_workers=workers, num_feature_shards=feats, device=device)


def largest_divisor_leq(m: int, cap: int) -> int:
    """Largest divisor of ``m`` that is <= ``cap``: the policy for sizing a
    worker axis that must divide the worker count."""
    for s in range(min(m, cap), 0, -1):
        if m % s == 0:
            return s
    return 1


def workers_mesh(m: int, device) -> Mesh | None:
    """The ``(W, 1)`` mesh of an ``m``-worker fit over the default group:
    ``W`` the largest divisor of ``m`` up to the group's size, the
    reference's policy over its devices. None outside a process group, and
    None when only a one-wide workers axis divides ``m`` in a group of
    several ranks (each rank then solves every worker itself)."""
    if not dist.is_initialized():
        return None
    have = world_size()
    workers = largest_divisor_leq(m, have)
    if workers == 1 and have > 1:
        return None
    return make_mesh(num_workers=workers, device=device)


def _shard_bounds(total: int, parts: int, index: int, what: str) -> slice:
    if total % parts:
        raise ValueError(f"{what}={total} not divisible by mesh axis of {parts}")
    per = total // parts
    return slice(index * per, (index + 1) * per)


def worker_rows(mesh: Mesh, m: int) -> slice:
    """This rank's workers ``[r m / W, (r + 1) m / W)`` of ``m``."""
    return _shard_bounds(m, mesh.axis_size(WORKER_AXIS),
                         mesh.axis_index(WORKER_AXIS), "num_workers")


def feature_rows(mesh: Mesh, d: int) -> slice:
    """This rank's rows of the feature dimension ``d``."""
    return _shard_bounds(d, mesh.axis_size(FEATURE_AXIS),
                         mesh.axis_index(FEATURE_AXIS), "dim")


def _place(x, mesh: Mesh) -> torch.Tensor:
    return torch.as_tensor(x).to(mesh.device)


def worker_shard(mesh: Mesh, x) -> torch.Tensor:
    """This rank's workers of a global ``(m, ...)`` stack on its device:
    axis 0 split over ``workers``, replicated over ``features`` (the
    reference's ``worker_sharding``). Host arrays are sliced before they
    move."""
    return _place(x[worker_rows(mesh, x.shape[0])], mesh)


def place_workers(mesh: Mesh | None, x, m: int, device) -> torch.Tensor:
    """A per-worker block on the device its step computes on: without a
    mesh all of it on ``device``; on a mesh this rank's workers on the
    mesh's device, from a block that holds all ``m`` workers (sliced here)
    or already this rank's ``m / W`` (placed as it is)."""
    if mesh is None:
        return torch.as_tensor(x).to(device)
    width = mesh.axis_size(WORKER_AXIS)
    n = x.shape[0]
    if n == m:
        return worker_shard(mesh, x)
    if width > 1 and n * width == m:
        return _place(x, mesh)
    raise ValueError(
        f"block holds {n} workers: want all {m} or this rank's "
        f"{m // width} of a {width}-wide workers axis"
    )


def feature_shard(mesh: Mesh, x) -> torch.Tensor:
    """This rank's block of a global ``(m, n, d)`` stack in the 2-D layout:
    workers over ``workers``, the trailing feature dim over ``features``
    (the reference's ``feature_sharding``)."""
    x = x[worker_rows(mesh, x.shape[0])]
    return _place(x[..., feature_rows(mesh, x.shape[-1])], mesh)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """The whole of ``x`` on this rank's device (``replicated_sharding``)."""
    return _place(x, mesh)


# -- the active mesh and its collectives ----------------------------------------

_ACTIVE: list[Mesh] = []


@contextlib.contextmanager
def mesh_scope(mesh: Mesh):
    """Make ``mesh`` the one that axis names resolve against inside the
    block: the counterpart of the body of a ``shard_map`` over it."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh() -> Mesh:
    if not _ACTIVE:
        raise RuntimeError(
            "an axis name was given but no mesh is active: run inside "
            "parallel.mesh.mesh_scope(mesh)"
        )
    return _ACTIVE[-1]


def axis_index(axis_name: str) -> int:
    return current_mesh().axis_index(axis_name)


def axis_size(axis_name: str) -> int:
    return current_mesh().axis_size(axis_name)


def _staged(group, x: torch.Tensor):
    """``(tensor to hand the collective, copy-back target or None)``: a gloo
    group takes host tensors, so a CUDA tensor goes through host memory."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().cpu().contiguous(), x
    return x, None


@contextlib.contextmanager
def recording_collectives():
    """Record every collective handed to ``torch.distributed`` inside the
    block: yields a list that gets one dict a call, ``{"op", "axis",
    "dtype", "elements", "bytes", "group_size", "tag", "shape"}``, with
    ``elements`` and ``bytes`` those of the tensor this rank handed over (an
    all-gather's own shard, an all-to-all's whole send buffer, a
    permute's block), ``shape`` the collective's result on this rank (a
    gather's whole output, else the tensor's own shape: what a compiled
    program's collective instruction carries) and ``tag`` the caller's
    label of a side payload (an int8 scale sidecar, a weight vector) or
    None. What runs no
    communication is not recorded: anything in one process without a
    group, and a sum, all-to-all or permute over a one-rank axis."""
    log: list = []
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.remove(log)


def _record(op: str, axis_name: str, x: torch.Tensor, group_size: int,
            tag=None, shape=None) -> None:
    if not _RECORDERS:
        return
    rec = {"op": op, "axis": axis_name, "dtype": str(x.dtype).replace("torch.", ""),
           "elements": x.numel(), "bytes": x.numel() * x.element_size(),
           "group_size": group_size, "tag": tag,
           "shape": list(x.shape if shape is None else shape)}
    for log in _RECORDERS:
        log.append(dict(rec))


def _all_reduce(x: torch.Tensor, axis_name: str, op) -> torch.Tensor:
    mesh = current_mesh()
    if mesh.axis_size(axis_name) == 1:  # a reduction over one rank is x
        return x
    group = mesh.group(axis_name)
    _record("psum" if op == dist.ReduceOp.SUM else "pmax", axis_name, x,
            mesh.axis_size(axis_name))
    buf, back = _staged(group, x)
    if back is None:  # reduced in place: a copy, never the caller's tensor
        buf = buf.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=op, group=group)
    return buf if back is None else buf.to(back.device)


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis_name`` (the reference's
    ``lax.psum``); every rank of the group gets the same bits."""
    return _all_reduce(x, axis_name, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Elementwise max over the ranks of ``axis_name`` (``lax.pmax``)."""
    return _all_reduce(x, axis_name, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis_name: str, *, tiled: bool = True,
               tag=None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis_name`` in group-rank order:
    concatenated on axis 0 (``tiled``, the reference's ``all_gather(...,
    axis=0, tiled=True)``) or stacked on a new axis 0. ``tag`` labels the
    call in :func:`recording_collectives`."""
    global gathers, gather_bytes
    mesh = current_mesh()
    if mesh.device_mesh is None:  # one process: the gather of one rank
        mesh._checked(axis_name)
        return x if tiled else x[None]
    group = mesh.group(axis_name)
    x = x.detach().contiguous()
    g = mesh.axis_size(axis_name)
    whole = ((g * x.shape[0], *x.shape[1:]) if tiled and x.dim() else (g, *x.shape))
    _record("all_gather", axis_name, x, g, tag, whole)
    buf, back = _staged(group, x)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    gathers += 1
    gather_bytes += x.numel() * x.element_size()
    out = torch.cat(parts, dim=0) if tiled else torch.stack(parts)
    return out if back is None else out.to(back.device)


def all_to_all(x: torch.Tensor, axis_name: str, *, tag=None) -> torch.Tensor:
    """The reference's ``lax.all_to_all(x, axis_name, split_axis=0,
    concat_axis=0)``: ``x (g, ...)`` with ``g`` the axis size; slot ``j``
    goes to group rank ``j``, and slot ``j`` of the result is what group
    rank ``j`` sent this rank."""
    mesh = current_mesh()
    size = mesh.axis_size(axis_name)
    if x.shape[0] != size:
        raise ValueError(
            f"all_to_all over {axis_name!r} splits axis 0 into {size} slots, "
            f"got shape {tuple(x.shape)}"
        )
    if mesh.device_mesh is None or size == 1:
        return x
    group = mesh.group(axis_name)
    x = x.detach().contiguous()
    _record("all_to_all", axis_name, x, size, tag)
    buf, back = _staged(group, x)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out if back is None else out.to(back.device)


def ppermute(x: torch.Tensor, axis_name: str, *, tag=None) -> torch.Tensor:
    """The cyclic +1 neighbour exchange over ``axis_name`` (the reference's
    ``ppermute`` with ``[(i, (i + 1) % size)]``): this rank sends ``x`` to
    group rank ``i + 1`` and returns what group rank ``i - 1`` sent."""
    mesh = current_mesh()
    size = mesh.axis_size(axis_name)
    if mesh.device_mesh is None or size == 1:
        return x
    group = mesh.group(axis_name)
    i = mesh.axis_index(axis_name)
    x = x.detach().contiguous()
    _record("ppermute", axis_name, x, size, tag)
    buf, back = _staged(group, x)
    out = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, dist.get_global_rank(group, (i + 1) % size), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - 1) % size), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out if back is None else out.to(back.device)


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """Whether ``flag`` is True on any rank of ``mesh``: one MAX all-reduce
    of a one-element flag over the mesh's ranks (the default group when the
    mesh spans it, else axis by axis), recorded as ``"pmax"`` over
    ``"mesh"``; ``flag`` itself in one process."""
    if mesh.device_mesh is None:
        return flag
    x = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    if mesh.device_mesh.size() == world_size():
        _record("pmax", "mesh", x, world_size())
        buf, back = _staged(None, x)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX)
        return bool(buf.item())
    with mesh_scope(mesh):
        for axis in mesh.axis_names:
            x = pmax(x, axis)
    return bool(x.item())


def barrier() -> None:
    """Wait for every rank of the default group (no-op in a world of one)."""
    if world_size() > 1:
        dist.barrier()


def is_writer() -> bool:
    """Whether this rank performs host side effects (rank 0, or the one
    process of a world of one)."""
    return rank() == 0


def on_writer(mesh: Mesh | None, fn, *args) -> None:
    """A host side effect of a mesh run (a hook, a commit): ``fn(*args)``
    on the writer rank, then a barrier so no rank runs ahead of it; without
    a mesh, ``fn(*args)`` here."""
    if mesh is None or is_writer():
        fn(*args)
    if mesh is not None:
        barrier()


# -- the launcher ----------------------------------------------------------------


class RankTimeout(TimeoutError):
    """The ranks of a :func:`launch` did not finish within its timeout."""


def _rank_main(fn, rank_, world, backend, init_method, timeout, args, conn) -> None:
    torch.set_num_threads(1)
    try:
        initialize(backend, rank=rank_, world_size=world, init_method=init_method,
                   timeout=timeout)
        result = fn(rank_, world, *args)
    except BaseException as e:  # noqa: BLE001 - reported to the caller
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps(e)
        except Exception:  # noqa: BLE001 - an unpicklable exception
            payload = None
        conn.send((False, (payload, tb)))
        conn.close()
        # leave at once: the parent kills the other ranks, so nothing waits
        # on this rank's part of a collective
        os._exit(1)
    conn.send((True, result))
    conn.close()
    shutdown()


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(5)


def launch(fn, world: int, *args, backend: str = "gloo", timeout: float = 300.0,
           workdir: str | None = None) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks started here with
    ``spawn``, each in the default process group of ``backend`` (joined
    through a ``file://`` rendezvous under ``workdir``, default a fresh
    temporary directory); returns each rank's return value, in rank order.

    ``fn`` and its arguments and results must pickle (a module-level
    function). Every rank runs one intra-op thread. The ranks are joined
    within ``timeout`` seconds, which also bounds each collective inside
    them: on expiry every rank is killed and :class:`RankTimeout` raised;
    when a rank raises, the others are killed and its exception is raised
    here, its traceback attached."""
    ctx = multiprocessing.get_context("spawn")
    with contextlib.ExitStack() as stack:
        if workdir is None:
            workdir = stack.enter_context(tempfile.TemporaryDirectory(prefix="det_launch_"))
        fd, path = tempfile.mkstemp(prefix="rendezvous_", dir=workdir)
        os.close(fd)
        os.unlink(path)  # the file store creates it
        init = f"file://{path}"
        procs, pending = [], {}
        try:
            for r in range(world):
                recv, send = ctx.Pipe(duplex=False)
                p = ctx.Process(
                    target=_rank_main,
                    args=(fn, r, world, backend, init, timeout, args, send),
                    daemon=True,
                )
                p.start()
                send.close()
                procs.append(p)
                pending[recv] = r
            results = [None] * world
            deadline = time.monotonic() + timeout
            while pending:
                left = deadline - time.monotonic()
                ready = multiprocessing.connection.wait(list(pending), max(left, 0))
                if not ready:
                    raise RankTimeout(
                        f"ranks {sorted(pending.values())} of {world} did not "
                        f"finish within {timeout} s"
                    )
                for conn in ready:
                    r = pending.pop(conn)
                    try:
                        ok, payload = conn.recv()
                    except EOFError:
                        procs[r].join(5)
                        raise RuntimeError(
                            f"rank {r} of {world} exited (code "
                            f"{procs[r].exitcode}) without a result"
                        ) from None
                    if not ok:
                        raise _rank_error(r, world, *payload)
                    results[r] = payload
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
            return results
        finally:
            _kill(procs)


def _rank_error(r: int, world: int, payload, tb: str) -> BaseException:
    err = None
    if payload is not None:
        try:
            err = pickle.loads(payload)
        except Exception:  # noqa: BLE001
            err = None
    if err is None:
        return RuntimeError(f"rank {r} of {world} raised:\n{tb}")
    err.add_note(f"raised on rank {r} of {world}:\n{tb}")
    return err
