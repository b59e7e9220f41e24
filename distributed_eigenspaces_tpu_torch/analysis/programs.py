"""The audited program matrix of the port: every program runs once, at
audit-sized shapes, on the device asked for.

Counterpart of ``distributed_eigenspaces_tpu/analysis/programs.py``, with
its names and audit shapes (d=64, k=2, m=4, n=8, T=3; d=128 on the
features path; B=8; cohort 16; 16 rows for serve; 1024 / 256 / 8 / 32 for
the kernels). A :class:`BuiltProgram` holds what one call of the program
did: the buffers it materialized (:func:`trace_buffers`), its FLOPs
(``FlopCounterMode``), the collectives it handed to ``torch.distributed``
(``parallel.mesh.recording_collectives``) and the
:class:`~..ops.geometry.KernelLaunch` records of its hand-written kernels:

- on the card the program really runs, under :func:`~..ops.geometry.
  recording`, so the records are the launches it made (``torch.profiler``
  holds them against the card in ``chip_smoke.py``);
- on the CPU the kernels cannot run; the program runs its plain versions
  for the buffer trace, and a single-device program's records come from
  the ``*_launch`` functions at the same shapes — what the JAX audit gets
  from ``interpret=True``: the blocks, not the execution.

:data:`PROGRAMS` run in this process. :data:`MESH_PROGRAMS` — the scan
family, the tree, the feature-sharded cores, the fleet, the row-sharded
serve transforms, the cohort reduce, the distributed merge and extract, the
deflation lanes and the sharded-basis serve — run on a mesh of
:data:`MESH_RANKS` gloo ranks that
:func:`build_matrix` starts with ONE ``parallel.mesh.launch`` for all of
them and for the seeded mesh mutations (on the card the ranks share it, as
``chip_smoke.py``'s ``slice_tree_ranks4`` does). Where the reference takes
8 devices the port keeps 4 ranks and says so in ``ProgramParams``: the
features cores, the distributed merge and extract and the sharded-basis
serve on workers 2 x features 2, the deflation lanes on components 2 x
features 2 (2 lanes of width 4 where the reference runs 4 of width 2), the
fleet with 2 tenants a rank, the row-sharded serve with 4 of its 16 rows a
rank, the cohort of 16 over 4 ranks; the bounds are evaluated at the params
of the mesh that ran. Rank 0's run forms the ``BuiltProgram``; every other
rank's collective records are held against it (``schedule_diffs``), and
every rank's held shapes go to the sharding pass. The
matrix is built once a process and device type (the reference caches its
builds the same way).

Every mesh program's build also states the GLOBAL shape of each tensor leaf
of its inputs and its output and the sizes of its mesh's axes
(:class:`GlobalLeaves`, the counterpart of the reference's avals and
shardings); every rank hands the program its own share of the data and
records the LOCAL shapes it held and the buffers of its trace that reach the
contract's floor (``shardings.HeldShapes``). The sharding pass holds every
rank's record against the global view. The row-sharded serve programs and
the ``dist_serve`` ones run the port's ``TransformEngine`` on each rank's
rows (with ``basis_spec``, its ``(rows, d_local)`` columns and ``(d_local,
k)`` basis rows); each audits one bucket of the engine, and a reconstruct or
residual program takes the engine's own projection of those rows, made by
its build before the audited call (the build's kernel launches are the
program's ``setup_launches``). The deflation lanes' seed blocks are drawn
with numpy from a seed, each rank given only its rows; the distributed
merge and extract draw their starts inside the audited call, each rank its
own rows (``ops.linalg.start_rows``), as the trainers do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from distributed_eigenspaces_tpu_torch.analysis.contracts import ProgramParams
from distributed_eigenspaces_tpu_torch.device import resolve_device
from distributed_eigenspaces_tpu_torch.ops.geometry import KernelLaunch, recording

# audit shapes: d=64 solo / fleet / serve, d=128 over 2 feature shards
# (d_local=64); everything else well below 64
_D, _K, _M, _N, _T = 64, 2, 4, 8, 3
_FEAT_D = 128
_FLEET_B = 8
_COHORT = 16
_SERVE_ROWS = 16
#: the ranks every mesh program runs on (the reference's 8 virtual devices)
MESH_RANKS = 4
# kernel-audit shapes: LARGE enough that a full-operand block is
# distinguishable from a tile — and the legit kernels sit far under the
# 131072-elem budget that the mutant's full (rows, d) CTA (262144) trips
_PALLAS_D, _PALLAS_ROWS, _PALLAS_K, _PALLAS_F = 1024, 256, 8, 32


@dataclass
class BuiltProgram:
    """One audited program after one call on ``device``."""

    name: str
    contract: str  # key into contracts.CONTRACTS
    params: ProgramParams
    #: the callable and its inputs (None / () for a mesh program, which ran
    #: in the ranks of a launch)
    fn: Callable | None
    args: tuple
    device: torch.device
    #: the hand-written kernels' launches (recorded on the card, declared
    #: by the ``*_launch`` functions on the CPU)
    launches: tuple[KernelLaunch, ...]
    #: ``(where, shape, dtype)`` of every input and every aten op output
    buffers: tuple
    #: the source whose kernel or trainer the program audits
    source: str | None = None
    #: what the call returned; for a mesh program each rank's output tensor
    #: leaves as numpy arrays, by rank
    output: Any = None
    #: the collectives the call handed to ``torch.distributed`` (rank 0's),
    #: as ``parallel.mesh.recording_collectives`` records them
    collectives: tuple = ()
    #: FLOPs of the call as ``torch.utils.flop_counter`` counts them, on the
    #: CPU (0 on the card, whose hand kernels it cannot see)
    flops: int = 0
    #: how another rank's collective schedule differed from rank 0's
    schedule_diffs: tuple = ()
    #: a mesh program's global view (:class:`GlobalLeaves`; None off a mesh)
    leaves: GlobalLeaves | None = None
    #: every rank's ``shardings.HeldShapes`` (empty off a mesh)
    held: tuple = ()
    #: the kernel launches a mesh program's build made before the audited
    #: call (rank 0's, on the card; the serve programs' projections)
    setup_launches: tuple = ()


@dataclass(frozen=True)
class GlobalLeaves:
    """What a mesh program's build states about the whole program, apart
    from any rank: the global shape of each tensor leaf of its inputs and
    of its output, in pytree order, and the sizes of its mesh's axes. The
    sharding pass holds each rank's local shapes against these."""

    ins: tuple
    outs: tuple
    axis_sizes: dict

    @classmethod
    def of(cls, ins, outs, mesh) -> "GlobalLeaves":
        return cls(ins=tuple(tuple(s) for s in ins), outs=tuple(tuple(s) for s in outs),
                   axis_sizes=dict(mesh.shape))


class _BufferTrace(TorchDispatchMode):
    """Records the shape of every tensor each aten op returns."""

    def __init__(self):
        super().__init__()
        self.buffers: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.buffers.append((str(func), tuple(t.shape), str(t.dtype)))
        return out


def trace_buffers(fn, *args):
    """``(fn(*args), buffers)``: ``buffers`` lists ``(where, shape,
    dtype)`` for every tensor input and every tensor an aten op returned
    during the call — the port's counterpart of walking a jaxpr's avals."""
    inputs = [("<input>", tuple(a.shape), str(a.dtype))
              for a in tree_leaves(args) if isinstance(a, torch.Tensor)]
    with _BufferTrace() as trace:
        out = fn(*args)
    return out, tuple(inputs + trace.buffers)


def _normal(shape, seed: int, device) -> torch.Tensor:
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device)


def _orthonormal(d: int, k: int, seed: int, device) -> torch.Tensor:
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((d, k)))
    return torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32)).to(device)


def _run_traced(fn, args, device, *, count_flops: bool = True):
    """``(out, buffers, flops, collectives, launches)`` of one call of
    ``fn(*args)`` under the buffer trace, the collective recorder and, on
    the card, the launch recorder; on the CPU under the FLOP counter too
    (on the card it would count none of the hand kernels' FLOPs, and its
    formulas do not take ``torch.bmm``'s ``out_dtype``: 0 there; 0 also
    with ``count_flops`` off)."""
    import contextlib

    from torch.utils.flop_counter import FlopCounterMode

    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    counter = (FlopCounterMode(display=False) if device.type == "cpu" and count_flops
               else None)
    with recording() as launches, pmesh.recording_collectives() as log:
        with counter or contextlib.nullcontext():
            out, buffers = trace_buffers(fn, *args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    flops = int(counter.get_total_flops()) if counter is not None else 0
    return out, buffers, flops, tuple(log), tuple(launches)


def _built(name, contract, params, fn, args, declare, source, device):
    """Run ``fn(*args)`` once (:func:`_run_traced`); on the CPU the kernel
    records are ``declare(*args)``."""
    out, buffers, flops, log, launches = _run_traced(fn, args, device)
    if device.type != "cuda":
        launches = tuple(declare(*args))
    return BuiltProgram(
        name=name, contract=contract, params=params, fn=fn, args=args,
        device=device, launches=launches, buffers=buffers,
        source=source, output=out, collectives=log, flops=flops,
    )


def _serve_program(name: str):
    """The port's ``TransformEngine`` fp32 project on one device: on the
    card the fixed-order serve kernel (``det_serve_project_f32``)."""

    def build(device) -> BuiltProgram:
        from distributed_eigenspaces_tpu_torch.ops.serve_project import (
            serve_project_launch,
        )
        from distributed_eigenspaces_tpu_torch.serving.transform import (
            TransformEngine,
            bucket_rows,
        )

        eng = TransformEngine(_D, _K, device=device)
        x = _normal((_SERVE_ROWS, _D), 0, device)
        v = _orthonormal(_D, _K, 1, device)

        def declare(x, v):
            rows = bucket_rows(x.shape[0], min_bucket=eng.min_bucket)
            return [serve_project_launch(rows, _D, _K, torch.float32, "f32")]

        return _built(
            name, "serve_transform",
            ProgramParams(d=_D, k=_K, rows=_SERVE_ROWS),
            eng.project, (x, v), declare, "csrc/serve_project.cu", device,
        )

    return build


def _kernel_program(name: str, kind: str):
    """The hand-written serve / solver kernels at the kernel-audit shapes,
    through the ``*_auto`` functions the port's callers use."""

    def build(device) -> BuiltProgram:
        from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg
        from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

        d, rows, k, f = _PALLAS_D, _PALLAS_ROWS, _PALLAS_K, _PALLAS_F
        x = _normal((rows, d), 2, device)
        v = _orthonormal(d, k, 3, device)
        if kind == "project_bf16":
            fn, args, source = sp.serve_project_auto, (x, v), "csrc/serve_project.cu"

            def declare(x, v):
                return [sp.serve_project_launch(rows, d, k, x.dtype, "bf16")]
        elif kind == "project_i8":
            q, s = sp.quantize_basis_i8(v)
            fn, args, source = sp.serve_project_i8_auto, (x, q, s), "csrc/serve_project.cu"

            def declare(x, q, s):
                return [sp.serve_project_launch(rows, d, k, x.dtype, "i8")]
        else:  # matvec_gram: the large-d solver's fused inner sweep
            c = _normal((d, f), 4, device)
            fn, args, source = mg.matvec_gram_auto, (c, v), "csrc/matvec_gram.cu"

            def declare(c, v):
                return [mg.matvec_gram_launch(d, f, k)]

        return _built(
            name, "serve_pallas",
            ProgramParams(d=d, k=k, rows=rows, sketch_width=f),
            fn, args, declare, source, device,
        )

    return build


#: name -> build function taking the device: the programs that run in this
#: process
PROGRAMS: dict[str, Callable[[torch.device], BuiltProgram]] = {
    "serve_project_solo": _serve_program("serve_project_solo"),
    "pallas_serve_project_bf16": _kernel_program(
        "pallas_serve_project_bf16", "project_bf16"
    ),
    "pallas_serve_project_i8": _kernel_program(
        "pallas_serve_project_i8", "project_i8"
    ),
    "pallas_matvec_gram": _kernel_program("pallas_matvec_gram", "matvec_gram"),
}


# -- the mesh programs ---------------------------------------------------------


def _cfg(**kw):
    from distributed_eigenspaces_tpu_torch.config import PCAConfig

    base = dict(
        dim=_D, k=_K, num_workers=_M, rows_per_worker=_N, num_steps=_T,
        solver="subspace", subspace_iters=2, warm_start_iters=1,
        compute_dtype="bfloat16",
    )
    base.update(kw)
    return PCAConfig(**base)


#: this rank's meshes, by layout: a ``DeviceMesh`` a layout, made once
_RANK_MESHES: dict = {}


def rank_mesh(kind: str, device):
    """This rank's mesh of one layout of the matrix (made once a launch):
    ``"workers"`` (4 workers), ``"tiered"`` (chip 2 x host 2),
    ``"features"`` (``auto_feature_mesh`` of the feature-sharded config:
    workers 2 x features 2), ``"components"`` (components 2 x features 2)
    or ``"fleet"`` (``fleet_mesh(8)``: 2 tenants a rank)."""
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    if kind not in _RANK_MESHES:
        if kind == "workers":
            mesh = pmesh.make_mesh(num_workers=MESH_RANKS, device=device)
        elif kind == "tiered":
            from distributed_eigenspaces_tpu_torch.parallel import topology as tp

            topo = tp.MergeTopology((("chip", 2), ("host", 2)))
            mesh = tp.make_tiered_mesh(topo, device=device)
        elif kind == "features":
            mesh = pmesh.auto_feature_mesh(_cfg(dim=_FEAT_D, backend="feature_sharded"),
                                           device)
        elif kind == "components":
            mesh = pmesh.make_component_mesh(_LANES, MESH_RANKS // _LANES, device=device)
        else:
            from distributed_eigenspaces_tpu_torch.parallel.fleet import fleet_mesh

            mesh = fleet_mesh(_FLEET_B, device=device)
        _RANK_MESHES[kind] = mesh
    return _RANK_MESHES[kind]


def _steps() -> torch.Tensor:
    """The scan and tree programs' whole ``(T, m, n, d)`` bf16 schedule: the
    same seeded draw on every rank, of which each keeps its own workers."""
    return _normal((_T, _M, _N, _D), 7, "cpu").to(torch.bfloat16)


def _fit_leaves(mesh, masked: bool) -> GlobalLeaves:
    """The scan and tree fits' global leaves: in the carried ``sigma_tilde``,
    the ``(T, m, n, d)`` schedule (and the ``(T, m)`` mask); out
    ``sigma_tilde`` and the ``(T, d, k)`` bases of the steps."""
    ins = [(_D, _D), (_T, _M, _N, _D)] + ([(_T, _M)] if masked else [])
    return GlobalLeaves.of(ins, [(_D, _D), (_T, _D, _K)], mesh)


def _scan_mesh(masked: bool = False, **cfg_kw):
    def build(rank, world, device):
        from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
        from distributed_eigenspaces_tpu_torch.algo.scan import make_scan_fit
        from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

        cfg = _cfg(**cfg_kw)
        mesh = rank_mesh("workers", device)
        fit = make_scan_fit(cfg, mesh=mesh, device=device, masked=masked)
        mine = _steps()[:, pmesh.worker_rows(mesh, _M)]
        args = (OnlineState.initial(_D, device=device), mine.to(device))
        if masked:
            args += (torch.ones((_T, _M)),)
        params = ProgramParams(d=_D, k=_K, m=_M, n=_N, T=_T, n_workers_mesh=world)
        return fit, args, params, _fit_leaves(mesh, masked)

    return "scan_fit", "algo/scan.py", build


def _tree_mesh(masked: bool = False, wire: dict | None = None):
    """The tiered tree fit on chip 2 x host 2 (the reference's topology, on
    4 ranks as on its 4 workers), each rank given its leaf worker's blocks.
    The bound shows the tree's point: max(d*k, (f*k)^2) = 128 elems against
    the flat stack's m*d*k = 512. ``wire`` runs the same fit under a
    ``merge_wire_dtype`` policy, whose codecs the ``collective-wire-dtype``
    rule audits on the data movers."""

    def build(rank, world, device):
        from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
        from distributed_eigenspaces_tpu_torch.algo.scan import make_scan_fit
        from distributed_eigenspaces_tpu_torch.parallel.topology import (
            flat_worker_index,
            resolve_topology,
        )
        from distributed_eigenspaces_tpu_torch.parallel.wire import resolve_wire_policy

        cfg = _cfg(merge_topology=(("chip", 2), ("host", 2)), merge_wire_dtype=wire)
        topo = resolve_topology(cfg)
        mesh = rank_mesh("tiered", device)
        fit = make_scan_fit(cfg, mesh=mesh, device=device, masked=masked)
        leaf = flat_worker_index(topo, mesh)
        args = (OnlineState.initial(_D, device=device), _steps()[:, leaf:leaf + 1].to(device))
        if masked:
            args += (torch.ones((_T, _M)),)
        params = ProgramParams(
            d=_D, k=_K, m=_M, n=_N, T=_T, n_workers_mesh=world,
            tier_fan_ins=topo.fan_ins, tier_axes=topo.names,
            tier_wire_dtypes=resolve_wire_policy(cfg, topo) or (),
        )
        return fit, args, params, _fit_leaves(mesh, masked)

    return "tree_merge", "parallel/topology.py", build


def _feature_mesh(kind: str):
    """The feature-sharded scan (rank-r state) or sketch on workers 2 x
    features 2, each rank given its workers' columns of the blocks."""

    def build(rank, world, device):
        from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as fs
        from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

        cfg = _cfg(dim=_FEAT_D, backend="feature_sharded")
        mesh = rank_mesh("features", device)
        mk = (fs.make_feature_sharded_scan_fit if kind == "scan"
              else fs.make_feature_sharded_sketch_fit)
        fit = mk(cfg, mesh, device=device)
        blocks = _normal((3, _M, _N, _FEAT_D), 8, "cpu").to(torch.bfloat16)
        blocks = blocks[:, pmesh.worker_rows(mesh, _M)][..., pmesh.feature_rows(mesh, _FEAT_D)]
        idx = torch.arange(2 * _T) % 3
        sketch_width = int(getattr(fit, "sketch_width", 0) or 0)
        params = ProgramParams(
            d=_FEAT_D, k=_K, m=_M, n=_N, T=2 * _T,
            n_feature_shards=mesh.axis_size(pmesh.FEATURE_AXIS),
            n_workers_mesh=mesh.axis_size(pmesh.WORKER_AXIS),
            sketch_width=sketch_width,
        )
        # the carried state: the rank-r (U, s), or the sketch's (Y, V)
        state = ([(_FEAT_D, fit.rank), (fit.rank,)] if kind == "scan"
                 else [(_FEAT_D, sketch_width), (_FEAT_D, _K)])
        leaves = GlobalLeaves.of(state + [(3, _M, _N, _FEAT_D), (2 * _T,)], state, mesh)
        return fit, (fit.init_state(), blocks.to(device), idx), params, leaves

    return "feature_sharded", "parallel/feature_sharded.py", build


def _fleet_mesh(masked: bool = False):
    def build(rank, world, device):
        from distributed_eigenspaces_tpu_torch.parallel import fleet

        cfg = _cfg()
        mesh = rank_mesh("fleet", device)
        per = _FLEET_B // world
        mine = slice(rank * per, (rank + 1) * per)
        fit = fleet.make_fleet_fit(cfg, mesh, masked=masked, device=device)
        xs = _normal((_FLEET_B, _T, _M, _N, _D), 9, "cpu")[mine].to(torch.bfloat16)
        args = (fleet.init_fleet_states(cfg, per, device=device), xs.to(device))
        if masked:
            args += (torch.ones((per, _T, _M)),)
        args += (torch.ones((per, _T)),)
        params = ProgramParams(d=_D, k=_K, m=_M, n=_N, T=_T, B=_FLEET_B,
                               n_workers_mesh=world)
        state = [(_FLEET_B, _D, _D), (_FLEET_B,)]
        ins = (state + [(_FLEET_B, _T, _M, _N, _D)]
               + ([(_FLEET_B, _T, _M)] if masked else []) + [(_FLEET_B, _T)])
        leaves = GlobalLeaves.of(ins, state + [(_FLEET_B, _T, _D, _K)], mesh)
        return fit, args, params, leaves

    return "fleet_fit", "parallel/fleet.py", build


def _serve_rows_mesh(kind: str):
    """The port's ``TransformEngine(mesh=)`` on the 4-worker mesh: each rank
    serves its 4 of the 16 query rows against the whole (replicated) basis,
    with zero collectives. The audited call is the engine's bucket of
    ``kind`` alone; ``reconstruct`` and ``residual`` take the engine's own
    projection of the rank's rows, made before the audited call."""

    def build(rank, world, device):
        from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
        from distributed_eigenspaces_tpu_torch.serving.transform import TransformEngine

        mesh = rank_mesh("workers", device)
        eng = TransformEngine(_D, _K, mesh=mesh)
        x = _normal((_SERVE_ROWS, _D), 0, "cpu")[pmesh.worker_rows(mesh, _SERVE_ROWS)]
        params = ProgramParams(d=_D, k=_K, rows=_SERVE_ROWS, n_workers_mesh=world)
        fn, args, ins = _bucket(eng, kind, x.to(device), _orthonormal(_D, _K, 1, device),
                                _SERVE_ROWS, _D)
        return fn, args, params, GlobalLeaves.of(ins, _served_outs(kind, _SERVE_ROWS, _D),
                                                 mesh)

    return "serve_transform", "serving/transform.py", build


def _bucket(eng, kind: str, x, v, rows: int, d: int):
    """``(fn, args, global input shapes)`` of the engine's bucket of
    ``kind`` on a rank's query rows ``x`` and basis ``v``: the projection
    ``(x, v)``, the reconstruction ``(z, v)`` or the residual and input
    energies ``(x, z)``, ``z`` the engine's projection of ``x`` made here,
    outside the audited call (on the card it launches the serve kernel)."""
    if kind == "project":
        return eng.project, (x, v), [(rows, d), (d, _K)]
    z = eng.project(x, v)
    if kind == "reconstruct":
        return eng.reconstruct, (z, v), [(rows, _K), (d, _K)]
    return eng.residual_energy, (x, z), [(rows, d), (rows, _K)]


def _served_outs(kind: str, rows: int, d: int) -> list:
    return {"project": [(rows, _K)], "reconstruct": [(rows, d)],
            "residual": [(rows,), (rows,)]}[kind]


def _population_mesh():
    """The cohort reduce: the hardened merge of one sampled cohort's (d, k)
    client bases, cohort-sharded over the workers axis — ONE all-gather of
    the (cohort, d, k) stack, a function of the cohort, never the
    population."""

    def build(rank, world, device):
        from distributed_eigenspaces_tpu_torch.parallel.clients import (
            make_sharded_cohort_reduce,
        )

        cfg = _cfg(population=1024, cohort_size=_COHORT, max_poison_frac=0.1)
        mesh = rank_mesh("workers", device)
        reduce = make_sharded_cohort_reduce(cfg, mesh)
        q, _ = torch.linalg.qr(_normal((_COHORT, _D, _K), 10, "cpu"))
        per = _COHORT // world
        mine = slice(rank * per, (rank + 1) * per)
        args = (q[mine].contiguous().to(device), torch.ones(per).to(device))
        params = ProgramParams(d=_D, k=_K, m=_COHORT, n_workers_mesh=world)
        leaves = GlobalLeaves.of([(_COHORT, _D, _K), (_COHORT,)], [(_D, _K)], mesh)
        return reduce, args, params, leaves

    return "population_merge", "parallel/clients.py", build


def _rows(a: np.ndarray, mesh, device) -> torch.Tensor:
    """This rank's ``features`` rows of a whole numpy block."""
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    return torch.from_numpy(np.ascontiguousarray(
        a[pmesh.feature_rows(mesh, a.shape[0])])).to(device)


def _dist_merge_mesh():
    """The distributed MERGE solve, ``dist_merged_top_k`` on workers 2 x
    features 2 (the crossover twin of the feature-sharded exact merge):
    each rank holds its workers' rows of the ``(m, d, k)`` factor stack,
    near one planted basis, and draws, inside the audited call, its rows of
    the start as the feature-sharded trainer does (``algo.step.merge_start``
    with this rank's rows). The dist_solve contract's subject: the worker
    factor-stack gather plus k-wide feature sums only, output a ``(d_local,
    k)`` row shard."""

    def build(rank, world, device):
        from distributed_eigenspaces_tpu_torch.algo.step import merge_start
        from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
        from distributed_eigenspaces_tpu_torch.solvers.distributed import dist_merged_top_k

        mesh = rank_mesh("features", device)
        cfg = _cfg(dim=_FEAT_D, solver="distributed", eigh_crossover_d=_FEAT_D // 2,
                   subspace_iters=2)
        vws, mask = dist_merge_inputs()
        w = pmesh.worker_rows(mesh, _M)
        rows = pmesh.feature_rows(mesh, _FEAT_D)
        args = (torch.from_numpy(vws[w][:, rows]).to(device),
                torch.from_numpy(mask[w]).to(device))

        def merge(vws, mask):
            with pmesh.mesh_scope(mesh):
                start = merge_start(cfg, device=vws.device, rows=rows)
                return dist_merged_top_k(vws, _K, mask=mask, iters=cfg.subspace_iters,
                                         v_init=start)

        params = ProgramParams(d=_FEAT_D, k=_K, m=_M, n_feature_shards=2,
                               n_workers_mesh=mesh.axis_size(pmesh.WORKER_AXIS))
        leaves = GlobalLeaves.of([(_M, _FEAT_D, _K), (_M,)], [(_FEAT_D, _K)], mesh)
        return merge, args, params, leaves

    return "dist_solve", "solvers/distributed.py", build


def _dist_extract_mesh():
    """The distributed serving extract, ``dist_extract_top_k`` of a rank-8
    state ``U diag(s) U^T`` from its row-sharded factors on workers 2 x
    features 2: the publish-time solve above the crossover whose basis is
    born sharded. Its start is the solver's own, each rank drawing its rows
    inside the audited call, as the reference's program leaves it."""

    def build(rank, world, device):
        from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
        from distributed_eigenspaces_tpu_torch.solvers.distributed import dist_extract_top_k

        mesh = rank_mesh("features", device)
        u, s = state_factors()

        def extract(u, s):
            with pmesh.mesh_scope(mesh):
                return dist_extract_top_k(u, s, _K, iters=2, axis_name=pmesh.FEATURE_AXIS)

        params = ProgramParams(d=_FEAT_D, k=_K, m=1, n_feature_shards=2,
                               n_workers_mesh=mesh.axis_size(pmesh.WORKER_AXIS),
                               sketch_width=_R)
        leaves = GlobalLeaves.of([(_FEAT_D, _R), (_R,)], [(_FEAT_D, _K)], mesh)
        return extract, (_rows(u, mesh, device), torch.from_numpy(s).to(device)), params, leaves

    return "dist_solve", "solvers/distributed.py", build


def _deflation_mesh():
    """The parallel-deflation solve, ``dist_deflation_eig`` on components 2
    x features 2: 2 lanes of width 4 (k=8), each iterating its ``(d_local,
    4)`` block against the rank-8 state operator with corrections from the
    lane below. The per-lane seed blocks ``(lanes, d, k / lanes)`` enter
    sharded over ``('components', 'features')``, so the new axis is audited
    non-vacuously."""

    def build(rank, world, device):
        from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
        from distributed_eigenspaces_tpu_torch.solvers.deflation import dist_deflation_eig
        from distributed_eigenspaces_tpu_torch.solvers.distributed import lowrank_matvec

        mesh = rank_mesh("components", device)
        u, s = state_factors()
        seeds = deflation_seeds()
        lane = mesh.axis_index(pmesh.COMPONENT_AXIS)
        mine = seeds[lane:lane + 1, pmesh.feature_rows(mesh, _FEAT_D)]

        def solve(v0, u, s):
            with pmesh.mesh_scope(mesh):
                return dist_deflation_eig(lowrank_matvec(u, s, pmesh.FEATURE_AXIS),
                                          u.shape[0], _DEFL_K, lanes=_LANES, iters=2,
                                          v0=v0[0])

        args = (torch.from_numpy(np.ascontiguousarray(mine)).to(device),
                _rows(u, mesh, device), torch.from_numpy(s).to(device))
        params = ProgramParams(d=_FEAT_D, k=_DEFL_K, m=1, n_feature_shards=2,
                               n_workers_mesh=_LANES, sketch_width=_R, components=_LANES)
        leaves = GlobalLeaves.of(
            [(_LANES, _FEAT_D, _DEFL_K // _LANES), (_FEAT_D, _R), (_R,)],
            [(_FEAT_D, _DEFL_K)], mesh)
        return solve, args, params, leaves

    return "deflation_solve", "solvers/deflation.py", build


def _dist_serve_mesh(kind: str):
    """Sharded-basis serving: the port's ``TransformEngine(basis_spec=
    ("features", None))`` on workers 2 x features 2. Each rank holds its
    workers' 8 of the 16 query rows, its 64 of their 128 columns and its 64
    rows of the basis; the audited call is the engine's bucket of ``kind``
    alone (as :func:`_serve_rows_mesh`): ``project`` is the serve kernel on
    that shard and one ``(rows, k)`` sum over ``features``, ``reconstruct``
    is row-local, ``residual`` sums the ``(rows,)`` input energies."""

    def build(rank, world, device):
        from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
        from distributed_eigenspaces_tpu_torch.serving.transform import TransformEngine

        mesh = rank_mesh("features", device)
        eng = TransformEngine(_FEAT_D, _K, mesh=mesh, basis_spec=(pmesh.FEATURE_AXIS, None))
        x = _normal((_SERVE_ROWS, _FEAT_D), 14, "cpu")
        x = x[pmesh.worker_rows(mesh, _SERVE_ROWS)][:, pmesh.feature_rows(mesh, _FEAT_D)]
        v = _rows(_orthonormal(_FEAT_D, _K, 15, "cpu").numpy(), mesh, device)
        params = ProgramParams(d=_FEAT_D, k=_K, rows=_SERVE_ROWS, n_feature_shards=2,
                               n_workers_mesh=mesh.axis_size(pmesh.WORKER_AXIS))
        fn, args, ins = _bucket(eng, kind, x.contiguous().to(device), v, _SERVE_ROWS,
                                _FEAT_D)
        leaves = GlobalLeaves.of(ins, _served_outs(kind, _SERVE_ROWS, _FEAT_D), mesh)
        return fn, args, params, leaves

    return "dist_serve", "serving/transform.py", build


# -- the dist and deflation programs' operands (numpy, from seeds) --------------

#: the extract's and the lanes' state rank, the lanes' k and lane count
_R, _DEFL_K, _LANES = 8, 8, 2


def _seeded(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def dist_merge_inputs() -> tuple[np.ndarray, np.ndarray]:
    """The merge program's whole ``(m, d, k)`` worker factor stack (each
    worker's orthonormal basis near one planted ``(d, k)``) and its all-ones
    ``(m,)`` mask."""
    rng = np.random.default_rng(11)
    truth = np.linalg.qr(rng.standard_normal((_FEAT_D, _K)))[0]
    vws = np.stack([np.linalg.qr(truth + 0.01 * rng.standard_normal((_FEAT_D, _K)))[0]
                    for _ in range(_M)]).astype(np.float32)
    return vws, np.ones((_M,), np.float32)


def state_factors() -> tuple[np.ndarray, np.ndarray]:
    """The extract's and the lanes' low-rank state ``U diag(s) U^T``: ``U
    (d, 8)`` orthonormal, ``s = 8 * 0.5**i`` (a condition of 128)."""
    u = np.linalg.qr(np.random.default_rng(16).standard_normal((_FEAT_D, _R)))[0]
    return u.astype(np.float32), (8.0 * 0.5 ** np.arange(_R)).astype(np.float32)


def deflation_seeds() -> np.ndarray:
    """The lanes' whole ``(lanes, d, k / lanes)`` seed blocks."""
    return _seeded((_LANES, _FEAT_D, _DEFL_K // _LANES), 17)


#: name -> ``(contract, source, build(rank, world, device) -> (fn, args,
#: params, GlobalLeaves))``: the programs that run on a mesh of ranks. With
#: :data:`PROGRAMS`, the reference's report order is :data:`MATRIX`.
MESH_PROGRAMS: dict[str, tuple] = {
    # solo scan family x pipeline x merge_interval
    "scan_solo": _scan_mesh(),
    "scan_pipelined": _scan_mesh(pipeline_merge=True),
    "scan_interval2": _scan_mesh(merge_interval=2),
    "scan_pipelined_interval2": _scan_mesh(pipeline_merge=True, merge_interval=2),
    "scan_masked": _scan_mesh(masked=True),
    "scan_masked_interval2": _scan_mesh(masked=True, merge_interval=2),
    # tiered-mesh tree merge
    "tree_fit": _tree_mesh(),
    "tree_fit_masked": _tree_mesh(masked=True),
    "tree_fit_wire": _tree_mesh(wire={"chip": "bf16", "host": "int8"}),
    # feature-sharded cores
    "feature_scan": _feature_mesh("scan"),
    "feature_sketch": _feature_mesh("sketch"),
    # fleet (B > 1, sharded over the workers axis)
    "fleet_b8": _fleet_mesh(),
    "fleet_b8_masked": _fleet_mesh(masked=True),
    # serve transforms, row-sharded
    "serve_project": _serve_rows_mesh("project"),
    "serve_reconstruct": _serve_rows_mesh("reconstruct"),
    "serve_residual": _serve_rows_mesh("residual"),
    # population cohort reduce
    "population_reduce": _population_mesh(),
    # distributed eigensolve + sharded-basis serving
    "dist_merge": _dist_merge_mesh(),
    "dist_extract": _dist_extract_mesh(),
    # parallel-deflation eigensolve on the components axis
    "deflation_merge": _deflation_mesh(),
    "dist_serve_project": _dist_serve_mesh("project"),
    "dist_serve_reconstruct": _dist_serve_mesh("reconstruct"),
    "dist_serve_residual": _dist_serve_mesh("residual"),
}

#: every audited program, in the reference's report order
MATRIX: tuple[str, ...] = (
    "scan_solo", "scan_pipelined", "scan_interval2", "scan_pipelined_interval2",
    "scan_masked", "scan_masked_interval2", "tree_fit", "tree_fit_masked",
    "tree_fit_wire", "feature_scan", "feature_sketch", "fleet_b8", "fleet_b8_masked",
    "serve_project", "serve_reconstruct", "serve_residual", "serve_project_solo",
    "population_reduce", "dist_merge", "dist_extract", "deflation_merge",
    "dist_serve_project", "dist_serve_reconstruct", "dist_serve_residual",
    "pallas_serve_project_bf16", "pallas_serve_project_i8", "pallas_matvec_gram",
)


def _schedule(log) -> list:
    return [(r["op"], r["axis"], r["dtype"], tuple(r["shape"]), r["group_size"], r["tag"])
            for r in log]


def _floor(contract: str, params) -> int | None:
    from distributed_eigenspaces_tpu_torch.analysis.contracts import CONTRACTS

    sc = CONTRACTS[contract].sharding
    return None if sc is None or sc.replicated_axis_floor is None else (
        sc.replicated_axis_floor(params))


def _mesh_rank(rank: int, world: int, device_type: str, names, mutants) -> dict:
    """One rank of :func:`build_matrix`'s launch: every mesh program of
    ``names`` once, on this rank's share of its data, under the buffer trace
    and the collective recorder, then every seeded mesh mutation of
    ``mutants``. Every rank returns its collective schedule and what it held
    (``shardings.HeldShapes``); rank 0 also the whole record of each
    (buffers, FLOPs, launches, the build's global leaves)."""
    from distributed_eigenspaces_tpu_torch.analysis.shardings import held_shapes
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    device = resolve_device(device_type)
    out: dict = {"programs": {}, "mutants": {}}
    for name in names:
        contract, source, build = MESH_PROGRAMS[name]
        with recording() as setup:
            fn, args, params, leaves = build(rank, world, device)
        result, buffers, flops, log, launches = _run_traced(fn, args, device,
                                                            count_flops=rank == 0)
        rec = dict(collectives=log, held=held_shapes(rank, args, result, buffers,
                                                     _floor(contract, params)),
                   output=tuple(t.detach().cpu().numpy() for t in tree_leaves(result)
                                if isinstance(t, torch.Tensor)))
        if rank == 0:
            rec.update(contract=contract, source=source, params=params, leaves=leaves,
                       buffers=buffers, flops=flops, launches=launches,
                       setup_launches=tuple(setup))
        out["programs"][name] = rec
    if mutants:
        from distributed_eigenspaces_tpu_torch.analysis.mutations import MESH_SEEDS

        for name in mutants:
            with pmesh.recording_collectives() as log:
                MESH_SEEDS[name](device)
            out["mutants"][name] = tuple(log)
    pmesh.barrier()
    return out


def _diffs(mine, theirs, rank: int) -> list[str]:
    a, b = _schedule(mine), _schedule(theirs)
    if a == b:
        return []
    at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return [f"rank {rank} recorded {len(b)} collectives against rank 0's {len(a)}; "
            f"first difference at call {at}: rank 0 "
            f"{a[at] if at < len(a) else None} vs rank {rank} "
            f"{b[at] if at < len(b) else None}"]


#: device type -> (built mesh programs, rank 0's records of each mutant)
_MESH_BUILT: dict[str, tuple[dict, dict]] = {}


def _mesh_matrix(device: torch.device, timeout: float) -> tuple[dict, dict]:
    """Every mesh program and seeded mesh mutation, from ONE launch of
    :data:`MESH_RANKS` gloo ranks on ``device``'s type (cached a process)."""
    if device.type in _MESH_BUILT:
        return _MESH_BUILT[device.type]
    from distributed_eigenspaces_tpu_torch.analysis.mutations import MESH_SEEDS
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    names, mutants = list(MESH_PROGRAMS), list(MESH_SEEDS)
    ranks = pmesh.launch(_mesh_rank, MESH_RANKS, device.type, names, mutants,
                         backend="gloo", timeout=timeout)
    built = {}
    for name in names:
        r0 = ranks[0]["programs"][name]
        diffs = [d for r in range(1, MESH_RANKS)
                 for d in _diffs(r0["collectives"], ranks[r]["programs"][name]["collectives"], r)]
        built[name] = BuiltProgram(
            name=name, contract=r0["contract"], params=r0["params"], fn=None, args=(),
            device=device, launches=r0["launches"], buffers=r0["buffers"],
            source=r0["source"], collectives=r0["collectives"], flops=r0["flops"],
            schedule_diffs=tuple(diffs), leaves=r0["leaves"],
            setup_launches=r0["setup_launches"],
            held=tuple(ranks[r]["programs"][name]["held"] for r in range(MESH_RANKS)),
            output=tuple(ranks[r]["programs"][name]["output"] for r in range(MESH_RANKS)),
        )
    recorded = {name: ranks[0]["mutants"][name] for name in mutants}
    _MESH_BUILT[device.type] = (built, recorded)
    return built, recorded


def build_matrix(names=None, *, device="cuda", timeout: float = 600.0):
    """Build and run the programs ``names`` (default: the whole
    :data:`MATRIX`) on ``device`` (``"cuda"`` unless the caller asks for
    the CPU; raises without a card). Returns ``(built, mutant_records)``:
    name -> :class:`BuiltProgram`, and the seeded mesh mutations' rank-0
    collective records (``mutations.MESH_SEEDS``), which the same launch
    ran. Any mesh program asked for starts that one launch (once a process
    and device type)."""
    dev = resolve_device(device)
    names = list(MATRIX if names is None else names)
    unknown = [n for n in names if n not in PROGRAMS and n not in MESH_PROGRAMS]
    if unknown:
        raise KeyError(f"unknown program {unknown[0]!r}; matrix: {sorted(MATRIX)}")
    mesh_built, recorded = ({}, {})
    if any(n in MESH_PROGRAMS for n in names):
        mesh_built, recorded = _mesh_matrix(dev, timeout)
    built = {n: mesh_built[n] if n in MESH_PROGRAMS else PROGRAMS[n](dev) for n in names}
    return built, recorded


def mesh_mutant_records(device="cuda") -> dict:
    """Rank 0's collective records of every seeded mesh mutation, from the
    matrix's launch (made now if this process has not made it)."""
    return _mesh_matrix(resolve_device(device), 600.0)[1]


def build_program(name: str, device="cuda") -> BuiltProgram:
    """Build and run one audited program by matrix name on ``device``
    (``"cuda"`` unless the caller asks for the CPU; raises without a card).
    A mesh program comes from the matrix's one launch."""
    if name not in PROGRAMS and name not in MESH_PROGRAMS:
        raise KeyError(f"unknown program {name!r}; matrix: {sorted(MATRIX)}")
    return build_matrix([name], device=device)[0][name]
