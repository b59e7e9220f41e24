"""sklearn-style estimator over the port's trainers.

Counterpart of ``OnlineDistributedPCA`` in ``distributed_eigenspaces_tpu/
api/estimator.py`` with the dense trainers, on one device or, under
``backend="shard_map"`` (or ``"auto"`` in a process group of more than
one rank), on a workers mesh of the group's ranks (:func:`_scan_mesh`):
every rank is given the same data, fits its own workers, and holds the
same state; host side effects (checkpoint commits, ``on_step`` hooks) run
on rank 0 and the ranks then meet at a barrier. The whole-fit
scan, its segmented and checkpointable twin (``checkpoint_dir``, or a
staged schedule over ``SCAN_STAGE_BYTES_MAX``), the masked whole fits of
both (``worker_masks`` as a ``(T, m)`` sequence), and the per-step loop
(``fit_stream``, ``partial_fit``, per-step hooks, mask generators), plus the
reference's ``transform`` / ``inverse_transform`` / ``score`` and the
``matrix_w`` alias. ``fit`` resolves its trainer with the reference's rule
(:func:`choose_trainer`) and raises the reference's ``ValueError``s for
combinations it refuses.

The feature-sharded backend (``backend="feature_sharded"``, or ``"auto"`` at
``dim >= 4096`` and, for a whole fit, at ``dim * k >= 65536``) runs the
rank-r scan (``trainer="scan"``) or the Nystrom sketch (``"sketch"``) of
``parallel/feature_sharded.py`` on ``parallel.mesh.auto_feature_mesh(cfg)``
(the ``(1, 1)`` layout in one process), staged in one program or, when
checkpointing or over the per-device staging budget, in windows; the
per-step loop runs the rank-r step, and ``fit_stream`` / ``partial_fit``
continue a sketch fit through its windowed entry (:meth:`_continue_sketch`).
Each rank holds its rows of the state; ``components_`` is the whole
``(d, k)`` basis on every rank; ``cfg.collectives="ring"`` runs their
switchable reductions over explicit rings (``parallel/ring.py``).

``cfg.compile_cache_dir`` acquires the one-device scan fit, its extraction
and ``transform``'s bucket programs through the persistent compile cache
(``utils/compile_cache.py``), as the reference does; a mesh fit stays on the
direct path.

``cfg.merge_topology`` makes every merge of the dense trainers the stacked
tree of ``parallel/topology.py`` (on one device and on the workers mesh
alike); ``cfg.merge_wire_dtype`` has no effect there (the stacked route
has no collectives to narrow). ``trainer="fleet"`` runs the solo fit as a
one-tenant fleet program (``parallel.fleet.fit_fleet``, one device; masks
as a ``(T, m)`` sequence); it does not checkpoint.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import warnings

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.algo.online import (
    OnlineState,
    online_distributed_pca,
)
from distributed_eigenspaces_tpu_torch.algo.scan import make_scan_fit
from distributed_eigenspaces_tpu_torch.api.runner import extract_dense, make_whole_fit
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.data.bin_stream import window_stream
from distributed_eigenspaces_tpu_torch.data.stream import (
    block_stream,
    count_steps,
    stage_blocks,
    stage_feature_blocks,
)
from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype
from distributed_eigenspaces_tpu_torch.ops.linalg import (
    initial_basis,
    principal_angles_degrees,
)
from distributed_eigenspaces_tpu_torch.ops.serve_project import project_exact
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.runtime.prefetch import prefetch_stream
from distributed_eigenspaces_tpu_torch.utils.checkpoint import Checkpointer

TRAINERS = ("auto", "step", "scan", "segmented", "sketch", "fleet")

#: d*k above which the reference's ``backend="auto"`` whole fit takes the
#: feature-sharded sketch trainer (its ``SKETCH_DK_CROSSOVER``)
SKETCH_DK_CROSSOVER = 65536

#: staged ``(T, m, n, d)`` bytes above which the reference's ``"auto"``
#: whole fit takes its segmented trainer (its ``SCAN_STAGE_BYTES_MAX``)
SCAN_STAGE_BYTES_MAX = 1 << 31  # 2 GiB


def resolves_feature_sharded(cfg: PCAConfig, *, whole_fit: bool = True) -> bool:
    """The reference's rule for "this workload runs the feature-sharded
    backend": explicit; ``"auto"`` at ``dim >= 4096``; or, for whole fits
    only, ``"auto"`` at ``dim * k >= SKETCH_DK_CROSSOVER``. The per-step
    paths (``fit_stream``, per-step hooks) pass ``whole_fit=False``."""
    if cfg.backend == "feature_sharded":
        return True
    if cfg.backend != "auto":
        return False
    if cfg.dim >= 4096:
        return True
    return whole_fit and cfg.dim * cfg.k >= SKETCH_DK_CROSSOVER


def _scan_mesh(cfg: PCAConfig, device="cuda"):
    """The workers mesh of the dense trainers, or None for one device: under
    ``backend="shard_map"`` / ``"tpu"``, or ``"auto"`` in a process group of
    more than one rank, a ``(W, 1)`` mesh with ``W`` the largest divisor of
    ``num_workers`` up to the group's size; None when that is 1 (one rank,
    as the reference with one device)."""
    if cfg.backend in ("shard_map", "tpu") or (
        cfg.backend == "auto" and pmesh.world_size() > 1
    ):
        mesh = pmesh.workers_mesh(cfg.num_workers, device)
        if mesh is not None and mesh.axis_size(pmesh.WORKER_AXIS) > 1:
            return mesh
    return None


def _routes_feature_whole(cfg: PCAConfig, trainer: str) -> bool:
    """Whether this (cfg, resolved trainer) pair runs the feature-sharded
    whole-fit programs: ``trainer="sketch"`` whatever the backend, and
    ``"scan"`` where the backend resolves to feature sharding."""
    return trainer == "sketch" or (
        trainer == "scan" and resolves_feature_sharded(cfg)
    )


def _feature_mesh(cfg: PCAConfig, device):
    """The feature-sharded trainers' mesh: ``auto_feature_mesh``, or the
    one-process ``(1, 1)`` layout."""
    mesh = pmesh.auto_feature_mesh(cfg, device)
    return pmesh.local_mesh(device) if mesh is None else mesh


def _step_bytes(cfg: PCAConfig) -> int:
    """Bytes of one staged ``(m, n, d)`` step in the resolved stage dtype."""
    itemsize = torch_dtype(cfg.resolved_stage_dtype()).itemsize
    return cfg.num_workers * cfg.rows_per_worker * cfg.dim * itemsize


def staged_bytes(cfg: PCAConfig) -> int:
    """Bytes of the whole fit's staged ``(T, m, n, d)`` schedule in the
    resolved stage dtype, as the reference counts them."""
    return cfg.num_steps * _step_bytes(cfg)


def choose_trainer(cfg: PCAConfig, *, per_step_hooks: bool = False,
                   checkpointing: bool = False) -> str:
    """The reference's trainer for a whole-dataset ``fit``: ``"step"`` for
    per-step hooks; for the feature-sharded backend ``"sketch"`` from
    ``dim * k >= SKETCH_DK_CROSSOVER`` on, else its ``"scan"``; for the
    dense state ``"segmented"`` when checkpointing or when the staged
    schedule exceeds ``SCAN_STAGE_BYTES_MAX``, else ``"scan"``."""
    if per_step_hooks:
        return "step"
    if resolves_feature_sharded(cfg):
        return "sketch" if cfg.dim * cfg.k >= SKETCH_DK_CROSSOVER else "scan"
    if checkpointing or staged_bytes(cfg) > SCAN_STAGE_BYTES_MAX:
        return "segmented"
    return "scan"


def _budget_steps(cfg: PCAConfig, n_devices: int = 1) -> int:
    """The most schedule steps the staging budget allows
    (``SCAN_STAGE_BYTES_MAX * n_devices // step_bytes``, at least 1): the
    segmented fit's window clamp, and the feature-sharded fits' (whose
    stack splits over every rank of the mesh)."""
    return max(1, SCAN_STAGE_BYTES_MAX * max(n_devices, 1) // max(_step_bytes(cfg), 1))


def _validated_masks(worker_masks, num_workers: int) -> np.ndarray:
    """Shape-check a ``(T, m)`` worker-mask sequence (every masked
    whole-fit route)."""
    if isinstance(worker_masks, torch.Tensor):
        worker_masks = worker_masks.detach().cpu().numpy()
    worker_masks = np.asarray(worker_masks, np.float32)
    if worker_masks.ndim != 2 or worker_masks.shape[1] != num_workers:
        raise ValueError(
            f"worker_masks shape {worker_masks.shape} != "
            f"(T, num_workers={num_workers})"
        )
    return worker_masks


def _masks_for(worker_masks: np.ndarray, t: int) -> np.ndarray:
    """The first ``t`` mask rows; raises when the supply is short (a step
    silently left unmasked is the fault this guards)."""
    if len(worker_masks) < t:
        raise ValueError(
            f"worker_masks covers {len(worker_masks)} steps; the "
            f"schedule runs {t} — every step needs its mask row"
        )
    return worker_masks[:t]


def _lockstep_mask_windows(windows, take_rows):
    """Mask windows shaped by the data windows: the schedule's step count
    belongs to the data. ``fit_windows``'s strict zip pulls a data window
    first, so its size is known when the mask side is pulled (under
    prefetch the data side only runs further ahead). ``take_rows(start,
    size)`` returns the ``(size, m)`` rows of steps ``[start, start +
    size)``. Returns the tapped window iterator and the mask iterator."""
    sizes: list[int] = []

    def tapped():
        for w in windows:
            sizes.append(int(w.shape[0]))
            yield w

    def masks():
        idx = taken = 0
        while idx < len(sizes):  # grows while iterating
            s = sizes[idx]
            idx += 1
            yield take_rows(taken, s)
            taken += s

    return tapped(), masks()


class OnlineDistributedPCA:
    """Online distributed PCA estimator on one device (``"cuda"`` unless
    the caller asks for another), or on every rank of a process group under
    ``backend="shard_map"`` (the module docstring)::

        pca = OnlineDistributedPCA(PCAConfig(dim=3072, k=10, ...))
        pca.fit(data)              # data: (N, 3072), numpy or torch
        z = pca.transform(data)    # (N, 10)
        w = pca.components_        # (3072, 10), descending, canonical signs

    ``v0`` is the cold start basis ``(d, k)`` of every subspace solve
    (default: drawn from ``cfg.seed``); ``v_init`` the ``(d, k')`` start of
    the crossover merge (``solver="distributed"`` above
    ``eigh_crossover_d``; default: drawn from ``cfg.seed``).
    ``checkpoint_dir`` makes ``fit`` take the segmented trainer and commit
    a checkpoint (``utils.checkpoint.Checkpointer``, the two newest kept)
    after every window of ``segment`` steps.
    """

    def __init__(self, cfg: PCAConfig, *, device="cuda", trainer: str = "auto",
                 v0=None, v_init=None, checkpoint_dir: str | None = None,
                 segment: int = 50):
        if trainer not in TRAINERS:
            raise ValueError(f"unknown trainer {trainer!r}; one of {TRAINERS}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.trainer = trainer
        self.checkpoint_dir = checkpoint_dir
        self.segment = segment
        self.v0 = initial_basis(
            cfg.dim, cfg.k, seed=cfg.seed, device=self.device, v0=v0
        )
        self.v_init = v_init
        self.state = None
        #: the trainer the last ``fit`` ran
        self.trainer_used_: str | None = None
        self._w: torch.Tensor | None = None
        #: the sketch trainer of the last sketch fit, kept for its online
        #: continuation (``fit_stream`` / ``partial_fit``)
        self._sketch_fit = None
        #: transform buckets backed by the persistent compile cache (built
        #: lazily when cfg.compile_cache_dir is set)
        self._transform_engine = None

    def _compile_cache(self):
        """The persistent store for ``cfg.compile_cache_dir``, or None
        (``utils.compile_cache.compile_cache_for``: one a directory)."""
        from distributed_eigenspaces_tpu_torch.utils.compile_cache import (
            compile_cache_for,
        )

        return compile_cache_for(self.cfg)

    def _cache_key(self, kind: str, shape: tuple, dtype):
        """A compile-cache key of this estimator's programs: ``shape``, the
        seed, the starts the closures hold, and the device in the
        signature; the config's program knobs."""
        from distributed_eigenspaces_tpu_torch.utils.compile_cache import (
            config_knobs,
            make_key,
            start_digest,
        )

        starts = (self.cfg.seed, start_digest(self.v0), start_digest(self.v_init),
                  str(self.device))
        return make_key(kind, (*shape, starts), dtype, knobs=config_knobs(self.cfg),
                        device=self.device)

    # -- fitting ------------------------------------------------------------

    def fit(self, data, *, on_step=None, worker_masks=None,
            tracer=None) -> "OnlineDistributedPCA":
        """Fit on ``(N, dim)`` data, streamed as ``num_steps`` blocks of
        ``num_workers x rows_per_worker`` rows. Starts fresh.

        ``tracer`` (a ``utils.telemetry.Tracer``) wraps the whole fit in a
        root ``estimator_fit`` span on a fresh ``fit`` trace, with the
        trainer that ran set on it; ``None`` traces nothing.

        The trainer is :func:`choose_trainer`'s unless the constructor
        named one: the whole-fit scan, which stages the schedule on the
        device in one ``(T, m, n, d)`` tensor of the resolved stage dtype
        (int8: each block quantized with its own scale); the segmented fit
        when checkpointing or above ``SCAN_STAGE_BYTES_MAX``, which stages
        windows of ``segment`` steps one at a time; or, for ``on_step``
        hooks, the per-step loop. ``worker_masks`` as a ``(T, m)`` sequence
        (array, tensor, list, tuple) runs the masked whole fit on the scan
        and segmented routes; a mask generator keeps the per-step loop,
        one ``next()`` a round."""
        from distributed_eigenspaces_tpu_torch.utils.telemetry import NULL_TRACER

        tr = tracer if tracer is not None else NULL_TRACER
        with tr.span(
            "estimator_fit", trace_id=tr.new_trace("fit"),
            category="fit", device=True,
            attrs={"dim": self.cfg.dim, "k": self.cfg.k,
                   "steps": self.cfg.num_steps},
        ) as sp:
            out = self._fit_impl(data, on_step=on_step, worker_masks=worker_masks)
            sp.set(trainer=self.trainer_used_)
            return out

    def _fit_impl(self, data, *, on_step, worker_masks):
        self.state = None
        self._w = None
        cfg = self.cfg
        trainer = self.trainer
        ckpt = self.checkpoint_dir is not None
        if cfg.pipeline_merge and ckpt:
            raise ValueError(
                "pipeline_merge fits cannot checkpoint: the pipelined "
                "carry (pending worker factors) is not part of any saved "
                "state, so kill/resume could not be bit-for-bit. Drop "
                "checkpoint_dir, or use merge_interval alone (resume-"
                "safe: the merge phase derives from the step counter)."
            )
        # a mask sequence rides the masked whole fit; a mask generator
        # keeps the per-step loop (one next() a round, its length unknown)
        masks_seq = (
            worker_masks is not None and on_step is None
            and isinstance(worker_masks, (np.ndarray, torch.Tensor, list, tuple))
        )
        if trainer == "auto":
            trainer = choose_trainer(
                cfg, per_step_hooks=on_step is not None or (
                    worker_masks is not None and not masks_seq),
                checkpointing=ckpt,
            )
        elif trainer != "step" and on_step is not None:
            raise ValueError(
                f"trainer={trainer!r} runs the whole fit as compiled "
                "programs — per-step on_step hooks need trainer='step' "
                "(or 'auto', which picks it for you)"
            )
        elif trainer != "step" and worker_masks is not None and not masks_seq:
            raise ValueError(
                f"trainer={trainer!r} takes worker_masks as a (T, m) "
                "sequence (array/list/tuple); use trainer='step' for a "
                "per-step mask generator"
            )
        if ckpt and (trainer in ("step", "fleet") or (
                trainer == "scan" and not resolves_feature_sharded(cfg))):
            raise ValueError(
                f"checkpoint_dir is honored by the whole-fit trainers "
                f"(segmented / feature-sharded scan / sketch); this fit "
                f"resolved to trainer={trainer!r}"
                + (
                    " because on_step/worker_masks hooks require the "
                    "per-step trainer. Drop the hooks, or checkpoint "
                    "from your own on_step hook via "
                    "utils.checkpoint.Checkpointer"
                    if trainer == "step" and self.trainer == "auto"
                    else ". Drop checkpoint_dir, drop the trainer "
                    "override (trainer='auto' picks a checkpointable "
                    "one), or checkpoint per-step state yourself via "
                    "utils.checkpoint in an on_step hook with "
                    "trainer='step'"
                )
            )
        if trainer == "step":
            stream = block_stream(
                data, num_workers=cfg.num_workers,
                rows_per_worker=cfg.rows_per_worker, num_steps=cfg.num_steps,
                remainder=cfg.remainder, dtype=cfg.dtype, device=self.device,
            )
            return self.fit_stream(stream, on_step=on_step, worker_masks=worker_masks)
        masks = None
        if worker_masks is not None:
            masks = _validated_masks(worker_masks, cfg.num_workers)
        self.trainer_used_ = trainer
        if trainer == "fleet":
            return self._fit_fleet(data, masks)
        if _routes_feature_whole(cfg, trainer):
            return self._fit_feature_sharded(data, trainer, masks)
        if trainer == "segmented":
            return self._fit_segmented(data, masks)
        return self._fit_scan(data, masks)

    def _blocks(self, data, stage_dtype, mesh=None):
        """The schedule's blocks on the device in the stage dtype: an int8
        stage quantizes each fp32 block with its own scale
        (``stage_blocks``), a float stage casts it. With a mesh each block
        is staged whole (the scale is the whole block's, as the
        reference's) and this rank keeps its workers."""
        cfg = self.cfg
        staged = stage_blocks(block_stream(
            data, num_workers=cfg.num_workers,
            rows_per_worker=cfg.rows_per_worker, num_steps=cfg.num_steps,
            remainder=cfg.remainder,
            dtype=torch.float32 if stage_dtype == torch.int8 else stage_dtype,
            device=self.device,
        ), stage_dtype)
        if mesh is None:
            return staged
        rows = pmesh.worker_rows(mesh, cfg.num_workers)
        return (b[rows] for b in staged)

    def _fit_scan(self, data, masks) -> "OnlineDistributedPCA":
        """The whole-fit scan over the schedule staged on the device: one
        allocation, each block staged into its slot as it arrives, so the
        device holds the schedule plus one block at most."""
        cfg = self.cfg
        stage_dtype = torch_dtype(cfg.resolved_stage_dtype())
        step_rows = cfg.num_workers * cfg.rows_per_worker
        steps = count_steps(len(data), step_rows, num_steps=cfg.num_steps,
                            remainder=cfg.remainder)
        if not steps:
            raise ValueError(
                f"dataset yielded zero full steps ({len(data)} rows, one "
                f"step needs {step_rows})"
            )
        if masks is not None:
            masks = _masks_for(masks, steps)
        mesh = _scan_mesh(cfg, self.device)
        m_local = cfg.num_workers // (1 if mesh is None
                                      else mesh.axis_size(pmesh.WORKER_AXIS))
        staged = torch.empty(
            (steps, m_local, cfg.rows_per_worker, cfg.dim),
            dtype=stage_dtype, device=self.device,
        )
        filled = 0
        for block in self._blocks(data, stage_dtype, mesh):
            staged[filled].copy_(block)
            filled += 1
        if filled != steps:
            raise RuntimeError(f"staged {filled} steps, counted {steps}")
        def build():
            return make_scan_fit(cfg, mesh=mesh, device=self.device, v0=self.v0,
                                 v_init=self.v_init, masked=masks is not None)

        cc = self._compile_cache()
        if cc is not None and mesh is None:
            # the one-device scan acquired through the persistent store (a
            # mesh fit stays on the direct path, as the reference's)
            from distributed_eigenspaces_tpu_torch.utils.compile_cache import (
                fit_libraries,
            )

            key = self._cache_key(
                "scan_fit", (cfg.dim, cfg.k, cfg.num_workers, cfg.rows_per_worker,
                             steps, masks is not None),
                staged.dtype)
            fit = cc.get_or_build(
                key, build,
                libraries=fit_libraries(cfg) if self.device.type == "cuda" else ())
        else:
            fit = build()
        state0 = OnlineState.initial(cfg.dim, cfg.state_dtype, device=self.device)
        state, _ = fit(state0, staged) if masks is None else fit(state0, staged, masks)
        return self._finish_dense(state, cached=mesh is None)

    def _fit_segmented(self, data, masks) -> "OnlineDistributedPCA":
        """The segmented fit over windows of ``segment`` steps (clamped to
        the staging budget) staged one at a time, the next window read and
        staged by a prefetch thread while the current one runs, a checkpoint committed after every
        window when checkpointing; ``masks`` run the masked windows in
        lockstep with the data windows."""
        cfg = self.cfg
        stage_dtype = torch_dtype(cfg.resolved_stage_dtype())
        seg = max(1, min(self.segment, _budget_steps(cfg)))
        mesh = _scan_mesh(cfg, self.device)
        on_segment = None
        if self.checkpoint_dir is not None:
            on_segment = Checkpointer(
                self.checkpoint_dir, every=1,
                rows_per_step=cfg.num_workers * cfg.rows_per_worker,
                device=self.device,
            ).on_step
        # one window in flight: windows are the big unit here
        source = windows = prefetch_stream(
            window_stream(self._blocks(data, stage_dtype, mesh), seg), depth=1,
            place=lambda w: w)
        mask_windows = None
        if masks is not None:
            windows, mask_windows = _lockstep_mask_windows(
                windows, lambda start, s: _masks_for(masks, start + s)[start:])
        handle = make_whole_fit(cfg, "segmented", mesh=mesh, segment=self.segment,
                                device=self.device, v0=self.v0, v_init=self.v_init)
        try:
            state = handle.fit_windows(handle.init_state(), windows,
                                       on_segment=on_segment,
                                       worker_masks=mask_windows)
        finally:
            source.close()
        if int(state.step) == 0:
            raise ValueError("dataset yielded zero full steps")
        return self._finish_dense(OnlineState(state.sigma_tilde, state.step),
                                  cached=mesh is None)

    def _fit_fleet(self, data, masks) -> "OnlineDistributedPCA":
        """The solo fit as a one-tenant fleet program on this estimator's
        device (``parallel.fleet.fit_fleet``, the reference's
        ``trainer="fleet"``): the state and components are tenant 0's."""
        from distributed_eigenspaces_tpu_torch.parallel.fleet import fit_fleet

        res = fit_fleet(
            self.cfg, [data], mesh=None,
            worker_masks=None if masks is None else [masks],
            device=self.device, v0=self.v0, v_init=self.v_init,
        )
        self.state = OnlineState(res.states.sigma_tilde[0], int(res.states.step[0]))
        self._w = torch.from_numpy(res.components[0]).to(self.device)
        return self

    def _finish_dense(self, state: OnlineState, cached: bool = False) -> "OnlineDistributedPCA":
        """Keep ``state`` and extract its basis; ``cached`` (a one-device
        fit) acquires the extraction through the compile cache when one is
        configured, the same ``extract_dense`` either way."""
        self.state = state
        cfg = self.cfg
        cc = self._compile_cache() if cached else None
        if cc is None:
            self._w = extract_dense(cfg, state.sigma_tilde, v0=self.v0)
            return self
        v0 = self.v0
        extract = cc.get_or_build(
            self._cache_key("scan_extract", (cfg.dim, cfg.k), state.sigma_tilde.dtype),
            lambda: (lambda sigma: extract_dense(cfg, sigma, v0=v0)),
        )
        self._w = extract(state.sigma_tilde)
        return self

    def _fit_feature_sharded(self, data, trainer: str, masks) -> "OnlineDistributedPCA":
        """The feature-sharded whole fits (the rank-r scan, the Nystrom
        sketch) on :func:`_feature_mesh`. A schedule within the per-device
        staging budget and no checkpointing stages once, each rank its
        ``(T, m_local, n, d_local)`` share, and runs one fit; otherwise the
        windowed entry streams windows of ``segment`` steps (clamped to the
        budget), committing a checkpoint per window when checkpointing.
        ``masks`` (a validated ``(T, m)`` array) must cover the schedule."""
        cfg = self.cfg
        if trainer == "sketch" and self.trainer == "auto":
            warnings.warn(
                f"auto dispatch picked the Nystrom-sketch trainer for d*k = "
                f"{cfg.dim * cfg.k} >= {SKETCH_DK_CROSSOVER} (the large-d "
                "path; drift vs the exact online estimate is bounded). Pass "
                "trainer='step' for the exact estimate, and see "
                "estimator.trainer_used_.",
                stacklevel=3,
            )
        mesh = _feature_mesh(cfg, self.device)
        handle = make_whole_fit(cfg, "sketch" if trainer == "sketch" else "fs_scan",
                                mesh, device=self.device, v_init=self.v_init)
        if trainer == "sketch":
            self._sketch_fit = handle
        stage_dtype = torch_dtype(cfg.resolved_stage_dtype())
        budget = _budget_steps(cfg, math.prod(mesh.shape.values()))
        blocks = stage_feature_blocks(block_stream(
            data, num_workers=cfg.num_workers, rows_per_worker=cfg.rows_per_worker,
            num_steps=cfg.num_steps, remainder=cfg.remainder,
            dtype=torch.float32 if stage_dtype == torch.int8 else stage_dtype,
            device=self.device,
        ), stage_dtype, mesh, num_workers=cfg.num_workers, dim=cfg.dim)
        if self.checkpoint_dir is None and cfg.num_steps <= budget:
            steps = count_steps(len(data), cfg.num_workers * cfg.rows_per_worker,
                                num_steps=cfg.num_steps, remainder=cfg.remainder)
            if not steps:
                raise ValueError("dataset yielded zero full steps")
            staged = None
            for t, b in enumerate(blocks):
                if staged is None:
                    staged = torch.empty((steps, *b.shape), dtype=b.dtype,
                                         device=b.device)
                staged[t].copy_(b)
            state = handle.fit(handle.init_state(), staged,
                               worker_masks=None if masks is None
                               else _masks_for(masks, steps))
            del staged
        else:
            on_segment = None
            if self.checkpoint_dir is not None:
                on_segment = Checkpointer(
                    self.checkpoint_dir, every=1,
                    rows_per_step=cfg.num_workers * cfg.rows_per_worker,
                    device=self.device,
                ).on_step
            source = windows = prefetch_stream(
                window_stream(blocks, max(1, min(self.segment, budget))),
                depth=1, place=lambda w: w)
            mask_windows = None
            if masks is not None:
                windows, mask_windows = _lockstep_mask_windows(
                    windows, lambda start, s: _masks_for(masks, start + s)[start:])
            try:
                state = handle.fit_windows(handle.init_state(), windows,
                                           on_segment=on_segment,
                                           worker_masks=mask_windows)
            finally:
                source.close()
            if int(state.step) == 0:
                raise ValueError("dataset yielded zero full steps")
        self.state = state
        self._w = self._whole_basis(handle, state)
        return self

    def _whole_basis(self, handle, state) -> torch.Tensor:
        """The whole ``(d, k)`` basis on every rank: the handle's extract,
        this rank's rows, gathered over ``features``."""
        mesh = handle.raw.mesh
        rows = handle.extract(state)
        with pmesh.mesh_scope(mesh):
            return pmesh.all_gather(rows.contiguous(), pmesh.FEATURE_AXIS)

    def fit_stream(self, stream, *, on_step=None, worker_masks=None,
                   max_steps="auto") -> "OnlineDistributedPCA":
        """Fit (or continue fitting) on an iterable of ``(m, n, dim)`` blocks
        with the per-step loop. Blocks go as they are, whatever
        ``stage_dtype`` says: as in the reference, only the whole-fit
        trainers stage (an int8 stage quantizes there), and the per-step
        route casts each block to the compute dtype inside the worker
        solve. So ``fit(trainer="step")``, ``on_step`` hooks and mask
        generators fit the same float blocks with or without an int8
        stage.

        A sketch fit's ``SketchState`` continues through the sketch
        trainer (:meth:`_continue_sketch`). Where the backend resolves to
        feature sharding for a per-step fit (``dim >= 4096`` under
        ``"auto"``), or the state is a ``LowRankState``, the loop runs the
        feature-sharded rank-r step."""
        from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import (
            LowRankState,
            SketchState,
        )

        if isinstance(self.state, SketchState):
            return self._continue_sketch(stream, on_step=on_step,
                                         worker_masks=worker_masks,
                                         max_steps=max_steps)
        cfg = self.cfg
        if cfg.backend != "feature_sharded" and (
            resolves_feature_sharded(cfg, whole_fit=False)
            or isinstance(self.state, LowRankState)
        ):
            cfg = dataclasses.replace(cfg, backend="feature_sharded")
        self.trainer_used_ = "step"
        w, state = online_distributed_pca(
            stream, cfg, device=self.device, state=self.state,
            on_step=on_step, worker_masks=worker_masks, max_steps=max_steps,
            v0=self.v0,
        )
        self._w, self.state = w, state
        return self

    def _continue_sketch(self, stream, *, on_step, worker_masks,
                         max_steps) -> "OnlineDistributedPCA":
        """Feed more ``(m, n, dim)`` blocks into a sketch fit's
        ``SketchState`` through the trainer's windowed entry: a nonzero
        carry runs the all-warm program, so windowed and incremental runs
        are the same bits. Blocks stage as the whole fit stages them, in
        windows of ``segment`` steps (clamped to the staging budget);
        ``on_step`` forces one-step windows and sees ``(t, state,
        state.v)`` (the whole state, on rank 0). ``worker_masks`` gives one
        ``(m,)`` row a consumed block; running out first raises. The step
        cap is the per-step loop's: ``cfg.num_steps`` in all under
        ``"auto"`` (open-ended for ``"1/t"``), an int cap, or None."""
        cfg = self.cfg
        fit = self._sketch_fit
        if fit is None:  # a restored state: rebuild the trainer the fit built
            fit = make_whole_fit(cfg, "sketch", _feature_mesh(cfg, self.device),
                                 device=self.device)
            self._sketch_fit = fit
        cap = cfg.num_steps if max_steps == "auto" else max_steps
        if max_steps == "auto" and cfg.discount == "1/t":
            cap = None
        if cap is not None:
            remaining = max(0, cap - int(self.state.step))
            if remaining == 0:
                return self
            stream = itertools.islice(iter(stream), remaining)
        mesh = fit.raw.mesh
        blocks = stage_feature_blocks(stream, cfg.resolved_stage_dtype(), mesh,
                                      num_workers=cfg.num_workers, dim=cfg.dim)
        seg = 1 if on_step is not None else max(
            1, min(self.segment, _budget_steps(cfg, math.prod(mesh.shape.values()))))
        windows = window_stream(blocks, seg)
        mask_windows = None
        if worker_masks is not None:
            mit = iter(worker_masks)

            def take_rows(start, s):
                rows = list(itertools.islice(mit, s))
                if len(rows) < s:
                    raise ValueError(
                        "worker_masks exhausted before the stream — every "
                        "step needs its mask row"
                    )
                return np.stack([np.asarray(r, np.float32) for r in rows])

            windows, mask_windows = _lockstep_mask_windows(windows, take_rows)
        on_segment = None
        if on_step is not None:
            def on_segment(steps_done, st):
                on_step(steps_done, st, st.v)
        self.state = fit.fit_windows(self.state, windows, on_segment=on_segment,
                                     worker_masks=mask_windows)
        self._w = self._whole_basis(fit, self.state)
        self.trainer_used_ = "sketch"
        return self

    def partial_fit(self, x_blocks) -> "OnlineDistributedPCA":
        """Fold one more ``(m, n, dim)`` step into the running estimate (no
        step cap: extra online rounds past T keep refining)."""
        return self.fit_stream([torch.as_tensor(x_blocks).to(self.device)],
                               max_steps=None)

    # -- results ------------------------------------------------------------

    @property
    def components_(self) -> torch.Tensor:
        """``(dim, k)`` principal directions, descending order."""
        if self._w is None:
            raise RuntimeError("call fit() first")
        return self._w

    # the reference's name for it (its notebook's ``matrix_w``)
    matrix_w = components_

    def transform(self, x, *, serve=None) -> torch.Tensor:
        """Project ``(N, dim) -> (N, k)`` (or ``(dim,) -> (k,)``) in
        ``cfg.dtype``: fp32 rows through ``ops.serve_project.project_exact``
        (on the card the fixed-order fp32 kernel, so a served row equals its
        direct projection bit for bit), bf16 rows with ``torch.matmul``.

        ``serve`` (a live ``serving.QueryServer``) routes the query through
        the server instead: it is admitted to the micro-batch queue and
        projected against the registry's LATEST published version, which
        may be newer than this estimator's own fit."""
        w = self.components_
        d = int(w.shape[0])
        width = np.shape(x)[-1] if np.ndim(x) >= 1 else None
        if np.ndim(x) not in (1, 2) or width != d:
            raise ValueError(
                f"transform input has feature width {width} "
                f"(shape {tuple(np.shape(x))}); this estimator was fitted "
                f"with dim={d} — pass (N, {d}) or ({d},) rows"
            )
        if serve is not None:
            if isinstance(x, torch.Tensor):
                x = x.detach().float().cpu().numpy()
            z = serve.submit(np.asarray(x, np.float32)).result().z
            return torch.from_numpy(z[0] if np.ndim(x) == 1 else z).to(self.device)
        cc = self._compile_cache()
        if cc is not None:
            # bucket programs backed by the persistent store
            # (serving/transform.py): padding leaves every row's bits as the
            # direct projection below computes them, so the knob changes
            # first-call latency, never results
            if self._transform_engine is None:
                from distributed_eigenspaces_tpu_torch.serving.transform import (
                    TransformEngine,
                )

                self._transform_engine = TransformEngine(
                    d, int(w.shape[1]), dtype=self.cfg.dtype, cache=cc,
                    device=self.device,
                )
            z = self._transform_engine.project(x if np.ndim(x) == 2 else x[None], w)
            return z[0] if np.ndim(x) == 1 else z
        x = torch.as_tensor(x).to(device=self.device, dtype=torch_dtype(self.cfg.dtype))
        return project_exact(x, w)

    def fit_transform(self, data, **kw) -> torch.Tensor:
        return self.fit(data, **kw).transform(data)

    def inverse_transform(self, z) -> torch.Tensor:
        """Back-project ``(N, k) -> (N, dim)`` (reconstruction)."""
        w = self.components_
        return torch.matmul(torch.as_tensor(z).to(device=w.device, dtype=w.dtype), w.mT)

    def score(self, x, exact_w=None) -> dict:
        """Diagnostics: the explained-variance ratio on ``x`` (the summed
        column variances of ``x W`` over those of ``x``, in ``cfg.dtype``);
        with ``exact_w`` also the worst principal angle in degrees against
        that subspace."""
        w = self.components_
        x = torch.as_tensor(x).to(device=w.device, dtype=torch_dtype(self.cfg.dtype))
        z = torch.matmul(x, w.to(x.dtype))
        total = torch.sum(torch.var(x.float(), dim=0, correction=0))
        explained = torch.sum(torch.var(z.float(), dim=0, correction=0))
        out = {"explained_variance_ratio": float(explained / total)}
        if exact_w is not None:
            ang = principal_angles_degrees(w, torch.as_tensor(exact_w).to(w.device))
            out["max_principal_angle_deg"] = float(torch.max(ang))
        return out
