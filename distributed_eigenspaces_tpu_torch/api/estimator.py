"""sklearn-style estimator over the port's trainers.

Counterpart of ``OnlineDistributedPCA`` in ``distributed_eigenspaces_tpu/
api/estimator.py``, with the two trainers this port has: the whole-fit
scan (``fit`` by default) and the per-step loop (``fit_stream``, or
``fit`` with per-step hooks). The reference's segmented, sketch, fleet
and feature-sharded trainers, masked whole fits and checkpointing are
not ported yet (ROADMAP.md Queue 1 items 9c, 9e, 9f and 15). ``fit``
resolves its trainer with the reference's rule (:func:`choose_trainer`);
where that rule picks a trainer the port lacks (the segmented fit above
``SCAN_STAGE_BYTES_MAX`` of staged schedule, the feature-sharded ones),
the estimator raises before staging anything, instead of fitting under
another trainer's name.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.algo.online import (
    OnlineState,
    online_distributed_pca,
)
from distributed_eigenspaces_tpu_torch.algo.scan import make_scan_fit
from distributed_eigenspaces_tpu_torch.api.runner import extract_dense
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.data.stream import (
    block_stream,
    count_steps,
    stage_blocks,
)
from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype
from distributed_eigenspaces_tpu_torch.ops.linalg import initial_basis
from distributed_eigenspaces_tpu_torch.ops.serve_project import project_exact

TRAINERS = ("auto", "scan", "step")

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


def _refuse_feature_sharded(cfg: PCAConfig, *, whole_fit: bool) -> None:
    if resolves_feature_sharded(cfg, whole_fit=whole_fit):
        raise NotImplementedError(
            f"backend={cfg.backend!r} at dim={cfg.dim}, k={cfg.k} runs the "
            "reference's feature-sharded trainers, which are not ported to "
            "distributed_eigenspaces_tpu_torch yet (ROADMAP.md Queue 1 item "
            "15); pass backend='local' for the dense single-device fit"
        )


def staged_bytes(cfg: PCAConfig) -> int:
    """Bytes of the whole fit's staged ``(T, m, n, d)`` schedule in the
    resolved stage dtype, as the reference counts them."""
    itemsize = torch_dtype(cfg.resolved_stage_dtype()).itemsize
    return (cfg.num_steps * cfg.num_workers * cfg.rows_per_worker * cfg.dim
            * itemsize)


def choose_trainer(cfg: PCAConfig, *, per_step_hooks: bool = False) -> str:
    """The reference's trainer for a whole-dataset ``fit``
    (``choose_trainer`` without checkpointing, which the port lacks):
    ``"step"`` for per-step hooks; for the feature-sharded backend
    ``"sketch"`` from ``dim * k >= SKETCH_DK_CROSSOVER`` on, else its
    ``"scan"``; for the dense state ``"segmented"`` when the staged
    schedule exceeds ``SCAN_STAGE_BYTES_MAX``, else ``"scan"``."""
    if per_step_hooks:
        return "step"
    if resolves_feature_sharded(cfg):
        return "sketch" if cfg.dim * cfg.k >= SKETCH_DK_CROSSOVER else "scan"
    return "segmented" if staged_bytes(cfg) > SCAN_STAGE_BYTES_MAX else "scan"


def _refuse_segmented(cfg: PCAConfig) -> None:
    staged = staged_bytes(cfg)
    if staged > SCAN_STAGE_BYTES_MAX:
        raise NotImplementedError(
            f"the whole fit stages {staged} bytes (T={cfg.num_steps}, "
            f"m={cfg.num_workers}, n={cfg.rows_per_worker}, d={cfg.dim}, "
            f"{cfg.resolved_stage_dtype()}), over SCAN_STAGE_BYTES_MAX = "
            f"{SCAN_STAGE_BYTES_MAX}: the reference runs such fits on its "
            "segmented trainer, which is not ported to "
            "distributed_eigenspaces_tpu_torch yet (ROADMAP.md Queue 1 item "
            "9e); use trainer='step', or fewer steps per fit"
        )


class OnlineDistributedPCA:
    """Online distributed PCA estimator on one device (``"cuda"`` unless
    the caller asks for another)::

        pca = OnlineDistributedPCA(PCAConfig(dim=3072, k=10, ...))
        pca.fit(data)              # data: (N, 3072), numpy or torch
        z = pca.transform(data)    # (N, 10)
        w = pca.components_        # (3072, 10), descending, canonical signs

    ``v0`` is the cold start basis ``(d, k)`` of every subspace solve
    (default: drawn from ``cfg.seed``); ``v_init`` the ``(d, k')`` start of
    the crossover merge (``solver="distributed"`` above
    ``eigh_crossover_d``; default: drawn from ``cfg.seed``).
    """

    def __init__(self, cfg: PCAConfig, *, device="cuda", trainer: str = "auto",
                 v0=None, v_init=None):
        if trainer not in TRAINERS:
            raise ValueError(f"unknown trainer {trainer!r}; one of {TRAINERS}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.trainer = trainer
        self.v0 = initial_basis(
            cfg.dim, cfg.k, seed=cfg.seed, device=self.device, v0=v0
        )
        self.v_init = v_init
        self.state: OnlineState | None = None
        self.trainer_used_: str | None = None
        self._w: torch.Tensor | None = None

    # -- fitting ------------------------------------------------------------

    def fit(self, data, *, on_step=None, worker_masks=None) -> "OnlineDistributedPCA":
        """Fit on ``(N, dim)`` data, streamed as ``num_steps`` blocks of
        ``num_workers x rows_per_worker`` rows. Starts fresh. Runs the
        whole-fit scan trainer unless per-step hooks (``on_step``,
        ``worker_masks``) or ``trainer="step"`` ask for the per-step loop.
        The scan stages the whole schedule on the device, in one
        ``(T, m, n, d)`` tensor of the resolved stage dtype filled block by
        block (int8: each block quantized from fp32 with its own scale); a
        schedule over ``SCAN_STAGE_BYTES_MAX`` raises (the reference's
        segmented fit)."""
        self.state = None
        self._w = None
        cfg = self.cfg
        trainer = self.trainer
        hooks = on_step is not None or worker_masks is not None
        if trainer == "auto":
            trainer = choose_trainer(cfg, per_step_hooks=hooks)
        elif trainer == "scan" and hooks:
            raise NotImplementedError(
                "on_step / worker_masks on the scan trainer (the masked "
                "whole fit) is not ported yet (ROADMAP.md Queue 1 item 9c); "
                "use trainer='step'"
            )
        if trainer == "step":
            stream = block_stream(
                data, num_workers=cfg.num_workers,
                rows_per_worker=cfg.rows_per_worker, num_steps=cfg.num_steps,
                remainder=cfg.remainder, dtype=cfg.dtype, device=self.device,
            )
            return self.fit_stream(stream, on_step=on_step, worker_masks=worker_masks)
        _refuse_feature_sharded(cfg, whole_fit=True)
        _refuse_segmented(cfg)
        self.trainer_used_ = "scan"
        stage_dtype = torch_dtype(cfg.resolved_stage_dtype())
        step_rows = cfg.num_workers * cfg.rows_per_worker
        steps = count_steps(len(data), step_rows, num_steps=cfg.num_steps,
                            remainder=cfg.remainder)
        if not steps:
            raise ValueError(
                f"dataset yielded zero full steps ({len(data)} rows, one "
                f"step needs {step_rows})"
            )
        # one allocation, each block staged into its slot as it arrives:
        # the device holds the schedule plus one block at most. An int8
        # stage quantizes each fp32 block with its own scale
        # (stage_blocks); a float stage casts it.
        staged = torch.empty(
            (steps, cfg.num_workers, cfg.rows_per_worker, cfg.dim),
            dtype=stage_dtype, device=self.device,
        )
        blocks = block_stream(
            data, num_workers=cfg.num_workers,
            rows_per_worker=cfg.rows_per_worker, num_steps=cfg.num_steps,
            remainder=cfg.remainder,
            dtype=torch.float32 if stage_dtype == torch.int8 else stage_dtype,
            device=self.device,
        )
        filled = 0
        for block in stage_blocks(blocks, stage_dtype):
            staged[filled].copy_(block)
            filled += 1
        if filled != steps:
            raise RuntimeError(f"staged {filled} steps, counted {steps}")
        fit = make_scan_fit(cfg, device=self.device, v0=self.v0, v_init=self.v_init)
        state, _ = fit(
            OnlineState.initial(cfg.dim, cfg.state_dtype, device=self.device),
            staged,
        )
        self.state = state
        self._w = extract_dense(cfg, state.sigma_tilde, v0=self.v0)
        return self

    def fit_stream(self, stream, *, on_step=None, worker_masks=None,
                   max_steps="auto") -> "OnlineDistributedPCA":
        """Fit (or continue fitting) on an iterable of ``(m, n, dim)`` blocks
        with the per-step loop. Under an int8 stage each block is quantized
        as the whole fit stages it (:func:`~..data.stream.stage_blocks`), so
        a continued fit sees the same int8 blocks; float blocks go as they
        are (the worker solve casts them to the compute dtype)."""
        _refuse_feature_sharded(self.cfg, whole_fit=False)
        self.trainer_used_ = "step"
        if self.cfg.resolved_stage_dtype() == "int8":
            stream = stage_blocks(stream, "int8")
        w, state = online_distributed_pca(
            stream, self.cfg, device=self.device, state=self.state,
            on_step=on_step, worker_masks=worker_masks, max_steps=max_steps,
            v0=self.v0,
        )
        self._w, self.state = w, state
        return self

    # -- results ------------------------------------------------------------

    @property
    def components_(self) -> torch.Tensor:
        """``(dim, k)`` principal directions, descending order."""
        if self._w is None:
            raise RuntimeError("call fit() first")
        return self._w

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
        x = torch.as_tensor(x).to(device=self.device, dtype=torch_dtype(self.cfg.dtype))
        return project_exact(x, w)

    def fit_transform(self, data, **kw) -> torch.Tensor:
        return self.fit(data, **kw).transform(data)
