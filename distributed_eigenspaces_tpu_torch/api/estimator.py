"""sklearn-style estimator over the port's trainers.

Counterpart of ``OnlineDistributedPCA`` in ``distributed_eigenspaces_tpu/
api/estimator.py``, with the two trainers this port has: the whole-fit
scan (``fit`` by default) and the per-step loop (``fit_stream``, or
``fit`` with per-step hooks). The reference's segmented, sketch, fleet
and feature-sharded trainers, masked whole fits and checkpointing are
not ported yet (ROADMAP.md Queue 1 items 9c and 9f).
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
from distributed_eigenspaces_tpu_torch.data.stream import block_stream
from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype
from distributed_eigenspaces_tpu_torch.ops.linalg import initial_basis

TRAINERS = ("auto", "scan", "step")


class OnlineDistributedPCA:
    """Online distributed PCA estimator on one device (``"cuda"`` unless
    the caller asks for another)::

        pca = OnlineDistributedPCA(PCAConfig(dim=3072, k=10, ...))
        pca.fit(data)              # data: (N, 3072), numpy or torch
        z = pca.transform(data)    # (N, 10)
        w = pca.components_        # (3072, 10), descending, canonical signs

    ``v0`` is the cold start basis ``(d, k)`` of every subspace solve
    (default: drawn from ``cfg.seed``).
    """

    def __init__(self, cfg: PCAConfig, *, device="cuda", trainer: str = "auto",
                 v0=None):
        if trainer not in TRAINERS:
            raise ValueError(f"unknown trainer {trainer!r}; one of {TRAINERS}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.trainer = trainer
        self.v0 = initial_basis(
            cfg.dim, cfg.k, seed=cfg.seed, device=self.device, v0=v0
        )
        self.state: OnlineState | None = None
        self.trainer_used_: str | None = None
        self._w: torch.Tensor | None = None

    # -- fitting ------------------------------------------------------------

    def fit(self, data, *, on_step=None, worker_masks=None) -> "OnlineDistributedPCA":
        """Fit on ``(N, dim)`` data, streamed as ``num_steps`` blocks of
        ``num_workers x rows_per_worker`` rows. Starts fresh. Runs the
        whole-fit scan trainer unless per-step hooks (``on_step``,
        ``worker_masks``) or ``trainer="step"`` ask for the per-step loop."""
        self.state = None
        self._w = None
        cfg = self.cfg
        trainer = self.trainer
        hooks = on_step is not None or worker_masks is not None
        if trainer == "auto":
            trainer = "step" if hooks else "scan"
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
        self.trainer_used_ = "scan"
        blocks = list(block_stream(
            data, num_workers=cfg.num_workers,
            rows_per_worker=cfg.rows_per_worker, num_steps=cfg.num_steps,
            remainder=cfg.remainder, dtype=cfg.resolved_stage_dtype(),
            device=self.device,
        ))
        if not blocks:
            raise ValueError("dataset yielded zero full steps")
        fit = make_scan_fit(cfg, device=self.device, v0=self.v0)
        state, _ = fit(
            OnlineState.initial(cfg.dim, cfg.state_dtype, device=self.device),
            torch.stack(blocks),
        )
        self.state = state
        self._w = extract_dense(cfg, state.sigma_tilde, v0=self.v0)
        return self

    def fit_stream(self, stream, *, on_step=None, worker_masks=None,
                   max_steps="auto") -> "OnlineDistributedPCA":
        """Fit (or continue fitting) on an iterable of ``(m, n, dim)`` blocks
        with the per-step loop."""
        self.trainer_used_ = "step"
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
        """Project ``(N, dim) -> (N, k)`` (or ``(dim,) -> (k,)``) with a plain
        ``torch.matmul`` in ``cfg.dtype``.

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
        return torch.matmul(x, w.to(x.dtype))

    def fit_transform(self, data, **kw) -> torch.Tensor:
        return self.fit(data, **kw).transform(data)
