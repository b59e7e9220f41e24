"""One constructor for the whole-fit trainers, and the final extraction.

Counterpart of ``distributed_eigenspaces_tpu/api/runner.py``:
:func:`make_whole_fit` names the program kind and returns a uniform
:class:`WholeFitHandle`; which kind fits a workload stays with the caller
(``choose_trainer`` for the estimator)::

    h = make_whole_fit(cfg, kind, mesh, segment=..., masked=..., device=...)
    state = h.init_state()
    state = h.fit(state, blocks, idx=None, worker_masks=None)
    state = h.fit_windows(state, windows, on_segment=..., worker_masks=...)
    w = h.extract(state)          # (d, k), descending, canonical signs

Kinds: ``"scan"`` (the dense whole fit) and ``"segmented"`` (dense,
windowed and checkpointable), each on one device (``mesh=None``) or on a
``(workers, features)`` mesh of ranks (``parallel/mesh.py``), where every
rank runs the handle and holds the same state; ``"fs_scan"`` (the exact
rank-r trainer) and ``"sketch"`` (the Nystrom sketch) of
``parallel/feature_sharded.py``, on a ``(workers, features)`` mesh (default
``parallel.mesh.auto_feature_mesh(cfg)``, the ``(1, 1)`` layout in one
process), where each rank holds its rows of the state and ``extract``
returns its rows of the basis; both are windowed and checkpointable
(``fit_windows``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import initial_basis, merged_top_k
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

KINDS = ("scan", "segmented", "fs_scan", "sketch")


@dataclass(frozen=True)
class WholeFitHandle:
    kind: str
    fit: Callable  # (state, blocks, idx=None, worker_masks=None) -> state
    init_state: Callable[[], Any]
    extract: Callable[[Any], torch.Tensor]
    fit_windows: Callable | None = None
    #: trainer-specific extras (the segment length) for reports
    info: dict | None = None
    #: the underlying trainer, for attributes the handle does not model
    raw: Any = None


def extract_dense(cfg: PCAConfig, sigma_tilde: torch.Tensor, v0=None) -> torch.Tensor:
    """Top-k of the running projector average by the configured solver and
    orthonormalization, at ``max(cfg.subspace_iters, 16)`` iterations from
    ``v0`` (default: :func:`~..ops.linalg.initial_basis` from ``cfg.seed``)
    under the subspace solver. ``solver="distributed"`` resolves to the
    subspace solver here at any d, as in the reference: the state is a dense
    d x d already, so the factor-operator extract has nothing to save."""
    return merged_top_k(
        sigma_tilde.float(), cfg.k, cfg.resolved_local_solver(),
        max(cfg.subspace_iters, 16), cfg.orth_method,
        v0=initial_basis(
            cfg.dim, cfg.k, seed=cfg.seed, device=sigma_tilde.device, v0=v0
        ),
    )


def make_whole_fit(
    cfg: PCAConfig,
    kind: str,
    mesh=None,
    *,
    segment: int = 50,
    gather: bool = False,
    masked: bool = False,
    device="cuda",
    v0=None,
    v_init=None,
    supervisor=None,
) -> WholeFitHandle:
    """Build the ``kind`` whole-fit trainer as a uniform handle, on
    ``device``, with the cold start ``v0 (d, k)`` of every subspace solve
    and of the extraction and the crossover-merge start ``v_init`` (both
    drawn from ``cfg.seed`` by default). ``gather`` / ``masked`` select
    the dense scan's gather and §5.3 variants (``algo/scan.py``); a masked
    segmented fit runs through ``fit_windows(worker_masks=...)``. With a
    ``mesh`` the handle runs on its device (``device`` is not used) and the
    fits shard each step's workers over it. ``supervisor`` (a
    ``runtime.supervisor.Supervisor``) runs the handle's ``fit`` and
    ``fit_windows`` under its retry and backoff policy."""
    if kind not in KINDS:
        raise ValueError(f"unknown whole-fit kind {kind!r}; one of {KINDS}")
    if supervisor is not None:
        inner = make_whole_fit(cfg, kind, mesh, segment=segment, gather=gather,
                               masked=masked, device=device, v0=v0, v_init=v_init)
        return supervisor.wrap_handle(inner)
    if kind in ("fs_scan", "sketch"):
        return _feature_sharded_handle(cfg, kind, mesh, device=device,
                                       v_init=v_init)
    dev = pmesh.mesh_device(mesh, device)
    v_cold = initial_basis(cfg.dim, cfg.k, seed=cfg.seed, device=dev, v0=v0)

    def extract(st):
        return extract_dense(cfg, st.sigma_tilde, v0=v_cold)

    if kind == "scan":
        from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
        from distributed_eigenspaces_tpu_torch.algo.scan import make_scan_fit

        f = make_scan_fit(cfg, mesh=mesh, device=dev, v0=v_cold, v_init=v_init,
                          gather=gather, masked=masked)

        def fit(state, blocks, idx=None, worker_masks=None):
            if masked:
                if worker_masks is None:
                    raise ValueError("masked scan fit needs worker_masks")
                return f(state, blocks, worker_masks)[0]
            if worker_masks is not None:
                raise ValueError(
                    "unmasked scan handle got worker_masks; build with "
                    "masked=True"
                )
            if gather:
                return f(state, blocks, idx)[0]
            return f(state, blocks)[0]

        return WholeFitHandle(
            kind=kind, fit=fit,
            init_state=lambda: OnlineState.initial(cfg.dim, cfg.state_dtype,
                                                   device=dev),
            extract=extract, raw=f,
        )

    from distributed_eigenspaces_tpu_torch.algo.scan import (
        SegmentState,
        make_segmented_fit,
    )

    f = make_segmented_fit(cfg, segment=segment, mesh=mesh, device=dev, v0=v_cold,
                           v_init=v_init)

    def fit(state, blocks, idx=None, worker_masks=None, on_segment=None):
        # masked segmented fits go through fit_windows with (S, m) mask
        # windows (the estimator's lockstep mask windows)
        if worker_masks is not None:
            raise ValueError("segmented masks run via fit_windows(worker_masks=...)")
        return f(state, blocks, on_segment=on_segment)

    return WholeFitHandle(
        kind=kind, fit=fit,
        init_state=lambda: SegmentState.initial(cfg.dim, cfg.k, cfg.state_dtype,
                                                device=dev),
        extract=extract, fit_windows=f.fit_windows, info={"segment": f.segment},
        raw=f,
    )


def _feature_sharded_handle(cfg: PCAConfig, kind: str, mesh, *, device,
                            v_init=None) -> WholeFitHandle:
    """The feature-sharded kinds as a handle: ``fit(state, blocks, idx=None,
    worker_masks=None)`` with ``idx`` defaulting to every block once."""
    from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as fs

    if mesh is None:
        mesh = pmesh.auto_feature_mesh(cfg, device)
    if kind == "fs_scan":
        f = fs.make_feature_sharded_scan_fit(cfg, mesh, device=device, v_init=v_init,
                                             collectives=cfg.collectives)
        info = {"rank": f.rank}
    else:
        f = fs.make_feature_sharded_sketch_fit(cfg, mesh, device=device,
                                               collectives=cfg.collectives)
        info = {"sketch_width": f.sketch_width}

    def fit(state, blocks, idx=None, worker_masks=None):
        return f(state, blocks, idx, worker_masks=worker_masks)

    return WholeFitHandle(kind=kind, fit=fit, init_state=f.init_state,
                          extract=f.extract, fit_windows=f.fit_windows, info=info,
                          raw=f)
