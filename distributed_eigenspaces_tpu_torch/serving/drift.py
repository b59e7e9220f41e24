"""DriftMonitor: served residual energy -> background refit -> republish.

The port's copy of ``distributed_eigenspaces_tpu/serving/drift.py``. Two
signals of different cost make one drift score:

- **Residual energy (free).** Every served batch already computes each
  query's residual energy ``||x||^2 - ||x V||^2`` (``serving/transform.py``);
  the :class:`~.server.QueryServer` hands each batch's sums to
  :meth:`DriftMonitor.observe`. An EWMA of the residual ratio against the
  live version's published explained-variance baseline is the always-on
  tripwire.
- **Principal-angle gap (paid on suspicion).** When the tripwire arms, a
  background refit runs on a ring buffer of recently served rows, and the
  worst principal angle between the live basis and the refit confirms the
  drift (a noisy residual spike with no rotation does not republish).

``score = residual_drift + angle_gap_deg / 90``; at or past ``threshold``
the refit publishes as a new registry version (lineage: the trigger score
and the version it replaces), and the server's next batch serves it through
the lock-free ``latest()``.

The refit is the caller's ``refit`` hook, else by default the supervised
per-step fit (``runtime/supervisor.supervised_fit``: a corrupt buffered
block is quarantined instead of killing the refresh), or with
``supervise=False`` the port's ``OnlineDistributedPCA`` on the buffered rows.
A ``MetricsLogger`` (``metrics=``) receives each refresh as a ``drift``
serve event (score, residual drift, angle gap, published version) and the
supervised refit's faults; its tracer records the refresh's spans.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.serving.registry import (
    BasisVersion,
    EigenbasisRegistry,
    _host,
)
from distributed_eigenspaces_tpu_torch.utils.metrics import log_line
from distributed_eigenspaces_tpu_torch.utils.telemetry import tracer_of

__all__ = ["DriftMonitor"]

_EPS = 1e-12


class DriftMonitor:
    """Folds served residual energy and a background-refit angle gap into
    a drift score; past ``threshold``, republishes.

    Args, as the reference's:
      registry: where refreshed versions publish (and the live baseline is
        read from).
      cfg: the refit's ``PCAConfig``: block geometry for the buffered rows;
        ``num_steps`` is re-derived from the buffer size.
      threshold: drift score at or above which a refresh publishes.
      arm_ratio: residual-drift level that arms the background refit;
        default ``threshold / 2``.
      ema_alpha: EWMA weight of the per-batch residual ratio.
      buffer_rows: ring-buffer capacity of served rows the refit trains
        on; default one full fit's worth (``num_steps * num_workers *
        rows_per_worker``).
      supervise: run the refit under ``supervised_fit`` (quarantine and
        retry) instead of a bare fit.
      refit: ``(rows) -> (w, state)`` replacing the built-in refit.
      auto: spawn the background refresh thread when armed; ``False``
        leaves refreshes to :meth:`refresh_now`.
      cooldown_batches: observed batches between auto refreshes.
      lease: a ``serving/replication.PublisherLease``: only its holder
        publishes (a non-holder's confirmed refresh is dropped and counted
        in ``publishes_rejected``).
      metrics: a ``MetricsLogger``: drift events land in its
        ``summary()["serving"]``.
      device: where the built-in refit runs (``"cuda"`` unless asked).
    """

    def __init__(
        self,
        registry: EigenbasisRegistry,
        cfg,
        *,
        threshold: float = 0.25,
        arm_ratio: float | None = None,
        ema_alpha: float = 0.2,
        buffer_rows: int | None = None,
        supervise: bool = True,
        refit: Callable | None = None,
        auto: bool = True,
        cooldown_batches: int = 8,
        lease=None,
        metrics=None,
        device="cuda",
    ):
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.registry = registry
        self.metrics = metrics
        self.cfg = cfg
        self.threshold = threshold
        self.arm_ratio = threshold / 2.0 if arm_ratio is None else arm_ratio
        self.ema_alpha = ema_alpha
        self.supervise = supervise
        self.refit = refit
        self.auto = auto
        self.cooldown_batches = cooldown_batches
        self.lease = lease
        self.device = device
        #: refreshes whose publish was dropped because this process did not
        #: hold the publisher lease
        self.publishes_rejected = 0
        self._observes_since_refresh = 0
        rows_per_step = cfg.num_workers * cfg.rows_per_worker
        self.buffer_rows = buffer_rows or cfg.num_steps * rows_per_step
        self._lock = threading.Lock()
        self._buffer: list[np.ndarray] = []
        self._buffered = 0
        self._ewma: float | None = None
        self._baseline: float | None = None
        self._baseline_version: int | None = None
        self._refresh_lock = threading.Lock()
        self._refresh_thread: threading.Thread | None = None
        #: last computed drift score (refreshes update it)
        self.last_score: float | None = None
        self.refreshes = 0
        #: seconds of the last refresh's refit
        self.last_refit_s: float | None = None

    # -- cheap always-on signal ---------------------------------------------

    def _live_baseline(self) -> float | None:
        """Residual-ratio baseline of the live version: ``1 - top_k_energy``
        from its published summary when there is one, else the first EWMA
        observed while it was live (re-anchored on every version change)."""
        live = self.registry.latest()
        if live is None:
            return None
        if self._baseline_version != live.version:
            self._baseline_version = live.version
            energy = live.explained_variance.get("top_k_energy")
            self._baseline = max(0.0, 1.0 - energy) if energy is not None else None
        return self._baseline

    def observe(self, residual_sq: float, input_sq: float, rows=None) -> float:
        """Fold one served batch's energies (and buffer its ``rows``);
        returns the residual drift (EWMA ratio minus the live baseline).
        Called by the server's dispatch lane: host arithmetic under a lock."""
        ratio = residual_sq / max(input_sq, _EPS)
        with self._lock:
            self._ewma = (
                ratio if self._ewma is None
                else (1 - self.ema_alpha) * self._ewma + self.ema_alpha * ratio
            )
            baseline = self._live_baseline()
            if baseline is None:
                # no published energy summary: the first impression is the
                # baseline
                self._baseline = baseline = self._ewma
            drift = max(0.0, self._ewma - baseline)
            if rows is not None:
                arr = np.asarray(rows, np.float32)
                self._buffer.append(arr)
                self._buffered += arr.shape[0]
                while (
                    len(self._buffer) > 1
                    and self._buffered - self._buffer[0].shape[0] >= self.buffer_rows
                ):
                    self._buffered -= self._buffer.pop(0).shape[0]
            self._observes_since_refresh += 1
            armed = (
                drift > self.arm_ratio
                and self._buffered >= self.cfg.num_workers * self.cfg.rows_per_worker
                and (self.refreshes == 0
                     or self._observes_since_refresh >= self.cooldown_batches)
            )
        if armed and self.auto:
            self._spawn_refresh()
        return drift

    def residual_drift(self) -> float:
        with self._lock:
            if self._ewma is None:
                return 0.0
            baseline = self._live_baseline()
            if baseline is None:
                return 0.0
            return max(0.0, self._ewma - baseline)

    def buffered_rows(self) -> int:
        """Rows in the refit buffer."""
        with self._lock:
            return self._buffered

    # -- paid confirmation + republish ---------------------------------------

    def _spawn_refresh(self) -> None:
        if self._refresh_lock.locked():
            return  # one background refresh in flight at a time
        t = threading.Thread(target=self._refresh_guarded, daemon=True)
        self._refresh_thread = t
        t.start()

    def _refresh_guarded(self) -> None:
        """Background-thread wrapper: a refresh that dies is logged, not
        lost with a daemon thread; serving continues on the stale version
        and the next armed batch retries."""
        try:
            self.refresh_now()
        except Exception as e:
            log_line("drift refresh failed", error=repr(e))
            if self.metrics is not None:
                self.metrics.serve({"kind": "drift", "error": repr(e),
                                    "published": None})

    def join_refresh(self, timeout: float | None = None) -> None:
        """Wait for an in-flight background refresh."""
        t = self._refresh_thread
        if t is not None:
            t.join(timeout)

    def refreshing(self) -> bool:
        """True while a background refresh runs."""
        t = self._refresh_thread
        return t is not None and t.is_alive()

    def _run_refit(self, rows: np.ndarray):
        """The refit on the buffered rows (``num_steps`` re-derived from
        them): the caller's ``refit``, else supervised by default (a
        corrupt buffered block is quarantined instead of killing the
        refresh), else the port's estimator. Returns ``(w, state)``."""
        if self.refit is not None:
            return self.refit(rows)
        cfg = self.cfg
        steps = max(1, len(rows) // (cfg.num_workers * cfg.rows_per_worker))
        cfg = dataclasses.replace(cfg, num_steps=steps)
        if self.supervise:
            from distributed_eigenspaces_tpu_torch.data.stream import block_stream
            from distributed_eigenspaces_tpu_torch.runtime.supervisor import (
                supervised_fit,
            )

            def factory(start_row):
                return block_stream(
                    rows, num_workers=cfg.num_workers,
                    rows_per_worker=cfg.rows_per_worker, start_row=start_row,
                    remainder=cfg.remainder, device=self.device,
                )

            w, state, _sup = supervised_fit(factory, cfg, metrics=self.metrics,
                                            device=self.device)
            return w, state
        from distributed_eigenspaces_tpu_torch.api.estimator import OnlineDistributedPCA

        est = OnlineDistributedPCA(cfg, device=self.device)
        est.fit(rows)
        return est.components_, est.state

    def refresh_now(self) -> BasisVersion | None:
        """Run the refit and the angle confirmation inline; publish and
        return the new version when the score clears the threshold, else
        None. Serializes with the background refresh."""
        from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

        with self._refresh_lock:
            with self._lock:
                if not self._buffer:
                    return None
                rows = np.concatenate(self._buffer, axis=0)
                drift = (
                    max(0.0, (self._ewma or 0.0) - (self._baseline or 0.0))
                    if self._ewma is not None else 0.0
                )
            live = self.registry.latest()
            if live is None:
                return None
            tr = tracer_of(self.metrics)
            trace_id = tr.new_trace("drift")
            with tr.span(
                "drift_refresh", trace_id=trace_id, category="drift",
                attrs={"refit_rows": int(len(rows)),
                       "residual_drift": round(drift, 4),
                       "base_version": live.version},
            ):
                t0 = time.perf_counter()
                with tr.span("refit", category="drift"):
                    w, state = self._run_refit(rows)
                    w = _host(w)
                self.last_refit_s = time.perf_counter() - t0
                with tr.span("angle_confirm", category="drift"):
                    angle = float(torch.max(principal_angles_degrees(
                        torch.from_numpy(np.array(w, np.float32)),
                        torch.from_numpy(np.array(live.v, np.float32)))))
            score = drift + angle / 90.0
            self.last_score = score
            self.refreshes += 1
            with self._lock:
                self._observes_since_refresh = 0
            published = None
            rejected = None
            if score >= self.threshold and self.lease is not None \
                    and not self.lease.check():
                # only the lease holder publishes; the holder's own monitor
                # performs the real refresh
                rejected = "not_lease_holder"
                self.publishes_rejected += 1
                log_line(
                    "drift refresh publish rejected: not lease holder",
                    score=round(score, 4),
                    owner=getattr(self.lease, "owner", None),
                )
            elif score >= self.threshold:
                sigma = getattr(state, "sigma_tilde", None)
                sigma = _host(sigma) if sigma is not None else None
                published = self.registry.publish(
                    w,
                    sigma_tilde=sigma if sigma is not None and sigma.ndim == 2 else None,
                    step=int(state.step) if state is not None else 0,
                    lineage={
                        "producer": "drift_refresh",
                        "base_version": live.version,
                        "trigger_score": round(score, 4),
                        "supervised": self.supervise and self.refit is None,
                    },
                )
                with self._lock:
                    # re-anchor the tripwire on the new version
                    self._ewma = None
                tr.event("publish", trace_id=trace_id, category="drift",
                         attrs={"version": published.version,
                                "score": round(score, 4)})
            if self.metrics is not None:
                event = {
                    "kind": "drift",
                    "trace_id": trace_id,
                    "score": round(score, 4),
                    "residual_drift": round(drift, 4),
                    "angle_gap_deg": round(angle, 4),
                    "refit_rows": int(len(rows)),
                    "published": published.version if published else None,
                }
                if rejected is not None:
                    event["rejected"] = rejected
                self.metrics.serve(event)
            log_line("drift refresh", score=round(score, 4),
                     residual_drift=round(drift, 4), angle_gap_deg=round(angle, 4),
                     refit_rows=int(len(rows)),
                     published=published.version if published else None)
            return published
