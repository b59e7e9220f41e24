"""Prewarmer: acquire expected signatures' programs OFF the serving thread.

The port's copy of ``distributed_eigenspaces_tpu/runtime/prewarm.py``.
A serving tier (``parallel/fleet.FleetServer``,
``serving/server.QueryServer``) would otherwise pay a signature's first
acquisition inside its dispatch lane, where the stall
blocks every queued neighbour. In the port there is no compile step: what
acquiring a program costs is building its closures and, on a first use,
the hand kernels' ``nvcc`` build (``ops/_build.py``) and the cuBLAS /
cuSOLVER libraries' start-up. The rule is the reference's: keep the
per-signature program count small, and have every program READY before
traffic needs it.

:class:`Prewarmer` is a background lane: a daemon thread draining a queue
of ``(label, thunk)`` jobs. The serving thread never blocks on an
acquisition it could have avoided: a signature that is not ready yet is
acquired in the background while its bucket waits out the flush deadline.

Three feeds, as in the reference:

- **Bucket specs**: ``ShapeBucketQueue.pending_signatures()`` names the
  shapes traffic is already queuing for; ``FleetServer.prewarm()``
  acquires its fleet programs through here.
- **Registry versions**: :meth:`warm_registry` walks an
  ``EigenbasisRegistry``'s published ``(d, k)`` signatures and acquires a
  ``TransformEngine``'s row buckets for each (:meth:`warm_engine`).
- **Explicit declarations**: :meth:`warmup` takes caller-declared
  signatures with a builder callback.

Thunks are expected to be idempotent and cheap on re-entry (every
acquisition path lands in a keyed cache: the engine's program dict,
``fit_fleet``'s ``fit_cache``), so a race between a prewarm and a live
request costs at worst one duplicate acquisition, never a wrong result.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Sequence

__all__ = ["Prewarmer", "registry_signatures"]


def registry_signatures(registry) -> list[tuple[int, int]]:
    """The distinct ``(d, k)`` signatures of a registry's retained
    versions, oldest first: the read-side prewarm feed."""
    sigs: list[tuple[int, int]] = []
    for vid in registry.versions():
        try:
            sig = registry.get(vid).signature
        except KeyError:  # collected between versions() and get()
            continue
        if sig not in sigs:
            sigs.append(sig)
    return sigs


class Prewarmer:
    """Background acquisition lane with per-label readiness tracking.

    ``submit(label, thunk)`` enqueues one job; :meth:`ready` asks whether a
    label is done; :meth:`wait` blocks until everything submitted so far
    has drained (the fence: wait, THEN serve, and the first request
    acquires nothing). A thunk that raises marks its label failed and is
    logged: a prewarm failure degrades to the inline acquisition, never
    takes the server down.
    """

    def __init__(self, *, metrics=None):
        self.metrics = metrics
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Condition()
        self._status: dict[Any, str] = {}  # label -> pending|ready|failed
        self._outstanding = 0
        self.compiled = 0
        self.failed = 0
        self.compile_ms_total = 0.0
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="prewarmer", daemon=True
        )
        self._thread.start()

    # -- submission ----------------------------------------------------------

    def submit(self, label: Any, thunk: Callable[[], Any]):
        """Enqueue one job; returns ``label``. Labels already pending or
        ready are skipped (idempotent declarations)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("submit on a closed Prewarmer")
            if self._status.get(label) in ("pending", "ready"):
                return label
            self._status[label] = "pending"
            self._outstanding += 1
        self._q.put((label, thunk))
        return label

    def warmup(
        self,
        signatures: Iterable[Any],
        *,
        compiler: Callable[[Any], Any],
        label_prefix: str = "sig",
    ) -> list:
        """Explicit-declaration feed: one job per signature via
        ``compiler(signature)``. Returns the submitted labels."""
        return [
            self.submit((label_prefix, sig), lambda s=sig: compiler(s))
            for sig in signatures
        ]

    def warm_engine(
        self,
        engine,
        rows: Sequence[int],
        *,
        kinds: Sequence[str] = ("project", "residual"),
    ) -> list:
        """Transform feed: acquire ``engine``'s programs for the padded row
        buckets covering ``rows`` query sizes (deduplicated: several row
        counts share one power-of-two bucket) and, on a card, launch each
        once (``TransformEngine.warm``): the launch loads the serve
        kernel's library and starts cuBLAS here rather than in the first
        request."""
        from distributed_eigenspaces_tpu_torch.serving.transform import (
            bucket_rows,
        )

        padded = sorted(
            {bucket_rows(int(r), min_bucket=engine.min_bucket) for r in rows}
        )
        labels = []
        for p in padded:
            for kind in kinds:
                labels.append(
                    self.submit(
                        ("engine", engine.d, engine.k, kind, p),
                        lambda k=kind, p=p: engine.warm(k, p),
                    )
                )
        return labels

    def warm_registry(
        self,
        registry,
        *,
        make_engine: Callable[[int, int], Any],
        rows: Sequence[int],
        kinds: Sequence[str] = ("project", "residual"),
    ) -> list:
        """Registry feed: acquire transform programs for every published
        ``(d, k)`` signature. ``make_engine(d, k)`` supplies (and should
        cache) the engine serving that signature."""
        labels = []
        for d, k in registry_signatures(registry):
            labels.extend(
                self.warm_engine(make_engine(d, k), rows, kinds=kinds)
            )
        return labels

    # -- readiness -----------------------------------------------------------

    def ready(self, label: Any) -> bool:
        with self._lock:
            return self._status.get(label) == "ready"

    def wait(self, timeout: float | None = None) -> bool:
        """Block until every submitted job has finished (ready or failed);
        returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._outstanding > 0:
                rem = (
                    None if deadline is None
                    else deadline - time.monotonic()
                )
                if rem is not None and rem <= 0:
                    return False
                self._lock.wait(rem)
            return True

    def stats(self) -> dict:
        with self._lock:
            return {
                "submitted": len(self._status),
                "compiled": self.compiled,
                "failed": self.failed,
                "pending": self._outstanding,
                "compile_ms_total": round(self.compile_ms_total, 3),
            }

    def close(self) -> None:
        """Stop accepting jobs and join the lane after the queue drains.
        Idempotent; the daemon thread also dies with the process."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(None)
        self._thread.join()

    def __enter__(self) -> "Prewarmer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the lane ------------------------------------------------------------

    def _loop(self) -> None:
        from distributed_eigenspaces_tpu_torch.utils.metrics import log_line
        from distributed_eigenspaces_tpu_torch.utils.telemetry import tracer_of

        while True:
            item = self._q.get()
            if item is None:
                return
            label, thunk = item
            tr = tracer_of(self.metrics)  # re-resolved: a late attach works
            t0 = time.perf_counter()
            try:
                thunk()
                status = "ready"
            except Exception as e:
                status = "failed"
                log_line(
                    "prewarm acquisition failed — the signature will "
                    "be acquired inline on first use instead",
                    label=repr(label),
                    error=repr(e),
                )
            t1 = time.perf_counter()
            tr.record_span(
                "prewarm_compile", t0, t1, category="compile",
                attrs={"label": repr(label), "status": status},
            )
            dt_ms = (t1 - t0) * 1e3
            with self._lock:
                self._status[label] = status
                self._outstanding -= 1
                if status == "ready":
                    self.compiled += 1
                else:
                    self.failed += 1
                self.compile_ms_total += dt_ms
                self._lock.notify_all()
