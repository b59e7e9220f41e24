"""Self-healing runs: fault-detecting supervision of fits and serve lanes.

The port's copy of ``distributed_eigenspaces_tpu/runtime/supervisor.py``.
The serve half: :class:`FaultLedger`, :class:`SupervisorError`,
:class:`BreakerOpen`, :class:`CircuitBreaker` and :class:`LaneWatchdog`
(``runtime/scheduler.py`` and ``serving/server.py`` use them). The fit
half: :class:`Supervisor` and :func:`supervised_fit`, four detection ->
policy -> recovery loops:

1. Block quarantine (:meth:`Supervisor.screen_block`): every incoming
   ``(m, n, d)`` block crosses a boundary check (a non-finite scan per
   worker, short reads, shape damage). A corrupt worker becomes a worker
   mask drop for that round, its rows replaced by finite placeholder rows
   so a masked-out NaN cannot ride ``0 * NaN = NaN`` into ``sigma_tilde``.
   A fault budget bounds the silent degradation; past it the run raises
   :class:`SupervisorError` with the ledger attached.
2. Retry with capped exponential backoff (:meth:`Supervisor.step_hook`, the
   guarded stream's pulls, :meth:`Supervisor.run_guarded`) for transient
   failures: host IO, the card's out-of-memory and accelerator errors, and
   a guard that fired (``utils/guards.CheckError``). A retry re-runs the
   same route on the same device; it never falls back to another.
3. Auto-resume (:func:`supervised_fit`): on escalation, or a process
   restart, the newest committed checkpoint is restored and the stream
   re-opened at its cursor, so recovery replays only the steps since the
   last commit, under a bounded number of in-process resumes.
4. Quorum (``runtime/membership.py``): a ``QuorumLost`` from an elastic
   stream waits a bounded time for quorum to return (rejoiners admitted
   during the wait), then resumes under the same budget. Membership masks
   and quarantine masks combine by multiplication.

Every fault event lands in the supervisor's ledger and, with a
``MetricsLogger`` attached, in ``summary()["faults"]`` and on the tracer's
timeline.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.runtime.membership import QuorumLost
from distributed_eigenspaces_tpu_torch.utils.guards import CheckError

__all__ = [
    "BreakerOpen",
    "CircuitBreaker",
    "FaultLedger",
    "LaneWatchdog",
    "RETRYABLE",
    "Supervisor",
    "SupervisorError",
    "supervised_fit",
]


def _retryable_exceptions() -> tuple:
    """Exception classes the supervisor treats as transient: host IO, a
    guard that fired (``utils/guards.CheckError``, the reference's
    ``checkify.JaxRuntimeError``), and the device-side failures the
    installed torch raises (out of memory, and ``torch.AcceleratorError``
    where this torch has it)."""
    kinds: list[type] = [OSError, CheckError, torch.cuda.OutOfMemoryError]
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(accel, type) and issubclass(accel, BaseException):
        kinds.append(accel)
    return tuple(kinds)


RETRYABLE = _retryable_exceptions()

#: ledger kinds that spend fault budget — the DEGRADATION events
#: (accuracy already paid), not the recovery bookkeeping around them
BUDGET_KINDS = ("quarantine_nonfinite", "quarantine_short", "dropped_round")


class FaultLedger:
    """Append-only record of every fault event in a supervised run."""

    def __init__(self):
        self.events: list[dict] = []

    def record(self, kind: str, step: int | None, **detail) -> dict:
        ev = {"kind": kind, "step": step, **detail}
        self.events.append(ev)
        return ev

    @property
    def by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    @property
    def budget_spent(self) -> int:
        """Fault units spent: one per quarantined WORKER-round, one per
        dropped round — i.e. proportional to how much of the data the
        run has already degraded away."""
        spent = 0
        for e in self.events:
            if e["kind"] in BUDGET_KINDS:
                spent += len(e.get("workers", ())) or 1
        return spent

    def as_dict(self) -> dict:
        return {
            "count": len(self.events),
            "budget_spent": self.budget_spent,
            "by_kind": self.by_kind,
            "events": list(self.events),
        }


class SupervisorError(RuntimeError):
    """Loud terminal failure of a supervised run — fault budget
    exhausted, or retries AND resumes exhausted. Carries the full fault
    ledger so the post-mortem starts with the evidence attached."""

    def __init__(self, message: str, ledger: FaultLedger):
        self.ledger = ledger
        counts = ledger.by_kind
        super().__init__(
            f"{message} (fault ledger: {len(ledger.events)} events, "
            f"{counts})"
        )


class BreakerOpen(RuntimeError):
    """Fast-fail: the circuit breaker for this dispatch signature is
    OPEN. Raised at the admission boundary (submit), so a caller hitting
    a poisoned signature gets an immediate, attributable error instead
    of a ticket that burns a retry ladder and fails seconds later —
    while every OTHER signature keeps serving. Carries the breaker so
    the caller can inspect state / time-to-probe."""

    def __init__(self, message: str, breaker: "CircuitBreaker" = None):
        super().__init__(message)
        self.breaker = breaker


class CircuitBreaker:
    """Per-signature circuit breaker for the serving dispatch path.

    States: ``closed`` (normal service) → ``open`` after ``threshold``
    CONSECUTIVE dispatch failures (admission fast-fails with
    :class:`BreakerOpen`) → ``half_open`` after ``cooldown_s`` (exactly
    ONE probe request is admitted) → ``closed`` on probe success /
    ``open`` again on probe failure. One success resets the consecutive
    count — the breaker reacts to a poisoned signature, not to a lossy
    one. Thread-safe; ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1: {threshold}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0: {cooldown_s}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self.consecutive_failures = 0
        self.opened_at: float | None = None
        self.last_error: str | None = None
        self._probe_inflight = False
        #: times the breaker tripped closed→open (probe reopens count)
        self.trips = 0
        #: admissions rejected while open (the fast-fail count)
        self.fast_fails = 0

    def allow(self) -> bool:
        """Admission check: True in ``closed``; after the cooldown
        exactly one half-open probe passes; everything else fast-fails
        (counted)."""
        with self._lock:
            if self.state == "closed":
                return True
            if (
                self.state == "open"
                and self._clock() - self.opened_at >= self.cooldown_s
            ):
                self.state = "half_open"
                self._probe_inflight = False
            if self.state == "half_open" and not self._probe_inflight:
                self._probe_inflight = True
                return True
            self.fast_fails += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self._probe_inflight = False
            self.state = "closed"

    def record_failure(self, error: Exception | str | None = None) -> bool:
        """Fold one dispatch failure; returns True when this failure
        tripped (or re-tripped) the breaker open."""
        with self._lock:
            self.consecutive_failures += 1
            if error is not None:
                self.last_error = repr(error) if isinstance(
                    error, Exception
                ) else str(error)
            tripping = (
                self.state == "half_open"  # failed probe: straight back
                or self.consecutive_failures >= self.threshold
            )
            if tripping and self.state != "open":
                self.state = "open"
                self.opened_at = self._clock()
                self._probe_inflight = False
                self.trips += 1
                return True
            return False

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "threshold": self.threshold,
                "trips": self.trips,
                "fast_fails": self.fast_fails,
            }
            if self.state == "open":
                out["retry_in_s"] = round(
                    max(
                        0.0,
                        self.cooldown_s - (self._clock() - self.opened_at),
                    ),
                    3,
                )
            if self.last_error is not None:
                out["last_error"] = self.last_error
            return out


class LaneWatchdog:
    """Supervise one daemon dispatch lane: heartbeat by construction
    (the watchdog thread IS the lane's runner), auto-restart with
    capped exponential backoff on lane death, bounded restarts.

    ``target`` is the blocking serve loop (e.g. ``ShapeBucketQueue.
    serve`` via a server's ``_serve_loop``). A clean return means the
    queue closed and drained — done. An exception is a lane death: the
    watchdog records it in the ledger (:class:`FaultLedger`
    form), backs off, and re-enters ``target`` — the queue's records
    and leases survive, so a bucket leased to the dead lane is
    re-leased by lease timeout and its tickets still resolve.
    ``on_dead`` fires when the restart budget is exhausted (the server
    uses it to close admission and fail pending waiters loudly instead
    of hanging them)."""

    def __init__(
        self,
        name: str,
        target: Callable[[], None],
        *,
        max_restarts: int = 3,
        backoff_base: float = 0.05,
        backoff_max: float = 1.0,
        ledger: FaultLedger | None = None,
        on_restart: Callable[[dict], None] | None = None,
        on_dead: Callable[[Exception], None] | None = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.name = name
        self.target = target
        self.max_restarts = max_restarts
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.ledger = ledger if ledger is not None else FaultLedger()
        self.on_restart = on_restart
        self.on_dead = on_dead
        self._sleep = sleep
        self._closing = threading.Event()
        self.restarts = 0
        self.dead = False
        self.last_error: Exception | None = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"watchdog-{name}"
        )

    def start(self) -> "LaneWatchdog":
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            try:
                self.target()
                return  # clean drain: the queue closed
            except BaseException as e:  # noqa: BLE001 — lane death
                self.last_error = e
                if self._closing.is_set():
                    return
                if self.restarts >= self.max_restarts:
                    self.dead = True
                    self.ledger.record(
                        "lane_dead", None, lane=self.name,
                        error=repr(e), restarts=self.restarts,
                    )
                    if self.on_dead is not None:
                        self.on_dead(e)
                    return
                delay = min(
                    self.backoff_max,
                    self.backoff_base * (2.0 ** self.restarts),
                )
                self.restarts += 1
                ev = self.ledger.record(
                    "lane_restart", None, lane=self.name,
                    error=repr(e), attempt=self.restarts,
                    backoff_s=delay,
                )
                if self.on_restart is not None:
                    self.on_restart(ev)
                if delay > 0:
                    self._sleep(delay)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def close(self) -> None:
        """Mark an intentional shutdown: a lane exiting after this is a
        clean drain, never a restartable death."""
        self._closing.set()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)


class _Escalation(Exception):
    """Internal signal: a retry loop exhausted its budget; the supervised
    run's loop decides (auto-resume or terminal error)."""

    def __init__(self, what: str, step: int | None, cause: Exception):
        super().__init__(f"{what} failed at step {step}: {cause!r}")
        self.what = what
        self.step = step
        self.cause = cause


class _MaskFeed:
    """The quarantine-mask side of a guarded stream: one mask pushed per
    yielded block, one popped per executed step (FIFO: prefetch may run
    the block side ahead). ``arm_replay`` re-serves the last mask once, so
    a retried step (which pulls its mask again inside the step) sees the
    same mask instead of taking the next round's."""

    def __init__(self):
        self._q: deque = deque()
        self._last = None
        self._replay = False

    def push(self, mask) -> None:
        self._q.append(mask)

    def arm_replay(self) -> None:
        self._replay = True

    def __iter__(self) -> "_MaskFeed":
        return self

    def __next__(self):
        if self._replay and self._last is not None:
            self._replay = False
            return self._last
        if not self._q:
            raise RuntimeError(
                "mask feed drained out of lockstep with its guarded "
                "stream — a step consumed a mask no screened block "
                "produced (supervisor wiring bug)"
            )
        self._last = self._q.popleft()
        return self._last


class _GuardedStream:
    """Block iterator that screens every pull through the supervisor:
    transient pull failures retry with backoff, each delivered block is
    quarantine-checked, and its per-worker survival mask lands on the
    paired :class:`_MaskFeed`."""

    def __init__(self, sup: "Supervisor", stream: Iterable, base_masks,
                 first_step: int):
        self._sup = sup
        self._raw = stream
        self._it = iter(stream)
        self._base = base_masks
        self._t = first_step - 1

    def __iter__(self) -> "_GuardedStream":
        return self

    def _base_mask(self, t: int):
        b = self._base
        if b is None:
            return None
        if hasattr(b, "__getitem__"):
            # an indexable (T, m) schedule, keyed by absolute step so it
            # survives kill and resume without drifting
            idx = t - 1
            return b[idx] if idx < len(b) else None
        return next(b, None)

    def __next__(self):
        while True:
            t = self._t + 1
            block = self._sup._retry_pull(self._it, t)
            screened = self._sup.screen_block(
                block, t, base_mask=self._base_mask(t)
            )
            if screened is None:
                continue  # dropped round: same step number, next block
            block, mask = screened
            self._sup.mask_feed.push(mask)
            self._t = t
            return block

    def close(self) -> None:
        close = getattr(self._raw, "close", None)
        if close is not None:
            close()


class Supervisor:
    """Policy and ledger of one supervised run.

    Args:
      cfg: the run's ``PCAConfig`` (block geometry for screening).
      fault_budget: most fault units (quarantined worker-rounds plus
        dropped rounds) before the run fails loudly; ``None`` = no cap
        (every fault still lands in the ledger).
      max_retries: transient-failure retries a pull / step before it
        escalates.
      backoff_base / backoff_max: capped exponential backoff,
        ``min(backoff_max, backoff_base * 2**(attempt-1))`` seconds.
      metrics: optional ``MetricsLogger``: fault events mirror into its
        ``summary()["faults"]``.
      membership: optional ``runtime.membership.MembershipTable``: every
        ledger event that names workers also records each worker's
        membership state at fault time, and ``supervised_fit`` handles
        ``QuorumLost`` against it.
      sleep: injectable sleep (tests pass a recorder; default
        ``time.sleep``).
    """

    def __init__(
        self,
        cfg,
        *,
        fault_budget: int | None = None,
        max_retries: int = 3,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        metrics=None,
        membership=None,
        sleep: Callable[[float], None] | None = None,
    ):
        if fault_budget is not None and fault_budget < 0:
            raise ValueError(f"fault_budget must be >= 0: {fault_budget}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0: {max_retries}")
        self.cfg = cfg
        self.fault_budget = fault_budget
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.metrics = metrics
        self.membership = membership
        self.ledger = FaultLedger()
        self.mask_feed = _MaskFeed()
        self._sleep = sleep if sleep is not None else time.sleep
        #: correlation id of the run this supervisor polices (set by
        #: ``supervised_fit``): every fault / retry / resume event lands on
        #: the run's trace
        self.trace_id = None

    # -- ledger --------------------------------------------------------------

    def record(self, kind: str, step: int | None = None, **detail) -> None:
        if self.membership is not None and "workers" in detail:
            # events that name workers carry each slot's membership state
            # at fault time and the live count: "NaN from a live worker"
            # and "lease expired mid-block" are different post-mortems
            detail.setdefault(
                "membership",
                {
                    int(w): self.membership.state(int(w))
                    for w in detail["workers"]
                },
            )
            detail.setdefault(
                "membership_live", self.membership.live_count()
            )
        ev = self.ledger.record(kind, step, **detail)
        if self.metrics is not None:
            self.metrics.fault(ev)
            from distributed_eigenspaces_tpu_torch.utils.telemetry import (
                tracer_of,
            )

            tracer_of(self.metrics).event(
                f"fault:{kind}", trace_id=self.trace_id,
                category="fault",
                attrs={
                    k: v
                    for k, v in {"step": step, **detail}.items()
                    if isinstance(v, (int, float, str, bool))
                },
            )
        if (
            self.fault_budget is not None
            and kind in BUDGET_KINDS
            and self.ledger.budget_spent > self.fault_budget
        ):
            raise SupervisorError(
                f"fault budget exhausted: {self.ledger.budget_spent} "
                f"fault units > budget {self.fault_budget}",
                self.ledger,
            )

    # -- detection loop 1: block quarantine ----------------------------------

    def screen_block(self, block, t: int, base_mask=None,
                     tenant: int | None = None):
        """Boundary check of one incoming block at step ``t``.

        Returns ``(block, mask)``, the (possibly repaired) block and its
        ``(m,)`` float32 survivor mask, or ``None`` for a round that cannot
        be salvaged (wrong geometry), dropped whole. ``base_mask`` folds an
        injected fault mask (``worker_masks=``) into the result; ``tenant``
        tags the ledger events with a fleet tenant's index. A numpy block
        is screened on the host, as the reference screens it; a tensor is
        screened where it lies (one device read on the card) and repaired
        there, in its dtype.
        """
        m = self.cfg.num_workers
        n, d = self.cfg.rows_per_worker, self.cfg.dim
        who = {} if tenant is None else {"tenant": tenant}
        tensor = isinstance(block, torch.Tensor)
        arr = block if tensor else np.asarray(block)
        mask = (
            np.ones(m, np.float32) if base_mask is None
            else np.array(base_mask, np.float32, copy=True)
        )
        if tuple(arr.shape) != (m, n, d):
            if arr.ndim == 3 and tuple(arr.shape[1:]) == (n, d) \
                    and 0 < arr.shape[0] < m:
                # short read: the trailing workers never arrived; pad them
                # with placeholder rows and drop them from the merge
                missing = list(range(arr.shape[0], m))
                got = int(arr.shape[0])
                if tensor:
                    padded = torch.empty((m, n, d), dtype=arr.dtype,
                                         device=arr.device)
                    padded[got:] = _placeholder_tensor(n, d, arr.dtype, arr.device)
                else:
                    padded = np.empty((m, n, d), arr.dtype)
                    padded[got:] = self._placeholder(n, d, arr.dtype)
                padded[:got] = arr
                mask[missing] = 0.0
                self.record(
                    "quarantine_short", t, workers=missing,
                    got_workers=got, **who,
                )
                arr = padded
            else:
                self.record(
                    "dropped_round", t, shape=list(arr.shape),
                    want=[m, n, d], **who,
                )
                return None
        if tensor:
            if arr.is_floating_point():
                finite = torch.isfinite(arr).flatten(1).all(dim=1).cpu().numpy()
                if not finite.all():
                    bad = [int(i) for i in np.nonzero(~finite)[0]]
                    arr = arr.clone()
                    arr[bad] = _placeholder_tensor(n, d, arr.dtype, arr.device)
                    mask[bad] = 0.0
                    self.record("quarantine_nonfinite", t, workers=bad, **who)
            return arr, mask
        if not np.issubdtype(arr.dtype, np.integer):
            check = (
                arr if arr.dtype in (np.float32, np.float64)
                else np.asarray(arr, np.float32)
            )
            finite = np.isfinite(check).all(axis=(1, 2))
            if not finite.all():
                bad = [int(i) for i in np.nonzero(~finite)[0]]
                arr = np.array(arr, copy=True)
                arr[bad] = self._placeholder(n, d, arr.dtype)
                mask[bad] = 0.0
                self.record("quarantine_nonfinite", t, workers=bad, **who)
        return arr, mask

    @staticmethod
    def _placeholder(n: int, d: int, dtype) -> np.ndarray:
        """Replacement rows for a quarantined worker's data. Not zeros: the
        masked merge weights the worker 0, but the worker's local solve
        still runs, and ``0 * NaN = NaN`` (a CholeskyQR of an all-zero
        block is NaN). Cycled identity rows give every solver a finite,
        well-conditioned dummy problem whose result the zero merge weight
        cancels exactly, so a quarantined round is bit for bit an explicit
        ``kill_workers`` round."""
        rows = np.zeros((n, d), np.float32)
        rows[np.arange(n), np.arange(n) % d] = 1.0
        return rows.astype(dtype, copy=False)

    def guard_stream(self, stream: Iterable, *, base_masks=None,
                     first_step: int = 1) -> _GuardedStream:
        """Wrap a raw block stream with pull retries and quarantine. The
        paired per-step masks arrive on ``self.mask_feed`` (pass it as
        ``worker_masks=`` to the trainer). ``base_masks`` may be an
        indexable ``(T, m)`` schedule (keyed by absolute step: resume
        safe) or a per-step mask iterator."""
        self.mask_feed = _MaskFeed()
        return _GuardedStream(self, stream, base_masks, first_step)

    # -- detection loop 2: retry with backoff --------------------------------

    def _retry(self, kind: str, what: str, t, fn, on_retry=None):
        """Run ``fn()``, retrying the transient failures (:data:`RETRYABLE`)
        with capped exponential backoff, one ``kind`` ledger event each;
        past ``max_retries`` escalate."""
        attempt = 0
        while True:
            try:
                return fn()
            except RETRYABLE as e:
                attempt += 1
                delay = min(
                    self.backoff_max,
                    self.backoff_base * (2.0 ** (attempt - 1)),
                )
                self.record(
                    kind, t, error=repr(e), attempt=attempt, backoff_s=delay,
                )
                if attempt > self.max_retries:
                    raise _Escalation(what, t, e) from e
                if on_retry is not None:
                    on_retry()
                if delay > 0:
                    self._sleep(delay)

    def _retry_pull(self, it, t: int):
        return self._retry("stream_retry", "stream pull", t, lambda: next(it))

    def step_hook(self, step_fn, state, x_blocks, t: int):
        """The per-step loop's hook (``algo/online._drive_stream``): one
        training step with transient failures retried under backoff. A
        retried step pulls its quarantine mask again, so the feed re-serves
        the same row."""
        return self._retry(
            "step_retry", "train step", t,
            lambda: step_fn(state, x_blocks),
            on_retry=self.mask_feed.arm_replay,
        )

    def run_guarded(self, what: str, fn: Callable, *args, step=None, **kw):
        """Retry wrapper for coarse work units (a whole-fit window, an
        extraction): the handle-level twin of :meth:`step_hook`."""
        return self._retry(f"{what}_retry", what, step, lambda: fn(*args, **kw))

    def wrap_handle(self, handle):
        """Supervise an ``api/runner.py`` whole-fit handle: its ``fit`` and
        ``fit_windows`` entries run under the retry / backoff policy
        (``make_whole_fit(..., supervisor=...)`` applies this)."""

        def wrap(fn, label):
            if fn is None:
                return None

            def run(*args, **kw):
                return self.run_guarded(label, fn, *args, **kw)

            return run

        return dataclasses.replace(
            handle,
            fit=wrap(handle.fit, "whole_fit"),
            fit_windows=wrap(handle.fit_windows, "fit_window"),
        )


def _placeholder_tensor(n: int, d: int, dtype, device) -> torch.Tensor:
    """:meth:`Supervisor._placeholder` as a tensor on ``device``."""
    rows = torch.zeros((n, d), dtype=torch.float32)
    rows[torch.arange(n), torch.arange(n) % d] = 1.0
    return rows.to(device=device, dtype=dtype)


# -- elastic membership -------------------------------------------------------


def _compose_base_masks(stream, worker_masks, first_step: int):
    """Fold an elastic stream's per-round membership masks
    (``ElasticStream.membership_masks``: membership AND arrived) into the
    injected ``worker_masks`` by multiplication: a dead worker is a
    persistent drop, a quarantined one a per-round drop, and the guarded
    stream sees one combined base mask a block. A plain stream passes
    ``worker_masks`` through untouched."""
    feed = getattr(stream, "membership_masks", None)
    if feed is None:
        return worker_masks
    mm_it = feed()
    if worker_masks is None:
        return mm_it
    indexable = hasattr(worker_masks, "__getitem__")
    wm_it = None if indexable else iter(worker_masks)

    def gen():
        idx = first_step - 1
        for m in mm_it:
            if indexable:
                w = worker_masks[idx] if idx < len(worker_masks) else None
            else:
                w = next(wm_it, None)
            idx += 1
            m = np.asarray(m, np.float32)
            yield m if w is None else m * np.asarray(w, np.float32)

    return gen()


# -- detection loop 3: auto-resume --------------------------------------------


def supervised_fit(
    stream_factory: Callable[[int], Iterable],
    cfg,
    *,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    resume: bool = True,
    trainer: str = "step",
    worker_masks=None,
    metrics=None,
    on_step=None,
    max_steps: Any = "auto",
    fault_budget: int | None = None,
    max_retries: int = 3,
    max_resumes: int = 2,
    backoff_base: float = 0.05,
    backoff_max: float = 2.0,
    sleep: Callable[[float], None] | None = None,
    supervisor: Supervisor | None = None,
    membership=None,
    quorum_wait_s: float | None = None,
    device="cuda",
    v0=None,
    v_init=None,
):
    """Run a fit under full supervision: quarantine, retry and resume.

    Args, as the reference's (its ``pool=`` aside: the port's per-step
    loop builds its own pool):
      stream_factory: ``(start_row) -> iterable`` of ``(m, n, d)`` blocks,
        called with the checkpoint cursor on each (re)start; wire it to
        ``block_stream(..., start_row=...)`` or ``bin_block_stream(...,
        start_row=...)`` so a resume reads only unseen rows.
      cfg: the ``PCAConfig``; any per-step backend rides through.
      checkpoint_dir: where the run commits resumable state
        (``utils.checkpoint.Checkpointer``). ``None`` disables auto-resume:
        escalations become a terminal ``SupervisorError``.
      checkpoint_every: steps between commits on the ``"step"`` trainer;
        the window size on ``"segmented"`` (one commit a window).
      resume: restore the newest committed checkpoint on entry (process
        restart recovery). ``False`` starts fresh.
      trainer: ``"step"`` (the per-step loop, any backend) or
        ``"segmented"`` (the dense windowed whole fit, killed and resumed
        bit for bit through its ``SegmentState`` warm carry).
      worker_masks: injected fault masks, folded into the quarantine
        masks: an indexable ``(T, m)`` schedule keyed by absolute step, or
        an iterator consumed per screened block.
      max_resumes: in-process auto-resumes before an escalation is
        terminal (a process restart gets the full allowance again).
      membership: a ``runtime.membership.MembershipTable`` for elastic
        runs (taken from the stream's ``table`` when omitted): ledger
        events gain per-worker membership states, and a ``QuorumLost``
        waits ``quorum_wait_s`` for quorum (rejoiners admitted during the
        wait), then resumes from the newest checkpoint, counted against
        ``max_resumes``. Quorum never restored, no checkpoint_dir or the
        budget spent: a terminal ``SupervisorError`` with the ledger.
      quorum_wait_s: bound of the quorum wait; ``None`` is ``max(1.0, 20 x
        heartbeat_timeout)`` of the table that lost quorum.
      device: where the fit runs (the card unless asked); a checkpoint
        restores onto it.
      v0, v_init: the cold start ``(d, k)`` and the crossover-merge start
        of the trainers (drawn from ``cfg.seed`` by default).

    Returns:
      ``(w, state, supervisor)``: the ``(d, k)`` estimate, the trainer's
      final state, and the supervisor (its ledger attached).
    """
    if trainer not in ("step", "segmented"):
        raise ValueError(
            f"supervised_fit trainer must be 'step' or 'segmented', "
            f"got {trainer!r}"
        )
    if getattr(cfg, "pipeline_merge", False):
        # the pipelined carry (pending worker factors) is no checkpointable
        # state, so killed-and-resumed == unkilled could not hold
        raise ValueError(
            "supervised runs do not support pipeline_merge (the "
            "pipelined carry is not checkpointable; use merge_interval "
            "for a resume-safe steady-state win)"
        )
    sup = supervisor or Supervisor(
        cfg,
        fault_budget=fault_budget,
        max_retries=max_retries,
        backoff_base=backoff_base,
        backoff_max=backoff_max,
        metrics=metrics,
        membership=membership,
        sleep=sleep,
    )
    if membership is not None and sup.membership is None:
        sup.membership = membership
    from distributed_eigenspaces_tpu_torch.utils.telemetry import tracer_of

    tr = tracer_of(metrics)
    sup.trace_id = tr.new_trace("fit")
    if metrics is not None and getattr(metrics, "_fit_trace", None) is None:
        # per-step spans (MetricsLogger.on_step) join the supervisor's
        # fault / retry / resume events on one trace
        metrics._fit_trace = sup.trace_id
    rows_per_step = cfg.num_workers * cfg.rows_per_worker

    ckpt = None
    state, cursor = None, 0
    if checkpoint_dir is not None:
        from distributed_eigenspaces_tpu_torch.utils.checkpoint import (
            Checkpointer,
        )

        ckpt = Checkpointer(
            checkpoint_dir,
            every=1 if trainer == "segmented" else checkpoint_every,
            rows_per_step=rows_per_step,
            device=device,
        )
        if resume:
            latest = ckpt.latest()
            if latest is not None:
                state, cursor = latest
                sup.record(
                    "resume", int(state.step), cursor=int(cursor),
                    reason="restart",
                )

    resumes = 0
    t_run0 = time.perf_counter()
    try:
        while True:
            try:
                if trainer == "segmented":
                    return (*_segmented_supervised(
                        sup, stream_factory, cfg, state, cursor, ckpt,
                        metrics, worker_masks, on_step,
                        segment=checkpoint_every, device=device, v0=v0,
                        v_init=v_init,
                    ), sup)
                return (*_step_supervised(
                    sup, stream_factory, cfg, state, cursor, ckpt, metrics,
                    worker_masks, on_step, max_steps, device=device, v0=v0,
                ), sup)
            except _Escalation as esc:
                if ckpt is None:
                    raise SupervisorError(
                        f"{esc} — no checkpoint_dir, cannot auto-resume",
                        sup.ledger,
                    ) from esc.cause
                if resumes >= max_resumes:
                    raise SupervisorError(
                        f"{esc} — {resumes} auto-resumes exhausted",
                        sup.ledger,
                    ) from esc.cause
                resumes += 1
                latest = ckpt.latest()
                state, cursor = latest if latest is not None else (None, 0)
                sup.record(
                    "resume",
                    int(state.step) if state is not None else 0,
                    cursor=int(cursor), reason=str(esc), attempt=resumes,
                )
            except QuorumLost as ql:
                # detection loop 4: a loud quorum loss waits (bounded) for
                # quorum to return, then resumes under the same budget as
                # any escalation. A tier's quorum loss carries its tier
                # table, which never becomes the per-worker annotator.
                tier = getattr(ql, "tier", None)
                if sup.membership is None and tier is None:
                    sup.membership = ql.table
                sup.record(
                    "quorum_lost", ql.step, live=ql.live,
                    frac=round(ql.frac, 4), required=ql.required,
                    **({"tier": tier} if tier is not None else {}),
                )
                if ckpt is None:
                    raise SupervisorError(
                        f"{ql} — no checkpoint_dir, cannot auto-resume",
                        sup.ledger,
                    ) from ql
                if resumes >= max_resumes:
                    raise SupervisorError(
                        f"{ql} — {resumes} auto-resumes exhausted",
                        sup.ledger,
                    ) from ql
                wait_s = (
                    quorum_wait_s if quorum_wait_s is not None
                    else max(1.0, 20.0 * ql.table.heartbeat_timeout_s)
                )
                if not ql.table.wait_for_quorum(wait_s):
                    raise SupervisorError(
                        f"quorum not restored within {wait_s:.1f}s "
                        f"after {ql}",
                        sup.ledger,
                    ) from ql
                sup.record(
                    "quorum_restored", None,
                    live=ql.table.live_count(),
                    frac=round(ql.table.live_frac(), 4),
                    **({"tier": tier} if tier is not None else {}),
                )
                resumes += 1
                latest = ckpt.latest()
                state, cursor = latest if latest is not None else (None, 0)
                sup.record(
                    "resume",
                    int(state.step) if state is not None else 0,
                    cursor=int(cursor), reason="quorum_restored",
                    attempt=resumes,
                )
    finally:
        # the whole supervised run (resumes included) as one span on the
        # fit's trace, through success and terminal error alike
        tr.record_span(
            "supervised_fit", t_run0, time.perf_counter(),
            trace_id=sup.trace_id, category="fit",
            attrs={"trainer": trainer, "resumes": resumes,
                   "faults": len(sup.ledger.events)},
        )


def _step_supervised(sup, stream_factory, cfg, state, cursor, ckpt, metrics,
                     worker_masks, on_step, max_steps, *, device, v0):
    """The per-step fit (``online_distributed_pca``, dense backends and the
    feature-sharded step loop) under supervision."""
    from distributed_eigenspaces_tpu_torch.algo.online import (
        online_distributed_pca,
    )

    ingest = None
    if metrics is not None and cfg.prefetch_depth > 0:
        # ingest-bound or compute-bound, from the run report: the prefetch
        # queue's stall / occupancy counters ride into summary()["ingest"]
        from distributed_eigenspaces_tpu_torch.runtime.prefetch import (
            PrefetchStats,
        )

        ingest = PrefetchStats()
        metrics.attach_ingest(ingest)

    done = int(state.step) if state is not None else 0
    raw = stream_factory(cursor)
    if sup.membership is None:
        # an elastic stream carries its table
        sup.membership = getattr(raw, "table", None)
    guarded = sup.guard_stream(
        raw,
        base_masks=_compose_base_masks(raw, worker_masks, done + 1),
        first_step=done + 1,
    )
    callbacks = []
    if metrics is not None:
        callbacks.append(metrics.on_step)
    if on_step is not None:
        callbacks.append(on_step)
    if ckpt is not None:
        callbacks.append(ckpt.on_step)  # last: commit after the observers

    def cb(t, st, v_bar):
        for c in callbacks:
            c(t, st, v_bar)

    return online_distributed_pca(
        guarded,
        cfg,
        device=device,
        state=state,
        on_step=cb if callbacks else None,
        worker_masks=sup.mask_feed,
        max_steps=max_steps,
        v0=v0,
        step_hook=sup.step_hook,
        ingest_stats=ingest,
    )


def _segmented_supervised(sup, stream_factory, cfg, state, cursor, ckpt,
                          metrics, worker_masks, on_step, segment, *, device,
                          v0, v_init):
    """The dense windowed whole fit (``api/runner.py``'s ``"segmented"``
    handle) under supervision: windows of ``segment`` steps run masked, a
    committed checkpoint a window, retries a window at a time.
    ``SegmentState`` carries the warm basis, so a killed-and-resumed run
    is the unkilled one bit for bit."""
    import itertools

    from distributed_eigenspaces_tpu_torch.api.estimator import _scan_mesh
    from distributed_eigenspaces_tpu_torch.api.runner import make_whole_fit
    from distributed_eigenspaces_tpu_torch.data.bin_stream import window_stream

    handle = make_whole_fit(
        cfg, "segmented", _scan_mesh(cfg, device), segment=segment,
        device=device, v0=v0, v_init=v_init, supervisor=sup,
    )
    if state is None:
        state = handle.init_state()
    done = int(state.step)
    remaining = max(0, cfg.num_steps - done)
    if remaining:
        raw = stream_factory(cursor)
        if sup.membership is None:
            sup.membership = getattr(raw, "table", None)
        guarded = sup.guard_stream(
            raw,
            base_masks=_compose_base_masks(raw, worker_masks, done + 1),
            first_step=done + 1,
        )
        try:
            windows = window_stream(
                itertools.islice(guarded, remaining), segment
            )
            for w in windows:
                masks = np.stack(
                    [next(sup.mask_feed) for _ in range(w.shape[0])]
                )
                # one retried unit a window (wrap_handle)
                state = handle.fit_windows(
                    state, [w], worker_masks=[masks]
                )
                t = int(state.step)
                if metrics is not None:
                    metrics.on_step(t, state, state.v_prev)
                if on_step is not None:
                    on_step(t, state, state.v_prev)
                if ckpt is not None:
                    ckpt.on_step(t, state)
        finally:
            guarded.close()
    w = sup.run_guarded("extract", handle.extract, state)
    return w, state
