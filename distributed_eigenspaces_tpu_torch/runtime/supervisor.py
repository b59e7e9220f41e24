"""Supervision of the serve lanes: fault ledger, circuit breaker, watchdog.

The port's copy of the serving half of ``distributed_eigenspaces_tpu/
runtime/supervisor.py``: :class:`FaultLedger`, :class:`SupervisorError`,
:class:`BreakerOpen`, :class:`CircuitBreaker` and :class:`LaneWatchdog`,
which ``runtime/scheduler.py`` and ``serving/server.py`` use. The
training-side ``Supervisor`` and ``supervised_fit`` (block quarantine,
retries, auto-resume on ``runtime.membership.QuorumLost``) are not ported
yet (ROADMAP.md Queue 1 item 16).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import torch

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
    """Exception classes the supervisor treats as transient: host IO plus
    the device-side failures the installed torch raises (out of memory,
    and ``torch.AcceleratorError`` where this torch has it)."""
    kinds: list[type] = [OSError, torch.cuda.OutOfMemoryError]
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



def _not_ported(name: str):
    raise NotImplementedError(
        f"{name} is not ported to distributed_eigenspaces_tpu_torch yet "
        "(ROADMAP.md Queue 1 item 16, runtime/supervisor.py)"
    )


class Supervisor:
    """The reference's fit supervisor: not ported yet."""

    def __init__(self, *args, **kwargs):
        _not_ported("Supervisor")


def supervised_fit(*args, **kwargs):
    """The reference's supervised fit: not ported yet."""
    _not_ported("supervised_fit")
