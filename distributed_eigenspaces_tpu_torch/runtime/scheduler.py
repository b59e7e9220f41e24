"""Dynamic work-queue scheduler — the reference master's job, done right.

The reference scheduler (``MasterNode``, ``distributed.py:82-143``) is a
dynamic dispatcher: split rows into batches, keep 5 requests in flight
(hardcoded — crashes when ``--batches < 5``), on each
result pop the next batch LIFO (``distributed.py:132-137``), track completion
in a set (crashes on duplicate replies, B5), and merge when the set empties
(then discard the result and hang, B4). Its fault tolerance is AMQP
at-least-once redelivery with no timeout or liveness (``distributed.py:53``,
§5.3).

On a TPU mesh the *device-side* schedule is static (the merge is a
permutation-invariant average, so static == dynamic semantically — tested in
tests/test_worker_pool.py), but the *host side* still wants a real scheduler:
block preparation (disk IO, decode, augmentation) runs on fallible,
variable-latency host lanes while the device consumes results. This module
is that scheduler, with the reference's failure modes fixed:

- prefetch depth configurable and clamped to the task count (no B5 crash);
- completion tracking is idempotent — duplicate results are dropped, not
  ``KeyError`` crashes;
- at-least-once is implemented with *lease timeouts*: a task leased to a
  lane that dies or stalls is re-queued after ``lease_timeout`` seconds
  (the liveness logic the reference lacks), up to ``max_retries``;
- the result is actually returned (B4 fix).

The port's copy of ``distributed_eigenspaces_tpu/runtime/scheduler.py``:
the queues as they are, and :func:`run_dynamic_round`, the master's
end-to-end one-shot round on top of them, whose batch Grams go through the
port's Gram kernel on the card.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Sequence

from distributed_eigenspaces_tpu_torch.utils.faults import KillSwitch


@dataclasses.dataclass
class TaskRecord:
    """Bookkeeping for one schedulable unit (one reference 'batch')."""

    task_id: int
    payload: Any
    attempts: int = 0
    done: bool = False
    result: Any = None
    last_exc: Exception | None = None
    #: isolation mode only: this task exhausted its retries and was
    #: failed ALONE (the queue kept serving everyone else)
    failed: bool = False


class SchedulerError(RuntimeError):
    pass


class QueueClosed(SchedulerError):
    """Admission after close(): the task would be unreachable to
    already-exiting lanes. Server frontends (``serving/server.py
    QueryServer``, ``parallel/fleet.py FleetServer``) translate this to
    their documented ``ServerClosed`` error at the API boundary."""


class QueueFull(SchedulerError):
    """Bounded admission refused a new task: ``max_depth`` requests are
    already in flight. The load-shedding signal — reject-NEWEST, so
    requests already queued keep their latency budget instead of
    everyone's p99 growing without bound. Server frontends translate
    this to ``ServerOverloaded``."""


class WorkQueue:
    """Dynamic dispatcher with lease-based failure detection.

    ``order="lifo"`` matches the reference's ``list.pop()`` dispatch
    (``distributed.py:137``); ``"fifo"`` is the sane default.
    """

    def __init__(
        self,
        payloads: Sequence[Any] = (),
        *,
        prefetch_depth: int = 5,
        order: str = "fifo",
        max_retries: int = 3,
        lease_timeout: float | None = None,
        open_ended: bool = False,
        isolate_failures: bool = False,
    ):
        if order not in ("fifo", "lifo"):
            raise ValueError(f"unknown order: {order!r}")
        if prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        self.records = [
            TaskRecord(task_id=i, payload=p) for i, p in enumerate(payloads)
        ]
        # reference seeds exactly min(5, ...) — here depth is clamped, so
        # fewer tasks than the prefetch depth is fine (B5 fix). An
        # open-ended queue can't clamp to a count it doesn't know yet.
        self.prefetch_depth = (
            prefetch_depth if open_ended
            else min(prefetch_depth, max(len(self.records), 1))
        )
        self.order = order
        self.max_retries = max_retries
        self.lease_timeout = lease_timeout
        # failure-isolation mode (the serving tier's choice): a task
        # that exhausts its retries is failed ALONE — marked done with
        # ``failed=True`` and reported through ``on_terminal`` — instead
        # of poisoning the whole queue. The default (False) keeps the
        # pre-existing fail-fast semantics: one terminal task aborts the
        # run (the right call for a one-shot round, fatal for a server).
        self.isolate_failures = isolate_failures
        #: isolation-mode callback ``(record, exc)`` invoked under the
        #: queue lock when a task terminally fails — must be cheap and
        #: must not re-enter the queue (ShapeBucketQueue fails the
        #: bucket's tickets here, which is a plain Event.set per ticket)
        self.on_terminal: Callable[[TaskRecord, Exception], None] | None = None
        self._lock = threading.Condition()
        self._pending: list[int] = list(range(len(self.records)))
        # task_id -> (lease deadline, attempt number that holds the lease)
        self._leases: dict[int, tuple[float, int]] = {}
        self._failed: Exception | None = None
        # open-ended queues accept add_task() until close(); a static
        # queue is born closed, so every pre-existing behavior — acquire
        # returning None the moment all seeded tasks complete — is
        # untouched (the fleet admission path is the open-ended consumer)
        self._closed = not open_ended

    def add_task(self, payload: Any) -> int:
        """Append one task to an open-ended queue (admission path);
        returns its task id. Raises on a closed queue — a task fed after
        close() would be silently unreachable to already-exiting lanes."""
        with self._lock:
            if self._closed:
                raise QueueClosed("add_task on a closed WorkQueue")
            rec = TaskRecord(task_id=len(self.records), payload=payload)
            self.records.append(rec)
            self._pending.append(rec.task_id)
            self._lock.notify_all()
            return rec.task_id

    def close(self) -> None:
        """No more add_task(): once the current tasks complete, acquire
        returns None and run() lanes exit. Idempotent."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    # -- lane-facing API -----------------------------------------------------

    def acquire(self) -> TaskRecord | None:
        """Lease the next task; None when everything is complete.

        Returns a *snapshot* of the record (``attempts`` identifies this
        lane's lease — pass it back to :meth:`fail` so a stale attempt
        can't disturb a newer lease on the same task).
        """
        with self._lock:
            while True:
                if self._failed is not None:
                    raise self._failed
                self._expire_leases_locked()
                if self._closed and self._all_done_locked():
                    self._lock.notify_all()
                    return None
                if self._pending:
                    idx = (
                        self._pending.pop()
                        if self.order == "lifo"
                        else self._pending.pop(0)
                    )
                    rec = self.records[idx]
                    if rec.done:
                        continue  # completed while queued for retry
                    rec.attempts += 1
                    if self.lease_timeout is not None:
                        self._leases[idx] = (
                            time.monotonic() + self.lease_timeout,
                            rec.attempts,
                        )
                    return dataclasses.replace(rec)
                # nothing pending but tasks are leased out — wait for a
                # completion, a lease expiry, or failure
                timeout = self._next_wakeup_locked()
                self._lock.wait(timeout)

    def complete(self, task_id: int, result: Any) -> bool:
        """Record a result. Idempotent: a duplicate completion (the
        at-least-once case that crashes the reference with ``KeyError``,
        ``distributed.py:124``) is dropped and returns False."""
        with self._lock:
            rec = self.records[task_id]
            if rec.done:
                return False
            rec.done = True
            rec.result = result
            self._leases.pop(task_id, None)
            self._lock.notify_all()
            return True

    def fail(
        self, task_id: int, exc: Exception, attempt: int | None = None
    ) -> bool:
        """Report a lane failure; the task is re-queued (at-least-once)
        unless its retry budget is exhausted. Returns True when the
        failure was TERMINAL for the task.

        ``attempt`` (from the :meth:`acquire` snapshot's ``attempts``)
        scopes the failure to this lane's lease: if the lease already
        expired and the task was re-leased by another lane, a stale
        failure neither pops the live lease nor double-queues the task.
        """
        with self._lock:
            rec = self.records[task_id]
            lease = self._leases.get(task_id)
            if attempt is not None and lease is not None and lease[1] != attempt:
                return False  # stale: a newer attempt owns this task now
            self._leases.pop(task_id, None)
            rec.last_exc = exc
            if rec.done:
                return False
            if rec.attempts > self.max_retries:
                term = SchedulerError(
                    f"task {task_id} failed after {rec.attempts} attempts"
                )
                term.__cause__ = exc
                if self.isolate_failures:
                    self._terminal_locked(rec, term)
                else:
                    self._failed = term
                self._lock.notify_all()
                return True
            elif rec.task_id not in self._pending:
                self._pending.append(rec.task_id)
            self._lock.notify_all()
            return False

    def _terminal_locked(self, rec: TaskRecord, exc: Exception) -> None:
        """Isolation mode: retire ONE task as failed-done (the queue
        keeps serving) and hand its waiters the cause via
        ``on_terminal``."""
        rec.done = True
        rec.failed = True
        rec.last_exc = exc
        if self.on_terminal is not None:
            self.on_terminal(rec, exc)

    # -- internals -----------------------------------------------------------

    def _all_done_locked(self) -> bool:
        return all(r.done for r in self.records)

    def _expire_leases_locked(self) -> None:
        if self.lease_timeout is None:
            return
        now = time.monotonic()
        expired = [
            tid for tid, (dl, _) in self._leases.items() if dl <= now
        ]
        for tid in expired:
            del self._leases[tid]
            rec = self.records[tid]
            if not rec.done:
                if rec.attempts > self.max_retries:
                    term = SchedulerError(
                        f"task {tid} leased {rec.attempts} times with no "
                        f"result (lease_timeout={self.lease_timeout}s)"
                    )
                    term.__cause__ = rec.last_exc
                    if self.isolate_failures:
                        self._terminal_locked(rec, term)
                    else:
                        self._failed = term
                elif tid not in self._pending:
                    self._pending.append(tid)  # requeue: liveness recovery

    def _next_wakeup_locked(self) -> float | None:
        if self.lease_timeout is None or not self._leases:
            return None
        soonest = min(dl for dl, _ in self._leases.values())
        return max(0.0, soonest - time.monotonic()) + 1e-3

    # -- run loop ------------------------------------------------------------

    def run(
        self,
        worker_fn: Callable[[Any], Any],
        *,
        num_lanes: int = 1,
        on_result: Callable[[int, Any], None] | None = None,
    ) -> list[Any]:
        """Drain the queue with ``num_lanes`` host threads calling
        ``worker_fn(payload)``; returns results in task order.

        ``prefetch_depth`` bounds how many tasks are in flight at once
        (lanes beyond the depth idle), mirroring the reference's in-flight
        window (``distributed.py:108-112``) without its crash.
        """
        lanes = min(num_lanes, self.prefetch_depth)
        errors: list[Exception] = []

        def lane():
            while True:
                try:
                    rec = self.acquire()
                except Exception as e:  # scheduler-level failure
                    errors.append(e)
                    return
                if rec is None:
                    return
                try:
                    out = worker_fn(rec.payload)
                except KillSwitch as e:
                    # hard lane death (chaos-harness SIGKILL semantics):
                    # the lane dies WITHOUT failing its task — exactly
                    # what a real killed thread does — so the task stays
                    # leased and lease expiry re-queues it for the
                    # supervisor-restarted lane (liveness, not loss)
                    errors.append(e)
                    return
                except Exception as e:
                    self.fail(rec.task_id, e, attempt=rec.attempts)
                    continue
                if self.complete(rec.task_id, out) and on_result:
                    try:
                        on_result(rec.task_id, out)
                    except Exception as e:
                        # a broken result-fold poisons the whole run: the
                        # task IS complete (idempotent), so retrying can't
                        # help — surface the error instead of letting the
                        # lane die silently with partial results
                        errors.append(e)
                        return

        threads = [
            threading.Thread(target=lane, daemon=True) for _ in range(lanes)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return [r.result for r in self.records]


class FleetTicket:
    """One admitted fit request: resolves to its per-tenant result (or
    the dispatch error) once the bucket it rode in has executed."""

    def __init__(self, signature, payload: Any, tenant: Any = None):
        self.signature = signature
        self.payload = payload
        #: fairness key (continuous batching): batch assembly draws
        #: round-robin over tenant ids, so one flooding tenant cannot
        #: starve the others out of a batch. None = anonymous (all
        #: anonymous tickets share one fairness slot).
        self.tenant = tenant
        #: admission stamp (``time.perf_counter``) — the telemetry
        #: layer's queue-wait anchor: dispatch lanes subtract it to
        #: decompose request latency (docs/OBSERVABILITY.md)
        self.t_submit = time.perf_counter()
        self._event = threading.Event()
        self._result: Any = None
        self._error: Exception | None = None
        #: admission bookkeeping hook (set by ShapeBucketQueue when
        #: bounded admission is on): fires exactly once, at the FIRST
        #: resolve/fail, so the in-flight depth count stays honest even
        #: when a rejected slot is later back-filled by the batch fold
        self._on_done: Callable[["FleetTicket"], None] | None = None

    def _done_once(self) -> None:
        cb, self._on_done = self._on_done, None
        if cb is not None:
            cb(self)

    def resolve(self, result: Any) -> None:
        self._result = result
        self._event.set()
        self._done_once()

    def fail(self, exc: Exception) -> None:
        self._error = exc
        self._event.set()
        self._done_once()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("fleet ticket not resolved in time")
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class Bucket:
    """One dispatch unit of the fleet admission queue: up to
    ``bucket_size`` same-signature tickets, executed as ONE batched
    program (``parallel/fleet.py`` stacks them along the fleet axis)."""

    signature: Any
    tickets: list[FleetTicket]
    #: flush stamp (``time.perf_counter``, set by the admission queue
    #: when the bucket dispatches into the work queue): splits a
    #: request's queue wait into bucket-fill wait (t_submit →
    #: t_dispatch) vs lane wait (t_dispatch → execution start)
    t_dispatch: float | None = None

    def __len__(self) -> int:
        return len(self.tickets)


class ShapeBucketQueue:
    """Shape-bucketed admission over an open-ended :class:`WorkQueue`.

    The fleet serving layer's front door: requests accumulate
    into EXACT-signature buckets — the signature is whatever hashable
    key the caller derives from the problem shape, canonically
    ``(d, k, m, n, T)`` plus the solver config (``parallel/fleet.py
    fleet_signature``) — and a bucket dispatches into the work queue
    when it is FULL (``bucket_size`` requests: maximal dispatch
    amortization) or when its OLDEST request has waited
    ``flush_deadline`` seconds (no starvation for low-traffic shapes).
    Dispatch itself rides the existing WorkQueue machinery, so the
    lease-timeout liveness, bounded retries, and idempotent completion
    the scheduler already guarantees apply unchanged to bucket
    execution — a crashed dispatch lane's bucket is re-leased, not lost.

    A deadline timer thread owns the flush clock; tests that want
    determinism call :meth:`flush_expired` with an explicit ``now``
    instead (the timer is harmless alongside — flushing is idempotent
    under the lock).

    **Continuous batching** (``continuous=True``): instead of
    holding a bucket until it is FULL or its deadline expires, a request
    is admitted into the *next in-flight batch*. The admission state
    machine per signature:

    - a dispatch lane with free budget (``serve(num_lanes=...)`` sets
      the budget) dispatches the pending pool IMMEDIATELY on submit —
      at sub-saturation rates a request never waits a flush window;
    - while every lane is busy, submissions POOL; the moment a batch
      completes, the freed lane assembles the next batch from the pool
      (up to ``bucket_size`` tickets) and dispatches it — a lane never
      idles while work is queued;
    - batch assembly draws ROUND-ROBIN over tenant ids
      (``submit(..., tenant=...)``) with a rotating start cursor, so an
      adversarial single-tenant flood gets at most its fair share of
      each batch while other tenants keep landing;
    - the deadline timer is retained as a liveness BACKSTOP: a pooled
      request's worst case is one flush window, exactly the old path's
      bound (and ``flush_deadline == 0`` still dispatches every submit
      immediately).

    The shed/breaker/close machinery is unchanged and layered identically
    in both modes; with ``continuous=False`` (default) the dispatch
    behavior is byte-identical to the bucket-full-or-deadline path
    (pinned in tests/test_scheduler.py).

    **Follower mode** (``follower=True``, the port's own; the mesh
    ``FleetServer``'s ranks other than 0): admission runs as above, the
    depth and breaker gates included, but nothing dispatches here: no full
    bucket, no timer, no continuous batch, no flush on close. The tickets
    wait in their buckets until the owner, told what rank 0's queue cut,
    runs them and takes them out (:meth:`withdraw`).
    """

    def __init__(
        self,
        *,
        bucket_size: int,
        flush_deadline: float,
        order: str = "fifo",
        max_retries: int = 3,
        lease_timeout: float | None = None,
        prefetch_depth: int = 5,
        start_timer: bool = True,
        max_depth: int | None = None,
        isolate_failures: bool = False,
        breaker_threshold: int | None = None,
        breaker_cooldown_s: float = 1.0,
        on_event: Callable[[str, dict], None] | None = None,
        continuous: bool = False,
        follower: bool = False,
    ):
        if bucket_size < 1:
            raise ValueError(f"bucket_size must be >= 1: {bucket_size}")
        if flush_deadline < 0:
            raise ValueError(
                f"flush_deadline must be >= 0: {flush_deadline}"
            )
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1: {max_depth}")
        self.bucket_size = bucket_size
        self.flush_deadline = flush_deadline
        self.wq = WorkQueue(
            (),
            prefetch_depth=prefetch_depth,
            order=order,
            max_retries=max_retries,
            lease_timeout=lease_timeout,
            open_ended=True,
            isolate_failures=isolate_failures,
        )
        if isolate_failures:
            # a bucket that exhausts its retries fails ITS tickets and
            # feeds its signature's breaker; the queue keeps serving
            # every other bucket (the per-signature isolation the
            # serving tier needs — the fail-fast default would abort
            # the whole dispatch loop on one poisoned signature)
            self.wq.on_terminal = self._bucket_terminal
        #: bounded admission: max un-resolved tickets in the system
        #: (queued + dispatched); None = unbounded (pre-existing
        #: behavior). Excess submissions shed via QueueFull.
        self.max_depth = max_depth
        self._inflight = 0
        #: load-shed counters by reason (the health report's feed)
        self.sheds = {"overload": 0, "breaker": 0}
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        #: per-signature circuit breakers (lazy; only with a threshold)
        self.breakers: dict[Any, Any] = {}
        #: optional event sink ``(kind, detail)`` — shed / breaker
        #: transitions, wired by the serving tier into MetricsLogger
        self.on_event = on_event
        self._lock = threading.Condition()
        self._buckets: dict[Any, list[FleetTicket]] = {}
        self._deadlines: dict[Any, float] = {}
        #: continuous-batching state (all untouched when continuous is
        #: False): the in-flight batch budget tracks dispatch lanes —
        #: serve() sets it to num_lanes — and the RR cursor rotates the
        #: tenant a batch assembly starts from, per signature
        self.continuous = continuous
        self._lane_budget = 1
        self._inflight_batches = 0
        self._rr: dict[Any, int] = {}
        self._closed = False
        self.follower = follower
        self._timer: threading.Thread | None = None
        if start_timer and flush_deadline > 0 and not follower:
            self._timer = threading.Thread(
                target=self._timer_loop, daemon=True
            )
            self._timer.start()

    # -- resilience plumbing -------------------------------------------------

    @property
    def inflight(self) -> int:
        """Un-resolved tickets currently in the system (the bounded
        admission's depth gauge)."""
        with self._lock:
            return self._inflight

    def _ticket_done(self, _ticket) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            self._lock.notify_all()

    def _emit(self, kind: str, detail: dict) -> None:
        cb = self.on_event
        if cb is not None:
            try:
                cb(kind, detail)
            except Exception:
                pass  # telemetry must never take down admission

    def breaker_for(self, signature):
        """The signature's breaker (created on first use), or None when
        breakers are disabled."""
        if self.breaker_threshold is None:
            return None
        with self._lock:
            br = self.breakers.get(signature)
            if br is None:
                from distributed_eigenspaces_tpu_torch.runtime.supervisor import (
                    CircuitBreaker,
                )

                br = self.breakers[signature] = CircuitBreaker(
                    threshold=self.breaker_threshold,
                    cooldown_s=self.breaker_cooldown_s,
                )
            return br

    def _bucket_terminal(self, rec: TaskRecord, exc: Exception) -> None:
        """Isolation-mode terminal failure of ONE bucket: fail its
        tickets with the cause (Event.set per ticket — safe under the
        work-queue lock) so waiters unblock loudly while every other
        signature keeps serving."""
        bucket = rec.payload
        if isinstance(bucket, Bucket):
            for t in bucket.tickets:
                if not t.done():
                    t.fail(exc)

    # -- admission -----------------------------------------------------------

    def submit(
        self, signature: Any, payload: Any, *, tenant: Any = None
    ) -> FleetTicket:
        """Admit one request; returns its ticket. A full bucket
        dispatches immediately; ``flush_deadline == 0`` dispatches every
        submission immediately (padded solo serving). In continuous mode
        the request instead joins the next in-flight batch (see the
        class docstring); ``tenant`` is its fairness key.

        Resilience gates (both opt-in, both REJECT-NEWEST): a signature
        whose circuit breaker is open fast-fails with
        :class:`~..runtime.supervisor.BreakerOpen`; with ``max_depth``
        set, admission past the depth sheds with :class:`QueueFull` —
        the queue never grows without bound under an overload burst.
        """
        br = self.breaker_for(signature)
        if br is not None and not br.allow():
            with self._lock:
                self.sheds["breaker"] += 1
            self._emit("shed", {
                "reason": "breaker", "signature": signature,
                "breaker": br.snapshot(),
            })
            from distributed_eigenspaces_tpu_torch.runtime.supervisor import (
                BreakerOpen,
            )

            snap = br.snapshot()
            raise BreakerOpen(
                f"signature {signature!r} is fast-failing: its circuit "
                f"breaker is {snap['state']} after "
                f"{snap['consecutive_failures']} consecutive dispatch "
                f"failures (threshold {br.threshold}; last error: "
                f"{snap.get('last_error')}); other signatures keep "
                "serving — a half-open probe retries in "
                f"{snap.get('retry_in_s', 0.0)}s",
                br,
            )
        ticket = FleetTicket(signature, payload, tenant=tenant)
        with self._lock:
            if self._closed:
                raise QueueClosed("submit on a closed ShapeBucketQueue")
            if (
                self.max_depth is not None
                and self._inflight >= self.max_depth
            ):
                self.sheds["overload"] += 1
                depth = self._inflight
                self._emit("shed", {
                    "reason": "overload", "signature": signature,
                    "inflight": depth, "max_depth": self.max_depth,
                })
                raise QueueFull(
                    f"admission shed: {depth} requests already in "
                    f"flight >= max_depth {self.max_depth} "
                    "(reject-newest load shedding — retry with backoff)"
                )
            if self.max_depth is not None:
                ticket._on_done = self._ticket_done
                self._inflight += 1
            pending = self._buckets.setdefault(signature, [])
            if not pending:
                self._deadlines[signature] = (
                    time.monotonic() + self.flush_deadline
                )
            pending.append(ticket)
            if self.follower:
                pass  # the owner dispatches what rank 0 cuts
            elif self.continuous:
                # dispatch into a free lane immediately; while every
                # lane is busy, POOL (the completion hook assembles the
                # next batch) — except flush_deadline == 0, which keeps
                # its dispatch-every-submit contract
                if (
                    self._inflight_batches < self._lane_budget
                    or self.flush_deadline == 0
                ):
                    self._flush_locked(signature)
            elif (
                len(pending) >= self.bucket_size
                or self.flush_deadline == 0
            ):
                self._flush_locked(signature)
            self._lock.notify_all()
        return ticket

    def pending_signatures(self) -> list:
        """Signatures with an un-dispatched bucket right now — the
        prewarm feed (``runtime/prewarm.py``): shapes traffic is
        ALREADY queuing for are exactly the shapes worth compiling off
        the dispatch thread before their bucket flushes."""
        with self._lock:
            return list(self._buckets)

    def flush_expired(self, now: float | None = None) -> int:
        """Dispatch every bucket whose oldest request has waited past
        the deadline; returns how many buckets ACTUALLY dispatched (not
        how many deadlines looked expired — a sweep racing another flush
        must not count a bucket twice). The timer
        thread calls this; tests may call it directly with a synthetic
        ``now``; repeated calls with the same ``now`` are idempotent."""
        if now is None:
            now = time.monotonic()
        if self.follower:
            return 0
        with self._lock:
            expired = [
                sig for sig, dl in self._deadlines.items() if dl <= now
            ]
            return sum(
                1 for sig in expired if self._flush_locked(sig)
            )

    def flush_all(self) -> None:
        """Dispatch every partially-full bucket now (close path)."""
        with self._lock:
            self._drain_locked()

    def close(self) -> None:
        """Flush remaining buckets and close the work queue: serve()
        lanes drain what is queued and exit. Idempotent."""
        with self._lock:
            self._closed = True
            self._drain_locked()
            self._lock.notify_all()
        self.wq.close()

    def _drain_locked(self) -> None:
        if self.follower:
            return  # a follower's tickets wait for rank 0's rounds
        # continuous assembly caps a dispatch at bucket_size, so a
        # pooled signature may need several flushes to empty
        for sig in list(self._buckets):
            while sig in self._buckets:
                if not self._flush_locked(sig):
                    break

    def withdraw(self, tickets) -> None:
        """Take ``tickets`` out of their pending buckets (a follower's
        owner, once it has run or failed them)."""
        gone = set(map(id, tickets))
        with self._lock:
            for sig in list(self._buckets):
                left = [t for t in self._buckets[sig] if id(t) not in gone]
                if left:
                    self._buckets[sig] = left
                else:
                    del self._buckets[sig]
                    self._deadlines.pop(sig, None)
            self._lock.notify_all()

    def add_control(self, payload) -> None:
        """Hand the dispatch lanes a task that is not a bucket of this
        queue (a mesh ``FleetServer``'s shed notice), counted as a batch in
        flight like a flushed bucket."""
        with self._lock:
            self._inflight_batches += 1
            self.wq.add_task(payload)

    def _flush_locked(self, signature) -> bool:
        """Dispatch one bucket for ``signature``; True when a bucket was
        actually handed to the work queue (the honest count
        ``flush_expired`` reports). Continuous mode assembles up to
        ``bucket_size`` tickets round-robin over tenants and leaves the
        remainder pooled with a fresh deadline."""
        if self.continuous:
            tickets = self._assemble_rr_locked(signature)
        else:
            tickets = self._buckets.pop(signature, None)
            self._deadlines.pop(signature, None)
        if not tickets:
            return False
        self._inflight_batches += 1
        self.wq.add_task(
            Bucket(
                signature=signature,
                tickets=tickets,
                t_dispatch=time.perf_counter(),
            )
        )
        return True

    def _assemble_rr_locked(self, signature) -> list[FleetTicket] | None:
        """Continuous-mode batch assembly: up to ``bucket_size`` tickets
        drawn round-robin over tenant ids (one per tenant per pass,
        arrival order within a tenant), starting from a rotating
        per-signature cursor so the same tenant is not always first."""
        pending = self._buckets.get(signature)
        if not pending:
            return None
        if len(pending) <= self.bucket_size:
            take = list(pending)
            del self._buckets[signature]
            self._deadlines.pop(signature, None)
            return take
        by_tenant: dict[Any, list[FleetTicket]] = {}
        order: list[Any] = []
        for t in pending:
            key = t.tenant
            if key not in by_tenant:
                by_tenant[key] = []
                order.append(key)
            by_tenant[key].append(t)
        idx = self._rr.get(signature, 0) % len(order)
        take: list[FleetTicket] = []
        scanned = 0
        while len(take) < self.bucket_size and scanned < len(order):
            q = by_tenant[order[idx % len(order)]]
            if q:
                take.append(q.pop(0))
                scanned = 0
            else:
                scanned += 1
            idx += 1
        self._rr[signature] = idx % len(order)
        taken = set(map(id, take))
        remainder = [t for t in pending if id(t) not in taken]
        self._buckets[signature] = remainder
        # the remainder's backstop deadline restarts — worst case one
        # extra flush window, and the completion hook usually assembles
        # it far sooner
        self._deadlines[signature] = (
            time.monotonic() + self.flush_deadline
        )
        return take

    def _batch_completed(self) -> None:
        """Batch-completion hook (runs on the dispatch lane as each
        batch finishes): free the lane's budget slot and — in
        continuous mode — assemble the next batch(es) from the pooled
        signatures, oldest deadline first, so the lane goes straight
        back to work. The decrement runs in BOTH modes: ``continuous``
        is a live knob (the controller flips it mid-run), and an
        inflight ledger that only ever counts down while the knob is on
        wedges the pool behind phantom in-flight batches the moment the
        knob flips."""
        with self._lock:
            self._inflight_batches = max(0, self._inflight_batches - 1)
            while (
                self.continuous
                and self._inflight_batches < self._lane_budget
                and self._buckets
            ):
                sig = (
                    min(self._deadlines, key=self._deadlines.get)
                    if self._deadlines
                    else next(iter(self._buckets))
                )
                if not self._flush_locked(sig):
                    break
            self._lock.notify_all()

    def _timer_loop(self) -> None:
        with self._lock:
            while not self._closed:
                if not self._deadlines:
                    self._lock.wait()
                    continue
                now = time.monotonic()
                soonest = min(self._deadlines.values())
                if soonest <= now:
                    for sig in [
                        s for s, dl in self._deadlines.items()
                        if dl <= now
                    ]:
                        self._flush_locked(sig)
                else:
                    self._lock.wait(soonest - now + 1e-3)

    # -- dispatch ------------------------------------------------------------

    def serve(
        self,
        fit_bucket: Callable[[Bucket], Sequence[Any]],
        *,
        num_lanes: int = 1,
    ) -> None:
        """Drain the admission queue: ``fit_bucket(bucket)`` returns one
        result per ticket (order-aligned); each ticket resolves as its
        bucket completes. Blocks until :meth:`close` has been called and
        everything queued has executed. WorkQueue's retry/lease policy
        applies per bucket; a bucket that exhausts its retries fails its
        tickets with the scheduler error instead of hanging them."""
        with self._lock:
            # the in-flight batch budget IS the lane count: one batch
            # per lane keeps every lane busy with zero head-of-line
            # queueing inside the work queue. Set unconditionally —
            # ``continuous`` is a live knob, and a run that starts in
            # deadline mode must still have the right budget when the
            # controller flips it on
            self._lane_budget = max(int(num_lanes), 1)

        def fold(task_id: int, out) -> None:
            bucket, results = out
            if len(results) != len(bucket.tickets):
                raise SchedulerError(
                    f"fit_bucket returned {len(results)} results for "
                    f"{len(bucket.tickets)} tickets"
                )
            for ticket, res in zip(bucket.tickets, results):
                ticket.resolve(res)

        def dispatch(bucket):
            # breaker feedback rides the dispatch itself: every failed
            # attempt feeds the signature's consecutive count (so a
            # poisoned signature trips within one retry ladder), every
            # success resets it. A KillSwitch is lane death, not a
            # dispatch verdict — it bypasses the breaker.
            # a control task (no tickets) is no dispatch verdict either
            br = self.breaker_for(bucket.signature) if bucket.tickets else None
            try:
                try:
                    out = fit_bucket(bucket)
                except KillSwitch:
                    raise
                except Exception as e:
                    if br is not None and br.record_failure(e):
                        self._emit("breaker", {
                            "event": "open",
                            "signature": bucket.signature,
                            "breaker": br.snapshot(),
                        })
                    raise
            finally:
                # the lane is free the moment this batch stops
                # computing — success, dispatch failure, or lane
                # death alike (a re-leased bucket decrements again;
                # the budget clamps at zero, so chaos can only
                # over-free, never wedge the pool). Unconditional:
                # every _flush_locked counted this batch in, whatever
                # mode the live knob is in by the time it completes.
                self._batch_completed()
            if br is not None and br.state != "closed":
                self._emit("breaker", {
                    "event": "closed", "signature": bucket.signature,
                })
            if br is not None:
                br.record_success()
            return bucket, out

        def fail_unresolved(err, *, only_done_tasks=False):
            for rec in self.wq.records:
                payload = rec.payload
                if only_done_tasks and not rec.done:
                    continue  # still leased/pending: a restarted lane
                    # re-serves it (supervised lane recovery)
                if isinstance(payload, Bucket):
                    for t in payload.tickets:
                        if not t.done():
                            t.fail(err)

        try:
            self.wq.run(
                dispatch,
                num_lanes=num_lanes,
                on_result=fold,
            )
        except Exception as e:
            if self.wq._failed is not None:
                # terminal scheduler failure (fail-fast mode retries
                # exhausted): every waiter unblocks with the cause
                fail_unresolved(self.wq._failed)
            else:
                # lane death (KillSwitch) or a poisoned fold: fail only
                # tickets whose task already COMPLETED (their results
                # can never be folded again); in-flight buckets keep
                # their tickets — a supervised re-entry of serve()
                # re-leases and resolves them
                fail_unresolved(e, only_done_tasks=True)
            raise
        else:
            # normal drain (closed + everything executed): any ticket
            # still unresolved belongs to an isolation-mode terminal
            # task whose on_terminal already failed it — the sweep is a
            # belt-and-braces guard against hung waiters
            fail_unresolved(
                self.wq._failed or SchedulerError("fleet dispatch aborted")
            )


def run_dynamic_round(
    data,
    *,
    num_batches: int,
    k: int,
    prefetch_depth: int = 5,
    num_lanes: int = 2,
    order: str = "lifo",
    remainder: str = "drop",
    solver: str = "eigh",
    subspace_iters: int = 16,
    orth_method: str = "cholqr2",
    compute_dtype=None,
    fault_hook: Callable[[int], None] | None = None,
    max_retries: int = 3,
    lease_timeout: float | None = None,
    device="cuda",
    v0=None,
):
    """The reference master's one-shot round over the dynamic scheduler.

    Splits ``(N, d)`` rows into ``num_batches`` contiguous ranges (the
    remainder policy explicit: ``"drop"`` the tail, ``"pad"`` it as one
    more batch, or ``"error"``), computes each batch's top-k eigenspace on
    ``device`` as the lanes drain the queue, folds the projector mean
    weighted by row count on the host as results arrive (the merge is
    order-invariant), and returns ``(sigma_bar, v_bar)`` on ``device``.

    Each batch's Gram is ``ops.gram.gram_auto`` of its ``(1, rows, d)``
    block: the hand-written Gram kernel on a CUDA tensor (fp32, or the
    ``compute_dtype`` cast), its plain version on the CPU; the lanes take
    turns on the device, so the kernel counters count every launch.
    ``fault_hook(task_id)`` runs before each batch computes and may raise
    to simulate a lane or worker crash; the queue retries it per
    ``max_retries``. ``v0 (d, k)`` starts the subspace solves (default:
    ``ops.linalg.initial_basis`` from seed 0).
    """
    import numpy as np
    import torch

    from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype
    from distributed_eigenspaces_tpu_torch.ops.gram import gram_auto
    from distributed_eigenspaces_tpu_torch.ops.linalg import (
        initial_basis,
        merged_top_k,
    )

    dev = resolve_device(device)
    data = np.asarray(data)
    n_total, d = data.shape
    step = n_total // num_batches
    if step == 0:
        raise ValueError(f"num_batches={num_batches} > rows={n_total}")
    ranges = [(i * step, (i + 1) * step) for i in range(num_batches)]
    tail = n_total - num_batches * step
    if tail:
        if remainder == "error":
            raise ValueError(f"{tail} remainder rows with remainder='error'")
        if remainder == "pad":  # fold the ragged tail as one more batch
            ranges.append((num_batches * step, n_total))
    cdt = None if compute_dtype is None else torch_dtype(compute_dtype)
    v_start = (initial_basis(d, k, device=dev, v0=v0)
               if solver == "subspace" else None)
    device_lock = threading.Lock()

    def eigenspace(x: torch.Tensor) -> torch.Tensor:
        if cdt is not None:
            x = x.to(cdt)
        g = gram_auto(x[None])[0]
        return merged_top_k(g, k, solver, subspace_iters, orth_method, v0=v_start)

    # projector mean weighted by batch row count: equal weights for the
    # equal-size batches, while a ragged "pad" tail counts in proportion to
    # its rows instead of skewing the mean
    merged_sum = np.zeros((d, d), np.float32)
    merged_rows = 0
    fold_lock = threading.Lock()

    def compute(rng_pair):
        lo, hi = rng_pair
        if fault_hook is not None:
            fault_hook(lo // step if step else 0)
        x = torch.from_numpy(np.ascontiguousarray(data[lo:hi], np.float32))
        with device_lock:
            v = eigenspace(x.to(dev)).cpu().numpy()
        return v, hi - lo

    def fold(task_id, result):
        nonlocal merged_sum, merged_rows
        v, rows = result
        with fold_lock:
            merged_sum = merged_sum + rows * (v @ v.T)
            merged_rows += rows

    wq = WorkQueue(
        ranges,
        prefetch_depth=prefetch_depth,
        order=order,
        max_retries=max_retries,
        lease_timeout=lease_timeout,
    )
    wq.run(compute, num_lanes=num_lanes, on_result=fold)

    sigma_bar = torch.from_numpy(merged_sum / max(merged_rows, 1)).to(dev)
    v_bar = merged_top_k(sigma_bar, k, solver, subspace_iters, orth_method,
                         v0=v_start)
    return sigma_bar, v_bar
