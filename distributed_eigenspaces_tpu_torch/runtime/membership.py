"""Elastic fleet membership: liveness, quorum, deadline rounds.

The port's copy of ``distributed_eigenspaces_tpu/runtime/membership.py``.
The merge ``sigma_bar(t) = (1/m) sum_l V_l V_l^T`` is already a masked mean
(``algo/step.py::mean_projector``), so aggregating over whichever
contributors showed up this round is a mask; this module computes it:

1. :class:`MembershipTable`: lease-based heartbeats over ``m`` stable worker
   slots. A worker that misses ``cfg.heartbeat_timeout_ms`` is **suspect**
   (excluded from merges, still owns its slot); a second timeout marks it
   **dead** (lease released, slot joinable). ``join()`` claims a dead slot
   as **joining**, admitted to **live** at the next round boundary with a
   fresh lease; slot ids are stable across the rejoin and a per-slot
   ``generation`` counts incarnations.
2. Deadline rounds: :class:`ElasticStream` wraps a block stream and closes
   each merge round at ``cfg.round_deadline_ms`` with whatever arrived: its
   per-round mask is ``membership AND arrived``. A late straggler's rows are
   held and folded into the next merge (one step stale), so a slow worker
   costs a one-round lag, not a stalled barrier.
3. :class:`QuorumLost`: below ``cfg.min_quorum_frac`` the round fails
   loudly, within about twice the heartbeat timeout of the crash.
   ``supervised_fit(..., membership=table)`` waits a bounded time for
   quorum (rejoins admitted during the wait) and resumes from the newest
   checkpoint.

Every membership event lands in ``MetricsLogger.summary()["membership"]``
and on the tracer's timeline (``membership:*`` instants). The stream's
blocks come out as tensors on the fit's device.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Iterable

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.device import resolve_device

__all__ = [
    "ElasticStream",
    "MembershipTable",
    "QuorumLost",
]

#: membership states a slot moves through (the MembershipTable table)
STATES = ("live", "suspect", "dead", "joining")


class QuorumLost(RuntimeError):
    """Live membership fell below ``min_quorum_frac``: the run cannot
    claim a representative merge and fails LOUDLY instead of silently
    averaging a sliver of the fleet. Carries the table so the handler
    (``supervised_fit``) can wait for quorum to return and resume."""

    def __init__(self, table: "MembershipTable", step: int | None = None):
        self.table = table
        self.step = step
        self.live = table.live_count()
        self.frac = table.live_frac()
        self.required = table.min_quorum_frac
        super().__init__(
            f"quorum lost at step {step}: {self.live}/{table.num_workers} "
            f"workers live ({self.frac:.2f} < min_quorum_frac "
            f"{self.required:.2f}); states {table.state_counts()}"
        )


class MembershipTable:
    """Lease-based membership over ``m`` stable worker slots.

    Heartbeats renew a slot's lease; :meth:`sweep` (called at every
    round boundary, and by the quorum wait) applies expiry:

    ==========  ==========================================  ============
    state       entered when                                mask weight
    ==========  ==========================================  ============
    live        heartbeat within ``heartbeat_timeout_ms``   1
    suspect     lease expired once (timeout missed)         0
    dead        suspect for ``suspect_grace_ms`` more       0
    joining     ``join()`` claimed a dead slot; admitted    0 until
                to live at the NEXT round boundary          admitted
    ==========  ==========================================  ============

    A suspect worker that heartbeats again recovers to live without
    losing its slot (network-blip flap). A dead slot's lease is
    released: ``join()`` re-claims it (same slot id, ``generation + 1``)
    and the joiner enters at the next :meth:`begin_round` /
    :meth:`admit_pending` with a fresh lease — so the ledger's slot ids
    stay attributable across churn. Thread-safe; ``clock`` is
    injectable for deterministic tests.
    """

    def __init__(
        self,
        num_workers: int,
        *,
        heartbeat_timeout_ms: float = 1000.0,
        suspect_grace_ms: float | None = None,
        min_quorum_frac: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        metrics=None,
        max_events: int = 4096,
    ):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1: {num_workers}")
        if heartbeat_timeout_ms <= 0:
            raise ValueError(
                f"heartbeat_timeout_ms must be > 0: {heartbeat_timeout_ms}"
            )
        if not 0.0 < min_quorum_frac <= 1.0:
            raise ValueError(
                f"min_quorum_frac must be in (0, 1]: {min_quorum_frac}"
            )
        self.num_workers = num_workers
        self.heartbeat_timeout_s = heartbeat_timeout_ms / 1e3
        self.suspect_grace_s = (
            self.heartbeat_timeout_s if suspect_grace_ms is None
            else suspect_grace_ms / 1e3
        )
        self.min_quorum_frac = min_quorum_frac
        self.metrics = metrics
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.RLock()
        now = self._clock()
        #: per-slot state in STATES — the fleet starts full and live
        self._state = ["live"] * num_workers
        #: last heartbeat (live/joining) or state-entry time (suspect)
        self._stamp = [now] * num_workers
        #: incarnation counter: bumped on every re-join of the slot
        self._gen = [0] * num_workers
        #: bounded local event record (tests/snapshot; the durable copy
        #: rides MetricsLogger/telemetry)
        self.events: deque = deque(maxlen=max_events)

    # -- events --------------------------------------------------------------

    def _record(self, kind: str, slot: int | None = None, **detail) -> dict:
        ev = {"kind": kind}
        if slot is not None:
            ev["slot"] = int(slot)
            ev["generation"] = self._gen[slot]
        ev.update(detail)
        self.events.append(ev)
        if self.metrics is not None:
            self.metrics.membership(ev)
            from distributed_eigenspaces_tpu_torch.utils.telemetry import (
                tracer_of,
            )

            tracer_of(self.metrics).event(
                f"membership:{kind}", category="membership",
                attrs={
                    k: v for k, v in ev.items()
                    if isinstance(v, (int, float, str, bool))
                },
            )
        return ev

    # -- state machine -------------------------------------------------------

    def heartbeat(self, slot: int) -> None:
        """Renew ``slot``'s lease. A suspect worker recovers to live
        (it never stopped owning the slot); a dead slot's heartbeat is
        ignored LOUDLY — the worker must :meth:`join` again (its lease
        was released; the slot may have been re-claimed)."""
        with self._lock:
            st = self._state[slot]
            if st == "dead":
                self._record("stale_heartbeat", slot)
                return
            self._stamp[slot] = self._clock()
            if st == "suspect":
                self._state[slot] = "live"
                self._record("recovered", slot)

    def join(self, slot: int | None = None) -> int:
        """Claim a dead slot as *joining* (admitted live at the next
        round boundary with a fresh lease). ``slot=None`` picks the
        lowest dead slot. Joining an already-member slot raises — the
        join protocol is explicit, not idempotent."""
        with self._lock:
            if slot is None:
                dead = [
                    i for i, s in enumerate(self._state) if s == "dead"
                ]
                if not dead:
                    raise ValueError(
                        "join: no dead slot is free "
                        f"(states {self.state_counts()})"
                    )
                slot = dead[0]
            if self._state[slot] != "dead":
                raise ValueError(
                    f"join: slot {slot} is {self._state[slot]!r}, not "
                    "dead (a suspect worker heartbeats to recover; a "
                    "live one is already a member)"
                )
            self._gen[slot] += 1
            self._state[slot] = "joining"
            self._stamp[slot] = self._clock()
            self._record("join", slot)
            return slot

    def leave(self, slot: int) -> None:
        """Graceful departure: the slot goes dead immediately (lease
        released, joinable) — no suspect detour, the worker said
        goodbye."""
        with self._lock:
            if self._state[slot] == "dead":
                return
            self._state[slot] = "dead"
            self._stamp[slot] = self._clock()
            self._record("leave", slot)

    def sweep(self) -> list[dict]:
        """Apply lease expiry at the current clock: live slots past the
        heartbeat timeout go suspect; suspects past the grace go dead.
        Returns the transition events (also recorded)."""
        out = []
        with self._lock:
            now = self._clock()
            for i, st in enumerate(self._state):
                if st == "live" and (
                    now - self._stamp[i] > self.heartbeat_timeout_s
                ):
                    self._state[i] = "suspect"
                    missed_s = now - self._stamp[i]
                    self._stamp[i] = now
                    out.append(self._record(
                        "suspect", i, missed_ms=round(missed_s * 1e3, 1),
                    ))
                elif st == "suspect" and (
                    now - self._stamp[i] > self.suspect_grace_s
                ):
                    self._state[i] = "dead"
                    self._stamp[i] = now
                    out.append(self._record("dead", i))
        return out

    def admit_pending(self) -> list[int]:
        """Admit every *joining* slot to live with a fresh lease — the
        round-boundary half of the join protocol (also run by the
        quorum wait: the resume IS the next round)."""
        admitted = []
        with self._lock:
            now = self._clock()
            for i, st in enumerate(self._state):
                if st == "joining":
                    self._state[i] = "live"
                    self._stamp[i] = now
                    admitted.append(i)
                    self._record("admit", i)
        return admitted

    def begin_round(self, step: int) -> np.ndarray:
        """Round boundary: sweep leases, admit pending joiners, return
        the round's membership mask. Raises :class:`QuorumLost` when
        live membership is below ``min_quorum_frac`` — the bounded-time
        loud failure (lease expiry is at most one heartbeat timeout
        behind the crash; the deadline bounds the round)."""
        with self._lock:
            self.sweep()
            self.admit_pending()
            if not self.quorum_ok():
                self._record(
                    "quorum_lost", step=step, live=self.live_count(),
                    frac=round(self.live_frac(), 4),
                    required=self.min_quorum_frac,
                )
                raise QuorumLost(self, step)
            return self.mask()

    # -- views ---------------------------------------------------------------

    def state(self, slot: int) -> str:
        return self._state[slot]

    def generation(self, slot: int) -> int:
        return self._gen[slot]

    def mask(self) -> np.ndarray:
        """(m,) float32 membership mask: 1.0 for live slots only."""
        with self._lock:
            return np.asarray(
                [1.0 if s == "live" else 0.0 for s in self._state],
                np.float32,
            )

    def live_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._state if s == "live")

    def live_frac(self) -> float:
        return self.live_count() / self.num_workers

    def quorum_ok(self) -> bool:
        return self.live_frac() >= self.min_quorum_frac

    def state_counts(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for s in self._state:
                out[s] = out.get(s, 0) + 1
            return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "states": list(self._state),
                "generations": list(self._gen),
                "live": self.live_count(),
                "live_frac": round(self.live_frac(), 4),
                "min_quorum_frac": self.min_quorum_frac,
                "quorum_ok": self.quorum_ok(),
            }

    def wait_for_quorum(
        self, timeout_s: float, *, poll_s: float = 0.01
    ) -> bool:
        """Block (bounded) until live membership is back above the
        quorum floor. Each poll sweeps leases AND admits pending
        joiners — a worker that calls :meth:`join` during the outage
        becomes live here (the wait is the round boundary). Returns
        True iff quorum returned within ``timeout_s``."""
        deadline = self._clock() + timeout_s
        while True:
            with self._lock:
                self.sweep()
                self.admit_pending()
                if self.quorum_ok():
                    self._record(
                        "quorum_restored", live=self.live_count(),
                        frac=round(self.live_frac(), 4),
                    )
                    return True
            if self._clock() >= deadline:
                return False
            self._sleep(poll_s)


class ElasticStream:
    """Round-deadline block assembly under a :class:`MembershipTable`.

    Wraps a plain ``(m, n, d)`` block stream (what each worker WOULD
    contribute per round) and emits the elastic view of it: each
    ``__next__`` is one merge round that

    1. applies the :class:`~..utils.faults.ChurnPlan` lifecycle actions
       scheduled for this step (crash-kills stop heartbeating — the
       liveness path detects them; graceful leaves release the slot
       immediately; rejoins claim their old slot and are admitted at the
       NEXT round);
    2. heartbeats every simulated-alive worker, then runs the table's
       round boundary (sweep → admit → quorum check — raises
       :class:`QuorumLost` when membership is below the floor);
    3. closes at ``cfg.round_deadline_ms`` with whatever arrived: a live
       worker whose delivery (``ChurnPlan`` straggler delay) misses the
       deadline contributes NOTHING this round — its rows are held and
       folded into the NEXT merge instead (one step stale), so a persistent straggler degrades to a one-round
       lag, and a dead worker can never deadlock the round (the
       deadline bounds the wait; dead slots are not waited for at all);
    4. pushes the round's effective mask (``membership ∧ arrived``) for
       the trainer: pass :meth:`membership_masks` as ``worker_masks=``
       (solo runs) or let ``supervised_fit`` compose it with the
       quarantine mask feed (it detects the stream's mask feed and the
       table rides the supervisor's ledger).

    Masked-out slots keep their (finite) fresh rows in the emitted
    block — the masked merge weights them 0 exactly, the same contract
    as the supervisor's placeholder rows. ``first_step`` offsets step
    numbering for resumed streams (churn plan keys are absolute);
    lifecycle actions for steps before ``first_step`` are replayed onto
    the simulation state at construction so a resume sees the same
    world. Each emitted block is a tensor on ``device``, where the fit
    runs (the card unless asked).
    """

    def __init__(
        self,
        stream: Iterable,
        table: MembershipTable,
        cfg,
        *,
        churn=None,
        first_step: int = 1,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        device="cuda",
    ):
        self._it = iter(stream)
        self._device = resolve_device(device)
        self.table = table
        self.cfg = cfg
        self.churn = churn
        self.metrics = metrics if metrics is not None else table.metrics
        self._clock = clock
        self._sleep = sleep
        self._step = first_step - 1
        self._deadline_s = (
            None if cfg.round_deadline_ms is None
            else cfg.round_deadline_ms / 1e3
        )
        #: straggler rows held for the next merge: slot -> (step, rows)
        self._pending: dict[int, tuple] = {}
        #: slots whose simulated worker is crashed (no heartbeats)
        self._sim_dead: set[int] = set()
        #: per-round masks, FIFO with the yielded blocks (the
        #: supervisor's _MaskFeed discipline)
        self._masks: deque = deque()
        if churn is not None:
            # resume replay: lifecycle state from steps already consumed
            for t in range(1, first_step):
                for s in churn.kill_at.get(t, ()):
                    self._sim_dead.add(s)
                for s in churn.leave_at.get(t, ()):
                    self._sim_dead.add(s)
                for s in churn.rejoin_at.get(t, ()):
                    self._sim_dead.discard(s)
            # the TABLE is the durable truth across resumes: a slot it
            # holds as live/joining rejoined out-of-plan (e.g. during a
            # quorum outage) — never re-crash it from the replay. (A
            # truly crashed slot still live in the table re-dies via
            # lease expiry, which is the detection path anyway.)
            self._sim_dead -= {
                s for s in range(table.num_workers)
                if table.state(s) in ("live", "joining")
            }

    def membership_masks(self):
        """Iterator over the per-round effective masks, FIFO with the
        yielded blocks — pass as ``worker_masks=`` (prefetch-safe: one
        mask is pushed per yielded block, popped per executed step)."""
        return _MembershipMaskFeed(self._masks)

    def _emit(self, kind: str, **detail) -> None:
        if self.metrics is not None:
            ev = {"kind": kind, **detail}
            self.metrics.membership(ev)
            from distributed_eigenspaces_tpu_torch.utils.telemetry import (
                tracer_of,
            )

            tracer_of(self.metrics).event(
                f"membership:{kind}", category="membership",
                attrs={
                    k: v for k, v in detail.items()
                    if isinstance(v, (int, float, str, bool))
                },
            )

    def __iter__(self) -> "ElasticStream":
        return self

    def __next__(self):
        t = self._step + 1
        table, churn = self.table, self.churn
        if churn is not None:
            kills = churn.kill_at.get(t, ())
            if kills:
                self._emit("churn_kill", step=t, slots=list(kills))
            for s in kills:
                # crash: heartbeats stop; the TABLE finds out via lease
                # expiry (that lag is the liveness detection under test)
                self._sim_dead.add(s)
            for s in churn.leave_at.get(t, ()):
                self._sim_dead.add(s)
                table.leave(s)
        # heartbeats from every simulated-alive worker, then the round
        # boundary: sweep (kills surface as suspect→dead once their
        # lease runs out), admit joiners, quorum check
        for s in range(table.num_workers):
            if s not in self._sim_dead and table.state(s) != "dead":
                table.heartbeat(s)
        member_mask = table.begin_round(t)
        if churn is not None:
            rejoins = churn.rejoin_at.get(t, ())
            if rejoins:
                self._emit("churn_rejoin", step=t, slots=list(rejoins))
            for s in rejoins:
                # back from the dead: claim the old slot; admitted at
                # the NEXT round's boundary (fresh lease, same slot
                # id). A flap caught before the lease ran out just
                # resumes heartbeating (suspect recovers in place).
                self._sim_dead.discard(s)
                if table.state(s) == "dead":
                    table.join(s)
        # a copy on the fit's device (the stale-row splice below writes it)
        block = _placed_copy(next(self._it), self._device)
        m = table.num_workers
        arrived = np.zeros(m, np.float32)
        late, stale = [], []
        max_wait = 0.0
        deadline_closed = False
        for s in range(m):
            if member_mask[s] == 0.0:
                self._pending.pop(s, None)  # a non-member's held rows die
                continue
            if s in self._sim_dead:
                # crashed but not yet detected (lease still warm): no
                # data is coming — the round waits it out until the
                # deadline and closes WITHOUT it. This detection-lag
                # cost is exactly what the heartbeat timeout bounds;
                # once the lease expires the slot leaves the membership
                # mask and is never waited for again.
                self._pending.pop(s, None)
                if self._deadline_s is not None:
                    deadline_closed = True
                continue
            delay = churn.delay(t, s) if churn is not None else 0.0
            on_time = self._deadline_s is None or delay <= self._deadline_s
            held = self._pending.pop(s, None)
            if held is not None:
                # fold the held straggler rows into THIS merge (the
                # one-step-stale rule); this round's fresh rows replace
                # them in the hold if the worker straggled again
                arrived[s] = 1.0
                stale.append(s)
                # copy BEFORE the splice: block[s] is a view, and the
                # held rows are about to overwrite it
                fresh = block[s].clone()
                block[s] = held[1]
                if not on_time:
                    self._pending[s] = (t, fresh)
                    deadline_closed = True
                else:
                    max_wait = max(max_wait, delay)
            elif on_time:
                arrived[s] = 1.0
                max_wait = max(max_wait, delay)
            else:
                # missed the deadline: hold the rows for the next merge
                late.append(s)
                self._pending[s] = (t, block[s].clone())
                deadline_closed = True
        if deadline_closed and self._deadline_s is not None:
            max_wait = self._deadline_s
        if max_wait > 0:
            self._sleep(max_wait)  # the round's simulated wall time
        mask = member_mask * arrived
        self._emit(
            "round_closed", step=t, arrived=int(arrived.sum()),
            members=int(member_mask.sum()),
            arrived_slots=[int(s) for s in np.nonzero(arrived)[0]],
            late=late, stale=stale,
            deadline_closed=bool(deadline_closed),
            quorum_frac=round(table.live_frac(), 4),
        )
        self._masks.append(mask)
        self._step = t
        return block

    def close(self) -> None:
        close = getattr(self._it, "close", None)
        if close is not None:
            close()


def _placed_copy(block, device: torch.device) -> torch.Tensor:
    """A block as a new tensor on ``device`` (a fresh copy even when it
    is there already)."""
    t = torch.as_tensor(block)
    out = t.to(device)
    return out.clone() if out.data_ptr() == t.data_ptr() else out


class _MembershipMaskFeed:
    """FIFO view over an :class:`ElasticStream`'s per-round masks —
    drained in lockstep with the yielded blocks (prefetch-safe, the
    supervisor's mask-feed discipline)."""

    def __init__(self, masks: deque):
        self._masks = masks

    def __iter__(self) -> "_MembershipMaskFeed":
        return self

    def __next__(self):
        if not self._masks:
            raise RuntimeError(
                "membership mask feed drained out of lockstep with its "
                "elastic stream — a step consumed a mask no assembled "
                "round produced (membership wiring bug)"
            )
        return self._masks.popleft()
