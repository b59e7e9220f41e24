"""Online autoscaler: the control plane's reactive half.

The port's copy of ``distributed_eigenspaces_tpu/runtime/controller.py``,
pure host Python. A controller lane watches ``metrics.summary()`` (SLO
burn fast / slow, attainment, shed counts, batch occupancy) and acts ONLY
through the serve tier's existing elastic surfaces: the live
:class:`~..runtime.scheduler.ShapeBucketQueue` reads ``bucket_size``,
``flush_deadline`` and ``continuous`` at submit / dispatch time, so a knob
write takes effect on the next admission with no new queue machinery.

State machine (one knob per window, every decision recorded):

- **WATCH**: each ``controller_window_s`` tick reads the telemetry. A
  pending plan override rolls out first (``trigger="plan_rollout"``, one
  knob per window); otherwise a fast-burn breach (``burn_fast > 1``:
  violations arriving faster than the error budget) picks the FIRST
  available mitigation in priority order: flip ``continuous`` on, halve
  ``flush_deadline``, halve ``bucket_size`` (``trigger="burn_breach"``).
- **HOLD**: after any action the controller holds for one full window and
  compares the burn over the observation window against the burn over the
  window before the action. Worsened: the knob is restored and a
  ``rollback`` decision recorded (``trigger="burn_worsened"``, both burns
  as evidence); otherwise the action ``commit``\\ s. A seeded bad plan
  therefore rolls itself back.
- **FROZEN**: actions and rollbacks are budgeted by
  ``controller_max_actions``; exhausting it records one loud
  ``budget_exhausted`` decision and stops acting.

Every decision lands on the ``metrics.controller()`` channel with the
lineage ``{trigger, knob, from, to, plan_id, seq}`` plus the triggering
telemetry evidence, so ``summary()["controller"]`` is the complete audit
trail.
"""

from __future__ import annotations

import threading
import time

__all__ = ["Controller", "SURFACE_KNOBS"]

#: the elastic surfaces the controller may touch, in mitigation
#: priority order — the same knob vocabulary the planner enumerates.
#: ``serve_bucket_size`` is LAST on purpose: shrinking it mints new
#: batch shapes, and each fresh shape pays an inline compile stall —
#: a mitigation that makes the first post-action window worse.
SURFACE_KNOBS = ("serve_continuous", "serve_flush_s", "serve_bucket_size")

#: hard floors: a mitigation never drives the queue degenerate
_MIN_BUCKET = 2
_MIN_FLUSH_S = 0.005

#: burn_fast above this = the error budget is burning faster than it
#: accrues (slo_summary quotes burn as violation_rate / error_budget)
_BURN_BREACH = 1.0


class Controller:
    """The autoscaler lane around one live ``QueryServer``.

    Runs as a daemon thread started by :meth:`start` (the scenario
    runner's integration) or stepped deterministically via
    :meth:`tick` (tests). ``plan`` is an optional ``plan-v1`` dict
    whose serve-side ``config_overrides`` roll out one knob per
    window; its ``plan_id`` stamps every decision's lineage —
    decisions taken with no plan carry ``plan_id=None``.
    """

    def __init__(self, server, metrics, cfg, plan=None,
                 clock=time.monotonic):
        if cfg.controller_window_s is None:
            raise ValueError(
                "Controller requires cfg.controller_window_s (None "
                "means the control plane is off — do not construct "
                "one)"
            )
        self.server = server
        self.metrics = metrics
        self.window_s = float(cfg.controller_window_s)
        self.max_actions = int(cfg.controller_max_actions)
        self.plan = plan
        self.plan_id = (plan or {}).get("plan_id")
        self._clock = clock
        self._seq = 0
        self._spent = 0
        self._frozen = False
        self._no_surface_said = False
        # HOLD state: {knob, restore_to, ev_action, ev_settled} —
        # ev_settled lands one window after the action so the judged
        # window excludes the backlog admitted under the OLD knob
        # (those queries complete after the flip and would smear its
        # latencies over the new setting's burn)
        self._holding: dict | None = None
        # the burn over the window BEFORE the current one — the
        # rollback comparison's baseline
        self._prev_counts = None
        self._rollout = self._plan_rollout_queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- knob access: the live queue attributes -----------------------------

    def _get(self, knob: str):
        q = self.server.queue
        if knob == "serve_continuous":
            return bool(q.continuous)
        if knob == "serve_bucket_size":
            return int(q.bucket_size)
        if knob == "serve_flush_s":
            return float(q.flush_deadline)
        raise KeyError(knob)

    def _set(self, knob: str, value) -> None:
        q = self.server.queue
        if knob == "serve_continuous":
            q.continuous = bool(value)
            if value:
                # drain the backlog pooled under the old deadline
                # regime NOW — otherwise those tickets ride out their
                # original flush windows and smear the judged window
                # with pre-action waits
                q.flush_all()
        elif knob == "serve_bucket_size":
            q.bucket_size = int(value)
        elif knob == "serve_flush_s":
            q.flush_deadline = float(value)
        else:
            raise KeyError(knob)

    def _plan_rollout_queue(self) -> list[tuple[str, object]]:
        """The plan's serve-side overrides that differ from the live
        values, in surface priority order — applied one per window so
        each gets its own observe/rollback arc."""
        if not self.plan:
            return []
        over = (
            (self.plan.get("chosen") or {}).get("config_overrides")
            or {}
        )
        queue = []
        for knob in SURFACE_KNOBS:
            if knob in over and over[knob] != self._get(knob):
                queue.append((knob, over[knob]))
        return queue

    # -- telemetry ----------------------------------------------------------

    def _evidence(self) -> dict:
        """The telemetry a decision cites: the SLO burn/attainment
        snapshot plus the serve counters that explain it."""
        summ = self.metrics.summary()
        slo = (summ.get("slo") or {}).get("serve") or {}
        serving = summ.get("serving") or {}
        health = serving.get("health") or {}
        sheds = health.get("sheds") or {}
        return {
            "burn_fast": (slo.get("burn") or {}).get("fast"),
            "burn_slow": (slo.get("burn") or {}).get("slow"),
            "attainment": slo.get("attainment"),
            "requests": slo.get("requests", 0),
            "violations": slo.get("violations", 0),
            "p99_ms": slo.get("p99_ms"),
            "mean_occupancy": serving.get("mean_occupancy"),
            "sheds": int(sum(sheds.values())) if sheds else 0,
        }

    def _window_burn(self, now: dict, then: dict | None) -> float | None:
        """Burn over the requests that arrived BETWEEN two evidence
        snapshots (cumulative burn dilutes — the rollback comparison
        needs the observation window alone). None when the window saw
        no traffic (nothing to judge an action by)."""
        if then is None:
            return now.get("burn_fast")
        dreq = now["requests"] - then["requests"]
        if dreq <= 0:
            return None
        dviol = now["violations"] - then["violations"]
        err_budget = 0.01  # slo_summary's fixed 99% objective
        return (dviol / dreq) / err_budget

    #: rollback tolerance, in budget-burn units: a judged window must
    #: burn MORE than the pre-action window by at least a quarter of
    #: the budget rate before the action reads as harmful (noise on a
    #: handful of requests must not thrash the knob back)
    _WORSEN_MARGIN = 0.25

    # -- decisions ----------------------------------------------------------

    def _record(self, kind: str, **fields) -> None:
        self._seq += 1
        self.metrics.controller({
            "kind": kind, "seq": self._seq,
            "plan_id": self.plan_id, **fields,
        })

    def _act(self, knob: str, target, trigger: str,
             evidence: dict) -> None:
        """One lineage-stamped knob change + enter HOLD."""
        current = self._get(knob)
        self._set(knob, target)
        self._spent += 1
        self._record(
            "action", knob=knob, trigger=trigger,
            **{"from": current, "to": target},
            evidence=evidence,
        )
        self._holding = {
            "knob": knob, "restore_to": current,
            # the pre-action window's burn, captured NOW — by judge
            # time _prev_counts has moved past the action tick
            "burn_before": self._window_burn(
                evidence, self._prev_counts
            ),
            "ev_settled": None,
        }

    def tick(self) -> None:
        """One control window: resolve a pending HOLD, then (budget
        permitting) take at most one action. Deterministic — tests
        drive it directly; :meth:`start`'s thread calls it once per
        ``controller_window_s``."""
        if self._frozen:
            return
        evidence = self._evidence()
        if self._holding is not None:
            hold = self._holding
            if hold["ev_settled"] is None:
                # settle window: the old knob's backlog drains; judge
                # from the NEXT window's traffic only
                hold["ev_settled"] = evidence
                return
            burn_after = self._window_burn(evidence, hold["ev_settled"])
            if burn_after is None:
                # no request RESOLVED since the settle snapshot — a
                # knob bad enough to stall the pipeline entirely would
                # otherwise commit unjudged. Keep holding: the judged
                # window stretches until evidence lands.
                return
            knob, restore_to = hold["knob"], hold["restore_to"]
            self._holding = None
            burn_before = hold["burn_before"]
            worsened = (
                burn_after is not None
                and burn_after
                > (burn_before or 0.0) + self._WORSEN_MARGIN
            )
            # a rollback is a SAFETY action: it runs even with the
            # budget spent (still counted — the freeze lands after)
            if worsened:
                applied = self._get(knob)
                self._set(knob, restore_to)
                self._spent += 1
                self._record(
                    "rollback", knob=knob, trigger="burn_worsened",
                    **{"from": applied, "to": restore_to},
                    evidence={
                        **evidence,
                        "window_burn_before": burn_before,
                        "window_burn_after": burn_after,
                    },
                )
            else:
                self._record(
                    "commit", knob=knob, trigger="hold_elapsed",
                    to=self._get(knob),
                    evidence={
                        **evidence,
                        "window_burn_before": burn_before,
                        "window_burn_after": burn_after,
                    },
                )
            self._prev_counts = evidence
            self._check_budget(evidence)
            return
        if self._spent >= self.max_actions:
            self._check_budget(evidence)
            return
        if self._rollout:
            knob, target = self._rollout.pop(0)
            self._act(knob, target, "plan_rollout", evidence)
        else:
            burn = self._window_burn(evidence, self._prev_counts)
            if burn is not None and burn > _BURN_BREACH:
                self._mitigate(evidence)
        self._prev_counts = evidence

    def _mitigate(self, evidence: dict) -> None:
        """First available mitigation, priority order: continuous
        admission (kills bucket-fill wait), tighter flush deadline,
        smaller buckets (last — new shapes pay inline compile stalls).
        All surfaces at their floor = nothing left to do; said once,
        loudly."""
        if not self._get("serve_continuous"):
            self._act("serve_continuous", True, "burn_breach", evidence)
        elif self._get("serve_flush_s") > _MIN_FLUSH_S:
            self._act(
                "serve_flush_s",
                max(_MIN_FLUSH_S, self._get("serve_flush_s") / 2),
                "burn_breach", evidence,
            )
        elif self._get("serve_bucket_size") > _MIN_BUCKET:
            self._act(
                "serve_bucket_size",
                max(_MIN_BUCKET, self._get("serve_bucket_size") // 2),
                "burn_breach", evidence,
            )
        elif not self._no_surface_said:
            self._no_surface_said = True
            self._record(
                "no_surface", trigger="burn_breach", evidence=evidence,
            )

    def _check_budget(self, evidence: dict) -> None:
        if self._spent >= self.max_actions and not self._frozen:
            self._frozen = True
            self._record(
                "budget_exhausted", trigger="budget",
                spent=self._spent, budget=self.max_actions,
                evidence=evidence,
            )

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Controller":
        if self._thread is not None:
            return self
        self._record(
            "start", window_s=self.window_s,
            budget=self.max_actions,
            rollout_pending=[k for k, _ in self._rollout],
        )
        self._thread = threading.Thread(
            target=self._loop, name="det-controller", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.window_s):
            try:
                self.tick()
            except Exception as e:  # never take the serve path down
                self._record("error", error=repr(e))
                return

    def close(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self._record(
            "stop", spent=self._spent, frozen=self._frozen,
            knobs={k: self._get(k) for k in SURFACE_KNOBS},
        )

    def __enter__(self) -> "Controller":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
