"""Population-scale ingest: sampled cohorts over a transient client
population.

The port's copy of ``distributed_eigenspaces_tpu/runtime/population.py``.
The fit tier assumes ``m`` STABLE worker slots with heartbeat leases; this
module is the population model, where contributors are anonymous,
transient and occasionally adversarial:

- **Sampled cohorts**: each round draws ``cfg.cohort_size`` clients
  uniformly from a simulated population of ``cfg.population`` ids. Merge
  cost scales with the cohort; the population only scales the sampler.
- **Participation-fraction deadline**: the round closes with whatever
  arrived; arrivals below ``cfg.min_participation_frac`` of the cohort
  raise :class:`ParticipationLost` (a ``QuorumLost``). Dropouts contribute
  nothing; a persistent straggler's contribution folds ONE-STEP-STALE into
  the next round's merge by refilling that round's empty slots.
- **Validation gauntlet before the merge**: every arrival crosses
  ``parallel/clients.py``'s host-side screen (shape / dtype / non-finite /
  near-orthonormality); rejects are quarantined into the fault ledger by
  client id and reason (``quarantine_client`` events) and mirrored into
  ``MetricsLogger.summary()["population"]``.
- **Hardened merge**: survivors reduce through the norm-clipped
  coordinate-wise trimmed mean, the affinity screen and the exact masked
  merge (``clients.make_population_merge``) on the fit's device.
- **Participation collapse, bounded wait, resume** (:func:`population_fit`):
  a collapse waits a bounded time for participation to return (the wait
  consumes rounds) and resumes under the ``max_resumes`` budget.

:class:`PopulationIngest` is numpy on the host, seeded per ``(seed, round,
client)`` exactly as the reference seeds it, so both packages ingest the
same bits. :func:`population_fit` moves each round's stack to ``device``
(the card unless the caller asks for the CPU) for the merge and the fold.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from distributed_eigenspaces_tpu_torch.parallel.clients import (
    make_population_merge,
    naive_mean_basis,
    validate_contribution,
)
from distributed_eigenspaces_tpu_torch.runtime.membership import QuorumLost

__all__ = [
    "ParticipationLost",
    "PopulationIngest",
    "population_fit",
]


class ParticipationLost(QuorumLost):
    """Round participation fell below ``cfg.min_participation_frac``: the
    cohort cannot claim a representative merge. It carries a table-shaped
    view of the ingest (``live_count`` = arrivals, ``num_workers`` = cohort
    size, ``wait_for_quorum`` = wait out the outage wave), so the
    bounded-wait and resume arc handles it unchanged."""


class _ParticipationView:
    """The ``QuorumLost.table`` duck type over a :class:`PopulationIngest`:
    quorum vocabulary re-anchored to participation (slots -> sampled
    cohort, live -> arrived)."""

    def __init__(self, ingest: "PopulationIngest", arrived: int):
        self._ingest = ingest
        self._arrived = arrived
        self.num_workers = ingest.cfg.cohort_size
        self.min_quorum_frac = ingest.cfg.min_participation_frac
        self.heartbeat_timeout_s = ingest.cfg.heartbeat_timeout_ms / 1e3

    def live_count(self) -> int:
        return self._arrived

    def live_frac(self) -> float:
        return self._arrived / max(self.num_workers, 1)

    def state_counts(self) -> dict:
        return {
            "arrived": self._arrived,
            "absent": self.num_workers - self._arrived,
        }

    def wait_for_quorum(self, timeout_s: float, poll_s: float = 0.01):
        return self._ingest.wait_for_participation(timeout_s, poll_s=poll_s)


class PopulationIngest:
    """Simulated transient-client population and the per-round cohort
    protocol (sample -> arrivals by deadline -> gauntlet -> stack).

    The simulation plants an orthonormal basis ``planted (d, k)``; honest
    clients submit ``QR(planted + noise * eps)`` (deterministic per
    ``(seed, round, client)``), and a :class:`~..utils.faults.
    ClientChaosPlan` assigns adversarial roles by population id range: NaN
    submitters, colluding poisoners (a shared sign-flipped basis orthogonal
    to the planted one, scaled by ``poison_scale``), and persistent
    stragglers. ``clock`` / ``sleep`` are injectable for deterministic
    tests.
    """

    def __init__(
        self,
        cfg,
        *,
        plan=None,
        metrics=None,
        supervisor=None,
        noise: float = 0.1,
        seed: int | None = None,
        gauntlet: bool = True,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if cfg.population is None:
            raise ValueError(
                "PopulationIngest needs cfg.population set (the "
                "simulated transient-client population size)"
            )
        from distributed_eigenspaces_tpu_torch.utils.faults import (
            ClientChaosPlan,
        )

        self.cfg = cfg
        self.plan = plan if plan is not None else ClientChaosPlan()
        self.metrics = metrics
        self.supervisor = supervisor
        self.noise = float(noise)
        #: gate the validation gauntlet: ``False`` is the UNHARDENED arm,
        #: every submitted summary enters the merge raw
        self.gauntlet = bool(gauntlet)
        self.seed = cfg.seed if seed is None else int(seed)
        self._clock = clock
        self._sleep = sleep
        self._round = 0
        self._pending_late: list[tuple[int, np.ndarray]] = []
        self.events: list[dict] = []
        d, k = cfg.dim, cfg.k
        rng = np.random.default_rng([self.seed, 0xBA515])
        q, _ = np.linalg.qr(rng.standard_normal((d, 2 * k)))
        #: the ground-truth basis honest clients estimate
        self.planted = np.ascontiguousarray(q[:, :k], np.float32)
        #: the colluders' shared target: sign-flipped, orthogonal to the
        #: planted subspace
        self.poison_basis = -np.ascontiguousarray(q[:, k: 2 * k], np.float32)
        p = cfg.population
        n_nan = int(round(p * self.plan.nan_frac))
        n_poison = int(round(p * self.plan.poison_frac))
        n_strag = int(round(p * self.plan.straggler_frac))
        self._nan_hi = n_nan
        self._poison_hi = n_nan + n_poison
        self._straggler_hi = n_nan + n_poison + n_strag

    # -- roles ---------------------------------------------------------------

    def role(self, client: int) -> str:
        if client < self._nan_hi:
            return "nan"
        if client < self._poison_hi:
            return "poison"
        if client < self._straggler_hi:
            return "straggler"
        return "honest"

    def contribution(self, rnd: int, client: int) -> np.ndarray:
        """The bytes client ``client`` submits for round ``rnd``."""
        d, k = self.cfg.dim, self.cfg.k
        role = self.role(client)
        if role == "nan":
            return np.full((d, k), np.nan, np.float32)
        if role == "poison":
            return np.asarray(
                self.plan.poison_scale * self.poison_basis, np.float32
            )
        rng = np.random.default_rng([self.seed, rnd, client])
        w = self.planted + self.noise * rng.standard_normal(
            (d, k)
        ).astype(np.float32)
        q, r = np.linalg.qr(w)
        # deterministic column signs (QR's are arbitrary): honest clients
        # estimating one subspace must agree on orientation
        q = q * np.sign(np.diag(r))[None, :]
        return np.ascontiguousarray(q, np.float32)

    # -- events --------------------------------------------------------------

    def _record(self, kind: str, rnd: int | None, **detail) -> None:
        ev = {"kind": kind, "round": rnd, **detail}
        self.events.append(ev)
        if self.metrics is not None:
            self.metrics.population(ev)

    def _quarantine(self, rnd: int, client: int, reason: str) -> None:
        self._record("quarantine_client", rnd, client=int(client), reason=reason)
        if self.supervisor is not None:
            self.supervisor.record(
                "quarantine_client", rnd, client=int(client), reason=reason,
            )

    # -- the round protocol --------------------------------------------------

    def expected_participation(self, rnd: int) -> float:
        """Expected arrival fraction for round ``rnd`` under the chaos plan:
        what the bounded participation wait probes."""
        return (1.0 - self.plan.dropout_at(rnd)) * (
            1.0 - self.plan.straggler_frac
        )

    @property
    def round(self) -> int:
        return self._round

    @property
    def late_pending(self) -> int:
        """Straggler contributions held for the next round's
        one-step-stale fold."""
        return len(self._pending_late)

    def run_round(self):
        """Execute one cohort round. Returns ``(t, stack, mask, rejected)``:
        the round number, the ``(cohort, d, k)`` float32 stack (zeros in
        absent slots), the arrival-and-valid mask, and the per-reason
        reject counts; or raises :class:`ParticipationLost` when arrivals
        miss the deadline floor (the round is consumed either way)."""
        cfg = self.cfg
        t = self._round + 1
        c, d, k = cfg.cohort_size, cfg.dim, cfg.k
        rng = np.random.default_rng([self.seed, t, 0xC0407])
        cohort = rng.choice(cfg.population, size=c, replace=False)
        drop_p = self.plan.dropout_at(t)
        dropped = rng.random(c) < drop_p
        # the PREVIOUS round's late arrivals, captured BEFORE this round's
        # stragglers are appended: a straggler is one-step-stale by
        # definition, never folded into its own round
        pending, self._pending_late = self._pending_late, []
        stack = np.zeros((c, d, k), np.float32)
        mask = np.zeros(c, np.float32)
        rejected: dict[str, int] = {}
        arrived = late = 0
        for slot, client in enumerate(map(int, cohort)):
            if dropped[slot]:
                continue
            if self.role(client) == "straggler":
                # misses the deadline: folds one-step-stale next round
                self._pending_late.append((client, self.contribution(t, client)))
                late += 1
                continue
            arrived += 1
            w = self.contribution(t, client)
            reason = validate_contribution(w, d, k) if self.gauntlet else None
            if reason is not None:
                rejected[reason] = rejected.get(reason, 0) + 1
                self._quarantine(t, client, reason)
                continue
            stack[slot] = w
            mask[slot] = 1.0
        participation = arrived / c
        self._round = t
        if participation < cfg.min_participation_frac:
            # the round their fold targeted is consumed with the collapse:
            # the previous round's late arrivals drop loudly rather than
            # fold arbitrarily stale later
            for client, _w in pending:
                self._record("late_dropped", t, client=int(client))
            self._record(
                "participation_lost", t, arrived=arrived, sampled=c,
                frac=round(participation, 4),
                required=cfg.min_participation_frac,
            )
            raise ParticipationLost(_ParticipationView(self, arrived), t)
        # fold the PREVIOUS round's late arrivals one-step-stale into this
        # round's empty slots; overflow is dropped loudly
        stale = 0
        free = [i for i in range(c) if mask[i] == 0.0]
        for client, w in pending:
            reason = validate_contribution(w, d, k) if self.gauntlet else None
            if reason is not None:
                rejected[reason] = rejected.get(reason, 0) + 1
                self._quarantine(t, client, reason)
                continue
            if not free:
                self._record("late_dropped", t, client=int(client))
                continue
            slot = free.pop()
            stack[slot] = w
            mask[slot] = 1.0
            stale += 1
        self._record(
            "round_closed", t, sampled=c, arrived=arrived,
            valid=int(mask.sum()), late=late, stale=stale,
            rejects=dict(rejected), participation=round(participation, 4),
        )
        return t, stack, mask, rejected

    def wait_for_participation(self, timeout_s: float, poll_s: float = 0.01) -> bool:
        """Bounded wait for participation to return. The wait CONSUMES
        rounds: while an outage wave lasts, cohorts keep failing, so each
        poll probes the NEXT round's expected participation and advances
        past it if still under the floor. True once a round clears
        ``min_participation_frac``; False at timeout."""
        deadline = self._clock() + timeout_s
        while True:
            nxt = self._round + 1
            frac = self.expected_participation(nxt)
            if frac >= self.cfg.min_participation_frac:
                self._record("participation_restored", nxt, expected=round(frac, 4))
                return True
            if self._clock() >= deadline:
                return False
            self._sleep(poll_s)
            self._round = nxt  # the wave ate this round too


def population_fit(
    cfg,
    *,
    plan=None,
    rounds: int | None = None,
    metrics=None,
    supervisor=None,
    hardened: bool = True,
    gauntlet: bool | None = None,
    noise: float = 0.1,
    seed: int | None = None,
    max_resumes: int = 2,
    participation_wait_s: float | None = None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    device="cuda",
):
    """Run a population-scale fit on ``device``: ``rounds`` sampled-cohort
    rounds of gauntlet -> hardened merge -> online fold, under the
    supervision arc (participation collapse -> bounded wait -> resume under
    ``max_resumes``).

    ``hardened=False`` runs the UNHARDENED arm: the raw mean of every
    submitted summary, no gauntlet, no clip / trim / screen. Returns ``(w,
    info, sup)``: the final ``(d, k)`` basis (numpy), a run-info dict
    (rounds completed, resumes, reject totals, per-round participation) and
    the supervisor with its ledger.
    """
    import torch

    from distributed_eigenspaces_tpu_torch.algo.online import (
        OnlineState,
        update_state,
    )
    from distributed_eigenspaces_tpu_torch.device import resolve_device
    from distributed_eigenspaces_tpu_torch.ops.linalg import top_k_eigvecs
    from distributed_eigenspaces_tpu_torch.runtime.supervisor import (
        Supervisor,
        SupervisorError,
    )

    dev = resolve_device(device)
    sup = supervisor or Supervisor(cfg, metrics=metrics)
    if gauntlet is None:
        gauntlet = hardened
    ingest = PopulationIngest(
        cfg, plan=plan, metrics=metrics, supervisor=sup, noise=noise,
        seed=seed, gauntlet=gauntlet, clock=clock, sleep=sleep,
    )
    if rounds is None:
        rounds = cfg.num_steps
    merge = make_population_merge(cfg, device=dev) if hardened else None
    state = OnlineState.initial(cfg.dim, device=dev)
    resumes = completed = 0
    participations: list[float] = []
    while completed < rounds:
        try:
            t, stack, mask, _rejected = ingest.run_round()
        except ParticipationLost as pl:
            sup.record(
                "participation_lost", pl.step, arrived=pl.live,
                frac=round(pl.frac, 4), required=pl.required,
            )
            if resumes >= max_resumes:
                raise SupervisorError(
                    f"{pl} — {resumes} auto-resumes exhausted", sup.ledger,
                ) from pl
            wait_s = (
                participation_wait_s
                if participation_wait_s is not None
                else max(1.0, 20.0 * pl.table.heartbeat_timeout_s)
            )
            if not pl.table.wait_for_quorum(wait_s):
                raise SupervisorError(
                    f"participation not restored within {wait_s:.1f}s "
                    f"after {pl}",
                    sup.ledger,
                ) from pl
            resumes += 1
            sup.record(
                "resume", ingest.round, reason="participation_restored",
                attempt=resumes,
            )
            continue
        participations.append(float(mask.sum()) / cfg.cohort_size)
        stack_dev = torch.from_numpy(stack).to(dev)
        mask_dev = torch.from_numpy(mask).to(dev)
        if hardened:
            v, keep, stats = merge(stack_dev, mask_dev)
            keep_np = keep.cpu().numpy()
            screened = [
                i for i in range(cfg.cohort_size)
                if mask[i] > 0 and keep_np[i] == 0
            ]
            for slot in screened:
                ingest._quarantine(t, -1 - slot, "screened")
            if metrics is not None:
                metrics.population({
                    "kind": "merge", "round": t,
                    "kept": int(float(stats["kept"])),
                    "trim_frac": round(float(stats["trim_frac"]), 4),
                    "screen_fallback": bool(float(stats["screen_fallback"])),
                })
        else:
            v = naive_mean_basis(stack_dev, mask_dev, cfg.k)
        state = update_state(state, v, discount=cfg.discount, num_steps=rounds)
        completed += 1
    w = top_k_eigvecs(state.sigma_tilde, cfg.k).cpu().numpy()
    # reject totals come from the quarantine trail, not the per-round
    # return values: a collapsed round's gauntlet rejects were ledgered
    # before ParticipationLost fired, and "every reject attributed, counts
    # equal" must hold across collapses too
    reject_totals: dict[str, int] = {}
    for ev in ingest.events:
        if ev["kind"] == "quarantine_client":
            reject_totals[ev["reason"]] = reject_totals.get(ev["reason"], 0) + 1
    info = {
        "rounds": completed,
        "resumes": resumes,
        "rejects": reject_totals,
        "participation": participations,
        "planted": ingest.planted,
        "events": ingest.events,
    }
    return w, info, sup
