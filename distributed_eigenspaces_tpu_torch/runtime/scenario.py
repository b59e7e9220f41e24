"""Scenario harness: production-shaped trace replay with a pure-telemetry
SLO verdict.

The port's copy of ``distributed_eigenspaces_tpu/runtime/scenario.py``.
The spec schema, its validation messages, the schedule and the verdict are
the reference's, word for word. The replay runs on ``device`` (the card
unless the caller asks for the CPU): the fit, the server's projections,
the fleet's buckets, the churn fit, the population merge and the drift
refit all take it explicitly, whichever thread launches them.

Random bits: the schedule draws from ``np.random.Generator`` only, so it is
identical across the two packages. The reference draws the replay's fit
rows, query payloads and tenant blocks with ``jax.random``; the port draws
them from numpy generators with the same seed arithmetic
(``default_rng(seed)`` for the fit, ``default_rng(seed * 1009 + i)`` for
episode ``i``'s queries, ``default_rng(seed * 31 + rank)`` for tenant
``rank``, ``default_rng(seed + 3)`` for a churn fit), one draw per query or
step in the reference's order. Same seeds, other bits: replays agree in
structure (gates, keys, planned requests), not in payload values.

Every chaos bench exercises ONE failure mode against ONE tier; the
ROADMAP's "millions of users" claim needs the composition — a flash
crowd landing while a churn-triggered refit compiles, a registry
publish mid-burst, tenant skew piling onto one fleet signature. This
module replays that shape from a declarative JSON spec: named episodes
on a shared timeline, seeded and deterministic, each episode driving an
EXISTING surface (``QueryServer.submit``, ``FleetServer.submit``,
``registry.publish``, ``DriftMonitor`` via served batches,
``ElasticStream`` + ``ChurnPlan`` for the fit tier, and
``QueryServer(fault_hook=...)`` via ``ServeChaosHook``) — the scenario
engine owns NO injection path of its own.

The verdict layer is the observability core: each episode is bracketed
by ``Tracer.episode`` markers, and judgment is computed exclusively
from ``MetricsLogger.summary()`` — per-episode SLO attainment and
error-budget burn, p99 latency decomposition
(queue_wait/compile_stall/compute), shed/breaker/lane-restart counts,
and recovery time from each injected fault back to SLO-attaining
steady state (``summary()["episodes"]``, utils/metrics.py). The
runner's own bookkeeping (tickets submitted/resolved) feeds the hard
gates only, never the judged numbers.

Spec schema (docs/OBSERVABILITY.md "Scenario verdicts")::

    {
      "name": "ci_smoke",
      "seed": 7,
      "slo_p99_ms": 400.0,            # optional; structural default
      "config": {"dim": 32, "k": 3},  # optional PCAConfig overrides
      "episodes": [
        {"name": "...", "kind": "<kind>", "start_s": 0.0,
         "duration_s": 0.5, ...kind fields...},
      ]
    }

Episode taxonomy (kind → required fields):

- ``steady``      — ``qps``: constant-rate query load.
- ``diurnal``     — ``qps_low, qps_high, period_s``: sinusoidal qps
  cycle (arrivals by fixed-grid intensity integration — deterministic,
  no rng).
- ``flash_crowd`` — ``qps``: a burst well above steady capacity;
  optional ``kill_lane_at_batch`` arms a ``ServeChaosHook`` lane kill
  mid-crowd. Counts as a FAULT episode (recovery measured).
- ``drift``       — ``qps``: queries drawn from a ROTATED spectrum so
  the served basis stops explaining them — ``DriftMonitor`` arms a
  background refit. FAULT episode.
- ``tenant_skew`` — ``qps, tenants, zipf_s``: fleet fit requests with
  Zipf(s)-distributed tenant ranks; each rank is a distinct
  ``FleetServer`` signature (different ``num_steps``), so the skew is
  skew over compiled programs, not just payloads.
- ``churn``       — ``workers, kill_slots, kill_step``: an elastic fit
  (``ElasticStream`` + ``MembershipTable``) runs in the background
  with a ``ChurnPlan`` killing the listed slots; optional
  ``rejoin_step`` brings them back, optional ``publish: true``
  publishes the churned fit's basis to the live registry when done
  (the cross-tier refit-during-traffic composition).
- ``publish``     — one mid-burst ``registry.publish`` at ``start_s``
  (hot-swap under load). Optional ``replicas: N`` runs the replay
  against the DURABLE registry with N ``ReplicaRegistry`` tailers
  and gates that the published version reaches every
  replica inside ``replica_staleness_ms``; optional
  ``kill_publisher: true`` kills the publisher lease mid-burst
  (renewals stop, TTL lapses) so a standby must take over at epoch+1
  through the lease-file protocol before the publish lands.

Malformed specs fail LOUDLY at load time with the offending episode and
field named in the ValueError — never at minute three of a replay.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from typing import Any

import numpy as np

__all__ = [
    "EPISODE_KINDS",
    "Episode",
    "ScenarioSpec",
    "ScenarioSchedule",
    "ScenarioRunner",
    "build_schedule",
    "load_spec",
    "run_scenario",
]

#: episode kinds that stress the serve tier hard enough that recovery
#: back to SLO-attaining steady state is a measured verdict field
FAULT_KINDS = ("flash_crowd", "drift")

#: kind → (required fields, optional fields); common fields
#: (name/kind/start_s/duration_s) validated separately
EPISODE_KINDS: dict[str, tuple[tuple[str, ...], tuple[str, ...]]] = {
    "steady": (("qps",), ("rows",)),
    "diurnal": (("qps_low", "qps_high", "period_s"), ("rows",)),
    "flash_crowd": (("qps",), ("rows", "kill_lane_at_batch")),
    "drift": (("qps",), ("rows",)),
    "tenant_skew": (("qps", "tenants", "zipf_s"), ()),
    "churn": (
        ("workers", "kill_slots", "kill_step"),
        ("rejoin_step", "steps", "publish", "tier"),
    ),
    "publish": ((), ("replicas", "kill_publisher")),
    "population": (
        ("population", "cohort_size"),
        ("dropout_frac", "poison_frac", "rounds",
         "min_participation_frac", "max_poison_frac"),
    ),
}

_COMMON = ("name", "kind", "start_s", "duration_s")

#: serve-tier load episodes (generate QueryServer.submit arrivals)
_SERVE_LOAD = ("steady", "diurnal", "flash_crowd", "drift")


@dataclasses.dataclass(frozen=True)
class Episode:
    """One named episode on the shared scenario timeline."""

    name: str
    kind: str
    start_s: float
    duration_s: float
    #: kind-specific fields, already validated against EPISODE_KINDS
    params: dict

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s

    @property
    def fault(self) -> bool:
        return self.kind in FAULT_KINDS


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A validated scenario: what :func:`load_spec` returns."""

    name: str
    seed: int
    episodes: tuple[Episode, ...]
    #: PCAConfig override fields for the serve-tier stack
    config: dict
    slo_p99_ms: float | None

    @property
    def horizon_s(self) -> float:
        return max(ep.end_s for ep in self.episodes)


def _fail(spec_name: str, msg: str) -> None:
    raise ValueError(f"scenario spec '{spec_name}': {msg}")


def _validate_episode(spec_name: str, i: int, raw: Any) -> Episode:
    """One episode dict → :class:`Episode`, every failure naming the
    episode AND the offending field."""
    if not isinstance(raw, dict):
        _fail(spec_name, f"episode #{i} must be an object, got "
                         f"{type(raw).__name__}")
    name = raw.get("name")
    label = f"episode '{name}'" if name else f"episode #{i}"
    for field in _COMMON:
        if field not in raw:
            _fail(spec_name, f"{label}: missing required field '{field}'")
    if not isinstance(name, str) or not name:
        _fail(spec_name, f"{label}: field 'name' must be a non-empty "
                         f"string, got {raw['name']!r}")
    kind = raw["kind"]
    if kind not in EPISODE_KINDS:
        _fail(
            spec_name,
            f"{label}: field 'kind' must be one of "
            f"{sorted(EPISODE_KINDS)}, got {kind!r}",
        )
    for field in ("start_s", "duration_s"):
        v = raw[field]
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            _fail(spec_name, f"{label}: field '{field}' must be a "
                             f"number >= 0, got {v!r}")
    required, optional = EPISODE_KINDS[kind]
    params = {k: v for k, v in raw.items() if k not in _COMMON}
    for field in required:
        if field not in params:
            _fail(spec_name, f"{label}: missing required field "
                             f"'{field}' for kind '{kind}'")
    allowed = set(required) | set(optional)
    for field in params:
        if field not in allowed:
            _fail(
                spec_name,
                f"{label}: unknown field '{field}' for kind '{kind}' "
                f"(allowed: {sorted(allowed)})",
            )
    for field in ("qps", "qps_low", "qps_high", "period_s", "zipf_s"):
        if field in params:
            v = params[field]
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v <= 0:
                _fail(spec_name, f"{label}: field '{field}' must be a "
                                 f"number > 0, got {v!r}")
    if kind == "diurnal" and params["qps_high"] < params["qps_low"]:
        _fail(spec_name, f"{label}: field 'qps_high' must be >= "
                         f"'qps_low'")
    if kind == "tenant_skew":
        t = params["tenants"]
        if not isinstance(t, int) or isinstance(t, bool) or t < 1:
            _fail(spec_name, f"{label}: field 'tenants' must be an "
                             f"int >= 1, got {t!r}")
    if kind == "churn":
        w = params["workers"]
        if not isinstance(w, int) or isinstance(w, bool) or w < 2:
            _fail(spec_name, f"{label}: field 'workers' must be an "
                             f"int >= 2, got {w!r}")
        ks = params["kill_slots"]
        if (not isinstance(ks, list) or not ks
                or any(not isinstance(s, int) or s < 0 or s >= w
                       for s in ks)):
            _fail(
                spec_name,
                f"{label}: field 'kill_slots' must be a non-empty "
                f"list of slot ids in [0, {w}), got {ks!r}",
            )
        tier = params.get("tier")
        if tier is not None and (not isinstance(tier, str) or not tier):
            _fail(spec_name, f"{label}: field 'tier' must be a non-"
                             f"empty tier name, got {tier!r}")
    if kind == "publish":
        r = params.get("replicas")
        if r is not None and (
            not isinstance(r, int) or isinstance(r, bool) or r < 1
        ):
            _fail(spec_name, f"{label}: field 'replicas' must be an "
                             f"int >= 1, got {r!r}")
        kp = params.get("kill_publisher")
        if kp is not None and not isinstance(kp, bool):
            _fail(spec_name, f"{label}: field 'kill_publisher' must "
                             f"be a bool, got {kp!r}")
        if kp and not r:
            _fail(
                spec_name,
                f"{label}: field 'kill_publisher' requires field "
                f"'replicas' (lease failover only exists on the "
                f"replicated durable registry)",
            )
    if kind == "population":
        p = params["population"]
        if not isinstance(p, int) or isinstance(p, bool) or p < 2:
            _fail(spec_name, f"{label}: field 'population' must be an "
                             f"int >= 2, got {p!r}")
        c = params["cohort_size"]
        if not isinstance(c, int) or isinstance(c, bool) or c < 1 \
                or c > p:
            _fail(
                spec_name,
                f"{label}: field 'cohort_size' must be an int in "
                f"[1, population={p}], got {c!r}",
            )
        for field in ("dropout_frac", "poison_frac",
                      "min_participation_frac", "max_poison_frac"):
            v = params.get(field)
            if v is not None and (
                not isinstance(v, (int, float)) or isinstance(v, bool)
                or not 0.0 <= v < 1.0
            ):
                _fail(spec_name, f"{label}: field '{field}' must be a "
                                 f"number in [0, 1), got {v!r}")
        r = params.get("rounds")
        if r is not None and (
            not isinstance(r, int) or isinstance(r, bool) or r < 1
        ):
            _fail(spec_name, f"{label}: field 'rounds' must be an "
                             f"int >= 1, got {r!r}")
    if kind in _SERVE_LOAD and raw["duration_s"] <= 0:
        _fail(spec_name, f"{label}: field 'duration_s' must be > 0 "
                         f"for load kind '{kind}'")
    return Episode(
        name=name, kind=kind, start_s=float(raw["start_s"]),
        duration_s=float(raw["duration_s"]), params=params,
    )


def _validate_churn_topology(
    spec_name: str, episodes: tuple[Episode, ...], config: dict
) -> None:
    """Cross-check churn episodes against the spec config's
    ``merge_topology``: a 'tier' that names no topology tier,
    a fleet the tree doesn't cover, or kill_slots beyond the tier's
    member count must all fail AT SPEC-LOAD TIME — not as a trainer
    build error half-way through a replay."""
    topo_raw = config.get("merge_topology")
    tiers: tuple[tuple[str, int], ...] | None = None
    if topo_raw is not None:
        try:
            tiers = tuple((str(n), int(f)) for n, f in topo_raw)
        except (TypeError, ValueError):
            _fail(
                spec_name,
                f"field 'config.merge_topology' must be a list of "
                f"[name, fan_in] pairs, got {topo_raw!r}",
            )
    names = tuple(n for n, _ in tiers) if tiers else ()
    for ep in episodes:
        if ep.kind != "churn":
            continue
        label = f"episode '{ep.name}'"
        w = int(ep.params["workers"])
        if tiers is not None:
            product = 1
            for _, f in tiers:
                product *= f
            if product != w:
                _fail(
                    spec_name,
                    f"{label}: field 'workers' ({w}) must equal the "
                    f"merge_topology fan-in product {product} "
                    f"({dict(tiers)}) — the tree must cover the "
                    f"churned fleet exactly",
                )
        tier = ep.params.get("tier")
        if tier is None:
            continue  # default: leaf worker churn
        if tiers is None:
            _fail(
                spec_name,
                f"{label}: field 'tier' is {tier!r} but the spec "
                f"config has no 'merge_topology' — a flat fleet has "
                f"only the leaf worker tier (omit 'tier')",
            )
        if tier not in names:
            _fail(
                spec_name,
                f"{label}: field 'tier' {tier!r} is not a "
                f"merge_topology tier (have {list(names)})",
            )
        members = w
        for _, f in tiers[: names.index(tier)]:
            members //= f
        bad = sorted(s for s in ep.params["kill_slots"] if s >= members)
        if bad:
            _fail(
                spec_name,
                f"{label}: kill_slots {bad} out of range for tier "
                f"{tier!r} — it has {members} members (slot ids are "
                f"TIER-member indices, not worker indices)",
            )


def load_spec(source: Any) -> ScenarioSpec:
    """Parse + validate a scenario spec from a dict or a JSON file
    path. Every rejection is a loud ValueError naming the offending
    episode and field."""
    if isinstance(source, (str, bytes)):
        with open(source) as f:
            raw = json.load(f)
    else:
        raw = source
    if not isinstance(raw, dict):
        raise ValueError(
            f"scenario spec must be an object, got {type(raw).__name__}"
        )
    name = raw.get("name")
    if not isinstance(name, str) or not name:
        raise ValueError(
            f"scenario spec: field 'name' must be a non-empty string, "
            f"got {name!r}"
        )
    seed = raw.get("seed", 0)
    if not isinstance(seed, int) or isinstance(seed, bool):
        _fail(name, f"field 'seed' must be an int, got {seed!r}")
    episodes_raw = raw.get("episodes")
    if not isinstance(episodes_raw, list) or not episodes_raw:
        _fail(name, "field 'episodes' must be a non-empty list")
    episodes = tuple(
        _validate_episode(name, i, ep) for i, ep in enumerate(episodes_raw)
    )
    seen: set[str] = set()
    for ep in episodes:
        if ep.name in seen:
            _fail(name, f"episode '{ep.name}': duplicate episode name")
        seen.add(ep.name)
    config = raw.get("config", {})
    if not isinstance(config, dict):
        _fail(name, f"field 'config' must be an object, got "
                    f"{type(config).__name__}")
    slo = raw.get("slo_p99_ms")
    if slo is not None and (
        not isinstance(slo, (int, float)) or isinstance(slo, bool)
        or slo <= 0
    ):
        _fail(name, f"field 'slo_p99_ms' must be a number > 0, "
                    f"got {slo!r}")
    extra = set(raw) - {"name", "seed", "episodes", "config", "slo_p99_ms"}
    if extra:
        _fail(name, f"unknown top-level field(s): {sorted(extra)}")
    _validate_churn_topology(name, episodes, config)
    return ScenarioSpec(
        name=name, seed=seed, episodes=episodes, config=dict(config),
        slo_p99_ms=float(slo) if slo is not None else None,
    )


# -- deterministic schedule ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Action:
    """One timed replay action: sorted by ``t_s`` on the shared
    timeline. ``kind`` ∈ episode_start / episode_end / query /
    fleet_fit / publish / churn_start."""

    t_s: float
    episode: str
    kind: str
    index: int = 0
    tenant: int = 0


@dataclasses.dataclass(frozen=True)
class ScenarioSchedule:
    """The precomputed, fully deterministic replay plan: same spec +
    seed ⇒ identical actions (tested in tests/test_scenario.py)."""

    spec: ScenarioSpec
    actions: tuple[Action, ...]

    def describe(self) -> dict:
        """JSON-able digest of the schedule — the determinism
        contract's comparison artifact."""
        per_ep: dict[str, dict] = {}
        for ep in self.spec.episodes:
            arrivals = [
                round(a.t_s, 9) for a in self.actions
                if a.episode == ep.name and a.kind in ("query", "fleet_fit")
            ]
            per_ep[ep.name] = {
                "kind": ep.kind,
                "start_s": ep.start_s,
                "duration_s": ep.duration_s,
                "planned_requests": len(arrivals),
                "arrivals": arrivals,
                "tenants": [
                    a.tenant for a in self.actions
                    if a.episode == ep.name and a.kind == "fleet_fit"
                ],
            }
        return {
            "scenario": self.spec.name,
            "seed": self.spec.seed,
            "horizon_s": self.spec.horizon_s,
            "episodes": per_ep,
        }


def _zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def _episode_arrivals(ep: Episode, rng: np.random.Generator) -> list[float]:
    """Arrival offsets (seconds from episode start), deterministic."""
    if ep.kind == "diurnal":
        lo, hi = float(ep.params["qps_low"]), float(ep.params["qps_high"])
        period = float(ep.params["period_s"])
        # integrate the sinusoidal intensity (lo at cycle start, hi at
        # mid-cycle) on a fine fixed grid and emit an arrival at every
        # integer crossing of the cumulative count — deterministic, no
        # rng, and free of the aliasing an inverse-rate step suffers
        # when one low-rate gap jumps the whole high-rate half of a
        # cycle
        dt = max(1e-4, min(period, ep.duration_s) / 512.0)
        t, acc, out = 0.0, 0.0, []
        while t < ep.duration_s:
            rate = lo + (hi - lo) * 0.5 * (
                1.0 - math.cos(2.0 * math.pi * t / period)
            )
            acc += rate * dt
            while acc >= 1.0:
                acc -= 1.0
                out.append(t)
            t += dt
        return out
    qps = float(ep.params["qps"])
    n = max(1, int(round(qps * ep.duration_s)))
    return sorted(
        float(v) for v in rng.uniform(0.0, ep.duration_s, size=n)
    )


def build_schedule(spec: ScenarioSpec) -> ScenarioSchedule:
    """Expand the spec into the sorted deterministic action list. All
    randomness comes from ``default_rng([seed, episode_index])`` — the
    schedule is a pure function of (spec, seed)."""
    actions: list[Action] = []
    for i, ep in enumerate(spec.episodes):
        actions.append(Action(ep.start_s, ep.name, "episode_start"))
        actions.append(Action(ep.end_s, ep.name, "episode_end"))
        rng = np.random.default_rng([spec.seed, i])
        if ep.kind in _SERVE_LOAD:
            for j, off in enumerate(_episode_arrivals(ep, rng)):
                actions.append(
                    Action(ep.start_s + off, ep.name, "query", index=j)
                )
        elif ep.kind == "tenant_skew":
            offsets = _episode_arrivals(ep, rng)
            tenants = rng.choice(
                int(ep.params["tenants"]),
                size=len(offsets),
                p=_zipf_weights(
                    int(ep.params["tenants"]), float(ep.params["zipf_s"])
                ),
            )
            for j, (off, tenant) in enumerate(zip(offsets, tenants)):
                actions.append(
                    Action(
                        ep.start_s + off, ep.name, "fleet_fit",
                        index=j, tenant=int(tenant),
                    )
                )
        elif ep.kind == "churn":
            actions.append(Action(ep.start_s, ep.name, "churn_start"))
        elif ep.kind == "population":
            actions.append(Action(ep.start_s, ep.name, "population_start"))
        elif ep.kind == "publish":
            actions.append(Action(ep.start_s, ep.name, "publish"))
    # stable order: time, then a fixed kind priority so start markers
    # precede same-instant work and end markers follow it
    prio = {
        "episode_start": 0, "churn_start": 1, "population_start": 1,
        "publish": 2, "query": 3, "fleet_fit": 3, "episode_end": 4,
    }
    actions.sort(key=lambda a: (a.t_s, prio[a.kind], a.episode, a.index))
    return ScenarioSchedule(spec=spec, actions=tuple(actions))


# -- runner -------------------------------------------------------------------


def _scenario_cfg(spec: ScenarioSpec):
    """Serve-tier PCAConfig: small defaults, overridable per spec (the
    spec's 'config' block wins)."""
    from distributed_eigenspaces_tpu_torch.config import PCAConfig

    base = dict(
        dim=32, k=3, num_workers=4, rows_per_worker=16, num_steps=4,
        backend="local", solver="eigh",
        serve_bucket_size=4, serve_flush_s=0.02,
        serve_queue_depth=64, serve_breaker_threshold=4,
        heartbeat_timeout_ms=100.0, round_deadline_ms=40.0,
        min_quorum_frac=0.5,
    )
    base.update(spec.config)
    return PCAConfig(**base)


class ScenarioRunner:
    """Replays one :class:`ScenarioSpec` against the full stack and
    computes the pure-telemetry verdict. Construct once, ``run()``
    once."""

    def __init__(
        self, spec: ScenarioSpec, *, trace_out: str | None = None,
        controller: bool = False, plan: dict | None = None,
        device="cuda",
    ):
        from distributed_eigenspaces_tpu_torch.device import resolve_device

        self.spec = spec
        #: where every tensor of the replay lives, whichever thread makes it
        self.device = resolve_device(device)
        self.trace_out = trace_out
        #: controller on/off is a RUNNER parameter, not a spec field —
        #: the A/B bench replays the SAME spec both ways (the spec's
        #: ``config`` block may still tune ``controller_window_s``)
        self.controller = controller
        #: optional plan-v1 dict whose serve overrides the controller
        #: rolls out (one knob per window, observe + rollback)
        self.plan = plan
        self.schedule = build_schedule(spec)
        # runner bookkeeping — feeds the hard gates only, never the
        # judged telemetry fields
        self.submitted = 0
        self.shed_at_submit = 0
        self.shed_at_result = 0
        self.resolved = 0
        self.failed = 0
        self.fleet_submitted = 0
        self.fleet_shed = 0
        self.fleet_resolved = 0
        self.fleet_failed = 0
        self.publishes = 0
        self.publisher_failovers = 0
        #: publish-episode name → did the version reach every replica
        #: inside the staleness-derived window
        self.replica_converged: dict[str, bool] = {}

    # -- payload generators --------------------------------------------------

    def _query_payloads(self, spectrum, drift_spectrum):
        """Per-episode deterministic query arrays: serve-load episodes
        sample the fitted spectrum; drift episodes sample the ROTATED
        one (so the live basis stops explaining them and the monitor
        arms). Numpy draws, one generator an episode."""
        payloads: dict[str, list[np.ndarray]] = {}
        for i, ep in enumerate(self.spec.episodes):
            if ep.kind not in _SERVE_LOAD:
                continue
            n = sum(
                1 for a in self.schedule.actions
                if a.episode == ep.name and a.kind == "query"
            )
            rows = int(ep.params.get("rows", 4))
            src = drift_spectrum if ep.kind == "drift" else spectrum
            rng = np.random.default_rng(self.spec.seed * 1009 + i)
            eps_payloads = [
                np.asarray(src.sample(rng, rows), np.float32)
                for _ in range(n)
            ]
            payloads[ep.name] = eps_payloads
        return payloads

    def _tenant_fleet(self, metrics):
        """FleetServer + per-rank tenant configs/problems for the
        tenant_skew episodes: each rank is a DISTINCT signature
        (different num_steps), so Zipf skew lands on compiled
        programs."""
        import dataclasses

        from distributed_eigenspaces_tpu_torch.config import PCAConfig
        from distributed_eigenspaces_tpu_torch.data.synthetic import (
            planted_spectrum,
        )
        from distributed_eigenspaces_tpu_torch.parallel.fleet import FleetServer

        skew_eps = [
            ep for ep in self.spec.episodes if ep.kind == "tenant_skew"
        ]
        if not skew_eps:
            return None, [], []
        n_tenants = max(int(ep.params["tenants"]) for ep in skew_eps)
        cfg0 = _scenario_cfg(self.spec)
        base = PCAConfig(
            dim=cfg0.dim, k=cfg0.k, num_workers=2, rows_per_worker=8,
            num_steps=2, backend="local", solver="subspace",
            subspace_iters=6, fleet_bucket_size=2, fleet_flush_s=0.05,
            serve_queue_depth=cfg0.serve_queue_depth,
        )
        cfgs = [
            dataclasses.replace(base, num_steps=2 + rank)
            for rank in range(n_tenants)
        ]
        spec_fleet = planted_spectrum(
            base.dim, k_planted=base.k, gap=20.0, noise=0.01,
            seed=self.spec.seed + 101,
        )
        problems = []
        for rank, cfg in enumerate(cfgs):
            rng = np.random.default_rng(self.spec.seed * 31 + rank)
            blocks = []
            for t in range(cfg.num_steps):
                blocks.append(
                    np.asarray(
                        spec_fleet.sample(
                            rng, cfg.num_workers * cfg.rows_per_worker
                        )
                    ).reshape(cfg.num_workers, cfg.rows_per_worker,
                              cfg.dim)
                )
            problems.append(np.stack(blocks))
        server = FleetServer(
            base, mesh=None, metrics=metrics, device=self.device,
        )
        return server, cfgs, problems

    def _churn_thread(self, ep: Episode, spectrum, metrics):
        """One churn episode's background elastic fit: ChurnPlan +
        MembershipTable + ElasticStream, reused verbatim, on the
        replay's device. A 'tier' param (validated at spec load)
        re-targets the churn: a non-leaf tier's kills/rejoins drive a
        TierSet + TieredStream instead of the leaf plan, so the episode
        exercises the per-tier deadline/quorum path. Returns
        (thread, result holder)."""
        import dataclasses

        from distributed_eigenspaces_tpu_torch.data.stream import block_stream
        from distributed_eigenspaces_tpu_torch.parallel.topology import (
            resolve_topology,
        )
        from distributed_eigenspaces_tpu_torch.runtime.membership import (
            ElasticStream,
            MembershipTable,
        )
        from distributed_eigenspaces_tpu_torch.runtime.supervisor import (
            supervised_fit,
        )
        from distributed_eigenspaces_tpu_torch.runtime.tiers import (
            TierSet,
            TieredStream,
        )
        from distributed_eigenspaces_tpu_torch.utils.faults import ChurnPlan

        dev = self.device
        cfg0 = _scenario_cfg(self.spec)
        m = int(ep.params["workers"])
        steps = int(ep.params.get("steps", 8))
        cfg = dataclasses.replace(
            cfg0, num_workers=m, rows_per_worker=8, num_steps=steps,
        )
        n = cfg.rows_per_worker
        data = np.asarray(
            spectrum.sample(
                np.random.default_rng(self.spec.seed + 3), m * n * steps
            )
        )
        kill_step = int(ep.params["kill_step"])
        plan_kw: dict = {"kill_at": {kill_step: list(ep.params["kill_slots"])}}
        if ep.params.get("rejoin_step") is not None:
            plan_kw["rejoin_at"] = {
                int(ep.params["rejoin_step"]): list(ep.params["kill_slots"])
            }
        churn = ChurnPlan(**plan_kw)
        table = MembershipTable(
            m, heartbeat_timeout_ms=cfg.heartbeat_timeout_ms,
            min_quorum_frac=cfg.min_quorum_frac, metrics=metrics,
        )
        metrics.attach_membership(table)
        topo = resolve_topology(cfg)
        tier = ep.params.get("tier")
        tier_nonleaf = (
            topo is not None and tier is not None and tier != topo.names[0]
        )
        tiers = (
            TierSet(topo, cfg, churn={tier: churn}, metrics=metrics)
            if tier_nonleaf else None
        )
        holder: dict = {}

        def factory(start_row):
            raw = block_stream(
                data, num_workers=m, rows_per_worker=n,
                start_row=start_row, device=dev,
            )
            es = ElasticStream(
                raw, table, cfg,
                # a non-leaf tier's churn drives the TierSet, not the
                # leaf plan — slot ids there are TIER-member indices
                churn=None if tier_nonleaf else churn,
                first_step=start_row // (m * n) + 1, metrics=metrics,
                device=dev,
            )
            if tiers is not None:
                return TieredStream(es, tiers)
            return es

        def work():
            try:
                w, st, _sup = supervised_fit(
                    factory, cfg, metrics=metrics, membership=table,
                    device=dev,
                )
                holder["w"] = w.cpu().numpy()
                holder["step"] = int(st.step)
            except Exception as e:  # surfaced in the verdict's gates
                holder["error"] = f"{type(e).__name__}: {e}"

        return threading.Thread(target=work, daemon=True), holder

    def _population_thread(self, ep: Episode, metrics):
        """One population episode's background cohort-sampled ingest:
        ClientChaosPlan + population_fit, reused verbatim, merging on
        the replay's device. The verdict judges it purely from
        ``summary()["population"]`` (rounds closed, rejects attributed)
        plus the holder's recovery angle. Returns (thread, holder)."""
        import dataclasses

        import torch

        from distributed_eigenspaces_tpu_torch.ops.linalg import (
            principal_angles_degrees,
        )
        from distributed_eigenspaces_tpu_torch.runtime.population import (
            population_fit,
        )
        from distributed_eigenspaces_tpu_torch.utils.faults import (
            ClientChaosPlan,
        )

        cfg0 = _scenario_cfg(self.spec)
        cfg = dataclasses.replace(
            cfg0,
            population=int(ep.params["population"]),
            cohort_size=int(ep.params["cohort_size"]),
            min_participation_frac=float(
                ep.params.get("min_participation_frac", 0.5)
            ),
            max_poison_frac=float(
                ep.params.get("max_poison_frac", 0.08)
            ),
        )
        plan = ClientChaosPlan(
            dropout_frac=float(ep.params.get("dropout_frac", 0.0)),
            poison_frac=float(ep.params.get("poison_frac", 0.0)),
            poison_scale=3.0,
        )
        rounds = int(ep.params.get("rounds", 4))
        holder: dict = {}

        def work():
            try:
                w, info, _sup = population_fit(
                    cfg, plan=plan, rounds=rounds, metrics=metrics,
                    seed=self.spec.seed, device=self.device,
                )
                q, _ = np.linalg.qr(np.asarray(w))
                holder["angle_deg"] = float(
                    torch.max(
                        principal_angles_degrees(
                            torch.from_numpy(q[:, : cfg.k]),
                            torch.from_numpy(info["planted"]),
                        )
                    )
                )
                holder["rounds"] = info["rounds"]
                holder["rejects"] = info["rejects"]
            except Exception as e:  # surfaced in the verdict's gates
                holder["error"] = f"{type(e).__name__}: {e}"

        return threading.Thread(target=work, daemon=True), holder

    # -- replay --------------------------------------------------------------

    def run(self) -> tuple[dict, bool]:
        """Replay the schedule against a freshly fitted + published
        stack; returns ``(verdict, ok)`` where ``ok`` is the AND of the
        verdict's hard gates."""
        import dataclasses

        from distributed_eigenspaces_tpu_torch.api.estimator import (
            OnlineDistributedPCA,
        )
        from distributed_eigenspaces_tpu_torch.data.synthetic import (
            planted_spectrum,
        )
        from distributed_eigenspaces_tpu_torch.serving import (
            EigenbasisRegistry,
            QueryServer,
        )
        from distributed_eigenspaces_tpu_torch.runtime.supervisor import (
            BreakerOpen,
        )
        from distributed_eigenspaces_tpu_torch.serving.drift import DriftMonitor
        from distributed_eigenspaces_tpu_torch.serving.server import (
            DeadlineExceeded,
            ServerClosed,
            ServerOverloaded,
        )
        from distributed_eigenspaces_tpu_torch.utils.faults import (
            ServeChaosHook,
            ServeChaosPlan,
        )
        from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger
        from distributed_eigenspaces_tpu_torch.utils.telemetry import Tracer

        dev = self.device

        spec = self.spec
        cfg = _scenario_cfg(spec)
        slo_ms = spec.slo_p99_ms
        if slo_ms is None:
            # structural default, same reasoning as bench --serve: a
            # healthy p99 is dominated by the admission flush window
            slo_ms = 3.0 * cfg.serve_flush_s * 1e3 + 100.0
        spectrum = planted_spectrum(
            cfg.dim, k_planted=cfg.k, gap=20.0, noise=0.01, seed=spec.seed
        )
        # drift episodes sample a DIFFERENT planted subspace: the live
        # basis stops explaining the traffic, exactly the tripwire
        # DriftMonitor's residual EWMA watches
        drift_spectrum = planted_spectrum(
            cfg.dim, k_planted=cfg.k, gap=20.0, noise=0.01,
            seed=spec.seed + 7919,
        )
        fit_rows = cfg.num_steps * cfg.num_workers * cfg.rows_per_worker
        est = OnlineDistributedPCA(cfg, device=dev).fit(
            spectrum.sample(np.random.default_rng(spec.seed), fit_rows)
        )
        metrics = MetricsLogger(slo_p99_ms=float(slo_ms))

        # publish episodes with `replicas: N` promote the
        # replay registry to the DURABLE store + publisher lease + N
        # read-only ReplicaRegistry tailers; everything else (server,
        # drift, churn publishes) rides the same registry object
        n_replicas = max(
            (
                int(ep.params["replicas"])
                for ep in spec.episodes
                if ep.kind == "publish" and ep.params.get("replicas")
            ),
            default=0,
        )
        registry_dir = None
        lease = None
        replica_regs: list = []
        if n_replicas:
            import tempfile

            from distributed_eigenspaces_tpu_torch.serving import (
                PublisherLease,
                ReplicaRegistry,
            )

            registry_dir = tempfile.mkdtemp(prefix="det_scenario_reg_")
            lease = PublisherLease(
                registry_dir, owner="scenario-primary",
                lease_ms=cfg.publisher_lease_ms, metrics=metrics,
            ).acquire(timeout_s=30.0)
            lease.start_heartbeat()
            registry = EigenbasisRegistry(
                keep=cfg.serve_keep_versions, registry_dir=registry_dir,
                lease=lease, metrics=metrics,
            )
        else:
            registry = EigenbasisRegistry(keep=cfg.serve_keep_versions)
        v1 = registry.publish_fit(est)
        if n_replicas:
            replica_regs = [
                ReplicaRegistry(
                    registry_dir, name=f"scenario-rep{i}",
                    keep=cfg.serve_keep_versions,
                    staleness_ms=cfg.replica_staleness_ms,
                    poll_s=0.005, metrics=metrics,
                )
                for i in range(n_replicas)
            ]
        tracer = Tracer()
        metrics.attach_tracer(tracer)

        has_drift = any(ep.kind == "drift" for ep in spec.episodes)
        drift = (
            DriftMonitor(
                registry, cfg, metrics=metrics, auto=True,
                cooldown_batches=4, device=dev,
            )
            if has_drift else None
        )
        kill_at = [
            int(ep.params["kill_lane_at_batch"])
            for ep in spec.episodes
            if ep.params.get("kill_lane_at_batch") is not None
        ]
        fault_hook = (
            ServeChaosHook(ServeChaosPlan(kill_lane_at_batch=min(kill_at)))
            if kill_at else None
        )

        payloads = self._query_payloads(spectrum, drift_spectrum)
        fleet, tenant_cfgs, tenant_problems = self._tenant_fleet(metrics)
        if fleet is not None:
            # compile every tenant signature BEFORE the replay clock
            # starts (production fleets run prewarmed) — otherwise the
            # first bucket per signature stamps its record seconds
            # late, past the episode window it belongs to, and the
            # slicing honestly reports zero fleet traffic
            fleet.prewarm(tenant_cfgs).wait(timeout=300.0)
        churn_threads: dict[str, threading.Thread] = {}
        churn_holders: dict[str, dict] = {}
        for ep in spec.episodes:
            if ep.kind == "churn":
                th, holder = self._churn_thread(ep, spectrum, metrics)
                churn_threads[ep.name] = th
                churn_holders[ep.name] = holder
        population_threads: dict[str, threading.Thread] = {}
        population_holders: dict[str, dict] = {}
        for ep in spec.episodes:
            if ep.kind == "population":
                th, holder = self._population_thread(ep, metrics)
                population_threads[ep.name] = th
                population_holders[ep.name] = holder

        pending: list = []
        fleet_pending: list = []
        handles: dict[str, Any] = {}
        ep_by_name = {ep.name: ep for ep in spec.episodes}

        server = QueryServer(
            registry, cfg, metrics=metrics, drift=drift,
            fault_hook=fault_hook,
            # a bucket leased to a chaos-killed lane must re-lease well
            # inside the replay horizon (the chaos drivers' setting;
            # the supervised default of 60 s would stall its riders
            # past every episode)
            lease_timeout=0.3,
            device=dev,
        )
        controller = None
        if self.controller:
            from distributed_eigenspaces_tpu_torch.runtime.controller import (
                Controller,
            )

            ctl_cfg = (
                cfg if cfg.controller_window_s is not None
                # default window: a few control decisions fit inside a
                # replay horizon (specs override via config)
                else dataclasses.replace(cfg, controller_window_s=0.2)
            )
            controller = Controller(
                server, metrics, ctl_cfg, plan=self.plan
            ).start()
        try:
            t_base = time.perf_counter()
            for action in self.schedule.actions:
                delay = action.t_s - (time.perf_counter() - t_base)
                if delay > 0:
                    time.sleep(delay)
                ep = ep_by_name[action.episode]
                if action.kind == "episode_start":
                    handles[ep.name] = tracer.episode(
                        ep.name, kind=ep.kind, fault=ep.fault,
                        start_s=ep.start_s,
                    )
                elif action.kind == "episode_end":
                    h = handles.pop(ep.name, None)
                    if h is not None:
                        h.close()
                elif action.kind == "query":
                    q = payloads[ep.name][action.index]
                    self.submitted += 1
                    try:
                        pending.append(server.submit(q))
                    except (ServerOverloaded, BreakerOpen):
                        # load shedding IS the designed behavior under
                        # a flash crowd; the shed lands in telemetry
                        # via the server's own event stream
                        self.shed_at_submit += 1
                    except ServerClosed:
                        self.failed += 1
                elif action.kind == "fleet_fit":
                    rank = action.tenant
                    self.fleet_submitted += 1
                    try:
                        fleet_pending.append(
                            fleet.submit(
                                tenant_problems[rank],
                                cfg=tenant_cfgs[rank],
                            )
                        )
                    except (ServerOverloaded, ServerClosed):
                        self.fleet_shed += 1
                elif action.kind == "publish":
                    if lease is not None and ep.params.get(
                        "kill_publisher"
                    ):
                        # mid-burst publisher kill: renewals stop and
                        # the TTL lapses (what a kill -9 leaves
                        # behind); the standby must wait it out and
                        # take over at epoch+1 BEFORE this publish —
                        # which then lands fenced-and-accepted
                        from distributed_eigenspaces_tpu_torch.serving import (
                            PublisherLease,
                        )

                        lease.stop_heartbeat()
                        lease = PublisherLease(
                            registry_dir, owner="scenario-standby",
                            lease_ms=cfg.publisher_lease_ms,
                            metrics=metrics,
                        ).acquire(timeout_s=30.0)
                        lease.start_heartbeat()
                        registry.lease = lease
                        self.publisher_failovers += 1
                    published = registry.publish(
                        v1.v, sigma_tilde=v1.sigma_tilde, step=v1.step,
                        lineage={"producer": f"scenario:{ep.name}"},
                    )
                    self.publishes += 1
                    if replica_regs:
                        # bounded-staleness convergence gate: the
                        # version must reach every replica inside a
                        # window derived from the declared bound
                        limit = max(
                            1.0, 4.0 * cfg.replica_staleness_ms / 1e3
                        )
                        deadline = time.monotonic() + limit
                        while time.monotonic() < deadline and not all(
                            r.latest() is not None
                            and r.latest().version >= published.version
                            for r in replica_regs
                        ):
                            for r in replica_regs:
                                r.poke()
                            time.sleep(0.002)
                        self.replica_converged[ep.name] = all(
                            r.latest() is not None
                            and r.latest().version >= published.version
                            for r in replica_regs
                        )
                elif action.kind == "churn_start":
                    churn_threads[ep.name].start()
                elif action.kind == "population_start":
                    population_threads[ep.name].start()

            # drain: resolve every accepted ticket (the no-hang gate).
            # A DeadlineExceeded here is the server's queue-deadline
            # shed surfacing at the waiter — designed load shedding
            # under the crowd, not a failure
            for t in pending:
                try:
                    t.result(timeout=60.0)
                    self.resolved += 1
                except DeadlineExceeded:
                    self.shed_at_result += 1
                except Exception:
                    self.failed += 1
            for t in fleet_pending:
                try:
                    t.result(timeout=120.0)
                    self.fleet_resolved += 1
                except Exception:
                    self.fleet_failed += 1
            for name, th in churn_threads.items():
                if not th.is_alive() and not th.ident:
                    continue  # never started (spec ended early)
                th.join(timeout=120.0)
                holder = churn_holders[name]
                if th.is_alive():
                    holder["error"] = "churn fit did not finish in 120s"
                elif "w" in holder and ep_by_name[name].params.get("publish"):
                    # the cross-tier composition: the churned fit's
                    # basis goes live mid-traffic through the same
                    # registry.publish surface as any producer
                    registry.publish(
                        holder["w"],
                        step=holder.get("step"),
                        lineage={"producer": f"scenario:{name}"},
                    )
                    self.publishes += 1
            for name, th in population_threads.items():
                if not th.is_alive() and not th.ident:
                    continue  # never started (spec ended early)
                th.join(timeout=120.0)
                if th.is_alive():
                    population_holders[name]["error"] = (
                        "population fit did not finish in 120s"
                    )
            if drift is not None:
                drift.join_refresh(timeout=60.0)
        finally:
            # close any episode still open (crash-path tidiness: the
            # span records what actually ran)
            for h in handles.values():
                h.close()
            if controller is not None:
                # stop the control lane BEFORE the server: a knob write
                # racing close() would act on a draining queue
                controller.close()
            if fleet is not None:
                fleet.close()
            server.close()
            for r in replica_regs:
                r.close()
            if lease is not None:
                lease.stop_heartbeat()
            if registry_dir is not None:
                import shutil

                shutil.rmtree(registry_dir, ignore_errors=True)

        summary = metrics.summary()
        verdict = self._verdict(summary, churn_holders, population_holders)
        if self.trace_out:
            tracer.export_chrome_trace(self.trace_out)
            verdict["trace_out"] = self.trace_out
        ok = all(verdict["gates"].values())
        if not ok:
            verdict["scenario_fail"] = sorted(
                g for g, passed in verdict["gates"].items() if not passed
            )
        return verdict, ok

    # -- verdict -------------------------------------------------------------

    def _verdict(
        self, summary: dict, churn_holders: dict,
        population_holders: dict | None = None,
    ) -> dict:
        """The judged record: every numeric field below comes from
        ``summary()`` — the runner's submit/resolve counters appear
        under 'replay' and feed the GATES only."""
        spec = self.spec
        episodes = summary.get("episodes") or {}
        serving = summary.get("serving") or {}
        replication = summary.get("replication") or {}
        fleet = summary.get("fleet") or {}
        membership = summary.get("membership") or {}
        population = summary.get("population") or {}
        population_holders = population_holders or {}
        slo = summary.get("slo") or {}

        gates: dict[str, bool] = {
            "all_episodes_measured": all(
                ep.name in episodes for ep in spec.episodes
            ),
            "all_accepted_tickets_resolved": (
                self.failed == 0 and self.fleet_failed == 0
            ),
        }
        for ep in spec.episodes:
            sec = episodes.get(ep.name) or {}
            if ep.kind in _SERVE_LOAD:
                gates[f"{ep.name}_served"] = sec.get("requests", 0) > 0
            elif ep.kind == "tenant_skew":
                gates[f"{ep.name}_fleet_served"] = (
                    sec.get("fleet_requests", 0) > 0
                )
            elif ep.kind == "churn":
                holder = churn_holders.get(ep.name, {})
                gates[f"{ep.name}_fit_completed"] = (
                    "error" not in holder and membership.get("rounds", 0) > 0
                )
            elif ep.kind == "population":
                # judged from summary()["population"]: the episode's
                # cohort rounds all closed into telemetry, and every
                # injected poisoner landed in rejects_by_reason (the
                # attribution trail, not just the holder's say-so)
                holder = population_holders.get(ep.name, {})
                gates[f"{ep.name}_rounds_closed"] = (
                    "error" not in holder
                    and population.get("rounds", 0)
                    >= int(ep.params.get("rounds", 4))
                )
                if ep.params.get("poison_frac"):
                    gates[f"{ep.name}_rejects_attributed"] = (
                        sum(
                            (population.get("rejects_by_reason") or {})
                            .values()
                        ) > 0
                    )
            elif ep.kind == "publish":
                gates[f"{ep.name}_version_live"] = (
                    len(serving.get("versions_served") or ()) >= 2
                )
                if ep.params.get("replicas"):
                    gates[f"{ep.name}_replicas_converged"] = (
                        self.replica_converged.get(ep.name, False)
                    )
            if ep.fault:
                gates[f"{ep.name}_recovered"] = bool(
                    sec.get("recovered")
                )
        serve_slo = slo.get("serve") or {}
        verdict = {
            "metric": "pca_scenario_slo_verdict",
            "scenario": spec.name,
            "seed": spec.seed,
            "value": serve_slo.get("attainment"),
            "unit": "slo_attainment",
            "horizon_s": spec.horizon_s,
            "episodes": episodes,
            "slo": slo,
            "serving": {
                k: serving.get(k)
                for k in (
                    "batches", "queries", "rejected", "qps",
                    "p50_latency_s", "p99_latency_s",
                    "latency_decomposition", "swaps", "versions_served",
                    "health", "drift_refreshes",
                )
                if k in serving
            },
            "replication": {
                k: replication.get(k)
                for k in (
                    "installs", "stale", "fenced", "failovers",
                    "propagation_p50_ms", "propagation_p99_ms",
                    "failover_recovery_ms",
                )
                if k in replication
            },
            "fleet": {
                k: fleet.get(k)
                for k in ("buckets", "tenants", "p99_latency_s",
                          "mean_occupancy")
                if k in fleet
            },
            "membership": {
                k: membership.get(k)
                for k in ("events", "by_kind", "rounds",
                          "deadline_closed", "stale_folds")
                if k in membership
            },
            "churn": {
                name: {k: v for k, v in holder.items() if k != "w"}
                for name, holder in churn_holders.items()
            },
            "population": {
                k: population.get(k)
                for k in ("rounds", "stale_folds", "participation_hist",
                          "rejects_by_reason", "by_kind")
                if k in population
            },
            "population_fits": dict(population_holders),
            "replay": {
                "submitted": self.submitted,
                "shed_at_submit": self.shed_at_submit,
                "shed_at_result": self.shed_at_result,
                "resolved": self.resolved,
                "failed": self.failed,
                "fleet_submitted": self.fleet_submitted,
                "fleet_shed": self.fleet_shed,
                "fleet_resolved": self.fleet_resolved,
                "fleet_failed": self.fleet_failed,
                "publishes": self.publishes,
                "publisher_failovers": self.publisher_failovers,
            },
            "gates": gates,
        }
        if "controller" in summary:
            # the control plane's audit trail rides the verdict
            # verbatim — every decision with lineage + evidence
            verdict["controller"] = summary["controller"]
        return verdict


def run_scenario(
    source: Any, *, trace_out: str | None = None,
    controller: bool = False, plan: dict | None = None,
    device="cuda",
) -> tuple[dict, bool]:
    """Load (or accept) a spec, replay it, return ``(verdict, ok)`` —
    the one-call form ``scripts/torch_scenario.py`` and ``chip_smoke.py``
    use. ``controller=True`` runs the same replay with the autoscaler lane
    attached (the controller A/B's arm); ``plan`` hands it a ``plan-v1``
    dict to roll out. ``device`` is where the replay runs."""
    spec = source if isinstance(source, ScenarioSpec) else load_spec(source)
    return ScenarioRunner(
        spec, trace_out=trace_out, controller=controller, plan=plan,
        device=device,
    ).run()
