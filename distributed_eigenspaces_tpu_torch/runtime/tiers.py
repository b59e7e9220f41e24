"""Per-tier elastic membership for the hierarchical merge.

The port's copy of ``distributed_eigenspaces_tpu/runtime/tiers.py``.
:class:`~.membership.MembershipTable` tracks the LEAF fleet, one slot per
worker. Under a ``cfg.merge_topology`` the non-leaf tiers (hosts, pods,
...) are failure domains of their own: a whole host can straggle or drop
while its workers' leases stay warm, and the tree merge above it must
close its round anyway. This module gives every non-leaf tier its own
membership table, deadline and quorum rule:

* :class:`TierTable`: a :class:`~.membership.MembershipTable` whose slots
  are TIER MEMBERS (e.g. hosts), stamping its tier name onto every
  membership event and raising :class:`TierQuorumLost` (not the global
  :class:`~.membership.QuorumLost`) so the supervisor can name which tier
  lost quorum and wait on THAT table.
* :class:`TierSet`: the per-round driver over all non-leaf tables: applies
  each tier's :class:`~..utils.faults.ChurnPlan`, heartbeats the
  simulated-alive members, runs the tier round boundary (sweep / admit /
  quorum), and closes the tier round at ``cfg.round_deadline_ms`` with
  whatever arrived. A member whose delivery misses the tier deadline
  contributes nothing THIS round: its group rows are held and folded
  one-step-stale into the NEXT tier-local merge. Emits ``metrics.merge``
  ``tier_round`` records and ``merge:tier`` tracer spans.
* :class:`TieredStream`: composes an :class:`~.membership.ElasticStream`
  (leaf rounds) with a :class:`TierSet`: splices held stale group rows
  into the emitted block and multiplies the leaf mask with every tier's
  effective mask (broadcast over each member's worker group), so the
  masked tree merge weights a late host's workers 0 exactly.

The round bookkeeping is numpy on the host; the blocks stay tensors on the
elastic stream's device (the fit's), and the splices are tensor copies
there. Holds do NOT survive a resume: a restarted stream replays churn
state only, exactly like ``ElasticStream``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable

import numpy as np

from distributed_eigenspaces_tpu_torch.runtime.membership import (
    ElasticStream,
    MembershipTable,
    QuorumLost,
    _MembershipMaskFeed,
)

__all__ = [
    "TierQuorumLost",
    "TierSet",
    "TierTable",
    "TieredStream",
]


class TierQuorumLost(QuorumLost):
    """A NON-LEAF tier fell below its quorum floor. Subclasses
    :class:`~.membership.QuorumLost` so ``supervised_fit``'s handler
    catches it (the quorum wait runs against the TIER's table), and
    carries ``tier`` so the ledger can tell a host-tier outage from a
    fleet-wide one."""

    def __init__(self, table, step=None, tier=None):
        super().__init__(table, step)
        self.tier = tier
        self.args = (f"tier {tier!r}: {self.args[0]}",)


class TierTable(MembershipTable):
    """A membership table whose slots are the MEMBERS of one non-leaf
    merge tier. Same lease state machine as the leaf table; every event
    carries the tier name and quorum loss surfaces as
    :class:`TierQuorumLost`."""

    def __init__(self, num_members: int, *, tier: str, **kw):
        self.tier = tier
        super().__init__(num_members, **kw)

    def _record(self, kind, slot=None, **detail):
        detail.setdefault("tier", self.tier)
        return super()._record(kind, slot, **detail)

    def begin_round(self, step, now=None):
        try:
            return super().begin_round(step, now)
        except TierQuorumLost:
            raise
        except QuorumLost as ql:
            raise TierQuorumLost(self, step, tier=self.tier) from ql


class TierSet:
    """Round driver over every non-leaf tier of a
    :class:`~..parallel.topology.MergeTopology`.

    One :class:`TierTable` per non-leaf tier (``topo.member_count``
    members each), all sharing the config's lease / quorum / deadline
    knobs. ``churn`` maps tier name to a :class:`ChurnPlan` whose slots
    are TIER-MEMBER indices. :meth:`begin_round` mirrors
    ``ElasticStream.__next__``'s lifecycle and arrival logic per tier.
    """

    def __init__(
        self,
        topo,
        cfg,
        *,
        churn=None,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        from distributed_eigenspaces_tpu_torch.parallel.wire import (
            resolve_wire_policy,
        )

        self.topo = topo
        self.cfg = cfg
        self.metrics = metrics
        self._clock = clock
        self._sleep = sleep
        #: per-tier wire dtypes under an active ``merge_wire_dtype`` policy,
        #: or None: drives the per-round ``wire`` merge records and the
        #: ``merge:tier`` span attribute
        self.wire = resolve_wire_policy(cfg, topo)
        #: tier -> last observed error-feedback residual norm
        self._wire_norms: dict[str, float] = {}
        self._deadline_s = (
            None if cfg.round_deadline_ms is None
            else cfg.round_deadline_ms / 1e3
        )
        self.churn = dict(churn or {})
        nonleaf = tuple(topo.names[1:])
        unknown = set(self.churn) - set(nonleaf)
        if unknown:
            raise ValueError(
                f"churn plans target unknown non-leaf tiers "
                f"{sorted(unknown)}; topology's non-leaf tiers are "
                f"{list(nonleaf)} (the leaf tier's churn rides the "
                f"worker ElasticStream, not the TierSet)"
            )
        self.tables: dict[str, TierTable] = {}
        #: tier -> crashed-member simulation (no heartbeats)
        self._sim_dead: dict[str, set] = {}
        #: tier -> members whose group rows are held for the next merge
        self._held: dict[str, set] = {}
        for stage in range(1, len(topo.tiers)):
            name = topo.names[stage]
            self.tables[name] = TierTable(
                topo.member_count(stage),
                tier=name,
                heartbeat_timeout_ms=cfg.heartbeat_timeout_ms,
                min_quorum_frac=cfg.min_quorum_frac,
                clock=clock,
                sleep=sleep,
                metrics=metrics,
            )
            self._sim_dead[name] = set()
            self._held[name] = set()

    # -- events ---------------------------------------------------------------

    def _emit(self, kind: str, **detail) -> None:
        if self.metrics is not None:
            self.metrics.merge({"kind": kind, **detail})

    def note_wire_residuals(self, norms) -> None:
        """Feed the latest per-tier error-feedback residual norms (the
        fit's wire stats, or any tier -> norm mapping); they ride the next
        round's ``wire`` merge records."""
        if norms is None:
            return
        if not isinstance(norms, dict):
            norms = dict(zip(
                self.topo.names, (float(x) for x in norms)
            ))
        for name, x in norms.items():
            self._wire_norms[str(name)] = float(x)

    def replay(self, first_step: int) -> None:
        """Rebuild the churn simulation state for a stream resuming at
        ``first_step`` (plan keys are absolute steps): the TABLE is the
        durable truth, so members it holds live / joining are never
        re-crashed by the replay. Holds are cleared: no in-flight rows
        survive a restart."""
        for name, table in self.tables.items():
            plan = self.churn.get(name)
            sd: set = set()
            if plan is not None:
                for t in range(1, first_step):
                    for s in plan.kill_at.get(t, ()):
                        sd.add(s)
                    for s in plan.leave_at.get(t, ()):
                        sd.add(s)
                    for s in plan.rejoin_at.get(t, ()):
                        sd.discard(s)
            sd -= {
                s for s in range(table.num_workers)
                if table.state(s) in ("live", "joining")
            }
            self._sim_dead[name] = sd
            self._held[name].clear()

    # -- round boundary -------------------------------------------------------

    def begin_round(self, step: int) -> dict[str, dict]:
        """Run one round boundary for every non-leaf tier, leaf to root.
        Raises :class:`TierQuorumLost` naming the first tier below its
        floor. Returns ``{tier: {"member_mask", "effective", "stale",
        "late", "rehold", "drop", "deadline_closed"}}``, the masks over
        TIER MEMBERS."""
        from distributed_eigenspaces_tpu_torch.utils.telemetry import tracer_of

        tracer = tracer_of(self.metrics)
        info: dict[str, dict] = {}
        for stage in range(1, len(self.topo.tiers)):
            name, fan_in = self.topo.tiers[stage]
            attrs = {"tier": name, "step": int(step)}
            if self.wire is not None:
                attrs["wire_dtype"] = self.wire[stage]
            with tracer.span("merge:tier", category="merge", attrs=attrs):
                info[name] = self._tier_round(name, fan_in, step)
        self._emit_wire_round(step)
        return info

    def _emit_wire_round(self, step: int) -> None:
        """One ``wire`` merge record per COMPRESSED tier per round: its
        modelled payload bytes against the fp32 program, its compression
        ratio and, once reported, the residual norm. fp32 tiers emit
        nothing."""
        if self.wire is None:
            return
        from distributed_eigenspaces_tpu_torch.parallel.wire import (
            tier_wire_records,
        )

        for rec in tier_wire_records(
            self.topo, self.wire, self.cfg.dim, self.cfg.k,
            residual_norms=self._wire_norms,
        ):
            if rec["wire_dtype"] == "fp32":
                continue
            del rec["kind"]
            self._emit("wire", step=step, **rec)

    def _tier_round(self, name: str, fan_in: int, step: int) -> dict:
        table = self.tables[name]
        plan = self.churn.get(name)
        sim_dead = self._sim_dead[name]
        held_set = self._held[name]
        if plan is not None:
            kills = plan.kill_at.get(step, ())
            if kills:
                self._emit(
                    "churn_kill", tier=name, step=step, slots=list(kills),
                )
            for s in kills:
                # crash: heartbeats stop; the tier table finds out via
                # lease expiry, as the leaf fleet does
                sim_dead.add(s)
            for s in plan.leave_at.get(step, ()):
                sim_dead.add(s)
                table.leave(s)
        # one clock reading for the members' beats and the sweep, as the
        # leaf stream does
        now = table.clock()
        for s in range(table.num_workers):
            if s not in sim_dead and table.state(s) != "dead":
                table.heartbeat(s, now)
        member_mask = table.begin_round(step, now)  # may raise TierQuorumLost
        if plan is not None:
            rejoins = plan.rejoin_at.get(step, ())
            if rejoins:
                self._emit(
                    "churn_rejoin", tier=name, step=step,
                    slots=list(rejoins),
                )
            for s in rejoins:
                sim_dead.discard(s)
                if table.state(s) == "dead":
                    table.join(s)
        n = table.num_workers
        arrived = np.zeros(n, np.float32)
        late, stale, rehold, drop = [], [], [], []
        max_wait = 0.0
        deadline_closed = False
        for s in range(n):
            if member_mask[s] == 0.0 or s in sim_dead:
                # a non-member's (or undetected-crashed member's) held rows
                # die with it; an undetected crash makes the tier round
                # wait out its deadline, the leaf rule
                if s in held_set:
                    held_set.discard(s)
                    drop.append(s)
                if (
                    s in sim_dead and member_mask[s] != 0.0
                    and self._deadline_s is not None
                ):
                    deadline_closed = True
                continue
            delay = plan.delay(step, s) if plan is not None else 0.0
            on_time = self._deadline_s is None or delay <= self._deadline_s
            if s in held_set:
                # fold the held group rows into THIS tier-local merge
                # (one-step-stale); this round's fresh rows take their
                # place in the hold if the member straggled again
                arrived[s] = 1.0
                stale.append(s)
                if not on_time:
                    rehold.append(s)
                    deadline_closed = True
                else:
                    held_set.discard(s)
                    max_wait = max(max_wait, delay)
            elif on_time:
                arrived[s] = 1.0
                max_wait = max(max_wait, delay)
            else:
                late.append(s)
                held_set.add(s)
                deadline_closed = True
        if deadline_closed and self._deadline_s is not None:
            max_wait = self._deadline_s
        if max_wait > 0:
            self._sleep(max_wait)  # the tier round's simulated wall time
        effective = member_mask * arrived
        self._emit(
            "tier_round", tier=name, step=step, fan_in=fan_in,
            members=int(member_mask.sum()), arrived=int(arrived.sum()),
            late=late, stale=stale,
            deadline_closed=bool(deadline_closed),
            quorum_frac=round(table.live_frac(), 4),
        )
        return {
            "member_mask": member_mask,
            "effective": effective,
            "stale": stale,
            "late": late,
            "rehold": rehold,
            "drop": drop,
            "deadline_closed": deadline_closed,
        }


class TieredStream:
    """Compose an :class:`~.membership.ElasticStream` (leaf rounds) with a
    :class:`TierSet` (non-leaf rounds) into one elastic block stream for
    the tiered trainer.

    Each ``__next__`` pulls a leaf round (a fresh tensor on the elastic
    stream's device), runs every non-leaf tier's round boundary, splices
    one-step-stale group rows for tier members that straggled LAST round,
    holds this round's group rows for members that missed THIS round's
    tier deadline, and pushes the composed worker mask (leaf AND every
    tier's effective mask broadcast over its worker groups). ``.table`` is
    the LEAF table, so the supervisor's ledger keeps per-worker
    resolution.
    """

    def __init__(self, elastic: ElasticStream, tiers: TierSet):
        self._es = elastic
        self.tiers = tiers
        self.topo = tiers.topo
        self.table = elastic.table
        self._feed = elastic.membership_masks()
        self._masks: deque = deque()
        #: tier -> member -> held (m_group, n, d) rows for the next merge
        self._pending: dict[str, dict] = {name: {} for name in tiers.tables}
        tiers.replay(elastic._step + 1)

    def membership_masks(self):
        """Composed per-round worker masks, FIFO with the yielded blocks:
        pass as ``worker_masks=`` like the wrapped elastic stream's feed."""
        return _MembershipMaskFeed(self._masks)

    def __iter__(self) -> "TieredStream":
        return self

    def __next__(self):
        # the elastic stream hands out a fresh copy: the splices write it
        block = next(self._es)
        leaf_mask = next(self._feed)
        step = self._es._step
        info = self.tiers.begin_round(step)  # may raise TierQuorumLost
        m = self.topo.num_workers
        mask = np.array(leaf_mask, np.float32, copy=True)
        for stage in range(1, len(self.topo.tiers)):
            name = self.topo.names[stage]
            tinfo = info[name]
            gs = m // self.topo.member_count(stage)
            pend = self._pending[name]
            for j in tinfo["drop"]:
                pend.pop(j, None)
            for j in tinfo["stale"]:
                held = pend.pop(j, None)
                fresh = block[j * gs:(j + 1) * gs].clone()
                if held is not None:
                    block[j * gs:(j + 1) * gs] = held
                if j in tinfo["rehold"]:
                    pend[j] = fresh
            for j in tinfo["late"]:
                pend[j] = block[j * gs:(j + 1) * gs].clone()
            mask *= np.repeat(tinfo["effective"], gs)
        self._masks.append(mask)
        return block

    def close(self) -> None:
        self._es.close()
