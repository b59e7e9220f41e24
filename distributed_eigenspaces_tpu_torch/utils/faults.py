"""Fault injection: worker-drop masks, chaos plans and chaotic streams.

The port's copy of ``distributed_eigenspaces_tpu/utils/faults.py``. A
dropped worker is a worker mask: its projector leaves the merge and the
mean reweights over the survivors exactly (``WorkerPool.round(
worker_mask=...)``). This module makes deterministic fault schedules for
tests and chaos runs: per-step worker-drop masks (:class:`FaultInjector`,
:func:`kill_workers`); scheduled data corruption for supervised fits
(:class:`ChaosPlan` / :class:`ChaosStream`: NaN blocks, zeroed blocks,
transient stream errors, a hard kill at a chosen step); membership churn
for elastic fits (:class:`ChurnPlan`, consumed by ``runtime/membership.py``);
the sampled-cohort tier's client faults (:class:`ClientChaosPlan`); and
the serve tier's (:class:`ServeChaosPlan` / :class:`ServeChaosHook`,
:func:`corrupt_version_file`). Blocks pass through as numpy arrays or
tensors; a corrupted block is a copy, in the input's kind.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


class KillSwitch(RuntimeError):
    """Simulated hard process death (chaos harness kill-at-step-t).

    Deliberately NOT in the supervisor's retryable set: a real SIGKILL
    doesn't retry — it takes the process down, and recovery is the next
    process restoring the newest committed checkpoint and seeking the
    stream cursor. Tests/scripts catch it OUTSIDE ``supervised_fit`` and
    call ``supervised_fit`` again to simulate the restart.
    """


class FaultInjector:
    """Deterministic per-step worker-failure masks.

    ``drop_prob`` is the independent per-worker failure probability per
    step; at least one worker always survives (an all-dead round would make
    the merge undefined — the masked mean guards with max(count, 1) but the
    algorithm should see >= 1 contribution).

    Iterate it alongside the stream and pass to ``worker_masks=``::

        faults = FaultInjector(num_workers=8, drop_prob=0.2, seed=3)
        online_distributed_pca(stream, cfg, worker_masks=iter(faults))
    """

    def __init__(self, num_workers: int, drop_prob: float, seed: int = 0):
        if not 0.0 <= drop_prob < 1.0:
            raise ValueError(f"drop_prob must be in [0, 1), got {drop_prob}")
        self.num_workers = num_workers
        self.drop_prob = drop_prob
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next_mask()

    def next_mask(self) -> np.ndarray:
        mask = (
            self._rng.random(self.num_workers) >= self.drop_prob
        ).astype(np.float32)
        if mask.sum() == 0:  # resurrect one survivor
            mask[self._rng.integers(self.num_workers)] = 1.0
        return mask


def kill_workers(num_workers: int, dead: list[int]) -> np.ndarray:
    """Explicit mask with the listed worker indices dead (scenario tests)."""
    mask = np.ones(num_workers, np.float32)
    for i in dead:
        mask[i] = 0.0
    if mask.sum() == 0:
        raise ValueError("cannot kill every worker")
    return mask


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """Deterministic corruption schedule for a block stream (1-based
    steps, matching the online loop's step numbering).

    ``nan_blocks`` / ``zero_blocks``: ``{step: [worker indices]}`` —
    the listed workers' row-blocks are overwritten with NaN / zeros
    before the block is yielded (the corrupt-input classes the
    supervisor's quarantine must catch: NaN is loud corruption, zeros
    model a reader that delivered an unwritten buffer).
    ``raise_at``: ``{step: message}`` — ``next()`` raises ``OSError``
    ONCE for that step, then delivers the step's block on the retry
    (the transient-IO class the supervisor's backoff absorbs).
    ``kill_at``: raise :class:`KillSwitch` INSTEAD of yielding this step
    — the hard-death class; fires once, so a restarted run streaming
    from its checkpoint cursor sails past.
    """

    nan_blocks: dict[int, list[int]] = dataclasses.field(
        default_factory=dict
    )
    zero_blocks: dict[int, list[int]] = dataclasses.field(
        default_factory=dict
    )
    raise_at: dict[int, str] = dataclasses.field(default_factory=dict)
    kill_at: int | None = None


@dataclasses.dataclass(frozen=True)
class ChurnPlan:
    """Deterministic membership-churn schedule for the FIT tier
   , consumed by ``runtime/membership.py ElasticStream``
    (1-based absolute steps, resume-safe like :class:`ChaosPlan`).

    ``kill_at``: ``{step: [slots]}`` — the listed workers CRASH before
    that round: their heartbeats stop and the membership table finds
    out via lease expiry (suspect after ``heartbeat_timeout_ms``, dead
    one grace later) — the liveness-detection path under test.
    ``leave_at``: graceful departures — the slot goes dead immediately
    (the worker said goodbye; no detection lag).
    ``rejoin_at``: the listed workers come back: they re-claim their
    old slot (``MembershipTable.join``) and are admitted at the NEXT
    round with a fresh lease — flapping is kills and rejoins
    interleaved on the same slot.
    ``straggle``: ``{step: {slot: delay_s}}`` — one-off delivery
    delays past the round start; a delay beyond
    ``cfg.round_deadline_ms`` misses the round and the rows fold into
    the NEXT merge.
    ``slow``: ``{slot: delay_s}`` — persistent stragglers (the delay
    applies every round; beyond the deadline this is a steady
    one-round lag, never a stall).
    """

    kill_at: dict[int, list[int]] = dataclasses.field(
        default_factory=dict
    )
    leave_at: dict[int, list[int]] = dataclasses.field(
        default_factory=dict
    )
    rejoin_at: dict[int, list[int]] = dataclasses.field(
        default_factory=dict
    )
    straggle: dict[int, dict[int, float]] = dataclasses.field(
        default_factory=dict
    )
    slow: dict[int, float] = dataclasses.field(default_factory=dict)

    def delay(self, step: int, slot: int) -> float:
        """Delivery delay (seconds past round start) for ``slot`` at
        ``step``: the scheduled one-off wins over the persistent
        rate."""
        d = self.straggle.get(step, {}).get(slot)
        if d is not None:
            return float(d)
        return float(self.slow.get(slot, 0.0))


@dataclasses.dataclass(frozen=True)
class ClientChaosPlan:
    """Deterministic population-chaos schedule for the SAMPLED-COHORT
    ingest tier, consumed by ``runtime/population.py``
    (1-based absolute rounds, resume-safe like :class:`ChaosPlan`).

    Client ROLES are assigned by population id range (deterministic,
    seed-independent): ids ``[0, P·nan_frac)`` are NaN submitters, the
    next ``P·poison_frac`` are colluding poisoners, the next
    ``P·straggler_frac`` are persistent stragglers; everyone else is
    honest. Uniform cohort sampling makes contiguous ranges equivalent
    to any other deterministic assignment.

    ``dropout_frac``: baseline i.i.d. per-sampled-client dropout
    probability per round — a dropped client contributes NOTHING (the
    participation-fraction deadline absorbs it; no detection lag, no
    placeholder).
    ``dropout_waves``: ``{round: frac}`` — rounds where the dropout
    probability SPIKES (a correlated outage wave). A wave deep enough
    to push arrivals below ``cfg.min_participation_frac`` triggers the
    participation-collapse arc (bounded wait → resume) under test.
    ``straggler_frac``: fraction of the population that is persistently
    SLOW: their contributions always miss the round deadline and fold
    one-step-stale into the NEXT round (the elastic stream's rule) — a
    steady one-round lag, never a stall.
    ``nan_frac``: fraction of the population whose submissions are NaN
    — the loud-corruption class the gauntlet's non-finite screen must
    quarantine with client id + reason.
    ``poison_frac``: fraction of the population that is Byzantine and
    COLLUDING: every poisoner submits the SAME sign-flipped adversarial
    basis (orthogonal to the planted one), scaled by ``poison_scale``.
    ``poison_scale``: norm multiplier on poison submissions. ``> 1``
    breaks near-orthonormality, so the gauntlet rejects it at the door
    (the attribution path); ``== 1`` stays exactly orthonormal and
    slips the gauntlet, so the norm-clipped trimmed mean + affinity
    screen must stop the steering (the robust-statistics path). The
    bench runs both.
    """

    dropout_frac: float = 0.0
    dropout_waves: dict[int, float] = dataclasses.field(
        default_factory=dict
    )
    straggler_frac: float = 0.0
    nan_frac: float = 0.0
    poison_frac: float = 0.0
    poison_scale: float = 1.0

    def __post_init__(self):
        for name in ("dropout_frac", "straggler_frac", "nan_frac",
                     "poison_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"{name} must be a fraction in [0, 1], got {v!r}"
                )
        for rnd, frac in self.dropout_waves.items():
            if not 0.0 <= frac <= 1.0:
                raise ValueError(
                    f"dropout_waves[{rnd}] must be a fraction in "
                    f"[0, 1], got {frac!r}"
                )

    def dropout_at(self, rnd: int) -> float:
        """Effective dropout probability for round ``rnd``: a scheduled
        wave overrides the baseline (one-off wins over persistent — the
        :class:`ChurnPlan.delay` rule)."""
        return float(self.dropout_waves.get(rnd, self.dropout_frac))


@dataclasses.dataclass
class ServeChaosPlan:
    """Deterministic fault schedule for the SERVE tier (the
    read-path dual of :class:`ChaosPlan`), consumed by
    :class:`ServeChaosHook` wired into ``QueryServer(fault_hook=...)``.

    ``kill_lane_at_batch``: the Nth dispatched bucket raises
    :class:`KillSwitch` — a hard serve-lane death (the lane thread
    exits without failing its bucket, exactly like a killed thread; the
    watchdog restarts the lane and lease expiry re-queues the bucket).
    Fires ONCE, so the restarted lane sails past — the restart IS the
    recovery under test.
    ``fail_signatures``: admission signatures whose every dispatch
    raises ``OSError`` — the poisoned-signature class the per-signature
    circuit breaker must isolate.
    ``fail_error``: the poisoned dispatch's message.
    """

    kill_lane_at_batch: int | None = None
    fail_signatures: tuple = ()
    fail_error: str = "chaos: poisoned dispatch"


class ServeChaosHook:
    """Stateful dispatch-time injector for a :class:`ServeChaosPlan`.
    Counts dispatched buckets; thread-safe (dispatch lanes may be
    concurrent)."""

    def __init__(self, plan: ServeChaosPlan):
        import threading

        self.plan = plan
        self.batches = 0
        self.killed = False
        self._lock = threading.Lock()

    def __call__(self, bucket) -> None:
        with self._lock:
            self.batches += 1
            n = self.batches
            kill = (
                self.plan.kill_lane_at_batch is not None
                and n >= self.plan.kill_lane_at_batch
                and not self.killed
            )
            if kill:
                self.killed = True
        if kill:
            raise KillSwitch(f"chaos: serve lane killed at batch {n}")
        if bucket.signature in tuple(self.plan.fail_signatures):
            raise OSError(self.plan.fail_error)


def corrupt_version_file(version_dir: str, *, offset: int = -8,
                         flip: int = 0xFF) -> str:
    """Flip one byte of a committed registry version's payload
    (``basis.npz``) IN PLACE, leaving its commit marker intact — the
    checksum-mismatch fault class registry recovery must quarantine
    (disk rot / tamper, as opposed to the torn-snapshot class a killed
    publisher leaves). Returns the corrupted payload path."""
    import os

    path = os.path.join(version_dir, "basis.npz")
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END if offset < 0 else os.SEEK_SET)
        pos = f.tell()
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ flip]))
    return path


class ChaosStream:
    """Apply a :class:`ChaosPlan` to a block stream.

    An ITERATOR class, not a generator: a generator that raises is dead
    (``next()`` after an exception is ``StopIteration``), but transient
    faults must leave the stream resumable — the supervisor retries the
    SAME pull and gets the step's block. ``first_step`` offsets the step
    numbering for resumed streams (a run restored at step t sees its
    first block as step t+1, so the plan keys stay absolute).
    """

    def __init__(self, stream, plan: ChaosPlan, *, first_step: int = 1):
        self._it = iter(stream)
        self._plan = plan
        self._step = first_step - 1
        self._raised: set[int] = set()
        self._killed = False

    def __iter__(self) -> "ChaosStream":
        return self

    def __next__(self):
        t = self._step + 1
        if self._plan.kill_at == t and not self._killed:
            self._killed = True
            raise KillSwitch(f"chaos kill at step {t}")
        if t in self._plan.raise_at and t not in self._raised:
            self._raised.add(t)
            raise OSError(self._plan.raise_at[t])
        block = next(self._it)
        self._step = t
        bad = self._plan.nan_blocks.get(t), self._plan.zero_blocks.get(t)
        if bad != (None, None):
            block = _float32_copy(block)
            for workers, value in zip(bad, (np.nan, 0.0)):
                for w in workers or ():
                    block[w] = value
        return block


def _float32_copy(block):
    """A float32 copy of a block to corrupt: a tensor stays a tensor on its
    device, anything else becomes a numpy array."""
    import torch

    if isinstance(block, torch.Tensor):
        return block.detach().to(torch.float32, copy=True)
    return np.array(block, np.float32, copy=True)
