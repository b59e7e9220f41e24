"""Replicated registry: bounded-staleness version propagation over the
committed store, a single-writer publisher lease with epoch fencing, and
replica-safe reads.

The port's copy of ``distributed_eigenspaces_tpu/serving/replication.py``
(host code: files, threads and numpy). The durable registry's commit
markers are the propagation bus, and the on-disk format is the two
packages' shared one, so a replica of either package tails a store the
other's registry commits.

- :class:`ReplicaRegistry`: a read-only registry replica. Its watcher lane
  (under ``runtime/supervisor.LaneWatchdog``, restart with backoff) polls
  the store, verifies each newly committed version (marker present,
  checksum valid, shape as signed, epoch not fenced) outside any lock, and
  installs it with the one-assignment swap, so ``latest()`` stays one
  attribute read. Each install measures its propagation lag against the
  marker's ``t_commit_unix`` and counts it stale past ``staleness_ms``. A
  replica never mutates the store: torn dirs, corrupt payloads and fenced
  commits are skipped and counted, not deleted.
- :class:`PublisherLease`: single-writer election over the same directory:
  one lease file (``publisher.lease``) written by atomic rename, heartbeat
  renewal, expiry-based takeover with a monotonically increasing fencing
  epoch, all under an ``fcntl`` file lock. The epoch is stamped into every
  commit marker; a zombie ex-publisher is rejected by the store
  (``publish`` raises :class:`LeaseLost` before assigning an id) and by
  every replica (a commit below an installed epoch is fenced).

Staleness and GC meet in the registry's ``retire_grace_s``: key the grace
window off the staleness bound and a replica that read a commit marker
just before the publisher GC'd it still completes its payload read.

A ``MetricsLogger`` (``metrics=``) receives every install, staleness
breach, fenced commit and lease failover as a ``replication`` event
(``summary()["replication"]``); the counters and
:meth:`ReplicaRegistry.health` carry the same numbers.
"""

from __future__ import annotations

import json
import os
import threading
import time

from distributed_eigenspaces_tpu_torch.runtime.supervisor import LaneWatchdog
from distributed_eigenspaces_tpu_torch.serving.registry import (
    _VERSION_DIR_RE,
    BasisVersion,
    VersionRetired,
    _load_committed_payload,
)

__all__ = ["LeaseLost", "PublisherLease", "ReplicaRegistry"]

_LEASE_NAME = "publisher.lease"
_LEASE_MUTEX = "publisher.lease.lock"


class LeaseLost(RuntimeError):
    """The publisher lease is no longer ours: it expired unrenewed, or
    a standby took over with a higher fencing epoch. A publish gated on
    the lease raises this INSTEAD of committing — the zombie path."""


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


class PublisherLease:
    """Single-writer publisher election over a registry directory.

    The lease record (``publisher.lease``) is JSON: ``owner``, fencing
    ``epoch``, ``expires_unix``, ``lease_ms``. All mutations (acquire,
    takeover, renew, release) run under an exclusive ``fcntl`` lock on
    a sibling mutex file and land via tmp + atomic rename, so readers
    never see a torn record and two standbys racing an expired lease
    cannot both win. Epochs only ever increase: release EXPIRES the
    record in place (it never deletes it), so the next holder's
    takeover bumps the epoch past every commit the old holder could
    have stamped.

    ``check()`` is the cheap read-only validation the store calls on
    every leased publish; ``ensure()`` raises :class:`LeaseLost` with
    the current holder named. ``start_heartbeat()`` renews on a
    background thread at a third of the lease duration; a heartbeat
    that discovers the lease gone flips ``held`` false and reports a
    ``replication`` telemetry event rather than dying silently.
    """

    def __init__(self, registry_dir: str, *, owner: str | None = None,
                 lease_ms: float = 1000.0, clock=time.time,
                 metrics=None):
        if lease_ms <= 0:
            raise ValueError(f"lease_ms must be > 0, got {lease_ms}")
        os.makedirs(registry_dir, exist_ok=True)
        self.registry_dir = registry_dir
        self.owner = owner or f"pid-{os.getpid()}-{id(self):x}"
        self.lease_ms = float(lease_ms)
        self.clock = clock
        self.metrics = metrics
        self.path = os.path.join(registry_dir, _LEASE_NAME)
        self._mutex_path = os.path.join(registry_dir, _LEASE_MUTEX)
        self._lock = threading.Lock()
        self._epoch = 0
        self._held = False
        self._hb_thread: threading.Thread | None = None
        self._hb_stop = threading.Event()
        #: takeovers this process performed (failover observability)
        self.takeovers = 0

    # -- file primitives (never under self._lock) ----------------------------

    def _with_mutex(self, fn):
        """Run ``fn()`` under the exclusive cross-process file lock.
        Mutations inside stay atomic against every other process's
        acquire/renew/takeover on the same store."""
        import fcntl

        fd = os.open(self._mutex_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            return fn()
        finally:
            os.close(fd)  # closing the fd releases the flock

    def _write_record(self, rec: dict) -> None:
        tmp = self.path + f".tmp.{self.owner}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)

    def _record(self) -> dict | None:
        return _read_json(self.path)

    def _expired(self, rec: dict) -> bool:
        return self.clock() > float(rec.get("expires_unix", 0.0))

    # -- protocol ------------------------------------------------------------

    def try_acquire(self) -> bool:
        """One acquisition attempt: fresh store → epoch 1; expired
        lease → takeover at ``epoch + 1``; our own live lease → renew.
        A live lease held by someone else loses (returns False)."""
        def attempt() -> tuple[bool, int, bool]:
            rec = self._record()
            now = self.clock()
            if rec is not None and not self._expired(rec):
                if rec.get("owner") != self.owner:
                    return False, 0, False
                epoch = int(rec.get("epoch", 1))
                took = False
            else:
                epoch = int(rec.get("epoch", 0)) + 1 if rec else 1
                took = rec is not None
            self._write_record({
                "owner": self.owner,
                "epoch": epoch,
                "expires_unix": now + self.lease_ms / 1e3,
                "lease_ms": self.lease_ms,
            })
            return True, epoch, took

        ok, epoch, took = self._with_mutex(attempt)
        if ok:
            with self._lock:
                self._set_state_locked(epoch, True)
            if took:
                self.takeovers += 1
                self._event(
                    "failover", epoch=epoch,
                    owner=self.owner,
                )
        return ok

    def acquire(self, timeout_s: float | None = None,
                poll_s: float = 0.01) -> "PublisherLease":
        """Block until the lease is ours (bounded by ``timeout_s``).
        Waiting is pure polling against the expiry stamp — the bounded
        failover window the bench gates on."""
        deadline = None if timeout_s is None else (
            time.monotonic() + timeout_s
        )
        while not self.try_acquire():
            if deadline is not None and time.monotonic() > deadline:
                rec = self._record() or {}
                raise LeaseLost(
                    f"lease acquisition timed out after {timeout_s}s: "
                    f"held by {rec.get('owner')!r} epoch "
                    f"{rec.get('epoch')} (lease_ms={self.lease_ms})"
                )
            time.sleep(poll_s)
        return self

    def renew(self) -> None:
        """Heartbeat: extend our live lease. A lease we let lapse is
        NEVER resurrected here — a standby may already be mid-takeover
        — and a lease someone else holds raises, both as
        :class:`LeaseLost`."""
        def attempt() -> dict | None:
            rec = self._record()
            if (
                rec is None
                or rec.get("owner") != self.owner
                or int(rec.get("epoch", -1)) != self._epoch
                or self._expired(rec)
            ):
                return rec
            self._write_record({
                **rec, "expires_unix": self.clock() + self.lease_ms / 1e3,
            })
            return None

        stale = self._with_mutex(attempt)
        if stale is not None:
            with self._lock:
                self._set_state_locked(self._epoch, False)
            raise LeaseLost(
                f"lease lost by {self.owner!r} (epoch {self._epoch}): "
                f"now held by {stale.get('owner')!r} epoch "
                f"{stale.get('epoch')}"
                if stale else
                f"lease lost by {self.owner!r}: record gone"
            )

    def check(self) -> bool:
        """Read-only validation: is the on-disk lease still ours, at
        our epoch, unexpired? The store calls this (via
        :meth:`ensure`) before EVERY leased publish — the zombie
        ex-publisher fails here without touching the store."""
        rec = self._record()
        return bool(
            rec is not None
            and rec.get("owner") == self.owner
            and int(rec.get("epoch", -1)) == self._epoch
            and not self._expired(rec)
        )

    def ensure(self) -> None:
        if not self.check():
            rec = self._record() or {}
            with self._lock:
                self._set_state_locked(self._epoch, False)
            raise LeaseLost(
                f"publisher {self.owner!r} (epoch {self._epoch}) no "
                f"longer holds the lease: current holder "
                f"{rec.get('owner')!r} epoch {rec.get('epoch')} — "
                "refusing to publish (a fenced zombie commit would be "
                "rejected by every replica anyway)"
            )

    def release(self) -> None:
        """Graceful handoff: EXPIRE the record in place. The record
        (and with it the epoch watermark) survives, so the next
        holder's epoch still fences every commit we ever stamped."""
        self.stop_heartbeat()

        def attempt() -> None:
            rec = self._record()
            if rec is not None and rec.get("owner") == self.owner:
                self._write_record({**rec, "expires_unix": 0.0})

        self._with_mutex(attempt)
        with self._lock:
            self._set_state_locked(self._epoch, False)

    # -- state ---------------------------------------------------------------

    def _set_state_locked(self, epoch: int, held: bool) -> None:
        self._epoch = epoch
        self._held = held

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def held(self) -> bool:
        return self._held

    def _event(self, kind: str, **fields) -> None:
        if self.metrics is not None:
            self.metrics.replication({"kind": kind, **fields})

    # -- heartbeat -----------------------------------------------------------

    def start_heartbeat(self, interval_s: float | None = None
                        ) -> "PublisherLease":
        """Renew on a background thread (default: a third of the lease
        duration — two missed beats of headroom before expiry)."""
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return self
        interval = (
            interval_s if interval_s is not None
            else self.lease_ms / 3e3
        )
        self._hb_stop.clear()

        def beat() -> None:
            while not self._hb_stop.wait(interval):
                try:
                    self.renew()
                except LeaseLost as e:
                    self._event(
                        "lease_lost", owner=self.owner,
                        epoch=self._epoch, error=str(e),
                    )
                    return

        self._hb_thread = threading.Thread(
            target=beat, daemon=True,
            name=f"lease-heartbeat-{self.owner}",
        )
        self._hb_thread.start()
        return self

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()
        t = self._hb_thread
        if t is not None:
            t.join(timeout=2.0)


class ReplicaRegistry:
    """A read-only registry replica tailing one committed store.

    Construction performs a synchronous catch-up scan (a replica
    warm-restart serves the recovered latest before its first poll),
    then ``start()`` — on by default — runs the watcher lane under a
    ``LaneWatchdog``: the same restart/backoff/ledger discipline as
    the serve lanes, so a watcher killed by a transient IO error
    restarts instead of silently freezing the replica at a stale
    version.

    Every poll is lock-free until the install: listdir, marker read,
    checksum, payload load and shape check all happen outside any
    lock, and the install is the one-assignment swap under the
    version-map lock. ``latest()`` on a replica is therefore exactly
    as cheap as on the primary.

    Read-only by contract: torn dirs (a publisher mid-commit), corrupt
    payloads, fenced zombie commits, and dirs GC'd mid-tail are
    counted and reported (``summary()["replication"]``), never
    deleted or renamed — the store belongs to the lease holder.
    """

    def __init__(self, registry_dir: str, *, name: str = "replica-0",
                 keep: int = 4, staleness_ms: float = 500.0,
                 poll_s: float = 0.02, metrics=None, start: bool = True,
                 max_restarts: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if staleness_ms <= 0:
            raise ValueError(
                f"staleness_ms must be > 0, got {staleness_ms}"
            )
        self.registry_dir = registry_dir
        self.name = name
        self.keep = keep
        self.staleness_ms = float(staleness_ms)
        self.poll_s = float(poll_s)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._versions: dict[int, BasisVersion] = {}
        self._latest: BasisVersion | None = None
        self._max_epoch = 0
        self._closing = threading.Event()
        self._wake = threading.Event()
        # single-writer fields (watcher lane only; readers may observe
        # them racily — they are monotone counters, not invariants)
        self._seen: set[int] = set()
        # the construction scan replays HISTORY: those installs carry
        # no propagation lag (a warm restart catching up on versions
        # committed hours ago is not a staleness breach)
        self._catching_up = True
        self.installs = 0
        #: installs whose lineage carries ``grew_from`` — elastic-k
        #: widenings tailed off the store; the health
        #: snapshot surfaces the count so a fleet dashboard can tell
        #: grown hot-swaps from full refits
        self.grown_installs = 0
        self.fenced: list[int] = []
        self.torn_pending: set[int] = set()
        self.retired_mid_tail = 0
        self.corrupt_skipped = 0
        self.last_lag_ms: float | None = None
        self.max_lag_ms = 0.0
        self.stale_installs = 0
        #: versions installed by the CONSTRUCTION scan — the replica
        #: warm-restart report (mirrors the registry's recovery report)
        self.recovered_versions: list[int] = []
        self._watchdog = None
        os.makedirs(registry_dir, exist_ok=True)
        self._poll_once()
        self._catching_up = False
        self.recovered_versions = sorted(self._versions)
        if start:
            self.start(max_restarts=max_restarts)

    # -- watcher lane --------------------------------------------------------

    def start(self, *, max_restarts: int = 3) -> "ReplicaRegistry":
        if self._watchdog is not None and self._watchdog.alive:
            return self
        self._watchdog = LaneWatchdog(
            f"replica-watch-{self.name}", self._watch_loop,
            max_restarts=max_restarts,
            on_restart=lambda ev: self._event(
                "watch_restart", replica=self.name,
                error=ev.get("error"), attempt=ev.get("attempt"),
            ),
            on_dead=lambda e: self._event(
                "watch_dead", replica=self.name, error=repr(e),
            ),
        ).start()
        return self

    def _watch_loop(self) -> None:
        while not self._closing.is_set():
            self._poll_once()
            self._wake.wait(self.poll_s)
            self._wake.clear()
        # clean return = drain: the watchdog records no death

    def poke(self) -> None:
        """Wake the watcher immediately (a test/bench lever, not part
        of the propagation protocol — the poll interval is)."""
        self._wake.set()

    def _poll_once(self) -> None:
        """One tail pass over the store: verify and install every newly
        committed version, oldest first. All IO outside the lock; each
        install is one swap under it."""
        try:
            names = os.listdir(self.registry_dir)
        except FileNotFoundError:
            return  # store not created yet — nothing to tail
        pending: list[int] = []
        for fname in names:
            m = _VERSION_DIR_RE.match(fname)
            if m is not None:
                version = int(m.group(1))
                if version not in self._seen:
                    pending.append(version)
        for version in sorted(pending):
            self._ingest(version)

    def _ingest(self, version: int) -> None:
        """Verify one on-disk version and install it. Every skip is
        loud (counted + evented); only a complete, checksum-valid,
        unfenced commit reaches the swap."""
        vdir = os.path.join(self.registry_dir, f"v{version:08d}")
        meta_path = os.path.join(vdir, "meta.json")
        meta = _read_json(meta_path)
        if meta is None:
            # torn: payload without marker — the publish has not
            # happened yet (or never will); re-check next poll
            if version not in self.torn_pending:
                self.torn_pending.add(version)
                self._event(
                    "torn_seen", replica=self.name, version=version,
                )
            return
        self.torn_pending.discard(version)
        epoch = int(meta.get("epoch", 0))
        if epoch < self._max_epoch:
            # zombie ex-publisher commit: fence it — never serve,
            # never install, never touch the store
            self._seen.add(version)
            self.fenced.append(version)
            self._event(
                "fenced", replica=self.name, version=version,
                epoch=epoch, fencing_epoch=self._max_epoch,
            )
            return
        try:
            # shared committed-read: verifies the single checksum or —
            # a sharded publish — EVERY per-shard checksum, so a torn
            # or rotted shard is skipped here exactly as recovery
            # quarantines it; sharded versions install with their
            # PartitionSpec and row partition intact
            v, st, spec, shard_sizes = _load_committed_payload(
                vdir, meta, require_checksum=False
            )
        except FileNotFoundError:
            # GC'd between marker read and payload read (we are past
            # the grace window — a badly lagged replica): the version
            # is retired, which is a terminal, non-error answer
            self._seen.add(version)
            self.retired_mid_tail += 1
            self._event(
                "retired_mid_tail", replica=self.name, version=version,
            )
            return
        except Exception as e:
            self._seen.add(version)
            self.corrupt_skipped += 1
            self._event(
                "corrupt_skipped", replica=self.name, version=version,
                error=repr(e),
            )
            return
        sig = tuple(meta.get("signature") or v.shape)
        if v.shape != sig:
            self._seen.add(version)
            self.corrupt_skipped += 1
            self._event(
                "corrupt_skipped", replica=self.name, version=version,
                error=f"payload shape {v.shape} != signature {sig}",
            )
            return
        bv = BasisVersion(
            version=version,
            v=v,
            sigma_tilde=st,
            signature=(int(sig[0]), int(sig[1])),
            step=int(meta.get("step", 0)),
            explained_variance=dict(meta.get("explained_variance") or {}),
            lineage=dict(meta.get("lineage") or {}),
            spec=spec,
            shard_sizes=shard_sizes,
        )
        t_commit = meta.get("t_commit_unix")
        lag_ms = (
            max(0.0, (time.time() - float(t_commit)) * 1e3)
            if t_commit is not None and not self._catching_up
            else None
        )
        with self._lock:
            self._install_locked(bv, epoch)
        self._seen.add(version)
        self.installs += 1
        grew_from = bv.lineage.get("grew_from")
        if grew_from is not None:
            self.grown_installs += 1
        stale = lag_ms is not None and lag_ms > self.staleness_ms
        if lag_ms is not None:
            self.last_lag_ms = lag_ms
            self.max_lag_ms = max(self.max_lag_ms, lag_ms)
        self._event(
            "install", replica=self.name, version=version,
            epoch=epoch, lag_ms=lag_ms, stale=stale,
            grew_from=grew_from,
        )
        if stale:
            self.stale_installs += 1
            self._event(
                "stale", replica=self.name, version=version,
                lag_ms=lag_ms, staleness_ms=self.staleness_ms,
            )

    def _install_locked(self, bv: BasisVersion, epoch: int) -> None:
        """The registry's swap, replica edition: map insert, one-assignment
        latest update (guarded monotone), memory GC to ``keep``."""
        self._versions[bv.version] = bv
        if self._latest is None or bv.version > self._latest.version:
            self._latest = bv
        self._max_epoch = max(self._max_epoch, epoch)
        while len(self._versions) > self.keep:
            del self._versions[min(self._versions)]

    # -- read side (the QueryServer-facing registry surface) -----------------

    def latest(self) -> BasisVersion | None:
        """The newest installed version — lock-free, same contract as
        ``EigenbasisRegistry.latest()`` (a ``QueryServer`` can serve
        straight off a replica)."""
        return self._latest

    def get(self, version: int) -> BasisVersion:
        with self._lock:
            try:
                return self._versions[version]
            except KeyError:
                retained = sorted(self._versions)
            fenced = version in self.fenced
        if fenced:
            raise VersionRetired(
                f"version {version} was FENCED on replica "
                f"{self.name!r}: committed by a zombie ex-publisher "
                f"below fencing epoch {self._max_epoch} — it was never "
                "served and never will be"
            )
        raise VersionRetired(
            f"version {version} is not retained on replica "
            f"{self.name!r}: the replica keeps the newest {self.keep} "
            f"versions (currently retained: {retained}) — raise "
            "serve_keep_versions to widen the retention window"
        ) from None

    def versions(self) -> list[int]:
        with self._lock:
            return sorted(self._versions)

    def __len__(self) -> int:
        with self._lock:
            return len(self._versions)

    def version_lag(self, committed_latest: int | None = None
                    ) -> int | None:
        """Versions behind the committed store head. With no argument
        the head is re-read from disk (one listdir — a monitoring
        call, not a hot-path one)."""
        if committed_latest is None:
            try:
                names = os.listdir(self.registry_dir)
            except FileNotFoundError:
                return None
            ids = [
                int(m.group(1))
                for m in (_VERSION_DIR_RE.match(n) for n in names)
                if m is not None
            ]
            if not ids:
                return None
            committed_latest = max(ids)
        mine = self._latest
        return committed_latest - (0 if mine is None else mine.version)

    def health(self) -> dict:
        """Per-replica liveness + staleness snapshot (merged into
        ``summary()["replication"]["replicas"]`` by the bench/chaos
        drivers)."""
        wd = self._watchdog
        return {
            "replica": self.name,
            "alive": bool(wd is not None and wd.alive),
            "restarts": 0 if wd is None else wd.restarts,
            "installs": self.installs,
            "grown_installs": self.grown_installs,
            "latest": (
                None if self._latest is None else self._latest.version
            ),
            "max_epoch": self._max_epoch,
            "fenced": len(self.fenced),
            "torn_pending": len(self.torn_pending),
            "retired_mid_tail": self.retired_mid_tail,
            "corrupt_skipped": self.corrupt_skipped,
            "last_lag_ms": self.last_lag_ms,
            "max_lag_ms": self.max_lag_ms,
            "stale_installs": self.stale_installs,
            "staleness_ms": self.staleness_ms,
        }

    def _event(self, kind: str, **fields) -> None:
        if self.metrics is not None:
            self.metrics.replication({"kind": kind, **fields})

    def close(self) -> None:
        """Stop the watcher lane (clean drain, never a ledgered
        death) and join it."""
        self._closing.set()
        self._wake.set()
        wd = self._watchdog
        if wd is not None:
            wd.close()
            wd.join(timeout=5.0)

    def __enter__(self) -> "ReplicaRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
