"""The port's replicated registry (serving/replication.py) and the
registry's lease, grace window and payload reads, against the reference's
behaviours (``tests/test_replication.py``, test for test) and across the
two packages, on the CPU.

The contracts: the lease state machine (fresh acquire -> epoch 1, expiry
-> takeover at epoch + 1, renew never resurrects a lapsed lease, release
keeps the epoch watermark); the store refusing a zombie's publish
(``LeaseLost`` before an id is assigned); a replica fencing a stale-epoch
commit, retrying a torn one and counting, never deleting, a corrupt one;
warm restarts bit-exact; ``DriftMonitor`` publishing only through the
lease holder; ``VersionRetired`` as the read side's only terminal answer,
the disk grace window included; grown versions tailed with their lineage.
Across packages, a store committed by either package's registry (and
lease) is tailed by the other package's replica bit for bit. The reference
test's ``MetricsLogger`` assertions read the same numbers from the
counters here (``MetricsLogger`` is not ported).
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from distributed_eigenspaces_tpu.serving.registry import EigenbasisRegistry as JaxRegistry
from distributed_eigenspaces_tpu.serving.replication import (
    PublisherLease as JaxLease,
    ReplicaRegistry as JaxReplica,
)
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.serving import (
    DriftMonitor,
    EigenbasisRegistry,
    LeaseLost,
    PublisherLease,
    ReplicaRegistry,
    VersionRetired,
)

D, K = 16, 2


def _cfg(**kw):
    base = dict(
        dim=D, k=K, num_workers=2, rows_per_worker=8, num_steps=2,
        serve_bucket_size=2, serve_flush_s=0.01,
    )
    base.update(kw)
    return PCAConfig(**base)


def _basis(d=D, k=K, seed=0):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.standard_normal((d, k)))[0].astype(
        np.float32
    )


class _Clock:
    """Injectable wall clock for the lease TTL state machine (the
    lease never sleeps on this — expiry is pure stamp arithmetic)."""

    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _StaleLease:
    """A forged publisher credential pinned at an old fencing epoch —
    what a zombie ex-publisher's in-memory state looks like the
    instant after a standby took over."""

    def __init__(self, epoch):
        self.epoch = epoch

    def ensure(self):
        pass


# -- publisher lease state machine ------------------------------------------


class TestPublisherLease:
    def test_fresh_acquire_starts_at_epoch_one(self, tmp_path):
        clock = _Clock()
        a = PublisherLease(
            str(tmp_path), owner="a", lease_ms=1000.0, clock=clock
        )
        assert a.try_acquire() is True
        assert a.epoch == 1
        assert a.held is True
        assert a.takeovers == 0
        rec = json.load(open(a.path))
        assert rec["owner"] == "a" and rec["epoch"] == 1

    def test_live_lease_blocks_second_owner(self, tmp_path):
        clock = _Clock()
        a = PublisherLease(
            str(tmp_path), owner="a", lease_ms=1000.0, clock=clock
        )
        b = PublisherLease(
            str(tmp_path), owner="b", lease_ms=1000.0, clock=clock
        )
        assert a.try_acquire()
        assert b.try_acquire() is False
        assert b.held is False
        with pytest.raises(LeaseLost, match="'a'"):
            b.acquire(timeout_s=0.05, poll_s=0.01)

    def test_expired_lease_takeover_bumps_epoch(self, tmp_path):
        clock = _Clock()
        a = PublisherLease(
            str(tmp_path), owner="a", lease_ms=1000.0, clock=clock
        )
        b = PublisherLease(
            str(tmp_path), owner="b", lease_ms=1000.0, clock=clock,
        )
        assert a.try_acquire() and a.epoch == 1
        clock.advance(1.1)  # past a's expiry stamp
        assert b.try_acquire() is True
        assert b.epoch == 2
        assert b.takeovers == 1
        assert a.takeovers == 0

    def test_renew_extends_then_lapse_raises(self, tmp_path):
        clock = _Clock()
        a = PublisherLease(
            str(tmp_path), owner="a", lease_ms=1000.0, clock=clock
        )
        a.try_acquire()
        clock.advance(0.9)
        assert a.check() is True
        a.renew()  # pushes expiry to t+1.0 again
        clock.advance(0.9)
        assert a.check() is True
        # let it lapse: renew must NOT resurrect (a standby may be
        # mid-takeover on the expired record)
        clock.advance(0.2)
        with pytest.raises(LeaseLost):
            a.renew()
        assert a.held is False

    def test_zombie_ensure_names_new_holder(self, tmp_path):
        clock = _Clock()
        a = PublisherLease(
            str(tmp_path), owner="a", lease_ms=1000.0, clock=clock
        )
        b = PublisherLease(
            str(tmp_path), owner="b", lease_ms=1000.0, clock=clock
        )
        a.try_acquire()
        clock.advance(1.5)
        b.try_acquire()
        assert a.check() is False
        with pytest.raises(LeaseLost, match="'b'"):
            a.ensure()
        assert a.held is False
        # the new holder is unaffected by the zombie's failure
        assert b.check() is True

    def test_release_preserves_epoch_watermark(self, tmp_path):
        clock = _Clock()
        a = PublisherLease(
            str(tmp_path), owner="a", lease_ms=1000.0, clock=clock
        )
        a.try_acquire()
        a.release()
        assert a.held is False
        # the record survives release (expired in place) so the next
        # holder's epoch still fences every commit "a" ever stamped
        rec = json.load(open(a.path))
        assert rec["epoch"] == 1
        b = PublisherLease(
            str(tmp_path), owner="b", lease_ms=1000.0, clock=clock
        )
        assert b.try_acquire() is True
        assert b.epoch == 2

    def test_heartbeat_keeps_lease_live_then_lapse(self, tmp_path):
        # a 2 s lease renewed every 0.1 s: the heartbeat thread may go
        # unscheduled for over a second on a loaded machine and the lease
        # still holds, so the check reads the heartbeat, not the scheduler
        lease_ms, beat_s = 2000.0, 0.1
        a = PublisherLease(str(tmp_path), owner="a", lease_ms=lease_ms)
        b = PublisherLease(str(tmp_path), owner="b", lease_ms=lease_ms)
        a.acquire(timeout_s=5.0).start_heartbeat(interval_s=beat_s)
        try:
            # live across ten beats
            deadline = time.monotonic() + 1.0
            while time.monotonic() < deadline:
                assert a.check() is True
                assert b.try_acquire() is False
                time.sleep(0.05)
        finally:
            a.stop_heartbeat()
        # heartbeat stopped == kill -9 aftermath: the record lapses
        # naturally and the standby wins once the lease runs out
        b.acquire(timeout_s=5 * lease_ms / 1e3)
        assert b.epoch == a.epoch + 1

    def test_store_rejects_zombie_publish_before_id_assignment(
        self, tmp_path
    ):
        clock = _Clock()
        reg_dir = str(tmp_path / "reg")
        a = PublisherLease(
            reg_dir, owner="a", lease_ms=1000.0, clock=clock
        )
        a.try_acquire()
        reg = EigenbasisRegistry(registry_dir=reg_dir, lease=a)
        v1 = reg.publish(_basis(seed=1))
        meta = json.load(
            open(os.path.join(reg_dir, "v00000001", "meta.json"))
        )
        assert meta["epoch"] == 1
        clock.advance(1.5)
        b = PublisherLease(
            reg_dir, owner="b", lease_ms=1000.0, clock=clock
        )
        b.try_acquire()
        with pytest.raises(LeaseLost, match="'b'"):
            reg.publish(_basis(seed=2))
        # the refused publish assigned NO id: the store head is
        # untouched and the next legitimate publish is v2
        assert reg.latest().version == v1.version
        reg_b = EigenbasisRegistry(registry_dir=reg_dir, lease=b)
        assert reg_b.publish(_basis(seed=3)).version == 2


# -- replica tailing ---------------------------------------------------------


class TestReplicaRegistry:
    def test_catch_up_installs_carry_no_lag(self, tmp_path):
        reg_dir = str(tmp_path / "reg")
        reg = EigenbasisRegistry(registry_dir=reg_dir)
        w1, w2 = _basis(seed=1), _basis(seed=2)
        reg.publish(w1)
        reg.publish(w2)
        rep = ReplicaRegistry(reg_dir, name="r0", start=False)
        assert rep.recovered_versions == [1, 2]
        assert rep.latest().version == 2
        np.testing.assert_array_equal(rep.latest().v, w2)
        np.testing.assert_array_equal(rep.get(1).v, w1)
        # history replay is a warm restart, not a staleness breach
        assert rep.stale_installs == 0
        assert rep.last_lag_ms is None

    def test_live_install_past_bound_counts_stale(self, tmp_path):
        reg_dir = str(tmp_path / "reg")
        reg = EigenbasisRegistry(registry_dir=reg_dir)
        rep = ReplicaRegistry(
            reg_dir, name="r0", staleness_ms=1.0, start=False
        )
        reg.publish(_basis(seed=1))
        time.sleep(0.05)  # the replica lags well past its 1ms bound
        rep._poll_once()
        assert rep.installs == 1
        assert rep.latest().version == 1
        assert rep.last_lag_ms is not None and rep.last_lag_ms > 1.0
        assert rep.stale_installs == 1

    def test_stale_epoch_commit_fenced_never_served(self, tmp_path):
        clock = _Clock()
        reg_dir = str(tmp_path / "reg")
        a = PublisherLease(
            reg_dir, owner="a", lease_ms=1000.0, clock=clock
        )
        a.try_acquire()
        clock.advance(1.5)
        b = PublisherLease(
            reg_dir, owner="b", lease_ms=1000.0, clock=clock
        )
        b.try_acquire()  # fencing epoch is now 2
        reg = EigenbasisRegistry(registry_dir=reg_dir, lease=b)
        w1 = _basis(seed=1)
        reg.publish(w1)
        rep = ReplicaRegistry(reg_dir, name="r0", start=False)
        assert rep.latest().version == 1
        # forge a zombie commit below the fencing epoch (the store
        # would refuse via ensure(); the forged credential bypasses
        # it to prove the replica's own fence)
        reg_zombie = EigenbasisRegistry(
            registry_dir=reg_dir, lease=_StaleLease(1)
        )
        forged = reg_zombie.publish(_basis(seed=9))
        rep._poll_once()
        assert forged.version in rep.fenced
        assert rep.latest().version == 1
        np.testing.assert_array_equal(rep.latest().v, w1)
        with pytest.raises(VersionRetired, match="FENCED"):
            rep.get(forged.version)

    def test_torn_commit_retried_until_marker_lands(self, tmp_path):
        reg_dir = str(tmp_path / "reg")
        os.makedirs(os.path.join(reg_dir, "v00000001"))
        w = _basis(seed=4)
        np.savez(
            os.path.join(reg_dir, "v00000001", "basis.npz"), v=w
        )
        rep = ReplicaRegistry(reg_dir, name="r0", start=False)
        # payload without marker: the publish has not happened yet
        assert rep.latest() is None
        assert rep.torn_pending == {1}
        rep._poll_once()  # still torn — retried, never abandoned
        assert rep.torn_pending == {1}
        with open(
            os.path.join(reg_dir, "v00000001", "meta.json"), "w"
        ) as f:
            json.dump({
                "version": 1, "signature": [D, K], "epoch": 0,
                "step": 0, "t_commit_unix": time.time(),
            }, f)
        rep._poll_once()
        assert rep.torn_pending == set()
        assert rep.latest().version == 1
        np.testing.assert_array_equal(rep.latest().v, w)

    def test_warm_restart_is_bit_exact(self, tmp_path):
        reg_dir = str(tmp_path / "reg")
        reg = EigenbasisRegistry(registry_dir=reg_dir)
        w2 = _basis(seed=2)
        reg.publish(_basis(seed=1))
        reg.publish(w2)
        rep1 = ReplicaRegistry(reg_dir, name="r0", start=False)
        before = np.asarray(rep1.latest().v).copy()
        rep1.close()
        rep2 = ReplicaRegistry(reg_dir, name="r0", start=False)
        assert rep2.recovered_versions == [1, 2]
        np.testing.assert_array_equal(rep2.latest().v, before)
        np.testing.assert_array_equal(rep2.latest().v, w2)

    def test_version_lag_and_health_snapshot(self, tmp_path):
        reg_dir = str(tmp_path / "reg")
        reg = EigenbasisRegistry(registry_dir=reg_dir)
        reg.publish(_basis(seed=1))
        rep = ReplicaRegistry(reg_dir, name="r0", start=False)
        assert rep.version_lag() == 0
        reg.publish(_basis(seed=2))  # committed, not yet tailed
        assert rep.version_lag() == 1
        rep._poll_once()
        assert rep.version_lag() == 0
        h = rep.health()
        assert h["replica"] == "r0"
        assert h["installs"] == 2
        assert h["latest"] == 2
        assert h["stale_installs"] == 0
        for key in ("alive", "fenced", "torn_pending", "max_lag_ms",
                    "staleness_ms"):
            assert key in h

    def test_watcher_lane_tails_live_publishes(self, tmp_path):
        reg_dir = str(tmp_path / "reg")
        reg = EigenbasisRegistry(registry_dir=reg_dir)
        rep = ReplicaRegistry(reg_dir, name="r0", poll_s=0.005)
        try:
            assert rep.health()["alive"] is True
            reg.publish(_basis(seed=1))
            rep.poke()
            deadline = time.monotonic() + 5.0
            while rep.latest() is None:
                assert time.monotonic() < deadline, (
                    "watcher never installed the live publish"
                )
                time.sleep(0.005)
            assert rep.latest().version == 1
        finally:
            rep.close()
        assert rep.health()["alive"] is False


# -- drift republish through the lease ---------------------------------------


class TestDriftLeaseGate:
    def _monitor(self, lease):
        reg = EigenbasisRegistry()
        reg.publish(_basis(seed=0))

        def refit(rows):
            # orthonormal but far from the live basis: a large
            # principal angle guarantees the score clears threshold
            return _basis(seed=77), None

        mon = DriftMonitor(
            reg, _cfg(), threshold=0.01, auto=False, refit=refit,
            lease=lease,
        )
        mon.observe(
            9.0, 10.0, rows=np.ones((32, D), np.float32)
        )
        return reg, mon

    def test_non_holder_refresh_is_rejected_loudly(self, tmp_path):
        clock = _Clock()
        a = PublisherLease(
            str(tmp_path), owner="a", lease_ms=1000.0, clock=clock
        )
        a.try_acquire()
        clock.advance(1.5)
        b = PublisherLease(
            str(tmp_path), owner="b", lease_ms=1000.0, clock=clock
        )
        b.try_acquire()  # "a" is now a zombie
        reg, mon = self._monitor(a)
        assert mon.refresh_now() is None
        assert mon.publishes_rejected == 1
        # drift was CONFIRMED (score computed, refresh counted) —
        # only the publish was dropped, and the store never moved
        assert mon.refreshes == 1
        assert mon.last_score is not None
        assert mon.last_score >= mon.threshold
        assert reg.latest().version == 1

    def test_lease_holder_refresh_publishes(self, tmp_path):
        clock = _Clock()
        a = PublisherLease(
            str(tmp_path), owner="a", lease_ms=1000.0, clock=clock
        )
        a.try_acquire()
        reg, mon = self._monitor(a)
        v2 = mon.refresh_now()
        assert v2 is not None and v2.version == 2
        assert reg.latest().version == 2
        assert mon.publishes_rejected == 0

    def test_no_lease_preserves_single_writer_behavior(self):
        # the single-writer deployment: no lease configured means
        # no gate — the monitor publishes exactly as before
        reg, mon = self._monitor(None)
        assert mon.refresh_now() is not None
        assert reg.latest().version == 2


# -- GC racing the lock-free reader ------------------------------------------


class TestGCReaderRace:
    def test_gcd_version_raises_version_retired_not_keyerror_int(
        self, tmp_path
    ):
        reg = EigenbasisRegistry(
            keep=2, registry_dir=str(tmp_path / "reg")
        )
        for s in range(4):
            reg.publish(_basis(seed=s))
        with pytest.raises(VersionRetired, match="retained"):
            reg.get(1)
        # VersionRetired IS a KeyError: dict-style callers still work
        assert issubclass(VersionRetired, KeyError)

    def test_disk_grace_window_then_retired(self, tmp_path):
        reg = EigenbasisRegistry(
            keep=1, registry_dir=str(tmp_path / "reg"),
            retire_grace_s=0.2,
        )
        w1 = _basis(seed=1)
        reg.publish(w1)
        reg.publish(_basis(seed=2))
        # v1 left MEMORY immediately...
        with pytest.raises(VersionRetired):
            reg.get(1)
        # ...but the disk tier honors the grace window: a replica
        # mid-tail between marker read and payload read still wins
        np.testing.assert_array_equal(reg.load_payload(1), w1)
        time.sleep(0.25)
        reg.sweep_retired()
        with pytest.raises(VersionRetired, match="grace"):
            reg.load_payload(1)

    def test_load_payload_never_filenotfound(self, tmp_path):
        reg = EigenbasisRegistry(
            keep=1, registry_dir=str(tmp_path / "reg")
        )
        reg.publish(_basis(seed=1))
        reg.publish(_basis(seed=2))  # v1 GC'd with zero grace
        try:
            reg.load_payload(1)
        except VersionRetired:
            pass
        except FileNotFoundError:  # pragma: no cover - the regression
            pytest.fail(
                "dangling-path FileNotFoundError leaked to the "
                "reader; retirement must be the only terminal answer"
            )
        else:
            pytest.fail("expected VersionRetired for a GC'd payload")

    def test_concurrent_reader_only_ever_sees_version_retired(
        self, tmp_path
    ):
        reg = EigenbasisRegistry(
            keep=2, registry_dir=str(tmp_path / "reg")
        )
        reg.publish(_basis(seed=0))
        stop = threading.Event()
        bad: list[BaseException] = []

        def reader():
            rng = np.random.default_rng(3)
            while not stop.is_set():
                head = reg.latest()
                if head is None:
                    continue
                # deliberately read BEHIND the head so GC races us
                victim = max(1, head.version - int(rng.integers(4)))
                for read in (reg.get, reg.load_payload):
                    try:
                        got = read(victim)
                    except VersionRetired:
                        continue  # the one terminal answer allowed
                    except BaseException as e:  # noqa: BLE001
                        bad.append(e)
                        stop.set()
                        return
                    arr = got.v if hasattr(got, "v") else got
                    assert arr.shape == (D, K)

        threads = [
            threading.Thread(target=reader) for _ in range(3)
        ]
        for t in threads:
            t.start()
        try:
            for s in range(1, 24):
                reg.publish(_basis(seed=s))
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10.0)
        assert not bad, f"non-retirement errors leaked: {bad!r}"

    def test_replica_get_on_gcd_version_names_replica(self, tmp_path):
        reg_dir = str(tmp_path / "reg")
        reg = EigenbasisRegistry(keep=4, registry_dir=reg_dir)
        for s in range(4):
            reg.publish(_basis(seed=s))
        rep = ReplicaRegistry(
            reg_dir, name="r0", keep=2, start=False
        )
        assert rep.versions() == [3, 4]
        with pytest.raises(VersionRetired, match="'r0'"):
            rep.get(1)


# -- elastic-k lineage through replication -----------------------------------


def _grown_from(parent, k1, seed=9):
    """Widen ``parent`` to k1 columns keeping the prefix bit-exact."""
    rng = np.random.default_rng(seed)
    d, k0 = parent.shape
    extra = rng.standard_normal((d, k1 - k0)).astype(np.float32)
    extra -= parent @ (parent.T @ extra)
    extra = np.linalg.qr(extra)[0].astype(np.float32)
    return np.concatenate([parent, extra], axis=1)


class TestGrownReplication:
    def test_grown_version_tails_with_lineage(self, tmp_path):
        """A replica that tails a grown publish counts it in
        ``grown_installs`` and serves the widened basis with the
        lineage intact — elastic k is a product surface, so the
        follower fleet must see WHY a version widened, not just that
        it did."""
        td = str(tmp_path / "reg")
        reg = EigenbasisRegistry(registry_dir=td)
        parent = _basis(seed=3)
        grown = _grown_from(parent, K + 2)
        bv0 = reg.publish(parent)
        rep = ReplicaRegistry(td, name="r0", start=False)
        rep._poll_once()
        assert rep.grown_installs == 0
        bv1 = reg.publish_grown(bv0, grown)
        rep._poll_once()
        assert rep.grown_installs == 1
        lv = rep.latest()
        assert lv.version == bv1.version
        assert lv.lineage["grew_from"] == bv0.version
        assert lv.lineage["k_from"] == K
        assert lv.lineage["k_to"] == K + 2
        np.testing.assert_array_equal(
            np.asarray(lv.v)[:, :K], parent
        )
        health = rep.health()
        assert health["grown_installs"] == 1

    def test_grown_install_event_names_parent(self, tmp_path):
        """The replica's installed version carries ``grew_from`` so an
        operator can trace a width change from any follower, and so does
        the install event of its MetricsLogger, as the reference's."""
        from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

        td = str(tmp_path / "reg")
        reg = EigenbasisRegistry(registry_dir=td)
        parent = _basis(seed=4)
        bv0 = reg.publish(parent)
        bv1 = reg.publish_grown(bv0, _grown_from(parent, K + 1))
        logger = MetricsLogger()
        rep = ReplicaRegistry(td, name="r0", start=False, metrics=logger)
        rep._poll_once()
        assert rep.grown_installs == 1
        installs = [e for e in logger.replication_records
                    if e["replication"] == "install"]
        assert [e["grew_from"] for e in installs] == [None, bv0.version]
        got = rep.get(bv1.version)
        assert got.lineage["grew_from"] == bv0.version
        assert got.lineage["producer"] == "grow_basis"

    def test_lineage_outlives_parent_on_replica(self, tmp_path):
        """GC retires the parent everywhere, but the grown version a
        replica serves still names it: provenance is append-only even
        when liveness is not."""
        td = str(tmp_path / "reg")
        reg = EigenbasisRegistry(keep=2, registry_dir=td)
        parent = _basis(seed=5)
        bv0 = reg.publish(parent)
        bv1 = reg.publish_grown(bv0, _grown_from(parent, K + 2))
        reg.publish(_basis(seed=6))
        reg.publish(_basis(seed=7))
        rep = ReplicaRegistry(td, name="r0", keep=2, start=False)
        rep._poll_once()
        assert rep.versions() == [3, 4]
        with pytest.raises(VersionRetired, match="'r0'"):
            rep.get(bv1.version)
        with pytest.raises(VersionRetired):
            reg.get(bv0.version)


# -- what the reference's tests do not cover -----------------------------------


class TestReplicaNeverMutatesTheStore:
    def test_corrupt_and_torn_dirs_are_counted_never_deleted(self, tmp_path):
        reg_dir = str(tmp_path / "reg")
        reg = EigenbasisRegistry(registry_dir=reg_dir)
        reg.publish(_basis(seed=1))
        bad = reg.publish(_basis(seed=2))
        payload = os.path.join(reg_dir, f"v{bad.version:08d}", "basis.npz")
        raw = bytearray(open(payload, "rb").read())
        raw[-20] ^= 0xFF
        open(payload, "wb").write(bytes(raw))
        torn = os.path.join(reg_dir, "v00000003")
        os.makedirs(torn)
        np.savez(os.path.join(torn, "basis.npz"), v=_basis(seed=3))
        before = sorted(os.listdir(reg_dir))
        rep = ReplicaRegistry(reg_dir, name="r0", start=False)
        rep._poll_once()
        assert rep.latest().version == 1
        assert rep.corrupt_skipped == 1 and rep.torn_pending == {3}
        assert rep.health()["corrupt_skipped"] == 1
        assert sorted(os.listdir(reg_dir)) == before
        with pytest.raises(VersionRetired):
            rep.get(bad.version)

    def test_retire_grace_s_is_validated(self, tmp_path):
        with pytest.raises(ValueError, match="retire_grace_s"):
            EigenbasisRegistry(registry_dir=str(tmp_path), retire_grace_s=-1.0)
        with pytest.raises(ValueError, match="durable"):
            EigenbasisRegistry().load_payload(1)
        with pytest.raises(ValueError, match="lease_ms"):
            PublisherLease(str(tmp_path), lease_ms=0)
        with pytest.raises(ValueError, match="staleness_ms"):
            ReplicaRegistry(str(tmp_path), staleness_ms=0, start=False)

    def test_sweep_retired_force_drains_the_grace_queue(self, tmp_path):
        reg_dir = str(tmp_path / "reg")
        reg = EigenbasisRegistry(keep=1, registry_dir=reg_dir, retire_grace_s=60.0)
        reg.publish(_basis(seed=1))
        reg.publish(_basis(seed=2))
        assert os.path.isdir(os.path.join(reg_dir, "v00000001"))
        assert reg.sweep_retired() == []
        assert reg.sweep_retired(force=True) == [1]
        assert not os.path.exists(os.path.join(reg_dir, "v00000001"))


class TestAcrossPackages:
    """The store format, the markers' epochs and the lease record are the
    two packages' shared ones: either side's replica tails the other
    side's commits bit for bit, and the leases fence each other."""

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_replica_tails_the_other_package(self, tmp_path, writer):
        reg_dir = str(tmp_path / "reg")
        clock = _Clock()
        lease_cls, reg_cls = (JaxLease, JaxRegistry) if writer == "jax" else (
            PublisherLease, EigenbasisRegistry)
        replica_cls = ReplicaRegistry if writer == "jax" else JaxReplica
        lease = lease_cls(reg_dir, owner="w", lease_ms=1000.0, clock=clock)
        assert lease.try_acquire() and lease.epoch == 1
        reg = reg_cls(registry_dir=reg_dir, lease=lease)
        w1, w2 = _basis(seed=1), _basis(seed=2)
        st = np.eye(D, dtype=np.float32)
        reg.publish(w1, sigma_tilde=st, step=3, lineage={"producer": "test"})
        rep = replica_cls(reg_dir, name="r0", start=False)
        assert rep.recovered_versions == [1]
        reg.publish(w2, step=4)
        rep._poll_once()
        assert rep.installs == 2 and rep.latest().version == 2
        np.testing.assert_array_equal(np.asarray(rep.get(1).v), w1)
        np.testing.assert_array_equal(np.asarray(rep.get(1).sigma_tilde), st)
        np.testing.assert_array_equal(np.asarray(rep.latest().v), w2)
        assert rep.get(1).lineage["producer"] == "test" and rep.get(2).step == 4
        assert rep.health()["max_epoch"] == 1

    @pytest.mark.parametrize("first", ["jax", "torch"])
    def test_leases_fence_across_packages(self, tmp_path, first):
        reg_dir = str(tmp_path / "reg")
        clock = _Clock()
        (a_lease, a_reg), (b_lease, b_reg) = (
            ((JaxLease, JaxRegistry), (PublisherLease, EigenbasisRegistry))
            if first == "jax" else
            ((PublisherLease, EigenbasisRegistry), (JaxLease, JaxRegistry)))
        a = a_lease(reg_dir, owner="a", lease_ms=1000.0, clock=clock)
        b = b_lease(reg_dir, owner="b", lease_ms=1000.0, clock=clock)
        assert a.try_acquire() and not b.try_acquire()
        ra = a_reg(registry_dir=reg_dir, lease=a)
        ra.publish(_basis(seed=1))
        clock.advance(1.5)
        assert b.try_acquire() and b.epoch == 2
        with pytest.raises(Exception, match="'b'") as e:
            ra.publish(_basis(seed=2))
        assert type(e.value).__name__ == "LeaseLost"
        rb = b_reg(registry_dir=reg_dir, lease=b)
        assert rb.publish(_basis(seed=3)).version == 2
        for rep in (ReplicaRegistry(reg_dir, start=False), JaxReplica(reg_dir, start=False)):
            assert rep.versions() == [1, 2] and rep.health()["max_epoch"] == 2
