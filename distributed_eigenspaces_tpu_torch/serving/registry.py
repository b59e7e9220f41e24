"""Versioned eigenbasis registry: immutable publishes, lock-free reads.

The port's copy of ``distributed_eigenspaces_tpu/serving/registry.py``. It
is numpy and threads only, and its disk format is the reference's, byte
for byte (``format_version`` 1, ``basis.npz`` + ``meta.json``): a registry
directory written by the JAX package opens here, which is how a basis
crosses between the two packages. ``publish_fit`` takes the port's
estimator, whose basis lives on the card, and moves it to the host. A
sharded publish (``publish(v=[row shards] | spec= | num_shards=)``) writes
one checksummed ``basis.shardNN.npz`` a shard, each with its own atomic
rename, and a torn, missing or rotted shard fails its version alone and
loudly. A ``MetricsLogger`` (``metrics=``) receives the store's log lines
(recoveries, torn snapshots, quarantines, GC) as ``registry`` serve
events.

A live serving tier cannot hand queries a basis that is half-written,
and it cannot block the query path on a publisher's lock. Both follow
from one rule: a :class:`BasisVersion` is FULLY CONSTRUCTED (arrays
copied to host, frozen read-only, diagnostics computed) before the
registry ever sees it, and publication is a single reference assignment
— the CPython-atomic write readers observe either entirely or not at
all. ``latest()`` therefore takes no lock: an in-flight query batch
that grabbed version ``t`` keeps projecting against version ``t`` even
while ``t+1`` publishes and ``t-N`` is garbage-collected, because the
version object itself is immutable and reference-held.

Lineage makes a served projection auditable back to its producer: every
version records which trainer/checkpoint/fit made it, its step count,
and an explained-variance summary — the registry is the system of
record connecting the fit fleet's write side to the query tier's read
side.

**Durability.** With ``registry_dir`` set the registry gains a
disk tier: every accepted publish lands as one per-version directory
(``v00000042/``) holding the payload (``basis.npz`` — the frozen arrays,
written tmp-file + atomic-rename) and a ``meta.json`` commit marker
(signature, step, lineage, and a sha256 checksum of the payload bytes —
the ``utils/checkpoint.py`` discipline: a crash at ANY point leaves
either a fully committed version or no marker at all, never a committed
half-write). A restarted process constructing
``EigenbasisRegistry(registry_dir=...)`` recovers by scanning the store:
committed, checksum-valid versions load bit-exact (np.savez float32
round-trips exactly, so a warm-restarted server's transforms equal the
pre-crash ones bit for bit — zero refit); a TORN snapshot (payload, no
marker — a publisher killed mid-publish) is skipped loudly and removed;
a checksum-MISMATCHED version (tampering, disk rot) is quarantined
loudly (renamed ``*.quarantined``, evidence preserved) and never served.
GC applies to the disk tier too: the newest ``keep`` versions survive.

**Replication hooks.** The committed store is also the propagation bus of
``serving/replication.py``: ``ReplicaRegistry`` readers tail the commit
markers and install each version with the same one-assignment swap. Three
store-side mechanisms make that safe, as in the reference:

- every ``meta.json`` carries a ``t_commit_unix`` stamp and, when the
  publisher holds a ``PublisherLease``, the lease's fencing ``epoch``;
  recovery fences a commit whose epoch is lower than an earlier one's
  (renamed ``*.fenced``, never served);
- ``publish`` with a ``lease`` re-validates it before assigning a version
  id, so a zombie that lost its lease raises ``LeaseLost`` instead of
  committing;
- ``retire_grace_s`` defers disk GC: a retired version leaves memory at
  once, but its payload outlives retirement by the grace window, so a
  replica between marker read and payload read never sees a dangling path.

A sharded version (either package's) recovers with ``v`` the ordered row
concatenation, its ``spec`` and ``shard_sizes``; ``shard(i)`` is the unit a
sharded consumer places per rank.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Mapping

import numpy as np

__all__ = ["BasisVersion", "EigenbasisRegistry", "VersionRetired"]

_VERSION_DIR_RE = re.compile(r"^v(\d{8})$")


def _file_checksum(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _load_committed_payload(path: str, meta: dict, *, require_checksum: bool = True):
    """Read a committed version dir's payload against its marker: the
    single ``basis.npz`` (replicated publish) or every
    ``basis.shardNN.npz`` (sharded publish), each verified against ITS
    committed checksum before a byte of it is trusted — a torn,
    truncated, or rotted file fails loudly, and recovery quarantines the
    version (a replica's tail skips it). Returns ``(v, sigma_tilde, spec,
    shard_sizes)`` with ``v`` the ordered row concatenation.
    ``require_checksum=False`` (the replica tail) installs a replicated
    payload whose marker predates the checksum field unverified."""
    shards = meta.get("shards")
    if not shards:
        payload = os.path.join(path, "basis.npz")
        committed = meta.get("checksum")
        if committed is not None or require_checksum:
            checksum = _file_checksum(payload)
            if checksum != committed:
                raise ValueError(
                    f"checksum mismatch: payload {checksum[:12]}... "
                    f"!= committed {str(committed)[:12]}..."
                )
        with np.load(payload) as z:
            v = _frozen_array(z["v"])
            st = (
                _frozen_array(z["sigma_tilde"])
                if "sigma_tilde" in z.files else None
            )
        return v, st, None, None
    parts, st = [], None
    for i, entry in enumerate(shards):
        spath = os.path.join(path, entry["file"])
        if not os.path.exists(spath):
            # FileNotFoundError, so a read mid-GC maps to retirement;
            # recovery quarantines it (committed-but-missing = corrupt)
            raise FileNotFoundError(
                f"committed shard {i} missing: {entry['file']}"
            )
        checksum = _file_checksum(spath)
        if checksum != entry.get("checksum"):
            raise ValueError(
                f"shard {i} checksum mismatch: payload "
                f"{checksum[:12]}... != committed "
                f"{str(entry.get('checksum'))[:12]}..."
            )
        with np.load(spath) as z:
            part = _frozen_array(z["v"])
            if i == 0 and "sigma_tilde" in z.files:
                st = _frozen_array(z["sigma_tilde"])
        if part.shape[0] != int(entry["rows"]):
            raise ValueError(
                f"shard {i} has {part.shape[0]} rows, marker "
                f"committed {entry['rows']}"
            )
        parts.append(part)
    v = _frozen_array(np.concatenate(parts, axis=0))
    spec = tuple(meta["spec"]) if meta.get("spec") else None
    shard_sizes = tuple(int(e["rows"]) for e in shards)
    return v, st, spec, shard_sizes


class VersionRetired(KeyError):
    """A version id outside the registry's retention window (GC'd, or
    never published). A KeyError subclass so pre-existing callers keep
    working, but the message names the knob that widens the window."""


def _host(a) -> np.ndarray:
    """A torch tensor (on any device) or array as a host numpy array."""
    if hasattr(a, "detach"):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _frozen_array(a, dtype=np.float32) -> np.ndarray:
    """Host copy with the write flag dropped: the version's arrays must
    not be mutable through any alias — a publisher reusing its buffer
    would otherwise mutate a version already being served."""
    arr = np.array(np.asarray(a), dtype=dtype, copy=True)
    arr.setflags(write=False)
    return arr


@dataclasses.dataclass(frozen=True)
class BasisVersion:
    """One immutable published eigenbasis.

    Attributes:
      version: monotonically increasing id (assigned by the registry).
      v: ``(d, k)`` orthonormal basis, host-resident, read-only.
      sigma_tilde: optional ``(d, d)`` state snapshot the basis was
        extracted from (read-only; large — publishers may omit it).
      signature: ``(d, k)`` — the shape contract a query batch checks.
      step: the producing fit's online step count.
      explained_variance: summary diagnostics (e.g. the top-k energy
        fraction of the producing state) — what a dashboard shows next
        to the version id.
      lineage: provenance of the producing fit — trainer name,
        checkpoint path, fleet ticket, refit trigger — whatever the
        publisher knows. Stored as an immutable snapshot.
      spec, shard_sizes: the PartitionSpec (a tuple of mesh-axis names,
        e.g. ``("features", None)``: rows over the features axis) and the
        row count of each shard of a sharded version (``v`` is then the
        ordered row concatenation, persisted per shard); ``None`` for a
        replicated publish.
    """

    version: int
    v: np.ndarray
    sigma_tilde: np.ndarray | None
    signature: tuple[int, int]
    step: int
    explained_variance: dict[str, float]
    lineage: dict[str, Any]
    spec: tuple | None = None
    shard_sizes: tuple[int, ...] | None = None

    @property
    def d(self) -> int:
        return self.signature[0]

    @property
    def k(self) -> int:
        return self.signature[1]

    @property
    def num_shards(self) -> int:
        return 1 if self.shard_sizes is None else len(self.shard_sizes)

    def shard(self, i: int) -> np.ndarray:
        """Row block ``i`` of the basis (a read-only view): the unit a
        sharded consumer places per rank. ``shard(0)`` of a replicated
        version is the whole basis."""
        if self.shard_sizes is None:
            if i != 0:
                raise IndexError(
                    f"replicated version has 1 shard, asked for {i}"
                )
            return self.v
        if not (0 <= i < len(self.shard_sizes)):
            raise IndexError(
                f"shard {i} out of range for {len(self.shard_sizes)} shards"
            )
        off = int(sum(self.shard_sizes[:i]))
        return self.v[off:off + int(self.shard_sizes[i])]


class EigenbasisRegistry:
    """Append-only store of :class:`BasisVersion` with lock-free reads.

    ``publish`` validates and freezes the version OUTSIDE the lock,
    assigns the next id and the ``latest`` pointer inside it, and GCs
    down to the newest ``keep`` versions. ``latest()`` is a plain
    attribute read — never blocked by a publisher, never a torn value.

    ``registry_dir`` adds the crash-safe disk tier (module docstring):
    publish commits to disk BEFORE the in-memory swap (a publish the
    disk rejected is a loud error, not a version that would vanish on
    restart), and construction recovers every committed, checksum-valid
    version — ``recovered_versions`` / ``torn_skipped`` /
    ``quarantined`` report what the scan found.
    """

    def __init__(self, *, keep: int = 4, registry_dir: str | None = None,
                 metrics=None, lease=None, retire_grace_s: float = 0.0):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if retire_grace_s < 0:
            raise ValueError(
                f"retire_grace_s must be >= 0, got {retire_grace_s}"
            )
        self.keep = keep
        self.metrics = metrics
        self.registry_dir = registry_dir
        #: optional ``serving/replication.PublisherLease``: publish
        #: re-validates it (``lease.ensure()``) before assigning an id, and
        #: its fencing epoch is stamped into every commit marker
        self.lease = lease
        #: disk-GC grace window (seconds): a retired version's payload
        #: outlives its retirement by at least this long, so a replica
        #: between marker read and payload read never sees a dangling path
        self.retire_grace_s = retire_grace_s
        #: deferred disk retirements: (due_monotonic, version id),
        #: appended under the lock at GC time, swept outside it
        self._pending_retire: list[tuple[float, int]] = []
        self._lock = threading.Lock()
        self._versions: dict[int, BasisVersion] = {}
        self._latest: BasisVersion | None = None
        self._next_id = 1
        #: recovery report (populated when ``registry_dir`` is set):
        #: version ids loaded from disk, torn snapshot dirs removed,
        #: quarantined (checksum-mismatch) dir names, and fenced
        #: (stale-epoch zombie commit) dir names
        self.recovered_versions: list[int] = []
        self.torn_skipped: list[str] = []
        self.quarantined: list[str] = []
        self.fenced: list[str] = []
        if registry_dir is not None:
            os.makedirs(registry_dir, exist_ok=True)
            self._recover()

    # -- disk tier -----------------------------------------------------------

    def _version_dir(self, version: int) -> str:
        return os.path.join(self.registry_dir, f"v{version:08d}")

    def _write_payload(self, vdir: str, bv: BasisVersion) -> str:
        """The version's arrays via tmp + atomic rename; returns the
        committed payload's checksum."""
        os.makedirs(vdir, exist_ok=True)
        arrays = {"v": bv.v}
        if bv.sigma_tilde is not None:
            arrays["sigma_tilde"] = bv.sigma_tilde
        tmp = os.path.join(vdir, "basis.tmp.npz")
        np.savez(tmp, **arrays)
        final = os.path.join(vdir, "basis.npz")
        os.replace(tmp, final)
        return _file_checksum(final)

    def _write_payload_sharded(self, vdir: str, bv: BasisVersion) -> list[dict]:
        """A sharded version's payload: one ``basis.shardNN.npz`` a row
        shard, each tmp + atomic rename and checksummed on its own, so a
        torn or rotted shard is found by itself. ``sigma_tilde`` (if any)
        rides in shard 0. Returns the per-shard manifest the marker
        commits to."""
        os.makedirs(vdir, exist_ok=True)
        manifest = []
        for i in range(bv.num_shards):
            arrays = {"v": bv.shard(i)}
            if i == 0 and bv.sigma_tilde is not None:
                arrays["sigma_tilde"] = bv.sigma_tilde
            name = f"basis.shard{i:02d}.npz"
            tmp = os.path.join(vdir, f"basis.shard{i:02d}.tmp.npz")
            np.savez(tmp, **arrays)
            final = os.path.join(vdir, name)
            os.replace(tmp, final)
            manifest.append({"file": name, "rows": int(bv.shard_sizes[i]),
                             "checksum": _file_checksum(final)})
        return manifest

    def _write_meta(self, vdir: str, bv: BasisVersion, checksum: str | None,
                    shards: list[dict] | None = None) -> None:
        """The commit marker (tmp + atomic rename): a version without
        it is torn and recovery treats the publish as never having
        happened. Its fields are the reference's: a sharded version's
        marker carries the per-shard manifest (file, rows, checksum) and
        the PartitionSpec instead of the single ``checksum``; the
        ``epoch`` is the lease's, 0 for an unleased publisher."""
        meta = {
            "format_version": 1,
            "version": bv.version,
            "signature": list(bv.signature),
            "step": bv.step,
            "explained_variance": bv.explained_variance,
            # tuples JSON-round-trip as lists; lineage consumers treat
            # it as data, not identity, so that is acceptable loss
            "lineage": json.loads(
                json.dumps(bv.lineage, default=str)
            ),
            "checksum": checksum,
            "spec": list(bv.spec) if bv.spec is not None else None,
            "shards": shards,
            # replication bus fields: the wall-clock commit
            # stamp replicas measure propagation lag against, and the
            # publisher lease's fencing epoch (0 = unleased publisher;
            # older markers carry neither and read as epoch 0)
            "t_commit_unix": time.time(),
            "epoch": int(self.lease.epoch) if self.lease is not None else 0,
        }
        tmp = os.path.join(vdir, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, os.path.join(vdir, "meta.json"))

    def _persist(self, bv: BasisVersion) -> None:
        vdir = self._version_dir(bv.version)
        if bv.shard_sizes is not None:
            self._write_meta(vdir, bv, None,
                             shards=self._write_payload_sharded(vdir, bv))
        else:
            self._write_meta(vdir, bv, self._write_payload(vdir, bv))

    def _delete_version_dir(self, version: int) -> None:
        shutil.rmtree(self._version_dir(version), ignore_errors=True)

    def _retire_disk(self, gc_ids: list[int]) -> None:
        """Disk GC of freshly retired ids: deferred by ``retire_grace_s``
        (a replica that saw the commit marker gets that long to finish its
        payload read), else immediate."""
        if not gc_ids:
            self.sweep_retired()
            return
        if self.retire_grace_s <= 0:
            for vid in gc_ids:
                self._delete_version_dir(vid)
            return
        due = time.monotonic() + self.retire_grace_s
        with self._lock:
            self._pending_retire.extend((due, vid) for vid in gc_ids)
        self.sweep_retired()

    def sweep_retired(self, *, force: bool = False) -> list[int]:
        """Delete the deferred-retired version dirs whose grace window has
        elapsed (``force=True``: all of them, at teardown). Called from the
        publish path; returns the version ids deleted."""
        now = time.monotonic()
        with self._lock:
            if force:
                ready = [vid for _, vid in self._pending_retire]
                self._pending_retire = []
            else:
                ready = [vid for due, vid in self._pending_retire if due <= now]
                self._pending_retire = [
                    (due, vid) for due, vid in self._pending_retire if due > now
                ]
        for vid in ready:
            self._delete_version_dir(vid)
        return ready

    def _log(self, msg: str, **fields) -> None:
        from distributed_eigenspaces_tpu_torch.utils.metrics import log_line

        log_line(msg, **fields)
        if self.metrics is not None:
            self.metrics.serve({"kind": "registry", "event": msg, **fields})

    def _recover(self) -> None:
        """Scan the store: load committed, checksum-valid versions
        (newest ``keep``), remove torn snapshots loudly, quarantine
        checksum mismatches loudly. ``_next_id`` advances past EVERY id
        seen on disk — a quarantined id is never reused."""
        entries = []
        max_seen = 0
        for name in sorted(os.listdir(self.registry_dir)):
            m = _VERSION_DIR_RE.match(name)
            if not m:
                # ids renamed away by a PRIOR recovery (quarantined /
                # fenced evidence dirs) still count toward _next_id:
                # reusing one would collide with replicas that already
                # marked it seen-and-rejected
                mq = re.match(r"^v(\d{8})\.(?:quarantined|fenced)$", name)
                if mq:
                    max_seen = max(max_seen, int(mq.group(1)))
                continue
            version = int(m.group(1))
            max_seen = max(max_seen, version)
            path = os.path.join(self.registry_dir, name)
            meta_path = os.path.join(path, "meta.json")
            if not os.path.exists(meta_path):
                # torn: a publisher died between payload and marker —
                # the publish never happened; clear the debris
                self.torn_skipped.append(name)
                self._log(
                    "registry recovery: torn snapshot skipped",
                    version=version, path=path,
                )
                shutil.rmtree(path, ignore_errors=True)
                continue
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                v, st, spec, shard_sizes = _load_committed_payload(
                    path, meta
                )
                sig = tuple(meta["signature"])
                if v.shape != sig:
                    raise ValueError(
                        f"payload shape {v.shape} != committed "
                        f"signature {sig}"
                    )
                bv = BasisVersion(
                    version=version,
                    v=v,
                    sigma_tilde=st,
                    signature=(int(sig[0]), int(sig[1])),
                    step=int(meta.get("step", 0)),
                    explained_variance=dict(
                        meta.get("explained_variance") or {}
                    ),
                    lineage=dict(meta.get("lineage") or {}),
                    spec=spec,
                    shard_sizes=shard_sizes,
                )
                epoch = int(meta.get("epoch", 0))
            except Exception as e:
                # corrupt-but-committed (tamper, rot, truncation):
                # quarantine — never serve it, never silently delete
                # the evidence
                qpath = path + ".quarantined"
                shutil.rmtree(qpath, ignore_errors=True)
                os.replace(path, qpath)
                self.quarantined.append(os.path.basename(qpath))
                self._log(
                    "registry recovery: corrupt version quarantined",
                    version=version, path=qpath, error=repr(e),
                )
                continue
            entries.append((bv, epoch))
        entries.sort(key=lambda be: be[0].version)
        # epoch fencing: epochs must be non-decreasing in
        # version order — a commit from a LOWER epoch than an earlier
        # version is a zombie ex-publisher writing after failover.
        # Fence it loudly (evidence preserved), never serve it.
        kept: list[BasisVersion] = []
        max_epoch = 0
        for bv, epoch in entries:
            if epoch < max_epoch:
                path = self._version_dir(bv.version)
                fpath = path + ".fenced"
                shutil.rmtree(fpath, ignore_errors=True)
                os.replace(path, fpath)
                self.fenced.append(os.path.basename(fpath))
                self._log(
                    "registry recovery: stale-epoch commit fenced",
                    version=bv.version, epoch=epoch,
                    fencing_epoch=max_epoch, path=fpath,
                )
                continue
            max_epoch = max(max_epoch, epoch)
            kept.append(bv)
        entries = kept
        for bv in entries[:-self.keep] if len(entries) > self.keep else []:
            self._delete_version_dir(bv.version)
        entries = entries[-self.keep:]
        # install under the lock: recovery runs from __init__ today,
        # but these are the same shared fields publish()/latest() guard
        with self._lock:
            self._versions = {bv.version: bv for bv in entries}
            self._latest = entries[-1] if entries else None
            self._next_id = max_seen + 1
            self.recovered_versions = [bv.version for bv in entries]
        if entries:
            self._log(
                "registry recovery: warm store loaded",
                versions=self.recovered_versions,
                latest=self._latest.version,
            )

    # -- write side ----------------------------------------------------------

    def publish(
        self,
        v,
        *,
        sigma_tilde=None,
        step: int = 0,
        explained_variance: Mapping[str, float] | None = None,
        lineage: Mapping[str, Any] | None = None,
        spec=None,
        num_shards: int | None = None,
    ) -> BasisVersion:
        """Publish one basis as the new latest version; returns it.

        The basis is copied, frozen, and validated (2-D, finite) before
        the swap — a rejected publish leaves the registry untouched, and
        an accepted one is visible to ``latest()`` only as a complete
        version. With a ``lease`` attached, the lease is re-validated
        first (``lease.ensure()`` raises ``LeaseLost``): a zombie
        ex-publisher is rejected before it assigns an id or touches disk.

        ``v`` is the whole ``(d, k)`` basis or, a sharded publish, the
        ordered sequence of its row shards (tensors on any device or
        arrays; the rows concatenate on the host). ``spec`` records the
        PartitionSpec as a tuple of mesh-axis names (default ``("features",
        None)`` for a sharded publish); ``num_shards`` alone asks for a
        balanced row split of a whole ``v``.
        """
        if self.lease is not None:
            self.lease.ensure()
        shard_sizes = None
        if isinstance(v, (list, tuple)):
            parts = [_host(p) for p in v]
            if not parts or any(p.ndim != 2 for p in parts):
                raise ValueError(
                    "a sharded publish takes a non-empty sequence of "
                    f"(rows_i, k) row shards, got {len(parts)} parts "
                    f"with shapes {[p.shape for p in parts]}"
                )
            shard_sizes = tuple(int(p.shape[0]) for p in parts)
            arr = _frozen_array(np.concatenate(parts, axis=0))
        else:
            arr = _frozen_array(_host(v))
        if arr.ndim != 2:
            raise ValueError(
                f"basis must be (d, k), got shape {arr.shape}"
            )
        if num_shards is not None and shard_sizes is None:
            if not (1 <= int(num_shards) <= arr.shape[0]):
                raise ValueError(
                    f"num_shards must be in [1, d={arr.shape[0]}], "
                    f"got {num_shards}"
                )
            base, rem = divmod(arr.shape[0], int(num_shards))
            shard_sizes = tuple(base + (1 if i < rem else 0)
                                for i in range(int(num_shards)))
        if spec is not None:
            spec = tuple(spec)
            if shard_sizes is None:
                # a spec with one payload is still a sharded version, with
                # a single shard, so the marker stays honest
                shard_sizes = (int(arr.shape[0]),)
        elif shard_sizes is not None:
            # rows over the features axis: the sharded layout the serving
            # tier produces
            spec = ("features", None)
        if not np.isfinite(arr).all():
            raise ValueError(
                "refusing to publish a non-finite basis (serving it "
                "would poison every query batch that grabs it)"
            )
        st = None
        ev = dict(explained_variance or {})
        if sigma_tilde is not None:
            st = _frozen_array(sigma_tilde)
            if st.shape != (arr.shape[0], arr.shape[0]):
                raise ValueError(
                    f"sigma_tilde shape {st.shape} != "
                    f"({arr.shape[0]}, {arr.shape[0]})"
                )
            if "top_k_energy" not in ev:
                # fraction of the state's variance the published basis
                # captures — the number drift is measured against
                trace = float(np.trace(st))
                if trace > 0:
                    ev["top_k_energy"] = round(
                        float(np.trace(arr.T @ st @ arr)) / trace, 6
                    )
        bv_partial = dict(
            v=arr,
            sigma_tilde=st,
            signature=(int(arr.shape[0]), int(arr.shape[1])),
            step=int(step),
            explained_variance=ev,
            lineage=dict(lineage or {}),
            spec=spec,
            shard_sizes=shard_sizes,
        )
        with self._lock:
            bv = BasisVersion(version=self._next_id, **bv_partial)
            self._next_id += 1
        if self.registry_dir is not None:
            # durable FIRST: commit to disk before the in-memory swap,
            # so a version readers can observe is always a version a
            # restart recovers (an IO failure raises here and the
            # registry is untouched — the id gap is harmless)
            self._persist(bv)
        gc_ids: list[int] = []
        with self._lock:
            self._versions[bv.version] = bv
            # single reference assignment = the atomic hot-swap point
            # (guarded so racing publishers can't move latest backwards)
            if self._latest is None or bv.version > self._latest.version:
                self._latest = bv
            while len(self._versions) > self.keep:
                oldest = min(self._versions)
                del self._versions[oldest]
                gc_ids.append(oldest)
        if self.registry_dir is not None:
            # disk GC mirrors memory GC (best effort); with a grace
            # window the payloads linger so replicas mid-read survive
            self._retire_disk(gc_ids)
        return bv

    def publish_fit(self, estimator, *, lineage: Mapping[str, Any] | None = None,
                    include_state: bool = True) -> BasisVersion:
        """Publish an ``OnlineDistributedPCA`` fit's result.

        Lineage records the trainer the fit actually ran
        (``trainer_used_``) and its checkpoint dir when the estimator has
        one; the dense state snapshot rides along (``include_state=True``)
        so drift monitoring can diff explained variance later. The basis
        and the snapshot are copied to the host first (the port's
        estimator keeps them on its device).
        """
        w = _host(estimator.components_)  # raises before fit — the right error
        lin = {
            "producer": "OnlineDistributedPCA",
            "trainer": estimator.trainer_used_,
        }
        checkpoint_dir = getattr(estimator, "checkpoint_dir", None)
        if checkpoint_dir is not None:
            lin["checkpoint_dir"] = checkpoint_dir
        lin.update(lineage or {})
        state = estimator.state
        step = int(state.step) if state is not None else 0
        sigma = (
            _host(state.sigma_tilde)
            if include_state and hasattr(state, "sigma_tilde")
            else None
        )
        return self.publish(w, sigma_tilde=sigma, step=step, lineage=lin)

    def publish_fleet(self, result, tenant: int, *,
                      lineage: Mapping[str, Any] | None = None,
                      include_state: bool = True) -> BasisVersion:
        """Publish one tenant's basis from a ``parallel.fleet.FleetResult``:
        the fleet -> registry edge of the serving loop. Lineage records the
        tenant index and the fleet batch's shape signature, so a served
        projection is attributable to the multi-tenant dispatch that made
        its basis; the tenant's ``sigma_tilde`` (copied to the host) and
        step ride along."""
        if not (0 <= tenant < len(result.components)):
            raise ValueError(
                f"tenant {tenant} out of range for a "
                f"{len(result.components)}-tenant fleet result"
            )
        lin = {
            "producer": "fit_fleet",
            "tenant": int(tenant),
            "fleet_signature": tuple(result.batch.signature),
        }
        lin.update(lineage or {})
        return self.publish(
            result.components[tenant],
            sigma_tilde=(
                _host(result.states.sigma_tilde[tenant])
                if include_state else None
            ),
            step=int(result.states.step[tenant]),
            lineage=lin,
        )

    def publish_grown(
        self,
        parent: "BasisVersion | int",
        v_grown,
        *,
        sigma_tilde=None,
        step: int | None = None,
        explained_variance: Mapping[str, float] | None = None,
        lineage: Mapping[str, Any] | None = None,
        spec=None,
        num_shards: int | None = None,
        prefix_atol: float = 1e-5,
    ) -> BasisVersion:
        """Publish an elastic-k widening of a retained version: ``v_grown
        (d, k')`` with ``k' > parent k``, from ``solvers.grow_basis``
        against the parent. Its first k columns must match the parent
        within ``prefix_atol`` (the grow fit freezes the parent lane; a
        drifted prefix means it was grown against another basis, and
        serving it under this lineage would mislead every replica that
        trusts ``grew_from``).

        Lineage: ``{"producer": "grow_basis", "grew_from": <parent
        version>, "k_from": k, "k_to": k'}``, under any caller entries.
        Otherwise an ordinary publish: durable first, lease-fenced, GC'd by
        the same retention window (``grew_from`` keeps naming the parent
        after the parent is GC'd)."""
        if not hasattr(parent, "v"):
            parent = self.get(int(parent))
        parr = np.asarray(parent.v)
        if isinstance(v_grown, (list, tuple)):
            garr = np.concatenate([_host(p) for p in v_grown], axis=0)
        else:
            garr = _host(v_grown)
        if garr.ndim != 2 or garr.shape[0] != parr.shape[0]:
            raise ValueError(
                f"grown basis must be (d={parr.shape[0]}, k'), got "
                f"shape {garr.shape}"
            )
        k0, k1 = parr.shape[1], garr.shape[1]
        if not k1 > k0:
            raise ValueError(
                f"publish_grown needs k' > parent k, got k'={k1} vs "
                f"parent k={k0} (version {parent.version}; shrinking "
                "is a slice of the parent, not a new version)"
            )
        if not np.allclose(garr[:, :k0], parr, atol=prefix_atol):
            drift = float(np.abs(garr[:, :k0] - parr).max())
            raise ValueError(
                f"grown basis prefix drifts from parent version "
                f"{parent.version} (max abs diff {drift:.3e} > "
                f"prefix_atol {prefix_atol:g}): grow_basis freezes the "
                "parent lane, so a drifted prefix means this was grown "
                "against a different basis — refusing the lineage link"
            )
        lin = {
            "producer": "grow_basis",
            "grew_from": int(parent.version),
            "k_from": int(k0),
            "k_to": int(k1),
        }
        lin.update(lineage or {})
        return self.publish(
            garr if not isinstance(v_grown, (list, tuple)) else v_grown,
            sigma_tilde=None if sigma_tilde is None else _host(sigma_tilde),
            step=int(parent.step if step is None else step),
            explained_variance=explained_variance,
            lineage=lin,
            spec=spec,
            num_shards=num_shards,
        )

    # -- read side -----------------------------------------------------------

    def latest(self) -> BasisVersion | None:
        """The newest complete version — lock-free (one attribute read;
        publishers swap it with one assignment)."""
        return self._latest

    def get(self, version: int) -> BasisVersion:
        """A retained version by id. A GC'd (or never-published) id
        raises :class:`VersionRetired` — a KeyError that NAMES the
        retention window and the knob that widens it, instead of a bare
        integer a 3am page can't act on."""
        with self._lock:
            try:
                return self._versions[version]
            except KeyError:
                retained = sorted(self._versions)
                raise VersionRetired(
                    f"version {version} is not retained: the registry "
                    f"keeps the newest {self.keep} versions "
                    f"(cfg.serve_keep_versions={self.keep}; currently "
                    f"retained: {retained}) — raise serve_keep_versions "
                    "to widen the retention window"
                ) from None

    def load_payload(self, version: int) -> np.ndarray:
        """Re-read a version's committed basis from the disk tier (the path
        a replica takes between commit-marker read and install). A version
        GC'd out from under the read, even one whose dir vanished between
        ``latest()`` and the load, raises :class:`VersionRetired`, never a
        dangling-path ``FileNotFoundError``."""
        if self.registry_dir is None:
            raise ValueError(
                "load_payload needs a durable registry "
                "(cfg.registry_dir is not set)"
            )
        vdir = self._version_dir(version)
        try:
            with open(os.path.join(vdir, "meta.json")) as f:
                meta = json.load(f)
            if meta.get("shards"):
                return _load_committed_payload(vdir, meta)[0]
            with np.load(os.path.join(vdir, "basis.npz")) as z:
                return _frozen_array(z["v"])
        except FileNotFoundError:
            with self._lock:
                retained = sorted(self._versions)
            raise VersionRetired(
                f"version {version} is not on disk: retired past its "
                f"grace window (retire_grace_s={self.retire_grace_s}; "
                f"currently retained: {retained}) — raise "
                "serve_keep_versions or replica_staleness_ms to widen "
                "the window"
            ) from None

    def versions(self) -> list[int]:
        """Retained version ids, oldest first."""
        with self._lock:
            return sorted(self._versions)

    def __len__(self) -> int:
        with self._lock:
            return len(self._versions)
