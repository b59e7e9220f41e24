"""QueryServer: deadline micro-batched projection against the registry.

The port's copy of ``distributed_eigenspaces_tpu/serving/server.py``. Query
admission batches independent transform requests into one padded
projection dispatch: a micro-batch dispatches when FULL
(``cfg.serve_bucket_size`` queries) or when its OLDEST query has waited
``cfg.serve_flush_s``, through ``runtime/scheduler.ShapeBucketQueue``
(lease/retry, idempotent completion).

Correctness properties, as in the reference:

- **One basis per batch, no torn reads.** A dispatch lane reads
  ``registry.latest()`` exactly ONCE and projects every query in the batch
  against that immutable version; a publish mid-batch affects only later
  batches.
- **Double-buffered swap, zero stall.** The device-resident basis is a
  ``(version_id, tensor)`` pair swapped by reference; in-flight batches
  keep the old tensor alive, and the engine takes the basis as an operand,
  so a swap is one host-to-device copy: no new bucket acquisition, no
  drained queue.
- **Per-request error isolation.** A query with non-finite rows fails ITS
  ticket (naming the rows) and leaves the batch; its neighbours are served.
- **Supervised serve lane.** The dispatch loop runs under a
  ``runtime/supervisor.LaneWatchdog`` (restart with capped backoff; a
  leased bucket re-leases by lease timeout), with bounded admission
  (``cfg.serve_queue_depth``, :class:`ServerOverloaded`), deadline shedding
  against ``cfg.serve_slo_p99_ms`` (:class:`DeadlineExceeded`) and a
  per-signature circuit breaker (``cfg.serve_breaker_threshold``).

Each micro-batch moves its concatenated rows to the engine's device once,
projects them (on the card at ``serve_dtype`` bfloat16/int8 this launches
the serve kernels of ``csrc/serve_project.cu``), computes the residual
energies, and copies ``z`` back to the host. Request spans go to the
engine's ``tracer`` when one is attached.

``drift`` (a :class:`~.drift.DriftMonitor`) receives every good batch's
residual and input energy sums and its rows: the serve -> drift -> refit
loop.

``mesh=`` (a ``parallel.mesh.Mesh``) builds the engine on the mesh: each
rank runs its own server over the traffic it is given. With an engine whose
basis is row-sharded over a ``features`` axis of more than one rank
(``TransformEngine(mesh=, basis_spec=("features", None))``), every rank of
the group must be given the same requests in the same order, and each
dispatch runs in rounds agreed with the other ranks. A round opens with
one small all-gather of each rank's first sequence number, remaining
count, live version and deadline-shed mask:

- the round serves the next run of requests, as many as the shortest
  count (the rest go in the next round), so the ranks' micro-batches may
  be cut differently and still meet in the same collectives;
- it serves them at ONE version, the oldest any rank reads as live, so no
  reduction adds the shards of two versions during a hot swap or while a
  rank's replica lags (a rank that has moved on reads that version back
  from its registry; if one no longer holds it, every rank fails the
  round's requests alike);
- a request that any rank sheds for its deadline is shed on every rank.

Each round is then one ``(rows, k + 1)`` psum carrying the projection and
the input energy; a rejected request's rows go in as zeros so the ranks'
shapes agree. A version is placed shard by shard: each rank moves its rows
only.

A ``MetricsLogger`` (``metrics=``) receives every batch (queries, padded
rows, queue waits, compute, version, swap), shed, breaker and lane event,
and its ``summary()["serving"]["health"]`` reads :meth:`QueryServer.health`;
its tracer, when one is attached, records each request's span chain. Not
ported yet: prewarming and the compile cache (ROADMAP.md Queue 1 item 16).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.config import _not_ported
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.runtime.scheduler import (
    QueueClosed,
    QueueFull,
    ShapeBucketQueue,
)
from distributed_eigenspaces_tpu_torch.runtime.supervisor import (
    BreakerOpen,
    FaultLedger,
    LaneWatchdog,
)
from distributed_eigenspaces_tpu_torch.serving.registry import EigenbasisRegistry
from distributed_eigenspaces_tpu_torch.serving.transform import (
    TransformEngine,
    bucket_rows,
)
from distributed_eigenspaces_tpu_torch.utils.metrics import log_line
from distributed_eigenspaces_tpu_torch.utils.telemetry import NULL_TRACER, tracer_of

__all__ = [
    "BreakerOpen",
    "DeadlineExceeded",
    "QueryServer",
    "ServedProjection",
    "ServerClosed",
    "ServerOverloaded",
]


class ServerClosed(RuntimeError):
    """submit() after close(): the documented server-boundary error. The
    request was never admitted; construct a new server to keep serving."""


class ServerOverloaded(RuntimeError):
    """Load shed: bounded admission (``cfg.serve_queue_depth``) refused the
    NEWEST request so already-admitted requests keep their latency budget.
    The client should back off and retry."""


class DeadlineExceeded(ServerOverloaded):
    """Deadline-aware shed: the request waited past the declared SLO
    (``cfg.serve_slo_p99_ms``) before its bucket dispatched, so it is
    dropped before compute and counted as a shed."""


#: requests a lockstep round agrees on at most: each takes one bit of the
#: round's int64 shed mask
_ROUND_MAX = 62


@dataclasses.dataclass(frozen=True)
class ServedProjection:
    """One resolved query: the projection, the per-row residual and input
    energies, and the basis version that served it."""

    z: np.ndarray  # (rows, k)
    residual_sq: np.ndarray  # (rows,) per-row residual energy
    input_sq: np.ndarray  # (rows,) per-row input energy
    version: int


@dataclasses.dataclass
class _QueryRequest:
    x: np.ndarray  # (rows, d) host rows, width-validated at submit
    t_submit: float
    #: correlation id of this request's span chain (admit -> queue_wait ->
    #: dispatch -> compute -> reply): born on the submitting thread, it
    #: rides the ticket payload to the dispatch lane
    trace_id: str | None = None
    #: admission order on this server (the ranks of a sharded engine agree
    #: on runs of requests by it)
    seq: int = 0


class QueryServer:
    """Micro-batched transform serving against an
    :class:`~..serving.registry.EigenbasisRegistry`, on one device
    (``"cuda"`` unless the caller asks for another) or, with ``mesh=``, on
    each rank of a mesh (the module docstring).

    ``submit(x)`` admits one ``(rows, d)`` query (a ``(d,)`` vector is one
    row) and returns a ticket whose ``.result(timeout)`` blocks for a
    :class:`ServedProjection`. Use it as a context manager, or call
    :meth:`close`.
    """

    def __init__(
        self,
        registry: EigenbasisRegistry,
        cfg=None,
        *,
        d: int | None = None,
        k: int | None = None,
        bucket_size: int | None = None,
        flush_s: float | None = None,
        mesh=None,
        metrics=None,
        drift=None,
        num_lanes: int = 1,
        max_retries: int = 3,
        lease_timeout: float | None = None,
        engine: TransformEngine | None = None,
        compile_cache=None,
        prewarm=False,
        prewarmer=None,
        queue_depth: int | None = None,
        breaker_threshold: int | None = None,
        breaker_cooldown_s: float = 1.0,
        supervise: bool = True,
        max_lane_restarts: int = 3,
        fault_hook=None,
        continuous: bool | None = None,
        serve_dtype: str | None = None,
        device="cuda",
    ):
        if prewarm or prewarmer is not None:
            raise _not_ported("QueryServer(prewarm=)", "Queue 1 item 16 (runtime/prewarm.py)")
        if compile_cache is not None:
            raise _not_ported(
                "QueryServer(compile_cache=)", "Queue 1 item 16 (utils/compile_cache.py)"
            )
        live = registry.latest()
        if d is None:
            d = cfg.dim if cfg is not None else (live.d if live else None)
        if k is None:
            k = cfg.k if cfg is not None else (live.k if live else None)
        if d is None or k is None:
            raise ValueError(
                "QueryServer needs a (d, k) signature: pass cfg / d+k, "
                "or publish a version before constructing"
            )
        if bucket_size is None:
            bucket_size = cfg.serve_bucket_size if cfg is not None else 8
        if flush_s is None:
            flush_s = cfg.serve_flush_s if cfg is not None else 0.02
        self.registry = registry
        self.drift = drift
        self.metrics = metrics
        if (
            metrics is not None
            and cfg is not None
            and cfg.serve_slo_p99_ms is not None
            and metrics.slo_p99_ms is None
        ):
            # the declared SLO rides the config; the logger owns the
            # attainment math (summary()["slo"]["serve"])
            metrics.slo_p99_ms = cfg.serve_slo_p99_ms
        self.d, self.k = int(d), int(k)
        self.bucket_size = bucket_size
        if serve_dtype is None:
            serve_dtype = cfg.serve_dtype if cfg is not None else "float32"
        self.serve_dtype = serve_dtype
        self.engine = engine or TransformEngine(
            self.d, self.k, mesh=mesh, serve_dtype=serve_dtype, device=device,
        )
        eng_mesh = self.engine.mesh
        #: whether dispatch meets the other ranks of a sharded engine's
        #: features group in its collectives (module docstring)
        self.lockstep = self.engine.sharded and (
            eng_mesh.axis_size(pmesh.FEATURE_AXIS) > 1)
        if self.lockstep:
            num_lanes = 1  # one lane: the collectives run in request order
        self._seq = 0
        self._seq_lock = threading.Lock()
        #: rounds of agreed requests a lockstep server has dispatched (one
        #: reduction of the engine each)
        self.lockstep_rounds = 0
        if self.engine.serve_dtype != "float32":
            # quantized serve kernels are angle-gated at the door: a basis
            # family whose quantization error blows the 0.2 degree budget
            # fails construction instead of serving drifted projections
            self.engine.self_check()
        #: served-version bookkeeping: the last version a batch used and how
        #: many hot swaps dispatch has observed
        self.swap_count = 0
        self._served_version: int | None = None
        self._dev_basis: tuple[int, torch.Tensor] | None = None
        if queue_depth is None and cfg is not None:
            queue_depth = cfg.serve_queue_depth
        if breaker_threshold is None and cfg is not None:
            breaker_threshold = cfg.serve_breaker_threshold
        self.queue_depth = queue_depth
        self._slo_ms = (
            metrics.slo_p99_ms if metrics is not None
            else (cfg.serve_slo_p99_ms if cfg is not None else None)
        )
        #: chaos-injection point: called with the bucket at the top of every
        #: dispatch; a KillSwitch here is a lane death, anything else a
        #: dispatch failure (breaker food). None in production.
        self.fault_hook = fault_hook
        #: fault ledger: lane restarts/deaths and sheds
        self.ledger = FaultLedger()
        self._sheds = {"overload": 0, "deadline": 0, "breaker": 0}
        self._last_lane_death: float | None = None
        self.last_recovery_ms: float | None = None
        self._closed = False
        if supervise and lease_timeout is None:
            # liveness default: a bucket leased to a killed lane must
            # re-lease for the restarted lane; an infinite lease would
            # hang its waiters forever
            lease_timeout = 60.0
        if continuous is None:
            continuous = cfg.serve_continuous if cfg is not None else False
        self.continuous = bool(continuous)
        self.queue = ShapeBucketQueue(
            bucket_size=bucket_size,
            flush_deadline=flush_s,
            max_retries=max_retries,
            lease_timeout=lease_timeout,
            max_depth=queue_depth,
            isolate_failures=supervise,
            breaker_threshold=breaker_threshold,
            breaker_cooldown_s=breaker_cooldown_s,
            on_event=self._queue_event,
            continuous=self.continuous,
        )
        self._num_lanes = max(num_lanes, 1)
        self._watchdog: LaneWatchdog | None = None
        if supervise:
            self._watchdog = LaneWatchdog(
                "query-serve",
                self._serve_loop,
                max_restarts=max_lane_restarts,
                ledger=self.ledger,
                on_restart=self._lane_restarted,
                on_dead=self._lane_dead,
            ).start()
            self._thread = self._watchdog._thread
        else:
            self._thread = threading.Thread(
                target=self._serve_loop_logged, daemon=True
            )
            self._thread.start()
        if metrics is not None:
            # summary()["serving"]["health"] reads the live state
            metrics.attach_serve_health(self.health)

    def _serve_loop(self) -> None:
        """One supervised serve-lane entry: exceptions propagate to the
        watchdog (lane death -> restart), a clean return is the closed
        queue draining."""
        self.queue.serve(self._run_batch, num_lanes=self._num_lanes)

    def _serve_loop_logged(self) -> None:
        try:
            self._serve_loop()
        except Exception as e:
            # unsupervised mode: log instead of dying through the
            # unhandled-thread hook; tickets were failed by the queue
            log_line("query server dispatch aborted", error=repr(e))

    # -- resilience event plumbing -------------------------------------------

    def _tracer(self):
        """The logger's tracer when one is attached (handed to the engine
        too, so its acquisitions land on the same timeline), else the
        engine's."""
        tr = tracer_of(self.metrics)
        if tr is not NULL_TRACER:
            if self.engine.tracer is None:
                self.engine.tracer = tr
            return tr
        tr = self.engine.tracer
        return tr if tr is not None else NULL_TRACER

    def _serve_event(self, event: dict) -> None:
        if self.metrics is not None:
            self.metrics.serve(event)

    def _queue_event(self, kind: str, detail: dict) -> None:
        """Shed / breaker transitions from the admission queue -> ledger +
        tracer (one merged timeline)."""
        if kind == "shed":
            reason = detail.get("reason", "overload")
            self._sheds[reason] = self._sheds.get(reason, 0) + 1
        flat = {
            k: v for k, v in detail.items()
            if isinstance(v, (int, float, str, bool))
        }
        self.ledger.record(kind, None, **flat)
        self._tracer().event(f"serve_{kind}", category="serve", attrs=flat)
        self._serve_event({
            "kind": kind, "signature": [self.d, self.k],
            **{k: v for k, v in detail.items() if k != "signature"},
        })

    def _lane_restarted(self, event: dict) -> None:
        self._last_lane_death = time.perf_counter()
        self._tracer().event(
            "serve_lane_restart", category="fault",
            attrs={"attempt": event.get("attempt"),
                   "error": event.get("error")},
        )
        self._serve_event({
            "kind": "lane", "event": "restart",
            "attempt": event.get("attempt"), "error": event.get("error"),
            "backoff_s": event.get("backoff_s"),
        })

    def _lane_dead(self, exc: Exception) -> None:
        """Restart budget exhausted: close admission and fail pending
        waiters loudly — a dead server that still accepts submissions
        would hang every new caller."""
        err = ServerClosed(
            f"query server serve lane is dead after "
            f"{self._watchdog.restarts} restarts (last error: "
            f"{exc!r}); pending requests failed, admission closed"
        )
        err.__cause__ = exc
        self._serve_event({
            "kind": "lane", "event": "dead", "error": repr(exc),
            "restarts": self._watchdog.restarts,
        })
        self._closed = True
        try:
            self.queue.close()
        finally:
            for rec in self.queue.wq.records:
                payload = rec.payload
                if hasattr(payload, "tickets"):
                    for t in payload.tickets:
                        if not t.done():
                            t.fail(err)

    def health(self) -> dict:
        """Live resilience state: sheds by reason, per-signature breaker
        snapshots, lane restarts, last recovery time."""
        out: dict = {
            "sheds": dict(self._sheds),
            "shed_count": sum(self._sheds.values()),
            "inflight": self.queue.inflight,
            "lane_alive": self._thread.is_alive(),
        }
        if self.queue_depth is not None:
            out["queue_depth"] = self.queue_depth
        if self.queue.breakers:
            out["breakers"] = {
                str(sig): br.snapshot()
                for sig, br in self.queue.breakers.items()
            }
        if self._watchdog is not None:
            out["lane_restarts"] = self._watchdog.restarts
            out["lane_dead"] = self._watchdog.dead
        if self.last_recovery_ms is not None:
            out["last_recovery_ms"] = round(self.last_recovery_ms, 3)
        return out

    # -- client API ----------------------------------------------------------

    def submit(self, x, *, tenant=None):
        """Admit one query; returns its ticket. Width is validated HERE (a
        malformed request fails its caller at the door). Admission
        failures are the documented server-boundary errors:
        :class:`ServerClosed` after ``close()``, :class:`ServerOverloaded`
        when bounded admission sheds, ``BreakerOpen`` when this signature
        is fast-failing. ``tenant`` is the continuous-batching fairness
        key (ignored in deadline mode)."""
        arr = np.asarray(x, np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2 or arr.shape[1] != self.d:
            raise ValueError(
                f"query shape {np.shape(x)} does not match the served "
                f"signature: want (rows, {self.d})"
            )
        if arr.shape[0] < 1:
            raise ValueError("empty query (zero rows)")
        tr = self._tracer()
        tid = tr.new_trace("query")
        t0 = time.perf_counter()
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
        try:
            ticket = self.queue.submit(
                (self.d, self.k),
                _QueryRequest(x=arr, t_submit=t0, trace_id=tid, seq=seq),
                tenant=tenant,
            )
        except QueueClosed as e:
            raise ServerClosed(
                "submit on a closed QueryServer (close() already ran; "
                "in-flight requests drained first) — construct a new "
                "server"
            ) from e
        except QueueFull as e:
            raise ServerOverloaded(
                f"query shed: {self.queue.inflight} requests already "
                f"in flight >= serve_queue_depth {self.queue_depth} "
                "(reject-newest load shedding; back off and retry)"
            ) from e
        tr.record_span(
            "admit", t0, time.perf_counter(), trace_id=tid,
            category="serve", attrs={"rows": int(arr.shape[0])},
        )
        return ticket

    def close(self) -> None:
        """Flush partial micro-batches, drain, join dispatch lanes. Marks
        the shutdown intentional FIRST, so a lane exiting during close is a
        clean drain, never a restartable death."""
        self._closed = True
        if self._watchdog is not None:
            self._watchdog.close()
        self.queue.close()
        self._thread.join()

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatch ------------------------------------------------------------

    def _basis_device(self, ver) -> torch.Tensor:
        """Device-resident basis for ``ver``, the double buffer: a
        ``(version_id, tensor)`` pair swapped by reference, so in-flight
        batches holding the previous tensor are untouched."""
        pair = self._dev_basis
        if pair is not None and pair[0] == ver.version:
            return pair[1]
        # a copy (ver.v is a read-only host array); a sharded engine moves
        # this rank's rows only
        arr = self.engine.place_basis(ver)
        self._dev_basis = (ver.version, arr)
        return arr

    def _version_fault(self, ver) -> str | None:
        """Why ``ver`` (a ``registry.latest()``) cannot be served here, or
        None."""
        if ver is None:
            return ("no published basis: publish to the registry before "
                    "serving queries")
        if ver.signature != (self.d, self.k):
            return (f"live version {ver.version} has signature "
                    f"{ver.signature}; this server serves ({self.d}, {self.k})")
        return None

    def _note_version(self, version: int) -> None:
        """Served-version bookkeeping: a change is one observed hot swap."""
        if self._served_version is not None and self._served_version != version:
            self.swap_count += 1
        self._served_version = version

    def _deadline_missed(self, req, t0: float) -> DeadlineExceeded | None:
        """Deadline-aware load shedding (active when bounded admission AND
        an SLO are declared): a request that already waited past the
        declared p99 target is dropped BEFORE compute."""
        if self.queue_depth is None or self._slo_ms is None:
            return None
        waited_ms = (t0 - req.t_submit) * 1e3
        if waited_ms <= self._slo_ms:
            return None
        return DeadlineExceeded(
            f"request shed before compute: queued {waited_ms:.1f} ms > "
            f"declared SLO {self._slo_ms} ms (cfg.serve_slo_p99_ms)"
        )

    def _shed(self, ticket, req, exc: Exception, tr) -> Exception:
        self._sheds["deadline"] += 1
        ticket.fail(exc)
        tr.event("serve_shed", trace_id=req.trace_id, category="serve",
                 attrs={"reason": "deadline"})
        self._serve_event({"kind": "shed", "reason": "deadline", "dropped": 1,
                           "signature": [self.d, self.k]})
        return exc

    @staticmethod
    def _non_finite(req) -> ValueError | None:
        """Per-request quarantine: a non-finite query fails ITS ticket and
        leaves the batch; everyone else is served normally."""
        finite = np.isfinite(req.x).all(axis=1)
        if finite.all():
            return None
        bad_rows = [int(r) for r in np.nonzero(~finite)[0]]
        return ValueError(
            f"query contains non-finite rows {bad_rows} — rejected (its "
            "batch neighbors were served)"
        )

    def _local_batch(self, bucket, reqs, t0, tr):
        """A bucket on this rank alone, at the one version read for it.
        Returns ``(results, fails, served, (t_c0, t_c1) or None)``,
        ``served`` the ``(x, residual_sq, input_sq)`` of the answered rows."""
        ver = self.registry.latest()
        fault = self._version_fault(ver)
        if fault is not None:
            raise RuntimeError(fault)
        self._note_version(ver.version)
        fails: dict[int, Exception] = {}
        good: list[int] = []
        for i, req in enumerate(reqs):
            exc = self._deadline_missed(req, t0)
            if exc is not None:
                fails[i] = self._shed(bucket.tickets[i], req, exc, tr)
                continue
            exc = self._non_finite(req)
            if exc is not None:
                fails[i] = exc
            else:
                good.append(i)
        results: list[Any] = [None] * len(reqs)
        if not good:
            return results, fails, [], None
        v_dev = self._basis_device(ver)
        x = np.concatenate([reqs[i].x for i in good], axis=0)
        t_c0 = time.perf_counter()
        # device=True opens a torch.profiler.record_function region, so a
        # profiler capture shows this region beside its kernels
        with tr.span(
            "batch_compute", category="serve", device=True,
            attrs={"rows": int(x.shape[0]), "queries": len(good),
                   "version": ver.version},
        ):
            # one host-to-device copy, shared by both operations
            x_dev = torch.from_numpy(x).to(self.engine.device)
            z = self.engine.project(x_dev, v_dev)
            r_sq, e_sq = self.engine.residual_energy(x_dev, z)
            z = z.cpu().numpy()
            r_sq = r_sq.cpu().numpy()
            e_sq = e_sq.cpu().numpy()
        t_c1 = time.perf_counter()
        off = 0
        for i in good:
            rows = reqs[i].x.shape[0]
            results[i] = ServedProjection(
                z=z[off : off + rows],
                residual_sq=r_sq[off : off + rows],
                input_sq=e_sq[off : off + rows],
                version=ver.version,
            )
            off += rows
        return results, fails, [(x, r_sq, e_sq)], (t_c0, t_c1)

    def _agree(self, row: list[int]) -> list[list[int]]:
        """Every rank's ``row`` of small ints, in rank order: one
        all-gather over ``features``."""
        mine = torch.tensor([row], dtype=torch.int64, device=self.engine.device)
        with pmesh.mesh_scope(self.engine.mesh):
            return pmesh.all_gather(mine, pmesh.FEATURE_AXIS).cpu().tolist()

    def _held(self, version: int):
        try:
            return self.registry.get(version)
        except KeyError:  # VersionRetired
            return None

    def _lockstep_batch(self, bucket, reqs, t0, tr):
        """A bucket through a sharded engine, in rounds agreed with the
        other ranks of the features group (the module docstring): one
        version and one shed decision a round, the same on every rank.
        Returns what :meth:`_local_batch` returns."""
        n = len(reqs)
        results: list[Any] = [None] * n
        fails: dict[int, Exception] = {}
        served = []
        t_c0 = time.perf_counter()
        i = 0
        with tr.span("batch_compute", category="serve", device=True,
                     attrs={"rows": sum(r.x.shape[0] for r in reqs),
                            "queries": n}):
            while i < n:
                ver = self.registry.latest()
                fault = self._version_fault(ver)
                mask = 0
                for j in range(min(n - i, _ROUND_MAX)):
                    if self._deadline_missed(reqs[i + j], t0) is not None:
                        mask |= 1 << j
                rows = self._agree([reqs[i].seq, n - i,
                                    -1 if fault else ver.version, mask])
                seqs, counts, vers, masks = (list(col) for col in zip(*rows))
                if len(set(seqs)) > 1:
                    raise RuntimeError(
                        f"sharded serving out of step: the ranks of the "
                        f"features group start their next batch at requests "
                        f"{seqs} — every rank must be given the same "
                        "requests in the same order"
                    )
                if min(vers) < 0:
                    raise RuntimeError(
                        fault or f"sharded serving: a rank of the features "
                        f"group has no servable version (live versions {vers})"
                    )
                c = min(min(counts), _ROUND_MAX)
                vid = min(vers)
                if max(vers) != vid:
                    # a hot swap under way, or a lagging replica: the round
                    # is served at the oldest live version, if every rank
                    # still holds it
                    held = ver if ver.version == vid else self._held(vid)
                    if not all(h for (h,) in self._agree([held is not None])):
                        err = RuntimeError(
                            f"sharded serving: the ranks of the features "
                            f"group read versions {vers} as live and version "
                            f"{vid} is no longer held on every rank; the "
                            "requests fail rather than mix the shards of two "
                            "versions"
                        )
                        fails.update((i + j, err) for j in range(c))
                        i += c
                        continue
                    ver = held
                shed = 0
                for m_ in masks:
                    shed |= m_
                live = []
                for j in range(i, i + c):
                    if shed >> (j - i) & 1:
                        exc = self._deadline_missed(reqs[j], t0) or DeadlineExceeded(
                            "request shed before compute: another rank of the "
                            "features group queued it past the declared SLO "
                            f"{self._slo_ms} ms (cfg.serve_slo_p99_ms)"
                        )
                        fails[j] = self._shed(bucket.tickets[j], reqs[j], exc, tr)
                    else:
                        live.append(j)
                i += c
                if not live:
                    continue
                self._note_version(ver.version)
                x = np.concatenate([np.where(np.isfinite(reqs[j].x), reqs[j].x, 0.0)
                                    for j in live], axis=0).astype(np.float32)
                z, r_sq, e_sq = (t.cpu().numpy() for t in self.engine.project_energy(
                    torch.from_numpy(x).to(self.engine.device),
                    self._basis_device(ver)))
                self.lockstep_rounds += 1
                off = 0
                for j in live:
                    rows_j = reqs[j].x.shape[0]
                    sl = slice(off, off + rows_j)
                    off += rows_j
                    exc = self._non_finite(reqs[j])
                    if exc is not None:
                        fails[j] = exc
                        continue
                    results[j] = ServedProjection(
                        z=z[sl], residual_sq=r_sq[sl], input_sq=e_sq[sl],
                        version=ver.version)
                    served.append((reqs[j].x, r_sq[sl], e_sq[sl]))
        return results, fails, served, (t_c0, time.perf_counter())

    def _run_batch(self, bucket) -> list:
        tr = self._tracer()
        if self.fault_hook is not None:
            # chaos-injection point: KillSwitch = lane death (watchdog
            # restarts, lease re-queues the bucket), anything else = a
            # dispatch failure (retry ladder + breaker food)
            self.fault_hook(bucket)
        t0 = time.perf_counter()
        if self._last_lane_death is not None:
            # first dispatch after a lane restart: the measured recovery
            # time (death -> served again), health-reported
            self.last_recovery_ms = (t0 - self._last_lane_death) * 1e3
            self._last_lane_death = None
            self.ledger.record(
                "lane_recovered", None,
                recovery_ms=round(self.last_recovery_ms, 3),
            )
            self._serve_event({
                "kind": "lane", "event": "recovered",
                "recovery_ms": round(self.last_recovery_ms, 3),
            })
        # any bucket this batch acquires for the first time shows up as
        # the delta below: a compile_stall span and the event's stall
        stall_miss0 = self.engine.compile_misses
        stall_ms0 = self.engine.compile_ms_total
        swaps0 = self.swap_count
        reqs = [t.payload for t in bucket.tickets]
        batch = self._lockstep_batch if self.lockstep else self._local_batch
        results, fails, served, t_c = batch(bucket, reqs, t0, tr)
        for i, exc in fails.items():
            bucket.tickets[i].fail(exc)
            # the scheduler's fold skips already-resolved tickets; mark the
            # slot served anyway
            results[i] = ServedProjection(
                z=np.zeros((0, self.k), np.float32),
                residual_sq=np.zeros(0, np.float32),
                input_sq=np.zeros(0, np.float32),
                version=-1 if self._served_version is None else self._served_version,
            )

        now = time.perf_counter()
        stall_ms = self.engine.compile_ms_total - stall_ms0
        if tr is not NULL_TRACER:
            # per-request span chain under the request's trace_id:
            # admit (recorded at submit) -> queue_wait -> dispatch
            # (compile_stall -> compute -> reply)
            for i, req in enumerate(reqs):
                tid = req.trace_id
                qw_attrs = {}
                if bucket.t_dispatch is not None:
                    qw_attrs = {
                        "bucket_wait_s": round(
                            max(0.0, bucket.t_dispatch - req.t_submit), 6
                        ),
                        "lane_wait_s": round(
                            max(0.0, t0 - bucket.t_dispatch), 6
                        ),
                    }
                tr.record_span(
                    "queue_wait", req.t_submit, t0, trace_id=tid,
                    category="serve", attrs=qw_attrs,
                )
                dspan = tr.record_span(
                    "dispatch", t0, now, trace_id=tid, category="serve",
                    attrs={"version": results[i].version,
                           "queries": len(reqs),
                           "rejected": i in fails},
                )
                if t_c is not None:
                    t_c0, t_c1 = t_c
                    if stall_ms > 0:
                        tr.record_span(
                            "compile_stall", t_c0, t_c0 + stall_ms / 1e3,
                            trace_id=tid, parent=dspan,
                            category="compile",
                            attrs={"compile_stall_ms": round(stall_ms, 3)},
                        )
                    tr.record_span(
                        "compute", t_c0, t_c1, trace_id=tid,
                        parent=dspan, category="serve",
                    )
                    tr.record_span(
                        "reply", t_c1, now, trace_id=tid,
                        parent=dspan, category="serve",
                    )
        if self.metrics is not None:
            self._batch_event(bucket, reqs, fails, t0, now, t_c, stall_ms,
                              stall_miss0, swaps0)
        if self.drift is not None and served:
            x, r_sq, e_sq = (np.concatenate(part) for part in zip(*served))
            self.drift.observe(float(r_sq.sum()), float(e_sq.sum()), rows=x)
        return results

    def _batch_event(self, bucket, reqs, fails, t0, now, t_c, stall_ms,
                     stall_miss0, swaps0) -> None:
        """The batch record of the logger's serving section: per-request
        queue waits and latencies, the batch's compute net of any inline
        acquisition, padded rows and the fill of the row bucket, the
        version served and whether it was a hot swap."""
        rows_total = int(sum(r.x.shape[0] for r in reqs))
        rows_served = int(sum(r.x.shape[0] for i, r in enumerate(reqs)
                              if i not in fails))
        padded = (bucket_rows(rows_served, min_bucket=self.engine.min_bucket)
                  - rows_served) if rows_served else 0
        compute_s = (max(0.0, (t_c[1] - t_c[0]) - stall_ms / 1e3)
                     if t_c is not None else 0.0)
        event = {
            "kind": "batch",
            "queries": len(reqs),
            "rejected": len(fails),
            "rows": rows_total,
            "padded_rows": padded,
            "fill_fraction": (round(rows_served / (rows_served + padded), 4)
                              if rows_served else 0.0),
            "admit_to_dispatch_s": [
                round(max(0.0, bucket.t_dispatch - r.t_submit), 6) for r in reqs
            ] if bucket.t_dispatch is not None else [],
            "batch_seconds": round(now - t0, 6),
            "signature": [self.d, self.k],
            "compile_misses": self.engine.compile_misses - stall_miss0,
            "compile_stall_ms": round(stall_ms, 3),
            "query_latency_s": [round(now - r.t_submit, 6) for r in reqs],
            # the decomposition feed: latency = queue_wait + compile_stall
            # + compute + other
            "queue_wait_s": [round(max(0.0, t0 - r.t_submit), 6) for r in reqs],
            "compute_s": round(compute_s, 6),
            "dispatch_s": round(now - t0, 6),
            "occupancy": round(len(reqs) / self.bucket_size, 4),
            "swap": self.swap_count > swaps0,
        }
        if self._served_version is not None:
            event["version"] = self._served_version
        self.metrics.serve(event)
