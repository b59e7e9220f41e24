"""Request-scoped spans on one merged host timeline.

The port's copy of the span half of ``distributed_eigenspaces_tpu/utils/
telemetry.py``: :class:`Tracer` (nested, correlation-ID'd spans carrying
both clocks, exported as a Chrome trace-event JSON that Perfetto loads),
:class:`NullTracer` / :data:`NULL_TRACER` and :func:`tracer_of`. Spans
opened with ``device=True`` also enter a ``torch.profiler.record_function``
(``utils/tracing.py``), so a ``torch.profiler`` capture run alongside shows
the same names beside the kernels they launched. Beside them, the
reference's fixed-memory aggregates, copied as they are: :class:`Histogram`
(log-spaced buckets, mergeable, quantile estimates), :class:`RingLog` (a
bounded event list that folds what it evicts) and :func:`slo_summary`
(attainment and error-budget burn of a p99 target), which
``utils/metrics.MetricsLogger`` holds.

Cross-thread propagation rule: a trace is born where the request enters
the system (``submit``); its ``trace_id`` rides the ticket payload to the
dispatch lane, which records the queue/compute spans AFTER the fact with
:meth:`Tracer.record_span` — spans never require the opening and closing
thread to match.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Any, Iterator

__all__ = [
    "NULL_TRACER",
    "Histogram",
    "NullTracer",
    "RingLog",
    "Span",
    "Tracer",
    "slo_summary",
    "tracer_of",
]


# -- spans -------------------------------------------------------------------


class Span:
    """One finished (or open) span. Host-side record only — creation is
    a few attribute writes; the device sees nothing unless the span was
    opened with ``device=True``."""

    __slots__ = (
        "name", "category", "trace_id", "span_id", "parent_id",
        "t_start_mono", "t_end_mono", "t_start_unix", "attrs",
        "thread_id", "phase",
    )

    def __init__(
        self,
        name: str,
        *,
        category: str = "host",
        trace_id: str | None = None,
        span_id: int = 0,
        parent_id: int | None = None,
        t_start_mono: float = 0.0,
        t_end_mono: float | None = None,
        t_start_unix: float = 0.0,
        attrs: dict | None = None,
        thread_id: int = 0,
        phase: str = "X",
    ):
        self.name = name
        self.category = category
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start_mono = t_start_mono
        self.t_end_mono = t_end_mono
        self.t_start_unix = t_start_unix
        self.attrs = attrs or {}
        self.thread_id = thread_id
        self.phase = phase

    @property
    def duration_s(self) -> float:
        if self.t_end_mono is None:
            return 0.0
        return self.t_end_mono - self.t_start_mono

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "cat": self.category,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_mono": self.t_start_mono,
            "t_unix": self.t_start_unix,
            "duration_s": round(self.duration_s, 9),
            **({"attrs": self.attrs} if self.attrs else {}),
        }


class _SpanHandle:
    """Context manager for an in-flight span; closes it on exit.

    ``handle.span_id`` / ``handle.trace_id`` are readable inside the
    ``with`` body for explicit child parenting across threads."""

    __slots__ = ("_tracer", "span", "_device_cm")

    def __init__(self, tracer: "Tracer", span: Span, device_cm=None):
        self._tracer = tracer
        self.span = span
        self._device_cm = device_cm

    @property
    def trace_id(self) -> str | None:
        return self.span.trace_id

    @property
    def span_id(self) -> int:
        return self.span.span_id

    def set(self, **attrs) -> "_SpanHandle":
        """Attach attributes to the span while it is open."""
        self.span.attrs.update(attrs)
        return self

    def __enter__(self) -> "_SpanHandle":
        if self._device_cm is not None:
            self._device_cm.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._device_cm is not None:
            self._device_cm.__exit__(*exc)
        self._tracer._close(self.span)


class _EpisodeHandle:
    """An open scenario episode (:meth:`Tracer.episode`): closing it
    records ONE ``category="episode"`` span covering the open interval.

    Deliberately OFF the per-thread implicit stack — episodes overlap
    each other and outlive the thread that opened them, so they must
    never parent (or be parented by) request spans. The export routes
    them to their own top-level track."""

    __slots__ = ("_tracer", "name", "attrs", "t_start_mono",
                 "t_start_unix", "span_id", "_closed")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t_start_mono = time.perf_counter()
        self.t_start_unix = time.time()
        self.span_id: int | None = None
        self._closed = False

    def set(self, **attrs) -> "_EpisodeHandle":
        self.attrs.update(attrs)
        return self

    def close(self) -> int | None:
        """Record the episode span; idempotent. Returns the span id."""
        if self._closed:
            return self.span_id
        self._closed = True
        self.span_id = self._tracer.record_span(
            self.name,
            self.t_start_mono,
            time.perf_counter(),
            category="episode",
            attrs=self.attrs,
            t_start_unix=self.t_start_unix,
            thread_id=0,
        )
        return self.span_id

    def __enter__(self) -> "_EpisodeHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Tracer:
    """Thread-safe span collector with a bounded buffer.

    Spans nest implicitly per thread (a ``span()`` opened inside
    another's ``with`` body parents to it) and explicitly across
    threads (``parent=`` / ``trace_id=`` carried on the ticket).
    ``max_spans`` bounds memory on long-lived servers; evicted spans
    bump :attr:`dropped` so a truncated export is loud, not silent.
    """

    def __init__(self, *, max_spans: int = 65536):
        if max_spans < 1:
            raise ValueError(f"max_spans must be >= 1: {max_spans}")
        self.max_spans = max_spans
        self.enabled = True
        self.spans: list[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._next_span = 1
        self._next_trace = 1
        self._local = threading.local()
        # one clock anchor pair for the whole tracer: exports place
        # every span on the monotonic axis and carry the unix anchor so
        # two processes' traces can be shifted onto one wall clock
        self.t0_mono = time.perf_counter()
        self.t0_unix = time.time()

    # -- ids -----------------------------------------------------------------

    def new_trace(self, kind: str = "trace") -> str:
        """A fresh correlation id: one per request ticket / fit run /
        drift arc. Process-qualified so merged multi-process streams
        never collide."""
        with self._lock:
            n = self._next_trace
            self._next_trace += 1
        return f"{kind}-{os.getpid():x}-{n:06x}"

    def _alloc(self) -> int:
        with self._lock:
            n = self._next_span
            self._next_span += 1
        return n

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Span | None:
        """The innermost open span on THIS thread (implicit parent)."""
        st = self._stack()
        return st[-1] if st else None

    # -- recording -----------------------------------------------------------

    def span(
        self,
        name: str,
        *,
        trace_id: str | None = None,
        parent: int | None = None,
        category: str = "host",
        attrs: dict | None = None,
        device: bool = False,
    ) -> _SpanHandle:
        """Open a span; use as a context manager. Inherits ``trace_id``
        and parent from the enclosing span on this thread when not
        given. ``device=True`` additionally enters a
        ``torch.profiler.record_function`` so the name shows up on the
        profiler's timeline beside the kernels launched inside it."""
        cur = self.current()
        if trace_id is None and cur is not None:
            trace_id = cur.trace_id
        if parent is None and cur is not None:
            parent = cur.span_id
        sp = Span(
            name,
            category=category,
            trace_id=trace_id,
            span_id=self._alloc(),
            parent_id=parent,
            t_start_mono=time.perf_counter(),
            t_start_unix=time.time(),
            attrs=dict(attrs) if attrs else {},
            thread_id=threading.get_ident(),
        )
        device_cm = None
        if device:
            device_cm = _device_annotation(name)
        self._stack().append(sp)
        return _SpanHandle(self, sp, device_cm)

    def _close(self, sp: Span) -> None:
        sp.t_end_mono = time.perf_counter()
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:  # exited out of order — tolerate, don't corrupt
            st.remove(sp)
        self._append(sp)

    def record_span(
        self,
        name: str,
        t_start_mono: float,
        t_end_mono: float,
        *,
        trace_id: str | None = None,
        parent: int | None = None,
        category: str = "host",
        attrs: dict | None = None,
        t_start_unix: float | None = None,
        thread_id: int | None = None,
    ) -> int:
        """Record a span AFTER the fact from explicit timestamps — the
        cross-thread form (queue wait measured on the dispatch lane from
        the submit thread's stamp). Returns the span id for parenting
        children. Timestamps are ``time.perf_counter()`` values."""
        if t_start_unix is None:
            # derive the wall clock from the shared anchor so both
            # clocks stay consistent for spans stamped mono-only
            t_start_unix = self.t0_unix + (t_start_mono - self.t0_mono)
        sp = Span(
            name,
            category=category,
            trace_id=trace_id,
            span_id=self._alloc(),
            parent_id=parent,
            t_start_mono=t_start_mono,
            t_end_mono=t_end_mono,
            t_start_unix=t_start_unix,
            attrs=dict(attrs) if attrs else {},
            thread_id=(
                thread_id if thread_id is not None
                else threading.get_ident()
            ),
        )
        self._append(sp)
        return sp.span_id

    def episode(self, name: str, **attrs) -> _EpisodeHandle:
        """Open a named scenario episode: a long span that
        overlaps other episodes and request spans freely, rendered as
        its own top-level track by :meth:`export_chrome_trace`.
        ``MetricsLogger.summary()["episodes"]`` slices per-tier records
        by these spans' windows — the markers ARE the verdict's
        episode boundaries. Close via the returned handle (or use it
        as a context manager)."""
        return _EpisodeHandle(self, name, dict(attrs))

    def event(
        self,
        name: str,
        *,
        trace_id: str | None = None,
        category: str = "host",
        attrs: dict | None = None,
    ) -> None:
        """Record an instant event (zero-duration mark): fault
        detections, cache hits, publishes."""
        cur = self.current()
        if trace_id is None and cur is not None:
            trace_id = cur.trace_id
        now = time.perf_counter()
        sp = Span(
            name,
            category=category,
            trace_id=trace_id,
            span_id=self._alloc(),
            parent_id=cur.span_id if cur is not None else None,
            t_start_mono=now,
            t_end_mono=now,
            t_start_unix=time.time(),
            attrs=dict(attrs) if attrs else {},
            thread_id=threading.get_ident(),
            phase="i",
        )
        self._append(sp)

    def _append(self, sp: Span) -> None:
        with self._lock:
            if len(self.spans) >= self.max_spans:
                # drop oldest: the tail of a long run is what you came
                # to look at; the drop is counted, never silent
                del self.spans[0 : max(1, self.max_spans // 16)]
                self.dropped += max(1, self.max_spans // 16)
            self.spans.append(sp)

    # -- export --------------------------------------------------------------

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self.spans)

    def export_chrome_trace(self, path: str) -> str:
        """Write the merged timeline as Chrome trace-event JSON —
        loadable by Perfetto (ui.perfetto.dev) and ``chrome://tracing``.

        One duration event (``ph: "X"``) per span, on its recording
        thread's track; instant events as ``ph: "i"``. ``args`` carries
        ``trace_id`` / ``parent_id`` / ``t_unix`` plus the span attrs,
        so every served query's chain is correlatable by one id across
        threads. ``otherData`` records the clock anchors and the drop
        count."""
        spans = self.snapshot()
        pid = os.getpid()
        events: list[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": "distributed_eigenspaces_tpu_torch"},
            }
        ]
        # scenario episodes get the top-level track (tid 0, named),
        # above every per-thread track — Perfetto then shows the
        # request spans of each phase directly under its episode bar
        if any(sp.category == "episode" for sp in spans):
            events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": "episodes"},
            })
        tids = sorted({
            sp.thread_id for sp in spans if sp.category != "episode"
        })
        # compress real thread idents to small track numbers
        tid_map = {t: i + 1 for i, t in enumerate(tids)}
        for t, small in tid_map.items():
            events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": small,
                "args": {"name": f"thread-{small} ({t})"},
            })
        for sp in spans:
            ev: dict = {
                "name": sp.name,
                "cat": sp.category,
                "ph": sp.phase,
                "ts": round((sp.t_start_mono - self.t0_mono) * 1e6, 3),
                "pid": pid,
                "tid": (
                    0 if sp.category == "episode"
                    else tid_map.get(sp.thread_id, 0)
                ),
                "args": {
                    "trace_id": sp.trace_id,
                    "span_id": sp.span_id,
                    "parent_id": sp.parent_id,
                    "t_unix": round(sp.t_start_unix, 6),
                    **sp.attrs,
                },
            }
            if sp.phase == "X":
                ev["dur"] = round(sp.duration_s * 1e6, 3)
            else:
                ev["s"] = "t"
            events.append(ev)
        doc = {
            "displayTimeUnit": "ms",
            "traceEvents": events,
            "otherData": {
                "t0_unix": self.t0_unix,
                "t0_mono": self.t0_mono,
                "dropped_spans": self.dropped,
                "span_count": len(spans),
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def _device_annotation(name: str):
    """A ``torch.profiler.record_function`` region for ``name`` (it shows
    on a profiler trace beside the kernels launched inside it), or None
    when the profiler API is unavailable — telemetry must never take
    down the code it observes."""
    try:
        from distributed_eigenspaces_tpu_torch.utils.tracing import (
            trace_annotation,
        )

        return trace_annotation(name)
    except Exception:
        return None


class NullTracer:
    """API-compatible no-op tracer: instrumented code traces
    unconditionally; without a tracer attached every call is a couple
    of attribute lookups and no allocation of span records."""

    enabled = False
    dropped = 0
    spans: list = []

    class _NullHandle:
        trace_id = None
        span_id = None

        def set(self, **attrs):
            return self

        def close(self):
            return None

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    _HANDLE = _NullHandle()

    def new_trace(self, kind: str = "trace") -> None:
        return None

    def current(self) -> None:
        return None

    def span(self, name, **kw) -> "_NullHandle":
        return self._HANDLE

    def episode(self, name, **kw) -> "_NullHandle":
        return self._HANDLE

    def record_span(self, name, t_start_mono, t_end_mono, **kw) -> None:
        return None

    def event(self, name, **kw) -> None:
        return None

    def snapshot(self) -> list:
        return []

    def export_chrome_trace(self, path: str) -> str:
        raise RuntimeError(
            "no tracer attached: construct a telemetry.Tracer and "
            "attach it (MetricsLogger.attach_tracer) before exporting"
        )


NULL_TRACER = NullTracer()


def tracer_of(metrics) -> Any:
    """The tracer attached to a ``MetricsLogger`` (or anything with a
    ``.tracer``), else :data:`NULL_TRACER` — the one null-safety rule
    every instrumentation site uses."""
    tr = getattr(metrics, "tracer", None)
    return tr if tr is not None else NULL_TRACER


# -- histogram ---------------------------------------------------------------


class Histogram:
    """Bounded log-spaced histogram with mergeable counts and quantile
    estimates — the fixed-memory replacement for raw latency lists.

    Bucket upper edges are ``lo * growth**i`` up to ``hi`` plus one
    overflow bucket, so the whole structure is ~60 ints regardless of
    how many values were recorded. Quantiles interpolate geometrically
    inside the winning bucket: the estimate is within one ``growth``
    factor of the exact quantile by construction (tested against known
    distributions). Two histograms with the same parameters merge by
    adding counts — the property that makes ring-buffer eviction safe
    (evicted events fold here; ``summary()`` merges live + evicted).
    """

    __slots__ = ("lo", "hi", "growth", "bounds", "counts", "count",
                 "total", "min", "max")

    def __init__(self, *, lo: float = 1e-6, hi: float = 3600.0,
                 growth: float = 1.5):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(
                f"need 0 < lo < hi and growth > 1: {lo}, {hi}, {growth}"
            )
        self.lo = lo
        self.hi = hi
        self.growth = growth
        bounds = []
        edge = lo
        while edge < hi:
            bounds.append(edge)
            edge *= growth
        bounds.append(edge)
        self.bounds = bounds  # upper edges; +1 overflow bucket beyond
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def record(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        self.counts[i] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def record_many(self, values) -> None:
        for v in values:
            self.record(v)

    def merge(self, other: "Histogram") -> "Histogram":
        if (self.lo, self.hi, self.growth) != (
            other.lo, other.hi, other.growth
        ):
            raise ValueError(
                "cannot merge histograms with different bucket layouts"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        for m, pick in (("min", min), ("max", max)):
            ov = getattr(other, m)
            if ov is not None:
                sv = getattr(self, m)
                setattr(self, m, ov if sv is None else pick(sv, ov))
        return self

    def copy(self) -> "Histogram":
        h = Histogram(lo=self.lo, hi=self.hi, growth=self.growth)
        h.merge(self)
        return h

    def quantile(self, q: float) -> float | None:
        """Estimated q-quantile (0 <= q <= 1), or None when empty.
        Geometric interpolation inside the winning bucket; clamped to
        the observed min/max so the estimate never leaves the data's
        range."""
        if self.count == 0:
            return None
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"q must be in [0, 1]: {q}")
        # nearest-rank target (1-based), matching sorted()[ceil(q*n)-1]
        target = max(1, int(q * self.count + 0.9999999999))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                if i >= len(self.bounds):  # overflow bucket
                    est = self.max if self.max is not None else self.hi
                else:
                    upper = self.bounds[i]
                    lower = upper / self.growth if i > 0 else 0.0
                    # geometric midpoint-ish: position of the target
                    # rank inside the bucket, interpolated in log space
                    frac = (target - (seen - c)) / max(c, 1)
                    if lower <= 0:
                        est = upper * frac
                    else:
                        est = lower * (upper / lower) ** frac
                lo_clamp = self.min if self.min is not None else est
                hi_clamp = self.max if self.max is not None else est
                return min(max(est, lo_clamp), hi_clamp)
        return self.max

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def as_dict(self) -> dict:
        out = {
            "count": self.count,
            "sum": round(self.total, 6),
        }
        if self.count:
            out["mean"] = round(self.total / self.count, 9)
            for name, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
                out[name] = round(self.quantile(q), 9)
            out["min"] = round(self.min, 9)
            out["max"] = round(self.max, 9)
        return out


# -- ring buffer -------------------------------------------------------------


class RingLog:
    """Bounded event list: appending past ``retention`` evicts the
    OLDEST entry through ``on_evict`` (which folds it into running
    aggregates — :class:`Histogram` and counters — so a long-lived
    server's summary stays correct after eviction, at fixed memory).

    Quacks like the list it replaces in ``MetricsLogger``: iteration,
    ``len``, indexing, truthiness all behave identically for retained
    entries."""

    def __init__(self, retention: int = 4096, on_evict=None):
        if retention < 1:
            raise ValueError(f"retention must be >= 1: {retention}")
        self.retention = retention
        self.on_evict = on_evict
        self.evicted = 0
        self._items: list = []

    def append(self, item) -> None:
        self._items.append(item)
        if len(self._items) > self.retention:
            old = self._items.pop(0)
            self.evicted += 1
            if self.on_evict is not None:
                self.on_evict(old)

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator:
        return iter(list(self._items))

    def __getitem__(self, i):
        return self._items[i]

    def __bool__(self) -> bool:
        return bool(self._items)

    def clear(self) -> None:
        self._items.clear()


# -- SLO ---------------------------------------------------------------------


def slo_summary(
    target_p99_ms: float,
    latencies_ms,
    *,
    objective: float = 0.99,
    evicted_requests: int = 0,
    evicted_violations: int = 0,
    p99_ms: float | None = None,
) -> dict:
    """SLO attainment + error-budget burn for a declared p99 target.

    ``latencies_ms`` is the LIVE (ring-retained) rolling window;
    ``evicted_*`` carry the folded lifetime counts, so attainment is
    reported both for the rolling window and the whole run. Burn rate
    is the standard SRE definition: the fraction of requests violating
    the target divided by the budgeted fraction (``1 - objective``) —
    1.0 means burning budget exactly as fast as allowed, >1 means the
    SLO fails if sustained.

    Burn is reported over TWO windows side by side (``out["burn"]``,
    docs/OBSERVABILITY.md): ``fast`` over the rolling ring window
    (a flash crowd spikes it immediately, then it decays as healthy
    requests refill the ring) and ``slow`` over the whole run's
    lifetime counts (a slow regression creeps it up and a burst barely
    moves it) — the pairing that distinguishes transient incidents
    from sustained SLO erosion. ``budget_burn`` stays the lifetime
    (slow) number for backward compatibility; the rolling window's own
    burn also appears as ``window["budget_burn"]``.
    """
    window = [float(v) for v in latencies_ms]
    w_viol = sum(1 for v in window if v > target_p99_ms)
    requests = len(window) + evicted_requests
    violations = w_viol + evicted_violations
    budget = max(1.0 - objective, 1e-9)
    out: dict = {
        "target_p99_ms": target_p99_ms,
        "objective": objective,
        "requests": requests,
        "violations": violations,
    }
    if p99_ms is None and window:
        ws = sorted(window)
        p99_ms = ws[min(len(ws) - 1, int(len(ws) * objective))]
    if p99_ms is not None:
        out["p99_ms"] = round(p99_ms, 3)
        out["attained"] = bool(p99_ms <= target_p99_ms)
    if requests:
        attainment = 1.0 - violations / requests
        slow_burn = round((violations / requests) / budget, 4)
        out["attainment"] = round(attainment, 6)
        out["error_budget"] = round(budget, 6)
        out["budget_burn"] = slow_burn
        fast_burn = (
            round((w_viol / len(window)) / budget, 4) if window
            else slow_burn
        )
        out["burn"] = {"fast": fast_burn, "slow": slow_burn}
    if window:
        out["window"] = {
            "requests": len(window),
            "violations": w_viol,
            "attainment": round(1.0 - w_viol / len(window), 6),
            "budget_burn": round((w_viol / len(window)) / budget, 4),
        }
    return out
