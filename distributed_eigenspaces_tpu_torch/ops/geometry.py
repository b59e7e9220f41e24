"""Launch geometry of the port's hand-written kernels, as data.

Each module of ``ops/`` that launches a kernel has a pure function
``<kernel>_launch(...)`` that returns the :class:`KernelLaunch` its C host
code picks for given shapes: grid, threads, shared memory, and for every
operand the extent that one CTA (thread block) reads, writes or stages over
its life. The ``*_cuda`` wrappers compute that record once, launch with it,
and hand the same object to :func:`note`, so a :func:`recording` block sees
every launch made inside it.

The record is the Hopper reading of a Pallas block ref. On a TPU the grid
runs in order on one core and a block ref is what one grid step owns; on
Hopper the CTAs run at once on 132 SMs and a loop inside the CTA replaces
the sequential grid axis, so what one CTA owns over its life is the unit the
analyzer's tile budget bounds (``analysis/contracts.py::check_pallas``).
A kernel whose single CTA owns a whole operand is legal and exact, and does
its work on one SM.

On the CPU nothing is launched: the analyzer calls the ``_launch`` functions
at the audit shapes. On the card ``torch.profiler`` reads the launches back
from its Chrome trace (:func:`profiled_kernels`), and
:func:`geometry_mismatches` holds every profiled event of a port kernel
against its record.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import json
import math
import re

__all__ = [
    "RECORDED_KERNELS",
    "KernelLaunch",
    "geometry_mismatches",
    "note",
    "profiled_kernels",
    "recording",
]


#: base symbols of the kernels whose wrappers record their launches
RECORDED_KERNELS = (
    "serve_split_kernel",  # ops/serve_project.py, every route
    "gram_bf16_tma_kernel",  # ops/gram.py, aligned bf16 x
    "gram_bf16_kernel",  # ops/gram.py, other bf16 x
    "gram_f32_kernel",  # ops/gram.py, fp32 x
    "gram_s8_transpose_kernel",  # ops/gram.py, int8 x: x^T first
    "gram_s8_tma_kernel",  # ops/gram.py, int8 x: then the Gram
    "matvec_gram_kernel",  # ops/matvec_gram.py
    "mutant_full_block_kernel",  # ops/mutant_full_block.py
)


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """One launch of a hand-written kernel, as its host code makes it."""

    #: the kernel's symbol with its template arguments as the compiler
    #: spells them, e.g. ``"serve_split_kernel<float, 0, 4>"``
    kernel: str
    #: the CUDA source, relative to the package (``"csrc/serve_project.cu"``)
    source: str
    #: CTAs per launch, or None while the grid is sized on the card from the
    #: occupancy query (``grid_rule="occupancy"``): :meth:`resolved` fills it
    grid: tuple[int, int, int] | None
    threads: int
    dynamic_smem: int
    static_smem: int
    #: ``(name, extent)`` per operand: what one CTA reads, writes or stages
    #: over its life (for a kernel of phases, over one item of the phase)
    operands: tuple[tuple[str, tuple[int, ...]], ...]
    #: "fixed" (the host code's formula) or "occupancy" (a cooperative
    #: launch: as many CTAs as the card keeps resident, sized on the card)
    grid_rule: str = "fixed"
    #: for a kernel whose rows must not depend on the launch's row count,
    #: the order in which it sums each output, as ``(name, value)`` pairs
    #: that are a function of the shapes other than rows; empty otherwise
    order: tuple = ()

    @property
    def block(self) -> tuple[int, int, int]:
        return (self.threads, 1, 1)

    @property
    def smem(self) -> int:
        """Shared memory a CTA holds: static plus dynamic bytes."""
        return self.static_smem + self.dynamic_smem

    def resolved(self, grid) -> "KernelLaunch":
        """This launch with the grid the card sized for it."""
        grid = tuple(int(g) for g in grid)
        if len(grid) != 3 or min(grid) < 1:
            raise ValueError(f"{self.kernel}: grid {grid} is not three counts >= 1")
        return dataclasses.replace(self, grid=grid)

    def operand_elems(self) -> dict[str, int]:
        return {name: math.prod(ext) for name, ext in self.operands}

    def to_json(self) -> dict:
        return {
            "kernel": self.kernel,
            "source": self.source,
            "grid": list(self.grid) if self.grid is not None else None,
            "grid_rule": self.grid_rule,
            "block": list(self.block),
            "dynamic_smem": self.dynamic_smem,
            "static_smem": self.static_smem,
            "operands": [[name, list(ext)] for name, ext in self.operands],
            "order": [[name, value] for name, value in self.order],
        }


_active: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "det_kernel_launches", default=()
)


@contextlib.contextmanager
def recording():
    """Collect the :class:`KernelLaunch` of every launch this thread makes
    inside the block (a list, in launch order). Blocks nest, and every
    enclosing block sees the launches of the blocks inside it."""
    launches: list[KernelLaunch] = []
    token = _active.set(_active.get() + (launches,))
    try:
        yield launches
    finally:
        _active.reset(token)


def note(launch: KernelLaunch) -> None:
    """Called by a wrapper right after its launch succeeded."""
    for launches in _active.get():
        launches.append(launch)


# -- reading launches back from torch.profiler ------------------------------

_BASE = re.compile(r"([A-Za-z_]\w*)\s*(<|\()")


def _symbol(name: str, bases) -> str | None:
    """``"kernel<args>"`` (or ``"kernel"``) out of a demangled event name
    such as ``void (anonymous namespace)::kernel<float, 0, 4>(float const*,
    ...)``, when its base name is one of ``bases``."""
    for m in _BASE.finditer(name):
        if m.group(1) not in bases:
            continue
        start = m.start(1)
        if m.group(2) == "(":
            return m.group(1)
        depth = 0
        for i in range(m.end(2) - 1, len(name)):
            depth += {"<": 1, ">": -1}.get(name[i], 0)
            if depth == 0:
                return re.sub(r"\s+", " ", name[start:i + 1])
        return None
    return None


def _triple(value) -> tuple[int, int, int] | None:
    if isinstance(value, list) and len(value) == 3:
        return tuple(int(v) for v in value)
    return None


def profiled_kernels(prof, bases, trace_path) -> list[dict]:
    """The kernel events of a finished ``torch.profiler.profile`` whose
    kernel's base name is in ``bases``, read from its Chrome trace (written
    to ``trace_path``: the launch arguments live only there):
    ``{"name", "symbol", "grid", "block", "smem", "dur_us", "args"}`` each,
    ``args`` being the raw arguments the profiler recorded for it."""
    bases = set(bases)
    prof.export_chrome_trace(str(trace_path))
    with open(trace_path, encoding="utf-8") as f:
        trace = json.load(f)
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") != "kernel":
            continue
        sym = _symbol(ev.get("name", ""), bases)
        if sym is None:
            continue
        args = ev.get("args", {})
        out.append({
            "name": ev["name"],
            "symbol": sym,
            "grid": _triple(args.get("grid")),
            "block": _triple(args.get("block")),
            "smem": args.get("shared memory"),
            "dur_us": ev.get("dur"),
            "args": args,
        })
    return out


def geometry_mismatches(events, launches) -> list[str]:
    """The profiled events against the recorded launches, per kernel
    symbol: each launch must show up as exactly one event with its grid,
    block and shared memory (static plus dynamic), and no event may be
    left over. Returns what disagrees, one line each (empty when every
    declaration held)."""
    want: dict[str, collections.Counter] = {}
    for launch in launches:
        if launch.grid is None:
            return [f"{launch.kernel}: recorded with an unresolved grid"]
        want.setdefault(launch.kernel, collections.Counter())[
            (launch.grid, launch.block, launch.smem)] += 1
    got: dict[str, collections.Counter] = {}
    for ev in events:
        got.setdefault(ev["symbol"], collections.Counter())[
            (ev["grid"], ev["block"], ev["smem"])] += 1
    bad = []
    for sym in sorted(set(want) | set(got)):
        w, g = want.get(sym, collections.Counter()), got.get(sym, collections.Counter())
        if w != g:
            bad.append(
                f"{sym}: recorded (grid, block, smem) x count {dict(w)} but "
                f"profiled {dict(g)}"
            )
    return bad
