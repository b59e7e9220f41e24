"""Compile lifecycle: the persistent store of kernel libraries and of
acquired programs.

Counterpart of ``distributed_eigenspaces_tpu/utils/compile_cache.py``. The
port runs eagerly, so it has no XLA program to compile or cache. What a
cold process pays before its first result is the ``nvcc`` build of each
hand kernel it launches (``ops/_build.py``), the start-up of cuBLAS and
cuSOLVER, and the building of each program's closures. The reference's two
layers map onto that:

1. **The kernel libraries** (:func:`configure_persistent_cache`, the
   counterpart of XLA's persistent compilation cache): the library
   directory of ``ops/_build.py`` is pointed at ``<dir>/kernels`` for the
   process. A library is keyed by its source, the flags and the ``nvcc``
   version, and written atomically (a temporary file, then a rename), so a
   second process with the same checkout and toolkit loads it and runs no
   ``nvcc``. A library already loaded in the process stays loaded. A fresh
   directory pays ``nvcc``: nothing is copied into it from another build
   directory.

2. **Acquired programs** (:class:`CompileCache`, the counterpart of the
   AOT executable store): ``get_or_build(key, build_fn, libraries=...)``
   returns the program ``build_fn()`` builds (the whole-fit handle, a
   transform bucket's function, the fleet's fit and extraction), kept in
   a memory tier keyed by :class:`CacheKey`. The disk tier writes one meta
   JSON an entry: the format, the key string, the torch / CUDA versions,
   the device, and the name and digest of each kernel library the program
   launches. A warm process validates the entry and loads those libraries
   at acquisition, not at the program's first launch; the closures are
   rebuilt (a Python closure cannot be stored), which costs next to
   nothing.

The ladder is the reference's, every rung loud and no rung fatal: memory
hit, then disk hit (meta validated: format, key string, versions,
backend, and each library's file and digest), then a fresh build (its
libraries built and loaded, its meta written best-effort). A corrupt,
truncated or mismatched entry, or a library whose file is gone or whose
digest differs, warns, counts a ``fallback`` and rebuilds: a cache never
changes results and never stops a run.

**CPU programs are not persisted.** A program on the CPU launches no
library, so its disk entry would carry nothing a second process could
reuse: it is kept in the memory tier only and counted ``not_portable``
(the reference's CPU portability guard has the same effect for its
programs with host custom calls).

**Keys.** The reference's ``jax_version`` is the torch version, the CUDA
runtime version and, on a card, the device's compute capability; the
backend is ``"cuda"`` or ``"cpu"``. Unlike the reference's programs, which
take their cold start as an operand, the port's closures hold their
cold-start basis (drawn from ``PCAConfig.seed``, or a caller's ``v0``):
each caller puts the seed, or the digest of an explicit start, and the
device into the key's signature, so two programs with different starts
never share an entry.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
import warnings
from typing import Callable, Sequence

__all__ = [
    "CacheKey",
    "CompileCache",
    "compile_cache_for",
    "config_knobs",
    "configure_persistent_cache",
    "make_key",
]

#: bump when the on-disk entry layout changes: old entries then fail meta
#: validation and fall back to a fresh build
_FORMAT_VERSION = 1

#: PCAConfig fields that change an acquired program (shape fields ride in
#: the key's signature, the device in its backend); warm start and warm
#: orth are keyed at their resolved values so "auto" and its resolution
#: cannot alias two programs under one key
_PROGRAM_KNOB_FIELDS = (
    "discount",
    "solver",
    "subspace_iters",
    "orth_method",
    "compute_dtype",
    "stage_dtype",
    "dtype",
    "state_dtype",
    "collectives",
    "merge_interval",
    "pipeline_merge",
)


def config_knobs(cfg) -> tuple[tuple[str, str], ...]:
    """The program-affecting PCAConfig knobs as a canonical ``((name,
    repr), ...)`` tuple: the ``knobs`` half of every config-derived
    :class:`CacheKey`."""
    knobs = [(f, repr(getattr(cfg, f))) for f in _PROGRAM_KNOB_FIELDS]
    knobs.append(("warm_start", repr(cfg.resolved_warm_start())))
    knobs.append(("warm_orth", repr(cfg.resolved_warm_orth())))
    return tuple(knobs)


def fit_libraries(cfg, *, staged: bool = True) -> tuple[str, ...]:
    """The ``csrc/`` kernels a dense fit of ``cfg`` launches on a card: the
    Gram's (the s8 pair's for an int8 stage when ``staged``) unless every
    cold worker solve streams (the route rule of
    ``parallel.worker_pool._local_eigenspaces``), and the fused sweep's
    where the merge runs the distributed eigensolve."""
    libs = []
    iters, d, k = cfg.subspace_iters, cfg.dim, cfg.k
    streams = cfg.resolved_local_solver() == "subspace" and (
        d >= 4096 or (2 * k * iters < d and iters <= 6))
    if not streams:
        int8 = staged and cfg.resolved_stage_dtype() == "int8"
        libs.append("gram_s8" if int8 else "gram")
    if cfg.solver == "distributed" and cfg.uses_distributed_solve():
        libs.append("matvec_gram")
    return tuple(libs)


def start_digest(v) -> str | None:
    """The digest of a start basis (a tensor or an array) as float32 bytes,
    for a key's signature; None for None."""
    if v is None:
        return None
    import numpy as np
    import torch

    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(v, np.float32).tobytes()).hexdigest()[:16]


def runtime_versions(backend: str) -> str:
    """``torch=<v>|cuda=<runtime>`` and, on a card, ``|sm=<major><minor>``
    of the current device: the port's counterpart of the reference's jax
    version in a key."""
    import torch

    out = f"torch={torch.__version__}|cuda={torch.version.cuda}"
    if backend == "cuda" and torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability()
        out += f"|sm={major}{minor}"
    return out


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """One cache key: everything that must match for a stored program to be
    reused. Two keys with any differing field map to different digests:
    changing ``k``, a dtype, a solver knob, the versions or the backend is
    a miss by construction."""

    kind: str  # program kind: "scan_fit", "fleet_fit", "transform_project", ...
    signature: tuple  # shape signature (kind-specific, hashable)
    dtype: str  # primary operand dtype
    backend: str  # "cuda" or "cpu"
    torch_version: str  # runtime_versions(backend) at key time
    knobs: tuple = ()  # ((name, repr), ...) program-affecting config knobs

    def string(self) -> str:
        return (
            f"fmt{_FORMAT_VERSION}|kind={self.kind}"
            f"|sig={self.signature!r}|dtype={self.dtype}"
            f"|backend={self.backend}|versions={self.torch_version}"
            f"|knobs={self.knobs!r}"
        )

    def digest(self) -> str:
        return hashlib.sha256(self.string().encode()).hexdigest()[:32]


def make_key(
    kind: str,
    signature: tuple,
    dtype,
    *,
    knobs: tuple = (),
    backend: str | None = None,
    torch_version: str | None = None,
    device=None,
) -> CacheKey:
    """A :class:`CacheKey` with the runtime defaults resolved: the backend
    of ``device`` (else ``"cuda"`` where a card is present, ``"cpu"``
    elsewhere) and that backend's :func:`runtime_versions`. Tests override
    both to prove version and backend invalidation."""
    if backend is None:
        import torch

        if device is not None:
            backend = torch.device(device).type
        else:
            backend = "cuda" if torch.cuda.is_available() else "cpu"
    return CacheKey(
        kind=kind,
        signature=tuple(signature),
        dtype=str(dtype).replace("torch.", ""),
        backend=backend,
        torch_version=(runtime_versions(backend) if torch_version is None
                       else torch_version),
        knobs=tuple(knobs),
    )


def _file_digest(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CompileCache:
    """Two-tier store of acquired programs: per-process memory plus an
    optional disk directory of meta entries (module docstring).

    ``get_or_build(key, build_fn, libraries=())`` returns the program for
    ``key``; ``build_fn()`` builds it and ``libraries`` names the
    ``csrc/`` kernels it launches. Counters (:meth:`stats`): ``hits``
    (memory), ``disk_hits`` (a validated entry: its libraries loaded, no
    ``nvcc``), ``misses`` (fresh builds), ``fallbacks`` (disk entries
    rejected loudly), ``not_portable`` (CPU programs kept in memory only)
    and ``compile_ms_total`` (wall time of the fresh builds: the ``nvcc``
    builds dominate it; disk hits do not add to it).

    ``cache_dir=None`` is a memory-only cache: the same counters and
    timing, no persistence.
    """

    def __init__(self, cache_dir: str | None = None):
        self.cache_dir = None if cache_dir is None else str(cache_dir)
        if self.cache_dir is not None:
            os.makedirs(self.cache_dir, exist_ok=True)
        self._mem: dict[str, object] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.disk_hits = 0
        self.misses = 0
        self.fallbacks = 0
        self.not_portable = 0
        self.compile_ms_total = 0.0
        self.last_compile_ms = 0.0
        #: optional ``utils.telemetry.Tracer`` (set by
        #: ``MetricsLogger.attach_compile`` / ``attach_tracer``): hits land
        #: as instant events, fresh builds as spans
        self.tracer = None

    # -- paths ---------------------------------------------------------------

    def _meta_path(self, key: CacheKey) -> str:
        return os.path.join(self.cache_dir, f"{key.digest()}.json")

    # -- disk tier -----------------------------------------------------------

    def _load_disk(self, key: CacheKey) -> bool:
        """Validate the disk entry for ``key`` and load the libraries it
        names; True on a hit. A missing entry is a plain miss; every other
        failure (unreadable or truncated meta, a format, key string,
        version or backend that does not match, a library whose file is
        gone or whose digest differs) warns and returns False (the fresh
        build), never raises."""
        if self.cache_dir is None:
            return False
        meta_path = self._meta_path(key)
        if not os.path.exists(meta_path):
            return False
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            bad = None
            if meta.get("format") != _FORMAT_VERSION:
                bad = f"format {meta.get('format')} != {_FORMAT_VERSION}"
            elif meta.get("key") != key.string():
                bad = "key string mismatch (digest collision or tamper)"
            elif meta.get("torch_version") != key.torch_version:
                bad = f"torch {meta.get('torch_version')} != {key.torch_version}"
            elif meta.get("backend") != key.backend:
                bad = f"backend {meta.get('backend')} != {key.backend}"
            if bad is not None:
                raise ValueError(bad)
            libs = meta["libraries"]
            from distributed_eigenspaces_tpu_torch.ops import _build

            for lib in libs:
                path = _build.library_path(lib["name"])
                if path.name != lib["file"] or not path.is_file():
                    raise ValueError(f"library {lib['file']} is not in {path.parent}")
                if _file_digest(path) != lib["sha256"]:
                    raise ValueError(f"library {lib['file']} digest mismatch")
            for lib in libs:
                _build.load(lib["name"])
            return True
        except Exception as e:  # corrupt / truncated / mismatched: fall back
            with self._lock:
                self.fallbacks += 1
            warnings.warn(
                f"compile cache entry for {key.kind} {key.signature} is "
                f"invalid ({e!r}) — falling back to a fresh build "
                "(results are unaffected; the entry will be rewritten)",
                stacklevel=3,
            )
            return False

    def _store_disk(self, key: CacheKey, libraries: Sequence[str]) -> None:
        """Best-effort persist of the meta entry: a directory that cannot be
        written costs the next process a build, never this one a crash."""
        try:
            from distributed_eigenspaces_tpu_torch.ops import _build

            libs = []
            for name in libraries:
                path = _build.build(name)
                libs.append({"name": name, "file": path.name,
                             "sha256": _file_digest(path)})
            import torch

            meta_path = self._meta_path(key)
            tmp = f"{meta_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "format": _FORMAT_VERSION,
                        "key": key.string(),
                        "kind": key.kind,
                        "torch_version": key.torch_version,
                        "backend": key.backend,
                        "device": (torch.cuda.get_device_name()
                                   if key.backend == "cuda"
                                   and torch.cuda.is_available() else key.backend),
                        "libraries": libs,
                        "written_at": time.time(),
                    },
                    f,
                )
            os.replace(tmp, meta_path)  # atomic: readers never see a torn entry
        except Exception as e:
            from distributed_eigenspaces_tpu_torch.utils.metrics import log_line

            log_line(
                "compile cache persist failed (a library did not build or "
                "the cache dir is unwritable) — continuing with the "
                "in-memory program",
                kind=key.kind,
                error=repr(e),
            )

    # -- the one entry point -------------------------------------------------

    def get_or_build(self, key: CacheKey, build_fn: Callable[[], object],
                     libraries: Sequence[str] = ()):
        """The program for ``key``: memory hit, then disk hit (its
        libraries loaded), then a fresh ``build_fn()`` with its
        ``libraries`` built and loaded here, at acquisition (persisted
        best-effort where the program is portable)."""
        from distributed_eigenspaces_tpu_torch.utils.telemetry import tracer_of

        tr = tracer_of(self)
        s = key.string()
        with self._lock:
            hit = self._mem.get(s)
            if hit is not None:
                self.hits += 1
                tr.event("compile_cache_hit", category="compile",
                         attrs={"kind": key.kind, "tier": "memory"})
                return hit
        if self._load_disk(key):
            program = build_fn()
            with self._lock:
                self.disk_hits += 1
                self._mem[s] = program
            tr.event("compile_cache_hit", category="compile",
                     attrs={"kind": key.kind, "tier": "disk"})
            return program
        t0 = time.perf_counter()
        program = build_fn()
        if key.backend == "cuda" and libraries:
            from distributed_eigenspaces_tpu_torch.ops import _build

            for name in libraries:
                _build.load(name)
        if self._portable(key):
            self._store_disk(key, libraries)
        dt_ms = (time.perf_counter() - t0) * 1e3
        tr.record_span(
            "compile", t0, time.perf_counter(), category="compile",
            attrs={"kind": key.kind, "signature": repr(key.signature)},
        )
        with self._lock:
            self.misses += 1
            self.compile_ms_total += dt_ms
            self.last_compile_ms = dt_ms
            self._mem[s] = program
        return program

    def _portable(self, key: CacheKey) -> bool:
        """Whether ``key``'s program gets a disk entry: never for a
        memory-only cache, never on the CPU (module docstring)."""
        if self.cache_dir is None:
            return False  # memory-only cache: nothing to persist
        if key.backend != "cpu":
            return True
        with self._lock:
            self.not_portable += 1
        return False

    def contains(self, key: CacheKey) -> bool:
        """Whether ``key`` would be served without a fresh build (memory, or
        a disk entry): the prewarm assertion's question. Bumps no counter
        and loads nothing."""
        with self._lock:
            if key.string() in self._mem:
                return True
        if self.cache_dir is None:
            return False
        return os.path.exists(self._meta_path(key))

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "disk_hits": self.disk_hits,
                "misses": self.misses,
                "fallbacks": self.fallbacks,
                "not_portable": self.not_portable,
                "compile_ms_total": round(self.compile_ms_total, 3),
                "entries_mem": len(self._mem),
                "dir": self.cache_dir,
            }


# -- wiring ------------------------------------------------------------------

_CONFIGURED_DIRS: set[str] = set()
_INSTANCES: dict[str, CompileCache] = {}
_WIRING_LOCK = threading.Lock()


def configure_persistent_cache(cache_dir: str) -> str:
    """Point ``ops/_build.py``'s library directory at ``<cache_dir>/kernels``
    for the process (layer 1 of the module docstring). Idempotent for one
    directory; another directory re-points it, as the reference's config
    update does. Returns the kernel directory."""
    from distributed_eigenspaces_tpu_torch.ops import _build

    kernel_dir = os.path.abspath(os.path.join(str(cache_dir), "kernels"))
    with _WIRING_LOCK:
        if kernel_dir in _CONFIGURED_DIRS and str(_build.BUILD_DIR) == kernel_dir:
            return kernel_dir
        os.makedirs(kernel_dir, exist_ok=True)
        _build.set_build_dir(kernel_dir)
        _CONFIGURED_DIRS.add(kernel_dir)
    return kernel_dir


def compile_cache_for(cfg) -> CompileCache | None:
    """The process-wide :class:`CompileCache` for ``cfg``'s
    ``compile_cache_dir`` (program entries under ``<dir>/programs``, kernel
    libraries under ``<dir>/kernels``), or None when the knob is unset. One
    instance a directory, so the estimator, the fleet server and the query
    server of one process share counters and the memory tier."""
    cache_dir = getattr(cfg, "compile_cache_dir", None)
    if cache_dir is None:
        return None
    configure_persistent_cache(cache_dir)
    program_dir = os.path.abspath(os.path.join(str(cache_dir), "programs"))
    with _WIRING_LOCK:
        inst = _INSTANCES.get(program_dir)
        if inst is None:
            inst = CompileCache(program_dir)
            _INSTANCES[program_dir] = inst
        return inst
