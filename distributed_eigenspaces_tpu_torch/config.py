"""``PCAConfig`` for the port: the fields the online-PCA fit and the read
path (registry, query server, transform engine) read.

Counterpart of ``distributed_eigenspaces_tpu/config.py``. Field names,
defaults and the ``ValueError`` validation follow the reference for every
field carried here. Settings that select code this port does not have yet
raise ``NotImplementedError`` naming the ROADMAP.md item that will add
them, instead of running something else under their name.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from distributed_eigenspaces_tpu_torch.device import dtype_name

#: dtypes the Gram kernel and the solvers take
FLOAT_DTYPES = ("float32", "bfloat16")
#: precisions of the served projection
SERVE_DTYPES = ("float32", "bfloat16", "int8")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to distributed_eigenspaces_tpu_torch yet "
        f"(ROADMAP.md {item})"
    )


@dataclasses.dataclass(frozen=True)
class PCAConfig:
    """Configuration for online distributed PCA.

    Attributes (as in the reference's ``PCAConfig``):
      dim, k: feature dimension d and subspace rank.
      num_workers, rows_per_worker, num_steps: m, n and T.
      discount: ``"1/T"`` | ``"1/t"`` | ``"notebook"`` (bug-compatible).
      backend: ``"auto"`` | ``"local"`` (both run the workers as a batch
        dimension on one device).
      solver: ``"eigh"`` | ``"subspace"`` | ``"distributed"``: the local
        eigensolver; ``"distributed"`` runs the subspace machinery locally
        and, above ``eigh_crossover_d``, the factor-operator merge of
        ``solvers/`` (``uses_distributed_solve()``).
      eigh_crossover_d: the merge runs the distributed solve when ``dim``
        exceeds it (strictly).
      subspace_iters: cold power-iteration steps (and the crossover
        merge's, cold or warm).
      solver_tol: residual at which the crossover merge stops early, or
        None (always ``subspace_iters``).
      components_axis_size: deflation lanes; must stay 1 in this port.
      warm_start_iters: ``"auto"`` (2 under the subspace solver), an int,
        or None (every step cold).
      orth_method: ``"cholqr2"`` | ``"qr"``; warm_orth_method likewise or
        None (= orth_method).
      compute_dtype: None | ``"float32"`` | ``"bfloat16"``: the cast applied
        to blocks entering the Gram / matvecs (accumulation is fp32).
      stage_dtype: None (stage in the compute dtype) or a float dtype.
      dtype: storage dtype of data blocks; state_dtype: ``sigma_tilde``'s.
      remainder: ``"drop"`` | ``"pad"`` | ``"error"`` batcher policy.
      merge_interval, pipeline_merge, merge_topology: must stay at their
        defaults in this port (see ROADMAP.md).
      seed: seed of the ``torch.Generator`` that draws the cold start
        basis (the reference draws it from ``jax.random.PRNGKey(0)``).
      serve_bucket_size, serve_flush_s: a query micro-batch dispatches
        when it holds this many queries, or when its oldest query has
        waited this long.
      serve_continuous: continuous batching (requests join the next
        in-flight batch) instead of deadline micro-batches.
      serve_dtype: ``"float32"`` | ``"bfloat16"`` | ``"int8"``: the serve
        projection's precision (the quantized ones run the serve kernels,
        angle-gated against fp32 at server construction).
      serve_keep_versions: how many basis versions the registry retains.
      registry_dir: durable root of the eigenbasis registry, or None.
      serve_queue_depth, serve_breaker_threshold: bounded admission and
        the per-signature circuit breaker (None = off).
      serve_slo_p99_ms: declared p99 request latency; with a queue depth
        set, requests already past it are shed before compute.
      compile_cache_dir: must stay None in this port (ROADMAP.md).
    """

    dim: int
    k: int
    num_workers: int = 8
    rows_per_worker: int = 128
    num_steps: int = 10
    discount: str = "1/T"
    backend: str = "auto"
    solver: str = "eigh"
    eigh_crossover_d: int = 4096
    subspace_iters: int = 16
    solver_tol: float | None = None
    components_axis_size: int = 1
    warm_start_iters: int | None | str = "auto"
    orth_method: str = "cholqr2"
    warm_orth_method: str | None = None
    compute_dtype: Any = None
    stage_dtype: Any = None
    dtype: Any = "float32"
    state_dtype: Any = "float32"
    remainder: str = "drop"
    merge_interval: int = 1
    pipeline_merge: bool = False
    merge_topology: tuple | None = None
    seed: int = 0
    serve_bucket_size: int = 8
    serve_flush_s: float = 0.02
    serve_continuous: bool = False
    serve_dtype: str = "float32"
    serve_keep_versions: int = 4
    registry_dir: str | None = None
    serve_queue_depth: int | None = None
    serve_breaker_threshold: int | None = None
    serve_slo_p99_ms: float | None = None
    compile_cache_dir: str | None = None

    def __post_init__(self):
        if self.discount not in ("1/T", "1/t", "notebook"):
            raise ValueError(f"unknown discount rule: {self.discount!r}")
        if self.backend not in (
            "auto", "local", "shard_map", "tpu", "feature_sharded"
        ):
            raise ValueError(f"unknown backend: {self.backend!r}")
        if self.backend not in ("auto", "local"):
            raise _not_ported(
                f"backend={self.backend!r}",
                "Queue 1 item 14 (multi-device on torch.distributed)",
            )
        if self.solver not in ("eigh", "subspace", "distributed",
                               "deflation"):
            raise ValueError(f"unknown solver: {self.solver!r}")
        self._validate_solver()
        if isinstance(self.warm_start_iters, str):
            if self.warm_start_iters != "auto":
                raise ValueError(
                    f"warm_start_iters must be an int >= 1, None, or "
                    f"'auto', got {self.warm_start_iters!r}"
                )
        elif self.warm_start_iters is not None and self.warm_start_iters < 1:
            raise ValueError(
                f"warm_start_iters must be >= 1, None, or 'auto', got "
                f"{self.warm_start_iters}"
            )
        if self.orth_method not in ("qr", "cholqr2"):
            raise ValueError(
                f"unknown orth_method: {self.orth_method!r} (qr/cholqr2; "
                "'ns' is warm_orth_method-only)"
            )
        if self.warm_orth_method not in (None, "qr", "cholqr2", "ns"):
            raise ValueError(
                f"unknown warm_orth_method: {self.warm_orth_method!r}"
            )
        if self.warm_orth_method == "ns":
            raise _not_ported(
                "warm_orth_method='ns'", "Queue 1 item 9b (ns_orth)"
            )
        for field in ("compute_dtype", "stage_dtype", "dtype", "state_dtype"):
            val = getattr(self, field)
            if val is None:
                continue
            name = dtype_name(val)  # raises on junk
            if name == "int8" and field == "stage_dtype":
                raise _not_ported(
                    "stage_dtype='int8'",
                    "Queue 1 item 9a (int8 staging and its int8 Gram route)",
                )
            if name not in FLOAT_DTYPES:
                raise ValueError(
                    f"{field} must be one of {FLOAT_DTYPES} in this port, "
                    f"got {val!r}"
                )
            object.__setattr__(self, field, name)
        if self.remainder not in ("drop", "pad", "error"):
            raise ValueError(f"unknown remainder policy: {self.remainder!r}")
        if not isinstance(self.merge_interval, int) or isinstance(
            self.merge_interval, bool
        ) or self.merge_interval < 1:
            raise ValueError(
                f"merge_interval must be an int >= 1, got "
                f"{self.merge_interval!r}"
            )
        if self.merge_interval > 1:
            raise _not_ported(
                "merge_interval > 1", "Queue 1 item 9d (merge_interval)"
            )
        if self.pipeline_merge:
            raise _not_ported(
                "pipeline_merge=True", "Queue 1 item 9d (pipeline_merge)"
            )
        if self.merge_topology is not None:
            raise _not_ported(
                "merge_topology", "Queue 1 item 15 (parallel/topology.py)"
            )
        if not (0 < self.k <= self.dim):
            raise ValueError(
                f"need 0 < k <= dim, got k={self.k}, dim={self.dim}"
            )
        self._validate_serve()

    def _validate_solver(self) -> None:
        """The reference's checks of the solver knobs, then the refusal of
        the parallel-deflation solve."""
        tol = self.solver_tol
        if tol is not None and (
            not isinstance(tol, (int, float)) or isinstance(tol, bool)
            or not 0.0 < tol < 1.0
        ):
            raise ValueError(
                f"solver_tol must be a residual tolerance in (0, 1) or None, "
                f"got {tol!r}"
            )
        lanes = self.components_axis_size
        if not isinstance(lanes, int) or isinstance(lanes, bool) or lanes < 1:
            raise ValueError(
                f"components_axis_size must be an int >= 1, got {lanes!r}"
            )
        if lanes > 1:
            if self.solver != "deflation":
                raise ValueError(
                    f"components_axis_size={lanes} requires solver='deflation' "
                    f"(got {self.solver!r})"
                )
            if lanes > self.k:
                raise ValueError(
                    f"components_axis_size={lanes} exceeds k={self.k}"
                )
            if self.k % lanes:
                raise ValueError(
                    f"k={self.k} must divide evenly into "
                    f"components_axis_size={lanes} lanes"
                )
        cross = self.eigh_crossover_d
        if not isinstance(cross, int) or isinstance(cross, bool) or cross < 1:
            raise ValueError(
                f"eigh_crossover_d must be an int >= 1, got {cross!r}"
            )
        if self.solver == "deflation":
            raise _not_ported(
                "solver='deflation' (and components_axis_size > 1)",
                "Queue 1 item 13 (solvers/deflation.py)",
            )

    def _validate_serve(self) -> None:
        """The reference's read-path checks, field for field."""
        if not isinstance(self.serve_bucket_size, int) or isinstance(
            self.serve_bucket_size, bool
        ) or self.serve_bucket_size < 1:
            raise ValueError(
                f"serve_bucket_size must be an int >= 1, got "
                f"{self.serve_bucket_size!r}"
            )
        if self.serve_flush_s < 0:
            raise ValueError(
                f"serve_flush_s must be >= 0, got {self.serve_flush_s}"
            )
        if not isinstance(self.serve_continuous, bool):
            raise ValueError(
                f"serve_continuous must be a bool, got "
                f"{self.serve_continuous!r}"
            )
        if self.serve_dtype not in SERVE_DTYPES:
            raise ValueError(
                f"unknown serve_dtype: {self.serve_dtype!r} "
                "(float32/bfloat16/int8 — the serve-kernel precision "
                "family, angle-gated vs fp32)"
            )
        if not isinstance(self.serve_keep_versions, int) or isinstance(
            self.serve_keep_versions, bool
        ) or self.serve_keep_versions < 1:
            raise ValueError(
                f"serve_keep_versions must be an int >= 1, got "
                f"{self.serve_keep_versions!r}"
            )
        if self.registry_dir is not None and not isinstance(
            self.registry_dir, str
        ):
            raise ValueError(
                f"registry_dir must be a path string or None, got "
                f"{self.registry_dir!r}"
            )
        for depth_field in ("serve_queue_depth", "serve_breaker_threshold"):
            val = getattr(self, depth_field)
            if val is not None and (
                not isinstance(val, int) or isinstance(val, bool)
                or val < 1
            ):
                raise ValueError(
                    f"{depth_field} must be an int >= 1 or None, got "
                    f"{val!r}"
                )
        slo = self.serve_slo_p99_ms
        if slo is not None and (
            not isinstance(slo, (int, float)) or isinstance(slo, bool)
            or slo <= 0
        ):
            raise ValueError(
                f"serve_slo_p99_ms must be a positive latency in ms or "
                f"None, got {slo!r}"
            )
        if self.compile_cache_dir is not None:
            if not isinstance(self.compile_cache_dir, str):
                raise ValueError(
                    f"compile_cache_dir must be a path string or None, "
                    f"got {self.compile_cache_dir!r}"
                )
            raise _not_ported(
                "compile_cache_dir (the persistent compile cache)",
                "Queue 1 item 16 (utils/compile_cache.py)",
            )

    def resolved_warm_start(self) -> int | None:
        """Warm-start iteration count, or None for all-cold steps:
        ``"auto"`` is 2 under the subspace-family solvers; eigh never
        warms."""
        if self.solver not in ("subspace", "distributed"):
            return None
        if self.warm_start_iters == "auto":
            return 2
        return self.warm_start_iters

    def resolved_local_solver(self) -> str:
        """The solver the per-worker and dense eigensolves run:
        ``"distributed"`` solves locally with the subspace machinery."""
        if self.solver == "distributed":
            return "subspace"
        return self.solver

    def uses_distributed_solve(self) -> bool:
        """True when the merge runs the distributed eigensolve
        (``solvers/``): ``solver="distributed"`` and ``dim`` strictly above
        ``eigh_crossover_d``."""
        return self.solver == "distributed" and self.dim > self.eigh_crossover_d

    def resolved_warm_orth(self) -> str:
        """Orthonormalization for warm solver rounds."""
        return (
            self.orth_method if self.warm_orth_method is None
            else self.warm_orth_method
        )

    def resolved_stage_dtype(self) -> str:
        """dtype the whole-fit trainer stages blocks in: ``stage_dtype``,
        else the compute dtype, else the storage dtype."""
        if self.stage_dtype is not None:
            return self.stage_dtype
        return self.compute_dtype if self.compute_dtype is not None else self.dtype
