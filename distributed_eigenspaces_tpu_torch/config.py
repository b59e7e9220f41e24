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

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.device import dtype_name

#: dtypes the Gram kernel and the solvers take
FLOAT_DTYPES = ("float32", "bfloat16")
#: precisions of the served projection
SERVE_DTYPES = ("float32", "bfloat16", "int8")


def _is_integer_dtype(dtype) -> bool:
    """True for an integer dtype in any spelling (a ``torch.dtype``, or
    anything ``numpy.dtype`` accepts); False for floats and for names
    numpy does not know (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)
    try:
        return bool(np.issubdtype(np.dtype(dtype), np.integer))
    except TypeError:
        return False


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
      backend: ``"auto"`` | ``"local"`` | ``"shard_map"`` (alias ``"tpu"``)
        | ``"feature_sharded"``: ``"local"`` runs the workers as a batch
        dimension on one device; ``"shard_map"`` spreads them over the
        ranks of a process group, one rank a device, gathering the factors
        each round (``parallel/mesh.py``); ``"feature_sharded"`` runs the
        rank-r and sketch trainers of ``parallel/feature_sharded.py`` on a
        ``(workers, features)`` mesh, ``d`` split over ``features`` (one
        process with no group is the ``(1, 1)`` layout); ``"auto"`` is
        ``"feature_sharded"`` at ``dim >= 4096`` (and, for a whole fit, at
        ``dim * k >= 65536``), else ``"shard_map"`` when a group of more
        than one rank is initialized, else ``"local"``.
      solver: ``"eigh"`` | ``"subspace"`` | ``"distributed"`` |
        ``"deflation"``: the local eigensolver; ``"distributed"`` runs the
        subspace machinery locally and, above ``eigh_crossover_d``, the
        factor-operator merge of ``solvers/`` (``uses_distributed_solve()``);
        ``"deflation"`` the same, with the merge on parallel-deflation lanes
        (``uses_deflation_solve()``, ``solvers/deflation.py``).
      eigh_crossover_d: the merge runs the distributed solve when ``dim``
        exceeds it (strictly).
      subspace_iters: cold power-iteration steps (and the crossover
        merge's, cold or warm).
      solver_tol: residual at which the crossover merge stops early, or
        None (always ``subspace_iters``).
      components_axis_size: the deflation merge's lane count (equal lanes,
        batched on each rank, or one lane a rank on a ``components`` mesh);
        > 1 needs ``solver="deflation"``.
      warm_start_iters: ``"auto"`` (2 under the subspace solver), an int,
        or None (every step cold).
      orth_method: ``"cholqr2"`` | ``"qr"``; warm_orth_method likewise, or
        ``"ns"`` (Newton-Schulz, warm rounds only), or None (= orth_method).
      compute_dtype: None | ``"float32"`` | ``"bfloat16"``: the cast applied
        to blocks entering the Gram / matvecs (accumulation is fp32).
      stage_dtype: None (stage in the compute dtype), a float dtype, or
        ``"int8"`` (one symmetric scale per block; requires
        ``compute_dtype="bfloat16"``).
      dtype: storage dtype of data blocks; state_dtype: ``sigma_tilde``'s.
      remainder: ``"drop"`` | ``"pad"`` | ``"error"`` batcher policy.
      mesh_shape: an explicit ``{"workers": W, "features": F}`` layout for
        the feature-sharded backend (``parallel.mesh.auto_feature_mesh``),
        or None for the default policy.
      collectives: the feature-sharded trainers' switchable reductions:
        ``"xla"`` (the process group's all-reduce and all-gather) or
        ``"ring"`` (explicit neighbour-exchange rings, ``parallel/ring.py``).
      merge_interval: the merged eigensolve runs every ``s`` steps (steps
        1, s+1, ...); the steps between fold the (masked) mean of the
        worker projectors at the same discount weight, and the warm carry
        keeps the last merged basis. ``s = 1`` is the per-step merge.
      pipeline_merge: the whole-fit scan's pipelined steady state: step
        ``t``'s warm solves start from the merge of step ``t - 2`` while
        step ``t - 1``'s merge or fold follows. Needs the subspace solver
        with warm starts; the masked fits ignore it and the segmented
        trainer refuses it (its pending factors are no checkpoint state).
      merge_topology: the hierarchical merge (``parallel/topology.py``):
        ``(tier_name, fan_in)`` pairs, leaf to root, e.g. ``(("chip", 4),
        ("host", 2))`` for 8 workers merged 4-way, then 2-way. The fan-ins
        must multiply to ``num_workers`` and each divide ``dim`` (checked
        where a trainer is built). On a tiered mesh
        (``make_tiered_mesh``) each tier merges with tier-local
        collectives; anywhere else the gathered factors merge as the same
        tree. Normalized to a tuple of pairs; None is the flat merge.
      merge_wire_dtype: the tree merge's per-tier wire precision
        (``parallel/wire.py``): tier name to ``"fp32"`` / ``"bf16"`` /
        ``"int8"`` for each tier's all-to-all and basis all-gather (sums
        stay fp32), unnamed tiers fp32, with error feedback one round
        stale. Needs ``merge_topology``; normalized to tier-ordered
        pairs. The stacked route has no collectives and ignores it.
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
      prefetch_depth: blocks the per-step loop keeps in flight ahead of the
        step (``runtime/prefetch.py``: read and copied to the device on a
        producer thread); 0 disables it. The producer reads ahead, so pass
        0 when one iterator is shared across fit calls.
      metrics_retention: ring-buffer retention of each ``MetricsLogger``
        event list; evicted entries fold into running aggregates, so
        ``summary()`` still covers the whole run.
      heartbeat_timeout_ms: the elastic-membership lease
        (``runtime/membership.py``): a worker silent this long is suspect
        (excluded from merges, still owns its slot), and dead one timeout
        later (slot joinable). Only elastic runs consult it.
      round_deadline_ms: an elastic merge round closes this long after it
        opens with whatever arrived; a late worker's rows fold into the
        next merge. None waits for every live member.
      min_quorum_frac: below this live fraction of ``num_workers`` an
        elastic round raises ``QuorumLost``; ``supervised_fit`` waits for
        quorum and resumes from the newest checkpoint.
      compile_cache_dir: must stay None in this port (ROADMAP.md).
      fleet_bucket_size, fleet_flush_s: a ``parallel.fleet.FleetServer``
        bucket dispatches when it holds this many fit requests, or when
        its oldest request has waited this long (padded with inactive
        tenants to the bucket size).
      fleet_pad_k: heterogeneous-k fleet buckets: k is padded to the next
        power of two (``parallel.fleet.padded_fleet_cfg``) so tenants whose
        k differs within one padded width share one bucket.
      fleet_slo_p99_ms: declared p99 fit-request latency of the fleet
        server, or None.
      cohort_size, max_poison_frac: the population merge
        (``parallel/clients.py``): contributions a cohort, and the declared
        Byzantine fraction, which is the merge's trim fraction.
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
    prefetch_depth: int = 2
    mesh_shape: dict[str, int] | None = None
    collectives: str = "xla"
    merge_interval: int = 1
    pipeline_merge: bool = False
    merge_topology: tuple | None = None
    merge_wire_dtype: Any = None
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
    metrics_retention: int = 4096
    compile_cache_dir: str | None = None
    heartbeat_timeout_ms: float = 1000.0
    round_deadline_ms: float | None = 250.0
    min_quorum_frac: float = 0.5
    fleet_bucket_size: int = 8
    fleet_flush_s: float = 0.1
    fleet_pad_k: bool = False
    fleet_slo_p99_ms: float | None = None
    cohort_size: int = 256
    max_poison_frac: float = 0.05

    def __post_init__(self):
        if self.discount not in ("1/T", "1/t", "notebook"):
            raise ValueError(f"unknown discount rule: {self.discount!r}")
        if self.backend not in (
            "auto", "local", "shard_map", "tpu", "feature_sharded"
        ):
            raise ValueError(f"unknown backend: {self.backend!r}")
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
        for field in ("compute_dtype", "stage_dtype", "dtype", "state_dtype"):
            val = getattr(self, field)
            if val is None:
                continue
            if field == "stage_dtype" and _is_integer_dtype(val):
                self._validate_int_stage(val)
                object.__setattr__(self, field, "int8")
                continue
            name = dtype_name(val)  # raises on junk
            if name not in FLOAT_DTYPES:
                raise ValueError(
                    f"{field} must be one of {FLOAT_DTYPES} in this port, "
                    f"got {val!r}"
                )
            object.__setattr__(self, field, name)
        if self.remainder not in ("drop", "pad", "error"):
            raise ValueError(f"unknown remainder policy: {self.remainder!r}")
        if self.collectives not in ("xla", "ring"):
            raise ValueError(f"unknown collectives mode: {self.collectives!r}")
        if not isinstance(self.merge_interval, int) or isinstance(
            self.merge_interval, bool
        ) or self.merge_interval < 1:
            raise ValueError(
                f"merge_interval must be an int >= 1, got "
                f"{self.merge_interval!r}"
            )
        if self.pipeline_merge and (
            self.solver not in ("subspace", "distributed")
            or self.resolved_warm_start() is None
        ):
            # the pipelined body overlaps step t-1's merge/fold with step
            # t's warm solves from a one-step-stale basis: without warm
            # starts there is no stale carry to solve from
            raise ValueError(
                "pipeline_merge=True requires solver='subspace' with "
                "warm starts enabled (warm_start_iters not None): the "
                "pipeline overlaps the merge with the NEXT step's "
                "warm solves from a one-step-stale basis"
            )
        self._validate_topology()
        if not (0 < self.k <= self.dim):
            raise ValueError(
                f"need 0 < k <= dim, got k={self.k}, dim={self.dim}"
            )
        self._validate_serve()
        self._validate_fleet()

    def _validate_fleet(self) -> None:
        """The reference's checks of the fleet and cohort fields."""
        if not isinstance(self.fleet_bucket_size, int) or isinstance(
            self.fleet_bucket_size, bool
        ) or self.fleet_bucket_size < 1:
            raise ValueError(
                f"fleet_bucket_size must be an int >= 1, got "
                f"{self.fleet_bucket_size!r}"
            )
        if self.fleet_flush_s < 0:
            raise ValueError(
                f"fleet_flush_s must be >= 0, got {self.fleet_flush_s}"
            )
        if not isinstance(self.fleet_pad_k, bool):
            raise ValueError(
                f"fleet_pad_k must be a bool, got {self.fleet_pad_k!r} "
                "(heterogeneous-k fleet bucketing: pad k to the next "
                "power of two so tenants with different k share one "
                "compiled program, padded lanes masked inactive)"
            )
        slo = self.fleet_slo_p99_ms
        if slo is not None and (
            not isinstance(slo, (int, float)) or isinstance(slo, bool)
            or slo <= 0
        ):
            raise ValueError(
                f"fleet_slo_p99_ms must be a positive latency in ms or "
                f"None, got {slo!r}"
            )
        if not isinstance(self.cohort_size, int) or isinstance(
            self.cohort_size, bool
        ) or self.cohort_size < 1:
            raise ValueError(
                f"cohort_size must be an int >= 1, got "
                f"{self.cohort_size!r}"
            )
        if not isinstance(self.max_poison_frac, (int, float)) or (
            isinstance(self.max_poison_frac, bool)
            or not 0.0 <= self.max_poison_frac < 0.5
        ):
            raise ValueError(
                f"max_poison_frac must be a fraction in [0, 0.5), got "
                f"{self.max_poison_frac!r} (trimming both α-tails past "
                "half the cohort leaves nothing to average)"
            )

    def _validate_topology(self) -> None:
        """The reference's checks and normal forms of ``merge_topology`` and
        ``merge_wire_dtype``."""
        if self.merge_topology is not None:
            topo = self.merge_topology
            if not isinstance(topo, (list, tuple)) or len(topo) == 0:
                raise ValueError(
                    f"merge_topology must be a non-empty sequence of "
                    f"(tier_name, fan_in) pairs or None, got {topo!r}"
                )
            tiers = []
            for entry in topo:
                if not isinstance(entry, (list, tuple)) or len(entry) != 2:
                    raise ValueError(
                        f"merge_topology entries must be (tier_name, "
                        f"fan_in) pairs, got {entry!r}"
                    )
                name, fan_in = entry
                if not isinstance(name, str) or not name:
                    raise ValueError(
                        f"merge_topology tier names must be non-empty "
                        f"strings, got {name!r}"
                    )
                if not isinstance(fan_in, int) or isinstance(
                    fan_in, bool
                ) or fan_in < 1:
                    raise ValueError(
                        f"merge_topology tier {name!r} fan_in must be an "
                        f"int >= 1, got {fan_in!r}"
                    )
                tiers.append((name, fan_in))
            names = [name for name, _ in tiers]
            if len(set(names)) != len(names):
                raise ValueError(
                    f"merge_topology tier names must be unique, got {names!r}"
                )
            # the tree replaces the flat merge core: the knobs that
            # restructure the flat merge's schedule have no tiered form
            if self.pipeline_merge:
                raise ValueError(
                    "merge_topology does not compose with "
                    "pipeline_merge=True: the pipelined body overlaps "
                    "the FLAT merge; pick one"
                )
            if self.backend == "feature_sharded":
                raise ValueError(
                    "merge_topology is not supported on the "
                    "feature_sharded backend (the tree factors the "
                    "WORKER axis; feature sharding factors d)"
                )
            object.__setattr__(self, "merge_topology", tuple(tiers))
        if self.merge_wire_dtype is None:
            return
        wd = self.merge_wire_dtype
        if isinstance(wd, dict):
            items = list(wd.items())
        elif isinstance(wd, (list, tuple)) and all(
            isinstance(e, (list, tuple)) and len(e) == 2 for e in wd
        ):
            items = [(k, v) for k, v in wd]
        else:
            raise ValueError(
                f"merge_wire_dtype must be a mapping of tier name "
                f"-> wire dtype or None, got {wd!r}"
            )
        if self.pipeline_merge:
            raise ValueError(
                "merge_wire_dtype does not compose with "
                "pipeline_merge=True: the pipelined body overlaps "
                "the FLAT merge, which has no tiers to compress"
            )
        if self.merge_topology is None:
            raise ValueError(
                "merge_wire_dtype requires merge_topology: the "
                "wire policy is per TIER, keyed by the resolved "
                "topology's tier names (flat merges have none)"
            )
        tier_names = [name for name, _ in self.merge_topology]
        for name, dtype in items:
            if not isinstance(name, str) or name not in tier_names:
                raise ValueError(
                    f"merge_wire_dtype key {name!r} names no "
                    f"merge_topology tier; tiers are {tier_names}"
                )
            if dtype not in ("fp32", "bf16", "int8"):
                raise ValueError(
                    f"merge_wire_dtype tier {name!r} has unknown "
                    f"wire dtype {dtype!r} (fp32/bf16/int8 — the "
                    "write-path codec family, error-feedback corrected)"
                )
        if len({name for name, _ in items}) != len(items):
            raise ValueError(
                f"merge_wire_dtype tier keys must be unique, got "
                f"{[name for name, _ in items]!r}"
            )
        by_name = dict(items)
        object.__setattr__(self, "merge_wire_dtype", tuple(
            (name, by_name[name]) for name in tier_names if name in by_name))

    def _validate_int_stage(self, stage) -> None:
        """The reference's checks of an integer ``stage_dtype``: int8 only,
        and only under bf16 compute (the in-loop widen path; without it the
        streaming solver would widen up front and the stage would only add
        quantization noise)."""
        if isinstance(stage, torch.dtype):
            int8 = stage == torch.int8
        else:
            int8 = np.dtype(stage) == np.int8
        if not int8:
            raise ValueError(f"integer stage_dtype must be int8, got {stage!r}")
        if self.compute_dtype != "bfloat16":
            raise ValueError(
                "stage_dtype='int8' requires compute_dtype='bfloat16' "
                "(the in-loop widen path; see BASELINE.md)"
            )

    def _validate_solver(self) -> None:
        """The reference's checks of the solver knobs."""
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
        if self.prefetch_depth < 0:
            raise ValueError(
                f"prefetch_depth must be >= 0, got {self.prefetch_depth}"
            )
        if not isinstance(self.metrics_retention, int) or isinstance(
            self.metrics_retention, bool
        ) or self.metrics_retention < 1:
            raise ValueError(
                f"metrics_retention must be an int >= 1, got "
                f"{self.metrics_retention!r}"
            )
        if not isinstance(self.heartbeat_timeout_ms, (int, float)) or (
            isinstance(self.heartbeat_timeout_ms, bool)
            or self.heartbeat_timeout_ms <= 0
        ):
            raise ValueError(
                f"heartbeat_timeout_ms must be a positive duration in "
                f"ms, got {self.heartbeat_timeout_ms!r}"
            )
        if self.round_deadline_ms is not None and (
            not isinstance(self.round_deadline_ms, (int, float))
            or isinstance(self.round_deadline_ms, bool)
            or self.round_deadline_ms <= 0
        ):
            raise ValueError(
                f"round_deadline_ms must be a positive duration in ms "
                f"or None, got {self.round_deadline_ms!r}"
            )
        if not isinstance(self.min_quorum_frac, (int, float)) or (
            isinstance(self.min_quorum_frac, bool)
            or not 0.0 < self.min_quorum_frac <= 1.0
        ):
            raise ValueError(
                f"min_quorum_frac must be a fraction in (0, 1], got "
                f"{self.min_quorum_frac!r}"
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
        if self.solver not in ("subspace", "distributed", "deflation"):
            return None
        if self.warm_start_iters == "auto":
            return 2
        return self.warm_start_iters

    def resolved_local_solver(self) -> str:
        """The solver the per-worker and dense eigensolves run:
        ``"distributed"`` and ``"deflation"`` solve locally with the
        subspace machinery."""
        if self.solver in ("distributed", "deflation"):
            return "subspace"
        return self.solver

    def uses_distributed_solve(self) -> bool:
        """True when the merge runs the distributed eigensolve
        (``solvers/``): ``solver="distributed"`` or its lane twin
        ``"deflation"``, and ``dim`` strictly above ``eigh_crossover_d``."""
        return (self.solver in ("distributed", "deflation")
                and self.dim > self.eigh_crossover_d)

    def uses_deflation_solve(self) -> bool:
        """True when that merge runs the parallel-deflation lanes
        (``solvers/deflation.py``, ``components_axis_size`` of them) instead
        of the single-block distributed iteration: ``solver="deflation"``
        above the crossover."""
        return self.solver == "deflation" and self.dim > self.eigh_crossover_d

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
