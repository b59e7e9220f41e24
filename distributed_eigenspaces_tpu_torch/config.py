"""``PCAConfig`` for the port: the fields the online-PCA fit reads.

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
      solver: ``"eigh"`` | ``"subspace"`` local eigensolver.
      subspace_iters: cold power-iteration steps.
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
    """

    dim: int
    k: int
    num_workers: int = 8
    rows_per_worker: int = 128
    num_steps: int = 10
    discount: str = "1/T"
    backend: str = "auto"
    solver: str = "eigh"
    subspace_iters: int = 16
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
        if self.solver == "distributed":
            raise _not_ported(
                "solver='distributed'", "Queue 1 item 12 (solvers/distributed.py)"
            )
        if self.solver == "deflation":
            raise _not_ported(
                "solver='deflation'", "Queue 1 item 13 (solvers/deflation.py)"
            )
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

    def resolved_warm_start(self) -> int | None:
        """Warm-start iteration count, or None for all-cold steps:
        ``"auto"`` is 2 under the subspace solver; eigh never warms."""
        if self.solver != "subspace":
            return None
        if self.warm_start_iters == "auto":
            return 2
        return self.warm_start_iters

    def resolved_local_solver(self) -> str:
        """The solver the per-worker and dense eigensolves run."""
        return self.solver

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
