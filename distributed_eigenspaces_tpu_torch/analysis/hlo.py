"""The collective byte model and its scaling projection: the ``ici_model``
block of an eval report.

The port's copy of ``ici_step_model`` and ``scaling_projection`` from
``distributed_eigenspaces_tpu/analysis/hlo.py`` (the rest of that module
parses compiled XLA HLO, which the port has none of: it records its
collectives as they run, ``parallel.mesh.recording_collectives``). The
integers are the reference's; the assumed link rate is the H100 SXM's
NVLink instead of a TPU interconnect link.
"""

from __future__ import annotations

#: one H100 SXM's NVLink rate each way (900 GB/s to the other cards of the
#: host, all to all: 450 GB/s in each direction)
NVLINK_GB_PER_SEC = 450.0


def ici_step_model(
    m: int, d: int, k: int, *,
    n_workers_mesh: int, n_feature_shards: int = 1, itemsize: int = 4,
) -> dict:
    """Documented per-step ICI byte model for the sharded trainers,
    ring-collective accounting (what XLA lowers to on a torus):

    - factor merge: ``all_gather`` of per-device ``(m/W, d_l, k)`` shards
      into ``(m, d_l, k)`` on each of W worker-mesh devices — each
      device moves ``(W-1)/W * m * d_l * k`` elements per step
      (``d_l = d / n_feature_shards``);
    - the dense alternative this design replaces: ``psum`` of a
      ``d x d`` projector — ``2 * (W-1)/W * d^2`` elements per device;
    - feature-axis reductions (sharded matvec / CholeskyQR Grams /
      sketch folds): k-wide payloads, O(n·k + k^2) elements — reported
      as a bound, not enumerated (each is <= the merge payload by
      construction; the audit asserts the ceiling).

    Returns modeled bytes/device/step for the factor route, the dense
    route, and their ratio — the number BASELINE.md's "16x less ICI
    traffic" claim quotes, now computed instead of asserted in prose.
    """
    w = max(n_workers_mesh, 1)
    d_local = d // max(n_feature_shards, 1)
    ring = (w - 1) / w if w > 1 else 0.0
    factor = ring * m * d_local * k * itemsize
    dense = 2.0 * ring * d * d * itemsize
    return {
        "factor_gather_bytes_per_step": int(factor),
        "dense_psum_bytes_per_step": int(dense),
        # None (not inf) when the worker axis is trivial — a 1-chip mesh
        # moves nothing, and inf is not valid strict JSON
        "dense_over_factor": (
            round(dense / factor, 2) if factor else None
        ),
        "model": "ring collectives: all_gather (W-1)/W*payload, "
                 "psum 2*(W-1)/W*payload, per device per step",
    }


def scaling_projection(
    m: int, d: int, k: int, *, step_seconds: float,
    n_workers_mesh: int, n_feature_shards: int = 1,
    ici_gbps: float = NVLINK_GB_PER_SEC,
) -> dict:
    """Collective-bytes-per-step vs step-time projection: at what mesh size
    does the merge's collective stop hiding behind the step's compute?
    ``ici_gbps`` defaults to :data:`NVLINK_GB_PER_SEC`, one H100 SXM's
    NVLink rate each way; the point of the field is the RATIO trend, not
    the last percent — both inputs are in the JSON so readers can
    re-anchor. The keys keep the reference's names (``ici`` there is the
    TPU's interconnect; here it is NVLink)."""
    model = ici_step_model(
        m, d, k,
        n_workers_mesh=n_workers_mesh,
        n_feature_shards=n_feature_shards,
    )
    wire_s = model["factor_gather_bytes_per_step"] / (ici_gbps * 1e9)
    return {
        **model,
        "assumed_ici_gb_per_sec": ici_gbps,
        "modeled_collective_seconds_per_step": round(wire_s, 9),
        "measured_step_seconds": round(step_seconds, 9),
        "collective_fraction_of_step": (
            round(wire_s / step_seconds, 6) if step_seconds > 0 else None
        ),
    }
