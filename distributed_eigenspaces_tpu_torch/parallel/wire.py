"""Wire formats for the merge's data-moving collectives.

Counterpart of ``distributed_eigenspaces_tpu/parallel/wire.py``. Every
merge-time payload that moves data (the tier all-to-all factor splits and
``(d, k)`` basis all-gathers of the tree merge, the worker factor-stack
gathers of the distributed and deflation solves) can ship bf16 or
per-column symmetric int8, while every Gram and sum stays fp32:

1. **Payloads only.** A codec wraps one all-to-all or all-gather: encode
   just before it, decode just after. Sums (``psum``) are never narrowed:
   int8 has no closed addition and a bf16 sum loses the fp32 accumulator.
2. **Per-tier policy.** ``cfg.merge_wire_dtype`` maps topology tier names
   to ``fp32`` / ``bf16`` / ``int8``; an unnamed tier is fp32, and None
   runs the uncompressed programs.
3. **Error feedback, one step stale.** A round's rounding residual is
   folded into the next round's payload before it is encoded
   (:func:`error_feedback`), so quantization error does not build up over
   the online loop.

The int8 codec is the read path's ``ops.serve_project.quantize_basis_i8``
(bit-equal to the reference's), once per slot of a ``(g, rows, k)``
stack; each sender's fp32 ``(1, k)`` scale rides beside its payload as a
sidecar. Eager torch casts where the code says, so the reference's
optimization barriers have no counterpart: ``parallel.mesh.
recording_collectives`` shows the dtype each collective was handed.
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.ops.serve_project import quantize_basis_i8
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

__all__ = [
    "WIRE_DTYPES",
    "WIRE_ITEMSIZE",
    "error_feedback",
    "normalize_wire_policy",
    "procrustes_rotation",
    "resolve_wire_policy",
    "root_wire_dtype",
    "tier_wire_records",
    "wire_all_gather",
    "wire_all_to_all",
    "wire_roundtrip",
]

#: the codecs, by the names ``cfg.merge_wire_dtype`` takes
WIRE_DTYPES = ("fp32", "bf16", "int8")

#: bytes per element each codec puts on the wire (the int8 scale sidecar
#: is counted apart)
WIRE_ITEMSIZE = {"fp32": 4, "bf16": 2, "int8": 1}

#: the tag :func:`wire_all_gather` / :func:`wire_all_to_all` give an int8
#: payload's scale sidecar in ``parallel.mesh.recording_collectives``
SCALE_TAG = "int8_scale"


def _check_dtype(dtype: str) -> None:
    if dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {dtype!r}; one of {WIRE_DTYPES}")


# -- policy ---------------------------------------------------------------------


def normalize_wire_policy(policy) -> dict[str, str]:
    """``merge_wire_dtype`` in any accepted spelling (a dict, or ``(tier,
    dtype)`` pairs, the config's normal form) as a plain dict."""
    if isinstance(policy, dict):
        return {str(k): str(v) for k, v in policy.items()}
    return {str(k): str(v) for k, v in policy}


def resolve_wire_policy(cfg, topo) -> tuple[str, ...] | None:
    """``cfg.merge_wire_dtype`` as a per-tier dtype tuple aligned with
    ``topo.tiers`` (leaf to root), or None for the uncompressed programs.
    A key that names no tier of ``topo`` is refused: a policy ignored in
    silence is a compression that never happens."""
    policy = getattr(cfg, "merge_wire_dtype", None)
    if policy is None or topo is None:
        return None
    policy = normalize_wire_policy(policy)
    unknown = set(policy) - set(topo.names)
    if unknown:
        raise ValueError(
            f"merge_wire_dtype keys {sorted(unknown)} name no resolved "
            f"topology tier; tiers are {list(topo.names)}"
        )
    bad = {k: v for k, v in policy.items() if v not in WIRE_DTYPES}
    if bad:
        raise ValueError(f"merge_wire_dtype values {bad} not in {WIRE_DTYPES}")
    return tuple(policy.get(name, "fp32") for name in topo.names)


def root_wire_dtype(cfg, topo) -> str:
    """The root tier's wire dtype: what one flat gather across every tier
    at once (the population cohort gather) inherits."""
    wire = resolve_wire_policy(cfg, topo)
    return "fp32" if wire is None else wire[-1]


# -- codecs ---------------------------------------------------------------------


def _quantize_i8(x: torch.Tensor):
    """Per-column symmetric int8 of a ``(rows, k)`` panel, or of each slot
    of a ``(g, rows, k)`` stack (one ``(1, k)`` scale a slot, so each
    sender's scale travels with its payload)."""
    if x.dim() == 2:
        return quantize_basis_i8(x)
    pairs = [quantize_basis_i8(slot) for slot in x]
    return torch.stack([q for q, _ in pairs]), torch.stack([s for _, s in pairs])


def procrustes_rotation(m: torch.Tensor) -> torch.Tensor:
    """The orthogonal ``(k, k)`` rotation ``R`` maximizing ``tr(R^T m)``
    (reflections allowed): the Procrustes alignment of a basis ``x`` onto
    a reference, ``m = x^T ref``. The delta codec aligns each payload to its
    carry before encoding, so eigensolver rotations and sign flips within
    the subspace never inflate the delta. The ``1e-6 I`` bias pins ``R =
    I`` exactly when the reference is all zero (round 0's carry)."""
    k = m.shape[-1]
    m = m + 1e-6 * torch.eye(k, dtype=m.dtype, device=m.device)
    u, _, vt = torch.linalg.svd(m)
    return torch.matmul(u, vt)


def wire_roundtrip(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """Encode and decode without moving anything: the value the receivers
    reconstruct. The error-feedback residual is ``x - roundtrip``."""
    _check_dtype(dtype)
    if dtype == "fp32":
        return x
    if dtype == "bf16":
        return x.to(torch.bfloat16).float()
    q, s = _quantize_i8(x)
    return q.float() * s


def error_feedback(x: torch.Tensor, residual, dtype: str):
    """Fold the previous round's rounding residual into this round's
    payload: ``(x_adjusted, new_residual)``. fp32 is exact: the residual
    is returned as it came and the payload untouched."""
    _check_dtype(dtype)
    if dtype == "fp32":
        return x, residual
    x = x + residual
    return x, x - wire_roundtrip(x, dtype)


def wire_all_gather(x: torch.Tensor, axis_name: str, dtype: str, *,
                    tiled: bool = True) -> torch.Tensor:
    """``parallel.mesh.all_gather`` over ``axis_name`` with the payload in
    the wire dtype, the result fp32. ``x`` is a ``(rows, k)`` panel or a
    ``(m_local, rows, k)`` stack, gathered on axis 0, tiled or stacked."""
    _check_dtype(dtype)
    if dtype == "fp32":
        return pmesh.all_gather(x, axis_name, tiled=tiled)
    if dtype == "bf16":
        return pmesh.all_gather(x.to(torch.bfloat16), axis_name, tiled=tiled).float()
    q, s = _quantize_i8(x)
    qg = pmesh.all_gather(q, axis_name, tiled=tiled).float()
    if not tiled:
        # qg (g, *x.shape); the scale (1, k) or (m_local, 1, k) stacks alike
        return qg * pmesh.all_gather(s, axis_name, tiled=False, tag=SCALE_TAG)
    if x.dim() == 2:
        # qg (g rows, k): regroup by sender to apply each sender's scale
        sg = pmesh.all_gather(s, axis_name, tiled=False, tag=SCALE_TAG)  # (g, 1, k)
        return (qg.reshape(sg.shape[0], x.shape[0], -1) * sg).reshape(qg.shape)
    # x (m_local, rows, k): the (m_local, 1, k) scales concatenate alike
    return qg * pmesh.all_gather(s, axis_name, tiled=True, tag=SCALE_TAG)


def wire_all_to_all(c: torch.Tensor, axis_name: str, dtype: str) -> torch.Tensor:
    """``parallel.mesh.all_to_all`` of ``c (g, rows, k)`` with the payload
    in the wire dtype, the result fp32: slot ``i`` is peer ``i``'s block,
    decoded with peer ``i``'s scale (the ``(g, 1, k)`` sidecar rides its own
    small all-to-all)."""
    _check_dtype(dtype)
    if dtype == "fp32":
        return pmesh.all_to_all(c, axis_name)
    if dtype == "bf16":
        return pmesh.all_to_all(c.to(torch.bfloat16), axis_name).float()
    q, s = _quantize_i8(c)  # q (g, rows, k), s (g, 1, k)
    qx = pmesh.all_to_all(q, axis_name)
    sx = pmesh.all_to_all(s, axis_name, tag=SCALE_TAG)
    return qx.float() * sx


# -- telemetry ------------------------------------------------------------------


def tier_wire_records(topo, wire, d: int, kf: int, *, residual_norms=None) -> list[dict]:
    """Per-tier ``{"kind": "wire", ...}`` records of one round under an
    active policy: the bytes a rank puts on the wire for the tier's two
    data movers (``2 (f - 1) / f d kf`` elements; the int8 scale sidecars
    added as an estimate, ``(f - 1) / f (f + 1) kf`` fp32 values), the fp32
    program's bytes, their ratio, and the error-feedback residual norm
    where the caller measured one."""
    records = []
    norms = residual_norms or {}
    for (name, fan), dtype in zip(topo.tiers, wire):
        ring = (fan - 1) / fan if fan > 1 else 0.0
        fp32_bytes = 2 * ring * d * kf * WIRE_ITEMSIZE["fp32"]
        bytes_wire = 2 * ring * d * kf * WIRE_ITEMSIZE[dtype]
        if dtype == "int8":
            bytes_wire += ring * (fan + 1) * kf * 4  # scale sidecars
        rec = {
            "kind": "wire",
            "tier": name,
            "wire_dtype": dtype,
            "payload_bytes": int(round(bytes_wire)),
            "fp32_bytes": int(round(fp32_bytes)),
            "compression_ratio": round(fp32_bytes / max(bytes_wire, 1e-9), 3),
        }
        if name in norms:
            rec["ef_residual_norm"] = float(norms[name])
        records.append(rec)
    return records
