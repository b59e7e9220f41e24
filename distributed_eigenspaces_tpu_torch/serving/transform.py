"""Query projections against an operand basis, with rows padded to buckets.

Counterpart of ``distributed_eigenspaces_tpu/serving/transform.py``. Two
disciplines of the reference carry over:

1. **The basis is an argument.** Every operation is ``f(x, v)``, so
   publishing a new version changes an operand, never the code that runs:
   a hot swap costs one host-to-device copy of the basis.
2. **Rows pad to shape buckets.** :func:`bucket_rows` pads a batch to the
   next power of two (floored at ``min_bucket``). The engine keeps the
   reference's acquisition counters: ``compile_misses`` counts the first
   dispatch of each ``(kind, padded_rows)`` pair, ``cache_hits`` every
   later one, ``compile_ms_total`` the time the misses took (for the
   quantized kinds on the card, the first one builds the serve kernels),
   so a test can assert that a swap acquired nothing.

Routes of :meth:`TransformEngine.project` by ``serve_dtype``:
``"float32"`` is ``ops.serve_project.project_exact``, the route
``OnlineDistributedPCA.transform`` takes too: on a CUDA tensor the
port's fixed-order fp32 kernel (the JAX package runs fp32 outside any
Pallas kernel, at ``Precision.HIGHEST``; the port never enables TF32), on
a CPU one ``torch.matmul``. ``"bfloat16"`` and ``"int8"`` go to the
serve kernels' ``*_auto`` functions, which launch the hand-written kernels
on a CUDA tensor and take the plain versions on a CPU one. Zero-padded
rows leave every real row's bits unchanged in all three kernels (each
row's sum order is fixed), so a served fp32 row equals the direct
projection bit for bit, as the reference's contract says.

On a mesh of ranks (``parallel/mesh.py``) each rank runs its own engine,
SPMD:

- ``mesh=`` alone: each rank projects the rows it is given (its share of
  the traffic) against the whole basis, as the one-device engine does on
  the mesh's device. Zero collectives.
- ``basis_spec=("features", None)``: the basis stays row-sharded over
  ``features``. Each rank keeps its ``d / f`` columns of every query and
  its rows of the basis, ``project`` runs the serve kernel on that shard
  (an int8 basis quantized and scaled per shard, so the dequantization
  comes before the reduce) and sums the fp32 partials with ONE psum over
  ``features``; ``reconstruct`` is row-local onto the shards (this rank's
  columns, no collective); ``residual_energy`` sums the input energy over
  ``features``. Every sharded reduction is one call of
  ``TransformEngine._shard_sums``: the partial projection and the partial
  input energy in one ``(rows, k + 1)`` fp32 psum. Every rank of a
  features group must make the same calls in the same order
  (``QueryServer`` agrees on each batch first). The dense ``(d, k)`` basis
  never lands on one rank.

Not ported yet: the persistent compile cache (ROADMAP.md Queue 1 item 16).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.config import SERVE_DTYPES, _not_ported
from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype
from distributed_eigenspaces_tpu_torch.ops import _build
from distributed_eigenspaces_tpu_torch.ops.serve_project import (
    project_exact,
    quantize_basis_i8,
    serve_project_auto,
    serve_project_i8_auto,
)
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel.mesh import FEATURE_AXIS

__all__ = ["TransformEngine", "bucket_rows"]


def bucket_rows(n: int, *, min_bucket: int = 8) -> int:
    """Padded row count for an ``n``-row batch: next power of two,
    floored at ``min_bucket``."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    return max(min_bucket, 1 << (n - 1).bit_length())


def _as_tensor(a) -> torch.Tensor:
    """``a`` as a tensor without a host copy, except of a read-only numpy
    array (which torch would otherwise share and warn about)."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a)


def _reconstruct(z, v):
    return torch.matmul(z, v.T.to(z.dtype))


def _residual(x, z):
    # per-row residual energy ||x||^2 - ||xV||^2 (>= 0 for an orthonormal
    # V up to rounding; clamped so drift scores never go negative on noise)
    e_in = torch.sum(x.float() ** 2, dim=-1)
    e_out = torch.sum(z.float() ** 2, dim=-1)
    return torch.clamp_min(e_in - e_out, 0.0), e_in


class TransformEngine:
    """Projection / reconstruction / residual operations for one ``(d, k)``
    signature on one device (``"cuda"`` unless the caller asks for
    another; on a ``mesh``, the mesh's device). The basis is an operand of
    every call; the acquisition counters (module docstring) make a swap's
    cost checkable, and ``psums`` counts the reductions a sharded engine
    ran."""

    def __init__(self, d: int, k: int, *, dtype="float32", mesh=None,
                 min_bucket: int = 8, cache=None, basis_spec=None,
                 serve_dtype: str = "float32", device="cuda"):
        if not (0 < k <= d):
            raise ValueError(f"need 0 < k <= d, got k={k}, d={d}")
        if serve_dtype not in SERVE_DTYPES:
            raise ValueError(
                f"unknown serve_dtype: {serve_dtype!r} "
                "(float32/bfloat16/int8)"
            )
        self.mesh = mesh
        self.basis_spec = None if basis_spec is None else tuple(basis_spec)
        if self.basis_spec is not None:
            if mesh is None or FEATURE_AXIS not in mesh.shape:
                raise ValueError(
                    "basis_spec needs a (workers, features) mesh — the "
                    "basis rows shard over the features axis "
                    f"(got mesh={mesh})"
                )
            if self.basis_spec != (FEATURE_AXIS, None):
                raise ValueError(
                    "the serving tier shards bases by rows over the "
                    f"features axis: basis_spec must be "
                    f"({FEATURE_AXIS!r}, None), got {self.basis_spec}"
                )
            nf = int(mesh.shape[FEATURE_AXIS])
            if d % nf:
                raise ValueError(f"d={d} does not divide over {nf} feature shards")
        if cache is not None:
            raise _not_ported(
                "TransformEngine(cache=) (the persistent compile cache)",
                "Queue 1 item 16 (utils/compile_cache.py)",
            )
        self.d = int(d)
        self.k = int(k)
        self.serve_dtype = serve_dtype
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.min_bucket = min_bucket
        #: this rank's feature columns (the whole of d unless sharded)
        self._cols = (
            pmesh.feature_rows(mesh, self.d) if self.basis_spec is not None
            else slice(0, self.d)
        )
        self.d_local = self._cols.stop - self._cols.start
        #: reductions over ``features`` this engine ran (sharded mode)
        self.psums = 0
        self._cache: dict = {}
        self.compile_misses = 0
        self.cache_hits = 0
        self.compile_ms_total = 0.0
        #: optional ``utils.telemetry.Tracer``: acquisitions land as
        #: ``engine_compile`` spans, and a ``QueryServer`` over this engine
        #: records its request spans there too
        self.tracer = None
        project = (
            project_exact if serve_dtype == "float32" else self._project_quant
        )
        self._fns = {
            "project": project,
            "reconstruct": _reconstruct,
            "residual": _residual,
        }

    def _project_quant(self, x, v):
        if self.serve_dtype == "int8":
            # per call, as the reference quantizes in-program: the fp32
            # basis stays the operand, so a swap re-quantizes, never rebuilds
            q, s = quantize_basis_i8(v)
            return serve_project_i8_auto(x, q, s)
        return serve_project_auto(x, v)

    # -- acquisition ---------------------------------------------------------

    def _compiled(self, kind: str, rows: int):
        key = (kind, rows)
        hit = self._cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            return hit
        self.compile_misses += 1
        t0 = time.perf_counter()
        if kind == "project" and self.device.type == "cuda":
            _build.load("serve_project")  # built once, at the first dispatch
        fn = self._fns[kind]
        t1 = time.perf_counter()
        self.compile_ms_total += (t1 - t0) * 1e3
        if self.tracer is not None:
            self.tracer.record_span(
                "engine_compile", t0, t1, category="compile",
                attrs={"op": kind, "rows": rows,
                       "signature": f"({self.d}, {self.k})"},
            )
        self._cache[key] = fn
        return fn

    def self_check(
        self,
        v=None,
        *,
        budget_deg: float = 0.2,
        rows: int = 64,
        seed: int = 0,
    ) -> float:
        """Startup gate: project a seeded query batch through this engine
        and compare it with the direct fp32 projection of the same operands
        (``project_exact``, the estimator's ``transform`` route; sharded,
        each shard's direct projection summed over ``features``, so every
        rank of the group must run the check together).
        ``serve_dtype='float32'`` must be bit-exact; the quantized routes
        must keep every row's projection within ``budget_deg`` degrees.
        Raises ``ValueError`` on a breach; returns the worst angle in
        degrees. ``v=None`` checks a seeded random orthonormal basis.

        Probe rows carry dominant in-subspace energy plus moderate
        orthogonal noise (the PCA serve regime): a near-orthogonal query's
        tiny projection would amplify rounding by ``sqrt(d/k)`` and
        measure the query, not the kernel."""
        rng = np.random.default_rng(seed)
        if v is None:
            q, _ = np.linalg.qr(rng.standard_normal((self.d, self.k)))
            v = np.asarray(q[:, : self.k], np.float32)
        elif isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy()
        else:
            v = np.asarray(v, np.float32)
        coeffs = rng.standard_normal((rows, self.k))
        noise = rng.standard_normal((rows, self.d))
        noise *= (
            0.3
            * np.linalg.norm(coeffs, axis=1, keepdims=True)
            / np.maximum(
                np.linalg.norm(noise, axis=1, keepdims=True), 1e-12
            )
        )
        x = np.asarray(coeffs @ v.T + noise, np.float32)
        z = self.project(x, v).cpu().numpy()
        cols = self._cols
        z_ref = project_exact(
            torch.from_numpy(np.ascontiguousarray(x[:, cols])).to(self.device),
            torch.from_numpy(np.ascontiguousarray(v[cols])).to(self.device),
        )
        if self.sharded:  # the direct projection of each shard, summed alike
            z_ref = self._psum(z_ref)
        z_ref = z_ref.cpu().numpy()
        if self.serve_dtype == "float32":
            if not np.array_equal(z, z_ref):
                raise ValueError(
                    "serve_dtype='float32' self-check failed: the "
                    "padded bucket projection is not bit-exact against "
                    "the direct matmul (max abs err "
                    f"{float(np.abs(z - z_ref).max()):.3e})"
                )
            return 0.0
        num = np.sum(z * z_ref, axis=1)
        den = np.linalg.norm(z, axis=1) * np.linalg.norm(z_ref, axis=1)
        ok = den > 1e-12
        cos = np.clip(num[ok] / den[ok], -1.0, 1.0)
        worst = float(np.degrees(np.arccos(cos)).max()) if ok.any() else 0.0
        if worst > budget_deg:
            raise ValueError(
                f"serve_dtype={self.serve_dtype!r} self-check failed: "
                f"worst projection angle {worst:.4f} deg exceeds the "
                f"{budget_deg} deg budget — the quantized kernel is "
                "mis-projecting (refusing to serve drifted answers)"
            )
        return worst

    def stats(self) -> dict:
        return {
            "compile_misses": self.compile_misses,
            "cache_hits": self.cache_hits,
            "compile_ms_total": round(self.compile_ms_total, 3),
            "buckets": sorted({r for _, r in self._cache}),
        }

    # -- padded dispatch -----------------------------------------------------

    @property
    def sharded(self) -> bool:
        """Whether the basis is row-sharded over ``features``."""
        return self.basis_spec is not None

    def _psum(self, t: torch.Tensor) -> torch.Tensor:
        self.psums += 1
        with pmesh.mesh_scope(self.mesh):
            return pmesh.psum(t, FEATURE_AXIS)

    def _pad(self, x, width: int):
        """``x`` on this engine's device and dtype (one copy from the host
        when it is there), zero-padded to its row bucket on the device. In
        sharded mode a ``(rows, d)`` batch keeps this rank's columns (taken
        before the copy); a ``(rows, d_local)`` batch is those already."""
        x = _as_tensor(x)
        if self.sharded and width == self.d and x.dim() == 2:
            if x.shape[1] == self.d:
                x = x[:, self._cols]
            width = self.d_local
        if x.dim() != 2 or x.shape[1] != width:
            raise ValueError(
                f"query batch must be (rows, {width}), got shape "
                f"{tuple(x.shape)}"
            )
        x = x.to(device=self.device, dtype=self.dtype)
        rows = int(x.shape[0])
        padded = bucket_rows(rows, min_bucket=self.min_bucket)
        if padded != rows:
            buf = torch.zeros((padded, width), dtype=self.dtype, device=self.device)
            buf[:rows] = x
            x = buf
        return x, rows

    def place_basis(self, v) -> torch.Tensor:
        """A basis on this engine's device as a float32 tensor (a copy).
        Accepts a ``serving.registry.BasisVersion`` (its host ``v``), a
        tensor, or any ``(d, k)`` array; in sharded mode only this rank's
        rows move (a ``(d_local, k)`` operand is taken as those rows). A
        hot swap costs exactly this."""
        if hasattr(v, "shard_sizes") and hasattr(v, "v"):
            v = v.v
        if self.sharded and tuple(v.shape) == (self.d, self.k):
            v = v[self._cols]
        if isinstance(v, torch.Tensor):
            return v.detach().to(device=self.device, dtype=torch.float32, copy=True)
        return torch.tensor(np.asarray(v), dtype=torch.float32, device=self.device)

    def _check_basis(self, v) -> torch.Tensor:
        """Loud signature check at the kernel boundary: a mis-shaped basis
        would otherwise surface as a shape error deep inside a dispatch
        lane. Sharded: the whole basis (its rows are taken) or this rank's
        ``(d_local, k)`` rows."""
        shape = tuple(v.shape)
        ok = shape == (self.d, self.k) or (
            self.sharded and shape == (self.d_local, self.k))
        if not ok:
            raise ValueError(
                f"basis shape {shape} does not match this "
                f"engine's signature ({self.d}, {self.k})"
            )
        if self.sharded and shape == (self.d, self.k):
            return self.place_basis(v)
        if isinstance(v, torch.Tensor):
            return v.to(device=self.device, dtype=torch.float32).contiguous()
        return self.place_basis(v)

    def _shard_sums(self, x, v=None):
        """Sharded mode's one reduction: this rank's partial projection of
        ``x`` against its basis rows ``v`` (the serve kernel; none when
        ``v`` is None) and its partial input energy, summed over
        ``features`` in ONE fp32 psum. Returns ``(z or None, input_sq)``
        for the real rows."""
        x_pad, rows = self._pad(x, self.d)
        parts = [torch.sum(x_pad.float() ** 2, dim=-1, keepdim=True)]
        if v is not None:
            v = self._check_basis(v)
            z = self._compiled("project", int(x_pad.shape[0]))(x_pad, v)
            parts.insert(0, z.float())
        both = self._psum(torch.cat(parts, dim=1))[:rows]
        return (None if v is None else both[:, :self.k]), both[:, -1]

    def project(self, x, v) -> torch.Tensor:
        """``(n, d) -> (n, k)`` against basis ``v``: pad, dispatch the
        bucket's operation, slice. Sharded: this rank's shard through the
        serve kernel, then the one psum of :meth:`_shard_sums`."""
        if self.sharded:
            return self._shard_sums(x, v)[0]
        v = self._check_basis(v)
        x_pad, rows = self._pad(x, self.d)
        return self._compiled("project", int(x_pad.shape[0]))(x_pad, v)[:rows]

    def project_energy(self, x, v):
        """``(z, residual_sq, input_sq)`` of a query batch in one pass: the
        server's dispatch. Sharded, one reduction (:meth:`_shard_sums`)."""
        if not self.sharded:
            z = self.project(x, v)
            r, e = self.residual_energy(x, z)
            return z, r, e
        z, e_in = self._shard_sums(x, v)
        return z, torch.clamp_min(e_in - torch.sum(z ** 2, dim=-1), 0.0), e_in

    def reconstruct(self, z, v) -> torch.Tensor:
        """``(n, k) -> (n, d)`` back-projection against basis ``v``;
        sharded, this rank's ``(n, d_local)`` columns (row-local, no
        collective)."""
        v = self._check_basis(v)
        z_pad, rows = self._pad(z, self.k)
        x = self._compiled("reconstruct", int(z_pad.shape[0]))(z_pad, v)
        return x[:rows]

    def residual_energy(self, x, z) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-row ``(residual_sq, input_sq)`` energies from a query batch
        and its projection. Zero-padded rows contribute zero to both.
        Sharded: the input energy summed over ``features``."""
        if self.sharded:
            _, e_in = self._shard_sums(x)
            z_pad, rows = self._pad(z, self.k)
            e_out = torch.sum(z_pad[:rows].float() ** 2, dim=-1)
            return torch.clamp_min(e_in - e_out, 0.0), e_in
        x_pad, rows = self._pad(x, self.d)
        z_pad, _ = self._pad(z, self.k)
        r, e = self._compiled("residual", int(x_pad.shape[0]))(x_pad, z_pad)
        return r[:rows], e[:rows]
