#!/usr/bin/env python3
"""The split serve kernel's basis staging against the vector staging it
replaced, timed on one card.

    python3 scripts/torch_profile_serve_staging.py

``serve_split_kernel`` (``csrc/serve_project.cu``) stages its basis with
``stage_cols``: a thread per basis row reads the tile's columns. It had a
second staging, ``stage_tile``: coalesced 16-byte vectors of the whole basis
(4 in flight per thread, each CTA starting at another round), each vector's
values rounded or widened and scattered pair by pair, taken where one
column tile holds all of k and the basis is 16-byte aligned. This script
builds a copy of the source with that staging put back (``STAGE_TILE``
below, as it stood in the kernel, and the host's choice between the two;
into ``build/torch_kernels/``, which the port never loads) and times both
libraries on the same operands (``chip_smoke.serve_operands``, fp32 x), for
the bf16 and the int8 basis, at row counts where the copy takes
``stage_tile``: 2,048 and 8,192 rows (a few items per persistent CTA, so
staging is not amortised), the bulk 65,536 rows (d = 3072, k = 10), and
4,096 rows at d = 12288, where the basis is staged in d chunks per item.
Each time is CUDA events over 100 back-to-back launches, in 7 rounds that
alternate the two libraries; it prints the median and the range over the
rounds, per launch, and fails if the two outputs differ in any bit. One
JSON line per shape and basis. The fp32 basis keeps ``stage_cols`` in both
builds (the vector staging rounds to bf16). The copies are built by
``scripts/torch_kernel_copies.py``.

It imports nothing of JAX or of the JAX package, needs a card, and exits
non-zero without one.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch_kernel_copies as kc

SOURCE = "serve_project.cu"
SHAPES = ((2048, 3072, 10), (8192, 3072, 10), (65536, 3072, 10), (4096, 12288, 10))
ROUNDS, REPS = 7, 100

# the vector staging and the dispatch between the two, inserted before
# stage_cols and before load_batch
STAGE_TILE = r"""// 16-byte vectors of the fp32 (B = kBf16) or int8 (B = kI8) basis, U of them
// in flight per thread while staging
template <int B>
struct BasisVec;

template <>
struct BasisVec<kBf16> {
  static constexpr int W = 4;  // values per vector
  static constexpr int U = 4;
  using T = float4;
  __device__ __forceinline__ static T load(const void* v, long long q, long long total) {
    const float* f = static_cast<const float*>(v);
    if ((q + 1) * W <= total) return __ldg(static_cast<const float4*>(v) + q);
    const long long f0 = q * W;
    return make_float4(f0 < total ? f[f0] : 0.f, f0 + 1 < total ? f[f0 + 1] : 0.f,
                       f0 + 2 < total ? f[f0 + 2] : 0.f, f0 + 3 < total ? f[f0 + 3] : 0.f);
  }
  __device__ __forceinline__ static float value(const T& t, int u) {
    return u == 0 ? t.x : u == 1 ? t.y : u == 2 ? t.z : t.w;
  }
};

template <>
struct BasisVec<kI8> {
  static constexpr int W = 16;
  static constexpr int U = 4;
  using T = int4;
  __device__ __forceinline__ static T load(const void* v, long long q, long long total) {
    if ((q + 1) * W <= total) return __ldg(static_cast<const int4*>(v) + q);
    const int8_t* b = static_cast<const int8_t*>(v);
    int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long f = q * W + 4 * i + u;
        if (f < total) w[i] |= (static_cast<int>(b[f]) & 0xff) << (8 * u);
      }
    }
    return make_int4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static float value(const T& t, int u) {  // exact
    const int w = (u >> 2) == 0 ? t.x : (u >> 2) == 1 ? t.y : (u >> 2) == 2 ? t.z : t.w;
    return static_cast<float>(static_cast<int8_t>(w >> (8 * (u & 3))));
  }
};

// Stage basis rows [c0, c0 + nd) of a basis of one column tile (k <= 2 * NP,
// col0 = 0) whose pointer is 16-byte aligned: the chunk's nd * k values are
// read as whole 16-byte vectors (coalesced: thread i takes vectors i,
// i + THREADS, ..., U of them in flight), each CTA starting at another
// round so that the CTAs of a launch spread their reads over L2; each
// value is rounded (fp32) or widened exactly (int8) to bf16. Even k stores
// whole 32-bit pairs; odd k one half at a time. The first round's loads are
// issued before the barrier that frees the previous chunk.
template <int B, int NP, int VEC>
__device__ __forceinline__ void stage_tile(uint32_t* vs, const void* __restrict__ v,
                                           int k, long long total, int c0, int nd,
                                           int ds) {
  using BV = BasisVec<B>;
  constexpr int W = BV::W, U = BV::U;
  constexpr int NPP = NP | 1;
  const long long f0 = (long long)c0 * k;
  const long long qb = f0 / W;  // the vector holding the chunk's first value
  const int lead = static_cast<int>(f0 - qb * W);
  const int n = nd * k;  // at most 2 * S_BASIS_WORDS values
  const int nvec = (lead + n + W - 1) / W;
  constexpr int PER_ROUND = THREADS * U;
  const int rounds = (nvec + PER_ROUND - 1) / PER_ROUND;
  int r = blockIdx.x % rounds;
  typename BV::T buf[U];
  auto load_round = [&](int round) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int iv = round * PER_ROUND + u * THREADS + threadIdx.x;
      if (iv < nvec) buf[u] = BV::load(v, qb + iv, total);
    }
  };
  load_round(r);
  __syncthreads();  // every warp is done reading the previous chunk
  uint4* vz = reinterpret_cast<uint4*>(vs);
  for (int i = threadIdx.x; i < NPP * ds / 4; i += THREADS) vz[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  uint16_t* half = reinterpret_cast<uint16_t*>(vs);
  // (row, column) of a value THREADS vectors further on
  const int st = THREADS * W / k, sj = THREADS * W - st * k;
  for (int done = 0; done < rounds; ++done) {
    if (done) load_round(r);
    // local index of this thread's first vector's first value in the round
    const int fl0 = (r * PER_ROUND + threadIdx.x) * W - lead;
    int t = fl0 >= 0 ? fl0 / k : -((-fl0 + k - 1) / k);
    int j = fl0 - t * k;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int iv = r * PER_ROUND + u * THREADS + threadIdx.x;
      const int fl = fl0 + u * THREADS * W;
      if (iv < nvec) {
        int te = t, je = j;
        if ((k & 1) == 0) {  // pairs never straddle rows: whole words
#pragma unroll
          for (int e = 0; e < W; e += 2) {
            if (fl + e >= 0 && fl + e < n)
              vs[slot<VEC>(te) * NPP + (je >> 1)] =
                  bf16_pack(BV::value(buf[u], e), BV::value(buf[u], e + 1));
            je += 2;
            if (je >= k) {
              je -= k;
              ++te;
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e) {
            if (fl + e >= 0 && fl + e < n)
              half[2 * (slot<VEC>(te) * NPP + (je >> 1)) + (je & 1)] =
                  __bfloat16_as_ushort(__float2bfloat16_rn(BV::value(buf[u], e)));
            if (++je == k) {
              je = 0;
              ++te;
            }
          }
        }
      }
      t += st;
      j += sj;
      if (j >= k) {
        j -= k;
        ++t;
      }
    }
    r = r + 1 == rounds ? 0 : r + 1;
  }
}

"""
STAGE = r"""template <int B, int NP, int VEC>
__device__ __forceinline__ void stage(uint32_t* vs, const void* __restrict__ v,
                                      int d, int k, int c0, int nd, int ds,
                                      int col0, int tile) {
  if constexpr (B != kF32) {  // the vector staging rounds or widens to bf16
    if (tile) {
      stage_tile<B, NP, VEC>(vs, v, k, (long long)d * k, c0, nd, ds);
      return;
    }
  }
  stage_cols<B, NP, VEC>(vs, v, k, c0, nd, ds, col0);
}

"""
# (text of the source, text of the copy): the kernel takes the host's choice
EDITS = (
    ("    stage_cols<B, NP, VEC>(vs, v, k, 0, d, ds, col0);\n",
     "    stage<B, NP, VEC>(vs, v, d, k, 0, d, ds, col0, tile);\n"),
    ("        stage_cols<B, NP, VEC>(vs, v, k, c0, min(ds, d - c0), ds, col0);\n",
     "        stage<B, NP, VEC>(vs, v, d, k, c0, min(ds, d - c0), ds, col0, tile);\n"),
    ("                       int rows, int d, int k, int ds, int vec_ok) {\n",
     "                       int rows, int d, int k, int ds, int vec_ok, int tile) {\n"),
    ("  serve_split_kernel<XT, B, NP><<<dim3(gx, tiles), THREADS, smem, s>>>(\n",
     "  // one column tile and a 16-byte aligned basis: vector staging\n"
     "  const int tile = tiles == 1 && (reinterpret_cast<uintptr_t>(v) & 15) == 0;\n"
     "  serve_split_kernel<XT, B, NP><<<dim3(gx, tiles), THREADS, smem, s>>>(\n"),
    ("      static_cast<const XT*>(x), v, scale, z, rows, d, k, ds, vec_ok);\n",
     "      static_cast<const XT*>(x), v, scale, z, rows, d, k, ds, vec_ok, tile);\n"),
)


def with_stage_tile(src: str) -> str:
    """``serve_project.cu`` with the vector staging put back."""
    for anchor, block in (("// Stage basis rows [c0, c0 + nd), columns [col0, col0 + 2 * NP): a",
                           STAGE_TILE), ("// x of one load batch:", STAGE)):
        src = kc.edit(src, anchor, block + anchor, SOURCE)
    for old, new in EDITS:
        src = kc.edit(src, old, new, SOURCE)
    return src


def main() -> int:
    import torch

    if not kc.require_card("torch_profile_serve_staging"):
        return 2
    import chip_smoke
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

    card = kc.card()
    P, I = kc.PTR, kc.INT
    libs = kc.build("serve_project", {"stage_cols": lambda s: s, "stage_tile": with_stage_tile},
                    {"det_serve_project": [P, P, P, I, I, I, I, I, P],
                     "det_serve_project_i8": [P, P, P, P, I, I, I, I, I, P]})
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for shape in SHAPES:
        rows, d, k = shape
        x, v = chip_smoke.serve_operands(shape, dev, seed=7)
        q, s = sp.quantize_basis_i8(v)
        for basis in ("bf16", "i8"):
            z = {name: torch.empty((rows, k), device=dev) for name in libs}

            def run(name, basis=basis, z=z):
                lib = libs[name]
                if basis == "bf16":
                    rc = lib.det_serve_project(x.data_ptr(), v.data_ptr(), z[name].data_ptr(),
                                               rows, d, k, 0, 1, stream)
                else:
                    rc = lib.det_serve_project_i8(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                                  z[name].data_ptr(), rows, d, k, 0, 1, stream)
                kc.checked(rc, f"{name} {basis}")

            fns = {name: (lambda name=name: run(name)) for name in libs}
            times = {name: [t * 1e3 for t in ts]
                     for name, ts in kc.rounds(fns, ROUNDS, REPS).items()}
            same = bool(torch.equal(z["stage_tile"], z["stage_cols"]))
            bound_ms, bound_by = chip_smoke.serve_bound(shape, basis)
            print(json.dumps({
                "phase": "serve_staging", "shape": list(shape), "basis": basis,
                "x_dtype": "float32", "plan": sp.split_plan(rows, d, k),
                **{f"{name}_us": statistics.median(t) for name, t in times.items()},
                **{f"{name}_us_range": [min(t), max(t)] for name, t in times.items()},
                "cols_over_tile": statistics.median(times["stage_cols"])
                / statistics.median(times["stage_tile"]),
                "bit_equal": same, "bound_us": bound_ms * 1e3, "bound_by": bound_by,
                "card": card,
            }), flush=True)
            chip_smoke.check(same, f"the two stagings differ at {shape} {basis}")
        del x, v, q, s
    return 0


if __name__ == "__main__":
    sys.exit(main())
