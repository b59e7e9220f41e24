// Batched Gram kernels for Hopper (sm_90a): G[w] = X[w]^T X[w] / n.
//
// Replaces the TPU kernel distributed_eigenspaces_tpu/ops/pallas_gram.py::
// gram_pallas (kernel body _gram_kernel). That kernel ran a sequential
// (d/bd, d/bd, n/bn) grid on one TensorCore, carrying the output tile in
// VMEM across the innermost n axis. Here a CTA owns square output tiles of
// one worker (128 x 128 for bf16, the TMA kernel two at a time; 32 to 128
// for fp32) and loops over n itself. Only the tiles with bj >= bi are
// computed; each off-diagonal tile is written twice, as itself and as its
// transpose, so the output is exactly symmetric by construction.
//
// What bounds it at the CIFAR-10 shape (m=8, n=1024, d=3072): the distinct
// output entries need m*n*d*(d+1) = 7.7e10 FLOP; the output is 302 MB
// written once (0.09 ms at 3.35 TB/s) and the bf16 input 50 MB. bf16:
// 7.7e10 FLOP at 989 TFLOP/s = 0.08 ms, so bytes bound it (0.105 ms), and
// loads, tensor-core work and the output's stores must all overlap to come
// near it. fp32: 7.7e10 FLOP at 67 TFLOP/s = 1.15 ms, operations bound it.
//
// Three kernels, picked by a shape rule before the launch (det_gram):
//   gram_bf16_tma_kernel : bf16 x with d % 8 == 0 and a 16-byte aligned
//     base (TMA needs 16-byte global strides), the fit's path. An item is
//     two neighbouring upper-triangle tiles of one tile row, 128 x 256
//     entries, so each 128 columns of x loaded feed 256 output columns
//     (two 128 x 128 tiles load 4 slabs, an item 3; a diagonal item 2).
//     The grid is persistent: as many CTAs as stay resident (one per SM),
//     each walking the (worker, item) list with stride gridDim.x. A
//     producer warpgroup (one thread issuing; setmaxnreg hands its
//     registers to the consumers) keeps a ring of T_STAGES stages full
//     with TMA: per stage the (T_BK, 128) slab i0 and the (T_BK, 256) slab
//     j0 of X, rows of n, as 64-column boxes in the 128-byte swizzle,
//     zero-filled past n and d, each stage's completion counted on an
//     mbarrier (full), its release on another (empty). Two consumer
//     warpgroups each own 64 rows of the item and run wgmma.mma_async
//     m64n256k16 bf16 -> fp32 with both operands read from shared memory
//     as MN-major (the transpose bits, allowed for 16-bit types), one group
//     of products in flight while the next stage is awaited. The epilogue
//     divides by `divisor` and stores each entry and its mirror straight
//     from registers; a diagonal tile stores its upper triangle and the
//     mirror of it, so the output is symmetric whatever order the tensor
//     core sums in. The producer is already loading the next item
//     meanwhile.
//     What stays exposed is the stores: on an NVIDIA H100 80GB HBM3 at
//     700 W the products and loads alone take about three quarters of the
//     kernel's time (scripts/torch_profile_gram.py, PERF.md). Staging the
//     tile in shared memory for TMA stores costs ring stages, and measured
//     slower in this design's trials, as did ping-pong warpgroups and
//     2-CTA clusters sharing slab j0 by TMA multicast.
//   gram_bf16_kernel : every other bf16 shape. WMMA (mma.sync) 16x16x16
//     bf16 products with fp32 accumulators, a 64x32 warp tile, eight warps
//     per 128x128 tile, one CTA per tile, register-staged double buffer,
//     element-by-element masked loads. It writes each tile through shared
//     memory with a scalar loop, the transpose the same way; its diagonal
//     tiles are symmetric because they sum the same products in the same
//     order.
//   gram_f32_kernel<T, VEC> : fp32 x. FFMA on the CUDA cores in full fp32;
//     TF32 is never used: the reference contracts fp32 at
//     Precision.HIGHEST. One CTA per upper-triangle T x T tile, a 16 x 16
//     grid of threads each holding (T/16) x (T/16) accumulators. The tile
//     edge T (128, 64 or 32) is a shape rule decided before the launch
//     (f32_tile): the largest edge whose m * tiles (tiles + 1) / 2 CTAs
//     fill the 132 SMs, else 32. At the entry shape (4, 128, 256) 128 x 128
//     tiles gave 12 CTAs; 32 x 32 tiles give 144. The slabs of x arrive
//     through a ring of F_STAGES cp.async stages of F_BK rows, one barrier
//     per stage (four stages, or 32 rows a stage, measured slower on an
//     NVIDIA H100 80GB HBM3 at 700 W; PERF.md); VEC = 4 copies 16 bytes
//     (d % 4 == 0 on a 16-byte aligned base), VEC = 1 four (ragged d, an
//     unaligned view), zero-filled past n and d either way. A diagonal tile loads one slab. The epilogue
//     divides in registers and stores each entry and its mirror straight
//     from registers (VEC: vector stores along a row, and along a column
//     of the tile for the mirror); a diagonal tile stores its upper
//     triangle and the mirror of it, so the output is exactly symmetric.
//     What bounds it at the CIFAR-10 shape is the FFMA rate (1.15 ms at 67
//     TFLOP/s); at the entry shape, where the bound is 0.5 us, the launch
//     and the latency of the first stage.
//
// C interface: det_gram(...) launches on the given stream, allocates
// nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue when
// the TMA descriptor cannot be built); det_gram_grid returns the grid.x a
// launch makes.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int TILE = 128;     // output tile edge, in d indices
constexpr int THREADS = 256;  // eight warps
constexpr int EPI_LD = 132;   // epilogue tile row stride (floats)
constexpr int EPI_BYTES = TILE * EPI_LD * 4;

constexpr int B_BK = 32;      // bf16: rows of X per stage
constexpr int B_LD = TILE + 8;  // bf16 slab row stride (elements)

constexpr int B_LOOP_BYTES = 2 * 2 * B_BK * B_LD * 2;
constexpr int SMEM_BYTES = EPI_BYTES;  // gram_bf16_kernel's
static_assert(EPI_BYTES >= B_LOOP_BYTES, "the epilogue tile reuses the loop's shared memory");

// gram_f32_kernel: its own constants (the tile edge is a template argument)
constexpr int F_THREADS = 256;  // a 16 x 16 grid of threads over the tile
constexpr int F_BK = 16;        // rows of X per stage
constexpr int F_STAGES = 2;     // stages in the cp.async ring (4 measured slower)
constexpr int F_FILL = 132;     // CTAs that fill the card: the SMs of an H100

// gram_bf16_tma_kernel: an item is two neighbouring tiles of a tile row,
// (bi, bj) and (bi, bj + 1), 128 x 256 outputs
constexpr int T_BK = 64;          // rows of X (n) per stage
constexpr int T_STAGES = 4;       // stages in the ring
constexpr int T_BOX = 64;         // d columns per TMA box: 128 bytes of bf16
constexpr int T_CONSUMERS = 2;    // warpgroups, 64 item rows each
constexpr int T_THREADS = 128 * (T_CONSUMERS + 1);  // and a producer warpgroup
constexpr int T_BOX_BYTES = T_BK * T_BOX * 2;      // 8 KB
constexpr int T_A_BYTES = 2 * T_BOX_BYTES;         // slab i0: 128 columns
constexpr int T_B_BYTES = 4 * T_BOX_BYTES;         // slab j0: 256 columns
constexpr int T_STAGE_BYTES = T_A_BYTES + T_B_BYTES;
constexpr int T_SMEM_BYTES = T_STAGES * T_STAGE_BYTES + 2 * T_STAGES * 8 + 1024;

// Linear index over the upper triangle of a tiles x tiles grid -> (bi, bj)
// with bi <= bj.
__device__ __forceinline__ void tile_coords(int p, int tiles, int& bi,
                                            int& bj) {
  int i = 0;
  while (p >= tiles - i) {
    p -= tiles - i;
    ++i;
  }
  bi = i;
  bj = i + p;
}

// Items of one worker: tile row bi holds (tiles - bi + 1) / 2 of them, item
// q of the row covering tile columns bi + 2q and bi + 2q + 1 (the second
// past the edge for the last item of a row of odd length).
__host__ __device__ __forceinline__ int row_items(int tiles, int bi) {
  return (tiles - bi + 1) / 2;
}

__host__ __device__ __forceinline__ int worker_items(int tiles) {
  int total = 0;
  for (int bi = 0; bi < tiles; ++bi) total += row_items(tiles, bi);
  return total;
}

__device__ __forceinline__ void item_coords(int q, int tiles, int& bi, int& bj) {
  int i = 0;
  while (q >= row_items(tiles, i)) {
    q -= row_items(tiles, i);
    ++i;
  }
  bi = i;
  bj = i + 2 * q;
}

// Write a (TILE, TILE) tile held row-major in shared memory to
// out[r0 + R][c0 + C], coalesced along C, masked at the ragged edge.
__device__ __forceinline__ void write_tile(const float* tile,
                                           float* __restrict__ out, int d,
                                           int r0, int c0, float divisor) {
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
    const int r = idx >> 7;
    const int c = idx & (TILE - 1);
    if (r0 + r < d && c0 + c < d) {
      out[(size_t)(r0 + r) * d + (c0 + c)] = tile[r * EPI_LD + c] / divisor;
    }
  }
}

// -- gram_f32_kernel ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (4 or 16) from src to shared dst; zeros where !ok
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// W adjacent floats (W = 1, 2 or 4) as one shared-memory or global access
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (W == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// One CTA per upper-triangle T x T tile (bi <= bj) of worker blockIdx.z.
// Thread (tx, ty) of the 16 x 16 grid owns rows g * 16 VW + ty VW + e and
// columns g * 16 VW + tx VW + e of the tile (g < TM / VW, e < VW), so each
// warp's reads of a stage row are one broadcast and 16 adjacent vectors.
template <int T, int VEC>
__global__ void __launch_bounds__(F_THREADS, 2)
    gram_f32_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int d,
                    float divisor) {
  constexpr int TM = T / 16;           // accumulators per thread along each axis
  constexpr int VW = TM < 4 ? TM : 4;  // of them adjacent: one vector
  constexpr int G = TM / VW;           // vectors per axis, 16 VW apart
  constexpr int SLAB = F_BK * T;       // floats of one slab in a stage
  constexpr int COPIES = 2 * SLAB / (F_THREADS * VEC);  // per thread per stage
  static_assert(2 * SLAB % (F_THREADS * VEC) == 0 && SLAB % (32 * VEC) == 0,
                "copies tile the stage, and a warp's lie in one slab");
  extern __shared__ __align__(16) float fsm[];  // [F_STAGES][slab i, slab j]

  const int tiles = (d + T - 1) / T;
  int bi, bj;
  tile_coords(blockIdx.x, tiles, bi, bj);
  const int i0 = bi * T, j0 = bj * T;
  const bool diag = bi == bj;  // slab j is slab i: loaded once
  const float* xw = x + (size_t)blockIdx.z * n * d;
  float* ow = out + (size_t)blockIdx.z * d * d;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int ktiles = (n + F_BK - 1) / F_BK;
  const uint32_t ring = smem_u32(fsm);

  // rows [kt F_BK, kt F_BK + F_BK) of x at columns i0.. and j0.. into stage
  // kt % F_STAGES; zeros past n and d (with VEC = 4, d % 4 == 0, so a
  // 16-byte copy lies wholly inside or wholly past d)
  auto load = [&](int kt) {
    const uint32_t st = ring + (kt % F_STAGES) * (2 * SLAB * 4);
#pragma unroll
    for (int q = 0; q < COPIES; ++q) {
      const int e = (q * F_THREADS + tid) * VEC;
      const int half = e / SLAB;
      if (diag && half) continue;
      const int row = (e - half * SLAB) / T, col = e % T;
      const int gr = kt * F_BK + row, gc = (half ? j0 : i0) + col;
      const bool ok = gr < n && gc < d;
      cp_async<4 * VEC>(st + e * 4, ok ? xw + (size_t)gr * d + gc : x, ok);
    }
  };

  float acc[TM][TM];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TM; ++b) acc[a][b] = 0.f;

#pragma unroll
  for (int kt = 0; kt < F_STAGES - 1; ++kt) {
    if (kt < ktiles) load(kt);
    cp_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<F_STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();          // everyone's, and stage kt - 1 is free
    if (kt + F_STAGES - 1 < ktiles) load(kt + F_STAGES - 1);
    cp_commit();
    const float* A = fsm + (kt % F_STAGES) * 2 * SLAB;
    const float* B = diag ? A : A + SLAB;
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      float av[TM], bv[TM];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        load_vec<VW>(A + k * T + g * 16 * VW + ty * VW, av + g * VW);
        load_vec<VW>(B + k * T + g * 16 * VW + tx * VW, bv + g * VW);
      }
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TM; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }

  // epilogue, from registers: block (ga, gb) of this thread is VW x VW
  // entries at tile rows R0.. and columns C0..; entry (r, c) is stored at
  // (r, c) and at (c, r). In a diagonal tile the blocks below the diagonal
  // are left to their mirror, and a block on it stores its upper triangle
  // and the mirror of that.
#pragma unroll
  for (int ga = 0; ga < G; ++ga) {
#pragma unroll
    for (int gb = 0; gb < G; ++gb) {
      const int R0 = ga * 16 * VW + ty * VW, C0 = gb * 16 * VW + tx * VW;
      if (diag && R0 > C0) continue;
      float v[VW][VW];  // v[e][u]: entry (i0 + R0 + e, j0 + C0 + u)
#pragma unroll
      for (int e = 0; e < VW; ++e)
#pragma unroll
        for (int u = 0; u < VW; ++u) v[e][u] = acc[ga * VW + e][gb * VW + u] / divisor;
      const int r0 = i0 + R0, c0 = j0 + C0;
      if (diag && R0 == C0) {
#pragma unroll
        for (int e = 0; e < VW; ++e)
#pragma unroll
          for (int u = e; u < VW; ++u) {
            const int r = r0 + e, c = c0 + u;
            if (max(r, c) < d) {
              ow[(size_t)r * d + c] = v[e][u];
              if (u > e) ow[(size_t)c * d + r] = v[e][u];
            }
          }
      } else if (VEC == 4) {  // d % VW == 0: a vector lies wholly inside or past d
        if (c0 < d) {
#pragma unroll
          for (int e = 0; e < VW; ++e)
            if (r0 + e < d) store_vec<VW>(ow + (size_t)(r0 + e) * d + c0, v[e]);
        }
        if (r0 < d) {
#pragma unroll
          for (int u = 0; u < VW; ++u) {
            float col[VW];
#pragma unroll
            for (int e = 0; e < VW; ++e) col[e] = v[e][u];
            if (c0 + u < d) store_vec<VW>(ow + (size_t)(c0 + u) * d + r0, col);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e)
#pragma unroll
          for (int u = 0; u < VW; ++u) {
            const int r = r0 + e, c = c0 + u;
            if (max(r, c) < d) {
              ow[(size_t)r * d + c] = v[e][u];
              ow[(size_t)c * d + r] = v[e][u];
            }
          }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    gram_bf16_kernel(const uint16_t* __restrict__ x, float* __restrict__ out,
                     int n, int d, float divisor) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + 2 * B_BK * B_LD;  // [2][B_BK][B_LD] each

  const int tiles = (d + TILE - 1) / TILE;
  int bi, bj;
  tile_coords(blockIdx.x, tiles, bi, bj);
  const int i0 = bi * TILE, j0 = bj * TILE;
  const uint16_t* xw = x + (size_t)blockIdx.z * n * d;
  float* ow = out + (size_t)blockIdx.z * d * d;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 0..1: 64 rows each
  const int wn = warp & 3;   // 0..3: 32 columns each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  // each thread moves two 16-byte chunks (8 bf16) of each slab per stage
  uint4 ra[2], rb[2];
  const int ktiles = (n + B_BK - 1) / B_BK;

  // element by element: the aligned shapes take gram_bf16_tma_kernel
  auto load_chunk = [&](int gr, int gc) -> uint4 {
    alignas(16) uint16_t tmp[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      tmp[e] = (gr < n && gc + e < d) ? xw[(size_t)gr * d + gc + e] : 0;
    }
    return *reinterpret_cast<const uint4*>(tmp);
  };
  auto load = [&](int kt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * THREADS;
      const int row = idx >> 4;
      const int col = (idx & 15) * 8;
      const int gr = kt * B_BK + row;
      ra[r] = load_chunk(gr, i0 + col);
      rb[r] = load_chunk(gr, j0 + col);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * THREADS;
      const int row = idx >> 4;
      const int col = (idx & 15) * 8;
      const int off = buf * B_BK * B_LD + row * B_LD + col;
      *reinterpret_cast<uint4*>(As + off) = ra[r];
      *reinterpret_cast<uint4*>(Bs + off) = rb[r];
    }
  };

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) load(kt + 1);
    const __nv_bfloat16* A = As + cur * B_BK * B_LD;
    const __nv_bfloat16* B = Bs + cur * B_BK * B_LD;
#pragma unroll
    for (int kk = 0; kk < B_BK; kk += 16) {
      // A (M x K) is the slab transposed: element (m, k) sits at
      // A[k * B_LD + m], i.e. column-major with leading dimension B_LD
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        wmma::load_matrix_sync(fa[a], A + kk * B_LD + wm * 64 + a * 16, B_LD);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wmma::load_matrix_sync(fb[b], B + kk * B_LD + wn * 32 + b * 16, B_LD);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
    if (kt + 1 < ktiles) store(cur ^ 1);
    __syncthreads();
  }

  float* tile = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      wmma::store_matrix_sync(
          tile + (wm * 64 + a * 16) * EPI_LD + wn * 32 + b * 16, acc[a][b],
          EPI_LD, wmma::mem_row_major);
  __syncthreads();
  write_tile(tile, ow, d, i0, j0, divisor);
  if (bi != bj) {
    __syncthreads();
    // column-major store of the same fragments = the transposed tile
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wmma::store_matrix_sync(
            tile + (wn * 32 + b * 16) * EPI_LD + wm * 64 + a * 16, acc[a][b],
            EPI_LD, wmma::mem_col_major);
    __syncthreads();
    write_tile(tile, ow, d, j0, i0, divisor);
  }
}

// -- gram_bf16_tma_kernel ----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one (T_BOX, T_BK) box of X at (d, n, worker) = (c0, c1, c2) into shared
// memory, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A shared-memory matrix descriptor for wgmma: an MN-major operand in the
// 128-byte swizzle, in 64-element (128-byte) wide boxes T_BOX_BYTES apart
// (LBO, read where the operand is wider than one box), whose 8-row groups
// of K lie 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(T_BOX_BYTES >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// a wgmma wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, fp32) += A (64 x 16) B (16 x 256), bf16, both operands
// MN-major in shared memory (transpose bits 1, 1)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(T_THREADS, 1)
    gram_bf16_tma_kernel(__grid_constant__ const CUtensorMap x_map,
                         float* __restrict__ out, int m, int n, int d, float divisor) {
  extern __shared__ __align__(1024) unsigned char tma_smem[];
  // the swizzled slabs need 1024-byte alignment
  const uint32_t raw = smem_u32(tma_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t stages = base;  // [T_STAGES][slab i0, slab j0]
  const uint32_t bars = base + T_STAGES * T_STAGE_BYTES;  // full, empty
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (T_STAGES + s); };

  const int tiles = (d + TILE - 1) / TILE;
  const int per_worker = worker_items(tiles);
  const int total = m * per_worker;
  const int ktiles = (n + T_BK - 1) / T_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * T_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * T_CONSUMERS) {  // the producer warpgroup
    // one thread issues the loads: the warpgroup hands its registers over
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * T_CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int w = t / per_worker;
        int bi, bj;
        item_coords(t - w * per_worker, tiles, bi, bj);
        const int i0 = bi * TILE, j0 = bj * TILE;
        // a diagonal item's slab i0 is the first half of its slab j0; a
        // box wholly past d is not loaded: its stale columns meet only
        // entries past d, which are never stored
        const bool diag = bi == bj;
        const int a_boxes = diag ? 0 : 1 + (i0 + T_BOX < d);
        int b_boxes = 0;
        while (b_boxes < 4 && j0 + b_boxes * T_BOX < d) ++b_boxes;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t bar = full(stage);
          mbar_expect_tx(bar, (a_boxes + b_boxes) * T_BOX_BYTES);
          const uint32_t a = stages + stage * T_STAGE_BYTES;
          const int row = kt * T_BK;
          for (int q = 0; q < a_boxes; ++q)
            tma_load(a + q * T_BOX_BYTES, &x_map, bar, i0 + q * T_BOX, row, w);
          for (int q = 0; q < b_boxes; ++q)
            tma_load(a + T_A_BYTES + q * T_BOX_BYTES, &x_map, bar, j0 + q * T_BOX, row, w);
          if (++stage == T_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns item rows [64 wg, 64 wg + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int w = t / per_worker;
    int bi, bj;
    item_coords(t - w * per_worker, tiles, bi, bj);
    const int i0 = bi * TILE, j0 = bj * TILE;
    const bool diag = bi == bj;

    float acc[128];  // this warpgroup's 64 rows, all 256 columns
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full(stage), phase);
      const uint32_t b = stages + stage * T_STAGE_BYTES + T_A_BYTES;
      const uint32_t a = (diag ? b : b - T_A_BYTES) + wg * T_BOX_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T_BK / 16; ++kk)
        wgmma_m64n256k16(acc, sw128_desc(a + kk * 2048), sw128_desc(b + kk * 2048));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done with it
      if (prev >= 0) mbar_arrive(empty(prev));
      prev = stage;
      if (++stage == T_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    mbar_arrive(empty(prev));
    fence_acc(acc);

    // epilogue: accumulator i of this thread is G[w] entry (r, c), stored
    // from registers with its mirror (c, r); a diagonal tile stores its
    // upper triangle and the mirror of it. Plain write-back stores: the
    // streaming hint (st.global.cs) and L1::no_allocate measured slower
    // (scripts/torch_profile_gram.py).
    float* g = out + (size_t)w * d * d;
    const int rbase = i0 + wg * 64 + warp * 16 + (lane >> 2);
    const int cbase = j0 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int r = rbase + 8 * ((i >> 1) & 1);
      const int c = cbase + 8 * (i >> 2);
      const float v0 = acc[i] / divisor, v1 = acc[i + 1] / divisor;
      if (r >= d || c >= d) continue;
      const bool c1 = c + 1 < d;
      if (!(diag && i < 64)) {
        if (c1)
          *reinterpret_cast<float2*>(g + (size_t)r * d + c) = make_float2(v0, v1);
        else
          g[(size_t)r * d + c] = v0;
        g[(size_t)c * d + r] = v0;
        if (c1) g[(size_t)(c + 1) * d + r] = v1;
      } else {
        if (c >= r) g[(size_t)r * d + c] = v0;
        if (c1 && c + 1 >= r) g[(size_t)r * d + c + 1] = v1;
        if (c > r) g[(size_t)c * d + r] = v0;
        if (c1 && c + 1 > r) g[(size_t)(c + 1) * d + r] = v1;
      }
    }
  }
}

// -- host --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the tensor map of x: (d, n, m) bf16 elements, rows of d, boxes of
// (T_BOX, T_BK, 1) in the 128-byte swizzle, zero-filled past n and d
bool encode_x(CUtensorMap* map, const void* x, int d, int n, int m) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)m};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)d * n * 2};
  const cuuint32_t box[3] = {T_BOX, T_BK, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

std::mutex g_occ_lock;

// CTAs of gram_bf16_tma_kernel resident per SM, and the SM count, on the
// current device (queried once per device); a CUDA error as a negative
int tma_resident(int* sms) {
  static std::map<int, std::pair<int, int>> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  std::lock_guard<std::mutex> guard(g_occ_lock);
  auto it = cache.find(dev);
  if (it == cache.end()) {
    e = cudaFuncSetAttribute(gram_bf16_tma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM_BYTES);
    int per_sm = 0, count = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_bf16_tma_kernel,
                                                        T_THREADS, T_SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -static_cast<int>(e);
    if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
    it = cache.emplace(dev, std::make_pair(per_sm, count)).first;
  }
  *sms = it->second.second;
  return it->second.first;
}

// grid.x of the TMA kernel for (m, d): resident CTAs, at most one per item
int tma_grid(int m, int d) {
  int sms = 0;
  const int per_sm = tma_resident(&sms);
  if (per_sm < 0) return per_sm;
  const long long total = (long long)m * worker_items((d + TILE - 1) / TILE);
  const long long gx = (long long)per_sm * sms;
  return static_cast<int>(gx < total ? gx : total);
}

// the shape rule: bf16 x whose rows TMA can read (16-byte strides and base)
bool takes_tma(int dtype, int d, int aligned) {
  return dtype == 1 && aligned && d % 8 == 0;
}

int launch_tma(const void* x, void* out, int m, int n, int d, float divisor,
               cudaStream_t s) {
  const int gx = tma_grid(m, d);
  if (gx < 0) return -gx;
  CUtensorMap x_map;
  if (!encode_x(&x_map, x, d, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  gram_bf16_tma_kernel<<<gx, T_THREADS, T_SMEM_BYTES, s>>>(
      x_map, static_cast<float*>(out), m, n, d, divisor);
  return static_cast<int>(cudaGetLastError());
}

// the fp32 shape rule: the largest tile edge whose CTAs fill the card
// (m * tiles (tiles + 1) / 2 >= F_FILL), else the smallest
int f32_tile(int m, int d) {
  for (int t = 128; t > 32; t /= 2) {
    const long long tiles = (d + t - 1) / t;
    if ((long long)m * (tiles * (tiles + 1) / 2) >= F_FILL) return t;
  }
  return 32;
}

// 16-byte copies and vector stores: rows of x and of the output 16-byte
// aligned
bool f32_vec(int d, int aligned) { return aligned && d % 4 == 0; }

template <int T, int VEC>
int launch_f32(const float* x, float* out, int m, int n, int d, float divisor,
               cudaStream_t s) {
  const int tiles = (d + T - 1) / T;
  const dim3 grid(tiles * (tiles + 1) / 2, 1, m);
  constexpr int smem = F_STAGES * 2 * F_BK * T * 4;  // the ring
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gram_f32_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gram_f32_kernel<T, VEC><<<grid, F_THREADS, smem, s>>>(x, out, n, d, divisor);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int launch_f32_vec(const float* x, float* out, int m, int n, int d, float divisor,
                   int aligned, cudaStream_t s) {
  return f32_vec(d, aligned) ? launch_f32<T, 4>(x, out, m, n, d, divisor, s)
                             : launch_f32<T, 1>(x, out, m, n, d, divisor, s);
}

}  // namespace

// x: (m, n, d) contiguous, dtype 0 = fp32, 1 = bf16. out: (m, d, d) fp32,
// 16-byte aligned. divisor: n for the normalized Gram, 1 otherwise.
// aligned: x is 16-byte aligned. bf16 x that is aligned, with d % 8 == 0,
// takes gram_bf16_tma_kernel (TMA reads it), other bf16 x gram_bf16_kernel,
// fp32 x gram_f32_kernel<f32_tile(m, d), f32_vec(d, aligned) ? 4 : 1>.
extern "C" int det_gram(const void* x, void* out, int m, int n, int d, int dtype,
                        float divisor, int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (takes_tma(dtype, d, aligned)) return launch_tma(x, out, m, n, d, divisor, s);
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    float* of = static_cast<float*>(out);
    switch (f32_tile(m, d)) {
      case 128: return launch_f32_vec<128>(xf, of, m, n, d, divisor, aligned, s);
      case 64: return launch_f32_vec<64>(xf, of, m, n, d, divisor, aligned, s);
      default: return launch_f32_vec<32>(xf, of, m, n, d, divisor, aligned, s);
    }
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (d + TILE - 1) / TILE;
  const dim3 grid(tiles * (tiles + 1) / 2, 1, m);
  cudaFuncSetAttribute(gram_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  gram_bf16_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const uint16_t*>(x), static_cast<float*>(out), n, d, divisor);
  return static_cast<int>(cudaGetLastError());
}

// grid.x of the launch det_gram makes on the current device for these
// shapes (a CUDA error as a negative number)
extern "C" int det_gram_grid(int m, int n, int d, int dtype, int aligned) {
  (void)n;
  if (takes_tma(dtype, d, aligned)) return tma_grid(m, d);
  const int edge = dtype == 0 ? f32_tile(m, d) : TILE;
  const int tiles = (d + edge - 1) / edge;
  return tiles * (tiles + 1) / 2;
}
