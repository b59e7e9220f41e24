// Batched Gram kernels for Hopper (sm_90a): G[w] = X[w]^T X[w] / n.
//
// Replaces the TPU kernel distributed_eigenspaces_tpu/ops/pallas_gram.py::
// gram_pallas (kernel body _gram_kernel). That kernel ran a sequential
// (d/bd, d/bd, n/bn) grid on one TensorCore, carrying the output tile in
// VMEM across the innermost n axis. Here a CTA owns 128 x 128 output tiles
// of one worker (the TMA kernel two at a time) and loops over n itself. Only the tiles with bj >= bi are
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
//     element-by-element masked loads.
//   gram_f32_kernel : fp32 x. FFMA on the CUDA cores in full fp32, an 8x8
//     register tile per thread. TF32 is never used: the reference contracts
//     fp32 at Precision.HIGHEST.
// The last two write each tile through shared memory with a scalar loop,
// the transpose the same way; their diagonal tiles are symmetric because
// they sum the same products in the same order.
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

constexpr int F_BK = 8;       // fp32: rows of X per stage
constexpr int B_BK = 32;      // bf16: rows of X per stage
constexpr int B_LD = TILE + 8;  // bf16 slab row stride (elements)

constexpr int F_LOOP_BYTES = 2 * 2 * F_BK * TILE * 4;
constexpr int B_LOOP_BYTES = 2 * 2 * B_BK * B_LD * 2;
constexpr int SMEM_BYTES = EPI_BYTES;  // the largest of the three
static_assert(EPI_BYTES >= F_LOOP_BYTES && EPI_BYTES >= B_LOOP_BYTES,
              "the epilogue tile reuses the loop's shared memory");

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

__global__ void __launch_bounds__(THREADS, 2)
    gram_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int n, int d, float divisor) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* As = smem;                    // [2][F_BK][TILE]
  float* Bs = smem + 2 * F_BK * TILE;  // [2][F_BK][TILE]

  const int tiles = (d + TILE - 1) / TILE;
  int bi, bj;
  tile_coords(blockIdx.x, tiles, bi, bj);
  const int i0 = bi * TILE, j0 = bj * TILE;
  const float* xw = x + (size_t)blockIdx.z * n * d;
  float* ow = out + (size_t)blockIdx.z * d * d;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  float ra[4], rb[4];
  const int ktiles = (n + F_BK - 1) / F_BK;

  auto load = [&](int kt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = tid + r * THREADS;
      const int row = idx >> 7;
      const int col = idx & (TILE - 1);
      const int gr = kt * F_BK + row;
      const bool okr = gr < n;
      ra[r] = (okr && i0 + col < d) ? xw[(size_t)gr * d + i0 + col] : 0.f;
      rb[r] = (okr && j0 + col < d) ? xw[(size_t)gr * d + j0 + col] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = tid + r * THREADS;
      As[buf * F_BK * TILE + idx] = ra[r];
      Bs[buf * F_BK * TILE + idx] = rb[r];
    }
  };

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) load(kt + 1);
    const float* A = As + cur * F_BK * TILE;
    const float* B = Bs + cur * F_BK * TILE;
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + k * TILE + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(A + k * TILE + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(B + k * TILE + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(B + k * TILE + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    if (kt + 1 < ktiles) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: the loop's buffers are dead, reuse the shared memory
  float* tile = smem;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int ri = (a < 4 ? 0 : 64) + ty * 4 + (a & 3);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int cj = (b < 4 ? 0 : 64) + tx * 4 + (b & 3);
      tile[ri * EPI_LD + cj] = acc[a][b];
    }
  }
  __syncthreads();
  write_tile(tile, ow, d, i0, j0, divisor);
  if (bi != bj) {
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int ri = (a < 4 ? 0 : 64) + ty * 4 + (a & 3);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int cj = (b < 4 ? 0 : 64) + tx * 4 + (b & 3);
        tile[cj * EPI_LD + ri] = acc[a][b];
      }
    }
    __syncthreads();
    write_tile(tile, ow, d, j0, i0, divisor);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

}  // namespace

// x: (m, n, d) contiguous, dtype 0 = fp32, 1 = bf16. out: (m, d, d) fp32,
// 16-byte aligned. divisor: n for the normalized Gram, 1 otherwise.
// aligned: x is 16-byte aligned. bf16 x that is aligned, with d % 8 == 0,
// takes gram_bf16_tma_kernel (TMA reads it), other bf16 x gram_bf16_kernel,
// fp32 x gram_f32_kernel.
extern "C" int det_gram(const void* x, void* out, int m, int n, int d, int dtype,
                        float divisor, int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (takes_tma(dtype, d, aligned)) return launch_tma(x, out, m, n, d, divisor, s);
  const int tiles = (d + TILE - 1) / TILE;
  const dim3 grid(tiles * (tiles + 1) / 2, 1, m);
  if (dtype == 0) {
    cudaFuncSetAttribute(gram_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    gram_f32_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, d, divisor);
  } else if (dtype == 1) {
    cudaFuncSetAttribute(gram_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    gram_bf16_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        static_cast<const uint16_t*>(x), static_cast<float*>(out), n, d, divisor);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// grid.x of the launch det_gram makes on the current device for these
// shapes (a CUDA error as a negative number)
extern "C" int det_gram_grid(int m, int n, int d, int dtype, int aligned) {
  (void)n;
  if (takes_tma(dtype, d, aligned)) return tma_grid(m, d);
  const int tiles = (d + TILE - 1) / TILE;
  return tiles * (tiles + 1) / 2;
}
