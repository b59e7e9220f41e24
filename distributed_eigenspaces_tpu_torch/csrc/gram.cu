// Batched Gram kernel for Hopper (sm_90a): G[w] = X[w]^T X[w] / n.
//
// Replaces the TPU kernel distributed_eigenspaces_tpu/ops/pallas_gram.py::
// gram_pallas (kernel body _gram_kernel). That kernel ran a sequential
// (d/bd, d/bd, n/bn) grid on one TensorCore, carrying the output tile in
// VMEM across the innermost n axis. Here every block owns one output tile
// of one worker (grid.z = worker) and loops over n itself, staging two
// (BK, 128) row slabs of X in shared memory with coalesced loads along d.
// Ragged edges (n or d not a multiple of the tile) are masked to zero in
// the loads and skipped in the stores, so every shape is taken: there is
// no tile-legality fallback.
//
// Symmetry: only the tiles with bj >= bi are computed (grid.x enumerates
// the upper triangle of the tile grid). Each off-diagonal block writes its
// tile and its transpose, both through shared memory so that both global
// writes are coalesced rows. The diagonal tiles are exactly symmetric
// (the same products in the same order), so the whole output is too.
//
// Two inner loops, picked by the input type:
//   fp32  : FFMA on the CUDA cores in full fp32, an 8x8 register tile per
//           thread. TF32 is never used: the reference contracts fp32 at
//           Precision.HIGHEST.
//   bf16  : WMMA (mma.sync) 16x16x16 bf16 products with fp32 accumulators,
//           a 64x32 warp tile, eight warps per 128x128 block tile.
// Both accumulate in fp32 and divide by `divisor` (n, or 1 for the
// unnormalized Gram) in the epilogue.
//
// What bounds it at the CIFAR-10 shape (m=8, n=1024, d=3072): the distinct
// output entries need m*n*d*(d+1) = 7.7e10 FLOP; the output is 302 MB
// written once (0.09 ms at 3.35 TB/s) and the bf16 input 50 MB. bf16:
// 7.7e10 FLOP at 989 TFLOP/s = 0.08 ms, so bytes bound it (0.105 ms).
// fp32: 7.7e10 FLOP at 67 TFLOP/s = 1.15 ms, operations bound it. This
// first version uses mma.sync rather than wgmma/TMA and a register-staged
// double buffer; its measured times are in PERF.md.
//
// C interface: det_gram(...) launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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
constexpr int SMEM_BYTES =
    EPI_BYTES > F_LOOP_BYTES
        ? (EPI_BYTES > B_LOOP_BYTES ? EPI_BYTES : B_LOOP_BYTES)
        : (F_LOOP_BYTES > B_LOOP_BYTES ? F_LOOP_BYTES : B_LOOP_BYTES);

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
                     int n, int d, float divisor, int vec_ok) {
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

  auto load_chunk = [&](int gr, int gc) -> uint4 {
    if (gr < n && vec_ok && gc + 8 <= d) {
      return *reinterpret_cast<const uint4*>(xw + (size_t)gr * d + gc);
    }
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

}  // namespace

// x: (m, n, d) contiguous, dtype 0 = fp32, 1 = bf16. out: (m, d, d) fp32.
// divisor: n for the normalized Gram, 1 otherwise. vec_ok: the bf16 rows
// may be read as 16-byte vectors (d % 8 == 0 and x 16-byte aligned).
extern "C" int det_gram(const void* x, void* out, int m, int n, int d,
                        int dtype, float divisor, int vec_ok,
                        void* stream) {
  const int tiles = (d + TILE - 1) / TILE;
  const dim3 grid(tiles * (tiles + 1) / 2, 1, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    cudaFuncSetAttribute(gram_f32_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    gram_f32_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, d,
        divisor);
  } else if (dtype == 1) {
    cudaFuncSetAttribute(gram_bf16_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    gram_bf16_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        static_cast<const uint16_t*>(x), static_cast<float*>(out), n, d,
        divisor, vec_ok);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
