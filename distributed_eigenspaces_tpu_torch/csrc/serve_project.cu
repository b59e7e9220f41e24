// Serve-side projection kernels for Hopper (sm_90a), the read path's hot op:
//   det_serve_project    : z = bf16(x) @ bf16(v)                (fp32 sums)
//   det_serve_project_i8 : z = (bf16(x) @ widen(v_i8)) * scale  (fp32 sums)
// x is (rows, d) fp32 or bf16, the basis (d, k) with k small (10 for the
// CIFAR-10 basis), z (rows, k) fp32, written once.
//
// Replaces the TPU kernels distributed_eigenspaces_tpu/ops/pallas_gram.py::
// serve_project_pallas (body _serve_project_kernel) and
// serve_project_i8_pallas (body _serve_project_i8_kernel). Those ran a
// (rows / block_rows, d / block_d) grid with the (block_rows, k) fp32 tile
// resident in VMEM across the sequential d axis, both operands cast to bf16
// on the MXU input; the int8 one widened the basis in-kernel and applied the
// per-column scale once, at the last d block. Here nothing carries across
// blocks: one warp owns RPW rows and walks the whole of d itself.
//
// What bounds it: bytes. Each x element meets k basis columns, 2k FLOP per
// 4 bytes of fp32 x (5 FLOP/byte at k = 10), far below the ~295 FLOP/byte
// at which Hopper's tensor cores become the limit, and k = 10 is no mma
// width. At the CIFAR-10 serve shapes the bound is x read once (plus the
// basis and z): (512, 3072, 10) 6.43 MB = 1.9 us, (65536, 3072, 10)
// 808 MB = 0.241 ms at 3.35 TB/s. So this is a GEMV-like CUDA-core kernel:
//   - x streams through 16-byte coalesced loads (4 fp32 or 8 bf16 per lane),
//     each value rounded to bf16 (round-to-nearest-even, as astype does);
//   - the basis is staged in shared memory in d chunks of DC, rounded to
//     bf16 (or widened from int8, exactly) and packed two columns per
//     32-bit word, in a lane-interleaved order so that the 32 lanes of a
//     warp read 32 consecutive words (no bank conflicts);
//   - k fp32 accumulators per row live in registers; every product of two
//     bf16 values is exact in fp32, so fmaf adds exact products;
//   - a fixed xor-shuffle tree finishes each row, and lane 0 writes it.
// k above 16 runs as grid.y tiles of 16 columns; ragged rows, d and k are
// masked (zeros in, nothing stored), so every shape takes the kernel.
//
// Each row's reduction order depends on d and the lane alone, never on how
// many rows share the launch: a zero-padded bucket gives every real row the
// bits it gets unpadded (the serving engine's padding contract).
// This first version stages the basis once per block and chunk, and has no
// cp.async/TMA pipeline and no persistent grid; its times are in PERF.md.
//
// C interface: each det_* function launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;                       // rows per warp
constexpr int ROWS_PER_BLOCK = WARPS * RPW;  // 32
constexpr int DC = 1024;                     // d indices per staged chunk
constexpr int MAX_PAIRS = 8;                 // 16 columns per launch tile

__device__ __forceinline__ float bf16_round(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

__device__ __forceinline__ float bf16_bits(uint32_t h) {
  return __uint_as_float(h << 16);
}

// VEC x values of one row from column `col`, rounded to bf16 and widened;
// zeros past d.
template <typename XT>
struct XLoad;

template <>
struct XLoad<float> {
  static constexpr int VEC = 4;
  __device__ __forceinline__ static void load(const float* __restrict__ row,
                                              int d, int col, int vec_ok,
                                              float out[VEC]) {
    if (vec_ok && col + VEC <= d) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row + col));
      out[0] = bf16_round(t.x);
      out[1] = bf16_round(t.y);
      out[2] = bf16_round(t.z);
      out[3] = bf16_round(t.w);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        out[e] = col + e < d ? bf16_round(row[col + e]) : 0.f;
    }
  }
};

template <>
struct XLoad<uint16_t> {  // bf16 bits
  static constexpr int VEC = 8;
  __device__ __forceinline__ static void load(const uint16_t* __restrict__ row,
                                              int d, int col, int vec_ok,
                                              float out[VEC]) {
    if (vec_ok && col + VEC <= d) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(row + col));
      const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[2 * i] = bf16_bits(w[i] & 0xffffu);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        out[e] = col + e < d ? bf16_bits(row[col + e]) : 0.f;
    }
  }
};

// Stage basis rows [c0, c0 + nd) and columns [col0, col0 + 2 * NP) into
// vs[p * DC + slot] as bf16 pairs (column col0 + 2p in the low half). The
// slot of local index t = g * 32 * VEC + lane * VEC + e is
// g * 32 * VEC + e * 32 + lane: the e-th value of every lane of a group
// sits in 32 consecutive words.
template <bool I8, int NP, int VEC>
__device__ __forceinline__ void stage(uint32_t* vs, const void* __restrict__ v,
                                      int k, int c0, int nd, int col0) {
  for (int idx = threadIdx.x; idx < DC * NP; idx += THREADS) {
    const int t = idx / NP;
    const int p = idx - t * NP;
    const int j = col0 + 2 * p;
    float a = 0.f, b = 0.f;
    if (t < nd) {
      const size_t off = (size_t)(c0 + t) * k + j;
      if constexpr (I8) {
        const int8_t* q = static_cast<const int8_t*>(v);
        if (j < k) a = static_cast<float>(q[off]);
        if (j + 1 < k) b = static_cast<float>(q[off + 1]);
      } else {
        const float* f = static_cast<const float*>(v);
        if (j < k) a = f[off];
        if (j + 1 < k) b = f[off + 1];
      }
    }
    const int g = t / (32 * VEC);
    const int w = t - g * 32 * VEC;
    const int slot = g * 32 * VEC + (w % VEC) * 32 + w / VEC;
    const __nv_bfloat162 pair = __floats2bfloat162_rn(a, b);
    vs[p * DC + slot] = *reinterpret_cast<const uint32_t*>(&pair);
  }
}

template <typename XT, bool I8, int NP>
__global__ void __launch_bounds__(THREADS)
    serve_project_kernel(const XT* __restrict__ x, const void* __restrict__ v,
                         const float* __restrict__ scale,
                         float* __restrict__ z, int rows, int d, int k,
                         int vec_ok) {
  constexpr int VEC = XLoad<XT>::VEC;
  constexpr int KT = 2 * NP;
  __shared__ uint32_t vs[NP * DC];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * ROWS_PER_BLOCK + warp * RPW;
  const int col0 = blockIdx.y * KT;

  float acc[RPW][KT];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < KT; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < d; c0 += DC) {
    const int nd = min(DC, d - c0);
    __syncthreads();  // every warp is done reading the previous chunk
    stage<I8, NP, VEC>(vs, v, k, c0, nd, col0);
    __syncthreads();
    for (int g0 = 0; g0 < nd; g0 += 32 * VEC) {
      const int col = c0 + g0 + lane * VEC;
      float xv[RPW][VEC];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        if (row0 + r < rows) {
          XLoad<XT>::load(x + (size_t)(row0 + r) * d, d, col, vec_ok, xv[r]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xv[r][e] = 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint32_t w = vs[p * DC + g0 + e * 32 + lane];
          const float v0 = bf16_bits(w & 0xffffu);
          const float v1 = __uint_as_float(w & 0xffff0000u);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            acc[r][2 * p] = fmaf(xv[r][e], v0, acc[r][2 * p]);
            acc[r][2 * p + 1] = fmaf(xv[r][e], v1, acc[r][2 * p + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float s = acc[r][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      acc[r][j] = s;
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = row0 + r;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int c = col0 + j;
        if (c >= k) continue;
        float out = acc[r][j];
        if constexpr (I8) out *= scale[c];  // once, after the whole d sum
        z[(size_t)row * k + c] = out;
      }
    }
  }
}

template <typename XT, bool I8>
int launch(const void* x, const void* v, const float* scale, float* z,
           int rows, int d, int k, int vec_ok, cudaStream_t s) {
  const int np = min(MAX_PAIRS, (k + 1) / 2);
  const dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                  (k + 2 * np - 1) / (2 * np));
  const XT* xt = static_cast<const XT*>(x);
#define DET_SERVE_CASE(N)                                          \
  case N:                                                          \
    serve_project_kernel<XT, I8, N><<<grid, THREADS, 0, s>>>(      \
        xt, v, scale, z, rows, d, k, vec_ok);                      \
    break;
  switch (np) {
    DET_SERVE_CASE(1)
    DET_SERVE_CASE(2)
    DET_SERVE_CASE(3)
    DET_SERVE_CASE(4)
    DET_SERVE_CASE(5)
    DET_SERVE_CASE(6)
    DET_SERVE_CASE(7)
    DET_SERVE_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DET_SERVE_CASE
  return static_cast<int>(cudaGetLastError());
}

template <bool I8>
int dispatch(const void* x, const void* v, const float* scale, void* z,
             int rows, int d, int k, int x_dtype, int vec_ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(z);
  if (x_dtype == 0)
    return launch<float, I8>(x, v, scale, out, rows, d, k, vec_ok, s);
  if (x_dtype == 1)
    return launch<uint16_t, I8>(x, v, scale, out, rows, d, k, vec_ok, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (rows, d) contiguous, x_dtype 0 = fp32, 1 = bf16. v: (d, k) fp32
// contiguous. z: (rows, k) fp32. vec_ok: x rows may be read as 16-byte
// vectors (d a multiple of 4 (fp32) or 8 (bf16), x 16-byte aligned).
extern "C" int det_serve_project(const void* x, const void* v, void* z,
                                 int rows, int d, int k, int x_dtype,
                                 int vec_ok, void* stream) {
  return dispatch<false>(x, v, nullptr, z, rows, d, k, x_dtype, vec_ok,
                         stream);
}

// As det_serve_project with q: (d, k) int8 contiguous and scale: (k,) fp32.
extern "C" int det_serve_project_i8(const void* x, const void* q,
                                    const void* scale, void* z, int rows,
                                    int d, int k, int x_dtype, int vec_ok,
                                    void* stream) {
  return dispatch<true>(x, q, static_cast<const float*>(scale), z, rows, d,
                        k, x_dtype, vec_ok, stream);
}
