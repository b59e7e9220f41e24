// Serve-side projection kernels for Hopper (sm_90a), the read path's hot op:
//   det_serve_project     : z = bf16(x) @ bf16(v)                (fp32 sums)
//   det_serve_project_i8  : z = (bf16(x) @ widen(v_i8)) * scale  (fp32 sums)
//   det_serve_project_f32 : z = x @ v, fp32 x and basis, no rounding
// x is (rows, d) fp32 or bf16, the basis (d, k) with k small (10 for the
// CIFAR-10 basis), z (rows, k) fp32, written once.
//
// Replaces the TPU kernels distributed_eigenspaces_tpu/ops/pallas_gram.py::
// serve_project_pallas (body _serve_project_kernel) and
// serve_project_i8_pallas (body _serve_project_i8_kernel). Those ran a
// (rows / block_rows, d / block_d) grid with the (block_rows, k) fp32 tile
// resident in VMEM across the sequential d axis, both operands cast to bf16
// on the MXU input; the int8 one widened the basis in-kernel and applied the
// per-column scale once, at the last d block.
//
// What bounds them: bytes. Each x element meets k basis columns, 2k FLOP per
// 4 bytes of fp32 x (5 FLOP/byte at k = 10), far below the ~295 FLOP/byte
// at which Hopper's tensor cores become the limit, and k = 10 is no mma
// width. At the CIFAR-10 serve shapes the bound is x read once (plus the
// basis and z): (512, 3072, 10) 6.43 MB = 1.9 us, (65536, 3072, 10)
// 808 MB = 0.241 ms at 3.35 TB/s. So these are GEMV-like CUDA-core kernels,
// and what decides their time is how many bytes of x are in flight and how
// often the basis is staged, not arithmetic.
//
// serve_split_kernel (det_serve_project, det_serve_project_i8 and, with an
// fp32 basis, det_serve_project_f32):
//   - An item is S_ROWS = 4 rows over all of d and a tile of basis columns.
//     Its d is cut into groups of 32 * VEC indices (one 16-byte load per
//     lane: 4 fp32 or 8 bf16 values) and warp w walks groups w, w + 8,
//     w + 16, ... in order. So 512 rows make 128 items, where a warp per 4
//     rows over all of d made 16 blocks.
//   - Below S_SPREAD_ITEMS items (1,056 rows) a tile is one column pair, so
//     that k = 10 gives 5 tiles: 8 rows run on 10 CTAs, 512 rows on 640,
//     and each CTA stages 2 columns of the basis. From there on a tile holds
//     all of k (up to 16 columns) and x is read once.
//   - Each lane loads S_GB groups of its S_ROWS rows at once: 8 independent
//     16-byte loads in flight per lane (streamed past L1 and evicted first
//     from L2, so the basis stays cached). x is rounded to bf16 (round to
//     nearest even) two values per instruction as it is consumed.
//   - The grid is persistent: as many CTAs as the occupancy query keeps
//     resident (at most one per item and tile), each walking items
//     blockIdx.x, blockIdx.x + gridDim.x, ... So at 65536 rows some 264 CTAs
//     stage the basis, where 2,048 blocks restaged it per 1024-wide chunk.
//   - A CTA stages its columns of the basis once, whole, in dynamic shared
//     memory (61,440 bytes at d = 3072, k = 10; up to S_BASIS_WORDS words),
//     each value rounded (fp32) or widened exactly (int8) to bf16 and packed
//     two columns to a 32-bit word (the fp32 route: see below). A row's pairs sit side by side in an odd
//     number of words, in the lane-interleaved row order, so the 32 lanes
//     read 32 banks and each (value, pair) is a constant offset from the
//     lane's group base. A thread per basis row reads the tile's columns
//     and stores whole pairs. These are plain loads, not cp.async: the
//     conversion needs the values in registers, and a raw copy in shared
//     memory would hold the fp32 basis's 123 KB beside the staged 61 KB.
//     Coalesced 16-byte vectors of the whole basis, scattered pair by pair,
//     were 6-38% slower at 2,048 rows and at d = 12288, and between 6%
//     slower and 1% faster at 8,192 and 65,536 rows (NVIDIA H100 80GB
//     HBM3, 700 W; scripts/torch_profile_serve_staging.py, PERF.md), so
//     there is one staging. Where the columns exceed the budget the
//     basis is staged in d chunks of a multiple of the group size, per item.
//   - Each lane keeps 4 x 2 * NP fp32 sums in registers (products of bf16
//     values are exact in fp32). The lanes finish with a transpose-reduce
//     over lanes (halving across lanes 16, 8, 4, then a butterfly over 2
//     and 1: 9 * NP shuffles where a full tree per value took 40 * NP), and
//     the 8 warps' partials are added through shared memory in warp order,
//     by one thread per output. The int8 scale multiplies that sum once.
// Every row's order of summation is fixed by (d, k) and the x dtype alone:
// the d groups of each warp, the lane tree and the warp order depend on
// neither the row count, nor the grid, nor where the row sits; the staged
// chunks and the column tiles, which do, change where a value waits, not
// the order in which it is added. No float atomics:
// a zero-padded bucket gives every real row the bits it gets unpadded (the
// serving engine's padding contract), and repeated launches are identical.
// Ragged rows, d and k are masked (zeros in, nothing stored), so every shape
// takes the kernel.
//
// The fp32 route (det_serve_project_f32, serve_split_kernel<float, kF32,
// NP>) is no TPU kernel's port: the JAX package computes the fp32
// projection with XLA at Precision.HIGHEST. It is the port's fixed-order
// fp32 route, so that a served row equals the direct projection bit for bit
// on the card (a matmul library may pick another algorithm for a padded
// bucket than for a 1-row query), and the split kernel's row order gives
// exactly that. Its basis is staged unrounded, a 32-bit word per value, a
// row's 2 * NP values in 2 * NP + 1 words (odd, so the lanes still read 32
// banks); x is never rounded; the sums are fp32 FMAs. Whole-k tiles at d =
// 3072, k = 10 stage 33,792 words (135 KB), over S_BASIS_WORDS, so the fp32
// route has its own budget, S_F32_BASIS_WORDS: such a CTA holds its whole
// basis once, one CTA per SM, where restaging it per item in d chunks would
// read the basis again for every 4 rows. Its bound is the bf16 routes'
// (bytes: x read once); it replaces a first version that gave each warp 4
// rows over all of d, 16 CTAs at 512 rows (times in PERF.md).
//
// C interface: each det_* function launches on the given stream, allocates
// nothing, and returns cudaGetLastError(); det_serve_project_grid returns
// the persistent grid the split launches use.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_PAIRS = 8;                 // 16 columns per launch tile
constexpr int S_ROWS = 4;            // rows per item
constexpr int S_GB = 2;              // groups per warp per load batch
constexpr int S_BASIS_WORDS = 24576;  // staged basis words per CTA at most
constexpr int S_F32_BASIS_WORDS = 49152;  // the same for the fp32 basis
constexpr int S_MIN_CTAS = 2;        // resident CTAs per SM the registers allow
constexpr int S_SPREAD_ITEMS = 264;  // items from which a tile takes all of k

// how the basis is stored and staged
enum Basis { kBf16 = 0, kI8 = 1, kF32 = 2 };

// words a staged basis row (slot) takes: for bf16 and int8 the tile's NP
// bf16 pairs, for fp32 its 2 * NP values, a word each; always an odd count
__host__ __device__ constexpr int slot_words(int b, int np) {
  return b == kF32 ? 2 * np + 1 : (np | 1);
}

// staged basis words per CTA at most
__host__ __device__ constexpr int basis_budget(int b) {
  return b == kF32 ? S_F32_BASIS_WORDS : S_BASIS_WORDS;
}

__device__ __forceinline__ float bf16_bits(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// x rows, per dtype: VEC values per 16-byte load, and the load itself
template <typename XT>
struct XLoad;

template <>
struct XLoad<float> {
  static constexpr int VEC = 4;
  using Raw = float4;
  // VEC values of one row from column `col` (zeros past d), streamed (read
  // once)
  __device__ __forceinline__ static Raw raw(const float* __restrict__ row,
                                            int d, int col, int vec_ok) {
    if (vec_ok && col + VEC <= d)
      return __ldcs(reinterpret_cast<const float4*>(row + col));
    Raw t;
    t.x = col < d ? row[col] : 0.f;
    t.y = col + 1 < d ? row[col + 1] : 0.f;
    t.z = col + 2 < d ? row[col + 2] : 0.f;
    t.w = col + 3 < d ? row[col + 3] : 0.f;
    return t;
  }
  __device__ __forceinline__ static Raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // values 2i and 2i + 1 rounded to bf16, as one bf16 pair
  __device__ __forceinline__ static uint32_t pair(const Raw& t, int i) {
    return i == 0 ? bf16_pack(t.x, t.y) : bf16_pack(t.z, t.w);
  }
  // value e, unrounded (the fp32 route)
  __device__ __forceinline__ static float value(const Raw& t, int e) {
    return e == 0 ? t.x : e == 1 ? t.y : e == 2 ? t.z : t.w;
  }
};

template <>
struct XLoad<uint16_t> {  // bf16 bits
  static constexpr int VEC = 8;
  using Raw = uint4;
  __device__ __forceinline__ static Raw raw(const uint16_t* __restrict__ row,
                                            int d, int col, int vec_ok) {
    if (vec_ok && col + VEC <= d)
      return __ldcs(reinterpret_cast<const uint4*>(row + col));
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = col + 2 * i < d ? row[col + 2 * i] : 0u;
      const uint32_t hi = col + 2 * i + 1 < d ? row[col + 2 * i + 1] : 0u;
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static Raw zero() { return make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ static uint32_t pair(const Raw& t, int i) {
    return i == 0 ? t.x : i == 1 ? t.y : i == 2 ? t.z : t.w;
  }
};

// ---------------------------------------------------------------------------
// serve_split_kernel

// The staged basis: with W = slot_words(B, NP), column col0 + 2p + h of
// local row t (d index c0 + t) is half h of word vs[slot(t) * W + p] (bf16,
// int8), or word vs[slot(t) * W + 2p + h] (fp32), where with G = 32 * VEC
//   slot(t) = (t / G) * G + (t % VEC) * 32 + (t % G) / VEC,
// the row that lane l meets as its e-th value of a group being slot
// g * G + e * 32 + l. Each slot holds its row's pairs side by side, in an
// odd number of words, so the 32 lanes reading pair p of their e-th rows hit
// 32 banks, and the offset of (e, p) from a lane's group base is a constant.
template <int VEC>
__device__ __forceinline__ int slot(int t) {
  constexpr int G = 32 * VEC;
  return (t & ~(G - 1)) + (t & (VEC - 1)) * 32 + (t & (G - 1)) / VEC;
}

// Stage basis rows [c0, c0 + nd), columns [col0, col0 + 2 * NP): a thread
// per row, the tile's 2 * NP values of RU rows in flight, each pair (or
// fp32 value) written whole (zeros past d and k), so no zero fill is needed.
template <int B, int NP, int VEC>
__device__ __forceinline__ void stage_cols(uint32_t* vs, const void* __restrict__ v,
                                           int k, int c0, int nd, int ds, int col0) {
  constexpr int W = slot_words(B, NP);
  constexpr int RU = NP <= 2 ? 4 : 1;
  __syncthreads();  // every warp is done reading the previous chunk
  for (int t0 = threadIdx.x; t0 < ds; t0 += THREADS * RU) {
    float a[RU][2 * NP];
#pragma unroll
    for (int ru = 0; ru < RU; ++ru) {
      const int t = t0 + ru * THREADS;
      const long long row = (long long)(c0 + t) * k;
#pragma unroll
      for (int c = 0; c < 2 * NP; ++c) {
        a[ru][c] = 0.f;
        if (t < nd && col0 + c < k) {
          if constexpr (B == kI8)
            a[ru][c] = static_cast<float>(__ldg(static_cast<const int8_t*>(v) + row + col0 + c));
          else
            a[ru][c] = __ldg(static_cast<const float*>(v) + row + col0 + c);
        }
      }
    }
#pragma unroll
    for (int ru = 0; ru < RU; ++ru) {
      const int t = t0 + ru * THREADS;
      if (t < ds) {
        if constexpr (B == kF32) {
#pragma unroll
          for (int c = 0; c < 2 * NP; ++c)
            vs[slot<VEC>(t) * W + c] = __float_as_uint(a[ru][c]);
        } else {
#pragma unroll
          for (int p = 0; p < NP; ++p)
            vs[slot<VEC>(t) * W + p] = bf16_pack(a[ru][2 * p], a[ru][2 * p + 1]);
        }
      }
    }
  }
}

// x of one load batch: groups g, g + WARPS, ... (S_GB of them, those below
// g1) of the item's S_ROWS rows
template <typename XT>
__device__ __forceinline__ void load_batch(
    typename XLoad<XT>::Raw (&xr)[S_ROWS][S_GB], const XT* __restrict__ x,
    int r0, int rows, int d, int g, int g1, int lane, int vec_ok) {
  using L = XLoad<XT>;
  constexpr int G = 32 * L::VEC;
#pragma unroll
  for (int b = 0; b < S_GB; ++b) {
    const int gb = g + b * WARPS;
    if (gb >= g1) break;
    const int col = gb * G + lane * L::VEC;
#pragma unroll
    for (int r = 0; r < S_ROWS; ++r)
      xr[r][b] = r0 + r < rows
                     ? L::raw(x + (size_t)(r0 + r) * d, d, col, vec_ok)
                     : L::zero();
  }
}

template <typename XT, int B, int NP>
__device__ __forceinline__ void fma_batch(
    float (&acc)[S_ROWS][2 * NP], typename XLoad<XT>::Raw (&xr)[S_ROWS][S_GB],
    const uint32_t* vs, int g, int g0, int g1, int lane) {
  using L = XLoad<XT>;
  constexpr int VEC = L::VEC;
  constexpr int G = 32 * VEC;
  constexpr int W = slot_words(B, NP);
#pragma unroll
  for (int b = 0; b < S_GB; ++b) {
    const int gb = g + b * WARPS;
    if (gb >= g1) break;
    const uint32_t* vg = vs + ((gb - g0) * G + lane) * W;
    if constexpr (B == kF32) {  // fp32 x and basis, unrounded
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float xv[S_ROWS];
#pragma unroll
        for (int r = 0; r < S_ROWS; ++r) xv[r] = L::value(xr[r][b], e);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float v0 = __uint_as_float(vg[e * 32 * W + 2 * p]);
          const float v1 = __uint_as_float(vg[e * 32 * W + 2 * p + 1]);
#pragma unroll
          for (int r = 0; r < S_ROWS; ++r) {
            acc[r][2 * p] = fmaf(xv[r], v0, acc[r][2 * p]);
            acc[r][2 * p + 1] = fmaf(xv[r], v1, acc[r][2 * p + 1]);
          }
        }
      }
    } else {  // bf16 x values against bf16 pairs
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        uint32_t xw[S_ROWS];
#pragma unroll
        for (int r = 0; r < S_ROWS; ++r) xw[r] = L::pair(xr[r][b], i);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * i + h;
          float xv[S_ROWS];
#pragma unroll
          for (int r = 0; r < S_ROWS; ++r)
            xv[r] = h ? __uint_as_float(xw[r] & 0xffff0000u) : bf16_bits(xw[r]);
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const uint32_t w = vg[e * 32 * W + p];
            const float v0 = bf16_bits(w), v1 = __uint_as_float(w & 0xffff0000u);
#pragma unroll
            for (int r = 0; r < S_ROWS; ++r) {
              acc[r][2 * p] = fmaf(xv[r], v0, acc[r][2 * p]);
              acc[r][2 * p + 1] = fmaf(xv[r], v1, acc[r][2 * p + 1]);
            }
          }
        }
      }
    }
  }
}

// One step of the lane transpose-reduce: the lane with bit OFF set keeps the
// upper half of its n values, the other the lower half, each adding its
// partner's copy of the half it keeps.
template <int NP, int N, int OFF>
__device__ __forceinline__ void halve(float (&acc)[S_ROWS][2 * NP], int lane) {
  constexpr int KT = 2 * NP;
  const bool hi = lane & OFF;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    float& lo_v = acc[i / KT][i % KT];
    const float up_v = acc[(i + N / 2) / KT][(i + N / 2) % KT];
    const float send = hi ? lo_v : up_v;
    const float keep = hi ? up_v : lo_v;
    lo_v = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

template <typename XT, int B, int NP>
__global__ void __launch_bounds__(THREADS, S_MIN_CTAS)
    serve_split_kernel(const XT* __restrict__ x, const void* __restrict__ v,
                       const float* __restrict__ scale, float* __restrict__ z,
                       int rows, int d, int k, int ds, int vec_ok) {
  using L = XLoad<XT>;
  constexpr int VEC = L::VEC;
  constexpr int G = 32 * VEC;
  constexpr int KT = 2 * NP;
  constexpr int N = S_ROWS * KT;  // sums per lane per item, 8 * NP
  constexpr int W = slot_words(B, NP);
  static_assert(B != kF32 || sizeof(XT) == 4, "the fp32 basis takes fp32 x");
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* vs = smem;  // W * ds staged words
  float* part = reinterpret_cast<float*>(smem + W * ds);  // [2][WARPS][N]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.y * KT;
  const int items = (rows + S_ROWS - 1) / S_ROWS;
  const int groups = (d + G - 1) / G;
  const bool whole = ds >= d;  // the basis fits: staged once

  typename L::Raw xr[S_ROWS][S_GB];
  if (whole) {
    stage_cols<B, NP, VEC>(vs, v, k, 0, d, ds, col0);
    __syncthreads();
  }
  int buf = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int r0 = item * S_ROWS;
    float acc[S_ROWS][KT];
#pragma unroll
    for (int r = 0; r < S_ROWS; ++r)
#pragma unroll
      for (int j = 0; j < KT; ++j) acc[r][j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += ds) {
      if (!whole) {
        stage_cols<B, NP, VEC>(vs, v, k, c0, min(ds, d - c0), ds, col0);
        __syncthreads();
      }
      const int g0 = c0 / G;
      const int g1 = min(groups, (c0 + ds) / G);
      for (int g = g0 + (warp - g0 % WARPS + WARPS) % WARPS; g < g1;
           g += WARPS * S_GB) {
        load_batch<XT>(xr, x, r0, rows, d, g, g1, lane, vec_ok);
        fma_batch<XT, B, NP>(acc, xr, vs, g, g0, g1, lane);
      }
    }
    // lanes: halve over 16, 8, 4, then a butterfly over 2 and 1; the lane
    // with bits (4, 3, 2) = (a, b, c) holds sums 8 * NP / 8 * (4a + 2b + c)
    // onward, NP of them
    halve<NP, N, 16>(acc, lane);
    halve<NP, N / 2, 8>(acc, lane);
    halve<NP, N / 4, 4>(acc, lane);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      float& s = acc[i / KT][i % KT];
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
    }
    float* pw = part + (buf * WARPS + warp) * N;
    if ((lane & 3) == 0) {
      const int blk = lane >> 2;  // 4a + 2b + c
#pragma unroll
      for (int i = 0; i < NP; ++i) pw[blk * NP + i] = acc[i / KT][i % KT];
    }
    __syncthreads();
    // warps: one thread per output adds the 8 partials in warp order
    if (threadIdx.x < N) {
      const int r = threadIdx.x / KT, c = col0 + threadIdx.x % KT;
      const float* pb = part + buf * WARPS * N + threadIdx.x;
      float s = pb[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += pb[w * N];
      if (r0 + r < rows && c < k) {
        if constexpr (B == kI8) s *= scale[c];  // once, after the whole d sum
        z[(size_t)(r0 + r) * k + c] = s;
      }
    }
    buf ^= 1;  // the next item writes the other buffer; its barrier orders
               // this item's reads before the item after writes this one
  }
}

// d slots (rows) staged: all of d, rounded up to whole groups, or the
// largest multiple of the group whose `words` words a slot fit `budget`
__host__ __device__ constexpr int split_slots(int d, int words, int group, int budget) {
  return ((d + group - 1) / group) * group <= (budget / words) / group * group
             ? ((d + group - 1) / group) * group
             : (budget / words) / group * group;
}

constexpr size_t split_smem(int np, int ds, int words) {
  return 4 * ((size_t)words * ds + 2 * WARPS * S_ROWS * 2 * np);
}

std::mutex g_occ_lock;

// CTAs of `kern` resident per SM at `smem` dynamic bytes, and the SM count,
// on the current device (queried once per kernel, device and size)
int resident(const void* kern, size_t smem, size_t smem_max, int* sms) {
  static std::map<std::pair<const void*, std::pair<int, size_t>>, std::pair<int, int>>
      cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  std::lock_guard<std::mutex> guard(g_occ_lock);
  const auto key = std::make_pair(kern, std::make_pair(dev, smem));
  auto it = cache.find(key);
  if (it == cache.end()) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_max));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    int per_sm = 0, count = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -static_cast<int>(e);
    if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
    it = cache.emplace(key, std::make_pair(per_sm, count)).first;
  }
  *sms = it->second.second;
  return it->second.first;
}

// The persistent grid (x: CTAs walking items, y: column tiles) and, unless
// `grid_only`, the launch.
template <typename XT, int B, int NP>
int split_run(const void* x, const void* v, const float* scale, float* z,
              int rows, int d, int k, int vec_ok, cudaStream_t s, bool grid_only,
              int* grid_x) {
  constexpr int G = 32 * XLoad<XT>::VEC;
  constexpr int W = slot_words(B, NP);
  const int ds = split_slots(d, W, G, basis_budget(B));
  const size_t smem = split_smem(NP, ds, W);
  const size_t smem_max = split_smem(NP, (basis_budget(B) / W) / G * G, W);
  const void* kern = reinterpret_cast<const void*>(&serve_split_kernel<XT, B, NP>);
  int sms = 0;
  const int per_sm = resident(kern, smem, smem_max, &sms);
  if (per_sm < 0) return -per_sm;
  const int tiles = (k + 2 * NP - 1) / (2 * NP);
  const int items = (rows + S_ROWS - 1) / S_ROWS;
  int gx = per_sm * sms / tiles;
  gx = gx < 1 ? 1 : gx;
  gx = gx < items ? gx : items;
  *grid_x = gx;
  if (grid_only) return 0;
  serve_split_kernel<XT, B, NP><<<dim3(gx, tiles), THREADS, smem, s>>>(
      static_cast<const XT*>(x), v, scale, z, rows, d, k, ds, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// Column pairs per tile: all of k (at most 16 columns) once there are
// S_SPREAD_ITEMS items; below that one pair, so that the column tiles spread
// a small launch over more SMs and each CTA stages 2 columns of the basis.
// Every output is summed in the same order at any tile width.
constexpr int split_np(int rows, int k) {
  return (rows + S_ROWS - 1) / S_ROWS < S_SPREAD_ITEMS
             ? 1
             : ((k + 1) / 2 < MAX_PAIRS ? (k + 1) / 2 : MAX_PAIRS);
}

template <typename XT, int B>
int split_dispatch(const void* x, const void* v, const float* scale, float* z,
                   int rows, int d, int k, int vec_ok, cudaStream_t s,
                   bool grid_only, int* grid_x) {
  const int np = split_np(rows, k);
#define DET_SPLIT_CASE(N)                                                  \
  case N:                                                                  \
    return split_run<XT, B, N>(x, v, scale, z, rows, d, k, vec_ok, s,      \
                               grid_only, grid_x);
  switch (np) {
    DET_SPLIT_CASE(1)
    DET_SPLIT_CASE(2)
    DET_SPLIT_CASE(3)
    DET_SPLIT_CASE(4)
    DET_SPLIT_CASE(5)
    DET_SPLIT_CASE(6)
    DET_SPLIT_CASE(7)
    DET_SPLIT_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DET_SPLIT_CASE
}

template <int B>
int split_by_dtype(const void* x, const void* v, const float* scale, void* z,
                   int rows, int d, int k, int x_dtype, int vec_ok, void* stream,
                   bool grid_only, int* grid_x) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(z);
  if (x_dtype == 0)
    return split_dispatch<float, B>(x, v, scale, out, rows, d, k, vec_ok, s,
                                    grid_only, grid_x);
  if constexpr (B != kF32) {
    if (x_dtype == 1)
      return split_dispatch<uint16_t, B>(x, v, scale, out, rows, d, k, vec_ok, s,
                                         grid_only, grid_x);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (rows, d) contiguous, x_dtype 0 = fp32, 1 = bf16. v: (d, k) fp32
// contiguous. z: (rows, k) fp32. vec_ok: x rows may be read as 16-byte
// vectors (d a multiple of 4 (fp32) or 8 (bf16), x 16-byte aligned).
extern "C" int det_serve_project(const void* x, const void* v, void* z,
                                 int rows, int d, int k, int x_dtype,
                                 int vec_ok, void* stream) {
  int gx = 0;
  return split_by_dtype<kBf16>(x, v, nullptr, z, rows, d, k, x_dtype, vec_ok,
                               stream, false, &gx);
}

// As det_serve_project with q: (d, k) int8 contiguous and scale: (k,) fp32.
extern "C" int det_serve_project_i8(const void* x, const void* q,
                                    const void* scale, void* z, int rows,
                                    int d, int k, int x_dtype, int vec_ok,
                                    void* stream) {
  int gx = 0;
  return split_by_dtype<kI8>(x, q, static_cast<const float*>(scale), z, rows,
                             d, k, x_dtype, vec_ok, stream, false, &gx);
}

// As det_serve_project with fp32 x (rows, d) and fp32 v (d, k), neither
// rounded: x @ v with every row summed in the same order at any row count.
extern "C" int det_serve_project_f32(const void* x, const void* v, void* z,
                                     int rows, int d, int k, int vec_ok,
                                     void* stream) {
  int gx = 0;
  return split_by_dtype<kF32>(x, v, nullptr, z, rows, d, k, 0, vec_ok, stream,
                              false, &gx);
}

// grid.x of the launch det_serve_project (basis 0), det_serve_project_i8
// (basis 1) or det_serve_project_f32 (basis 2, fp32 x only) makes on the
// current device for these shapes; a CUDA error as a negative number.
extern "C" int det_serve_project_grid(int rows, int d, int k, int x_dtype,
                                      int basis) {
  int gx = 0;
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (basis == 0)
    rc = split_by_dtype<kBf16>(nullptr, nullptr, nullptr, nullptr, rows, d, k,
                               x_dtype, 0, nullptr, true, &gx);
  else if (basis == 1)
    rc = split_by_dtype<kI8>(nullptr, nullptr, nullptr, nullptr, rows, d, k,
                             x_dtype, 0, nullptr, true, &gx);
  else if (basis == 2)
    rc = split_by_dtype<kF32>(nullptr, nullptr, nullptr, nullptr, rows, d, k,
                              x_dtype, 0, nullptr, true, &gx);
  return rc != 0 ? -rc : gx;
}
