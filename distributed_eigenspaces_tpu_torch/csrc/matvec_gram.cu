// Fused matvec + Gram of the large-d solver's inner sweep, for Hopper
// (sm_90a):
//   det_matvec_gram : y = C^T v,  w = C y,  g = w^T w      (all fp32)
// C is the (d, f) factor concatenation of the crossover merge (f = m * k),
// v the (d, k') iterate (k' = k + oversample), w (d, k') and g (k', k').
//
// Replaces the TPU kernel distributed_eigenspaces_tpu/ops/pallas_gram.py::
// matvec_gram_pallas (body _matvec_gram_kernel). That kernel ran a
// sequential (2, d / block_d) grid on one core: pass 0 added each block's
// C_blk^T v_blk into an (f, k') VMEM scratch, pass 1 wrote w = C_blk y and
// added w_blk^T w_blk into the resident g block. On Hopper the blocks of a
// launch run in no order on 132 SMs and nothing carries between them, so
// both passes become reductions across blocks. This is one cooperative
// launch (every block resident at once) in four phases, separated by grid
// barriers:
//
//   A. items (slab of d rows, tile of 64 f indices): each writes the
//      partial C_slab^T v_slab of its tile to the workspace;
//   B. y = sum of the slab partials, one warp per entry of y;
//   C. items (64 rows of d): each stages y in shared memory chunk by chunk,
//      writes its rows of w = C y, keeps them in shared memory and writes
//      the upper triangle of their Gram as a partial;
//   D. g = sum of the row partials, one warp per upper entry, mirrored, so
//      g is exactly symmetric.
//
// A warp adds its entry's partials lane by lane in index order and then
// down a fixed xor-shuffle tree, so every sum has an order fixed by
// (d, f, k') alone: no float atomics, and (w, g) is bit-identical from run
// to run, as the sequential TPU kernel's is, whatever the grid size. All
// products are FFMA on fp32 operands (never TF32). Ragged d, f and k' are
// masked (zeros staged, nothing stored), so every shape takes the kernel;
// k' above 64 runs as column chunks of 64 inside each item. Spreading the
// two reductions over every warp matters: a version that left each to the
// last block to finish (threadfence + counter) spent most of its time there,
// one block waiting out the L2 latency once per partial (PERF.md).
//
// What bounds it: at the slice shape (12288, 200, 58) the work is
// 4 d f k' + 2 d k'^2 = 0.653 GFLOP, 9.75 us at 67 TFLOP/s fp32, against
// 25.4 MB of bytes (C twice, v, w) = 7.6 us at 3.35 TB/s: operations, and
// only just, so the launch, the three grid barriers and the load latency of
// each item's staging weigh about as much as the arithmetic. This version
// is a tiled CUDA-core kernel: float4 shared-memory reads into 4 x 4 (and
// 8 x 2) fp32 register tiles, the next chunk of each item loaded into
// registers while the current one is multiplied, no cp.async/TMA and no
// tensor cores; its times are in PERF.md.
//
// C interface: det_matvec_gram_workspace() gives the scratch the caller
// allocates; det_matvec_gram() makes one cooperative launch on the given
// stream, allocates nothing and returns its CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// phase A: an item sums RC rows at a time into an FT x 64 tile (4 f
// indices by 4 columns per thread)
constexpr int A_FT = 64;
constexpr int A_KC = 64;
constexpr int A_RC = 32;
constexpr int A_LOADS = A_RC * A_FT / THREADS;  // staged values per thread
constexpr int A_TARGET_ITEMS = 264;  // two per SM on 132 SMs

// phase C: an item writes R rows of w (8 rows by 2 columns per thread),
// staging FC indices of f at a time
constexpr int C_R = 64;
constexpr int C_TR = 8;
constexpr int C_KC = 64;
constexpr int C_FC = 32;
constexpr int C_CST = C_R + 4;  // row stride of the transposed C tile
constexpr int C_LOADS = C_R * C_FC / THREADS;  // staged values per thread
constexpr int SMEM_MAX = 232448;  // bytes a block may use on Hopper

// each phase stages two tiles of one size, with the same index split
static_assert(A_KC == A_FT && C_KC == C_R, "staged tiles differ in size");

struct Plan {
  int ntile;      // f tiles of phase A
  int nslab;      // d slabs of phase A
  int slab_rows;  // rows per slab (a multiple of A_RC)
  int nblk;       // row items of phase C
  size_t off_part, off_gpart, bytes;  // workspace layout (y first)
  size_t smem;    // dynamic shared memory
};

size_t align256(size_t n) { return (n + 255) / 256 * 256; }
__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

Plan make_plan(int d, int f, int k) {
  Plan p;
  p.ntile = (f + A_FT - 1) / A_FT;
  const int max_slabs = (d + A_RC - 1) / A_RC;
  int nslab = (A_TARGET_ITEMS + p.ntile - 1) / p.ntile;
  nslab = nslab < 1 ? 1 : (nslab > max_slabs ? max_slabs : nslab);
  const int per = (d + nslab - 1) / nslab;
  p.slab_rows = (per + A_RC - 1) / A_RC * A_RC;
  p.nslab = (d + p.slab_rows - 1) / p.slab_rows;  // no empty slab
  p.nblk = (d + C_R - 1) / C_R;
  p.off_part = align256(sizeof(float) * (size_t)f * k);
  p.off_gpart = p.off_part +
                align256(sizeof(float) * (size_t)p.ntile * p.nslab * A_FT * k);
  p.bytes = p.off_gpart + align256(sizeof(float) * (size_t)p.nblk * k * k);
  const size_t smem_a = (size_t)A_RC * (A_FT + A_KC);
  const size_t smem_c = (size_t)C_R * pad4(k) + (size_t)C_FC * (C_CST + C_KC);
  p.smem = sizeof(float) * (smem_a > smem_c ? smem_a : smem_c);
  return p;
}

// The sum of count partials p[0], p[stride], ... in a fixed order: lane by
// lane in index order, then down the xor tree (every lane gets the total).
__device__ __forceinline__ float warp_sum(const float* __restrict__ p,
                                          size_t stride, int count, int lane) {
  float s = 0.f;
  for (int q = lane; q < count; q += 32) s += __ldcg(p + (size_t)q * stride);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// Phase A item: part[t][s] = C[slab s, tile t]^T v[slab s] as (A_FT, k).
// Each chunk of rows is loaded into registers while the previous one is
// multiplied out of shared memory.
__device__ void slab_partial(const float* __restrict__ c,
                             const float* __restrict__ v,
                             float* __restrict__ part, float* smem, int d,
                             int f, int k, int nslab, int slab_rows, int s,
                             int t) {
  float* cs = smem;                 // [A_RC][A_FT]
  float* vsh = smem + A_RC * A_FT;  // [A_RC][A_KC]
  const int tid = threadIdx.x;
  const int tj = tid & 15;  // columns 4 tj .. 4 tj + 3 of the chunk
  const int ti = tid >> 4;  // f indices 4 ti .. 4 ti + 3 of the tile
  const int r_begin = s * slab_rows;
  const int r_end = min(d, r_begin + slab_rows);
  const int f0 = t * A_FT;
  float* my = part + ((size_t)t * nslab + s) * A_FT * k;

  for (int c0 = 0; c0 < k; c0 += A_KC) {
    float acc[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[e][h] = 0.f;
    float rc[A_LOADS], rv[A_LOADS];
    auto load = [&](int r0) {
#pragma unroll
      for (int q = 0; q < A_LOADS; ++q) {
        const int idx = tid + q * THREADS;
        const int rr = idx / A_FT, ii = idx % A_FT;  // A_FT == A_KC
        const int r = r0 + rr, i = f0 + ii, j = c0 + ii;
        rc[q] = (r < r_end && i < f) ? c[(size_t)r * f + i] : 0.f;
        rv[q] = (r < r_end && j < k) ? v[(size_t)r * k + j] : 0.f;
      }
    };
    load(r_begin);
    for (int r0 = r_begin; r0 < r_end; r0 += A_RC) {
      __syncthreads();  // every warp is done with the previous rows
#pragma unroll
      for (int q = 0; q < A_LOADS; ++q) {
        cs[tid + q * THREADS] = rc[q];
        vsh[tid + q * THREADS] = rv[q];
      }
      __syncthreads();
      if (r0 + A_RC < r_end) load(r0 + A_RC);
#pragma unroll 8
      for (int rr = 0; rr < A_RC; ++rr) {
        const float4 a = *reinterpret_cast<const float4*>(cs + rr * A_FT + 4 * ti);
        const float4 b = *reinterpret_cast<const float4*>(vsh + rr * A_KC + 4 * tj);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int h = 0; h < 4; ++h) acc[e][h] = fmaf(av[e], bv[h], acc[e][h]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int il = 4 * ti + e;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = c0 + 4 * tj + h;
        if (j < k) my[(size_t)il * k + j] = acc[e][h];
      }
    }
  }
}

// Phase C item: rows [row0, row0 + C_R) of w = C y, and the upper triangle
// of their Gram as gpart[item]. Each chunk of f is loaded into registers
// while the previous one is multiplied out of shared memory.
__device__ void rows_of_w(const float* __restrict__ c,
                          const float* __restrict__ y, float* __restrict__ w,
                          float* __restrict__ gpart, float* smem, int d, int f,
                          int k, int item) {
  const int kp = pad4(k);              // row stride of ws, for float4 reads
  float* ws = smem;                    // [C_R][kp]: this item's w rows
  float* cst = ws + (size_t)C_R * kp;  // [C_FC][C_CST]: C tile, transposed
  float* ys = cst + C_FC * C_CST;      // [C_FC][C_KC]: y chunk
  const int tid = threadIdx.x;
  const int tc = tid & 31;  // columns tc and tc + 32 of the chunk
  const int tr = tid >> 5;  // rows tr * C_TR .. + C_TR of the item
  const int row0 = item * C_R;

  for (int c0 = 0; c0 < k; c0 += C_KC) {
    float acc[C_TR][2];
#pragma unroll
    for (int e = 0; e < C_TR; ++e) acc[e][0] = acc[e][1] = 0.f;
    float rc[C_LOADS], ry[C_LOADS];
    auto load = [&](int i0) {
#pragma unroll
      for (int q = 0; q < C_LOADS; ++q) {
        const int idx = tid + q * THREADS;
        const int rr = idx / C_FC, ii = idx % C_FC;
        const int r = row0 + rr, i = i0 + ii;
        rc[q] = (r < d && i < f) ? c[(size_t)r * f + i] : 0.f;
        const int yi = i0 + idx / C_KC, yj = c0 + idx % C_KC;
        ry[q] = (yi < f && yj < k) ? y[(size_t)yi * k + yj] : 0.f;
      }
    };
    load(0);
    for (int i0 = 0; i0 < f; i0 += C_FC) {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < C_LOADS; ++q) {
        const int idx = tid + q * THREADS;
        cst[(idx % C_FC) * C_CST + idx / C_FC] = rc[q];
        ys[idx] = ry[q];
      }
      __syncthreads();
      if (i0 + C_FC < f) load(i0 + C_FC);
#pragma unroll 4
      for (int ii = 0; ii < C_FC; ++ii) {
        const float b0 = ys[ii * C_KC + tc];
        const float b1 = ys[ii * C_KC + tc + 32];
        const float4* col =
            reinterpret_cast<const float4*>(cst + ii * C_CST + tr * C_TR);
#pragma unroll
        for (int q = 0; q < C_TR / 4; ++q) {
          const float4 a = col[q];
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[4 * q + e][0] = fmaf(av[e], b0, acc[4 * q + e][0]);
            acc[4 * q + e][1] = fmaf(av[e], b1, acc[4 * q + e][1]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < C_TR; ++e) {
      const int rl = tr * C_TR + e;
      const int r = row0 + rl;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = c0 + tc + 32 * h;
        // columns k .. kp and rows past d hold zeros (zeros were staged)
        if (j < kp) ws[(size_t)rl * kp + j] = acc[e][h];
        if (j < k && r < d) w[(size_t)r * k + j] = acc[e][h];
      }
    }
  }
  __syncthreads();

  // upper triangle of this item's w^T w in 4 x 4 tiles, rows in order
  float* my = gpart + (size_t)item * k * k;
  const int nt = kp / 4;
  for (int tix = tid; tix < nt * nt; tix += THREADS) {
    const int ta = tix / nt, tb = tix - ta * nt;
    if (ta > tb) continue;
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int z = 0; z < 4; ++z) acc[x][z] = 0.f;
#pragma unroll 4
    for (int r = 0; r < C_R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(ws + r * kp + 4 * ta);
      const float4 b = *reinterpret_cast<const float4*>(ws + r * kp + 4 * tb);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int z = 0; z < 4; ++z) acc[x][z] = fmaf(av[x], bv[z], acc[x][z]);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const int a = 4 * ta + x, b = 4 * tb + z;
        if (a < k && b < k && a <= b) my[(size_t)a * k + b] = acc[x][z];
      }
  }
}

// two blocks per SM: at most 128 registers a thread
__global__ void __launch_bounds__(THREADS, 2)
    matvec_gram_kernel(const float* __restrict__ c, const float* __restrict__ v,
                       float* __restrict__ w, float* __restrict__ g,
                       float* __restrict__ y, float* __restrict__ part,
                       float* __restrict__ gpart, int d, int f, int k,
                       int nslab, int slab_rows, int ntile, int nblk) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int nwarp = gridDim.x * WARPS;

  // A. slab partials of C^T v
  for (int it = blockIdx.x; it < nslab * ntile; it += gridDim.x)
    slab_partial(c, v, part, smem, d, f, k, nslab, slab_rows, it % nslab,
                 it / nslab);
  grid.sync();

  // B. y = sum over slabs, slab order
  for (int e = gwarp; e < f * k; e += nwarp) {
    const int i = e / k, j = e - i * k;
    const int t = i / A_FT, il = i - t * A_FT;
    const float* p = part + (size_t)t * nslab * A_FT * k + (size_t)il * k + j;
    const float s = warp_sum(p, (size_t)A_FT * k, nslab, lane);
    if (lane == 0) y[e] = s;
  }
  grid.sync();

  // C. rows of w and their Gram partials
  for (int it = blockIdx.x; it < nblk; it += gridDim.x)
    rows_of_w(c, y, w, gpart, smem, d, f, k, it);
  grid.sync();

  // D. g = sum over row items, item order, mirrored
  for (int e = gwarp; e < k * k; e += nwarp) {
    const int a = e / k, b = e - a * k;
    if (a > b) continue;
    const float s = warp_sum(gpart + e, (size_t)k * k, nblk, lane);
    if (lane == 0) {
      g[(size_t)a * k + b] = s;
      g[(size_t)b * k + a] = s;
    }
  }
}

}  // namespace

// Bytes of scratch det_matvec_gram needs for C (d, f) and v (d, k).
extern "C" size_t det_matvec_gram_workspace(int d, int f, int k) {
  return make_plan(d, f, k).bytes;
}

// c: (d, f) fp32 contiguous. v: (d, k) fp32 contiguous. w: (d, k) fp32.
// g: (k, k) fp32. workspace: det_matvec_gram_workspace(d, f, k) bytes,
// 256-byte aligned.
extern "C" int det_matvec_gram(const void* c, const void* v, void* w, void* g,
                               void* workspace, int d, int f, int k,
                               void* stream) {
  if (d < 1 || f < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(d, f, k);
  if (p.smem > (size_t)SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && p.smem > 48 * 1024)
    err = cudaFuncSetAttribute(matvec_gram_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p.smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, matvec_gram_kernel, THREADS, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // every block resident at once (a cooperative launch's condition); no
  // more blocks than items
  const int items = max(p.nslab * p.ntile, p.nblk);
  const int blocks = min(per_sm * sms, items);

  const float* cf = static_cast<const float*>(c);
  const float* vf = static_cast<const float*>(v);
  float* wf = static_cast<float*>(w);
  float* gf = static_cast<float*>(g);
  char* base = static_cast<char*>(workspace);
  float* y = reinterpret_cast<float*>(base);
  float* part = reinterpret_cast<float*>(base + p.off_part);
  float* gpart = reinterpret_cast<float*>(base + p.off_gpart);
  int dd = d, ff = f, kk = k, nslab = p.nslab, slab_rows = p.slab_rows;
  int ntile = p.ntile, nblk = p.nblk;
  void* args[] = {&cf, &vf, &wf, &gf, &y, &part, &gpart, &dd, &ff, &kk,
                  &nslab, &slab_rows, &ntile, &nblk};
  err = cudaLaunchCooperativeKernel((void*)matvec_gram_kernel,
                                    dim3(blocks), dim3(THREADS), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
