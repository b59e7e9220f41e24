// Batched int8 Gram for Hopper (sm_90a): G[w] = f32(X[w]^T X[w]) / n.
//
// Replaces no Pallas kernel: the JAX package forms the Gram of an int8
// block as an XLA einsum with exact int32 accumulation
// (distributed_eigenspaces_tpu/ops/linalg.py::gram, lines 64-72; its
// gram_auto sends integer blocks there, ops/pallas_gram.py:427-431), then
// converts to fp32 and divides by n. PyTorch has no batched int8 product on
// CUDA (torch.matmul refuses int8, torch._int_mm takes 2-D operands), and
// widening to bf16 with fp32 sums is exact only while a sum stays under
// 2^24 (n <= 1040 rows of +-127), so the port has its own kernels. The
// caller guards n * 127^2 < 2^31, as the reference does, so the int32
// sums are exact; each is converted to fp32 once (round to nearest) and
// divided by `divisor` with a true division: bit for bit the reference's
// .astype(float32) / n.
//
// Both operands of the product are columns of the block, and the
// contraction runs over n, the strided axis of the row-major (n, d) block.
// wgmma, like the warp-level products, takes s8 operands K-major only: its
// transpose bits exist for 16-bit types alone. So one call makes two
// launches on one stream (det_gram_s8):
//
//   gram_s8_transpose_kernel<VEC> writes X^T, (m, d, n_pad) int8 with
//     n_pad = ceil(n / 16) * 16, into a scratch the caller allocates. A CTA
//     moves a 128 (n) x 128 (d) tile through shared memory: 16-byte loads
//     along d (VEC = 16, d % 16 == 0 on a 16-byte aligned base) or byte
//     loads (VEC = 1), then each thread gathers 16 rows x 4 columns as
//     32-bit words, transposes its 4 x 4 byte squares with __byte_perm and
//     stores 16 bytes along n for each of its 4 columns; a warp's stores
//     are 4 rows x 128 contiguous bytes. The word columns of a row are
//     XOR-swizzled by (row / 16) so that both the row-wise stores and the
//     column-wise gathers hit 32 banks. Rows from n to n_pad are written as
//     zeros (the scratch comes from torch.empty). The row stride n_pad is a
//     multiple of 16 bytes, so TMA can read X^T for every int8 shape.
//     Bound: 2 m n d bytes, 50 MB at the CIFAR-10 block (0.015 ms at 3.35
//     TB/s), paid once where transposing in each CTA's shared memory would
//     repeat it for every item that reads the slab (~24 times at d = 3072).
//   gram_s8_tma_kernel is gram_bf16_tma_kernel's skeleton (csrc/gram.cu)
//     with s8 operands. An item is two neighbouring upper-triangle tiles of
//     one tile row, 128 x 256 entries. The grid is persistent (as many CTAs
//     as stay resident, one per SM), each walking the (worker, item) list
//     with stride gridDim.x. A producer warpgroup (one thread issuing;
//     setmaxnreg hands its registers to the consumers) keeps a ring of
//     S_STAGES stages full with TMA: per stage the 128 rows i0.. and the 256
//     rows j0.. of X^T over S_BK = 128 bytes of n, as (128 n, 128 d) boxes
//     in the 128-byte swizzle, zero-filled past d and n_pad, completion
//     counted on an mbarrier (full), release on another (empty). A diagonal
//     item's rows i0.. are the first half of its rows j0..: not loaded
//     twice. Two consumer warpgroups each own 64 rows of the item and run
//     wgmma.mma_async m64n256k32 s8 x s8 -> s32 with both descriptors
//     K-major (four k32 steps of 32 bytes inside each 128-byte swizzle
//     row), one stage of products in flight while the next is awaited.
//     The epilogue converts (__int2float_rn) and divides (__fdiv_rn, or the
//     exact multiplication by 1 / divisor when divisor is a power of two,
//     which gives the same bits), writes each 64 x 32 chunk of a
//     warpgroup's rows and its mirror into shared memory, and one thread
//     stores them with TMA while the warpgroup goes on to the next item
//     (shapes with d % 4 != 0, whose rows are no 16-byte strides, store
//     from registers). int32 sums are exact, so the diagonal tile is
//     symmetric in any order: it is stored whole, and without a mirror.
//
// What bounds it: at the CIFAR-10 shape (8, 1024, 3072) the fp32 output,
// 302 MB written once (0.090 ms at 3.35 TB/s), against 25 MB of int8 input
// and 7.7e10 distinct int8 operations (0.039 ms at 1,979 TOPS dense): the
// pair's bound is 0.0977 ms (bytes). At (8, 2048, 1024) the 50 MB of input
// and output (0.015 ms). On an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/torch_profile_gram_s8.py, PERF.md) the pair takes ~0.16 ms at
// CIFAR: the transpose ~0.019, the products and loads alone ~0.045 (near
// the operations' 0.039), the epilogue's conversion and staging ~0.045
// more, and the stores the rest, which the warpgroups no longer wait for
// but which then bound the kernel with the epilogue that feeds them: one
// CTA per SM, and a warpgroup's accumulators are not free for the next
// item before they are staged. Stores from registers measured ~0.015 ms
// slower, IEEE division of every entry ~0.02, the normal L2 policies ~0.015,
// four stages with one staging buffer per warpgroup ~0.003.
//
// C interface: det_gram_s8(...) launches both kernels on the given stream
// (det_gram_s8_transpose the first alone), allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue when the TMA descriptor
// cannot be built); det_gram_s8_grid returns the grid.x of the TMA
// kernel's launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <map>
#include <mutex>
#include <utility>

namespace {

// gram_s8_transpose_kernel
constexpr int X_TILE = 128;     // n rows x d columns of x per CTA
constexpr int X_THREADS = 256;  // 16 rows x 4 columns of the tile each
constexpr int X_SMEM_BYTES = X_TILE * X_TILE;  // static: the tile
constexpr int S_PAD = 16;       // X^T's rows are padded to a multiple of 16 bytes

// gram_s8_tma_kernel: an item is two neighbouring tiles of a tile row,
// (bi, bj) and (bi, bj + 1), 128 x 256 outputs
constexpr int S_TILE = 128;       // output tile edge, in d indices
constexpr int S_BK = 128;         // bytes of n per stage: four k32 steps
constexpr int S_STAGES = 3;       // stages in the ring
constexpr int S_CONSUMERS = 2;    // warpgroups, 64 item rows each
constexpr int S_THREADS = 128 * (S_CONSUMERS + 1);  // and a producer warpgroup
constexpr int S_BOX_BYTES = S_TILE * S_BK;          // 16 KB: 128 d rows x 128 n bytes
constexpr int S_A_BYTES = S_BOX_BYTES;              // rows i0..: 128
constexpr int S_B_BYTES = 2 * S_BOX_BYTES;          // rows j0..: 256
constexpr int S_STAGE_BYTES = S_A_BYTES + S_B_BYTES;
// the epilogue's staging (TMA stores): per consumer warpgroup S_EPI_BUFS
// buffers, each a 64 x 32 chunk of its rows and the chunk's mirror, as four
// (32, 32) fp32 boxes in the 128-byte swizzle
constexpr int S_EPI_BOX = 32;                        // fp32 box edge: 128-byte rows
constexpr int S_EPI_BOX_BYTES = S_EPI_BOX * S_EPI_BOX * 4;  // 4 KB
constexpr int S_EPI_BUF_BYTES = 4 * S_EPI_BOX_BYTES;        // direct 2 + mirror 2
constexpr int S_EPI_BUFS = 2;
constexpr int S_EPI_BYTES = S_CONSUMERS * S_EPI_BUFS * S_EPI_BUF_BYTES;
constexpr int S_SMEM_BYTES = S_STAGES * S_STAGE_BYTES + S_EPI_BYTES + 2 * S_STAGES * 8 + 1024;

// -- gram_s8_transpose_kernel -------------------------------------------------

// The 4 x 4 byte transpose: r[i] holds 4 bytes of row i (byte u: column
// u); on return r[u] holds column u, byte i from row i.
__device__ __forceinline__ void transpose4(uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// Word of the tile holding columns 4 c .. 4 c + 3 of row r: a row is 32
// words in 8 chunks of 16 bytes, chunk q stored at chunk q ^ (r / 16) % 8.
__device__ __forceinline__ int tile_word(int r, int c) {
  return r * (X_TILE / 4) + (((c >> 2) ^ (r >> 4)) & 7) * 4 + (c & 3);
}

// CTA (bx, by, w): rows [128 bx, 128 bx + 128) of n and columns [128 by,
// 128 by + 128) of d of worker w, into X^T[w][d][n] (rows of n_pad bytes).
template <int VEC>
__global__ void __launch_bounds__(X_THREADS)
    gram_s8_transpose_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ xt, int n,
                             int d, int n_pad) {
  __shared__ __align__(16) uint32_t tile[X_TILE * X_TILE / 4];
  const int r0 = blockIdx.x * X_TILE, c0 = blockIdx.y * X_TILE;
  const int8_t* xw = x + (size_t)blockIdx.z * n * d;
  int8_t* tw = xt + (size_t)blockIdx.z * d * n_pad;
  const int tid = threadIdx.x;

  // 128 rows x 8 chunks of 16 bytes, four chunks a thread; zeros past n
  // and d (with VEC = 16, d % 16 == 0: a chunk lies wholly inside or past d)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = q * X_THREADS + tid;
    const int r = e >> 3, ch = e & 7;
    const int gr = r0 + r, gc = c0 + 16 * ch;
    uint4 v = make_uint4(0, 0, 0, 0);
    if constexpr (VEC == 16) {
      if (gr < n && gc < d) v = *reinterpret_cast<const uint4*>(xw + (size_t)gr * d + gc);
    } else {
      uint32_t wv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t word = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = gc + 4 * k + u;
          const uint32_t b =
              (gr < n && col < d) ? (uint32_t)(uint8_t)xw[(size_t)gr * d + col] : 0u;
          word |= b << (8 * u);
        }
        wv[k] = word;
      }
      v = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
    *reinterpret_cast<uint4*>(&tile[tile_word(r, 4 * ch)]) = v;
  }
  __syncthreads();

  // thread (j, c): rows 16 j .. 16 j + 15, columns 4 c .. 4 c + 3; a warp
  // holds one c >> 2 and all eight j, so its gathers hit 32 banks
  const int j = tid & 7, c = tid >> 3;
  uint32_t col[4][4];  // [column u][word q: rows 16 j + 4 q .. + 3]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t sq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sq[i] = tile[tile_word(16 * j + 4 * q + i, c)];
    transpose4(sq);
#pragma unroll
    for (int u = 0; u < 4; ++u) col[u][q] = sq[u];
  }
  const int gn = r0 + 16 * j;
  if (gn < n_pad) {  // n_pad % 16 == 0: 16 bytes lie wholly inside or past it
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gd = c0 + 4 * c + u;
      if (gd < d)
        *reinterpret_cast<uint4*>(tw + (size_t)gd * n_pad + gn) =
            make_uint4(col[u][0], col[u][1], col[u][2], col[u][3]);
    }
  }
}

// -- gram_s8_tma_kernel -------------------------------------------------------

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

// L2 policies: X^T is read again by every item of its rows (evict_last),
// G is written once and streams through (evict_first)
__device__ __forceinline__ uint64_t policy_keep() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_stream() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// one (S_BK, S_TILE) box of X^T at (n, d, worker) = (c0, c1, c2) into
// shared memory, counted on `bar`, under L2 policy `pol`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "l"(pol)
      : "memory");
}

// one (S_EPI_BOX, S_EPI_BOX) box of shared memory to G at (column, row,
// worker) = (c0, c1, c2) under L2 policy `pol`; what lies past d is not
// written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3, %4}], [%1], %5;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the bulk stores committed before the last N groups have read their
// shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// every committed bulk store has written global memory
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's writes to shared memory, seen by the bulk copies
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of one consumer warpgroup (barrier 1 + wg; 0 is
// __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// byte offset of fp32 element (row, col) in a (32, 32) box in the 128-byte
// swizzle: the 16-byte chunk col / 4 of a row sits at chunk col / 4 ^ row % 8
__device__ __forceinline__ uint32_t epi_offset(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// G's entry from its int32 sum, as the reference computes it: one rounding
// to fp32, then an IEEE division by `divisor`. By a power of two (`scale`
// = 1 / divisor, exact; 0 otherwise) the division is that multiplication:
// neither rounds, so the bits are the same, without the division's
// instruction sequence.
__device__ __forceinline__ float entry(int acc, float divisor, float scale) {
  const float x = __int2float_rn(acc);
  return scale != 0.f ? __fmul_rn(x, scale) : __fdiv_rn(x, divisor);
}

// A shared-memory matrix descriptor for wgmma: a K-major operand in the
// 128-byte swizzle, one 128-byte row of K per row of M (or N), 8-row groups
// 1024 bytes apart (SBO); LBO is not read for a swizzled K-major operand
// whose K step (32 bytes) lies inside one swizzle row (set to 1).
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
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
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 256, s32) += A (64 x 32) B (32 x 256), s8, both operands K-major
// in shared memory
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// TMA_STORE: the epilogue stages its entries in shared memory and writes
// them with TMA stores (out_map; needs d % 4 == 0, 16-byte row strides);
// otherwise it stores from registers
template <bool TMA_STORE>
__global__ void __launch_bounds__(S_THREADS, 1)
    gram_s8_tma_kernel(__grid_constant__ const CUtensorMap xt_map,
                       __grid_constant__ const CUtensorMap out_map, float* __restrict__ out,
                       int m, int n_pad, int d, float divisor, float scale) {
  extern __shared__ __align__(1024) unsigned char tma_smem[];
  // the swizzled boxes need 1024-byte alignment
  const uint32_t raw = smem_u32(tma_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t stages = base;  // [S_STAGES][rows i0, rows j0]
  const uint32_t epi = base + S_STAGES * S_STAGE_BYTES;  // [S_CONSUMERS][S_EPI_BUFS]
  const uint32_t bars = epi + S_EPI_BYTES;  // full, empty
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S_STAGES + s); };

  const int tiles = (d + S_TILE - 1) / S_TILE;
  const int per_worker = worker_items(tiles);
  const int total = m * per_worker;
  const int ktiles = (n_pad + S_BK - 1) / S_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * S_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * S_CONSUMERS) {  // the producer warpgroup
    // one thread issues the loads: the warpgroup hands its registers over
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * S_CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int w = t / per_worker;
        int bi, bj;
        item_coords(t - w * per_worker, tiles, bi, bj);
        const int i0 = bi * S_TILE, j0 = bj * S_TILE;
        // a box wholly past d is not loaded: its stale rows meet only
        // entries past d, which are never stored
        const int a_boxes = bi == bj ? 0 : 1;
        const int b_boxes = 1 + (j0 + S_TILE < d);
        const uint64_t keep = policy_keep();
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t bar = full(stage);
          mbar_expect_tx(bar, (a_boxes + b_boxes) * S_BOX_BYTES);
          const uint32_t a = stages + stage * S_STAGE_BYTES;
          const int col = kt * S_BK;
          if (a_boxes) tma_load(a, &xt_map, bar, col, i0, w, keep);
          for (int q = 0; q < b_boxes; ++q)
            tma_load(a + S_A_BYTES + q * S_BOX_BYTES, &xt_map, bar, col, j0 + q * S_TILE, w,
                     keep);
          if (++stage == S_STAGES) {
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
  const bool pairs = (d & 1) == 0;  // float2 stores stay 8-byte aligned
  const bool leader = (threadIdx.x & 127) == 0;  // issues the warpgroup's TMA stores
  int chunks = 0;  // staged chunks so far: buffer chunks % S_EPI_BUFS is next
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int w = t / per_worker;
    int bi, bj;
    item_coords(t - w * per_worker, tiles, bi, bj);
    const int i0 = bi * S_TILE, j0 = bj * S_TILE;
    const bool diag = bi == bj;

    int acc[128];  // this warpgroup's 64 rows, all 256 columns
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full(stage), phase);
      const uint32_t b = stages + stage * S_STAGE_BYTES + S_A_BYTES;
      const uint32_t a = (diag ? b : b - S_A_BYTES) + wg * 64 * S_BK;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < S_BK / 32; ++kk)
        wgmma_m64n256k32_s8(acc, kmajor_sw128_desc(a + kk * 32),
                            kmajor_sw128_desc(b + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done with it
      if (prev >= 0) mbar_arrive(empty(prev));
      prev = stage;
      if (++stage == S_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    mbar_arrive(empty(prev));
    fence_acc(acc);

    if constexpr (TMA_STORE) {
      // epilogue through shared memory, 64 x 32 chunks: accumulator i of
      // this thread is entry (r, c) of the warpgroup's rows, written into
      // the chunk's direct box (row r, column c) and, off the diagonal
      // tile, its mirror box (row c, column r); the leader thread stores
      // the boxes with TMA and the warpgroup goes on to the next item
      // while they are written. The diagonal tile of a diagonal item (its
      // first 128 columns) holds both (r, c) and (c, r): no mirror.
      const int r0 = i0 + wg * 64;
      const int rl = warp * 16 + (lane >> 2);  // row in the warpgroup's 64
      if (r0 < d) {
#pragma unroll
        for (int q = 0; q < 2 * S_TILE / S_EPI_BOX; ++q) {
          const int c0 = j0 + q * S_EPI_BOX;
          if (c0 >= d) break;
          const bool mirror = !(diag && q < S_TILE / S_EPI_BOX);
          const uint32_t buf = epi + (wg * S_EPI_BUFS + chunks % S_EPI_BUFS) * S_EPI_BUF_BYTES;
          if (leader) bulk_wait_read<S_EPI_BUFS - 1>();  // the buffer's last stores read it
          wg_sync(wg);
          // this thread's 16 entries of the chunk (accumulators 16 q ..), the
          // division's branch taken once for all of them
          float v[16];
          if (scale != 0.f) {
#pragma unroll
            for (int j = 0; j < 16; ++j) v[j] = __fmul_rn(__int2float_rn(acc[16 * q + j]), scale);
          } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) v[j] = __fdiv_rn(__int2float_rn(acc[16 * q + j]), divisor);
          }
#pragma unroll
          for (int j = 0; j < 16; j += 2) {
            const int r = rl + 8 * ((j >> 1) & 1);
            const int c = 8 * (j >> 2) + 2 * (lane & 3);  // column in the chunk
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                             buf + (r >> 5) * S_EPI_BOX_BYTES + epi_offset(r & 31, c)),
                         "f"(v[j]), "f"(v[j + 1])
                         : "memory");
          }
          if (mirror) {
#pragma unroll
            for (int j = 0; j < 16; j += 2) {
              const int r = rl + 8 * ((j >> 1) & 1);
              const int c = 8 * (j >> 2) + 2 * (lane & 3);
              const uint32_t mbox = buf + (2 + (r >> 5)) * S_EPI_BOX_BYTES;
              asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(mbox + epi_offset(c, r & 31)),
                           "f"(v[j])
                           : "memory");
              asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(mbox + epi_offset(c + 1, r & 31)),
                           "f"(v[j + 1])
                           : "memory");
            }
          }
          fence_async_smem();
          wg_sync(wg);
          if (leader) {
            const uint64_t stream = policy_stream();
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rh = r0 + h * S_EPI_BOX;
              if (rh >= d) break;
              tma_store(&out_map, buf + h * S_EPI_BOX_BYTES, c0, rh, w, stream);
              if (mirror) tma_store(&out_map, buf + (2 + h) * S_EPI_BOX_BYTES, rh, c0, w, stream);
            }
            bulk_commit();
          }
          ++chunks;
        }
      }
    } else {
      // epilogue from registers (rows of G that TMA cannot write, d % 4 !=
      // 0): accumulator i of this thread is G[w] entry (r, c), stored with
      // its mirror (c, r) but in the diagonal tile of a diagonal item
      float* g = out + (size_t)w * d * d;
      const int rbase = i0 + wg * 64 + warp * 16 + (lane >> 2);
      const int cbase = j0 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 128; i += 2) {
        const int r = rbase + 8 * ((i >> 1) & 1);
        const int c = cbase + 8 * (i >> 2);
        if (r >= d || c >= d) continue;
        const float v0 = entry(acc[i], divisor, scale);
        const float v1 = entry(acc[i + 1], divisor, scale);
        const bool c1 = c + 1 < d;
        float* row = g + (size_t)r * d + c;
        if (c1 && pairs) {
          *reinterpret_cast<float2*>(row) = make_float2(v0, v1);
        } else {
          row[0] = v0;
          if (c1) row[1] = v1;
        }
        if (!(diag && i < 64)) {
          g[(size_t)c * d + r] = v0;
          if (c1) g[(size_t)(c + 1) * d + r] = v1;
        }
      }
    }
  }
  if (TMA_STORE && leader) bulk_wait_all();  // the shared memory outlives the stores
}

// -- host ---------------------------------------------------------------------

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

// the tensor map of X^T: (n_pad, d, m) bytes, rows of n_pad, boxes of
// (S_BK, S_TILE, 1) in the 128-byte swizzle, zero-filled past n_pad and d
bool encode_xt(CUtensorMap* map, const void* xt, int n_pad, int d, int m) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n_pad, (cuuint64_t)d, (cuuint64_t)m};
  const cuuint64_t strides[2] = {(cuuint64_t)n_pad, (cuuint64_t)d * n_pad};
  const cuuint32_t box[3] = {S_BK, S_TILE, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(xt), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensor map of G: (d, d, m) fp32, rows of d, boxes of (S_EPI_BOX,
// S_EPI_BOX, 1) in the 128-byte swizzle; needs d % 4 == 0
bool encode_out(CUtensorMap* map, const void* out, int d, int m) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)d, (cuuint64_t)m};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)d * d * 4};
  const cuuint32_t box[3] = {S_EPI_BOX, S_EPI_BOX, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(out), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

std::mutex g_occ_lock;

// CTAs of gram_s8_tma_kernel resident per SM, and the SM count, on the
// current device (queried once per device); a CUDA error as a negative
int tma_resident(int* sms) {
  static std::map<int, std::pair<int, int>> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  std::lock_guard<std::mutex> guard(g_occ_lock);
  auto it = cache.find(dev);
  if (it == cache.end()) {
    // both instances: the same threads and shared memory
    e = cudaFuncSetAttribute(gram_s8_tma_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gram_s8_tma_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM_BYTES);
    int per_sm = 0, count = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_s8_tma_kernel<true>,
                                                        S_THREADS, S_SMEM_BYTES);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
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
  const long long total = (long long)m * worker_items((d + S_TILE - 1) / S_TILE);
  const long long gx = (long long)per_sm * sms;
  return static_cast<int>(gx < total ? gx : total);
}

// 16-byte loads: every row of x 16-byte aligned
bool transpose_vec(int d, int aligned) { return aligned && d % 16 == 0; }

// TMA stores: rows of G 16-byte aligned
bool tma_store_rows(int d) { return d % 4 == 0; }

template <int VEC>
int launch_transpose(const int8_t* x, int8_t* xt, int m, int n, int d, int n_pad,
                     cudaStream_t s) {
  const dim3 grid((n_pad + X_TILE - 1) / X_TILE, (d + X_TILE - 1) / X_TILE, m);
  gram_s8_transpose_kernel<VEC><<<grid, X_THREADS, 0, s>>>(x, xt, n, d, n_pad);
  return static_cast<int>(cudaGetLastError());
}

// 1 / divisor where divisor is a power of two (the reciprocal is exact),
// else 0
float exact_reciprocal(float divisor) {
  int e = 0;
  return divisor > 0.f && std::frexp(divisor, &e) == 0.5f ? 1.f / divisor : 0.f;
}

int launch_tma(const int8_t* xt, float* out, int m, int n_pad, int d, float divisor,
               cudaStream_t s) {
  const float scale = exact_reciprocal(divisor);
  const int gx = tma_grid(m, d);
  if (gx < 0) return -gx;
  CUtensorMap xt_map, out_map;
  if (!encode_xt(&xt_map, xt, n_pad, d, m)) return static_cast<int>(cudaErrorInvalidValue);
  if (tma_store_rows(d)) {
    if (!encode_out(&out_map, out, d, m)) return static_cast<int>(cudaErrorInvalidValue);
    gram_s8_tma_kernel<true><<<gx, S_THREADS, S_SMEM_BYTES, s>>>(xt_map, out_map, out, m, n_pad,
                                                                 d, divisor, scale);
  } else {
    gram_s8_tma_kernel<false><<<gx, S_THREADS, S_SMEM_BYTES, s>>>(xt_map, xt_map, out, m, n_pad,
                                                                  d, divisor, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, n, d) int8, contiguous. xt: (m, d, n_pad) int8, 16-byte aligned,
// n_pad = ceil(n / 16) * 16. aligned: x is 16-byte aligned. Launches
// gram_s8_transpose_kernel<transpose_vec(d, aligned) ? 16 : 1> alone.
extern "C" int det_gram_s8_transpose(const void* x, void* xt, int m, int n, int d, int aligned,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* xti = static_cast<int8_t*>(xt);
  const int n_pad = (n + S_PAD - 1) / S_PAD * S_PAD;
  return transpose_vec(d, aligned) ? launch_transpose<16>(xi, xti, m, n, d, n_pad, s)
                                   : launch_transpose<1>(xi, xti, m, n, d, n_pad, s);
}

// x, xt, aligned: as above. out: (m, d, d) fp32, 16-byte aligned. divisor:
// n for the normalized Gram, 1 otherwise. The caller keeps n * 127^2 <
// 2^31 (exact int32 sums). Launches the transpose, then gram_s8_tma_kernel.
extern "C" int det_gram_s8(const void* x, void* xt, void* out, int m, int n, int d,
                           float divisor, int aligned, void* stream) {
  const int rc = det_gram_s8_transpose(x, xt, m, n, d, aligned, stream);
  if (rc != 0) return rc;
  const int n_pad = (n + S_PAD - 1) / S_PAD * S_PAD;
  return launch_tma(static_cast<const int8_t*>(xt), static_cast<float*>(out), m, n_pad, d,
                    divisor, static_cast<cudaStream_t>(stream));
}

// grid.x of the TMA kernel's launch det_gram_s8 makes on the current device
// (a CUDA error as a negative number)
extern "C" int det_gram_s8_grid(int m, int d) { return tma_grid(m, d); }
