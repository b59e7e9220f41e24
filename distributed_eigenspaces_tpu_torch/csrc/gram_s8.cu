// Batched int8 Gram kernel for Hopper (sm_90a): G[w] = f32(X[w]^T X[w]) / n.
//
// Replaces no Pallas kernel: the JAX package forms the Gram of an int8
// block as an XLA einsum with exact int32 accumulation
// (distributed_eigenspaces_tpu/ops/linalg.py::gram, lines 64-72; its
// gram_auto sends integer blocks there, ops/pallas_gram.py:427-431), then
// converts to fp32 and divides by n. PyTorch has no batched int8 product on
// CUDA (torch.matmul refuses int8, torch._int_mm takes 2-D operands), and
// widening to bf16 with fp32 sums is exact only while a sum stays under
// 2^24 (n <= 1040 rows of +-127), so the port has its own kernel. The
// caller guards n * 127^2 < 2^31, as the reference does, so the int32
// sums are exact; each is converted to fp32 once (round to nearest) and
// divided by `divisor` with a true division: bit for bit the reference's
// .astype(float32) / n.
//
// Design (simple first): one CTA per upper-triangle 128 x 128 tile (bi <=
// bj) of worker blockIdx.z, eight warps of 64 x 32 outputs each, int32
// accumulators in registers, mma.sync.m16n8k32 s8 x s8 -> s32 on the
// tensor cores. Both operands are columns of the block and the contraction
// runs over n, the strided axis of the row-major (n, d) block, while
// mma.sync (and wgmma) take s8 operands K-major only: ldmatrix.trans and
// the wgmma descriptor's transpose handle 16-bit elements. So the block is
// transposed on its way into shared memory. Each thread loads 4 rows x 16
// columns of one slab (four 16-byte loads, or 64 masked byte loads when
// d % 16 != 0 or the base is not 16-byte aligned), transposes each 4 x 4
// byte square with __byte_perm, and stores one 32-bit word per column: 4
// consecutive rows of n. In shared memory a slab is 128 columns x 64 rows
// (S_BK), 64 bytes a column in four 16-byte chunks; chunk c of column j
// sits at chunk c ^ ((j >> 1) ^ (j >> 4)) & 3, so a warp's fragment reads
// (8 columns x 4 words) hit 32 banks and its stores 16. Two stages: the
// next stage's global loads are issued into registers before the current
// stage's products, and stored after them (one barrier a stage). Rows past
// n and columns past d load as zeros. The epilogue converts, divides and
// stores each entry and its mirror from registers; a diagonal tile stores
// its upper triangle and the mirror of it, so the output is exactly
// symmetric.
//
// What bounds it: at the CIFAR-10 shape (8, 1024, 3072) the fp32 output,
// 302 MB written once (0.090 ms at 3.35 TB/s), against 25 MB of int8 input
// and 7.7e10 distinct int8 operations (0.039 ms at 1,979 TOPS dense); at
// (8, 2048, 1024) the 50 MB of input and output (0.015 ms). This kernel
// does not overlap its epilogue with loads, and mma.sync does not reach
// wgmma's rate: it is the simple version, to be redesigned.
//
// C interface: det_gram_s8(...) launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S_TILE = 128;      // output tile edge, in d indices
constexpr int S_BK = 64;         // rows of X (n) per stage: two k32 steps
constexpr int S_THREADS = 256;   // eight warps: 2 x 4 warps of 64 x 32 outputs
constexpr int S_STAGES = 2;      // stages of shared memory
constexpr int S_SLAB_WORDS = S_TILE * S_BK / 4;  // one slab: 128 columns x 64 rows
constexpr int S_SMEM_BYTES = S_STAGES * 2 * S_SLAB_WORDS * 4;  // static, 32 KB

// Linear index over the upper triangle of a tiles x tiles grid -> (bi, bj)
// with bi <= bj.
__device__ __forceinline__ void tile_coords(int p, int tiles, int& bi, int& bj) {
  int i = 0;
  while (p >= tiles - i) {
    p -= tiles - i;
    ++i;
  }
  bi = i;
  bj = i + p;
}

// Word of a slab holding rows 4 w .. 4 w + 3 (w < 16) of column j.
__device__ __forceinline__ int slab_word(int j, int w) {
  const int chunk = (w >> 2) ^ (((j >> 1) ^ (j >> 4)) & 3);
  return j * (S_BK / 4) + chunk * 4 + (w & 3);
}

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

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// VEC = 16: 16-byte loads (d % 16 == 0 on a 16-byte aligned base, so a
// load lies wholly inside or wholly past d); VEC = 1: byte loads.
template <int VEC>
__global__ void __launch_bounds__(S_THREADS, 2)
    gram_s8_kernel(const int8_t* __restrict__ x, float* __restrict__ out, int n, int d,
                   float divisor) {
  __shared__ __align__(16) uint32_t sm[S_STAGES][2][S_SLAB_WORDS];

  const int tiles = (d + S_TILE - 1) / S_TILE;
  int bi, bj;
  tile_coords(blockIdx.x, tiles, bi, bj);
  const int i0 = bi * S_TILE, j0 = bj * S_TILE;
  const bool diag = bi == bj;  // slab j is slab i: loaded once
  const int8_t* xw = x + (size_t)blockIdx.z * n * d;
  float* ow = out + (size_t)blockIdx.z * d * d;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates

  // this thread's share of a stage: slab `half` (0: columns i0.., 1: j0..),
  // rows 4 rg .. 4 rg + 3 and columns 16 cg .. 16 cg + 15 of it
  const int half = tid >> 7, rg = (tid >> 3) & 15, cg = tid & 7;
  const bool loader = !(diag && half);
  const int gcol = (half ? j0 : i0) + 16 * cg;
  uint32_t reg[4][4];  // [row][4 columns], one stage's prefetch

  auto load = [&](int kt) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int row = kt * S_BK + 4 * rg + rr;
      const int8_t* src = xw + (size_t)row * d + gcol;
      if constexpr (VEC == 16) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (loader && row < n && gcol < d) v = *reinterpret_cast<const uint4*>(src);
        reg[rr][0] = v.x, reg[rr][1] = v.y, reg[rr][2] = v.z, reg[rr][3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t w = 0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int col = gcol + 4 * q + u;
            const uint32_t b =
                (loader && row < n && col < d) ? (uint32_t)(uint8_t)src[4 * q + u] : 0u;
            w |= b << (8 * u);
          }
          reg[rr][q] = w;
        }
      }
    }
  };

  auto store = [&](int stage) {
    if (!loader) return;
    uint32_t* slab = sm[stage][half];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t sq[4] = {reg[0][q], reg[1][q], reg[2][q], reg[3][q]};
      transpose4(sq);
#pragma unroll
      for (int u = 0; u < 4; ++u) slab[slab_word(16 * cg + 4 * q + u, rg)] = sq[u];
    }
  };

  int acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0;

  const int wr = (warp >> 2) * 64, wc = (warp & 3) * 32;  // the warp's outputs
  const int ktiles = (n + S_BK - 1) / S_BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < ktiles) load(kt + 1);
    const uint32_t* A = sm[stage][0];
    const uint32_t* B = diag ? A : sm[stage][1];
#pragma unroll
    for (int ks = 0; ks < S_BK / 32; ++ks) {
      // fragment words: rows 32 ks + 4 t.. (w0) and 32 ks + 16 + 4 t.. (w1)
      const int w0 = 8 * ks + t, w1 = 8 * ks + 4 + t;
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wc + 8 * nt + g;
        bf[nt][0] = B[slab_word(c, w0)];
        bf[nt][1] = B[slab_word(c, w1)];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wr + 16 * mt + g;
        const uint32_t a0 = A[slab_word(r, w0)], a1 = A[slab_word(r + 8, w0)];
        const uint32_t a2 = A[slab_word(r, w1)], a3 = A[slab_word(r + 8, w1)];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a0, a1, a2, a3, bf[nt][0], bf[nt][1]);
      }
    }
    if (kt + 1 < ktiles) store(stage ^ 1);
    __syncthreads();
  }

  // epilogue, from registers: fragment e of (mt, nt) is entry (r, c) with
  // r = wr + 16 mt + g + 8 (e >> 1), c = wc + 8 nt + 2 t + (e & 1); it is
  // stored at (r, c) and at (c, r). In a diagonal tile only r <= c stores.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + 16 * mt + g + 8 * (e >> 1), c = wc + 8 * nt + 2 * t + (e & 1);
        const int gr = i0 + r, gc = j0 + c;
        if ((diag && r > c) || gr >= d || gc >= d) continue;
        const float v = __int2float_rn(acc[mt][nt][e]) / divisor;
        ow[(size_t)gr * d + gc] = v;
        if (gr != gc) ow[(size_t)gc * d + gr] = v;
      }
}

template <int VEC>
int launch_s8(const int8_t* x, float* out, int m, int n, int d, float divisor,
              cudaStream_t s) {
  const int tiles = (d + S_TILE - 1) / S_TILE;
  const dim3 grid(tiles * (tiles + 1) / 2, 1, m);
  gram_s8_kernel<VEC><<<grid, S_THREADS, 0, s>>>(x, out, n, d, divisor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, n, d) int8, contiguous. out: (m, d, d) fp32. divisor: n for the
// normalized Gram, 1 otherwise. aligned: x is 16-byte aligned. The caller
// keeps n * 127^2 < 2^31 (exact int32 sums). d % 16 == 0 on an aligned base
// takes gram_s8_kernel<16>, anything else gram_s8_kernel<1>.
extern "C" int det_gram_s8(const void* x, void* out, int m, int n, int d, float divisor,
                           int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  float* of = static_cast<float*>(out);
  if (aligned && d % 16 == 0) return launch_s8<16>(xi, of, m, n, d, divisor, s);
  return launch_s8<1>(xi, of, m, n, d, divisor, s);
}
