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
// barriers. d is cut into SLABS slabs of contiguous rows (fewer when d is
// small), one per block on an H100, each slab staged in shared memory by
// cp.async in chunks of RC rows:
//
//   A. per slab, in passes over rectangles of (f, k'): the pass's partial
//      of C_slab^T v_slab, staged in shared memory; the launch runs in
//      clusters of PAIR = 2 blocks, and the two add their partials through
//      distributed shared memory and write the sum to the workspace;
//   B. y = sum of the slab partials: each block stages every slab's piece
//      of its run of entries (bulk 16-byte copies) and adds them up;
//   C. per slab: w_slab = C_slab y, its rows kept in shared memory and
//      written out contiguously, and the upper triangle of their Gram
//      summed into a (k', k') tile, added to the pair's other tile and
//      written to the workspace;
//   D. g = sum of the slab partials, upper triangle, mirrored, so g is
//      exactly symmetric.
//
// Two plans, decided before the launch from (d, f, k') (make_plan):
//   resident (matvec_gram_kernel<TR_RESIDENT>): the whole slab of C stays
//     in shared memory across the grid barriers, so C is read from device
//     memory once; y is staged whole and the Gram tile kept in shared
//     memory; phase C walks the slab in passes of WARPS * TR_RESIDENT rows.
//   streamed (matvec_gram_kernel<TR_STREAMED>): where the slab, y and the
//     Gram tile do not fit together. Its shared memory does not depend on
//     f: phase A streams each pass's columns of C and v through a ring of
//     ST_STREAMED chunks, phase C streams (WARPS * TR_STREAMED, FC) of C
//     and (FC, KC) of y, and each slab's Gram tile is added up in the
//     workspace. Only a pass's rows of w grow with k', so it takes any f
//     and k' up to the limit the wrapper computes from this rule (MAX_K).
// Phase A covers (f, k') in passes of at most PASS_QP pairs of f quads by
// PASS_CG groups of AC column quads, one block of a lane pair each.
// Every sum has an order fixed by (d, f, k'): rows of a slab in order (in
// two or four interleaved runs added by a fixed shuffle tree), slabs in
// order. No float atomics, so (w, g) is bit-identical from run to run
// whatever the grid size. All products are FFMA on fp32 operands (never
// TF32). Ragged d, f and k' are masked (zeros staged, nothing stored).
//
// What bounds it: at the slice shape (12288, 200, 58) the work is
// 4 d f k' + 2 d k'^2 = 0.653 GFLOP, 9.75 us at 67 TFLOP/s fp32, against
// 15.5 MB of bytes (C once, v, w) = 4.6 us at 3.35 TB/s: operations. On the
// card it is the shared-memory reads: one block of 8 warps per SM, each
// lane of phases A and C holds a register tile (A: 2 quads of f by 3 groups
// of 4 columns over one parity of the rows; C: 12 rows by 8 columns over a
// quarter of f) fed by 16-byte reads, about 5 products per float read, and
// the SM's shared memory delivers 32 floats a cycle against 128 FFMA
// lanes. What else weighs, by copies of this file with parts removed
// (NVIDIA H100 80GB HBM3, 700 W, PERF.md): the launch, three grid
// barriers, the slab landing before phase A can start (waiting for it
// chunk by chunk measured no faster than waiting for all of it), the
// partials' traffic through L2, and stores: the partial of phase A stored
// from the lanes' scattered tiles measured slower than the same bytes
// staged and stored in one run. The streamed plan at the slice shape
// measured 1.4x the resident plan (scripts/torch_profile_matvec_gram.py).
//
// C interface: det_matvec_gram_workspace() gives the scratch the caller
// allocates and det_matvec_gram_grid() the grid (the cluster occupancy
// query); det_matvec_gram() makes one cooperative launch of that grid in
// clusters of PAIR blocks on the given stream, allocates nothing and
// returns its CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLABS = 132;        // slabs of d: one per SM of an H100
constexpr int PAIR = 2;  // blocks of a cluster: their partials are added on chip
static_assert(PAIR == 2, "a block adds its partial to its one partner's");
constexpr int RC = 32;            // rows of a staged chunk
constexpr int AQ = 2;             // phase A: a lane's f quads (4 indices each)
constexpr int AC = 3;             // phase A: a lane's groups of 4 columns
constexpr int PASS_QP = 32;       // phase A: pairs of f quads a pass covers at most
constexpr int PASS_CG = 16;       // phase A: groups of AC column quads a pass covers at most
constexpr int TR_RESIDENT = 12;   // phase C rows per warp per pass (96-row passes)
constexpr int TR_STREAMED = 4;    // streamed: 32-row passes
constexpr int ST_STREAMED = 3;    // streamed: chunks in a ring
constexpr int FC = 64;            // streamed phase C: f indices of a staged chunk
constexpr int KC = 64;            // phase C: columns of a column pass (8 a lane)
constexpr int SUM_MIN = 4 * SLABS;  // phases B, D stage 4 entries of every slab at least
constexpr int SMEM_MAX = 232448;  // bytes a block may use on Hopper

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// row stride (floats) of the pass's rows of w in shared memory: kp padded
// to 16 modulo 32, so that the Gram update's two lanes of a tile, on rows
// r and r + 1, read 16 banks apart
__host__ __device__ __forceinline__ int wstride(int kp) { return kp + ((16 - kp) % 32 + 32) % 32; }

struct Plan {
  int fp, kp;      // f and k' padded to multiples of 4 (shared-memory rows)
  int rows;        // rows of d per slab
  int nslab;       // slabs
  int npart;       // partials: one per pair of slabs
  int nchunk;      // chunks of RC rows in a slab
  int resident;    // 1: the slab stays in shared memory; 0: streamed
  int stages;      // chunks a ring holds (resident: the slab's)
  int pq, pc;      // phase A pass: pq pairs of f quads by pc groups of AC column quads
  int gstride;     // streamed: floats between the slabs' Gram tiles in the workspace
  size_t room;     // floats before the region phases B and D stage partials in
  size_t smem;     // dynamic shared memory (bytes)
  size_t off_part, off_gpart, off_gslot, bytes;  // workspace: y, then the partials
};

size_t align256(size_t n) { return (n + 255) / 256 * 256; }
size_t mx(size_t a, size_t b) { return a > b ? a : b; }

// floats of the resident plan: the whole slab of C (nchunk chunks), then a
// region for the largest of the slab of v and a pass's partial (phase A),
// the staged partials (phases B, D) and y, a pass's rows of w and the Gram
// tile (phase C)
size_t resident_floats(size_t fp, size_t kp, size_t nchunk, size_t fw, size_t kw) {
  return nchunk * RC * fp +
         mx(mx(nchunk * RC * kp + fw * kw, SUM_MIN),
            fp * kp + (size_t)WARPS * TR_RESIDENT * wstride((int)kp) + kp * kp);
}

// floats of the streamed plan, none depending on f: the largest of phase
// A's ring of the pass's columns of C and v with the pass's partial, the
// staged partials, and phase C's ring of (rows, FC) of C and (FC, KC) of y
// with a pass's rows of w
size_t streamed_floats(size_t kp, size_t fw, size_t kw) {
  constexpr size_t PROWS = WARPS * TR_STREAMED;
  return mx(mx(ST_STREAMED * RC * (fw + kw) + fw * kw, SUM_MIN),
            ST_STREAMED * (PROWS * FC + FC * KC) + PROWS * wstride((int)kp));
}

Plan make_plan(int d, int f, int k) {
  Plan p;
  p.fp = pad4(f);
  p.kp = pad4(k);
  p.rows = (d + SLABS - 1) / SLABS;
  p.nslab = (d + p.rows - 1) / p.rows;
  p.npart = (p.nslab + PAIR - 1) / PAIR;
  p.nchunk = (p.rows + RC - 1) / RC;
  p.pc = min((p.kp / 4 + AC - 1) / AC, PASS_CG);
  p.pq = min(THREADS / 2 / p.pc, PASS_QP);
  const int fw = 4 * AQ * p.pq, kw = 4 * AC * p.pc;
  const size_t resident = 4 * resident_floats(p.fp, p.kp, p.nchunk, fw, kw);
  p.resident = resident <= (size_t)SMEM_MAX;
  p.stages = p.resident ? p.nchunk : ST_STREAMED;
  p.smem = p.resident ? resident : 4 * streamed_floats(p.kp, fw, kw);
  p.room = p.resident ? (size_t)p.nchunk * RC * p.fp : 0;
  p.gstride = p.resident ? 0 : (p.kp * p.kp + 63) / 64 * 64;
  p.off_part = align256(sizeof(float) * (size_t)p.fp * p.kp);
  p.off_gpart = p.off_part + align256(sizeof(float) * (size_t)p.npart * p.fp * p.kp);
  const size_t gpart = align256(sizeof(float) * (size_t)p.npart * pad4(k * k));
  p.off_gslot = p.off_gpart + (p.resident ? gpart : 0);
  p.bytes = p.off_gslot + sizeof(float) * (size_t)p.nslab * p.gstride;
  return p;
}

struct Args {
  const float* c;  // (d, f)
  const float* v;  // (d, k)
  float* w;        // (d, k)
  float* g;        // (k, k)
  float* y;        // workspace: (fp, kp), zero past f and k
  float* part;     // workspace: (npart, fp, kp), entries past f and k unused
  float* gpart;    // workspace, resident: npart (k, k) upper triangles, pad4(k k) apart
  float* gslot;    // workspace, streamed: nslab (kp, kp) upper tiles, gstride apart
  int d, f, k, fp, kp, rows, nslab, npart, nchunk, stages, pq, pc, gstride;
  int room, room_size;  // phases B, D: staged partials at smem + room, room_size floats
  int cvec, vvec;  // floats per copy of C / v rows (4, 2 or 1: their alignment)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 8 : 0)
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

// nr rows from row r0 and columns c0 .. c0 + cp of a (*, cols) row-major
// matrix into shared rows of stride cp (a multiple of 4; zeros past cols)
// in copies of `vec` floats (4: cols and c0 multiples of 4, 2: even, rows
// aligned to the copy, else 1)
template <int VEC>
__device__ __forceinline__ void stage_rows_by(uint32_t dst, const float* __restrict__ src,
                                              int r0, int nr, int c0, int cp, int cols) {
  for (int e = threadIdx.x * VEC; e < nr * cp; e += THREADS * VEC) {
    const int r = e / cp, col = c0 + e - r * cp;
    const bool ok = col < cols;
    cp_async<4 * VEC>(dst + 4 * e, ok ? src + (size_t)(r0 + r) * cols + col : src, ok);
  }
}

__device__ __forceinline__ void stage_rows(uint32_t dst, const float* __restrict__ src,
                                           int r0, int nr, int c0, int cp, int cols, int vec) {
  if (vec == 4) stage_rows_by<4>(dst, src, r0, nr, c0, cp, cols);
  else if (vec == 2) stage_rows_by<2>(dst, src, r0, nr, c0, cp, cols);
  else stage_rows_by<1>(dst, src, r0, nr, c0, cp, cols);
}

// The sums over the n partials p[0], p[stride], ... of entries [0, entries)
// (a multiple of 4; stride too): block b takes a contiguous run of entries,
// stages each partial's piece of the run into shared memory (`room`
// floats) with 16-byte copies, all in flight at once, and one thread per
// entry adds its n values in partial order; put(e, sum) gets each entry.
template <class Put>
__device__ __forceinline__ void sum_partials(const float* __restrict__ p, size_t stride,
                                             int n, int entries, float* room, int room_size,
                                             Put put) {
  const int per_block = ((entries + gridDim.x - 1) / gridDim.x + 3) & ~3;
  const int e_begin = blockIdx.x * per_block, e_end = min(entries, e_begin + per_block);
  const int cap = (room_size / n) & ~3;  // entries staged at once
  const uint32_t dst = smem_u32(room);
  for (int c0 = e_begin; c0 < e_end; c0 += cap) {
    const int ce = min(cap, e_end - c0);  // a multiple of 4
    const int vecs = ce / 4;
    for (int idx = threadIdx.x; idx < n * vecs; idx += THREADS) {
      const int q = idx / vecs, v4 = idx - q * vecs;
      cp_async<16>(dst + 16 * (q * vecs + v4), p + (size_t)q * stride + c0 + 4 * v4, true);
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    for (int x = threadIdx.x; x < ce; x += THREADS) {
      float sum = 0.f;
#pragma unroll 16
      for (int q = 0; q < n; ++q) sum += room[q * ce + x];
      put(c0 + x, sum);
    }
    __syncthreads();  // the room is staged again
  }
}

// Phase A for slab s: part[s / PAIR] = C^T v over the pair's two slabs, in
// passes over rectangles of pq pairs of f quads by pc groups of AC column
// quads. In a pass, lane l of warp w holds block 16 w + l % 16 of the
// rectangle (AQ quads of f by AC groups of 4 columns) over the slab's rows
// of parity l / 16, summed in order; the two parities are added at the
// slab's end, the blocks stored as the pass's partial in shared memory, and
// the pair's two partials added and written out. Resident, the slab's
// rows of C and v land whole, once, and every pass reads its columns;
// streamed, each pass's columns of each chunk go through the ring. At
// (f, k') = (200, 58) one pass of 25 by 5 blocks covers it all.
template <int TR>
__device__ void slab_partial(const Args& a, float* smem, int s) {
  constexpr bool RESIDENT = TR == TR_RESIDENT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fp = a.fp, kp = a.kp, fw = 4 * AQ * a.pq, kw = 4 * AC * a.pc;
  const int cst = RESIDENT ? fp : fw, vst = RESIDENT ? kp : kw;  // staged row strides
  float* cring = smem;
  float* vring = smem + (size_t)a.stages * RC * cst;
  float* pstage = vring + (size_t)a.stages * RC * vst;  // the pass's partial (fw, kw)
  const int r_begin = s * a.rows;
  const int r_end = min(a.d, r_begin + a.rows);
  const int nchunk = max(0, (r_end - r_begin + RC - 1) / RC);  // 0: no slab s
  const int nquad = fp / 4, ngrp = kp / 4;
  const int nrc = ((ngrp + AC - 1) / AC + a.pc - 1) / a.pc;  // rectangles across k'
  const int passes = ((nquad + AQ - 1) / AQ + a.pq - 1) / a.pq * nrc;
  const int visits = passes * nchunk;
  // first f quad and column quad of pass p's rectangle
  auto quad0 = [&](int p) { return AQ * a.pq * (p / nrc); };
  auto grp0 = [&](int p) { return AC * a.pc * (p % nrc); };
  // visit t (chunk t % nchunk of pass t / nchunk) is in stage stage(t): its
  // chunk's own when resident, the ring's next when streamed
  auto stage = [&](int t) { return RESIDENT ? t % nchunk : t % a.stages; };
  auto issue = [&](int t) {
    const int q = t % nchunk, st = stage(t), p = t / nchunk;
    const int r0 = r_begin + q * RC, nr = min(RC, r_end - r0);
    stage_rows(smem_u32(cring + (size_t)st * RC * cst), a.c, r0, nr, RESIDENT ? 0 : 4 * quad0(p),
               cst, a.f, a.cvec);
    stage_rows(smem_u32(vring + (size_t)st * RC * vst), a.v, r0, nr, RESIDENT ? 0 : 4 * grp0(p),
               vst, a.k, a.vvec);
    cp_commit();
  };
  if (RESIDENT) {
    for (int q = 0; q < nchunk; ++q) issue(q);
  } else {
    for (int t = 0; t < ST_STREAMED - 1; ++t)
      if (t < visits) issue(t);
      else cp_commit();
  }

  const int half = lane >> 4;
  const int b = 16 * warp + (lane & 15);  // the lane pair's block of the rectangle
  const bool active = b < a.pq * a.pc;
  const int bq = min(b / a.pc, a.pq - 1), bc = b % a.pc;
  cg::cluster_group pair = cg::this_cluster();
  const int rank = pair.block_rank();
  for (int p = 0; p < passes; ++p) {
    const int f0q = quad0(p), k0q = grp0(p);
    const int q0 = f0q + AQ * bq, g0 = k0q + AC * bc;  // the block's first quad, column quad
    // quads and column groups clamped to the last (duplicates are summed
    // and not stored): every load is unconditional; offsets in the staged
    // rows (streamed: in the rectangle's columns)
    int qoff[AQ], goff[AC];
#pragma unroll
    for (int e = 0; e < AQ; ++e) qoff[e] = 4 * (min(q0 + e, nquad - 1) - (RESIDENT ? 0 : f0q));
#pragma unroll
    for (int c = 0; c < AC; ++c) goff[c] = 4 * (min(g0 + c, ngrp - 1) - (RESIDENT ? 0 : k0q));
    float acc[AQ][4][4 * AC];  // [quad][f index in the quad][column]
#pragma unroll
    for (int e = 0; e < AQ; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int x = 0; x < 4 * AC; ++x) acc[e][u][x] = 0.f;
    for (int q = 0; q < nchunk; ++q) {
      const int t = p * nchunk + q;
      if (RESIDENT) {
        if (t == 0) {  // the whole slab (waiting chunk by chunk measured no faster)
          cp_wait<0>();
          __syncthreads();
        }
      } else {
        // into the stage freed at t - 1
        if (t + ST_STREAMED - 1 < visits) issue(t + ST_STREAMED - 1);
        else cp_commit();
        cp_wait<ST_STREAMED - 1>();
        __syncthreads();
      }
      const float* cs = cring + (size_t)stage(t) * RC * cst;
      const float* vs = vring + (size_t)stage(t) * RC * vst;
      const int nr = min(RC, r_end - (r_begin + q * RC));
      struct Row {
        float4 c[AQ], v[AC];
      };
      auto fetch = [&](int rr, Row& o) {
#pragma unroll
        for (int e = 0; e < AQ; ++e)
          o.c[e] = *reinterpret_cast<const float4*>(cs + (size_t)rr * cst + qoff[e]);
#pragma unroll
        for (int c = 0; c < AC; ++c)
          o.v[c] = *reinterpret_cast<const float4*>(vs + (size_t)rr * vst + goff[c]);
      };
      auto product = [&](const Row& o) {
        float bv[4 * AC];
#pragma unroll
        for (int c = 0; c < AC; ++c)
          bv[4 * c] = o.v[c].x, bv[4 * c + 1] = o.v[c].y, bv[4 * c + 2] = o.v[c].z,
          bv[4 * c + 3] = o.v[c].w;
#pragma unroll
        for (int e = 0; e < AQ; ++e) {
          const float cv[4] = {o.c[e].x, o.c[e].y, o.c[e].z, o.c[e].w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int x = 0; x < 4 * AC; ++x) acc[e][u][x] = fmaf(cv[u], bv[x], acc[e][u][x]);
        }
      };
      const int mine = (nr - half + 1) / 2;  // rows half, half + 2, ...
      auto row = [&](int m) { return half + 2 * min(m, mine - 1); };
      Row ra, rb;  // two rows in flight: one multiplied while the next lands
      if (mine > 0) fetch(row(0), ra);
      for (int m = 0; m < mine; m += 2) {
        fetch(row(m + 1), rb);
        product(ra);
        if (m + 1 < mine) {
          fetch(row(m + 2), ra);
          product(rb);
        }
      }
      if (!RESIDENT) __syncthreads();  // the stage may be refilled
    }
    // even rows plus odd rows: the same bits in both halves
#pragma unroll
    for (int e = 0; e < AQ; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int x = 0; x < 4 * AC; ++x)
          acc[e][u][x] += __shfl_xor_sync(0xffffffffu, acc[e][u][x], 16);
#pragma unroll
    for (int e = 0; e < AQ; ++e) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * (q0 + e) + u;
        if (half || !active || q0 + e >= nquad || i >= a.f) continue;
        // whole vectors, padding columns too (never read)
        float4* out = reinterpret_cast<float4*>(pstage + (size_t)(i - 4 * f0q) * kw);
#pragma unroll
        for (int c = 0; c < AC; ++c)
          if (g0 + c < ngrp)
            out[g0 + c - k0q] = make_float4(acc[e][u][4 * c], acc[e][u][4 * c + 1],
                                            acc[e][u][4 * c + 2], acc[e][u][4 * c + 3]);
      }
    }
    // the pair's partial of the rectangle, rank 0's plus rank 1's, read
    // from both blocks' shared memory and written in order, each block half
    // of the rows, by 16-byte stores
    pair.sync();
    const float4* own = reinterpret_cast<const float4*>(pstage);
    const float4* other = pair.map_shared_rank(own, rank ^ 1);
    const int fr = min(fw, a.f - 4 * f0q);     // rows of the rectangle within f
    const int kr = min(kw, kp - 4 * k0q) / 4;  // and vectors of a row within k'
    const int split = (fr + 1) / 2 * kr, total = fr * kr;
    float4* to = reinterpret_cast<float4*>(a.part + (size_t)(s / PAIR) * fp * kp);
    const int end = s / PAIR < a.npart ? (rank ? total : split) : 0;  // 0: neither slab is
    for (int x = (rank ? split : 0) + threadIdx.x; x < end; x += THREADS) {
      const int i = x / kr, jv = x - i * kr, at = i * (kw / 4) + jv;
      const float4 p0 = rank ? other[at] : own[at], p1 = rank ? own[at] : other[at];
      to[(size_t)(4 * f0q + i) * (kp / 4) + k0q + jv] =
          make_float4(p0.x + p1.x, p0.y + p1.y, p0.z + p1.z, p0.w + p1.w);
    }
    pair.sync();  // both have read each other's partial: it may be replaced
  }
}

// Phase C for slab s: rows of w = C_slab y in passes of PROWS = WARPS * TR
// rows (warp w: pass rows w + WARPS e; lane l: 8 columns of the KC of
// column pass jp over one quarter of f's quads, summed in order, the
// quarters added at the end), each pass's rows kept in wbuf, written out
// and added into the Gram tile gt in row order. Resident: the slab is
// still in shared memory (loaded again when `loaded` is false), y is staged
// whole, gt is in shared memory, and the pair's two tiles are added into
// the pair's partial. Streamed: (PROWS, FC) of C and (FC, KC) of y go
// through the ring, quarters of each chunk's quads, and gt is slab s's
// partial in the workspace (the first pass stores its upper tiles, later
// ones add).
template <int TR>
__device__ void slab_rows_of_w(const Args& a, float* smem, int s, bool loaded) {
  constexpr bool RESIDENT = TR == TR_RESIDENT;
  constexpr int PROWS = WARPS * TR;  // rows of a pass
  constexpr int CH = PROWS * FC + FC * KC;  // floats of a streamed stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, quarter = lane >> 3;
  const int fp = a.fp, kp = a.kp;
  const int ws = wstride(kp);
  float* cring = smem;
  float* ys = smem + (size_t)a.stages * RC * fp;  // resident: y
  float* wbuf = RESIDENT ? ys + (size_t)fp * kp : smem + ST_STREAMED * CH;  // [PROWS][ws]
  float* gt = RESIDENT ? wbuf + (size_t)PROWS * ws : a.gslot + (size_t)s * a.gstride;
  const int r_begin = s * a.rows;
  const int r_end = min(a.d, r_begin + a.rows);
  const int nrows = max(0, r_end - r_begin);  // 0: no slab s
  const int nchunk = (nrows + RC - 1) / RC;
  const int passes = (nrows + PROWS - 1) / PROWS;
  const int jpasses = (kp + KC - 1) / KC;
  const int nfc = RESIDENT ? 1 : (fp + FC - 1) / FC;
  const int visits = passes * jpasses * nfc;

  if (RESIDENT)
    for (int e = threadIdx.x; e < kp * kp; e += THREADS) gt[e] = 0.f;
  // streamed visit t: chunk t % nfc of f, column pass t / nfc % jpasses, row pass t / (nfc jpasses)
  auto issue = [&](int t) {
    const int ch = t % nfc, jp = t / nfc % jpasses, pc = t / (nfc * jpasses);
    const int r0 = r_begin + pc * PROWS;
    float* st = smem + (size_t)(t % ST_STREAMED) * CH;
    stage_rows(smem_u32(st), a.c, r0, min(PROWS, r_end - r0), ch * FC, FC, a.f, a.cvec);
    stage_rows(smem_u32(st + PROWS * FC), a.y, ch * FC, min(FC, fp - ch * FC), jp * KC, KC, kp, 4);
    cp_commit();
  };
  if (RESIDENT && !loaded) {  // a second slab of this block: load it again
    for (int q = 0; q < nchunk; ++q) {
      const int r0 = r_begin + q * RC;
      stage_rows(smem_u32(cring + (size_t)q * RC * fp), a.c, r0, min(RC, r_end - r0), 0, fp,
                 a.f, a.cvec);
    }
    cp_commit();
    cp_wait<0>();
  } else if (!RESIDENT) {
    for (int t = 0; t < ST_STREAMED - 1; ++t)
      if (t < visits) issue(t);
      else cp_commit();
  }
  __syncthreads();

  for (int pc = 0; pc < passes; ++pc) {
    const int p0 = pc * PROWS;  // first slab row of the pass
    const int pr = min(PROWS, nrows - p0);
    for (int jp = 0; jp < jpasses; ++jp) {
      // lane l: 8 columns, jp * KC + 4 (l % 8) .. + 3 and 32 further on,
      // over the quarter (l / 8) of f's quads (the quarters meet at the
      // end: (q0 + q1) + (q2 + q3))
      const int j = jp * KC + 4 * (lane & 7);  // and j + 32
      float acc[TR][8];
#pragma unroll
      for (int e = 0; e < TR; ++e)
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[e][x] = 0.f;
      for (int ch = 0; ch < nfc; ++ch) {
        const int t = (pc * jpasses + jp) * nfc + ch;
        const float* cs;  // the pass's rows of C, from its chunk's first quad
        const float* yc;  // y's rows of the chunk, from the column pass's first column
        int cstr, ystr, ja, jb, n4;
        if (RESIDENT) {
          cs = cring + (size_t)p0 * fp, cstr = fp, yc = ys, ystr = kp, n4 = fp / 4;
          ja = j < kp ? j : 0, jb = j + 32 < kp ? j + 32 : 0;
        } else {
          // into the stage freed at t - 1
          if (t + ST_STREAMED - 1 < visits) issue(t + ST_STREAMED - 1);
          else cp_commit();
          cp_wait<ST_STREAMED - 1>();
          __syncthreads();
          cs = smem + (size_t)(t % ST_STREAMED) * CH, cstr = FC, yc = cs + PROWS * FC, ystr = KC;
          n4 = min(FC, fp - ch * FC) / 4;
          ja = 4 * (lane & 7), jb = ja + 32;  // zeros staged past kp
        }
        const int per = (n4 + 3) / 4;
        const int i4_begin = min(n4, quarter * per), i4_end = min(n4, i4_begin + per);
        // the warp's rows, clamped to the pass's last (duplicates are summed
        // and not stored): every load unconditional
        int crow[TR];  // offsets of the rows in cs
#pragma unroll
        for (int e = 0; e < TR; ++e) crow[e] = min(warp + WARPS * e, pr - 1) * cstr;
#pragma unroll 1
        for (int i4 = i4_begin; i4 < i4_end; ++i4) {
          float4 yv[4][2];  // y rows 4 i4 + u at the lane's columns
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            yv[u][0] = *reinterpret_cast<const float4*>(yc + (size_t)(4 * i4 + u) * ystr + ja);
            yv[u][1] = *reinterpret_cast<const float4*>(yc + (size_t)(4 * i4 + u) * ystr + jb);
          }
#pragma unroll
          for (int e = 0; e < TR; ++e) {
            const float4 c4 = *reinterpret_cast<const float4*>(cs + crow[e] + 4 * i4);
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float yr[8] = {yv[u][0].x, yv[u][0].y, yv[u][0].z, yv[u][0].w,
                                   yv[u][1].x, yv[u][1].y, yv[u][1].z, yv[u][1].w};
#pragma unroll
              for (int x = 0; x < 8; ++x) acc[e][x] = fmaf(cv[u], yr[x], acc[e][x]);
            }
          }
        }
        if (!RESIDENT) __syncthreads();  // the stage may be refilled
      }
#pragma unroll
      for (int e = 0; e < TR; ++e)
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          acc[e][x] += __shfl_xor_sync(0xffffffffu, acc[e][x], 8);
          acc[e][x] += __shfl_xor_sync(0xffffffffu, acc[e][x], 16);
        }
#pragma unroll
      for (int e = 0; e < TR; ++e) {
        const int lr = warp + WARPS * e;
        if (quarter || lr >= pr) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int jh = j + 32 * h;
          if (jh >= kp) continue;
          *reinterpret_cast<float4*>(wbuf + (size_t)lr * ws + jh) =
              make_float4(acc[e][4 * h], acc[e][4 * h + 1], acc[e][4 * h + 2], acc[e][4 * h + 3]);
        }
      }
    }
    __syncthreads();
    // the pass's rows of w, contiguous in w, written out in order
    float* wout = a.w + (size_t)(r_begin + p0) * a.k;
    for (int e = threadIdx.x; e < pr * a.k; e += THREADS) {
      const int r = e / a.k;
      wout[e] = wbuf[(size_t)r * ws + (e - r * a.k)];
    }
    // the pass's rows into the Gram tile: 4 x 4 blocks (ta <= tb), two
    // lanes each, over the rows of one parity each in order, added even +
    // odd into the tile
    const int nt = kp / 4, ntri = nt * (nt + 1) / 2;
    const int par = threadIdx.x & 1;
    // the lane pair's tile: u along row ta of the triangle, THREADS / 2 on
    // each round
    int u = threadIdx.x >> 1, ta = 0;
    for (int base = 0; base < ntri; base += THREADS / 2, u += THREADS / 2) {
      const bool ok = base + (threadIdx.x >> 1) < ntri;
      while (ok && u >= nt - ta) u -= nt - ta++;
      const int tb = ok ? ta + u : 0;
      float g4[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int z = 0; z < 4; ++z) g4[x][z] = 0.f;
      if (ok) {
#pragma unroll 4
        for (int r = par; r < pr; r += 2) {
          const float4 p = *reinterpret_cast<const float4*>(wbuf + (size_t)r * ws + 4 * ta);
          const float4 q = *reinterpret_cast<const float4*>(wbuf + (size_t)r * ws + 4 * tb);
          const float pv[4] = {p.x, p.y, p.z, p.w};
          const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int z = 0; z < 4; ++z) g4[x][z] = fmaf(pv[x], qv[z], g4[x][z]);
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int z = 0; z < 4; ++z) g4[x][z] += __shfl_xor_sync(0xffffffffu, g4[x][z], 1);
      if (ok && par == 0) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float4* t = reinterpret_cast<float4*>(gt + (size_t)(4 * ta + x) * kp + 4 * tb);
          const float4 o = RESIDENT || pc ? *t : make_float4(0.f, 0.f, 0.f, 0.f);
          *t = make_float4(o.x + g4[x][0], o.y + g4[x][1], o.z + g4[x][2], o.w + g4[x][3]);
        }
      }
    }
    __syncthreads();  // wbuf and the stage are free
  }
  if constexpr (RESIDENT) {
    // the pair's partial: rank 0's tile plus rank 1's, each block half of
    // the entries
    cg::cluster_group pair = cg::this_cluster();
    pair.sync();
    const int rank = pair.block_rank();
    const float* other = pair.map_shared_rank(gt, rank ^ 1);
    float* my = a.gpart + (size_t)(s / PAIR) * pad4(a.k * a.k);
    const int kk = a.k * a.k, split = kk / 2;
    const int end = s / PAIR < a.npart ? (rank ? kk : split) : 0;  // 0: neither slab is
    for (int e = (rank ? split : 0) + threadIdx.x; e < end; e += THREADS) {
      const int r = e / a.k, c = e - r * a.k;
      const float g0 = rank ? other[(size_t)r * kp + c] : gt[(size_t)r * kp + c];
      const float g1 = rank ? gt[(size_t)r * kp + c] : other[(size_t)r * kp + c];
      if (r <= c) my[e] = g0 + g1;
    }
    pair.sync();  // both have read each other's tile: it is zeroed next
  }
}

// one block of 8 warps per SM; at most 255 registers a thread
template <int TR>
__global__ void __launch_bounds__(THREADS, 1) matvec_gram_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int bid = blockIdx.x, nblk = gridDim.x;  // nblk: a multiple of PAIR
  // every block takes the same rounds of slabs, bid + i nblk (past nslab:
  // none), so the two blocks of a pair meet at each round's cluster barrier
  const int rounds = (a.nslab + nblk - 1) / nblk;
  const int last = a.nslab - 1 - (a.nslab - 1 - bid) % nblk;  // this block's last slab

  // A. slab partials of C^T v, added pairwise (this block's slabs in order;
  // the last stays, resident)
  for (int i = 0; i < rounds; ++i) slab_partial<TR>(a, smem, bid + i * nblk);
  grid.sync();

  // B. y = sum over slabs, slab order
  sum_partials(a.part, (size_t)a.fp * a.kp, a.npart, a.fp * a.kp, smem + a.room, a.room_size,
               [&](int e, float s) {
                 a.y[e] = e / a.kp < a.f && e % a.kp < a.k ? s : 0.f;
               });
  grid.sync();

  // C. y staged once per block (resident); rows of w and their Gram
  // partials, the slab still in shared memory first
  if (TR == TR_RESIDENT) {
    float* ys = smem + (size_t)a.stages * RC * a.fp;
    const uint32_t dst = smem_u32(ys);
    for (int e = threadIdx.x * 4; e < a.fp * a.kp; e += THREADS * 4)
      cp_async<16>(dst + 4 * e, a.y + e, true);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  }
  for (int i = rounds - 1; i >= 0; --i)
    slab_rows_of_w<TR>(a, smem, bid + i * nblk, bid + i * nblk == last);
  grid.sync();

  // D. g = sum over slabs, slab order, mirrored (resident: the pairs'
  // (k, k) partials; streamed: the slabs' (kp, kp) tiles)
  const bool resident = TR == TR_RESIDENT;
  const int ld = resident ? a.k : a.kp;  // row stride of a partial
  const int entries = resident ? pad4(a.k * a.k) : a.kp * a.kp;
  sum_partials(resident ? a.gpart : a.gslot, resident ? (size_t)entries : (size_t)a.gstride,
               resident ? a.npart : a.nslab, entries, smem + a.room, a.room_size,
               [&](int e, float s) {
                 const int r = e / ld, c = e - r * ld;
                 if (r >= a.k || c >= a.k || r > c) return;
                 a.g[(size_t)r * a.k + c] = s;
                 a.g[(size_t)c * a.k + r] = s;
               });
}

template <int TR>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(matvec_gram_kernel<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// the launch: cooperative, in clusters of PAIR blocks
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  Launch(int blocks, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attrs[0].id = cudaLaunchAttributeCooperative;
    attrs[0].val.cooperative = 1;
    attrs[1].id = cudaLaunchAttributeClusterDimension;
    attrs[1].val.clusterDim.x = PAIR;
    attrs[1].val.clusterDim.y = 1;
    attrs[1].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 2;
  }
};

// pairs of blocks resident at once on the current device
template <int TR>
cudaError_t resident_pairs(int* pairs, size_t smem) {
  cudaError_t err = allow_smem<TR>(smem);
  Launch l(PAIR, smem, nullptr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(pairs, (void*)matvec_gram_kernel<TR>, &l.cfg);
  return err;
}

// floats per cp.async of rows of `cols` floats at p: 16-byte copies where
// every row is 16-byte aligned, 8-byte where 8-byte aligned, else 4-byte
int copy_width(const void* p, int cols) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (cols % 4 == 0 && a % 16 == 0) return 4;
  if (cols % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

}  // namespace

// Bytes of scratch det_matvec_gram needs for C (d, f) and v (d, k).
extern "C" size_t det_matvec_gram_workspace(int d, int f, int k) {
  return make_plan(d, f, k).bytes;
}

// The cooperative grid for C (d, f) and v (d, k) on the current device: as
// many pairs of blocks as can be resident at once (the cluster occupancy
// query; a cooperative launch's condition), and no more than there are
// pairs of slabs. Returns the block count, or minus a CUDA error code.
extern "C" int det_matvec_gram_grid(int d, int f, int k) {
  if (d < 1 || f < 1 || k < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(d, f, k);
  if (p.smem > (size_t)SMEM_MAX) return -static_cast<int>(cudaErrorInvalidValue);
  int pairs = 0;
  const cudaError_t err = p.resident ? resident_pairs<TR_RESIDENT>(&pairs, p.smem)
                                     : resident_pairs<TR_STREAMED>(&pairs, p.smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (pairs < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return PAIR * min(pairs, p.npart);
}

// c: (d, f) fp32 contiguous. v: (d, k) fp32 contiguous. w: (d, k) fp32.
// g: (k, k) fp32. workspace: det_matvec_gram_workspace(d, f, k) bytes,
// 256-byte aligned. blocks: det_matvec_gram_grid(d, f, k), the grid the
// caller records for this launch.
extern "C" int det_matvec_gram(const void* c, const void* v, void* w, void* g,
                               void* workspace, int d, int f, int k,
                               int blocks, void* stream) {
  if (d < 1 || f < 1 || k < 1 || blocks < 1 || blocks % PAIR)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(d, f, k);
  if (p.smem > (size_t)SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = p.resident ? allow_smem<TR_RESIDENT>(p.smem) : allow_smem<TR_STREAMED>(p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  Args a;
  a.c = static_cast<const float*>(c);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<float*>(w);
  a.g = static_cast<float*>(g);
  char* base = static_cast<char*>(workspace);
  a.y = reinterpret_cast<float*>(base);
  a.part = reinterpret_cast<float*>(base + p.off_part);
  a.gpart = reinterpret_cast<float*>(base + p.off_gpart);
  a.gslot = reinterpret_cast<float*>(base + p.off_gslot);
  a.d = d, a.f = f, a.k = k, a.fp = p.fp, a.kp = p.kp;
  a.rows = p.rows, a.nslab = p.nslab, a.npart = p.npart, a.nchunk = p.nchunk;
  a.stages = p.stages, a.pq = p.pq, a.pc = p.pc, a.gstride = p.gstride;
  a.room = static_cast<int>(p.room);
  a.room_size = static_cast<int>(p.smem / sizeof(float) - p.room);
  a.cvec = copy_width(c, f);
  a.vvec = copy_width(v, k);
  Launch l(blocks, p.smem, static_cast<cudaStream_t>(stream));
  err = p.resident ? cudaLaunchKernelEx(&l.cfg, matvec_gram_kernel<TR_RESIDENT>, a)
                   : cudaLaunchKernelEx(&l.cfg, matvec_gram_kernel<TR_STREAMED>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
