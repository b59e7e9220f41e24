// The static analyzer's seeded tiling mutant, for Hopper (sm_90a):
//   det_mutant_full_block : o = x @ v      x (rows, d), v (d, k), o (rows, k)
// all fp32, every product an FFMA (never TF32).
//
// Replaces the TPU kernel of distributed_eigenspaces_tpu/
// analysis/mutations.py:352 (_mutant_pallas_full_block, its `project`; the
// pallas_call at :371): a grid of (1,) whose BlockSpecs pin the whole
// (rows, d) x and the whole (d, k) v as one block each. That mutant exists to prove that the
// analyzer's tile budget (analysis/contracts.py::check_pallas, rule
// pallas-block) catches a kernel that has silently stopped tiling. Here the
// same failure has its Hopper form: ONE CTA (grid (1, 1, 1), 256 threads)
// owns all of x, so one of the card's 132 SMs does the work while the others
// idle. It is legal and exact, and deliberately slow: its time is recorded
// and never optimised, and no user path launches it (only the analyzer's
// mutation self-test and the checks beside it).
//
// The CTA stages v in shared memory, its columns zero-padded to a multiple
// of KC ((1024, 8) fp32 is 32 KB at the audit shape). Each thread owns a row,
// looping when rows > 256: it walks all of d in index order with FFMA into
// KC fp32 registers per column chunk, then writes its row of o.
//
// What bounds it: spread over the card, bytes (x read once, 1 MB at the
// audit shape: 0.3 us at 3.35 TB/s); on one SM, that SM's load rate, with
// each thread reading its own row (neighbouring threads d floats apart, so
// no load is coalesced). That is the failure the analyzer names.
//
// C interface: det_mutant_full_block() launches on the given stream,
// allocates nothing and returns its CUDA error code.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 8;              // columns per register chunk
constexpr int SMEM_MAX = 232448;   // bytes a block may use on Hopper

__global__ void __launch_bounds__(THREADS)
    mutant_full_block_kernel(const float* __restrict__ x,
                             const float* __restrict__ v,
                             float* __restrict__ o, int rows, int d, int k,
                             int kp) {
  extern __shared__ __align__(16) float vs[];  // [d][kp]
  for (int idx = threadIdx.x; idx < d * kp; idx += THREADS) {
    const int t = idx / kp;
    const int j = idx - t * kp;
    vs[idx] = j < k ? v[(size_t)t * k + j] : 0.f;
  }
  __syncthreads();

  for (int row = threadIdx.x; row < rows; row += THREADS) {
    const float* xr = x + (size_t)row * d;
    for (int c0 = 0; c0 < kp; c0 += KC) {
      float acc[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[j] = 0.f;
      for (int t = 0; t < d; ++t) {
        const float a = __ldg(xr + t);
        const float4 b0 = *reinterpret_cast<const float4*>(vs + t * kp + c0);
        const float4 b1 = *reinterpret_cast<const float4*>(vs + t * kp + c0 + 4);
        acc[0] = fmaf(a, b0.x, acc[0]);
        acc[1] = fmaf(a, b0.y, acc[1]);
        acc[2] = fmaf(a, b0.z, acc[2]);
        acc[3] = fmaf(a, b0.w, acc[3]);
        acc[4] = fmaf(a, b1.x, acc[4]);
        acc[5] = fmaf(a, b1.y, acc[5]);
        acc[6] = fmaf(a, b1.z, acc[6]);
        acc[7] = fmaf(a, b1.w, acc[7]);
      }
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if (c0 + j < k) o[(size_t)row * k + c0 + j] = acc[j];
    }
  }
}

}  // namespace

// x: (rows, d) fp32 contiguous. v: (d, k) fp32 contiguous. o: (rows, k) fp32.
// One CTA of 256 threads, d * ceil(k / 8) * 8 * 4 bytes of dynamic shared
// memory (at most 227 KB).
extern "C" int det_mutant_full_block(const void* x, const void* v, void* o,
                                     int rows, int d, int k, void* stream) {
  if (rows < 1 || d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int kp = (k + KC - 1) / KC * KC;
  const size_t smem = sizeof(float) * (size_t)d * kp;
  if (smem > (size_t)SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mutant_full_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mutant_full_block_kernel<<<dim3(1, 1, 1), THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(v),
      static_cast<float*>(o), rows, d, k, kp);
  return static_cast<int>(cudaGetLastError());
}
