// Batched SPD inverse of 128x128 f32 blocks by the symmetric SWEEP operator.
//
// Replaces lqp_py_tpu/ops/pallas/spd_inverse.py::_sweep_kernel, the leaf of
// the block Schur-complement recursion (lqp_py_tpu_torch/ops/linalg.py
// _schur_inverse) under every KKT factorization of the box-QP solver and
// every backward solve (_schur_solve_rec).  The recurrence itself is
// sweep_tile.cuh.
//
// Design: one thread block per matrix (grid = B, one wave of 128 blocks on
// the H100's 132 SMs at the solver's B = 128).  The 64 KB tile lives in
// dynamic shared memory for all 128 steps, with 512 threads on it.  The
// final negation is folded into the store.
//
// Bound: the 128-step dependency chain and shared-memory traffic (one load
// and one store of every tile element per step), not device memory — each
// matrix is read once and written once (64 KB each way).  Later work can
// keep each thread's share of the tile in registers with only the pivot
// row in shared memory, or fuse two pivots per pass as the Pallas leaf does
// (rank-2 steps halve the tile read-modify-writes).

#include <cuda_runtime.h>

#include "sweep_tile.cuh"

namespace {

constexpr int kM = kSweepM;                  // leaf size (matrix order)
constexpr int kThreads = 512;
constexpr size_t kSmemBytes = (size_t)(kM * kM + 2 * kM) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ H, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* tile = smem;                        // kM * kM, row-major
  float* prow = smem + kM * kM;              // 2 * kM: pivot row, double-buffered

  const size_t base = (size_t)blockIdx.x * kM * kM;
  const float* src = H + base;
  float* dst = out + base;
  const int tid = threadIdx.x;

  for (int e = tid; e < kM * kM; e += kThreads) tile[e] = src[e];
  if (tid < kM) prow[tid] = src[tid];        // pivot row 0
  __syncthreads();

  sweep_tile<kThreads>(tile, prow);

  for (int e = tid; e < kM * kM; e += kThreads) dst[e] = -tile[e];
}

}  // namespace

// H, out: B contiguous m x m f32 matrices on the current device (m must be
// 128).  Launches on stream s and returns cudaGetLastError(); it does not
// synchronise.
extern "C" int sweep_spd_inverse_f32(const float* H, float* out, int B, int m,
                                     cudaStream_t s) {
  if (m != kM || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<<<B, kThreads, kSmemBytes, s>>>(H, out);
  return (int)cudaGetLastError();
}
