// Batched SPD inverse of 128x128 f32 blocks by the symmetric SWEEP operator.
//
// Replaces lqp_py_tpu/ops/pallas/spd_inverse.py::_sweep_kernel, the leaf of
// the block Schur-complement recursion (lqp_py_tpu_torch/ops/linalg.py
// _schur_inverse) under every KKT factorization of the box-QP solver and
// every backward solve (_schur_solve_rec).  The recurrence itself is
// sweep_tile.cuh.
//
// Design: one thread block of 256 threads per matrix (grid = B, one wave
// at the solver's B = 128 on the H100's 132 SMs).  The 64 KB tile lives in
// registers, 8 x 8 elements per thread; only the two pivot rows of each
// pivot pair pass through shared memory (2 KB, double-buffered), so a tile
// takes 64 rank-2 steps with one __syncthreads() each.  The input is read
// and the output written through their own batch and row strides with
// float4 accesses (scalar ones where either is not 16-byte aligned), so the
// recursion's diagonal-block views need no copy either way; the final
// negation is folded into the store.  The output may be the input: a block
// holds its whole tile in registers, and passes a barrier, before its
// first store, so neither pointer is __restrict__.
//
// Bound: the arithmetic, 128 * 128^2 FMAs per matrix (two per element and
// pivot pair), runs on one SM; the function's own bound is its bytes, each
// matrix read once and written once (64 KB each way; 16.8 MB at B = 128).

#include <cstdint>

#include <cuda_runtime.h>

#include "sweep_tile.cuh"

namespace {

constexpr int kM = kSweepM;                  // leaf size (matrix order)
using Tile = SweepTile<16, 16>;

template <bool kVec>
__global__ void __launch_bounds__(Tile::kThreads)
sweep_kernel(const float* H, long long batch_stride, long long row_stride,
             float* out, long long out_batch_stride,
             long long out_row_stride) {
  __shared__ __align__(16) float piv[Tile::kPivFloats];
  const float* src = H + blockIdx.x * batch_stride;
  float* dst = out + blockIdx.x * out_batch_stride;

  Tile t;
  t.load([&](int i, int j) {
    const float* s = src + i * row_stride + j;
    if constexpr (kVec) {
      return *reinterpret_cast<const float4*>(s);
    } else {
      return make_float4(s[0], s[1], s[2], s[3]);
    }
  });
  t.sweep(piv);
  t.store([&](int i, int j, float4 v) {
    float* d = dst + i * out_row_stride + j;
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(d) = make_float4(-v.x, -v.y, -v.z, -v.w);
    } else {
      d[0] = -v.x;
      d[1] = -v.y;
      d[2] = -v.z;
      d[3] = -v.w;
    }
  });
}

bool aligned4(const float* p, long long batch_stride, long long row_stride,
              int B) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row_stride % 4 == 0 &&
         (B == 1 || batch_stride % 4 == 0);
}

}  // namespace

// H: B m x m f32 matrices on the current device, matrix b's row i at
// H + b * batch_stride + i * row_stride (unit column stride, row_stride >= m,
// m must be 128); out: the same layout through out_batch_stride and
// out_row_stride, and it may be H itself.  Launches on stream s and returns
// cudaGetLastError(); it does not synchronise.
extern "C" int sweep_spd_inverse_f32(const float* H, long long batch_stride,
                                     long long row_stride, float* out,
                                     long long out_batch_stride,
                                     long long out_row_stride, int B, int m,
                                     cudaStream_t s) {
  if (m != kM || B < 0 || row_stride < kM || batch_stride < 0 ||
      out_row_stride < kM || out_batch_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const bool vec = aligned4(H, batch_stride, row_stride, B) &&
                   aligned4(out, out_batch_stride, out_row_stride, B);
  if (vec)
    sweep_kernel<true><<<B, Tile::kThreads, 0, s>>>(
        H, batch_stride, row_stride, out, out_batch_stride, out_row_stride);
  else
    sweep_kernel<false><<<B, Tile::kThreads, 0, s>>>(
        H, batch_stride, row_stride, out, out_batch_stride, out_row_stride);
  return (int)cudaGetLastError();
}

// Registers per thread and local-memory bytes per thread, the larger over
// the aligned and the unaligned build; local bytes other than 0 mean the
// register tile spilled.
extern "C" int sweep_spd_inverse_attributes(int* num_regs, int* local_bytes) {
  *num_regs = *local_bytes = 0;
  const void* fns[] = {(const void*)sweep_kernel<true>,
                       (const void*)sweep_kernel<false>};
  for (const void* fn : fns) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return (int)err;
    if (fa.numRegs > *num_regs) *num_regs = fa.numRegs;
    if ((int)fa.localSizeBytes > *local_bytes)
      *local_bytes = (int)fa.localSizeBytes;
  }
  return (int)cudaSuccess;
}
