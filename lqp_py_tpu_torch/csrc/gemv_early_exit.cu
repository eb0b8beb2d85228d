// ADMM x-update GEMV with per-element early exit: out[b] = P[b] @ r[b] for
// elements that have not converged, out[b] = x_prev[b] (bitwise) for those
// that have, whose P panel is never read.  P[b] is m x n: square (m = n) in
// the one-process solve, the rank's (N, L) column block of P in the
// column-sharded (tp) solve (lqp_py_tpu_torch/parallel/tp.py), which sums
// the ranks' partial products afterwards.
//
// Replaces lqp_py_tpu/ops/pallas/admm_step.py::_kernel / gemv_early_exit,
// the GEMV inside fused_admm_step that the box-QP solver runs once per
// iteration with use_pallas_step=True (lqp_py_tpu_torch/models/box_qp.py).
//
// The Pallas kernel keeps P in HBM and issues double-buffered DMAs by hand
// inside the predicated region, because BlockSpec prefetch cannot be
// predicated.  Nothing of that carries over: on Hopper a block that returns
// before its first load simply never reads its panel.
//
// Design: grid (ceil(m / kRows), B), 256 threads (8 warps); a batch of more
// than 65535 elements (the grid's y limit) is launched in chunks of at most
// that many on the same stream, each reading its own slice.  Each block reads
// its element's flag from device memory (no host read).  A frozen block
// copies its kRows entries of x_prev to out and returns.  An active block
// stages r[b] in shared memory (4 KB at n = 1024); each warp then takes rows
// in turn, reads each row with coalesced 16-byte loads (a scalar loop where
// n % 4 != 0 or P is not 16-byte aligned), accumulates in f32, reduces with
// __shfl_xor_sync, and lane 0 stores.  Any n is taken; the 256-alignment of
// the Pallas kernel was a TPU tiling constraint.  P's loads are marked
// streaming (evict-first): P is read once, r, x_prev and out stay in L2.
// Blocks of 32 rows (four per warp) read P faster than blocks of 64 on the
// H100; 16 gain little more and cost more when the whole batch is frozen.
//
// Bound: device-memory bytes, 4 m n per *active* element: 537 MB at B = 128,
// m = n = 1024 with none converged, about 160 us at 3.35 TB/s.  A converged
// element costs 4 m bytes of x_prev read and out written.
//
// A persistent grid balanced over the active rows, streaming P through a
// ring of bulk-TMA stages, was measured against this design on the H100 and
// lost on the solver's own traffic (the straggler batch's flags, replayed
// by lqp_py_tpu_torch/kernel_variants.py; PERF.md): most of its calls have
// nothing frozen, where it streamed P more slowly than these short blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;                    // rows of P per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;   // above it: opt-in attribute
constexpr size_t kMaxSmem = 232448;          // 227 KB per block on sm_90
constexpr int kMaxGridY = 65535;             // a grid's y extent at most

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gemv_early_exit_kernel(const float* __restrict__ P, const float* __restrict__ r,
                       const float* __restrict__ x_prev,
                       const uint8_t* __restrict__ converged,
                       float* __restrict__ out, int m, int n) {
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, m - row0);
  const size_t vec0 = (size_t)b * m + row0;  // this block's first out entry

  if (converged[b]) {
    for (int i = threadIdx.x; i < rows; i += kThreads)
      out[vec0 + i] = x_prev[vec0 + i];
    return;
  }

  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);
  const float* rb = r + (size_t)b * n;
  for (int j = threadIdx.x; j < n; j += kThreads) rs[j] = rb[j];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* Pb = P + (size_t)b * m * n;
  for (int i = warp; i < rows; i += kWarps) {
    const float* row = Pb + (size_t)(row0 + i) * n;
    float acc = 0.0f;
    if (kVec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const int n4 = n / 4;
#pragma unroll 8
      for (int k = lane; k < n4; k += 32) {
        const float4 a = __ldcs(row4 + k);
        const float4 v = smem4[k];
        acc += a.x * v.x + a.y * v.y + a.z * v.z + a.w * v.w;
      }
    } else {
      for (int k = lane; k < n; k += 32) acc += __ldcs(row + k) * rs[k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[vec0 + i] = acc;
  }
}

template <bool kVec>
int launch(const float* P, const float* r, const float* x_prev,
           const uint8_t* converged, float* out, int B, int m, int n,
           size_t smem, cudaStream_t s) {
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        gemv_early_exit_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((m + kRows - 1) / kRows, B);
  gemv_early_exit_kernel<kVec><<<grid, kThreads, smem, s>>>(
      P, r, x_prev, converged, out, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// P: B contiguous m x n f32 matrices; r: contiguous (B, n) f32; x_prev, out:
// contiguous (B, m) f32; converged: B bytes (0 = active).  All on the current
// device.  Launches on stream s and returns cudaGetLastError(); it does not
// synchronise.
extern "C" int gemv_early_exit_rect_f32(const float* P, const float* r,
                                        const float* x_prev,
                                        const uint8_t* converged, float* out,
                                        int B, int m, int n, cudaStream_t s) {
  if (B < 0 || m < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || m == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)n * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // m * n * 4 is a multiple of 16 where n % 4 == 0, so every row and every
  // chunk's P keep the first one's alignment.
  const bool vec = (n % 4 == 0) && ((uintptr_t)P % 16 == 0);
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = min(kMaxGridY, B - b0);
    const size_t v0 = (size_t)b0 * n;        // the chunk's first r entry
    const size_t x0 = (size_t)b0 * m;        // the chunk's first out entry
    const int rc =
        vec ? launch<true>(P + x0 * n, r + v0, x_prev + x0, converged + b0,
                           out + x0, nb, m, n, smem, s)
            : launch<false>(P + x0 * n, r + v0, x_prev + x0, converged + b0,
                            out + x0, nb, m, n, smem, s);
    if (rc != (int)cudaSuccess) return rc;
  }
  return (int)cudaSuccess;
}

// The square form (m = n), the one-process solve's: the same launch.
extern "C" int gemv_early_exit_f32(const float* P, const float* r,
                                   const float* x_prev,
                                   const uint8_t* converged, float* out,
                                   int B, int n, cudaStream_t s) {
  return gemv_early_exit_rect_f32(P, r, x_prev, converged, out, B, n, n, s);
}

// Registers per thread and local-memory bytes per thread of the vector path
// (the solver's: it pads n to 256).
extern "C" int gemv_early_exit_attributes(int* num_regs, int* local_bytes) {
  cudaFuncAttributes fa;
  const cudaError_t err =
      cudaFuncGetAttributes(&fa, gemv_early_exit_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  *num_regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)cudaSuccess;
}
