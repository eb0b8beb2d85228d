// Batched whole-matrix SPD inverse of (B, n, n) f32, n % 128 == 0, by the
// right-looking block Gauss-Jordan sweep with 128-wide pivot blocks.
//
// Replaces lqp_py_tpu/ops/pallas/block_inverse.py::_block_sweep_kernel (and
// its pivot sweep _sweep_tile_ref).  For each diagonal block K of M (= H at
// the start):
//     D = M[K,K];  V = M[:,K] D^-1;  M -= V M[:,K]^T;
//     M[:,K] = V;  M[K,:] = V^T;  M[K,K] = -D^-1
// and after the last block M = -H^-1, negated on the way out.  Like the
// Pallas kernel no solver calls it (lqp_py_tpu_torch/ops/kernels/
// block_inverse.py is its entry point).
//
// Bound: the rank-128 updates, about 2 n^3 full-f32 FMA flops per matrix
// (2.15 GFLOP at n = 1024, 275 GFLOP for B = 128: ~4.1 ms at the H100's
// 67 TFLOP/s f32 rate), against 2 * 4 * n^2 bytes of input and output
// (~0.32 ms at 3.35 TB/s).  Full f32 to match the Pallas kernel's
// Precision.HIGHEST products.
//
// Design (a simple first version): grid (B,), one CTA of 512 threads per
// matrix, looping over the n/128 block steps, so no grid-wide sync is
// needed; at B = 128 that is one wave on 132 SMs.  A 1024^2 matrix (4 MB)
// does not fit in shared memory, so M lives in the output buffer and every
// step streams it through L2.  Per step:
//   1. D swept to -D^-1 in registers (sweep_tile.cuh, 4 x 8 elements per
//      thread), then stored into shared memory.
//   2. The column panel M[:,K] transposed into the scratch ct (128, n) via
//      a padded shared-memory tile, so every later panel read is
//      contiguous.
//   3. vt (128, n) = V^T = -(-D^-1)^T ct, a 128x128-tile GEMM.
//   4. M -= V C^T over 128x128 tiles: the V^T tile of the row block stays
//      in shared memory while the ct panel streams through a double
//      buffer of 32-row chunks (register prefetch); each thread keeps a
//      4x8 accumulator.  The row and column block K are skipped: step 5
//      overwrites them.
//   5. V into column block K (transposed back through shared memory), V^T
//      into row block K, -D^-1 into M[K,K].
// __syncthreads() separates the phases; global writes of the CTA are
// visible to its own threads after it.  Later work: wgmma with a 3xTF32
// split, TMA panels, and symmetry to halve the update.

#include <cuda_runtime.h>

#include "sweep_tile.cuh"

namespace {

constexpr int kB = kSweepM;                  // pivot block width, tile edge
constexpr int kThreads = 512;
constexpr int kKc = 32;                      // rows of a streamed panel chunk
constexpr int kChunks = kB / kKc;            // chunks per 128x128 tile
constexpr int kSPad = kB + 1;                // conflict-free transpose stride
using Tile = SweepTile<32, 16>;
static_assert(Tile::kThreads == kThreads, "one sweep thread per thread");

// Shared memory, in floats.
constexpr int kTileOff = 0;                  // 128 x 128: -D^-1
constexpr int kPivOff = kB * kB;             // the sweep's pivot buffers
constexpr int kAOff = kPivOff + Tile::kPivFloats;  // A tile [k][i] or stage
constexpr int kBOff = kAOff + kB * kSPad;    // 2 x 32 x 128 streamed chunks
constexpr size_t kSmemBytes = (size_t)(kBOff + 2 * kKc * kB) * sizeof(float);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// acc[r][c] += sum_k A[k][ty*4 + r] * Bc[k][col(c)] over one chunk, with
// col(c) = tx*4 + c for c < 4 and 64 + tx*4 + (c-4) otherwise.  A and Bc
// are k-major with row stride 128.
__device__ __forceinline__ void fma_chunk(const float* A, const float* Bc,
                                          float (&acc)[4][8], int tx,
                                          int ty) {
#pragma unroll
  for (int k = 0; k < kKc; ++k) {
    const float4 a = ld4(A + k * kB + ty * 4);
    const float4 b0 = ld4(Bc + k * kB + tx * 4);
    const float4 b1 = ld4(Bc + k * kB + 64 + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// Rows k0..k0+31, columns J..J+127 of a (128, n) k-major panel: two float4
// per thread.
__device__ __forceinline__ void load_chunk(const float* src, int n, int k0,
                                           int J, float4 (&v)[2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = threadIdx.x + kThreads * s;
    v[s] = ld4(src + (size_t)(k0 + (e >> 5)) * n + J + (e & 31) * 4);
  }
}

__device__ __forceinline__ void store_chunk(float* Bc, const float4 (&v)[2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = threadIdx.x + kThreads * s;
    st4(Bc + (e >> 5) * kB + (e & 31) * 4, v[s]);
  }
}

// For every 128-column tile J of the (128, n) global panel `bsrc` except
// tile `skip`: acc = A^T bsrc[:, J:J+128] (A: 128x128 k-major in shared
// memory), then epi(J, acc).  Streams bsrc in 32-row chunks through the
// double buffer Bs with a register prefetch of the next chunk.  Ends
// synchronised.
template <class Epi>
__device__ __forceinline__ void panel_gemm(const float* A,
                                           const float* bsrc, int n,
                                           int skip, float* Bs, Epi epi) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nchunks = (n / kB - 1) * kChunks;  // every tile but `skip`
  if (nchunks == 0) return;
  auto tile_col = [&](int c) {
    const int t = c / kChunks;
    return (t >= skip ? t + 1 : t) * kB;
  };
  float4 pre[2];
  load_chunk(bsrc, n, 0, tile_col(0), pre);
  store_chunk(Bs, pre);
  __syncthreads();
  float acc[4][8] = {};
  for (int c = 0; c < nchunks; ++c) {
    float* cur = Bs + (c & 1) * kKc * kB;
    const bool more = c + 1 < nchunks;
    if (more) load_chunk(bsrc, n, ((c + 1) % kChunks) * kKc, tile_col(c + 1),
                         pre);
    fma_chunk(A + (c % kChunks) * kKc * kB, cur, acc, tx, ty);
    if (c % kChunks == kChunks - 1) {
      epi(tile_col(c), acc, tx, ty);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
    }
    if (more) store_chunk(Bs + ((c + 1) & 1) * kKc * kB, pre);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
block_sweep_kernel(const float* __restrict__ H, float* __restrict__ out,
                   float* __restrict__ ct_all, float* __restrict__ vt_all,
                   int n) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem + kTileOff;
  float* piv = smem + kPivOff;
  float* As = smem + kAOff;
  float* Bs = smem + kBOff;

  const size_t nn = (size_t)n * n;
  const float* src = H + blockIdx.x * nn;
  float* M = out + blockIdx.x * nn;
  float* ct = ct_all + (size_t)blockIdx.x * kB * n;
  float* vt = vt_all + (size_t)blockIdx.x * kB * n;
  const int tid = threadIdx.x;
  const int nb = n / kB;
  const int n4 = n / 4;

  for (size_t e = tid; e < nn / 4; e += kThreads) st4(M + 4 * e, ld4(src + 4 * e));
  __syncthreads();

  for (int kb = 0; kb < nb; ++kb) {
    const int off = kb * kB;

    // 1. D = M[K,K] -> -D^-1, swept in registers, into shared memory.
    {
      Tile d;
      d.load([&](int i, int j) {
        return ld4(M + (size_t)(off + i) * n + off + j);
      });
      d.sweep(piv);
      d.store([&](int i, int j, float4 v) { st4(tile + i * kB + j, v); });
    }
    __syncthreads();

    // 2. ct[k][r] = M[r][off + k] for row tiles R != kb.
    for (int R = 0; R < nb; ++R) {
      if (R == kb) continue;
      for (int e = tid; e < kB * kB; e += kThreads) {
        const int r = e / kB, k = e % kB;
        As[r * kSPad + k] = M[(size_t)(R * kB + r) * n + off + k];
      }
      __syncthreads();
      for (int e = tid; e < kB * kB; e += kThreads) {
        const int k = e / kB, r = e % kB;
        ct[(size_t)k * n + R * kB + r] = As[r * kSPad + k];
      }
      __syncthreads();
    }

    // 3. vt[j][i] = V[i][j] = -sum_k tile[k][j] ct[k][i], i outside K.
    panel_gemm(tile, ct, n, kb, Bs,
               [&](int I, const float (&acc)[4][8], int tx, int ty) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* a = acc[r] + 4 * h;
          st4(vt + (size_t)(ty * 4 + r) * n + I + 64 * h + tx * 4,
              make_float4(-a[0], -a[1], -a[2], -a[3]));
        }
    });

    // 4. M[I+i][J+j] -= sum_k vt[k][I+i] ct[k][J+j] for I, J != kb.
    for (int I = 0; I < nb; ++I) {
      if (I == kb) continue;
      for (int e = tid; e < kB * kB / 4; e += kThreads) {
        const int k = e / 32, i = (e % 32) * 4;
        st4(As + k * kB + i, ld4(vt + (size_t)k * n + I * kB + i));
      }
      __syncthreads();
      panel_gemm(As, ct, n, kb, Bs,
                 [&](int J, const float (&acc)[4][8], int tx, int ty) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* m = M + (size_t)(I * kB + ty * 4 + r) * n + J + 64 * h +
                       tx * 4;
            const float* a = acc[r] + 4 * h;
            float4 v = ld4(m);
            v.x -= a[0]; v.y -= a[1]; v.z -= a[2]; v.w -= a[3];
            st4(m, v);
          }
      });
    }

    // 5. Write-back: row block K <- V^T, column block K <- V (through the
    // transpose stage), M[K,K] <- -D^-1.  The three regions are disjoint.
    for (int e = tid; e < kB * n4; e += kThreads) {
      const int k = e / n4, c = (e % n4) * 4;
      if (c / kB != kb)
        st4(M + (size_t)(off + k) * n + c, ld4(vt + (size_t)k * n + c));
    }
    for (int e = tid; e < kB * kB; e += kThreads)
      M[(size_t)(off + e / kB) * n + off + e % kB] = tile[e];
    for (int R = 0; R < nb; ++R) {
      if (R == kb) continue;
      for (int e = tid; e < kB * kB; e += kThreads) {
        const int k = e / kB, r = e % kB;
        As[k * kSPad + r] = vt[(size_t)k * n + R * kB + r];
      }
      __syncthreads();
      for (int e = tid; e < kB * kB; e += kThreads) {
        const int r = e / kB, k = e % kB;
        M[(size_t)(R * kB + r) * n + off + k] = As[k * kSPad + r];
      }
      __syncthreads();
    }
    __syncthreads();
  }

  for (size_t e = tid; e < nn / 4; e += kThreads) {
    float4 v = ld4(M + 4 * e);
    st4(M + 4 * e, make_float4(-v.x, -v.y, -v.z, -v.w));
  }
}

}  // namespace

// H, out: B contiguous n x n f32 matrices on the current device, n a
// multiple of 128; ct, vt: B x 128 x n f32 scratch.  Launches on stream s
// and returns cudaGetLastError(); it does not synchronise.
extern "C" int block_spd_inverse_f32(const float* H, float* out, float* ct,
                                     float* vt, int B, int n,
                                     cudaStream_t s) {
  if (B < 0 || n <= 0 || n % kB) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      block_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  block_sweep_kernel<<<B, kThreads, kSmemBytes, s>>>(H, out, ct, vt, n);
  return (int)cudaGetLastError();
}

// Registers per thread and local-memory bytes per thread of the kernel.
extern "C" int block_spd_inverse_attributes(int* num_regs, int* local_bytes) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, block_sweep_kernel);
  if (err != cudaSuccess) return (int)err;
  *num_regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)cudaSuccess;
}
