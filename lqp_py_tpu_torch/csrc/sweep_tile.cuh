// In-place symmetric SWEEP of one 128x128 f32 tile in shared memory, shared
// by the SWEEP-leaf kernel (sweep_spd_inverse.cu) and the block-sweep
// inverse (block_spd_inverse.cu).
//
// Sweeping pivot k of a symmetric A (d = A[k,k]) maps
//     A[k,k] -> -1/d,   A[i,k] -> A[i,k]/d,   A[k,j] -> A[k,j]/d,
//     A[i,j] -> A[i,j] - A[i,k] A[k,j] / d          (i, j != k);
// sweeping every pivot of an SPD matrix gives -A^-1 (each pivot is a Schur
// complement diagonal, hence positive: no pivoting).  Symmetry lets the
// pivot row stand in for the pivot column, so a step reads one row.
//
// Each of the kThreads threads owns a fixed set of tile elements (one
// column, every (kThreads/128)-th row), so a step needs no tile reads from
// other threads: the only shared value is the pivot row, kept
// double-buffered so that each step ends in a single __syncthreads().  The
// thread that writes row k+1 during step k also writes it into the next
// pivot buffer.

#pragma once

constexpr int kSweepM = 128;                 // tile order

// On entry: tile (row-major 128x128) holds A, prow[0..128) holds its row 0,
// and the block is synchronised.  On exit: tile holds -A^-1, synchronised.
// blockDim.x must be kThreads.
template <int kThreads>
__device__ __forceinline__ void sweep_tile(float* tile, float* prow) {
  static_assert(kThreads % kSweepM == 0, "whole columns per thread group");
  constexpr int kRowStride = kThreads / kSweepM;
  const int tid = threadIdx.x;
  const int j = tid % kSweepM;               // this thread's column
  const int i0 = tid / kSweepM;              // and its first row
  for (int k = 0; k < kSweepM; ++k) {
    const float* p = prow + (k & 1) * kSweepM;
    float* p_next = prow + ((k + 1) & 1) * kSweepM;
    const float dinv = 1.0f / p[k];
    const float vj = p[j] * dinv;
    for (int i = i0; i < kSweepM; i += kRowStride) {
      float a;
      if (i == k) {
        a = (j == k) ? -dinv : vj;
      } else if (j == k) {
        a = p[i] * dinv;
      } else {
        a = tile[i * kSweepM + j] - p[i] * vj;
      }
      tile[i * kSweepM + j] = a;
      if (i == k + 1) p_next[j] = a;
    }
    __syncthreads();
  }
}
