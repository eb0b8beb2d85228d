// Symmetric SWEEP of one 128x128 f32 tile held in registers, shared by the
// SWEEP-leaf kernel (sweep_spd_inverse.cu) and the block-sweep inverse
// (block_spd_inverse.cu).
//
// Sweeping pivot k of a symmetric A (d = A[k,k]) maps
//     A[k,k] -> -1/d,   A[i,k] -> A[i,k]/d,   A[k,j] -> A[k,j]/d,
//     A[i,j] -> A[i,j] - A[i,k] A[k,j] / d          (i, j != k);
// sweeping every pivot of an SPD matrix gives -A^-1 (each pivot is a Schur
// complement diagonal, hence positive: no pivoting).  As in the Pallas leaf
// (lqp_py_tpu/ops/pallas/spd_inverse.py::_sweep_kernel) the map is written
// A - u v^T with u = A[k,:] - e_k and v = u / d, which is exact everywhere
// but at (k,k), where it leaves 2 - 1/d; the 2 comes off right after the
// step (carried to the end, it would double the diagonal's rounding error
// where the inverse's diagonal is near 1).  Symmetry lets the pivot row
// stand in for the pivot column.
//
// Pivots go in pairs (k, k+1), as in the Pallas leaf: with u1 = row k - e_k
// and v1 = u1 / d1, row k+1 after the first sweep is row(k+1) - u1[k+1] v1,
// an O(1) correction per value, so the pair is one rank-2 update
//     A -= u1 v1^T + u2 v2^T.
// The pivots d1, d2 come from the rows' raw diagonals, kept beside the u
// rows: recovered as u[k] + 1 they would lose the low bits of a small
// pivot (an ill-conditioned tile's error about doubles).
//
// Layout: a kTY x kTX grid of threads; thread (ty, tx) keeps in registers
// the elements at rows row(r) and columns col(c), runs of four consecutive
// indices 4*kTY (rows) or 4*kTX (columns) apart, so that pivot-row reads
// and tile loads and stores are float4.  The only shared values are the two
// pivot rows of a pair, stored as u (the row minus e_k) with their raw
// diagonals in one of two buffers: the threads that hold rows k+2 and k+3
// write them into the other buffer right after their update, so each pair
// ends in one __syncthreads() (64 per tile, against 128 for one pivot per
// step).  Every loop over a thread's elements is unrolled with compile-time
// indices, so the tile never leaves registers: the loop takes two pairs per
// trip, so that the register row holding the next pivot rows is known but
// for its run of four, which a value select picks.

#pragma once

constexpr int kSweepM = 128;                 // tile order

template <int kTY, int kTX>
struct SweepTile {
  static constexpr int kThreads = kTY * kTX;
  static constexpr int kRows = kSweepM / kTY;  // rows held per thread
  static constexpr int kCols = kSweepM / kTX;  // columns held per thread
  static_assert(kRows % 4 == 0 && kCols % 4 == 0, "runs of four per thread");
  static_assert(kRows >= 2, "a pivot pair lies in one thread row");
  // Shared floats of the pivot buffers: 2 buffers x 2 rows x 128, then
  // 2 buffers x 2 raw diagonals.
  static constexpr int kPivFloats = 4 * kSweepM + 4;

  float a[kRows][kCols];
  int ty, tx;

  __device__ __forceinline__ SweepTile()
      : ty(threadIdx.x / kTX), tx(threadIdx.x % kTX) {}

  // Tile row of this thread's r-th row and column of its c-th column.
  __device__ __forceinline__ int row(int r) const {
    return (r / 4) * 4 * kTY + 4 * ty + r % 4;
  }
  __device__ __forceinline__ int col(int c) const {
    return (c / 4) * 4 * kTX + 4 * tx + c % 4;
  }

  // a <- A, with ld(i, j) the float4 A[i, j..j+3].
  template <class Ld>
  __device__ __forceinline__ void load(Ld ld) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        const float4 v = ld(row(r), col(c));
        a[r][c] = v.x;
        a[r][c + 1] = v.y;
        a[r][c + 2] = v.z;
        a[r][c + 3] = v.w;
      }
  }

  // st(i, j, v) for each run of four: v = a at (i, j..j+3).
  template <class St>
  __device__ __forceinline__ void store(St st) const {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; c += 4)
        st(row(r), col(c), make_float4(a[r][c], a[r][c + 1], a[r][c + 2],
                                       a[r][c + 3]));
  }

  // On entry a holds a symmetric A and no thread reads piv (kPivFloats
  // shared floats); on exit a holds -A^-1 and piv is free again.
  __device__ __forceinline__ void sweep(float* piv) {
    put_pivots<0>(piv, 0);
    __syncthreads();
    // Two pairs per trip, so that k % 4, and with it the register row that
    // holds the next pivot rows, is known at compile time.
#pragma unroll 1
    for (int k = 0; k < kSweepM; k += 4) {
      pair<0>(piv, k);
      pair<2>(piv, k + 2);
    }
  }

 private:
  __device__ __forceinline__ static float4 ld4(const float* s) {
    return *reinterpret_cast<const float4*>(s);
  }

  // Pivots k, k+1 (k % 4 == kS) as one rank-2 update; then rows k+2, k+3
  // into the other buffer and the pair's one barrier.
  template <int kS>
  __device__ __forceinline__ void pair(float* piv, int k) {
    constexpr int b = kS / 2;              // this pair's buffer, (k / 2) % 2
    const float* u1s = piv + b * 2 * kSweepM;
    const float* u2s = u1s + kSweepM;
    const float2 d = *reinterpret_cast<const float2*>(
        piv + 4 * kSweepM + 2 * b);        // A[k,k], A[k+1,k+1]
    const float e = u1s[k + 1];            // A[k, k+1]
    const float dinv1 = 1.0f / d.x;
    const float dinv2 = 1.0f / fmaf(-e, e * dinv1, d.y);
    // Rows: u1 and u2 = u(k+1) - e v1.  Columns: v1 and v2 = u2 / d2.
    float ur1[kRows], ur2[kRows], vc1[kCols], vc2[kCols];
#pragma unroll
    for (int r = 0; r < kRows; r += 4) {
      const float4 x1 = ld4(u1s + row(r));
      const float4 x2 = ld4(u2s + row(r));
      const float y1[4] = {x1.x, x1.y, x1.z, x1.w};
      const float y2[4] = {x2.x, x2.y, x2.z, x2.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ur1[r + q] = y1[q];
        ur2[r + q] = fmaf(-e, y1[q] * dinv1, y2[q]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; c += 4) {
      const float4 x1 = ld4(u1s + col(c));
      const float4 x2 = ld4(u2s + col(c));
      const float y1[4] = {x1.x, x1.y, x1.z, x1.w};
      const float y2[4] = {x2.x, x2.y, x2.z, x2.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        vc1[c + q] = y1[q] * dinv1;
        vc2[c + q] = fmaf(-e, vc1[c + q], y2[q]) * dinv2;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        a[r][c] = fmaf(-ur2[r], vc2[c], fmaf(-ur1[r], vc1[c], a[r][c]));
    // (k,k) and (k+1,k+1) came out 2 too large.  They sit at register rows
    // 4i + kS (+1) and columns 4j + kS (+1) of one thread, for runs i, j
    // known only at run time: subtract 2 or 0 from every candidate.
    const bool holds = ty == (k % (4 * kTY)) / 4 && tx == (k % (4 * kTX)) / 4;
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols / 4; ++j) {
        const float two = holds && k / (4 * kTY) == i && k / (4 * kTX) == j
                              ? 2.0f : 0.0f;
        a[4 * i + kS][4 * j + kS] -= two;
        a[4 * i + kS + 1][4 * j + kS + 1] -= two;
      }
    if (kS == 0 || k + 2 < kSweepM) put_pivots<(kS + 2) % 4>(piv, k + 2);
    __syncthreads();
  }

  // Into buffer (k / 2) % 2: row k - e_k, row k+1 - e_{k+1} and their raw
  // diagonals, from the threads that hold them.  k % 4 == kQ (0 or 2), so
  // both rows lie in one run of four of one thread row, at register rows
  // 4g + kQ and 4g + kQ + 1; the run g is picked by value selects, not by a
  // runtime register index (which would put the tile in local memory).
  template <int kQ>
  __device__ __forceinline__ void put_pivots(float* piv, int k) const {
    if (ty != (k % (4 * kTY)) / 4) return;
    const int g = k / (4 * kTY);
    constexpr int b = kQ / 2;
    float* buf = piv + b * 2 * kSweepM;
    float* diag = piv + 4 * kSweepM + 2 * b;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float x = a[kQ + h][c + q];
#pragma unroll
          for (int gg = 1; gg < kRows / 4; ++gg)
            x = g == gg ? a[4 * gg + kQ + h][c + q] : x;
          const bool on_diag = col(c + q) == k + h;
          if (on_diag) diag[h] = x;
          v[q] = on_diag ? x - 1.0f : x;
        }
        *reinterpret_cast<float4*>(buf + h * kSweepM + col(c)) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
  }
};
