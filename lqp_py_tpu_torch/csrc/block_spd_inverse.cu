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
// Bound of the function: an SPD inverse needs about n^3 flops (1.07 GFLOP
// at n = 1024; 137 GFLOP for B = 128: 2.05 ms at the H100's 67 TFLOP/s f32
// rate, 0.83 ms at the 3xTF32 rate of 495/3 TFLOP/s), against 2 * 4 * n^2
// bytes of input and output (0.32 ms at 3.35 TB/s).  This design's own cost
// is higher: with symmetry the updates are ~n^3 + n^2 * 128 multiply-adds
// per matrix (2.3 GFLOP, ~0.9 ms for B = 128 at the 3xTF32 rate), and a
// 4 MB matrix does not fit on chip, so every step moves the upper triangle
// of M through HBM (~0.5 GB per step over the batch, ~1.1 ms in all).
//
// Design: grid (B,), one CTA of 256 threads (two warpgroups) per matrix,
// looping over the n/128 block steps, so no grid-wide sync is needed.  M
// lives in the output buffer and only its upper block triangle (tiles
// I <= J, diagonal tiles whole) is kept during the sweep; the lower one is
// mirrored once at the end, with the negation.  Per step:
//   1. D = M[K,K] swept to -D^-1 in registers (sweep_tile.cuh, 8 x 8
//      elements per thread), written to M[K,K] and, split into TF32 hi and
//      lo parts, into shared memory as the held wgmma operand.
//   2. The column panel C = M[:,K], held as (n, 128) rows with the pivot
//      index contiguous (K-major): rows above K are M's own tiles (I, K)
//      and are read in place; rows below K are the transposes of the upper
//      tiles (K, I), written to the scratch ct.
//   3. W = C (-D^-1) = -V into the scratch w (n, 128), as W^T = (-D^-1) C^T
//      with -D^-1 held and C streamed.
//   4. M[I,J] += W[I] C[J]^T for I <= J (I, J != K): W[I] is loaded by TMA
//      and held split in shared memory, C[J] streamed.
//   5. Write-back: tiles (I, K), I < K, get V = -W; tiles (K, J), J > K,
//      get V^T through a shared-memory transpose.
// Both products run on the tensor cores as wgmma m64n64k8 tf32 with both
// operands in shared memory, three passes per product (A_lo B_hi + A_hi
// B_lo + A_hi B_hi, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)),
// accumulated in f32: about f32 accuracy, as the Pallas kernel's
// Precision.HIGHEST products have.  The streamed operand arrives in 64-row
// by 32-column boxes of 8 KB (2-D TMA through 3-D tensor maps with row
// stride n, 128-byte swizzle, the layout wgmma reads) into a ring of 5
// stages, each split into hi (in place) and lo while the previous box's
// products run.  Each warpgroup computes 64 of the 128 rows of a 128 x 64
// output tile; the tile's M values come in by TMA into a shared output
// tile while its products run, are updated there and go out by TMA store
// (step 3 stores W the same way).  The transposes, copies and the final
// mirror move whole 128 x 128 tiles with float4 loads, all issued before
// the first store.  Shared memory: 128 KB held operand, 40 KB ring, 16 KB
// of lo buffers, 32 KB output tile, the sweep's pivot rows.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "sweep_tile.cuh"

namespace {

constexpr int kB = kSweepM;                  // pivot block width, tile edge
constexpr int kThreads = 256;                // two warpgroups
using Tile = SweepTile<16, 16>;
static_assert(Tile::kThreads == kThreads, "one sweep thread per thread");
constexpr int kStages = 5;                   // streamed-operand ring
constexpr int kBoxRows = 64, kBoxCols = 32;  // one TMA box: 8 KB
constexpr int kBoxBytes = kBoxRows * kBoxCols * 4;
constexpr int kKChunks = kB / kBoxCols;      // 4 boxes along the pivot index
constexpr int kPad = kB + 1;                 // conflict-free transpose stride

// Dynamic shared memory, in bytes from a 1024-aligned base (128-byte
// swizzle atoms are 1 KB).  The held operand is [kc][row 0..127][32] per
// part; a ring stage holds one box, split to hi in place, its lo part goes
// to one of two lo buffers.
constexpr int kAHiOff = 0;
constexpr int kALoOff = kAHiOff + kB * kB * 4;
constexpr int kRingOff = kALoOff + kB * kB * 4;
constexpr int kStageBytes = kBoxBytes;
constexpr int kLoOff = kRingOff + kStages * kStageBytes;
constexpr int kOutOff = kLoOff + 2 * kBoxBytes;  // output tile, 4 boxes
constexpr int kPivOff = kOutOff + 4 * kBoxBytes;
constexpr int kSmemBytes = kPivOff + Tile::kPivFloats * 4;
constexpr size_t kSmemAlloc = kSmemBytes + 1024;   // room to align the base
static_assert(kSmemAlloc + 128 <= 232448, "227 KB per block on sm_90");
static_assert(kB * kPad * 4 <= kPivOff - kRingOff,
              "the transpose stage fits in the ring");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// x -> (hi, lo) with hi = rna(x), lo = rna(x - hi).
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                   tf32_rna(x.w));
  lo = make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                   tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
}

// Split `floats` floats at hi (in place) into hi and lo.
__device__ __forceinline__ void split_region(float* hi, float* lo,
                                             int floats) {
  for (int e = threadIdx.x * 4; e < floats; e += kThreads * 4) {
    float4 h, l;
    split4(ld4(hi + e), h, l);
    st4(hi + e, h);
    st4(lo + e, l);
  }
}

// Float offset of (row, k) in a K-major tile of 32-float rows with the
// 128-byte swizzle: the 16-byte chunk k / 4 of row r sits at k / 4 ^ r % 8.
__device__ __forceinline__ int swz(int row, int k) {
  return row * kBoxCols + ((((k >> 2) ^ row) & 7) << 2) + (k & 3);
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled operand:
// 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B^T for a 64 x 8 A and a 64 x 8 B, tf32, f32 accumulators.
__device__ __forceinline__ void wgmma_64x64x8(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// This thread's accumulator coordinates in a 128 x 64 output tile: element
// 4c + 2h + e sits at row acc_row(h), column acc_col(c) + e.
__device__ __forceinline__ int acc_row(int h) {
  const int t = threadIdx.x;
  return 64 * (t / 128) + 16 * ((t % 128) / 32) + (t % 32) / 4 + 8 * h;
}
__device__ __forceinline__ int acc_col(int c) {
  return 8 * c + 2 * (threadIdx.x % 4);
}

struct Smem {
  float* a_hi;
  float* a_lo;
  char* ring;
  float* lo;        // two lo buffers of one box
  float* out;       // a 64 x 128 or 128 x 64 output tile as four boxes
  float* piv;
  uint64_t* full;   // kStages ring barriers
  uint64_t* abar;   // held-operand load barrier
  uint64_t* obar;   // output-tile load barrier
};

// Stream nq operand tiles of 64 rows x 128 through the ring and multiply
// each by the held 128 x 128 operand: acc = A_held B^T (128 x 64; each
// warpgroup 64 rows).  src(q, kc, &map, &x, &y) names box kc of tile q;
// epi.pre(q) runs before tile q's products, epi.post(q, acc) after.  `tg`
// counts ring boxes over the kernel (stage and barrier parity).  Ends
// synchronised.
template <class Src, class Epi>
__device__ __forceinline__ void run_stream(const Smem& sm, int nq, Src src,
                                           Epi& epi, uint32_t& tg) {
  const int total = nq * kKChunks;
  if (total == 0) return;
  auto issue = [&](int t) {
    const uint32_t s = (tg + t) % kStages;
    const void* map;
    int x, y;
    src(t / kKChunks, t % kKChunks, &map, &x, &y);
    mbar_expect_tx(&sm.full[s], kBoxBytes);
    tma_load_3d(sm.ring + s * kStageBytes, map, x, y, blockIdx.x,
                &sm.full[s]);
  };
  auto stage = [&](int t) {
    return reinterpret_cast<float*>(sm.ring + ((tg + t) % kStages) *
                                                  kStageBytes);
  };
  auto lo_of = [&](int t) { return sm.lo + (t & 1) * kBoxRows * kBoxCols; };
  // Box t arrived: split it into hi (in place) and lo.
  auto land = [&](int t) {
    mbar_wait(&sm.full[(tg + t) % kStages], ((tg + t) / kStages) & 1);
    split_region(stage(t), lo_of(t), kBoxRows * kBoxCols);
    fence_proxy_async_smem();
  };
  if (threadIdx.x == 0)
    for (int t = 0; t < min(kStages, total); ++t) issue(t);
  const int wg = threadIdx.x / 128;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  land(0);
  __syncthreads();
  // Box t's products run while box t + 1 is split; box t + kStages is
  // loaded into box t's stage once every warpgroup is done with it.
  for (int t = 0; t < total; ++t) {
    const int q = t / kKChunks, kc = t % kKChunks;
    if (kc == 0) epi.pre(q);
    const float* bhi = stage(t);
    const float* blo = lo_of(t);
    const float* ahi = sm.a_hi + kc * kB * kBoxCols + wg * 64 * kBoxCols;
    const float* alo = sm.a_lo + kc * kB * kBoxCols + wg * 64 * kBoxCols;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < kBoxCols / 8; ++k8) {
      const int first = kc == 0 && k8 == 0;
      wgmma_64x64x8(acc, gmma_desc(alo + 8 * k8), gmma_desc(bhi + 8 * k8),
                    !first);
      wgmma_64x64x8(acc, gmma_desc(ahi + 8 * k8), gmma_desc(blo + 8 * k8), 1);
      wgmma_64x64x8(acc, gmma_desc(ahi + 8 * k8), gmma_desc(bhi + 8 * k8), 1);
    }
    wgmma_commit();
    if (t + 1 < total) land(t + 1);
    wgmma_wait_all();
    fence_acc(acc);
    if (kc == kKChunks - 1) epi.post(q, acc);
    __syncthreads();
    if (threadIdx.x == 0 && t + kStages < total) issue(t + kStages);
  }
  tg += total;
}

// Each thread's float4 of a 128 x 128 tile pass: 8 at a time, 64 rows of
// the tile, all loads of a half issued before its first use.
constexpr int kPer = kB * kB / 4 / kThreads / 2;

// dst[r][c] = s * src[c][r] for a 128 x 128 tile (row strides ls, ld),
// through the 128 x 129 stage T, with float4 loads and stores; with
// `scale_src` src is also rewritten as s * src.
__device__ __forceinline__ void tile_transpose(float* src, size_t ls,
                                               float* dst, size_t ld, float s,
                                               float* T,
                                               bool scale_src = false) {
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    float4 v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + (half * kPer + i) * kThreads;
      v[i] = ld4(src + (size_t)(e / 32) * ls + (e % 32) * 4);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + (half * kPer + i) * kThreads;
      const int c = e / 32, r = (e % 32) * 4;
      T[(r + 0) * kPad + c] = v[i].x;
      T[(r + 1) * kPad + c] = v[i].y;
      T[(r + 2) * kPad + c] = v[i].z;
      T[(r + 3) * kPad + c] = v[i].w;
    }
  }
  __syncthreads();
#pragma unroll 2
  for (int i = 0; i < 2 * kPer; ++i) {
    const int e = threadIdx.x + i * kThreads, r = e / 32, c = (e % 32) * 4;
    const float* t = T + r * kPad + c;
    st4(dst + (size_t)r * ld + c,
        make_float4(s * t[0], s * t[1], s * t[2], s * t[3]));
    if (scale_src) {
      const float* u = T + c * kPad + r;
      st4(src + (size_t)r * ls + c,
          make_float4(s * u[0], s * u[kPad], s * u[2 * kPad], s * u[3 * kPad]));
    }
  }
  __syncthreads();
}

// dst[r][c] = s * src[r][c] for a 128 x 128 tile (row strides ls, ld), or
// with `mirror` s * src[min(r, c)][max(r, c)], the upper triangle mirrored
// through the stage T.
__device__ __forceinline__ void tile_copy(const float* src, size_t ls,
                                          float* dst, size_t ld, float s,
                                          bool mirror, float* T) {
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    float4 v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + (half * kPer + i) * kThreads;
      v[i] = ld4(src + (size_t)(e / 32) * ls + (e % 32) * 4);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + (half * kPer + i) * kThreads;
      const int r = e / 32, c = (e % 32) * 4;
      if (mirror) {                           // kPad rows: not float4-aligned
        float* t = T + r * kPad + c;
        t[0] = v[i].x;
        t[1] = v[i].y;
        t[2] = v[i].z;
        t[3] = v[i].w;
      } else {
        st4(dst + (size_t)r * ld + c,
            make_float4(s * v[i].x, s * v[i].y, s * v[i].z, s * v[i].w));
      }
    }
  }
  if (!mirror) return;
  __syncthreads();
#pragma unroll 2
  for (int i = 0; i < 2 * kPer; ++i) {
    const int e = threadIdx.x + i * kThreads, r = e / 32, c = (e % 32) * 4;
    float x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[q] = s * (r <= c + q ? T[r * kPad + c + q] : T[(c + q) * kPad + r]);
    st4(dst + (size_t)r * ld + c, make_float4(x[0], x[1], x[2], x[3]));
  }
  __syncthreads();
}

// Step 3's epilogue: W[i][c] = acc(c, i) for the 64 C rows i of tile q,
// through the output tile in shared memory (four 64 x 32 boxes along c,
// swizzled as the tensor map writes them) and four TMA stores.
struct PanelEpi {
  const Smem& sm;
  const CUtensorMap* map_w;
  int kb;
  __device__ __forceinline__ void pre(int) {}
  __device__ __forceinline__ void post(int q, const float (&acc)[32]) {
    if (threadIdx.x == 0) bulk_wait_read();    // the last tile is out
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = acc_col(c) + e, k = acc_row(h);
          sm.out[(k / kBoxCols) * kBoxRows * kBoxCols + swz(i, k % kBoxCols)] =
              acc[4 * c + 2 * h + e];
        }
    fence_proxy_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int idx = q / 2, I = idx + (idx >= kb);
      for (int b = 0; b < 4; ++b)
        tma_store_3d(map_w, b * kBoxCols, I * kB + (q % 2) * kBoxRows,
                     blockIdx.x, sm.out + b * kBoxRows * kBoxCols);
      bulk_commit();
    }
  }
};

// Step 4's epilogue: M[I rows][J cols, half q % 2] += acc.  The 128 x 64
// M tile is loaded by TMA into the output tile (boxes [col half][row
// half]) while the products run, updated there and stored by TMA.
struct UpdateEpi {
  const Smem& sm;
  const CUtensorMap* map_m;
  int I, kb;
  uint32_t& loads;
  __device__ __forceinline__ int col(int q) const {
    const int idx = q / 2;
    const int J = I + idx + (I < kb && I + idx >= kb);
    return J * kB + (q % 2) * kBoxRows;
  }
  __device__ __forceinline__ void pre(int q) {
    if (threadIdx.x != 0) return;
    bulk_wait_read();                           // the last tile is out
    mbar_expect_tx(sm.obar, 4 * kBoxBytes);
    for (int b = 0; b < 4; ++b)
      tma_load_3d(sm.out + b * kBoxRows * kBoxCols, map_m,
                  col(q) + (b / 2) * kBoxCols, I * kB + (b % 2) * kBoxRows,
                  blockIdx.x, sm.obar);
  }
  __device__ __forceinline__ void post(int q, const float (&acc)[32]) {
    mbar_wait(sm.obar, loads & 1);
    ++loads;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = acc_row(h), j = acc_col(c);
        float2* p = reinterpret_cast<float2*>(
            sm.out + ((j / kBoxCols) * 2 + i / kBoxRows) * kBoxRows * kBoxCols +
            swz(i % kBoxRows, j % kBoxCols));
        const float2 v = *p;
        *p = make_float2(v.x + acc[4 * c + 2 * h],
                         v.y + acc[4 * c + 2 * h + 1]);
      }
    fence_proxy_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int b = 0; b < 4; ++b)
        tma_store_3d(map_m, col(q) + (b / 2) * kBoxCols,
                     I * kB + (b % 2) * kBoxRows, blockIdx.x,
                     sm.out + b * kBoxRows * kBoxCols);
      bulk_commit();
    }
  }
};

// Thread 0's bulk stores completed and ordered before what every thread
// reads next, through either proxy.
__device__ __forceinline__ void drain_stores() {
  if (threadIdx.x == 0) bulk_wait();
  fence_proxy_async();
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
block_sweep_kernel(const float* __restrict__ H, float* __restrict__ out,
                   float* __restrict__ ct_all, float* __restrict__ w_all,
                   const __grid_constant__ CUtensorMap map_m,
                   const __grid_constant__ CUtensorMap map_ct,
                   const __grid_constant__ CUtensorMap map_w, int n) {
  extern __shared__ __align__(16) char smem_raw[];
  char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t bars[kStages + 2];
  Smem sm{reinterpret_cast<float*>(base + kAHiOff),
          reinterpret_cast<float*>(base + kALoOff), base + kRingOff,
          reinterpret_cast<float*>(base + kLoOff),
          reinterpret_cast<float*>(base + kOutOff),
          reinterpret_cast<float*>(base + kPivOff), bars, bars + kStages,
          bars + kStages + 1};
  float* T = reinterpret_cast<float*>(sm.ring);   // transpose stage

  const int tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const float* src = H + blockIdx.x * nn;
  float* M = out + blockIdx.x * nn;
  float* ct = ct_all + (size_t)blockIdx.x * n * kB;
  float* w = w_all + (size_t)blockIdx.x * n * kB;
  const int nb = n / kB;
  uint32_t tg = 0, a_loads = 0, m_loads = 0;

  if (tid == 0) {
    for (int s = 0; s < kStages + 2; ++s) mbar_init(&bars[s], 1);
    fence_mbarrier_init();
  }
  // The upper block triangle of H into M.
  for (int I = 0; I < nb; ++I)
    for (int J = I; J < nb; ++J) {
      const size_t o = (size_t)I * kB * n + J * kB;
      tile_copy(src + o, n, M + o, n, 1.0f, false, T);
    }
  __syncthreads();

  for (int kb = 0; kb < nb; ++kb) {
    const int off = kb * kB;
    float* Mk = M + (size_t)off * n;            // row block K

    // 1. -D^-1 in registers; into M[K,K] and the held operand (hi, lo).
    {
      Tile d;
      d.load([&](int i, int j) { return ld4(Mk + (size_t)i * n + off + j); });
      d.sweep(sm.piv);
      d.store([&](int i, int j, float4 v) {
        st4(Mk + (size_t)i * n + off + j, v);
        float4 h, l;
        split4(v, h, l);
        const int o = (j / kBoxCols) * kB * kBoxCols + swz(i, j % kBoxCols);
        st4(sm.a_hi + o, h);
        st4(sm.a_lo + o, l);
      });
    }
    __syncthreads();

    // 2. ct rows below K: the transposes of the upper tiles (K, I).
    for (int I = kb + 1; I < nb; ++I)
      tile_transpose(Mk + I * kB, n, ct + (size_t)I * kB * kB, kB, 1.0f, T);
    fence_proxy_async();
    __syncthreads();

    // Box kc of the 64 C rows at half q % 2 of row block J.
    auto c_box = [&](int J, int q, int kc, const void** map, int* x,
                     int* y) {
      *y = J * kB + (q % 2) * kBoxRows;
      if (J < kb) {
        *map = &map_m;
        *x = off + kc * kBoxCols;
      } else {
        *map = &map_ct;
        *x = kc * kBoxCols;
      }
    };

    // 3. W = C (-D^-1), every row block but K.
    {
      PanelEpi epi{sm, &map_w, kb};
      run_stream(sm, 2 * (nb - 1), [&](int q, int kc, const void** map,
                                       int* x, int* y) {
        const int idx = q / 2;
        c_box(idx + (idx >= kb), q, kc, map, x, y);
      }, epi, tg);
    }
    drain_stores();

    // 4. M[I,J] += W[I] C[J]^T over the upper tiles outside row/column K.
    for (int I = 0; I < nb; ++I) {
      if (I == kb) continue;
      if (tid == 0) {
        mbar_expect_tx(sm.abar, kB * kB * 4);
        for (int kc = 0; kc < kKChunks; ++kc)
          for (int h = 0; h < 2; ++h)
            tma_load_3d(sm.a_hi + kc * kB * kBoxCols + h * kBoxRows * kBoxCols,
                        &map_w, kc * kBoxCols, I * kB + h * kBoxRows,
                        blockIdx.x, sm.abar);
      }
      mbar_wait(sm.abar, a_loads & 1);
      ++a_loads;
      split_region(sm.a_hi, sm.a_lo, kB * kB);
      fence_proxy_async_smem();
      __syncthreads();
      const int nJ = nb - I - (I < kb ? 1 : 0);
      UpdateEpi epi{sm, &map_m, I, kb, m_loads};
      run_stream(sm, 2 * nJ, [&](int q, int kc, const void** map, int* x,
                                 int* y) {
        const int idx = q / 2;
        c_box(I + idx + (I < kb && I + idx >= kb), q, kc, map, x, y);
      }, epi, tg);
    }
    drain_stores();

    // 5. Write-back: (I, K) <- V = -W for I < K; (K, J) <- V^T for J > K.
    for (int I = 0; I < kb; ++I)
      tile_copy(w + (size_t)I * kB * kB, kB, M + (size_t)I * kB * n + off, n,
                -1.0f, false, T);
    for (int J = kb + 1; J < nb; ++J)
      tile_transpose(w + (size_t)J * kB * kB, kB, Mk + J * kB, n, -1.0f, T);
    fence_proxy_async();
    __syncthreads();
  }

  // M = -H^-1 on the upper tiles: mirror into the lower ones and negate.
  for (int I = 0; I < nb; ++I) {
    float* d = M + (size_t)I * kB * n + I * kB;
    tile_copy(d, n, d, n, -1.0f, true, T);
    for (int J = I + 1; J < nb; ++J)
      tile_transpose(M + (size_t)I * kB * n + J * kB, n,
                     M + (size_t)J * kB * n + I * kB, n, -1.0f, T, true);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                       cudaEnableDefault, &q) != cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                              &q) != cudaSuccess)
    return nullptr;
#endif
  if (q != cudaDriverEntryPointSuccess) return nullptr;
  fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// A 3-D map over B stacked (rows, cols) f32 matrices with 64 x 32 boxes and
// the 128-byte swizzle.
bool make_map(EncodeTiled enc, CUtensorMap* map, const float* p, int B,
              int rows, int cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4,
                                 (cuuint64_t)cols * rows * 4};
  const cuuint32_t box[3] = {kBoxCols, kBoxRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// H, out: B contiguous n x n f32 matrices on the current device, n a
// multiple of 128; ct, w: B x n x 128 f32 scratch.  Launches on stream s
// and returns cudaGetLastError(); it does not synchronise.
extern "C" int block_spd_inverse_f32(const float* H, float* out, float* ct,
                                     float* w, int B, int n,
                                     cudaStream_t s) {
  if (B < 0 || n <= 0 || n % kB) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap map_m, map_ct, map_w;
  if (!make_map(enc, &map_m, out, B, n, n) ||
      !make_map(enc, &map_ct, ct, B, n, kB) ||
      !make_map(enc, &map_w, w, B, n, kB))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemAlloc);
  if (err != cudaSuccess) return (int)err;
  block_sweep_kernel<<<B, kThreads, kSmemAlloc, s>>>(H, out, ct, w, map_m,
                                                      map_ct, map_w, n);
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
