// Batched scaled-inverse solve with monotone refinement (Hopper, sm_90a).
//
// Replaces the TPU kernel minotaur_tpu/ops/pallas_kernels.py:_build_kernel
// (reached through refined_spd_solve_f32), which the JAX IPM runs as the
// XLA ops of engines/ipm.py::_make_spd_solver.solve_xla.  For every lane b
// and all R right-hand sides of that lane at once:
//   x   = dinv * (Minv_s @ (dinv * r))              (Minv_s in factor type TF)
//   repeat refine_steps times, keeping a round only if ||res||^2 drops:
//     res = r - (M @ x + shift * x)                  (operator type TM)
//     x'  = x + dinv * (Minv_s @ (dinv * res))
// The norm is ONE scalar per lane over all R columns, as in the JAX code's
// matrix right-hand sides.  Casts sit exactly where base_solve puts them:
// r (type TR) is taken to TM before the first scaling, the scaled
// right-hand side is rounded to TF before the product, the product is
// rounded to TF and taken to TM before the second scaling, and x is rounded
// to the output type TO at the store.  So a caller with f64 vectors and an
// f32 operator needs no cast kernels around the call.
//
// Each row of a product with Minv_s is summed in f64 and rounded to TF once
// (the Pallas kernel sums in TF).  Under f32 factors the IPM's lane
// statuses depend on the rounding of these sums: summed in f32 in this
// kernel's order, two of 64 intquad(300) lanes of chip_smoke's phase 5 ended
// at the iteration limit where the plain version converged; summed in f64,
// all 64 agree.  The products with M (residuals) are summed in TM.
//
// What bounds it on the card: a product is 2 flops per 4 or 8 bytes of a
// k x k matrix, so the kernel is bound by bytes.  At refine 0 that is one
// pass over Minv_s (23 MB in f32 at B=64, k=300; it stays in the 50 MB L2
// between the calls of one IPM iteration, which all use the same
// factorization).  With refinement it is one pass over Minv_s and one over
// M per round, and the rounds of a lane depend on each other through the
// monotone test: at (64, 1378) f32 refine 2 that is 6 passes of 486 MB,
// 0.87 ms at 3.35 TB/s.  The main path's right-hand sides are vectors
// (R = 1); a wider R takes one pass per column, from L2.
//
// One row engine, three designs.  The engine: a warp owns kRowsPerWarp
// rows at once with an independent accumulator per row, and streams them
// with 16-byte loads (float4 / double2; the vector path, taken when every
// row starts 16-byte aligned: k % 4 == 0 in f32, k % 2 == 0 in f64, and
// aligned base pointers), or one element a load on the scalar path (other
// k, e.g. 1378 or 1339 in f32), each lane summing its elements in the same
// order on both.  Rows are reduced with warp shuffles.  The cluster design
// takes several steps of a lane at once (warp_rows_batched), and on the
// scalar path loads f32 rows as 8-byte pairs, handing each element to the
// lane that sums it with shuffles: from element 0 where every row starts
// 8-byte aligned (even k, warp_rows_pairs), else from each row's first
// 8-byte boundary (odd k, where every other row starts 4 bytes off, or a
// base 4 bytes off: warp_rows_odd); none changes a sum.
//  - refine 0: a grid of (ceil(k / kRowsPerCta), B) CTAs of 8 warps (640
//    CTAs at (64, 300), four resident per SM).  Each CTA scales the lane's
//    right-hand sides into shared memory (in chunks of columns that fit
//    48 KB, for wide R) and computes its 32 rows; no CTA needs another's
//    result.  Every main-path call: 0.0086 ms at (64, 300).
//  - refine > 0, one CTA of 16 warps a lane: the monotone test needs
//    the whole lane between rounds.  u, x, res, x2 and res2 live in shared
//    memory when they fit (in a global scratch buffer beyond that); a kept
//    round swaps pointers instead of copying.  B SMs pull from HBM.
//  - refine > 0, a cluster of C CTAs of 16 warps a lane, one CTA a SM (see
//    spd_solve_cluster_kernel): each CTA streams its block of rows, and the
//    slices of each new vector are copied between the CTAs through DSMEM;
//    the norm is summed in the one-CTA order, so x has the same bits.
//    B * C SMs pull from HBM.
// The launcher picks the refining design from (B, k) (refine_design, the
// one place of the threshold): the cluster from k >= kClusterMinKS = 256,
// at even and odd k and in both types, with the largest C <= kMaxClusterS
// = 4 that keeps B * C within the SMs (C = 2 at B = 64, 4 at B = 16), else
// one CTA.  Device ms, f32 refine 2 unless stated (NVIDIA H100 80GB HBM3,
// 700 W, tools/kernel_designs.py), one CTA against the cluster the
// launcher picks at and above the threshold, or C = 2 and 4 below it:
//   below:  (64, 128) 0.0152 / 0.0215, 0.0669; (16, 128) 0.0149 / 0.0212,
//           0.0241; (64, 192) 0.0306 / 0.0309, 0.0741; (16, 192) 0.0309
//           / 0.0297, 0.0263;
//   at:     (64, 256) 0.0354 / 0.0351 (C = 2), f64 refine 3 0.1392 /
//           0.1094; (16, 256) 0.0321 / 0.0283 (C = 4);
//   above:  (64, 300) 0.0733 / 0.0620, f64 refine 3 0.2050 / 0.1609;
//           (16, 300) 0.0489 / 0.0372; (64, 512) 0.1574 / 0.1471;
//           (16, 512) 0.1010 / 0.0476; (64, 1024) 0.5702 / 0.5215 (3.1
//           TB/s; plain 0.6049), f64 refine 3 1.9308 / 1.3630; (16, 1024)
//           0.4306 / 0.1597; (64, 1378) 2.6745 / 1.0613 (2.7 TB/s; plain
//           1.0817).
// At odd k (f32 refine 2 with f64 r and x, as the glob IPM calls it):
//   below:  (64, 193) 0.0446 / 0.0566, 0.1161; (16, 193) 0.0435 / 0.0556,
//           0.0398;
//   at:     (64, 257) 0.0683 / 0.0815 (C = 2); (16, 257) 0.0667 / 0.0598
//           (C = 4);
//   above:  (64, 301) 0.1620 / 0.1083; (64, 1339) 2.5601 / 1.0978 (2.5
//           TB/s over six passes; plain 1.0257); (16, 1339) 2.3694 /
//           0.4949; (64, 1377) 2.6702 / 1.1536.
// So the crossover lies between 192-193, where one CTA ties or wins at
// B = 64, and 256-273, where the designs tie within the runs' spread (at
// (64, 257) one CTA read 0.0683-0.0956 and the cluster 0.0796-0.0825 over
// three runs; at (64, 273) 0.0935-0.1054 against 0.0850), the cluster
// winning above at every measured B, type and parity: one threshold
// serves both parities.  Earlier runs of the same tool: at (16, 1024)
// C = 8 took 0.2095 (more barrier and copy than stream a CTA), so C stops
// at 4; with 4-byte loads on its odd rows the cluster took (64, 1339)
// 2.1461-2.1723 and (16, 1339) 0.8124, which is why odd k stayed on one
// CTA before warp_rows_odd; warp_rows_odd with four shuffles a pair of
// elements, as warp_rows_pairs has, took (64, 1339) 1.2250-1.2303, and
// with the halves first swapped between lanes j and j + 16 (three
// shuffles) and no work on blocks past k, 1.0725-1.0743 in kernels of its
// own.  Both f32 engines now share one kernel, where warp_rows_pairs
// shared it with a 4-byte loop before (128 registers either way; 268
// bytes of spill stores, 1044 with the loop): (64, 1378) reads 1.0613
// against 1.0166 beside the loop, and (64, 1339) 1.0978 against 1.0743.
// A cluster that cannot be placed or a failed cudaLaunchKernelEx is
// returned as an error; nothing falls back.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_launch.cuh"

namespace {

constexpr int kRowsPerWarp = 4;                   // rows in flight per warp
constexpr int kThreadsGrid = 256;                 // refine 0: 8 warps
constexpr int kRowsPerCta = kThreadsGrid / 32 * kRowsPerWarp;
constexpr int kThreadsLane = 512;                 // refine > 0: 16 warps
constexpr int kWarpsLane = kThreadsLane / 32;
// the design threshold (see the header note): a refining call takes the
// cluster design from this order on, with the largest power-of-two cluster
// size up to kMaxClusterS that keeps B * C within the SMs (one CTA a SM)
constexpr int kClusterMinKS = 256;
constexpr int kMaxClusterS = 4;
constexpr size_t kSmemDefault = 48 * 1024;        // without the opt-in

// Column stride of the vectors in shared memory (and scratch): a multiple
// of 4 elements, so every column starts 16-byte aligned.
__host__ __device__ __forceinline__ int col_stride(int k) {
  return (k + 3) & ~3;
}

// W elements of T per load: one 16-byte load on the vector path.
template <typename T, bool kVec>
struct Pack {
  static constexpr int W = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  struct alignas(sizeof(T) * W) Type {
    T v[W];
  };
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[r] = sum_j A[row0 + r, j] * v[j] for the kRowsPerWarp rows of the
// row-major (k, k) matrix A and one column v (16-byte aligned), summed in
// TA by one warp and returned to all its threads.  Rows past k repeat the
// last one; the caller stores only rows below k.
template <typename T, typename TA, bool kVec>
__device__ __forceinline__ void warp_rows(const T* __restrict__ A, int k,
                                          int row0, const T* v,
                                          TA (&acc)[kRowsPerWarp]) {
  using P = typename Pack<T, kVec>::Type;
  constexpr int W = Pack<T, kVec>::W;
  const P* rows[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    rows[r] = reinterpret_cast<const P*>(
        A + static_cast<long long>(min(row0 + r, k - 1)) * k);
    acc[r] = TA(0);
  }
  const P* col = reinterpret_cast<const P*>(v);
  const int np = k / W;                 // the vector path has k % W == 0
#pragma unroll 2
  for (int p = threadIdx.x & 31; p < np; p += 32) {
    P a[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) a[r] = rows[r][p];
    const P u = col[p];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int w = 0; w < W; ++w)
        acc[r] += static_cast<TA>(a[r].v[w]) * static_cast<TA>(u.v[w]);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = warp_sum(acc[r]);
}

// The scalar path of warp_rows_batched for f32 rows of even k: a lane
// loads the pairs (2 l, 2 l + 1) of each 64-element block, and shuffles
// give lane l the elements l and l + 32 of the block, the ones it sums on
// the scalar path, in that order.  kB blocks a lane at once.
template <typename T, typename TA, int kB>
__device__ __forceinline__ void warp_rows_pairs(const T* __restrict__ A,
                                                int k, int row0, const T* v,
                                                TA (&acc)[kRowsPerWarp]) {
  const float2* rows[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    rows[r] = reinterpret_cast<const float2*>(
        A + static_cast<long long>(min(row0 + r, k - 1)) * k);
  const int ln = threadIdx.x & 31, np2 = k / 2;
  const int src0 = ln >> 1, src1 = 16 + (ln >> 1);
  const bool odd = ln & 1;
  for (int m0 = 0; m0 * 64 < k; m0 += kB) {
    float2 a[kB][kRowsPerWarp];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int pi = (m0 + b) * 32 + ln;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        a[b][r] = pi < np2 ? rows[r][pi] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int e0 = (m0 + b) * 64 + ln, e1 = e0 + 32;
      float v0[kRowsPerWarp], v1[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float x0 = __shfl_sync(0xffffffffu, a[b][r].x, src0);
        const float y0 = __shfl_sync(0xffffffffu, a[b][r].y, src0);
        const float x1 = __shfl_sync(0xffffffffu, a[b][r].x, src1);
        const float y1 = __shfl_sync(0xffffffffu, a[b][r].y, src1);
        v0[r] = odd ? y0 : x0;
        v1[r] = odd ? y1 : x1;
      }
      if (e0 < k) {
        const T u0 = v[e0];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r] += static_cast<TA>(v0[r]) * static_cast<TA>(u0);
      }
      if (e1 < k) {
        const T u1 = v[e1];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r] += static_cast<TA>(v1[r]) * static_cast<TA>(u1);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = warp_sum(acc[r]);
}

// The scalar path of warp_rows_batched for the f32 rows that
// warp_rows_pairs does not take (odd k, or a base 4 bytes off): each row
// loads pairs from its first 8-byte boundary, decided from its own
// address.  A row that starts aligned (s = 0) pairs the elements (2 j,
// 2 j + 1), with a last element left over (k - s odd) loaded alone as the
// x of pair (k - 1 - s) / 2; one that starts 4 bytes off (s = 1) loads
// element 0 alone and pairs (2 j + 1, 2 j + 2).  Lane l loads pair 32 m + l
// of block m, so with s = 1 block m's pairs hold its elements 64 m + 1 ..
// 64 m + 64, and element 64 m is lane 31's last y of block m - 1 (`carry`;
// for m = 0 the lone element 0).  Shuffles give lane l the elements l and
// l + 32 of each block, the ones it sums on the scalar path, in that order.
template <typename T, typename TA, int kB>
__device__ __forceinline__ void warp_rows_odd(const T* __restrict__ A, int k,
                                              int row0, const T* v,
                                              TA (&acc)[kRowsPerWarp]) {
  const float2* rows[kRowsPerWarp];
  int s[kRowsPerWarp];
  float carry[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const T* p = A + static_cast<long long>(min(row0 + r, k - 1)) * k;
    s[r] = static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 1u);
    rows[r] = reinterpret_cast<const float2*>(p + s[r]);
    carry[r] = s[r] ? p[0] : 0.f;
  }
  const int ln = threadIdx.x & 31;
  for (int m0 = 0; m0 * 64 < k; m0 += kB) {
    float2 a[kB][kRowsPerWarp];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int pi = (m0 + b) * 32 + ln;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int np2 = (k - s[r]) >> 1;        // whole pairs of the row
        a[b][r] = pi < np2 ? rows[r][pi]
                  : pi == np2 && 2 * pi + s[r] < k
                      ? make_float2(reinterpret_cast<const T*>(rows[r])[2 * pi],
                                    0.f)
                      : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      if ((m0 + b) * 64 >= k) break;           // warp-uniform
      const int e0 = (m0 + b) * 64 + ln, e1 = e0 + 32;
      float v0[kRowsPerWarp], v1[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        // lanes j and j + 16 swap halves, so lane j holds places 2 j and
        // 2 j + 32 of the block's stream of pairs (w1, w2) and lane j + 16
        // places 2 j + 1 and 2 j + 33; i: the place of element e0 (-1: the
        // carry, and e1 is lane 31's w1)
        const float2 p = a[b][r];
        const bool lo = ln < 16;
        const float t = __shfl_xor_sync(0xffffffffu, lo ? p.y : p.x, 16);
        const float w1 = lo ? p.x : t, w2 = lo ? t : p.y;
        const int i = ln - s[r];
        const int src = i < 0 ? 31 : (i >> 1) + ((i & 1) << 4);
        const float q1 = __shfl_sync(0xffffffffu, w1, src);
        const float q2 = __shfl_sync(0xffffffffu, w2, src);
        v0[r] = i < 0 ? carry[r] : q1;
        v1[r] = i < 0 ? q1 : q2;
        if (s[r]) carry[r] = __shfl_sync(0xffffffffu, w2, 31);
      }
      if (e0 < k) {
        const T u0 = v[e0];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r] += static_cast<TA>(v0[r]) * static_cast<TA>(u0);
      }
      if (e1 < k) {
        const T u1 = v[e1];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r] += static_cast<TA>(v1[r]) * static_cast<TA>(u1);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = warp_sum(acc[r]);
}

// warp_rows for the cluster design, the same sums in the same order: a
// lane takes kU of its steps at once, all loads first (the last group
// masked), so a row costs ceil(k / (32 W kU)) load latencies instead of
// one every two steps.  The refine-0 grid and the one-CTA design keep
// warp_rows (64 registers a thread: four CTAs a SM on the grid, two at
// small k one CTA a lane; the batched loop took the main-path call from
// 0.0085 to 0.0140 ms and the OBBT lanes' (182, 91) refine 2 from 0.026
// to 0.063).
template <typename T, typename TA, bool kVec, int kU>
__device__ __forceinline__ void warp_rows_batched(const T* __restrict__ A,
                                                  int k, int row0,
                                                  const T* v, bool pairs,
                                                  TA (&acc)[kRowsPerWarp]) {
  using P = typename Pack<T, kVec>::Type;
  constexpr int W = Pack<T, kVec>::W;
  const P* rows[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    rows[r] = reinterpret_cast<const P*>(
        A + static_cast<long long>(min(row0 + r, k - 1)) * k);
    acc[r] = TA(0);
  }
  const P* col = reinterpret_cast<const P*>(v);
  const int np = k / W;
  if constexpr (!kVec && sizeof(T) == 4) {
    // f32 rows load pairs, from element 0 where every row starts 8-byte
    // aligned (`pairs`: even k on an 8-byte-aligned base), else from each
    // row's first 8-byte boundary, and hand each element to the lane that
    // sums it on the scalar path (lane e % 32) with shuffles, so the sums
    // keep their order
    if (pairs)
      warp_rows_pairs<T, TA, kU / 2>(A, k, row0, v, acc);
    else
      warp_rows_odd<T, TA, kU / 2>(A, k, row0, v, acc);
    return;
  }
  for (int p = threadIdx.x & 31; p < np; p += 32 * kU) {
    P a[kU][kRowsPerWarp], u[kU];
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      if (p + 32 * q < np) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) a[q][r] = rows[r][p + 32 * q];
        u[q] = col[p + 32 * q];
      }
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      if (p + 32 * q < np) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int w = 0; w < W; ++w)
            acc[r] += static_cast<TA>(a[q][r].v[w]) *
                      static_cast<TA>(u[q].v[w]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = warp_sum(acc[r]);
}

// steps a lane takes at once in the refining kernels (up to 128 registers a
// thread): 16-byte loads x 4, or single elements x 16 (f32) or x 8 (f64)
template <typename T, bool kVec>
struct LaneUnroll {
  static constexpr int value = kVec ? 4 : (sizeof(T) == 4 ? 16 : 8);
};

// ------------------------------------------------------------- refine 0
// One CTA per (row block, lane); blockIdx.x = lane * nrb + row block.
template <typename TF, typename TM, typename TR, typename TO, bool kVec>
__global__ void __launch_bounds__(kThreadsGrid, 4)
spd_solve_rows_kernel(const TF* __restrict__ minv,
                      const TM* __restrict__ dinv, const TR* __restrict__ r,
                      TO* __restrict__ x, int k, int R, int rc, int nrb) {
  extern __shared__ __align__(16) unsigned char smem[];
  TF* su = reinterpret_cast<TF*>(smem);            // (rc, kp) chunk of u
  const int kp = col_stride(k);
  const long long b = blockIdx.x / nrb;
  const int rb = blockIdx.x - static_cast<int>(b) * nrb;
  const TF* A = minv + b * k * k;
  const TM* dv = dinv + b * k;
  const TR* rl = r + b * k * R;
  TO* xl = x + b * k * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = rb * kRowsPerCta + warp * kRowsPerWarp;

  for (int c0 = 0; c0 < R; c0 += rc) {
    const int nc = min(rc, R - c0);
    if (c0) __syncthreads();                   // the last chunk is read
    for (int p = threadIdx.x; p < nc * k; p += kThreadsGrid) {
      const int j = p / nc, c = p - j * nc;
      su[c * kp + j] = static_cast<TF>(
          static_cast<TM>(rl[static_cast<long long>(j) * R + c0 + c]) * dv[j]);
    }
    __syncthreads();
    if (row0 >= k) continue;                   // warp-uniform
    for (int c = 0; c < nc; ++c) {
      double acc[kRowsPerWarp];
      warp_rows<TF, double, kVec>(A, k, row0, su + c * kp, acc);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int row = row0 + i;
        if (lane == i && row < k)
          xl[static_cast<long long>(row) * R + c0 + c] = static_cast<TO>(
              static_cast<TM>(static_cast<TF>(acc[i])) * dv[row]);
      }
    }
  }
}

// ------------------------------------------------------------ refine > 0
template <typename TF, typename TM>
struct LaneCtx {
  const TF* minv;   // (k, k)
  const TM* mop;    // (k, k)
  const TM* dv;     // (k,)
  const TM* sh;     // (k,)
  int k, R, kp;
  bool pair_f, pair_m;  // the scalar path loads pairs of Minv_s / M rows
};

// dst = (add +) dinv * TM(Minv_s @ U) for the rows [lo, hi) of the lane, all
// (R, kp) column-major vectors, by kWarps warps; kBatch: warp_rows_batched
// (the cluster design), else warp_rows (the one-CTA design, whose 64
// registers a thread keep two CTAs on an SM at small k)
template <int kWarps, bool kVec, bool kBatch, typename TF, typename TM>
__device__ void lane_product(const LaneCtx<TF, TM>& L, const TF* U,
                             const TM* add, TM* dst, int lo, int hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row0 = lo + warp * kRowsPerWarp; row0 < hi;
       row0 += kWarps * kRowsPerWarp) {
    for (int c = 0; c < L.R; ++c) {
      double acc[kRowsPerWarp];
      if constexpr (kBatch)
        warp_rows_batched<TF, double, kVec, LaneUnroll<TF, kVec>::value>(
            L.minv, L.k, row0, U + c * L.kp, L.pair_f, acc);
      else
        warp_rows<TF, double, kVec>(L.minv, L.k, row0, U + c * L.kp, acc);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int row = row0 + i;
        if (lane == i && row < hi) {
          const int p = c * L.kp + row;
          const TM v = static_cast<TM>(static_cast<TF>(acc[i])) * L.dv[row];
          dst[p] = add ? add[p] + v : v;
        }
      }
    }
  }
  __syncthreads();
}

// res = r - (M @ xv + shift * xv) for the rows [lo, hi), by kWarps warps;
// returns this thread's part of sum(res^2) (lane i of warp w: rows
// lo + 4 w + i + 4 kWarps j in order, columns inner)
template <int kWarps, bool kVec, bool kBatch, typename TF, typename TM,
          typename TR>
__device__ TM lane_residual(const LaneCtx<TF, TM>& L,
                            const TR* __restrict__ rl, const TM* xv, TM* res,
                            int lo, int hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  TM part = TM(0);
  for (int row0 = lo + warp * kRowsPerWarp; row0 < hi;
       row0 += kWarps * kRowsPerWarp) {
    for (int c = 0; c < L.R; ++c) {
      TM acc[kRowsPerWarp];
      if constexpr (kBatch)
        warp_rows_batched<TM, TM, kVec, LaneUnroll<TM, kVec>::value>(
            L.mop, L.k, row0, xv + c * L.kp, L.pair_m, acc);
      else
        warp_rows<TM, TM, kVec>(L.mop, L.k, row0, xv + c * L.kp, acc);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int row = row0 + i;
        if (lane == i && row < hi) {
          const int p = c * L.kp + row;
          const TM rv =
              static_cast<TM>(rl[static_cast<long long>(row) * L.R + c]) -
              (acc[i] + L.sh[row] * xv[p]);
          res[p] = rv;
          part += rv * rv;
        }
      }
    }
  }
  return part;
}

// the one-CTA design's sum of the threads' parts: each warp's shuffle
// tree, then the warps in order; returned to every thread (uniform, so the
// monotone decision is too).  s_red is rewritten only after the next
// barrier.
template <typename TM>
__device__ TM lane_total(TM part, TM* s_red) {
  part = warp_sum(part);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = part;
  __syncthreads();
  TM total = TM(0);
#pragma unroll
  for (int w = 0; w < kWarpsLane; ++w) total += s_red[w];
  return total;
}

// Bytes of the five lane vectors: x, res, x2, res2 (TM), then u (TF).
__host__ __device__ __forceinline__ size_t lane_bytes(int k, int R,
                                                       size_t sf, size_t sm) {
  const size_t n = static_cast<size_t>(R) * col_stride(k);
  return n * (4 * sm + sf);
}

// One CTA per lane.  scratch: null when the vectors sit in shared memory,
// else B * lane_bytes(...) bytes.
template <typename TF, typename TM, typename TR, typename TO, bool kVec>
__global__ void __launch_bounds__(kThreadsLane)
spd_solve_refine_kernel(const TF* __restrict__ minv,
                        const TM* __restrict__ mop,
                        const TM* __restrict__ dinv,
                        const TM* __restrict__ shift,
                        const TR* __restrict__ r, TO* __restrict__ x,
                        unsigned char* scratch, int k, int R, int steps,
                        int pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ TM s_red[kWarpsLane];
  const long long b = blockIdx.x;
  const int kp = col_stride(k);
  const long long n = static_cast<long long>(R) * kp;
  unsigned char* base =
      scratch ? scratch + b * lane_bytes(k, R, sizeof(TF), sizeof(TM)) : smem;
  TM* X = reinterpret_cast<TM*>(base);
  TM* RES = X + n;
  TM* X2 = RES + n;
  TM* RES2 = X2 + n;
  TF* U = reinterpret_cast<TF*>(RES2 + n);
  const LaneCtx<TF, TM> L{minv + b * k * k, mop + b * k * k, dinv + b * k,
                          shift + b * k, k, R, kp, (pairs & 1) != 0,
                          (pairs & 2) != 0};
  const TR* rl = r + b * k * R;
  TO* xl = x + b * k * R;

  for (int p = threadIdx.x; p < k * R; p += kThreadsLane) {
    const int j = p / R, c = p - j * R;
    U[c * kp + j] = static_cast<TF>(static_cast<TM>(rl[p]) * L.dv[j]);
  }
  __syncthreads();
  lane_product<kWarpsLane, kVec, false>(L, U, static_cast<const TM*>(nullptr),
                                        X, 0, k);
  TM nrm = lane_total(
      lane_residual<kWarpsLane, kVec, false>(L, rl, X, RES, 0, k), s_red);
  for (int s = 0; s < steps; ++s) {
    for (int p = threadIdx.x; p < n; p += kThreadsLane) {
      const int j = p % kp;
      if (j < k) U[p] = static_cast<TF>(RES[p] * L.dv[j]);
    }
    __syncthreads();
    lane_product<kWarpsLane, kVec, false>(L, U, X, X2, 0, k);
    const TM nrm2 = lane_total(
        lane_residual<kWarpsLane, kVec, false>(L, rl, X2, RES2, 0, k), s_red);
    if (nrm2 < nrm) {                          // uniform across the block
      TM* t = X; X = X2; X2 = t;
      t = RES; RES = RES2; RES2 = t;
      nrm = nrm2;
    }
  }
  for (int p = threadIdx.x; p < k * R; p += kThreadsLane) {
    const int j = p / R, c = p - j * R;
    xl[p] = static_cast<TO>(X[c * kp + j]);
  }
}

// ------------------------------------------------ refine > 0, cluster
// One cluster of C CTAs (16 warps each, one a SM) per lane, blockIdx.x = lane * C +
// rank; CTA r owns rows [r per, (r + 1) per) of Minv_s and M (per a multiple
// of kRowsPerWarp).  Each CTA keeps the whole of every vector in its shared
// memory: after each product it has its rows of the result, and the other
// rows are copied from the other CTAs through DSMEM (`share`) behind a
// cluster barrier.  Every row is summed as in the one-CTA kernel, and the
// monotone test's norm is summed from the whole residual in the one-CTA
// kernel's order (lane_norm), so x has the one-CTA kernel's bits.

// rows a CTA owns in a cluster of C: a multiple of kRowsPerWarp
__host__ __device__ __forceinline__ int cluster_rows(int k, int C) {
  const int per = (k + C - 1) / C;
  return (per + kRowsPerWarp - 1) / kRowsPerWarp * kRowsPerWarp;
}

// sum(res^2) over the whole lane in the order of the one-CTA kernel:
// slot (w, i) of its kWarpsLane warps sums rows 4 w + i + 4 kWarpsLane j
// (columns inner), warp w's shuffle tree adds its four slots as
// (s0 + s2) + (s1 + s3), then the warps add in order.  Returned to every
// thread.
template <int kThreads, typename TM>
__device__ TM lane_norm(const TM* res, int k, int R, int kp, TM* s_slot) {
  constexpr int kSlots = kWarpsLane * kRowsPerWarp;
  for (int t = threadIdx.x; t < kSlots; t += kThreads) {
    TM part = TM(0);
    for (int row = t; row < k; row += kSlots)
      for (int c = 0; c < R; ++c) {
        const TM v = res[c * kp + row];
        part += v * v;
      }
    s_slot[t] = part;
  }
  __syncthreads();
  TM total = TM(0);
#pragma unroll
  for (int w = 0; w < kWarpsLane; ++w) {
    const TM* s = s_slot + w * kRowsPerWarp;
    total += (s[0] + s[2]) + (s[1] + s[3]);
  }
  return total;
}

template <typename TF, typename TM, typename TR, typename TO, bool kVec>
__global__ void __launch_bounds__(kThreadsLane)
spd_solve_cluster_kernel(const TF* __restrict__ minv,
                         const TM* __restrict__ mop,
                         const TM* __restrict__ dinv,
                         const TM* __restrict__ shift,
                         const TR* __restrict__ r, TO* __restrict__ x, int k,
                         int R, int steps, int pairs) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ TM s_slot[kWarpsLane * kRowsPerWarp];
  const long long b = blockIdx.x / C;
  const int kp = col_stride(k);
  const long long n = static_cast<long long>(R) * kp;
  TM* X = reinterpret_cast<TM*>(smem);
  TM* RES = X + n;
  TM* X2 = RES + n;
  TM* RES2 = X2 + n;
  TF* U = reinterpret_cast<TF*>(RES2 + n);
  const LaneCtx<TF, TM> L{minv + b * k * k, mop + b * k * k, dinv + b * k,
                          shift + b * k, k, R, kp, (pairs & 1) != 0,
                          (pairs & 2) != 0};
  const TR* rl = r + b * k * R;
  TO* xl = x + b * k * R;
  const int per = cluster_rows(k, C);
  const int lo = min(k, rank * per), hi = min(k, lo + per);

  // the other CTAs' rows of v into this CTA's copy, 16 bytes a copy (row
  // blocks start 16-byte aligned; the copy may run into the column's
  // padding up to kp)
  auto share = [&](TM* v) {
    cluster.sync();
    constexpr int kPer = 16 / static_cast<int>(sizeof(TM));
    for (int d = 1; d < C; ++d) {
      const int rr = (rank + d) % C;
      const int a = min(k, rr * per), e = min(k, a + per);
      const int nv = (e - a + kPer - 1) / kPer;
      const TM* rv = cluster.map_shared_rank(v, rr);
      for (int q = threadIdx.x; q < R * nv; q += kThreadsLane) {
        const int c = q / nv;
        const long long off = c * kp + a + (q - c * nv) * kPer;
        *reinterpret_cast<uint4*>(v + off) =
            *reinterpret_cast<const uint4*>(rv + off);
      }
    }
    __syncthreads();
  };

  for (int p = threadIdx.x; p < k * R; p += kThreadsLane) {
    const int j = p / R, c = p - j * R;
    U[c * kp + j] = static_cast<TF>(static_cast<TM>(rl[p]) * L.dv[j]);
  }
  __syncthreads();
  lane_product<kWarpsLane, kVec, true>(L, U, static_cast<const TM*>(nullptr),
                                       X, lo, hi);
  share(X);
  lane_residual<kWarpsLane, kVec, true>(L, rl, X, RES, lo, hi);
  share(RES);
  TM nrm = lane_norm<kThreadsLane>(RES, k, R, kp, s_slot);
  for (int s = 0; s < steps; ++s) {
    for (int p = threadIdx.x; p < n; p += kThreadsLane) {
      const int j = p % kp;
      if (j < k) U[p] = static_cast<TF>(RES[p] * L.dv[j]);
    }
    __syncthreads();
    lane_product<kWarpsLane, kVec, true>(L, U, X, X2, lo, hi);
    share(X2);
    lane_residual<kWarpsLane, kVec, true>(L, rl, X2, RES2, lo, hi);
    share(RES2);
    const TM nrm2 = lane_norm<kThreadsLane>(RES2, k, R, kp, s_slot);
    if (nrm2 < nrm) {                          // uniform across the cluster
      TM* t = X; X = X2; X2 = t;
      t = RES; RES = RES2; RES2 = t;
      nrm = nrm2;
    }
  }
  for (int p = threadIdx.x; p < (hi - lo) * R; p += kThreadsLane) {
    const int j = lo + p / R, c = p % R;
    xl[static_cast<long long>(j) * R + c] = static_cast<TO>(X[c * kp + j]);
  }
  // no CTA may exit while another can still read its shared memory
  cluster.sync();
}

// ------------------------------------------------------------- launches
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
}

cudaError_t smem_optin(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename TF, typename TM, typename TR, typename TO, bool kVec>
cudaError_t launch_rows(const TF* minv, const TM* dinv, const TR* r, TO* x,
                        int B, int k, int R, int rc, size_t smem,
                        cudaStream_t stream) {
  auto kernel = spd_solve_rows_kernel<TF, TM, TR, TO, kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nrb = (k + kRowsPerCta - 1) / kRowsPerCta;
  const long long grid = static_cast<long long>(nrb) * B;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(grid), kThreadsGrid, smem, stream>>>(
      minv, dinv, r, x, k, R, rc, nrb);
  return cudaGetLastError();
}

template <typename TF, typename TM, typename TR, typename TO, bool kVec>
cudaError_t launch_refine(const TF* minv, const TM* mop, const TM* dinv,
                          const TM* shift, const TR* r, TO* x,
                          unsigned char* scratch, int B, int k, int R,
                          int steps, int pairs, size_t smem,
                          cudaStream_t stream) {
  auto kernel = spd_solve_refine_kernel<TF, TM, TR, TO, kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreadsLane, smem, stream>>>(minv, mop, dinv, shift, r, x,
                                            scratch, k, R, steps, pairs);
  return cudaGetLastError();
}

template <typename TF, typename TM, typename TR, typename TO, bool kVec>
cudaError_t launch_cluster(const TF* minv, const TM* mop, const TM* dinv,
                           const TM* shift, const TR* r, TO* x, int B, int k,
                           int R, int steps, int pairs, int C, size_t smem,
                           cudaStream_t stream) {
  auto kernel = spd_solve_cluster_kernel<TF, TM, TR, TO, kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreadsLane);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cluster_fits(reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, minv, mop, dinv, shift, r, x, k, R,
                           steps, pairs);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether the refinement vectors of a lane fit shared memory.
cudaError_t refine_in_smem(int k, int R, size_t sf, size_t sm, bool* fits) {
  int optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  // the static s_red or s_slot (at most 64 doubles) sits beside the
  // dynamic part
  *fits = lane_bytes(k, R, sf, sm) +
              kWarpsLane * kRowsPerWarp * sizeof(double) <=
          static_cast<size_t>(optin);
  return cudaSuccess;
}

// The design of a refining call (steps > 0) for B lanes of order k: 1 (one
// CTA a lane), else the cluster size.  The one place that sets the
// threshold, at even and at odd k (the times that set it are in the header
// note).  The cluster design needs the vectors in shared memory.
cudaError_t refine_design(int B, int k, int R, size_t sf, size_t sm,
                          int* C) {
  *C = 1;
  if (k < kClusterMinKS) return cudaSuccess;
  bool fits = false;
  cudaError_t err = refine_in_smem(k, R, sf, sm, &fits);
  if (err != cudaSuccess || !fits) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  for (int c = kMaxClusterS; c >= 2; c /= 2) {
    if (static_cast<long long>(B) * c <= sms) {
      *C = c;
      break;
    }
  }
  return cudaSuccess;
}

template <typename TF, typename TM, typename TR, typename TO>
int launch(const void* minv_, const void* mop_, const void* dinv_,
           const void* shift_, const void* r_, void* x_, void* scratch_,
           int B, int k, int R, int steps, int cluster, void* stream_,
           int* design) {
  if (design) *design = 0;
  if (B <= 0 || k <= 0 || R <= 0) return 0;
  if (steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const TF* minv = static_cast<const TF*>(minv_);
  const TM* mop = static_cast<const TM*>(mop_);
  const TM* dinv = static_cast<const TM*>(dinv_);
  const TM* shift = static_cast<const TM*>(shift_);
  const TR* r = static_cast<const TR*>(r_);
  TO* x = static_cast<TO*>(x_);
  unsigned char* scratch = static_cast<unsigned char*>(scratch_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err;

  if (steps == 0) {
    const bool vec = k % Pack<TF, true>::W == 0 && aligned16(minv);
    const size_t col = sizeof(TF) * col_stride(k);
    if (col > kSmemDefault) {        // one column, with the opt-in
      int optin = 0;
      err = smem_optin(&optin);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (col > static_cast<size_t>(optin))
        return static_cast<int>(cudaErrorInvalidValue);
    }
    // the widest chunk of right-hand sides that fits the default 48 KB
    int rc = static_cast<int>(kSmemDefault / col);
    rc = rc < 1 ? 1 : (rc > R ? R : rc);
    const size_t smem = col * rc;
    err = vec ? launch_rows<TF, TM, TR, TO, true>(minv, dinv, r, x, B, k, R,
                                                  rc, smem, stream)
              : launch_rows<TF, TM, TR, TO, false>(minv, dinv, r, x, B, k, R,
                                                   rc, smem, stream);
    return static_cast<int>(err);
  }

  const bool vec = k % Pack<TF, true>::W == 0 &&
                   k % Pack<TM, true>::W == 0 && aligned16(minv) &&
                   aligned16(mop);
  // the cluster's scalar path loads f32 rows in pairs: from element 0
  // where every row starts 8-byte aligned (`pairs`), else from each row's
  // first 8-byte boundary
  const int pairs = (k % 2 == 0 && aligned8(minv) ? 1 : 0) |
                    (k % 2 == 0 && aligned8(mop) ? 2 : 0);
  int C = cluster;
  if (C <= 0) {
    err = refine_design(B, k, R, sizeof(TF), sizeof(TM), &C);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 1, 2 or 4 CTAs a lane: the sizes the dispatch picks
  if ((C != 1 && C != 2 && C != kMaxClusterS) ||
      static_cast<long long>(B) * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (design) *design = C;
  bool fits = false;
  err = refine_in_smem(k, R, sizeof(TF), sizeof(TM), &fits);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > 1) {
    if (!fits) return static_cast<int>(cudaErrorInvalidValue);
    // more than half an SM's shared memory, so no two CTAs share an SM
    int optin = 0;
    err = smem_optin(&optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    size_t smem = lane_bytes(k, R, sizeof(TF), sizeof(TM));
    if (smem < static_cast<size_t>(optin) / 2 + 1024)
      smem = static_cast<size_t>(optin) / 2 + 1024;
    err = vec ? launch_cluster<TF, TM, TR, TO, true>(minv, mop, dinv, shift,
                                                    r, x, B, k, R, steps,
                                                    pairs, C, smem, stream)
              : launch_cluster<TF, TM, TR, TO, false>(minv, mop, dinv, shift,
                                                     r, x, B, k, R, steps,
                                                     pairs, C, smem, stream);
    return static_cast<int>(err);
  }
  if (!fits && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fits ? lane_bytes(k, R, sizeof(TF), sizeof(TM)) : 0;
  if (fits) scratch = nullptr;
  err = vec ? launch_refine<TF, TM, TR, TO, true>(minv, mop, dinv, shift, r,
                                                 x, scratch, B, k, R, steps,
                                                 pairs, smem, stream)
            : launch_refine<TF, TM, TR, TO, false>(minv, mop, dinv, shift, r,
                                                  x, scratch, B, k, R, steps,
                                                  pairs, smem, stream);
  return static_cast<int>(err);
}

}  // namespace

// minv: (B, k, k) TF; m_op: (B, k, k) TM; dinv, shift: (B, k) TM;
// r: (B, k, R) TR; x: (B, k, R) TO, all contiguous; scratch as above;
// cluster: 0 for the launcher's design, 1 for one CTA a lane, 2 or 4 for
// that cluster size (refine > 0 only; a cluster that cannot be placed is
// an error, never another design); design: null, or where the host gets
// the design the call took (0 at refine 0, 1 one CTA a lane, else the
// cluster size; 0 for an empty call).  Named
// mt_spd_solve_<TF>_<TM>_<TR>_<TO>.  Returns a cudaError_t.
#define MT_SPD_SOLVE(NAME, TF, TM, TR, TO)                                    \
  extern "C" int NAME(const void* minv, const void* mop, const void* dinv,    \
                      const void* shift, const void* r, void* x,              \
                      void* scratch, int B, int k, int R, int steps,          \
                      int cluster, void* stream, int* design) {               \
    return launch<TF, TM, TR, TO>(minv, mop, dinv, shift, r, x, scratch, B,   \
                                  k, R, steps, cluster, stream, design);      \
  }
