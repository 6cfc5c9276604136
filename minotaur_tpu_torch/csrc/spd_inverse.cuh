// K1: batched SPD factorize + explicit inverse (Hopper, sm_90a).
//
// Replaces the TPU kernel minotaur_tpu/ops/pallas_kkt.py:_build_factor_inv
// (reached through batched_spd_inverse / _spd_inverse_vmappable): for every
// lane b of a (B, k, k) batch of Jacobi-scaled SPD matrices it returns
// Minv = L^-T L^-1 = Linv' Linv and flag 0, or the identity and flag 2 when
// a pivot is non-positive or non-finite, or when an entry of Minv is not
// finite.  The result depends only on the lower triangle of the input (the
// upper halves of the 32x32 diagonal blocks are loaded but never used).
//
// What bounds it on this card.  The work is k^3 flops per lane (potrf,
// trtri and lauum, k^3/3 each): 1.73 GFLOP at B=64, k=300, 25.8 us at the
// 67 TFLOP/s peak of either type; the bytes the function needs (a read of
// the lower triangle of ms, a write of Minv) take 10.3 us (f32) or 20.7 us
// (f64) at 3.35 TB/s, so the bound is the 25.8 us of operations in both.
// Neither is what limits it.  The factor and the triangular inverse of one
// lane are a chain of k/32 dependent panel steps, each a rank-32 update of
// a trailing triangle of up to k^2/2 entries, and a warp starts at most one
// FMA every other cycle, so stage A is bound by that chain and by the FMA
// rate of the SMs it occupies.  Stage B is a batched product on a grid
// that fills all 132 SMs.
//
// Two designs of stage A, one kernel each; the launcher picks one from
// (B, k) (factor_design, the one place of the threshold):
//  - one CTA a lane, for k < kClusterMinK or B > 66: B SMs.  At the
//    main path's (64, 300) it takes 0.3216 ms against 0.3610 for clusters
//    of 2 (f32; f64 0.4794 against 0.5300); at (16, 300) 0.2638 against
//    0.2911 and 0.2728 (C = 2, 4).
//  - a cluster of C CTAs a lane (kMaxClusterA = 4 at most, the largest C
//    with B * C <= the SM count: C = 2 at B = 64, 4 at B <= 33), for
//    k >= kClusterMinK = 384: B * C SMs split each panel's substitution and
//    update C ways, and two cluster barriers a panel replace the block
//    barriers.  (64, 384) f32: 0.4678 ms against 0.4894 for one CTA;
//    (64, 1024) f32 5.4594 against 8.3480; (64, 1378) f32 15.1566 against
//    22.0987; (64, 1024) f64 11.7525 against 24.7808; (16, 1024) f32
//    2.3731 (C = 4) against 5.9861, where C = 8 took 3.0595 (in an
//    earlier run of the tool, when it still timed C = 8): every CTA
//    copies (C - 1) / C of the panel through DSMEM each step, which grows
//    with C, so the launcher takes only C = 1, 2 and 4.  The update itself runs at 15-25% of the FFMA peak of its SMs,
//    as in the one-CTA design.  (NVIDIA H100 80GB HBM3, 700 W,
//    tools/kernel_designs.py.)
// A cluster that cannot be placed (cudaOccupancyMaxActiveClusters 0) or a
// failed cudaLaunchKernelEx is returned as an error; nothing falls back.
//
// Three launches on the caller's stream:
//
//   A. factor, one CTA a lane (12 warps), panel width 32.  The lane's
//      k x k scratch X holds, in its lower block triangle, the trailing
//      matrix C (blocks right of the panel) and the forward substitution
//      R of L X = I, which becomes Linv (blocks up to the panel): the two
//      never overlap.  For each 32-column panel p:
//        a. warps 2-11 load the panel below the diagonal block and the
//           block row of R left of it into the panel buffer W (32 x k,
//           transposed, in shared memory).
//        b. every column of W outside the diagonal block gets L_pp^-1
//           applied by forward substitution (one thread a column): below
//           the block they become the panel of L (the trsm of potrf), left
//           of it the block row of Linv (also stored in X).  The diagonal
//           block of Linv is Dinv = L_pp^-1.
//        c. one rank-32 update of the block rows below p over [R | C]:
//           block (I, J), I > p, J <= I, becomes old - W_I' W_J (J > p:
//           the Cholesky trailing update; J <= p: the forward
//           substitution).  Warps take 32x32 blocks from a shared counter;
//           each lane holds an 8x4 register tile and reads 12 values of W
//           per 32 FMAs.  First, warp 0 updates the next diagonal block and
//           factors it with shuffles and no block barrier while warp 1
//           inverts it in lockstep (a 64-thread named barrier a column),
//           so Dinv of panel p+1 is ready when c ends (lookahead).  The
//           pivot test sits in that factor.
//      Three block barriers per panel (about 30 at k=300); L itself is
//      never stored.  This is the blocked right-looking potrf with trtri
//      fused into it as block forward substitution.
//   A'. factor, a cluster of C CTAs (12 warps each) a lane: the same steps
//      and the same operations on every entry in the same order, spread
//      over the cluster (see spd_inverse_factor_cluster_kernel), so both
//      designs return the same bits.
//   B. gram: Minv = Linv' Linv on a grid of (lower-triangle 64x64 tiles) x
//      lanes (15 x 64 = 960 CTAs at k=300, all 132 SMs).  A tile (a, b)
//      sums X[t, a]' X[t, b] over t >= 64 a only (Linv is lower
//      triangular), 128 threads with 8x4 register tiles, 32 rows of X
//      staged in shared memory per step with the next step prefetched
//      into registers.  It writes the tile and its mirror, skips lanes
//      that A flagged, and ORs a non-finite tile into the lane's fail word.
//   C. finish: one CTA per lane writes flag (0 or 2) in the tensor's dtype
//      and the identity into failed lanes.
//
// Panel width 32: one warp's 32 lanes own the 32 rows of a diagonal block,
// so its factor needs no block barrier; W (32 x k) fits shared memory up
// to k = 1664 (f32) or 736 (f64); and the 32-wide block grid gives 32x32
// warp blocks.  Width 64 would need block barriers inside the diagonal
// factor and twice the shared memory.  Larger lanes keep W in a global
// scratch buffer (same code, the other instantiation); in the cluster
// design each warp then stages the two 32x32 tiles of its block in shared
// memory, so the f64 update at k = 1024 reads W from shared memory as the
// f32 one does.  A CTA's blocks read nearly every column of W whatever
// their split (block (I, J) reads W_I and W_J), so the cluster keeps a
// whole copy of W in each CTA rather than a share of it.
//
// Arithmetic is FFMA (f32) or DFMA (f64); no tensor cores, no TF32.  (DMMA,
// the f64 tensor-core product, adds four products an instruction, so it
// would not keep the one-CTA design's rounding; DFMA on two SMs a lane
// already takes (64, 1024) f64 below the plain version.)
// Square roots and divisions are IEEE, and every update subtracts one
// product at a time in column order, so the result rounds exactly as the
// unblocked right-looking Cholesky, row-wise forward substitution and a
// row-ordered Linv' Linv do.  The IPM's outcome on a lane near the f32
// limit depends on that rounding: with rsqrt and reciprocal multiplies one
// intquad(300) lane ended at the iteration limit where the plain version
// converged.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"

namespace {

constexpr int kNb = 32;                 // panel width, block size of the lane
constexpr int kThreadsA = 384;          // stage A: 12 warps per lane
constexpr int kWarpsA = kThreadsA / 32;
constexpr int kTileB = 64;              // stage B: 64 x 64 output tiles
constexpr int kThreadsB = 128;          // 8 x 16 threads, 8 x 4 outputs each
constexpr int kDepthB = 32;             // rows of X staged per step
constexpr int kThreadsC = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLdD = kNb + 4;           // row stride of Dinv' and L' in shared memory
// the design threshold (see the header note): stage A takes the cluster
// design from this order on, with the largest power-of-two cluster size up
// to kMaxClusterA that keeps B * C within the SMs
constexpr int kClusterMinK = 384;
constexpr int kMaxClusterA = 4;

// row stride of the panel buffer W (at most k + 35): 16-byte aligned rows
// for the vector loads, and not a multiple of 32 (fewer bank conflicts in
// the transpose)
__host__ __device__ inline int panel_stride(int k) {
  return ((k + kNb - 1) / kNb) * kNb + 4;
}

__device__ __forceinline__ bool finite_value(float x) { return isfinite(x); }
__device__ __forceinline__ bool finite_value(double x) { return isfinite(x); }

// barrier 1 between warps 0 and 1 (the diagonal block's two warps)
__device__ __forceinline__ void named_barrier_sync() {
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

// four consecutive values from a 16-byte-aligned address
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// The 32x32 diagonal block is factored and inverted by warps 0 and 1 in
// lockstep, joined by named barrier 1 once a step.  Warp 0, lane r holding
// row r of the block in d (lower triangle; entries above it are never
// read), runs the Cholesky: step j puts column j of L in row j of lt (L'
// in shared memory, row stride kLdD, entry 32 L[j][j]) and updates the
// trailing rows.  Warp 1, lane r holding column r of Y = L^-1 in z,
// applies the same column to the inverse, and at the end writes Dinv' = Y'
// into dinv_t (row stride kLdD; Dinv is zero above the diagonal).  Square
// roots and divisions are IEEE (no rsqrt, no reciprocal multiply), and
// every update subtracts one product at a time in column order, so stage A
// rounds exactly as the unblocked right-looking Cholesky and row-wise
// forward substitution do.
template <typename T>
__device__ __forceinline__ bool factor_block(T (&d)[kNb], T* lt, int r) {
  bool bad = false;
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    const T piv = __shfl_sync(kFull, d[j], j);
    bad |= !(piv > T(0)) || !finite_value(piv);
    const T ljj = sqrt(piv);
    const T lrj = (r == j) ? ljj : ((r > j) ? d[j] / ljj : T(0));
    T* cj = lt + j * kLdD;
    cj[r] = lrj;                        // L[r][j]
    if (r == 0) cj[kNb] = ljj;
    named_barrier_sync();
#pragma unroll
    for (int c4 = (j + 1) & ~3; c4 < kNb; c4 += 4) {
      T l4[4];
      load4(cj + c4, l4);               // L[c4 .. c4+3][j]
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c4 + q > j) d[c4 + q] -= lrj * l4[q];
    }
  }
  return bad;
}

template <typename T>
__device__ __forceinline__ void invert_block(const T* lt, T* dinv_t, int r) {
  T z[kNb];
#pragma unroll
  for (int i = 0; i < kNb; ++i) z[i] = (i == r) ? T(1) : T(0);
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    named_barrier_sync();
    const T* cj = lt + j * kLdD;
    z[j] /= cj[kNb];                    // Y[j][r] = Z[j][r] / L[j][j]
#pragma unroll
    for (int c4 = (j + 1) & ~3; c4 < kNb; c4 += 4) {
      T l4[4];
      load4(cj + c4, l4);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c4 + q > j) z[c4 + q] -= l4[q] * z[j];
    }
  }
#pragma unroll
  for (int i = 0; i < kNb; ++i) dinv_t[r * kLdD + i] = z[i];
}

// One warp's 32x32 block of a product: rows [r0, r0 + 32) and columns
// [q0, q0 + 32) of  acc += A' B,  (A' B)[r][q] = sum_t A[t][r] B[t][q],
// with A and B stored t-major (row strides lda, ldb).  Lane (ry, cx) =
// (ln / 8, ln % 8) owns rows r0 + 8 ry + i (i < 8) and columns
// q0 + cx + 8 c (c < 4).  Per step t it reads 12 values for 32 FMAs, so the
// shared-memory return path (32 values a cycle per SM) keeps up with the
// FMA rate, and the 8 lanes of a group cover 8 neighbouring columns of a
// row, so the caller's global loads and stores are coalesced.
constexpr int kTr = 8, kTc = 4;         // register tile of a lane

template <typename T>
__device__ __forceinline__ void warp_gemm(const T* A, int lda, const T* B,
                                          int ldb, int r0, int q0,
                                          T (&acc)[kTr][kTc]) {
  const int ln = threadIdx.x & 31, ry = ln >> 3, cx = ln & 7;
  const T* a_p = A + r0 + kTr * ry;
  const T* b_p = B + q0 + cx;
#pragma unroll 4
  for (int t = 0; t < kNb; ++t) {
    T a0[4], a1[4], bv[kTc];
    load4(a_p + t * lda, a0);
    load4(a_p + t * lda + 4, a1);
#pragma unroll
    for (int c = 0; c < kTc; ++c) bv[c] = b_p[t * ldb + 8 * c];
#pragma unroll
    for (int c = 0; c < kTc; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][c] += a0[i] * bv[c];
        acc[i + 4][c] += a1[i] * bv[c];
      }
    }
  }
}

// shared memory of stage A, in elements of T: two Dinv' buffers and L' of
// the diagonal block (row stride kLdD), the lookahead transpose tile
// (32 x 33), then the panel buffer W when it is resident
constexpr int kSmemFixed = 3 * kNb * kLdD + kNb * (kNb + 1);

template <typename T, bool kSmemPanel>
__global__ void __launch_bounds__(kThreadsA, 1)
spd_inverse_factor_kernel(const T* __restrict__ ms, T* __restrict__ xbuf,
                          T* __restrict__ wbuf, int* __restrict__ fail,
                          int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dinv_buf = reinterpret_cast<T*>(smem_raw);
  T* lt = dinv_buf + 2 * kNb * kLdD;
  T* tile = lt + kNb * kLdD;
  __shared__ int s_fail, s_next;

  const int ws = panel_stride(k);
  const long long b = blockIdx.x;
  const long long kk = static_cast<long long>(k) * k;
  const T* A = ms + b * kk;
  // X holds, in the lower block triangle, C (the trailing matrix, blocks
  // J > p) and R, then Linv (blocks J <= p): the two never overlap
  T* X = xbuf + b * kk;
  T* W;                                 // panel buffer, kNb x ws
  if constexpr (kSmemPanel) {
    W = dinv_buf + kSmemFixed;
  } else {
    W = wbuf + b * kNb * ws;
  }
  const int tid = threadIdx.x, ln = tid & 31, warp = tid >> 5;
  const int ry = ln >> 3, cx = ln & 7;
  const int nblk = (k + kNb - 1) / kNb;
  if (tid == 0) s_fail = 0;

  for (int p = 0; p < nblk; ++p) {
    const int c0 = p * kNb;
    const int nbp = min(kNb, k - c0);
    const T* src = (p == 0) ? A : X;
    const T* dcur = dinv_buf + (p & 1) * kNb * kLdD;       // Dinv'
    T* dnext = dinv_buf + ((p + 1) & 1) * kNb * kLdD;

    // ---- a. warps 2-11 fill W: the block row's right-hand side R[p, :c0]
    //         (rows t >= nbp zero) and the panel below the diagonal block,
    //         transposed.  Warps 0-1 factor the first diagonal block
    //         (later ones are factored ahead, in step c of the panel before).
    if (warp < 2) {
      if (p == 0) {
        if (warp == 0) {
          T d[kNb];
          const T* row = A + static_cast<long long>(ln) * k;
#pragma unroll
          for (int c = 0; c < kNb; ++c)
            d[c] = (ln < nbp) ? ((c <= ln) ? row[c] : T(0))
                              : ((c == ln) ? T(1) : T(0));
          if (factor_block(d, lt, ln) && ln == 0) s_fail = 1;
        } else {
          invert_block(lt, dinv_buf, ln);
        }
      }
    } else {
      for (int t = warp - 2; t < kNb; t += kWarpsA - 2) {
        const T* xr = X + static_cast<long long>(c0 + t) * k;
        for (int u = ln; u < c0; u += 32) W[t * ws + u] = (t < nbp) ? xr[u] : T(0);
      }
      constexpr int kRows = 8;
      for (int i0 = c0 + kNb + (warp - 2) * kRows; i0 < k;
           i0 += (kWarpsA - 2) * kRows) {
        T v[kRows];
#pragma unroll
        for (int m = 0; m < kRows; ++m)
          v[m] = (i0 + m < k)
                     ? src[static_cast<long long>(i0 + m) * k + c0 + ln]
                     : T(0);
#pragma unroll
        for (int m = 0; m < kRows; ++m)
          if (i0 + m < k) W[ln * ws + i0 + m] = v[m];
      }
    }
    if (tid == 0) s_next = 0;
    __syncthreads();
    if (s_fail) break;

    // ---- b. L_pp^-1 applied to every column u of W outside the diagonal
    //         block, by forward substitution (one thread a column, L' from
    //         the factor in lt): left of the block this is the block row of
    //         X (also stored in X), below it the panel of L (L[i, p]' =
    //         L_pp^-1 C[i, p]').  The diagonal block of X is Dinv.
    for (int u0 = tid; u0 < k - nbp; u0 += kThreadsA) {
      const int u = (u0 < c0) ? u0 : u0 + nbp;
      T v[kNb];
#pragma unroll
      for (int t = 0; t < kNb; ++t) v[t] = W[t * ws + u];
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        const T* lj = lt + j * kLdD;    // column j of L_pp
        v[j] /= lj[kNb];
#pragma unroll
        for (int t4 = (j + 1) & ~3; t4 < kNb; t4 += 4) {
          T l4[4];
          load4(lj + t4, l4);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (t4 + q > j) v[t4 + q] -= l4[q] * v[j];
        }
      }
#pragma unroll
      for (int t = 0; t < kNb; ++t) {
        W[t * ws + u] = v[t];
        if (u < c0 && t < nbp) X[static_cast<long long>(c0 + t) * k + u] = v[t];
      }
    }
    for (int e = tid; e < kNb * kNb; e += kThreadsA) {
      const int t = e / kNb, c = e - t * kNb;
      const T v = dcur[c * kLdD + t];   // Dinv[t][c], zero above the diagonal
      W[t * ws + c0 + c] = v;
      if (c <= t && t < nbp) X[static_cast<long long>(c0 + t) * k + c0 + c] = v;
    }
    __syncthreads();
    if (p == nblk - 1) break;

    // ---- c. rank-32 update over [R | C]: block (I, J), I > p, J <= I,
    //         becomes old - W_I' W_J.  Warp 0 first updates the next
    //         diagonal block and factors it with warp 1 (lookahead); all
    //         warps then take the other blocks from a shared counter.
    const int q1 = p + 1;
    if (warp == 0) {
      T acc[kTr][kTc];
#pragma unroll
      for (int c = 0; c < kTc; ++c) {
        const int j = q1 * kNb + cx + 8 * c;
#pragma unroll
        for (int i = 0; i < kTr; ++i) {
          const int r = q1 * kNb + kTr * ry + i;
          acc[i][c] = (r < k && j < k)
                          ? -src[static_cast<long long>(r) * k + j] : T(0);
        }
      }
      warp_gemm(W, ws, W, ws, q1 * kNb, q1 * kNb, acc);
      // lane r of the factor needs row r: transpose through the tile
#pragma unroll
      for (int c = 0; c < kTc; ++c)
#pragma unroll
        for (int i = 0; i < kTr; ++i)
          tile[(kTr * ry + i) * (kNb + 1) + cx + 8 * c] = -acc[i][c];
      __syncwarp();
      const int nb1 = min(kNb, k - q1 * kNb);
      T d[kNb];
#pragma unroll
      for (int c = 0; c < kNb; ++c)
        d[c] = (ln < nb1) ? ((c <= ln) ? tile[ln * (kNb + 1) + c] : T(0))
                          : ((c == ln) ? T(1) : T(0));
      if (factor_block(d, lt, ln) && ln == 0) s_fail = 1;
    } else if (warp == 1) {
      invert_block(lt, dnext, ln);
    }
    for (;;) {
      int q = 0;
      if (ln == 0) q = atomicAdd(&s_next, 1);
      q = __shfl_sync(kFull, q, 0);
      // block row q1 has q1 blocks besides its diagonal, row I > q1 has I + 1
      int I = q1, n = q1;
      while (I < nblk && q >= n) {
        q -= n;
        ++I;
        n = I + 1;
      }
      if (I >= nblk) break;
      const int J = q, r0 = I * kNb, j0 = J * kNb;
      const T* old = (J > p) ? src : ((J < p) ? X : nullptr);
      T acc[kTr][kTc];
#pragma unroll
      for (int c = 0; c < kTc; ++c) {
        const int j = j0 + cx + 8 * c;
#pragma unroll
        for (int i = 0; i < kTr; ++i) {
          const int r = r0 + kTr * ry + i;
          acc[i][c] = (old != nullptr && r < k && j < k)
                          ? -old[static_cast<long long>(r) * k + j] : T(0);
        }
      }
      warp_gemm(W, ws, W, ws, r0, j0, acc);
#pragma unroll
      for (int c = 0; c < kTc; ++c) {
        const int j = j0 + cx + 8 * c;
#pragma unroll
        for (int i = 0; i < kTr; ++i) {
          const int r = r0 + kTr * ry + i;
          if (r < k && j < k) X[static_cast<long long>(r) * k + j] = -acc[i][c];
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) fail[b] = s_fail;
}

// ---------------------------------------------------------------------------
// Stage A, the cluster design: one cluster of C CTAs (12 warps each) per
// lane, blockIdx.x = lane * C + rank.  The per-panel steps of the one-CTA
// kernel above, spread over the cluster:
//   ab. CTA r loads and forward-substitutes the columns of W in its share of
//       block columns [r nblk / C, (r + 1) nblk / C), one thread a column,
//       with L_pp and Dinv copied from the CTA that factored block p (rank
//       p % C) through distributed shared memory (DSMEM).
//   c.  after a cluster barrier every CTA copies the other CTAs' columns of
//       W into its own copy through DSMEM (kSmemPanel; else W lives in the
//       lane's global wbuf and each warp stages the two 32x32 tiles of a
//       block into its own shared slot), then updates every C-th block of
//       the rank-32 update.  Rank (p + 1) % C factors and inverts the next
//       diagonal block first (the lookahead of the one-CTA kernel).
// A second cluster barrier ends the panel.  Every entry sees the same
// operations in the same order as in the one-CTA kernel, so the two designs
// return the same bits.  The trailing matrix and R live in the lane's X in
// global memory; CTAs of a cluster sit on different SMs, so X (and wbuf) is
// read through L2 (ld.global.cg), after the barrier that orders the writes.

// fixed shared memory of the cluster design, in elements of T: L' and Dinv'
// of the current diagonal block (row stride kLdD), the lookahead transpose
// tile (32 x 33); then the panel W (kSmemPanel) or two 32x32 staging tiles a
// warp
constexpr int kSmemFixedCl = 2 * kNb * kLdD + kNb * (kNb + 1);
constexpr int kStageCl = kWarpsA * 2 * kNb * kNb;

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }

// tile[t][c] = W[t][c0 + c] for a 32x32 block of W in global memory, by one
// warp, 16 bytes a load (rows of W start 16-byte aligned)
template <typename T>
__device__ __forceinline__ void stage_tile(const T* W, int ws, int c0,
                                           T* tile) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int kRow = kNb / kPer;      // 16-byte units a row
  for (int e = threadIdx.x & 31; e < kNb * kRow; e += 32) {
    const int t = e / kRow, c = (e - t * kRow) * kPer;
    *reinterpret_cast<uint4*>(tile + t * kNb + c) =
        __ldcg(reinterpret_cast<const uint4*>(W + t * ws + c0 + c));
  }
  __syncwarp();
}

template <typename T, bool kSmemPanel>
__global__ void __launch_bounds__(kThreadsA, 1)
spd_inverse_factor_cluster_kernel(const T* __restrict__ ms,
                                  T* __restrict__ xbuf, T* __restrict__ wbuf,
                                  int* __restrict__ fail, int k) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lt = reinterpret_cast<T*>(smem_raw);           // L' of the block
  T* dinv = lt + kNb * kLdD;                        // Dinv' of the block
  T* tile = dinv + kNb * kLdD;
  T* dyn = lt + kSmemFixedCl;
  __shared__ int s_fail, s_next;

  const int ws = panel_stride(k);
  const long long b = blockIdx.x / C;
  const long long kk = static_cast<long long>(k) * k;
  const T* A = ms + b * kk;
  T* X = xbuf + b * kk;
  T* W = kSmemPanel ? dyn : wbuf + b * kNb * ws;
  const int tid = threadIdx.x, ln = tid & 31, warp = tid >> 5;
  const int ry = ln >> 3, cx = ln & 7;
  const int nblk = (k + kNb - 1) / kNb;
  const int u_lo = rank * nblk / C * kNb;
  const int u_hi = min((rank + 1) * nblk / C * kNb, k);
  if (tid == 0) s_fail = 0;
  if (rank == 0 && warp < 2) {          // the first diagonal block
    if (warp == 0) {
      const int nb0 = min(kNb, k);
      T d[kNb];
      const T* row = A + static_cast<long long>(ln) * k;
#pragma unroll
      for (int c = 0; c < kNb; ++c)
        d[c] = (ln < nb0) ? ((c <= ln) ? row[c] : T(0))
                          : ((c == ln) ? T(1) : T(0));
      if (factor_block(d, lt, ln) && ln == 0) s_fail = 1;
    } else {
      invert_block(lt, dinv, ln);
    }
  }
  cluster.sync();

  bool failed = false;
  for (int p = 0; p < nblk; ++p) {
    const int c0 = p * kNb;
    const int nbp = min(kNb, k - c0);
    const int owner = p % C;            // factored block p
    const T* src = (p == 0) ? A : X;
    if (*cluster.map_shared_rank(&s_fail, owner)) {   // uniform
      failed = true;
      break;
    }
    if (rank != owner) {                // L' and Dinv' are contiguous
      const T* rlt = cluster.map_shared_rank(lt, owner);
      for (int e = tid; e < 2 * kNb * kLdD; e += kThreadsA) lt[e] = rlt[e];
    }
    if (tid == 0) s_next = 0;
    __syncthreads();

    // ---- ab. load and forward-substitute this CTA's columns of W: left
    //          of the diagonal block the block row of R (also stored in X),
    //          below it the panel (row u of the trailing matrix, read along
    //          the row)
    for (int u = u_lo + tid; u < u_hi; u += kThreadsA) {
      if (u >= c0 && u < c0 + nbp) continue;
      T v[kNb];
      if (u < c0) {
#pragma unroll
        for (int t = 0; t < kNb; ++t)
          v[t] = (t < nbp) ? ldcg(X + static_cast<long long>(c0 + t) * k + u)
                           : T(0);
      } else {
        const T* row = src + static_cast<long long>(u) * k + c0;
#pragma unroll
        for (int t = 0; t < kNb; ++t) v[t] = ldcg(row + t);
      }
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        const T* lj = lt + j * kLdD;    // column j of L_pp
        v[j] /= lj[kNb];
#pragma unroll
        for (int t4 = (j + 1) & ~3; t4 < kNb; t4 += 4) {
          T l4[4];
          load4(lj + t4, l4);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (t4 + q > j) v[t4 + q] -= l4[q] * v[j];
        }
      }
#pragma unroll
      for (int t = 0; t < kNb; ++t) {
        W[t * ws + u] = v[t];
        if (u < c0 && t < nbp) X[static_cast<long long>(c0 + t) * k + u] = v[t];
      }
    }
    // the diagonal block of W is Dinv: every copy of W gets it (the
    // global W once), and the owner stores it in X
    if (kSmemPanel || rank == owner) {
      for (int e = tid; e < kNb * kNb; e += kThreadsA) {
        const int t = e / kNb, c = e - t * kNb;
        const T v = dinv[c * kLdD + t];
        W[t * ws + c0 + c] = v;
        if (rank == owner && c <= t && t < nbp)
          X[static_cast<long long>(c0 + t) * k + c0 + c] = v;
      }
    }
    if (p == nblk - 1) break;
    cluster.sync();                     // every column of W is final

    if constexpr (kSmemPanel) {         // gather the other CTAs' columns
      constexpr int kPer = 16 / static_cast<int>(sizeof(T));
      for (int d = 1; d < C; ++d) {
        const int rr = (rank + d) % C;
        const int lo = rr * nblk / C * kNb, hi = (rr + 1) * nblk / C * kNb;
        const int nv = (hi - lo) / kPer;
        const T* rW = cluster.map_shared_rank(W, rr);
        for (int e = tid; e < kNb * nv; e += kThreadsA) {
          const int t = e / nv;
          const int off = t * ws + lo + (e - t * nv) * kPer;
          *reinterpret_cast<uint4*>(W + off) =
              *reinterpret_cast<const uint4*>(rW + off);
        }
      }
      __syncthreads();
    }

    // ---- c. the rank-32 update, every C-th block of the one-CTA
    //         kernel's order to this CTA; rank (p + 1) % C updates the next
    //         diagonal block first and factors it (warp 0) and inverts it
    //         (warp 1) into its own lt and dinv
    const int q1 = p + 1;
    T* ta = dyn + (kSmemPanel ? 0 : warp * 2 * kNb * kNb);
    T* tb = ta + kNb * kNb;
    if (rank == q1 % C && warp == 0) {
      T acc[kTr][kTc];
#pragma unroll
      for (int c = 0; c < kTc; ++c) {
        const int j = q1 * kNb + cx + 8 * c;
#pragma unroll
        for (int i = 0; i < kTr; ++i) {
          const int r = q1 * kNb + kTr * ry + i;
          acc[i][c] = (r < k && j < k)
              ? -ldcg(src + static_cast<long long>(r) * k + j) : T(0);
        }
      }
      if constexpr (kSmemPanel) {
        warp_gemm(W, ws, W, ws, q1 * kNb, q1 * kNb, acc);
      } else {
        stage_tile(W, ws, q1 * kNb, ta);
        warp_gemm(ta, kNb, ta, kNb, 0, 0, acc);
        __syncwarp();
      }
#pragma unroll
      for (int c = 0; c < kTc; ++c)
#pragma unroll
        for (int i = 0; i < kTr; ++i)
          tile[(kTr * ry + i) * (kNb + 1) + cx + 8 * c] = -acc[i][c];
      __syncwarp();
      const int nb1 = min(kNb, k - q1 * kNb);
      T d[kNb];
#pragma unroll
      for (int c = 0; c < kNb; ++c)
        d[c] = (ln < nb1) ? ((c <= ln) ? tile[ln * (kNb + 1) + c] : T(0))
                          : ((c == ln) ? T(1) : T(0));
      if (factor_block(d, lt, ln) && ln == 0) s_fail = 1;
    } else if (rank == q1 % C && warp == 1) {
      invert_block(lt, dinv, ln);
    }
    for (;;) {
      int q = 0;
      if (ln == 0) q = atomicAdd(&s_next, 1);
      q = __shfl_sync(kFull, q, 0) * C + rank;
      int I = q1, n = q1;
      while (I < nblk && q >= n) {
        q -= n;
        ++I;
        n = I + 1;
      }
      if (I >= nblk) break;
      const int J = q, r0 = I * kNb, j0 = J * kNb;
      const T* old = (J > p) ? src : ((J < p) ? X : nullptr);
      T acc[kTr][kTc];
#pragma unroll
      for (int c = 0; c < kTc; ++c) {
        const int j = j0 + cx + 8 * c;
#pragma unroll
        for (int i = 0; i < kTr; ++i) {
          const int r = r0 + kTr * ry + i;
          acc[i][c] = (old != nullptr && r < k && j < k)
              ? -ldcg(old + static_cast<long long>(r) * k + j) : T(0);
        }
      }
      if constexpr (kSmemPanel) {
        warp_gemm(W, ws, W, ws, r0, j0, acc);
      } else {
        stage_tile(W, ws, r0, ta);
        stage_tile(W, ws, j0, tb);
        warp_gemm(ta, kNb, tb, kNb, 0, 0, acc);
        __syncwarp();
      }
#pragma unroll
      for (int c = 0; c < kTc; ++c) {
        const int j = j0 + cx + 8 * c;
#pragma unroll
        for (int i = 0; i < kTr; ++i) {
          const int r = r0 + kTr * ry + i;
          if (r < k && j < k) X[static_cast<long long>(r) * k + j] = -acc[i][c];
        }
      }
    }
    cluster.sync();                     // X updated, block p + 1 factored
  }
  // no CTA may exit while another can still read its shared memory
  cluster.sync();
  if (rank == 0 && tid == 0) fail[b] = failed ? 1 : 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreadsB)
spd_inverse_gram_kernel(const T* __restrict__ xbuf, T* __restrict__ out,
                        int* __restrict__ fail, int k, int lane0) {
  // staging rows of X (As | Bs) while summing, then the finished tile
  __shared__ __align__(16) T sm[kTileB * (kTileB + 1)];
  __shared__ int s_failed;
  const int b = lane0 + blockIdx.y;
  // stage A failed this lane?  One read for the whole CTA: other CTAs of
  // the lane may set bit 2 of the word meanwhile, and every thread must
  // take the same branch to the barriers below
  if (threadIdx.x == 0) s_failed = fail[b] & 1;
  __syncthreads();
  if (s_failed) return;
  // lower-triangle tile (ta, tb), ta >= tb, from the linear index
  const int x = blockIdx.x;
  int ta = static_cast<int>((sqrtf(8.0f * x + 1.0f) - 1.0f) * 0.5f);
  while ((ta + 1) * (ta + 2) / 2 <= x) ++ta;
  while (ta * (ta + 1) / 2 > x) --ta;
  const int tb = x - ta * (ta + 1) / 2;
  const int a0 = ta * kTileB, b0 = tb * kTileB;

  const long long kk = static_cast<long long>(k) * k;
  const T* X = xbuf + b * kk;
  T* O = out + b * kk;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  T* As = sm;
  T* Bs = sm + kDepthB * kTileB;
  // each thread stages column lc of rows lr + 2 m (m < 16) for both tiles;
  // X[t][c] is read only for c <= t (Linv is lower triangular)
  const int lc = tid & (kTileB - 1), lr = tid >> 6;
  constexpr int kPer = kDepthB * kTileB / kThreadsB;     // 16
  T ra[kPer], rb[kPer];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int t = t0 + lr + 2 * m;
      const long long row = static_cast<long long>(t) * k;
      ra[m] = (t < k && a0 + lc <= t) ? X[row + a0 + lc] : T(0);
      rb[m] = (t < k && b0 + lc <= t) ? X[row + b0 + lc] : T(0);
    }
  };
  // thread (ty, tx) owns rows 8 ty + i (i < 8) and columns tx + 16 c
  // (c < 4): 12 values of shared memory per 32 FMAs
  T acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  fetch(a0);                            // rows above a0 >= b0 add nothing
  for (int t0 = a0; t0 < k; t0 += kDepthB) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      As[(lr + 2 * m) * kTileB + lc] = ra[m];
      Bs[(lr + 2 * m) * kTileB + lc] = rb[m];
    }
    __syncthreads();
    if (t0 + kDepthB < k) fetch(t0 + kDepthB);
#pragma unroll 4
    for (int t = 0; t < kDepthB; ++t) {
      T a_lo[4], a_hi[4], bv[4];
      load4(As + t * kTileB + ty * 8, a_lo);
      load4(As + t * kTileB + ty * 8 + 4, a_hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[t * kTileB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += a_lo[i] * bv[j];
          acc[i + 4][j] += a_hi[i] * bv[j];
        }
    }
    __syncthreads();
  }

  // entries outside the matrix are sums of zeros, so no mask is needed
  bool bad = false;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) bad |= !finite_value(acc[i][j]);
  if (__syncthreads_or(bad) && tid == 0) atomicOr(fail + b, 2);

  constexpr int kLd = kTileB + 1;
  T* Cs = sm;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty * 8 + i) * kLd + tx + 16 * j] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < kTileB * kTileB; e += kThreadsB) {
    const int r = e / kTileB, c = e - r * kTileB;
    if (a0 + r < k && b0 + c < k)
      O[static_cast<long long>(a0 + r) * k + b0 + c] = Cs[r * kLd + c];
    if (ta != tb && b0 + r < k && a0 + c < k)
      O[static_cast<long long>(b0 + r) * k + a0 + c] = Cs[c * kLd + r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsC)
spd_inverse_finish_kernel(T* __restrict__ out, const int* __restrict__ fail,
                          T* __restrict__ flag, int k) {
  const long long b = blockIdx.x;
  const int failed = fail[b];
  if (threadIdx.x == 0) flag[b] = failed ? T(2) : T(0);
  if (!failed) return;
  T* O = out + b * static_cast<long long>(k) * k;
  const int ln = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < k; i += kThreadsC / 32) {
    const long long row = static_cast<long long>(i) * k;
    for (int c = ln; c < k; c += 32) O[row + c] = (i == c) ? T(1) : T(0);
  }
}

template <typename T, bool kSmemPanel>
cudaError_t launch_factor(const T* ms, T* xbuf, T* wbuf, int* fail, int B,
                          int k, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      spd_inverse_factor_kernel<T, kSmemPanel>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  spd_inverse_factor_kernel<T, kSmemPanel><<<B, kThreadsA, smem, stream>>>(
      ms, xbuf, wbuf, fail, k);
  return cudaGetLastError();
}

template <typename T, bool kSmemPanel>
cudaError_t launch_factor_cluster(const T* ms, T* xbuf, T* wbuf, int* fail,
                                  int B, int k, int C, size_t smem,
                                  cudaStream_t stream) {
  auto kernel = spd_inverse_factor_cluster_kernel<T, kSmemPanel>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreadsA);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cluster_fits(reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, ms, xbuf, wbuf, fail, k);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether stage A's panel buffer W fits the current device's shared memory
// next to the fixed part of the design (one-CTA: `fixed` = kSmemFixed,
// cluster: kSmemFixedCl), for a lane of order k and elements of `itemsize`
// bytes; otherwise W lives in the caller's global buffer wbuf.
cudaError_t panel_in_smem(int k, size_t itemsize, int fixed, bool* fits) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *fits = itemsize * (fixed + kNb * panel_stride(k)) <=
          static_cast<size_t>(optin);
  return cudaSuccess;
}

// The design of stage A for B lanes of order k: 1 (one CTA a lane), else
// the cluster size C.  The one place that sets the threshold (the times
// that set it are in the header note).
cudaError_t factor_design(int B, int k, int* C) {
  *C = 1;
  if (k < kClusterMinK) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  for (int c = kMaxClusterA; c >= 2; c /= 2) {
    if (static_cast<long long>(B) * c <= sms) {
      *C = c;
      break;
    }
  }
  return cudaSuccess;
}

template <typename T>
int launch(const void* ms_, void* out_, void* xbuf_, void* wbuf_, void* fail_,
           void* flag_, int B, int k, int cluster, void* stream_) {
  if (B <= 0 || k <= 0) return 0;
  const T* ms = static_cast<const T*>(ms_);
  T* out = static_cast<T*>(out_);
  T* xbuf = static_cast<T*>(xbuf_);
  T* wbuf = static_cast<T*>(wbuf_);
  int* fail = static_cast<int*>(fail_);
  T* flag = static_cast<T*>(flag_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);

  int C = cluster;
  cudaError_t err = cudaSuccess;
  if (C <= 0) err = factor_design(B, k, &C);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1, 2 or 4 CTAs a lane: the sizes the dispatch picks
  if ((C != 1 && C != 2 && C != kMaxClusterA) ||
      static_cast<long long>(B) * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  bool fits = false;
  err = panel_in_smem(k, sizeof(T), C == 1 ? kSmemFixed : kSmemFixedCl,
                      &fits);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!fits && wbuf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 1) {
    const size_t fixed = sizeof(T) * kSmemFixed;
    err = fits ? launch_factor<T, true>(
                     ms, xbuf, wbuf, fail, B, k,
                     fixed + sizeof(T) * kNb * panel_stride(k), stream)
               : launch_factor<T, false>(ms, xbuf, wbuf, fail, B, k, fixed,
                                         stream);
  } else {
    const size_t fixed = sizeof(T) * kSmemFixedCl;
    err = fits ? launch_factor_cluster<T, true>(
                     ms, xbuf, wbuf, fail, B, k, C,
                     fixed + sizeof(T) * kNb * panel_stride(k), stream)
               : launch_factor_cluster<T, false>(
                     ms, xbuf, wbuf, fail, B, k, C,
                     fixed + sizeof(T) * kStageCl, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const int nt = (k + kTileB - 1) / kTileB;
  const int pairs = nt * (nt + 1) / 2;
  for (int lane0 = 0; lane0 < B; lane0 += 65535) {
    const dim3 grid(pairs, B - lane0 < 65535 ? B - lane0 : 65535);
    spd_inverse_gram_kernel<T><<<grid, kThreadsB, 0, stream>>>(
        xbuf, out, fail, k, lane0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  spd_inverse_finish_kernel<T><<<B, kThreadsC, 0, stream>>>(out, fail, flag,
                                                            k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
