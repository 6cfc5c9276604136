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
// Neither is what limits this
// design.  The factor and the triangular inverse of one lane are a chain
// of k/32 dependent panel steps on one SM, and a warp starts at most one
// FMA every other cycle (12 warps reach well under one a cycle per
// scheduler), so stage A is bound by that chain and by the FMA rate of
// the 64 SMs it occupies at B=64; stage B is a batched product on a grid
// that fills all 132 SMs.
//
// Three launches on the caller's stream:
//
//   A. factor: one CTA (12 warps) per lane, panel width 32.  The lane's
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
// scratch buffer (same code, the other instantiation).
//
// Arithmetic is FFMA (f32) or DFMA (f64); no tensor cores, no TF32.
// Square roots and divisions are IEEE, and every update subtracts one
// product at a time in column order, so the result rounds exactly as the
// unblocked right-looking Cholesky, row-wise forward substitution and a
// row-ordered Linv' Linv do.  The IPM's outcome on a lane near the f32
// limit depends on that rounding: with rsqrt and reciprocal multiplies one
// intquad(300) lane ended at the iteration limit where the plain version
// converged.

#include <cuda_runtime.h>

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

// Whether stage A's panel buffer W fits the current device's shared memory
// next to the fixed part, for a lane of order k and elements of `itemsize`
// bytes; otherwise W lives in the caller's global buffer wbuf.
cudaError_t panel_in_smem(int k, size_t itemsize, bool* fits) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *fits = itemsize * (kSmemFixed + kNb * panel_stride(k)) <=
          static_cast<size_t>(optin);
  return cudaSuccess;
}

template <typename T>
int launch(const void* ms_, void* out_, void* xbuf_, void* wbuf_, void* fail_,
           void* flag_, int B, int k, void* stream_) {
  if (B <= 0 || k <= 0) return 0;
  const T* ms = static_cast<const T*>(ms_);
  T* out = static_cast<T*>(out_);
  T* xbuf = static_cast<T*>(xbuf_);
  T* wbuf = static_cast<T*>(wbuf_);
  int* fail = static_cast<int*>(fail_);
  T* flag = static_cast<T*>(flag_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);

  bool fits = false;
  cudaError_t err = panel_in_smem(k, sizeof(T), &fits);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t fixed = sizeof(T) * kSmemFixed;
  if (fits) {
    err = launch_factor<T, true>(ms, xbuf, wbuf, fail, B, k,
                                 fixed + sizeof(T) * kNb * panel_stride(k),
                                 stream);
  } else {
    if (wbuf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_factor<T, false>(ms, xbuf, wbuf, fail, B, k, fixed, stream);
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

// Elements per lane of the global panel buffer wbuf for a lane of order k
// with elements of `itemsize` bytes on the current device: 0 when the
// panel fits shared memory (wbuf is then not read and may be null), else a
// negative cudaError_t if the device query failed.
extern "C" long long mt_spd_inverse_wbuf_elems(int k, int itemsize) {
  if (k <= 0) return 0;
  bool fits = false;
  const cudaError_t err = panel_in_smem(k, static_cast<size_t>(itemsize), &fits);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return fits ? 0 : static_cast<long long>(kNb) * panel_stride(k);
}

// ms, out, xbuf: (B, k, k); wbuf: B times mt_spd_inverse_wbuf_elems(k,
// sizeof(T)) elements; fail: (B,) int32; flag: (B,).
// Returns the first non-zero cudaError_t of the three launches, else 0.
extern "C" int mt_spd_inverse_f32(const void* ms, void* out, void* xbuf,
                                  void* wbuf, void* fail, void* flag, int B,
                                  int k, void* stream) {
  return launch<float>(ms, out, xbuf, wbuf, fail, flag, B, k, stream);
}

extern "C" int mt_spd_inverse_f64(const void* ms, void* out, void* xbuf,
                                  void* wbuf, void* fail, void* flag, int B,
                                  int k, void* stream) {
  return launch<double>(ms, out, xbuf, wbuf, fail, flag, B, k, stream);
}
