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
// monotone test.  The main path's right-hand sides are vectors (R = 1); a
// wider R takes one pass per column, from L2.
//
// Two designs, one row engine.  The engine: a warp owns kRowsPerWarp rows
// at once with an independent accumulator per row, and streams them with
// 16-byte loads (float4 / double2; the vector path, taken when every row
// starts 16-byte aligned: k % 4 == 0 in f32, k % 2 == 0 in f64, and
// aligned base pointers), so each thread has several independent loads in
// flight instead of one dependent chain; other k take the scalar path of
// the same code.  Rows are reduced with warp shuffles.
//  - refine 0: a grid of (ceil(k / kRowsPerCta), B) CTAs of 8 warps (640
//    CTAs at (64, 300), four resident per SM).  Each CTA scales the lane's
//    right-hand sides into shared memory (in chunks of columns that fit
//    48 KB, for wide R) and computes its 32 rows; no CTA needs another's
//    result.
//  - refine > 0: one CTA of 16 warps per lane, since the monotone test
//    needs the whole lane between rounds.  u, x, res, x2 and res2 live in
//    shared memory when they fit (in a global scratch buffer beyond that);
//    a kept round swaps pointers instead of copying.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerWarp = 4;                   // rows in flight per warp
constexpr int kThreadsGrid = 256;                 // refine 0: 8 warps
constexpr int kRowsPerCta = kThreadsGrid / 32 * kRowsPerWarp;
constexpr int kThreadsLane = 512;                 // refine > 0: 16 warps
constexpr int kWarpsLane = kThreadsLane / 32;
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
};

// dst = (add +) dinv * TM(Minv_s @ U), all (R, kp) column-major vectors
template <bool kVec, typename TF, typename TM>
__device__ void lane_product(const LaneCtx<TF, TM>& L, const TF* U,
                             const TM* add, TM* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row0 = warp * kRowsPerWarp; row0 < L.k;
       row0 += kWarpsLane * kRowsPerWarp) {
    for (int c = 0; c < L.R; ++c) {
      double acc[kRowsPerWarp];
      warp_rows<TF, double, kVec>(L.minv, L.k, row0, U + c * L.kp, acc);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int row = row0 + i;
        if (lane == i && row < L.k) {
          const int p = c * L.kp + row;
          const TM v = static_cast<TM>(static_cast<TF>(acc[i])) * L.dv[row];
          dst[p] = add ? add[p] + v : v;
        }
      }
    }
  }
  __syncthreads();
}

// res = r - (M @ xv + shift * xv); returns sum(res^2) to every thread
template <bool kVec, typename TF, typename TM, typename TR>
__device__ TM lane_residual(const LaneCtx<TF, TM>& L,
                            const TR* __restrict__ rl, const TM* xv, TM* res,
                            TM* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  TM part = TM(0);
  for (int row0 = warp * kRowsPerWarp; row0 < L.k;
       row0 += kWarpsLane * kRowsPerWarp) {
    for (int c = 0; c < L.R; ++c) {
      TM acc[kRowsPerWarp];
      warp_rows<TM, TM, kVec>(L.mop, L.k, row0, xv + c * L.kp, acc);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int row = row0 + i;
        if (lane == i && row < L.k) {
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
  part = warp_sum(part);
  if (lane == 0) s_red[warp] = part;
  __syncthreads();
  // every thread sums the warps' parts in the same order, so the monotone
  // decision is uniform; s_red is rewritten only after the next barrier
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
                        unsigned char* scratch, int k, int R, int steps) {
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
                          shift + b * k, k, R, kp};
  const TR* rl = r + b * k * R;
  TO* xl = x + b * k * R;

  for (int p = threadIdx.x; p < k * R; p += kThreadsLane) {
    const int j = p / R, c = p - j * R;
    U[c * kp + j] = static_cast<TF>(static_cast<TM>(rl[p]) * L.dv[j]);
  }
  __syncthreads();
  lane_product<kVec>(L, U, static_cast<const TM*>(nullptr), X);
  TM nrm = lane_residual<kVec>(L, rl, X, RES, s_red);
  for (int s = 0; s < steps; ++s) {
    for (int p = threadIdx.x; p < n; p += kThreadsLane) {
      const int j = p % kp;
      if (j < k) U[p] = static_cast<TF>(RES[p] * L.dv[j]);
    }
    __syncthreads();
    lane_product<kVec>(L, U, X, X2);
    const TM nrm2 = lane_residual<kVec>(L, rl, X2, RES2, s_red);
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

// ------------------------------------------------------------- launches
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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
                          int steps, size_t smem, cudaStream_t stream) {
  auto kernel = spd_solve_refine_kernel<TF, TM, TR, TO, kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreadsLane, smem, stream>>>(minv, mop, dinv, shift, r, x,
                                            scratch, k, R, steps);
  return cudaGetLastError();
}

// Whether the refinement vectors of a lane fit shared memory.
cudaError_t refine_in_smem(int k, int R, size_t sf, size_t sm, bool* fits) {
  int optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  // the static s_red (at most 16 doubles) sits beside the dynamic part
  *fits = lane_bytes(k, R, sf, sm) + kWarpsLane * sizeof(double) <=
          static_cast<size_t>(optin);
  return cudaSuccess;
}

template <typename TF, typename TM, typename TR, typename TO>
int launch(const void* minv_, const void* mop_, const void* dinv_,
           const void* shift_, const void* r_, void* x_, void* scratch_,
           int B, int k, int R, int steps, void* stream_) {
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

  bool fits = false;
  err = refine_in_smem(k, R, sizeof(TF), sizeof(TM), &fits);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!fits && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fits ? lane_bytes(k, R, sizeof(TF), sizeof(TM)) : 0;
  if (fits) scratch = nullptr;
  const bool vec = k % Pack<TF, true>::W == 0 &&
                   k % Pack<TM, true>::W == 0 && aligned16(minv) &&
                   aligned16(mop);
  err = vec ? launch_refine<TF, TM, TR, TO, true>(minv, mop, dinv, shift, r,
                                                 x, scratch, B, k, R, steps,
                                                 smem, stream)
            : launch_refine<TF, TM, TR, TO, false>(minv, mop, dinv, shift, r,
                                                  x, scratch, B, k, R, steps,
                                                  smem, stream);
  return static_cast<int>(err);
}

}  // namespace

// Bytes of global scratch a call needs for B = 1 (times B for a batch): 0
// at refine 0 or when a lane's refinement vectors fit shared memory on the
// current device (scratch is then not read and may be null), else the
// bytes of one lane's vectors; a negative cudaError_t if the device query
// failed.  sf, sm: the factor and operator element sizes.
extern "C" long long mt_spd_solve_scratch_bytes(int k, int R, int sf, int sm,
                                                int steps) {
  if (steps <= 0 || k <= 0 || R <= 0) return 0;
  bool fits = false;
  const cudaError_t err = refine_in_smem(k, R, sf, sm, &fits);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return fits ? 0 : static_cast<long long>(lane_bytes(k, R, sf, sm));
}

// minv: (B, k, k) TF; m_op: (B, k, k) TM; dinv, shift: (B, k) TM;
// r: (B, k, R) TR; x: (B, k, R) TO, all contiguous; scratch as above.
// Named mt_spd_solve_<TF>_<TM>_<TR>_<TO>.  Returns a cudaError_t.
#define MT_SPD_SOLVE(NAME, TF, TM, TR, TO)                                    \
  extern "C" int NAME(const void* minv, const void* mop, const void* dinv,    \
                      const void* shift, const void* r, void* x,              \
                      void* scratch, int B, int k, int R, int steps,          \
                      void* stream) {                                         \
    return launch<TF, TM, TR, TO>(minv, mop, dinv, shift, r, x, scratch, B,   \
                                  k, R, steps, stream);                       \
  }

MT_SPD_SOLVE(mt_spd_solve_f32_f32_f32_f32, float, float, float, float)
MT_SPD_SOLVE(mt_spd_solve_f32_f32_f32_f64, float, float, float, double)
MT_SPD_SOLVE(mt_spd_solve_f32_f32_f64_f32, float, float, double, float)
MT_SPD_SOLVE(mt_spd_solve_f32_f32_f64_f64, float, float, double, double)
MT_SPD_SOLVE(mt_spd_solve_f32_f64_f64_f64, float, double, double, double)
MT_SPD_SOLVE(mt_spd_solve_f64_f64_f64_f64, double, double, double, double)
