// Batched scaled-inverse solve with monotone refinement, one CTA per lane
// (Hopper, sm_90a).
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
// the scaled right-hand side is rounded to TF before the product, and the
// product is taken back to TM before the second scaling.
//
// What bounds it on the card: each product reads a k x k matrix once per
// right-hand side (2 flops per 4 or 8 bytes), so the kernel is bound by
// L2/HBM bandwidth and by its block barriers, not by flops.  A warp owns
// one output row at a time and its lanes read that row contiguously; the
// scaled right-hand side sits in a global scratch buffer (L2-resident).
// One CTA per lane fills 64 of the 132 SMs at the bench's B=64.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename TF, typename TM>
struct Lane {
  const TF* minv;   // (k, k)
  const TM* mop;    // (k, k)
  const TM* dinv;   // (k,)
  const TM* shift;  // (k,)
  const TM* r;      // (k, R)
  TF* u;            // (k, R) scratch
  int k, R;
};

// dst = base_solve(src) (+ add, when add is not null)
template <typename TF, typename TM>
__device__ void base_solve(const Lane<TF, TM>& L, const TM* src,
                           const TM* add, TM* dst) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = L.k * L.R;
  for (int p = tid; p < n; p += kThreads)
    L.u[p] = static_cast<TF>(src[p] * L.dinv[p / L.R]);
  __syncthreads();
  for (int p = warp; p < n; p += kWarps) {
    const int i = p / L.R, c = p - i * L.R;
    const TF* row = L.minv + static_cast<long long>(i) * L.k;
    TF acc = TF(0);
    for (int j = lane; j < L.k; j += 32)
      acc += row[j] * L.u[static_cast<long long>(j) * L.R + c];
    acc = warp_sum(acc);
    if (lane == 0) {
      const TM v = static_cast<TM>(acc) * L.dinv[i];
      dst[p] = add ? add[p] + v : v;
    }
  }
  __syncthreads();
}

// res = r - (M @ xv + shift * xv); returns sum(res^2) to every thread
template <typename TF, typename TM>
__device__ TM residual(const Lane<TF, TM>& L, const TM* xv, TM* res,
                       TM* s_red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = L.k * L.R;
  TM part = TM(0);
  for (int p = warp; p < n; p += kWarps) {
    const int i = p / L.R, c = p - i * L.R;
    const TM* row = L.mop + static_cast<long long>(i) * L.k;
    TM acc = TM(0);
    for (int j = lane; j < L.k; j += 32)
      acc += row[j] * xv[static_cast<long long>(j) * L.R + c];
    acc = warp_sum(acc);
    if (lane == 0) {
      const TM rv = L.r[p] - (acc + L.shift[i] * xv[p]);
      res[p] = rv;
      part += rv * rv;
    }
  }
  if (lane == 0) s_red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    TM s = TM(0);
    for (int w = 0; w < kWarps; ++w) s += s_red[w];
    s_red[kWarps] = s;
  }
  __syncthreads();
  const TM total = s_red[kWarps];
  __syncthreads();   // s_red is rewritten by the next call
  return total;
}

template <typename TF, typename TM>
__global__ void __launch_bounds__(kThreads)
spd_solve_kernel(const TF* __restrict__ minv, const TM* __restrict__ mop,
                 const TM* __restrict__ dinv, const TM* __restrict__ shift,
                 const TM* __restrict__ r, TM* __restrict__ x,
                 TM* __restrict__ res, TM* __restrict__ x2,
                 TM* __restrict__ res2, TF* __restrict__ u, int k, int R,
                 int steps) {
  __shared__ TM s_red[kWarps + 1];
  const long long b = blockIdx.x;
  const long long kk = static_cast<long long>(k) * k;
  const long long kr = static_cast<long long>(k) * R;
  Lane<TF, TM> L{minv + b * kk, mop + b * kk, dinv + b * k, shift + b * k,
                 r + b * kr, u + b * kr, k, R};
  TM* X = x + b * kr;
  TM* RES = res + b * kr;
  TM* X2 = x2 + b * kr;
  TM* RES2 = res2 + b * kr;
  const int n = k * R;

  base_solve(L, L.r, static_cast<const TM*>(nullptr), X);
  if (steps <= 0) return;
  TM nrm = residual(L, X, RES, s_red);
  for (int s = 0; s < steps; ++s) {
    base_solve(L, RES, X, X2);
    const TM nrm2 = residual(L, X2, RES2, s_red);
    if (nrm2 < nrm) {              // uniform across the block
      for (int p = threadIdx.x; p < n; p += kThreads) {
        X[p] = X2[p];
        RES[p] = RES2[p];
      }
      nrm = nrm2;
      __syncthreads();
    }
  }
}

template <typename TF, typename TM>
int launch(const void* minv, const void* mop, const void* dinv,
           const void* shift, const void* r, void* x, void* res, void* x2,
           void* res2, void* u, int B, int k, int R, int steps,
           void* stream) {
  if (B <= 0 || k <= 0 || R <= 0) return 0;
  spd_solve_kernel<TF, TM><<<B, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TF*>(minv), static_cast<const TM*>(mop),
      static_cast<const TM*>(dinv), static_cast<const TM*>(shift),
      static_cast<const TM*>(r), static_cast<TM*>(x), static_cast<TM*>(res),
      static_cast<TM*>(x2), static_cast<TM*>(res2), static_cast<TF*>(u), k,
      R, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MT_SPD_SOLVE(NAME, TF, TM)                                          \
  extern "C" int NAME(const void* minv, const void* mop, const void* dinv,  \
                      const void* shift, const void* r, void* x, void* res, \
                      void* x2, void* res2, void* u, int B, int k, int R,   \
                      int steps, void* stream) {                            \
    return launch<TF, TM>(minv, mop, dinv, shift, r, x, res, x2, res2, u,   \
                          B, k, R, steps, stream);                          \
  }

MT_SPD_SOLVE(mt_spd_solve_f32_f32, float, float)
MT_SPD_SOLVE(mt_spd_solve_f32_f64, float, double)
MT_SPD_SOLVE(mt_spd_solve_f64_f64, double, double)
