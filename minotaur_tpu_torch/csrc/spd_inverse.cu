// Batched SPD factorize + explicit inverse, one CTA per lane (Hopper, sm_90a).
//
// Replaces the TPU kernel minotaur_tpu/ops/pallas_kkt.py:_build_factor_inv
// (reached through batched_spd_inverse / _spd_inverse_vmappable): for every
// lane b of a (B, k, k) batch of Jacobi-scaled SPD matrices it computes
//   1. the Cholesky factor L (right-looking, column by column),
//   2. Linv = L^{-1} (forward substitution, one row at a time),
//   3. Minv = Linv' Linv (32x32 shared-memory tiles),
// and returns the identity with flag 2 when a pivot is non-positive or
// non-finite, or when any entry of Minv is non-finite (flag 0 otherwise).
// Unlike Mosaic, CUDA lets the failure test live inside the kernel.
//
// What bounds it on the card: at the bench shape (B=64, k=300, f32) each
// lane does ~k^3/2 = 13.5 MFLOP, far below the card's rate, and a lane's
// matrix (360 KB) is larger than a block's 227 KB of shared memory.  Every
// column and row step ends in a block barrier, so the kernel is bound by
// those k-long chains of dependent steps and by L2 latency, not by flops
// or HBM bandwidth.  The simple design keeps the three working matrices
// (L, Linv, Minv) in global memory, where the 64 lanes (23 MB each) stay
// L2-resident, and keeps only the current column or row in shared memory.
// One CTA per lane fills 64 of the 132 SMs at B=64.  Blocked panels in
// shared memory, wgmma and several CTAs per lane are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps; the tile loop assumes 32 x 8
constexpr int kTile = 32;

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
spd_inverse_kernel(const T* __restrict__ ms, T* __restrict__ out,
                   T* __restrict__ lbuf, T* __restrict__ xbuf,
                   T* __restrict__ flag, int k) {
  extern __shared__ unsigned char smem_raw[];
  T* vec = reinterpret_cast<T*>(smem_raw);          // k entries
  __shared__ T tA[kTile][kTile + 1];
  __shared__ T tB[kTile][kTile + 1];
  __shared__ T s_piv;
  __shared__ int s_fail;
  __shared__ int s_bad;

  const long long kk = static_cast<long long>(k) * k;
  const long long off = static_cast<long long>(blockIdx.x) * kk;
  const T* A = ms + off;
  T* L = lbuf + off;
  T* X = xbuf + off;
  T* O = out + off;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;

  for (int i = warp; i < k; i += nwarps) {
    const long long row = static_cast<long long>(i) * k;
    for (int c = lane; c < k; c += 32) {
      L[row + c] = A[row + c];
      X[row + c] = T(0);
    }
  }
  if (tid == 0) {
    s_fail = 0;
    s_bad = 0;
  }
  __syncthreads();

  // ---- 1. Cholesky, lower triangle, column j at a time ------------------
  for (int j = 0; j < k; ++j) {
    if (tid == 0) {
      const T piv = L[static_cast<long long>(j) * k + j];
      if (!(piv > T(0)) || !isfinite(piv)) {
        s_fail = 1;
      } else {
        s_piv = dev_sqrt(piv);
      }
    }
    __syncthreads();
    if (s_fail) break;
    const T ljj = s_piv;
    for (int i = j + tid; i < k; i += kThreads) {
      const long long at = static_cast<long long>(i) * k + j;
      const T v = (i == j) ? ljj : L[at] / ljj;
      vec[i] = v;
      L[at] = v;
    }
    __syncthreads();
    // trailing update of rows/cols j+1..k-1 (lower triangle only)
    for (int i = j + 1 + warp; i < k; i += nwarps) {
      const long long row = static_cast<long long>(i) * k;
      const T li = vec[i];
      for (int c = j + 1 + lane; c <= i; c += 32) L[row + c] -= li * vec[c];
    }
    __syncthreads();
  }

  // ---- 2. Linv by forward substitution, row i at a time -----------------
  if (!s_fail) {
    for (int i = 0; i < k; ++i) {
      const long long row = static_cast<long long>(i) * k;
      for (int j = tid; j <= i; j += kThreads) vec[j] = L[row + j];
      __syncthreads();
      const T lii = vec[i];
      for (int c = tid; c <= i; c += kThreads) {
        // X[j][c] == 0 for j < c, so starting at the warp's aligned base
        // keeps every lane of a warp on the same j (coalesced reads)
        const int j0 = c & ~31;
        T acc = T(0);
        for (int j = j0; j < i; ++j)
          acc += vec[j] * X[static_cast<long long>(j) * k + c];
        X[row + c] = ((c == i ? T(1) : T(0)) - acc) / lii;
      }
      __syncthreads();
    }
  }

  // ---- 3. Minv = Linv' Linv --------------------------------------------
  if (!s_fail) {
    const int ntiles = (k + kTile - 1) / kTile;
    const int tx = tid % kTile;
    const int ty = tid / kTile;                      // 0..7
    for (int tile = 0; tile < ntiles * ntiles; ++tile) {
      const int a0 = (tile / ntiles) * kTile;
      const int b0 = (tile % ntiles) * kTile;
      T acc[4] = {T(0), T(0), T(0), T(0)};
      // Linv is lower triangular: rows above max(a0, b0) contribute 0
      for (int i0 = (a0 > b0 ? a0 : b0); i0 < k; i0 += kTile) {
        for (int rr = ty; rr < kTile; rr += kThreads / kTile) {
          const int i = i0 + rr;
          const long long row = static_cast<long long>(i) * k;
          tA[rr][tx] = (i < k && a0 + tx < k) ? X[row + a0 + tx] : T(0);
          tB[rr][tx] = (i < k && b0 + tx < k) ? X[row + b0 + tx] : T(0);
        }
        __syncthreads();
#pragma unroll 8
        for (int rr = 0; rr < kTile; ++rr) {
          const T bv = tB[rr][tx];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += tA[rr][ty + 8 * q] * bv;
        }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int a = a0 + ty + 8 * q;
        const int bc = b0 + tx;
        if (a < k && bc < k) O[static_cast<long long>(a) * k + bc] = acc[q];
      }
    }
  }
  __syncthreads();

  // ---- 4. failure test: any non-finite entry fails the lane -------------
  if (!s_fail) {
    int bad = 0;
    for (int i = warp; i < k; i += nwarps) {
      const long long row = static_cast<long long>(i) * k;
      for (int c = lane; c < k; c += 32) bad |= !isfinite(O[row + c]);
    }
    if (bad) atomicOr(&s_bad, 1);
  }
  __syncthreads();
  const int failed = s_fail | s_bad;
  if (failed) {
    for (int i = warp; i < k; i += nwarps) {
      const long long row = static_cast<long long>(i) * k;
      for (int c = lane; c < k; c += 32) O[row + c] = (i == c) ? T(1) : T(0);
    }
  }
  if (tid == 0) flag[blockIdx.x] = failed ? T(2) : T(0);
}

template <typename T>
int launch(const void* ms, void* out, void* lbuf, void* xbuf, void* flag,
           int B, int k, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  const size_t smem = static_cast<size_t>(k) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      spd_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  spd_inverse_kernel<T><<<B, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ms), static_cast<T*>(out),
      static_cast<T*>(lbuf), static_cast<T*>(xbuf), static_cast<T*>(flag), k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mt_spd_inverse_f32(const void* ms, void* out, void* lbuf,
                                  void* xbuf, void* flag, int B, int k,
                                  void* stream) {
  return launch<float>(ms, out, lbuf, xbuf, flag, B, k, stream);
}

extern "C" int mt_spd_inverse_f64(const void* ms, void* out, void* lbuf,
                                  void* xbuf, void* flag, int B, int k,
                                  void* stream) {
  return launch<double>(ms, out, lbuf, xbuf, flag, B, k, stream);
}
