// K1: the entry points of spd_inverse.cuh (the note at its top) that are
// not per dtype, and the f32 instantiation.  The f64 one sits in
// spd_inverse_f64.cu, so nvcc compiles the two in parallel.

#include "spd_inverse.cuh"

// Elements per lane of the global panel buffer wbuf for a lane of order k
// with elements of `itemsize` bytes on the current device under the design
// `cluster` (0: the one the launcher picks for B lanes, 1: one CTA a lane,
// else that cluster size): 0 when the panel fits shared memory (wbuf is
// then not read and may be null), else a negative cudaError_t if the device
// query failed.
extern "C" long long mt_spd_inverse_wbuf_elems(int B, int k, int itemsize,
                                               int cluster) {
  if (k <= 0) return 0;
  int C = cluster;
  cudaError_t err = cudaSuccess;
  if (C <= 0) err = factor_design(B, k, &C);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  bool fits = false;
  err = panel_in_smem(k, static_cast<size_t>(itemsize),
                      C == 1 ? kSmemFixed : kSmemFixedCl, &fits);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return fits ? 0 : static_cast<long long>(kNb) * panel_stride(k);
}

// The design the launcher picks for B lanes of order k: 1 (one CTA a lane)
// or the cluster size; a negative cudaError_t if the device query failed.
extern "C" int mt_spd_inverse_design(int B, int k) {
  int C = 1;
  const cudaError_t err = factor_design(B, k, &C);
  return err != cudaSuccess ? -static_cast<int>(err) : C;
}

// ms, out, xbuf: (B, k, k); wbuf: B times mt_spd_inverse_wbuf_elems(B, k,
// sizeof(T), cluster) elements; fail: (B,) int32; flag: (B,); cluster: 0
// for the launcher's design, 1 for one CTA a lane, 2 or 4 for that
// cluster size.  Returns the first non-zero cudaError_t of the three launches (a
// cluster that cannot be placed is an error, never another design), else 0.
extern "C" int mt_spd_inverse_f32(const void* ms, void* out, void* xbuf,
                                  void* wbuf, void* fail, void* flag, int B,
                                  int k, int cluster, void* stream) {
  return launch<float>(ms, out, xbuf, wbuf, fail, flag, B, k, cluster,
                       stream);
}
