// K2: the entry points of spd_solve.cuh (the note at its top) that are not
// per dtype, and the f32 factor/operator instantiations with f32 r.  The
// other instantiations sit in spd_solve_r64.cu and spd_solve_m64.cu, so
// nvcc compiles the three in parallel.

#include "spd_solve.cuh"

// Bytes of global scratch a call needs for B = 1 (times B for a batch): 0
// at refine 0, under the cluster design, or when a lane's refinement
// vectors fit shared memory on the current device (scratch is then not read
// and may be null), else the bytes of one lane's vectors; a negative
// cudaError_t if the device query failed.  sf, sm: the factor and operator
// element sizes.
extern "C" long long mt_spd_solve_scratch_bytes(int k, int R, int sf, int sm,
                                                int steps) {
  if (steps <= 0 || k <= 0 || R <= 0) return 0;
  bool fits = false;
  const cudaError_t err = refine_in_smem(k, R, sf, sm, &fits);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return fits ? 0 : static_cast<long long>(lane_bytes(k, R, sf, sm));
}

// The design the launcher picks for a call: 0 at refine 0 (the row-block
// grid), 1 for one CTA a lane, else the cluster size; a negative
// cudaError_t if the device query failed.
extern "C" int mt_spd_solve_design(int B, int k, int R, int sf, int sm,
                                   int steps) {
  if (steps <= 0) return 0;
  int C = 1;
  const cudaError_t err = refine_design(B, k, R, sf, sm, &C);
  return err != cudaSuccess ? -static_cast<int>(err) : C;
}

MT_SPD_SOLVE(mt_spd_solve_f32_f32_f32_f32, float, float, float, float)
MT_SPD_SOLVE(mt_spd_solve_f32_f32_f32_f64, float, float, float, double)
