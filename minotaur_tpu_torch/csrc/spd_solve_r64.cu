// K2 (spd_solve.cuh): the f32 factor/operator instantiations with f64 r,
// the IPM's mixed policy and its light phase.

#include "spd_solve.cuh"

MT_SPD_SOLVE(mt_spd_solve_f32_f32_f64_f32, float, float, double, float)
MT_SPD_SOLVE(mt_spd_solve_f32_f32_f64_f64, float, float, double, double)
