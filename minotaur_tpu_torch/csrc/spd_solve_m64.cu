// K2 (spd_solve.cuh): the instantiations with an f64 operator.

#include "spd_solve.cuh"

MT_SPD_SOLVE(mt_spd_solve_f32_f64_f64_f64, float, double, double, double)
MT_SPD_SOLVE(mt_spd_solve_f64_f64_f64_f64, double, double, double, double)
