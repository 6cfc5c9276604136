// K1 (spd_inverse.cuh): the f64 instantiation, the arguments as
// mt_spd_inverse_f32's (spd_inverse.cu).

#include "spd_inverse.cuh"

extern "C" int mt_spd_inverse_f64(const void* ms, void* out, void* xbuf,
                                  void* wbuf, void* fail, void* flag, int B,
                                  int k, int cluster, void* stream) {
  return launch<double>(ms, out, xbuf, wbuf, fail, flag, B, k, cluster,
                        stream);
}
