// RX(theta) on one qubit of a state vector: the default launch variant,
// 256 threads a block.  The kernel, its design and its numerics are in
// rx_gate.cuh; rx_gate_variants.cu holds the tuner's other variants.
//
// C interface (loaded with ctypes):
//   int rx_gate_launch(const void *re, const void *im, void *ore,
//                      void *oim, long long n_amp, int qubit, float c,
//                      float s, int dtype, cudaStream_t stream);
//       dtype: 0 fp32, 1 bf16
//   const char *rx_gate_error_string(int code);

#include "rx_gate.cuh"

extern "C" int rx_gate_launch(const void *re, const void *im, void *ore,
                              void *oim, long long n_amp, int qubit, float c,
                              float s, int dtype, cudaStream_t stream) {
  return launch_variant<256>(re, im, ore, oim, n_amp, qubit, c, s, dtype,
                             stream);
}
