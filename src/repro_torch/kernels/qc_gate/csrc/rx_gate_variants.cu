// RX(theta) on one qubit of a state vector: the tuner's launch variants
// other than the default (rx_gate.cu), each an instantiation of
// rx_gate.cuh's kernel: 128, 512 and 1024 threads a block.
//
// C interface (loaded with ctypes):
//   int rx_gate_variant_launch(const void *re, const void *im, void *ore,
//                              void *oim, long long n_amp, int qubit,
//                              float c, float s, int dtype, int threads,
//                              cudaStream_t stream);
//   as rx_gate_launch, for the variant of `threads` threads a block; any
//   other count returns cudaErrorInvalidValue.
//   const char *rx_gate_error_string(int code);

#include "rx_gate.cuh"

extern "C" int rx_gate_variant_launch(const void *re, const void *im,
                                      void *ore, void *oim, long long n_amp,
                                      int qubit, float c, float s, int dtype,
                                      int threads, cudaStream_t stream) {
  switch (threads) {
    case 128:
      return launch_variant<128>(re, im, ore, oim, n_amp, qubit, c, s, dtype,
                                 stream);
    case 512:
      return launch_variant<512>(re, im, ore, oim, n_amp, qubit, c, s, dtype,
                                 stream);
    case 1024:
      return launch_variant<1024>(re, im, ore, oim, n_amp, qubit, c, s,
                                  dtype, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
