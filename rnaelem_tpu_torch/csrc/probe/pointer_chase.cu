// A dependent-load latency probe (not part of the kernel library): one
// thread follows i = next[i] for a number of steps, every load waiting
// for the one before, as K13's walk waits for each cell's table values.
// chip_smoke.py --tb-times builds it alone with the library's nvcc flags
// and times it with CUDA events over a buffer that L2 holds and over one
// far larger than L2; time / steps is the latency of one dependent load,
// and the walk's longest read times that is K13's dependent-path bound.
#include <cuda_runtime.h>

__global__ void pointer_chase_kernel(const long long* next, long long steps,
                                     long long* out) {
  long long i = 0;
  for (long long k = 0; k < steps; ++k) i = __ldcg(next + i);
  out[0] = i;  // keeps the chain
}

extern "C" __attribute__((visibility("default"))) int pointer_chase(
    const long long* next, long long steps, long long* out,
    cudaStream_t st) {
  pointer_chase_kernel<<<1, 1, 0, st>>>(next, steps, out);
  return static_cast<int>(cudaGetLastError());
}
