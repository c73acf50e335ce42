// P1: the mesh probe's copy kernel.
//
// Replaces optical_flow_tpu/parallel/vma_compat.py::vma_accepts_pallas
// (the copy kernel under shard_map, pallas_call at :44). The JAX probe asks
// whether JAX's shard_map checker accepts a kernel's output; the port has
// no such checker, so its probe asks what can break on the port's mesh:
// a hand-written kernel launched on each tile's device, on that device's
// current stream, between split, the halo exchange and merge
// (parallel/vma_compat.py).
//
// Bound on the H100: memory, 8 B per element; the probe copies a few KB
// per tile once per mesh, so only correctness matters. Design: a
// grid-stride loop, one element per thread per step.
#include <cuda_runtime.h>

namespace oft {

__global__ void tile_copy_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                 long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    dst[i] = src[i];
}

}  // namespace oft

extern "C" int oft_tile_copy(const float* src, float* dst, long long n, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  oft::tile_copy_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(src, dst, n);
  return (int)cudaGetLastError();
}
