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
// Bound on the H100: memory, 8 B per element; the probe copies a 4 KB tile
// once per tile of a mesh, so the time is the launch's. Design, to cost no
// more than PyTorch's own copy (`clone`): where both pointers are 16-byte
// aligned and n < 2^31, one pass of 128-thread blocks sized to the work,
// 32-bit indices, two float4s per thread (one block for the probe's 1024
// floats; the first n % 4 threads also copy the scalar tail). Anything else
// (an unaligned pointer, which no caller of the port hands it, or 2^31
// elements and more) takes a scalar grid-stride loop with 64-bit indices.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace oft {

constexpr int CNT = 128;  // threads per block
constexpr int PER = 2;    // float4s per thread

__global__ void __launch_bounds__(CNT)
    tile_copy_f4(const float* __restrict__ src, float* __restrict__ dst, int n) {
  const int n4 = n >> 2;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = (blockIdx.x * PER + k) * CNT + threadIdx.x;
    if (i < n4) reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  }
  const int i = blockIdx.x * CNT + threadIdx.x;
  if (i < (n & 3)) dst[4 * n4 + i] = src[4 * n4 + i];
}

__global__ void tile_copy_wide(const float* __restrict__ src, float* __restrict__ dst,
                               long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    dst[i] = src[i];
}

}  // namespace oft

extern "C" int oft_tile_copy(const float* src, float* dst, long long n, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n < 1) return 0;
  if (n < (1LL << 31) && ((uintptr_t)src | (uintptr_t)dst) % 16 == 0) {
    const int work = (int)std::max(n >> 2, n & 3);  // float4s, or the tail alone
    const int per_block = oft::CNT * oft::PER;
    oft::tile_copy_f4<<<(work + per_block - 1) / per_block, oft::CNT, 0, s>>>(src, dst, (int)n);
  } else {
    const long long blocks = std::min(1024LL, (n + 255) / 256);
    oft::tile_copy_wide<<<(unsigned)blocks, 256, 0, s>>>(src, dst, n);
  }
  return (int)cudaGetLastError();
}
