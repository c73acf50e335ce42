// S2-S4: the probes that measure what the flow kernels are made of on the
// H100. No flow path calls them; chip_smoke.py runs them beside their plain
// versions (kernels/probes.py) and reports their rates.
//
// S2, the 2x interleave store that pyrUp's output is made of. Replaces
// scripts/tpu_interleave_poc.py (pallas_calls at :76, :99, :188; kernels
// :18-57, :92, :175-185). Rows: (2H, W) with a in the even rows and b in
// the odd. Columns: (H, 2W) with a in the even columns and b in the odd,
// in two Hopper forms: each thread stores its (a, b) pair as one float2
// from registers, or a block stages a row segment of a and b in shared
// memory and stores the interleaved segment one float per thread. Bound:
// memory, 8 B read and 8 B written per pair, no arithmetic.
//
// S3, the stencil-tap read of K3/K4. Replaces scripts/tpu_roll_micro.py
// (pallas_call in run() at :40; kernels :22 and :31), the slice variant's
// output: out[r, o] = sum over t = -5..6 of float32(0.1 t) * x[r, o+6+t]
// for o < WIN, summed from 0 in the order of t, and out[r, o] = 0 for
// o >= WIN. Two Hopper forms of the tap reads: from a row staged in
// shared memory, or from registers through warp shuffles. Bound: memory,
// 4 B read and 4 B written per element for 24 flops.
//
// S4, the elementwise rate. Replaces scripts/tpu_vpu_rate_probe.py
// (measure() at :49, make_kernel :35): acc = a, then `steps` times
// acc = acc * b + a, in float32 or in bfloat16. Built with -fmad=false,
// each step is a multiply and an add, each rounded (bf16: computed in
// float32 and rounded to bf16 after each operation, as eager PyTorch
// does), so the kernel equals its plain version bit for bit and measures
// the rate of the separate multiplies and adds that the port's kernels
// issue, not the fused multiply-add that the published 67 TFLOP/s counts
// as two operations. Bound at 64 steps: 128 flops per element against
// 12 B (f32) or 6 B (bf16) of traffic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace oft {

constexpr int PT = 256;  // threads per block of the probes

// ------------------------------------------------------------------- S2

__global__ void interleave_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                       float* __restrict__ out, int H, int W) {
  const long long n = (long long)H * W;
  for (long long i = (long long)blockIdx.x * PT + threadIdx.x; i < n;
       i += (long long)gridDim.x * PT) {
    const long long r = i / W, c = i % W;
    out[(2 * r) * W + c] = a[i];
    out[(2 * r + 1) * W + c] = b[i];
  }
}

__global__ void interleave_cols_f2_kernel(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          float2* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * PT + threadIdx.x; i < n;
       i += (long long)gridDim.x * PT)
    out[i] = make_float2(a[i], b[i]);
}

// One block per (row, segment of PT input columns).
__global__ void interleave_cols_smem_kernel(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            float* __restrict__ out, int W) {
  __shared__ float sa[PT];
  __shared__ float sb[PT];
  const int r = blockIdx.y, c0 = blockIdx.x * PT, t = threadIdx.x;
  const size_t row = (size_t)r * W;
  if (c0 + t < W) {
    sa[t] = a[row + c0 + t];
    sb[t] = b[row + c0 + t];
  }
  __syncthreads();
  float* o = out + 2 * row + 2 * (size_t)c0;
  const int n = 2 * min(PT, W - c0);
  for (int k = t; k < n; k += PT) o[k] = (k & 1) ? sb[k >> 1] : sa[k >> 1];
}

// ------------------------------------------------------------------- S3

constexpr int S3_TAPS = 12;  // t = -5..6 -> offsets 1..12

__device__ __forceinline__ float s3_weight(int k) {  // float32(0.1 * t), t = k - 6
  return (float)(0.1 * (double)(k - 6));
}

// One block per row; the row is staged in shared memory (W floats).
__global__ void colsum_smem_kernel(const float* __restrict__ x, float* __restrict__ out, int W,
                                   int win) {
  extern __shared__ float srow[];
  const size_t row = (size_t)blockIdx.x * W;
  for (int c = threadIdx.x; c < W; c += PT) srow[c] = x[row + c];
  __syncthreads();
  for (int o = threadIdx.x; o < W; o += PT) {
    float acc = 0.0f;
    if (o < win) {
#pragma unroll
      for (int k = 1; k <= S3_TAPS; ++k) acc = acc + s3_weight(k) * srow[o + k];
    }
    out[row + o] = acc;
  }
}

// One warp per 32 consecutive outputs of a row: each lane holds x[o] and
// x[o + 32], and tap k of lane l is lane (l + k) mod 32 of one of the two.
__global__ void colsum_shfl_kernel(const float* __restrict__ x, float* __restrict__ out, int rows,
                                   int W, int win) {
  const int lane = threadIdx.x & 31;
  const int chunks = (W + 31) / 32;
  const long long wid = ((long long)blockIdx.x * PT + threadIdx.x) >> 5;
  if (wid >= (long long)rows * chunks) return;  // whole warps leave together
  const size_t row = (size_t)(wid / chunks) * W;
  const int o = (int)(wid % chunks) * 32 + lane;
  const float v0 = o < W ? x[row + o] : 0.0f;
  const float v1 = o + 32 < W ? x[row + o + 32] : 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int k = 1; k <= S3_TAPS; ++k) {
    const int src = (lane + k) & 31;
    const float lo = __shfl_sync(0xffffffffu, v0, src);
    const float hi = __shfl_sync(0xffffffffu, v1, src);
    acc = acc + s3_weight(k) * (lane + k < 32 ? lo : hi);
  }
  if (o < W) out[row + o] = o < win ? acc : 0.0f;
}

// ------------------------------------------------------------------- S4

__global__ void mul_add_chain_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                         float* __restrict__ out, long long n, int steps) {
  for (long long i = (long long)blockIdx.x * PT + threadIdx.x; i < n;
       i += (long long)gridDim.x * PT) {
    const float av = a[i], bv = b[i];
    float acc = av;
    for (int s = 0; s < steps; ++s) acc = acc * bv + av;  // -fmad=false: mul, then add
    out[i] = acc;
  }
}

__global__ void mul_add_chain_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                                          const __nv_bfloat16* __restrict__ b,
                                          __nv_bfloat16* __restrict__ out, long long n,
                                          int steps) {
  for (long long i = (long long)blockIdx.x * PT + threadIdx.x; i < n;
       i += (long long)gridDim.x * PT) {
    const float av = __bfloat162float(a[i]), bv = __bfloat162float(b[i]);
    float acc = av;
    for (int s = 0; s < steps; ++s) {
      acc = __bfloat162float(__float2bfloat16_rn(acc * bv));
      acc = __bfloat162float(__float2bfloat16_rn(acc + av));
    }
    out[i] = __float2bfloat16_rn(acc);
  }
}

inline unsigned grid_for(long long n) {
  long long blocks = (n + PT - 1) / PT;
  if (blocks > 132 * 32) blocks = 132 * 32;  // a grid-stride loop beyond 32 blocks per SM
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace oft

extern "C" {

int oft_interleave_rows(const float* a, const float* b, float* out, int H, int W, void* stream) {
  oft::interleave_rows_kernel<<<oft::grid_for((long long)H * W), oft::PT, 0,
                                (cudaStream_t)stream>>>(a, b, out, H, W);
  return (int)cudaGetLastError();
}

int oft_interleave_cols_f2(const float* a, const float* b, float* out, int H, int W,
                           void* stream) {
  const long long n = (long long)H * W;
  oft::interleave_cols_f2_kernel<<<oft::grid_for(n), oft::PT, 0, (cudaStream_t)stream>>>(
      a, b, reinterpret_cast<float2*>(out), n);
  return (int)cudaGetLastError();
}

int oft_interleave_cols_smem(const float* a, const float* b, float* out, int H, int W,
                             void* stream) {
  const dim3 grid((W + oft::PT - 1) / oft::PT, H);
  oft::interleave_cols_smem_kernel<<<grid, oft::PT, 0, (cudaStream_t)stream>>>(a, b, out, W);
  return (int)cudaGetLastError();
}

int oft_colsum_smem(const float* x, float* out, int rows, int W, int win, void* stream) {
  oft::colsum_smem_kernel<<<rows, oft::PT, W * sizeof(float), (cudaStream_t)stream>>>(x, out, W,
                                                                                     win);
  return (int)cudaGetLastError();
}

int oft_colsum_shfl(const float* x, float* out, int rows, int W, int win, void* stream) {
  const long long threads = (long long)rows * ((W + 31) / 32) * 32;
  const unsigned blocks = (unsigned)((threads + oft::PT - 1) / oft::PT);
  oft::colsum_shfl_kernel<<<blocks, oft::PT, 0, (cudaStream_t)stream>>>(x, out, rows, W, win);
  return (int)cudaGetLastError();
}

int oft_mul_add_chain_f32(const float* a, const float* b, float* out, long long n, int steps,
                          void* stream) {
  oft::mul_add_chain_f32_kernel<<<oft::grid_for(n), oft::PT, 0, (cudaStream_t)stream>>>(
      a, b, out, n, steps);
  return (int)cudaGetLastError();
}

int oft_mul_add_chain_bf16(const void* a, const void* b, void* out, long long n, int steps,
                           void* stream) {
  oft::mul_add_chain_bf16_kernel<<<oft::grid_for(n), oft::PT, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(out), n, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
