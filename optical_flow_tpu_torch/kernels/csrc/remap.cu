// W1: reference mode's symmetric gather warp, both frames of a level in one
// launch: img1 sampled at (x + u/2, y + v/2) and img2 at (x - u/2, y - v/2),
// cv::remap INTER_LINEAR with a constant-0 border (LKof.cpp:213-226).
//
// Replaces no TPU kernel: the JAX package's remap_bilinear
// (optical_flow_tpu/ops/warp.py:50) is a plain XLA gather. In eager PyTorch
// the same warp (ops/warp.py::symmetric_warp, impl 'gather') is a chain of
// about 180 kernels a level (rounds, casts, shifts, four gathers with their
// masks and clamps, the lerp), each writing its index, mask or value plane
// to device memory and reading it back.
//
// Bound on the H100: memory. Per output position it reads u and v and
// writes both warped frames, 16 B, and reads the 8 taps, which fall on the
// lines of the neighbouring positions (the flow is smooth): 6 planes of 4 B,
// 28.0 MB at 1080^2, at least 8.36 us at 3.35 TB/s, for 64 operations a
// position (utils/profiling.py's OPS_PER_OUTPUT). Design:
// - A thread owns VEC (4, else 2, else 1) consecutive outputs of a row: one
//   VEC-wide load of u and of v, one VEC-wide store of each warped frame.
//   Both frames' taps come from the same (u/2, v/2).
// - The taps are scalar loads through the read-only path (__ldg): a warp's
//   taps cover a few contiguous runs of a row, so they hit the same L1 and
//   L2 lines; a block is 8 rows of one warp each, so neighbouring rows'
//   taps share the lines too.
// - No index, mask or promoted plane is written: the coordinates, the
//   border test and a uint8 source's conversion stay in registers.
// - Frames of a batch run on blockIdx.z.
//
// Bit for bit: the operations are those of ops/warp.py::remap_bilinear, in
// its order. The fixed-point coordinate is rint(map * 32) cast to int
// (round half to even, then the cast PyTorch's CUDA .to(torch.int32)
// makes), split by >> 5 and & 31; the lerp is v00 + fx * (v01 - v00) per
// row, then top + fy * (bot - top). With -fmad=false no product is fused,
// so the kernel equals its plain version bit for bit; u / 2 and f / 32 are
// exact scalings, as PyTorch's multiply by the reciprocal is.
#include <stdint.h>

#include <cuda_runtime.h>

namespace oft {
namespace {

constexpr int RL = 32;   // threads across a block: a warp along a row
constexpr int RNY = 8;   // rows of a block, one warp each
constexpr int MAX_Z = 65535;

__device__ __forceinline__ float load_src(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_src(const uint8_t* p) { return (float)__ldg(p); }

// A tap of the H x W plane p; 0 outside it (unsigned compares: a negative
// index wraps past the bound).
template <typename T>
__device__ __forceinline__ float tap(const T* p, unsigned y, unsigned x, unsigned H, unsigned W) {
  return (y < H && x < W) ? load_src(p + (size_t)y * W + x) : 0.0f;
}

// The integer tap and the fraction of one map coordinate.
template <bool QUANT>
__device__ __forceinline__ void split_coord(float m, int* i, float* f) {
  if (QUANT) {  // cv2's 5-bit fixed point
    const int s = static_cast<int>(rintf(m * 32.0f));
    *i = s >> 5;
    *f = (float)(s & 31) / 32.0f;
  } else {
    *i = static_cast<int>(floorf(m));
    *f = m - (float)*i;
  }
}

template <typename T, bool QUANT>
__device__ __forceinline__ float sample(const T* p, int H, int W, float mx, float my) {
  int ix, iy;
  float fx, fy;
  split_coord<QUANT>(mx, &ix, &fx);
  split_coord<QUANT>(my, &iy, &fy);
  const unsigned x0 = (unsigned)ix, x1 = x0 + 1u, y0 = (unsigned)iy, y1 = y0 + 1u;
  const float v00 = tap(p, y0, x0, H, W), v01 = tap(p, y0, x1, H, W);
  const float v10 = tap(p, y1, x0, H, W), v11 = tap(p, y1, x1, H, W);
  const float top = v00 + fx * (v01 - v00);
  const float bot = v10 + fx * (v11 - v10);
  return top + fy * (bot - top);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if (VEC == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

template <typename T, int VEC, bool QUANT>
__global__ void __launch_bounds__(RL * RNY)
    remap_pair_kernel(const T* __restrict__ img1, const T* __restrict__ img2,
                      const float* __restrict__ u, const float* __restrict__ v,
                      float* __restrict__ w1, float* __restrict__ w2, int B, int H, int W) {
  const int x = VEC * (blockIdx.x * RL + threadIdx.x);
  const int y = blockIdx.y * RNY + threadIdx.y;
  if (y >= H || x >= W) return;
  const size_t plane = (size_t)H * W;
  const float ys = (float)y;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const size_t off = (size_t)b * plane;
    const size_t at = off + (size_t)y * W + x;
    float hx[VEC], hy[VEC], o1[VEC], o2[VEC];
    load_vec<VEC>(u + at, hx);
    load_vec<VEC>(v + at, hy);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float dx = hx[k] / 2.0f, dy = hy[k] / 2.0f, xs = (float)(x + k);
      o1[k] = sample<T, QUANT>(img1 + off, H, W, xs + dx, ys + dy);
      o2[k] = sample<T, QUANT>(img2 + off, H, W, xs - dx, ys - dy);
    }
    store_vec<VEC>(w1 + at, o1);
    store_vec<VEC>(w2 + at, o2);
  }
}

template <typename T, int VEC, bool QUANT>
int launch(const void* img1, const void* img2, const float* u, const float* v, float* w1,
           float* w2, int B, int H, int W, void* stream) {
  const dim3 block(RL, RNY);
  const dim3 grid((W / VEC + RL - 1) / RL, (H + RNY - 1) / RNY, B < MAX_Z ? B : MAX_Z);
  remap_pair_kernel<T, VEC, QUANT><<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(img1), static_cast<const T*>(img2), u, v, w1, w2, B, H, W);
  return (int)cudaGetLastError();
}

// VEC 4 where every row of the flow and the outputs is a whole number of
// 16-byte words (W % 4 == 0, planes 16-byte aligned), else 2 (8 bytes), else 1.
template <typename T, bool QUANT>
int launch_vec(const void* img1, const void* img2, const float* u, const float* v, float* w1,
               float* w2, int B, int H, int W, void* stream) {
  const uintptr_t ptrs = (uintptr_t)u | (uintptr_t)v | (uintptr_t)w1 | (uintptr_t)w2;
  if (W % 4 == 0 && ptrs % 16 == 0)
    return launch<T, 4, QUANT>(img1, img2, u, v, w1, w2, B, H, W, stream);
  if (W % 2 == 0 && ptrs % 8 == 0)
    return launch<T, 2, QUANT>(img1, img2, u, v, w1, w2, B, H, W, stream);
  return launch<T, 1, QUANT>(img1, img2, u, v, w1, w2, B, H, W, stream);
}

}  // namespace
}  // namespace oft

// img1, img2: B planes of H x W, float32 (u8 == 0) or uint8 (u8 == 1); u, v
// float32 flows of the same shape; w1, w2 the float32 warped frames.
extern "C" int oft_remap(const void* img1, const void* img2, const float* u, const float* v,
                         float* w1, float* w2, int B, int H, int W, int u8, int quantize,
                         void* stream) {
  if (u8) {
    return quantize ? oft::launch_vec<uint8_t, true>(img1, img2, u, v, w1, w2, B, H, W, stream)
                    : oft::launch_vec<uint8_t, false>(img1, img2, u, v, w1, w2, B, H, W, stream);
  }
  return quantize ? oft::launch_vec<float, true>(img1, img2, u, v, w1, w2, B, H, W, stream)
                  : oft::launch_vec<float, false>(img1, img2, u, v, w1, w2, B, H, W, stream);
}
