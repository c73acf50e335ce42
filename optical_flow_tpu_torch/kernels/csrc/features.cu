// F1: the whole of pipeline/preprocess.py::diff_features in one launch: the
// temporal diff (saturated to uint8 on the faithful path), THRESH_TOZERO,
// Sobel x + y (REFLECT_101), then dilate^r and erode^r with the 3x3 rect
// element, as one (2r+1)-square max and min whose window ignores positions
// outside the image.
//
// Replaces no TPU kernel: the JAX package's diff_features
// (optical_flow_tpu/pipeline/preprocess.py) is left to XLA, which fuses it.
// In eager PyTorch the chain is about 54 launches (60 on the uint8 path),
// each writing a full plane to device memory and reading it back: about
// 120 plane passes, 560 MB a 1080^2 frame.
//
// Bound on the H100: memory. The function reads two gray planes and writes
// one float32 plane: 14.0 MB at 1080^2 in float32 (4.18 us at 3.35 TB/s),
// 7.0 MB with uint8 planes (2.09 us), for about 32 operations a pixel.
// Design:
// - A block owns a 32 x 64 output tile of one frame (frames on blockIdx.z).
//   It stages d (diff and threshold) over the tile and its halo of 1 + 2r
//   in shared memory, a warp a row: each input pixel is read from device
//   memory by the blocks whose halo holds it (the halo's re-reads come from
//   L2), and no intermediate plane leaves the chip.
// - The separable passes run in shared memory over shrinking windows, each
//   thread walking a column segment of fixed length, unrolled, with the
//   vertical window in registers: (a) Sobel and the vertical max, g never
//   stored; (b) the horizontal max and the vertical min, written over d;
//   (c) the horizontal min, four outputs a thread, one 16-byte store.
// - The border: d is staged at REFLECT_101 positions, so the Sobel at an
//   edge pixel reads what the padded plain version reads; the max window
//   sees -inf outside the image and the min window +inf, as the plain
//   version's constant pads give.
// - Latency, not bandwidth, bounds it at one frame (578 blocks): five blocks
//   share an SM (48 registers a thread), which timed fastest. Timed against
//   it on the card: tiles of 64 rows (slower at batch 1, where 289 blocks
//   leave SMs idle; a little faster at batch 16), and a warp sliding down a
//   32-column strip with every window in registers and the horizontal taps
//   by shuffles (26 us at batch 1).
//
// Bit for bit: every product and sum is the plain version's, in its order:
// d = cur - (lr * prev); sobel3's sums start from 0 (Python's sum): the
// smoothing ((0 + a) + 2b) + c and the difference (0 + -a) + c; g = Gx + Gy.
// The saturation is rintf (round half to even, as torch.round) clamped to
// [0, 255] and passed through an integer, as the uint8 cast does. max and
// min are exact; max.NaN/min.NaN propagate a NaN as torch.maximum and
// torch.minimum do. With -fmad=false no product is fused into a sum.
#include <stdint.h>

#include <cuda_runtime.h>

namespace oft {
namespace {

constexpr int FT = 256;  // threads a block
constexpr int FW = 64;   // output columns of a tile
constexpr int TH = 32;   // output rows of a tile
constexpr int MAX_Z = 65535;

__device__ __forceinline__ float load_gray(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_gray(const uint8_t* p) { return (float)__ldg(p); }

// torch.maximum / torch.minimum: a NaN operand gives NaN (fmaxf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// REFLECT_101 for a reach of up to n - 1 past an edge; clamped beyond it,
// where d feeds only positions outside the image.
__device__ __forceinline__ int reflect_once(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// temporal_diff, then threshold_tozero, at one pixel.
template <typename T, bool SAT>
__device__ __forceinline__ float diff_at(const T* cur, const T* prev, size_t at, float lr,
                                         float thresh) {
  float d = load_gray(cur + at) - lr * load_gray(prev + at);
  if (SAT) d = (float)(int)fminf(fmaxf(rintf(d), 0.0f), 255.0f);
  return d > thresh ? d : 0.0f;
}

// sobel3's taps: (1, 2, 1) and (-1, 0, 1), each sum from 0.
__device__ __forceinline__ float smooth3(float a, float b, float c) {
  return ((0.0f + a) + 2.0f * b) + c;
}

__device__ __forceinline__ float diff3(float a, float c) { return (0.0f + -a) + c; }

// The window of the last 2R + 1 values of a column, oldest first.
template <int R>
__device__ __forceinline__ void push(float (&w)[2 * R + 1], float x) {
#pragma unroll
  for (int j = 0; j < 2 * R; ++j) w[j] = w[j + 1];
  w[2 * R] = x;
}

template <int R>
__device__ __forceinline__ float max_of(const float (&w)[2 * R + 1]) {
  float m = w[0];
#pragma unroll
  for (int j = 1; j <= 2 * R; ++j) m = nan_max(m, w[j]);
  return m;
}

template <int R>
__device__ __forceinline__ float min_of(const float (&w)[2 * R + 1]) {
  float m = w[0];
#pragma unroll
  for (int j = 1; j <= 2 * R; ++j) m = nan_min(m, w[j]);
  return m;
}

// Element i of an array of float4 (i known at compile time: a register).
template <int N>
__device__ __forceinline__ float word(const float4 (&v)[N], int i) {
  const float4 q = v[i >> 2];
  return (i & 3) == 0 ? q.x : (i & 3) == 1 ? q.y : (i & 3) == 2 ? q.z : q.w;
}

// Shared-memory layout of a tile, in tile-relative rows and columns:
// d over [-HD, TH + HD) x [-HD, FW + HD); V (the vertical max of g) over
// [-R, TH + R) x [-2R, FW + 2R); E (the vertical min of the dilated plane)
// over [0, TH) x [-R, FW + R), written over d, its rows 16-byte aligned.
// A pass walks column segments of a fixed length, so the last segment may
// run past the region: d and V have rows to spare for its reads, and it
// stores nothing there.
template <int R>
struct Tile {
  static constexpr int HD = 1 + 2 * R;
  static constexpr int DR = TH + 2 * HD, DC = FW + 2 * HD;
  static constexpr int VR = TH + 2 * R, VC = FW + 4 * R;
  static constexpr int EC = FW + 2 * R, EP = (EC + 3) / 4 * 4;
  // pass (a): VC columns x SA segments of LA V rows; pass (b): EC x SB of LB E rows
  static constexpr int SA = FT / VC, LA = (VR + SA - 1) / SA;
  static constexpr int SB = FT / EC, LB = (TH + SB - 1) / SB;
  static constexpr int DRS = SA * LA + HD + 1 > DR ? SA * LA + HD + 1 : DR;  // d rows stored
  static constexpr int VRS = SB * LB + 2 * R > VR ? SB * LB + 2 * R : VR;    // V rows stored
  static constexpr int SMEM = (DRS * DC + VRS * VC) * 4;
  static constexpr int NS = (DC + 31) / 32;  // d columns a lane stages
  static_assert(TH * EP <= DRS * DC, "E is written over d");
  static_assert(FT % 32 == 0 && FW % 4 == 0, "warps of whole rows; 16-byte outputs");
};

// At most 48 registers a thread, so that five blocks share an SM: timed
// fastest on the card against 2 to 4 and 6 to 8 blocks an SM.
template <typename T, bool SAT, int R>
__global__ void __launch_bounds__(FT, 5)
    diff_features_kernel(const T* __restrict__ cur, const T* __restrict__ prev,
                         float* __restrict__ out, int B, int H, int W, float lr, float thresh) {
  using L = Tile<R>;
  extern __shared__ __align__(16) float smem[];
  float* sd = smem;                   // d, then E
  float* sv = smem + L::DRS * L::DC;  // V
  const int tid = threadIdx.x, lane = tid & 31;
  const int x0 = blockIdx.x * FW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)H * W;
  // the d columns this lane stages, each at its source column
  int sx[L::NS];
#pragma unroll
  for (int j = 0; j < L::NS; ++j) sx[j] = reflect_once(x0 - L::HD + lane + 32 * j, W);
  const bool vec = (W & 3) == 0 && ((uintptr_t)out & 15) == 0;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const T* c = cur + b * plane;
    const T* p = prev + b * plane;
    // d over the tile and its halo, a warp a row
#pragma unroll 2
    for (int ry = tid >> 5; ry < L::DR; ry += FT / 32) {
      const size_t row = (size_t)reflect_once(y0 - L::HD + ry, H) * W;
#pragma unroll
      for (int j = 0; j < L::NS; ++j)
        if (lane + 32 * j < L::DC)
          sd[ry * L::DC + lane + 32 * j] = diff_at<T, SAT>(c, p, row + sx[j], lr, thresh);
    }
    __syncthreads();
    // (a) g = Sobel x + y (-inf outside the image), slid down a column
    // segment; its vertical max V
    if (tid < L::SA * L::VC) {
      const int col = tid % L::VC, seg = tid / L::VC;
      const int vx = col - 2 * R, vy0 = -R + seg * L::LA;
      const bool xin = (unsigned)(x0 + vx) < (unsigned)W;
      // d at rows vy0 - R - 1 .., columns vx - 1 .. vx + 1
      const float* d = sd + (vy0 - R - 1 + L::HD) * L::DC + (vx - 1 + L::HD);
      float a0 = d[0], a1 = d[1], a2 = d[2];
      float b0 = d[L::DC], b1 = d[L::DC + 1], b2 = d[L::DC + 2];
      float sha = smooth3(a0, a1, a2), shb = smooth3(b0, b1, b2);
      float w[2 * R + 1];
#pragma unroll
      for (int k = 0; k < L::LA + 2 * R; ++k) {
        const float* e = d + (k + 2) * L::DC;
        const float c0 = e[0], c1 = e[1], c2 = e[2];
        const float shc = smooth3(c0, c1, c2);
        const float g = diff3(smooth3(a0, b0, c0), smooth3(a2, b2, c2)) + diff3(sha, shc);
        const int gy = vy0 - R + k;
        push<R>(w, xin && (unsigned)(y0 + gy) < (unsigned)H ? g : -INFINITY);
        const int vy = gy - R;
        if (k >= 2 * R && vy < TH + R) sv[(vy + R) * L::VC + col] = max_of<R>(w);
        a0 = b0; a1 = b1; a2 = b2;
        b0 = c0; b1 = c1; b2 = c2;
        sha = shb;
        shb = shc;
      }
    }
    __syncthreads();
    // (b) the dilated plane (+inf outside the image), the horizontal max of
    // V, slid down a column segment; its vertical min E
    if (tid < L::SB * L::EC) {
      const int col = tid % L::EC, seg = tid / L::EC;
      const int ex = col - R, ey0 = seg * L::LB;
      const bool xin = (unsigned)(x0 + ex) < (unsigned)W;
      const float* v = sv + ey0 * L::VC + col;  // V at row ey0 - R, columns ex - R .. ex + R
      float w[2 * R + 1];
#pragma unroll
      for (int k = 0; k < L::LB + 2 * R; ++k) {
        const float* vr = v + k * L::VC;
        float m = vr[0];
#pragma unroll
        for (int j = 1; j <= 2 * R; ++j) m = nan_max(m, vr[j]);
        const int dy = ey0 - R + k;
        push<R>(w, xin && (unsigned)(y0 + dy) < (unsigned)H ? m : INFINITY);
        const int ey = dy - R;
        if (k >= 2 * R && ey < TH) sd[ey * L::EP + col] = min_of<R>(w);
      }
    }
    __syncthreads();
    // (c) the horizontal min of E: four outputs a thread, one 16-byte store
    // where the rows allow it
    float* o = out + b * plane;
    constexpr int NV = (4 + 2 * R + 3) / 4;  // 16-byte words of E a thread reads
    for (int i = tid; i < TH * (FW / 4); i += FT) {
      const int ry = i / (FW / 4), qx = (i - ry * (FW / 4)) * 4;
      if (y0 + ry >= H || x0 + qx >= W) continue;
      float4 e[NV];  // E at columns qx - R .. qx + 3 + R, and up to 3 more
#pragma unroll
      for (int j = 0; j < NV; ++j)
        e[j] = *reinterpret_cast<const float4*>(sd + ry * L::EP + qx + 4 * j);
      float m[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m[k] = word(e, k);
#pragma unroll
        for (int j = 1; j <= 2 * R; ++j) m[k] = nan_min(m[k], word(e, k + j));
      }
      float* q = o + (size_t)(y0 + ry) * W + x0 + qx;
      if (vec && x0 + qx + 4 <= W) {
        *reinterpret_cast<float4*>(q) = make_float4(m[0], m[1], m[2], m[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (x0 + qx + k < W) q[k] = m[k];
      }
    }
    __syncthreads();  // the next frame's d is written over E
  }
}

template <typename T, bool SAT, int R>
int launch(const void* cur, const void* prev, float* out, int B, int H, int W, float lr,
           float thresh, void* stream) {
  const dim3 grid((W + FW - 1) / FW, (H + TH - 1) / TH, B < MAX_Z ? B : MAX_Z);
  diff_features_kernel<T, SAT, R><<<grid, FT, Tile<R>::SMEM, (cudaStream_t)stream>>>(
      static_cast<const T*>(cur), static_cast<const T*>(prev), out, B, H, W, lr, thresh);
  return (int)cudaGetLastError();
}

template <typename T, bool SAT>
int launch_r(int r, const void* cur, const void* prev, float* out, int B, int H, int W,
             float lr, float thresh, void* stream) {
  switch (r) {
    case 0: return launch<T, SAT, 0>(cur, prev, out, B, H, W, lr, thresh, stream);
    case 1: return launch<T, SAT, 1>(cur, prev, out, B, H, W, lr, thresh, stream);
    case 2: return launch<T, SAT, 2>(cur, prev, out, B, H, W, lr, thresh, stream);
    case 3: return launch<T, SAT, 3>(cur, prev, out, B, H, W, lr, thresh, stream);
    case 4: return launch<T, SAT, 4>(cur, prev, out, B, H, W, lr, thresh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace oft

// cur, prev: B gray planes of H x W, float32 (u8 == 0) or uint8 (u8 == 1);
// out: the float32 feature planes. saturate: the uint8 diff of the
// faithful path; lr: learning_rate as float32; thresh: diff_thresh as
// float32; r: morph_iterations, 0 to 4.
extern "C" int oft_diff_features(const void* cur, const void* prev, float* out, int B, int H,
                                 int W, int u8, int saturate, float lr, float thresh, int r,
                                 void* stream) {
  if (!u8) return oft::launch_r<float, false>(r, cur, prev, out, B, H, W, lr, thresh, stream);
  return saturate
             ? oft::launch_r<uint8_t, true>(r, cur, prev, out, B, H, W, lr, thresh, stream)
             : oft::launch_r<uint8_t, false>(r, cur, prev, out, B, H, W, lr, thresh, stream);
}
