// S2-S4: the probes that measure what the flow kernels are made of on the
// H100. No flow path calls them; chip_smoke.py runs them beside their plain
// versions (kernels/probes.py) and reports their rates.
//
// S2, the 2x interleave store that pyrUp's output is made of. Replaces
// scripts/tpu_interleave_poc.py (pallas_calls at :76, :99, :188; kernels
// :18-57, :92, :175-185). Rows: (2H, W) with a in the even rows and b in
// the odd. Columns: (H, 2W) with a in the even columns and b in the odd,
// which is the flat interleave of the two planes whatever W is. Bound on
// the H100: memory, 8 B read and 8 B written per pair, no arithmetic; at
// the probe's (1080, 540) that is 9.33 MB, a few microseconds, so a call
// is about as much launch as transfer. Design: 16-byte loads and stores
// (float4) and 32-bit indices with no 64-bit division; each thread loads
// one float4 of each plane before it stores, in a grid with no mostly
// empty block (one float4 a thread at 256 threads measured best on the
// H100; PERF.md). Rows: item c of row r goes to row 2r (a) and 2r + 1 (b),
// the row from one 32-bit division per 16-byte item. Columns, in two
// forms: "float2", each thread forms the (a, b) pairs of its float4s in
// registers and stores them as two float4s; "smem", a block stages a tile
// of one float4 a thread of each plane in shared memory and writes the
// interleaved tile with float4 stores, neighbouring threads on
// neighbouring addresses (8-byte shared-memory reads, no bank conflict).
// The 16-byte path needs 16-byte-aligned planes and, for rows, W % 4 == 0;
// the columns forms take the n % 4 tail in the same launch, the smem form
// as the last block's scalar tile. Otherwise the same kernels run with
// float items (the wrapper decides, kernels/probes.py quad_path).
//
// S3, the stencil-tap read of K3/K4. Replaces scripts/tpu_roll_micro.py
// (pallas_call in run() at :40; kernels :22 and :31), the slice variant's
// output: out[r, o] = sum over t = -5..6 of float32(0.1 t) * x[r, o+6+t]
// for o < WIN, summed from 0 in the order of t, and out[r, o] = 0 for
// o >= WIN. Two Hopper forms of the tap reads: from shared memory, or from
// registers through warp shuffles. Bound on the H100: memory, the window's
// inputs x[r, 1 .. win + 11] read once and every output written once, for
// 24 flops per windowed output; at the probe's (15, 88, 1280) that is
// 12.92 MB, 3.86 us at 3.35 TB/s (the launch floor plus the rate the card
// sustains make about 6.3 us). Design: each thread computes one quad,
// four consecutive outputs 4c .. 4c + 3, from the sixteen inputs
// x[4c .. 4c + 15], which are the float4s of its own quad and of the three
// to its right, and stores the quad as one float4; 32-bit indices, one
// 32-bit division a quad for its column; 128 threads a block. Both forms
// load alike: a float4 a thread, and the first three threads of a block
// (smem) or lanes of a warp (shuffle) one more, the quads past the block or
// the warp. smem: the block stages its float4s in shared memory and each
// thread reads its three neighbours' from there. shuffle: each lane takes
// them from lanes l + 1 .. l + 3 by one shuffle of each component. Larger
// spans (several rows a block, up to eight quads a thread) and blocks of
// 64, 256 and 512 threads measured slower on the H100 (PERF.md). Each step
// is __fadd_rn(acc, __fmul_rn(w, x)), never an fma, the zero tap included,
// so both equal the plain version bit for bit (chip_smoke.py phase 2 reads
// their PTX). The 16-byte path needs 16-byte-aligned tensors and
// W % 4 == 0; otherwise the same kernels load and store a quad one float
// at a time, guarded at the row's end (the wrapper decides, quad_path).
//
// S4, the elementwise rate. Replaces scripts/tpu_vpu_rate_probe.py
// (measure() at :49, make_kernel :35): acc = a, then `steps` times
// acc = acc * b + a, in float32 or in bfloat16, each multiply and add
// rounded apart as eager PyTorch rounds them, so the kernel equals its plain
// version bit for bit and measures the rate of separate multiplies and adds,
// not the fused multiply-add that the published 67 TFLOP/s counts as two.
// Bound on the H100 at the probe's (512, 1024) and 64 steps: float32, 12 B
// against 128 operations an element, 1.88 us of bytes and about 2.0 us of
// issue (67.1 M unfused operations over 128 lanes x 132 SMs at 1.98 GHz);
// bfloat16, 6 B, 0.94 us of bytes and about 1.0 us of issue, a packed
// instruction doing two elements. Design: each thread runs four
// independent chains from one 16-byte load of a and of b (four floats, or
// four bf16x2 pairs of eight bfloat16), so the schedulers have independent
// instructions without relying on occupancy; a grid of at most one wave
// strides over the rest; the probe's 64 steps are a template, fully
// unrolled, and any other count a runtime loop. float32 steps are
// __fmul_rn then __fadd_rn (never contracted, whatever -fmad says).
// bfloat16 steps are __hmul2_rn then __hadd2_rn, mul.rn.bf16x2 and
// add.rn.bf16x2, with no conversion in the chain; the explicit .rn forbids
// contraction into fma.bf16x2. Each rounds the exact result once to
// bfloat16. Eager PyTorch computes in float32 and rounds to bfloat16: a
// product of two bfloat16 values is exact in float32 (8 x 8 significand
// bits) and a float32 sum rounded again to bfloat16 is an innocuous double
// rounding (24 >= 2 x 8 + 2), so the two agree bit for bit, subnormals
// included (tests/test_torch_probes.py pins the float32 side on the CPU;
// chip_smoke.py phase 10 sweeps the card). chip_smoke.py phase 2 checks
// the PTX of these kernels: mul.rn and add.rn, no fma, no conversion in
// the bfloat16 ones. ptxas then issues part of the packed operations on
// the MMA pipe as HFMA2.MMA.BF16_V2 with a zero addend (a multiply) or a
// multiplier of one (an add), each still one rounding. The n % 4 (float32)
// or n % 8 (bfloat16) tail runs in block 0 of the same launch through the
// scalar __fmul_rn/__fadd_rn or __hmul_rn/__hadd_rn; unaligned inputs take
// the same kernel with one element a lane, four chains a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace oft {
namespace {

constexpr int S3T = 128;  // threads per block of S3, one output quad a thread
constexpr int S2T = 256;  // threads per block of S2, one item of each plane a thread
constexpr int S4T = 256;  // threads per block of S4
constexpr int S4_CHAINS = 4;  // independent chains a thread of S4
constexpr int S4_STEPS = 64;  // the probe's chain (kernels/probes.py S4_STEPS), unrolled

// ------------------------------------------------------------------- S2

// n items (float4 or float) of each plane, w items a row.
template <typename V>
__global__ void __launch_bounds__(S2T)
    interleave_rows_kernel(const V* __restrict__ a, const V* __restrict__ b, V* __restrict__ out,
                           unsigned n, unsigned w) {
  const unsigned i = blockIdx.x * S2T + threadIdx.x;
  if (i < n) {
    const V va = a[i], vb = b[i];
    const unsigned o = i + i / w * w;  // item c of row r: row 2r of the output
    out[o] = va;
    out[o + w] = vb;
  }
}

// n floats of each plane; QUAD: float4 items, then the n % 4 tail in block 0.
template <bool QUAD>
__global__ void __launch_bounds__(S2T)
    interleave_cols_f2_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              float* __restrict__ out, unsigned n) {
  const unsigned i = blockIdx.x * S2T + threadIdx.x;
  if constexpr (QUAD) {
    const unsigned nq = n >> 2;
    if (i < nq) {
      const float4 va = reinterpret_cast<const float4*>(a)[i];
      const float4 vb = reinterpret_cast<const float4*>(b)[i];
      float4* o4 = reinterpret_cast<float4*>(out) + 2 * i;
      o4[0] = make_float4(va.x, vb.x, va.y, vb.y);
      o4[1] = make_float4(va.z, vb.z, va.w, vb.w);
    }
    if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
      const unsigned j = 4 * nq + threadIdx.x;
      out[2 * j] = a[j];
      out[2 * j + 1] = b[j];
    }
  } else if (i < n) {
    const float va = a[i], vb = b[i];
    out[2 * i] = va;
    out[2 * i + 1] = vb;
  }
}

template <bool QUAD>
__host__ __device__ constexpr unsigned s2_tile() {  // floats of each plane a smem block stages
  return QUAD ? 4 * S2T : S2T;
}

template <bool QUAD>
__global__ void __launch_bounds__(S2T)
    interleave_cols_smem_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                float* __restrict__ out, unsigned n) {
  constexpr unsigned TILE = s2_tile<QUAD>();
  __shared__ __align__(16) float sa[TILE];
  __shared__ __align__(16) float sb[TILE];
  const unsigned f0 = blockIdx.x * TILE, t = threadIdx.x;
  const unsigned m = min(TILE, n - f0);  // floats of each plane in this tile
  if (QUAD && m == TILE) {
    const float4 va = reinterpret_cast<const float4*>(a + f0)[t];
    const float4 vb = reinterpret_cast<const float4*>(b + f0)[t];
    reinterpret_cast<float4*>(sa)[t] = va;
    reinterpret_cast<float4*>(sb)[t] = vb;
    __syncthreads();
    // output quads t and t + S2T of the tile; quad j is a[2j], b[2j], a[2j + 1], b[2j + 1]
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const unsigned j = t + k * S2T;
      const float2 pa = reinterpret_cast<const float2*>(sa)[j];
      const float2 pb = reinterpret_cast<const float2*>(sb)[j];
      reinterpret_cast<float4*>(out + 2 * f0)[j] = make_float4(pa.x, pb.x, pa.y, pb.y);
    }
  } else {
    for (unsigned c = t; c < m; c += S2T) {
      sa[c] = a[f0 + c];
      sb[c] = b[f0 + c];
    }
    __syncthreads();
    for (unsigned c = t; c < 2 * m; c += S2T) out[2 * f0 + c] = (c & 1 ? sb : sa)[c >> 1];
  }
}

inline unsigned blocks_for(unsigned items, unsigned per_block) {
  return std::max(1u, (items + per_block - 1) / per_block);
}

// ------------------------------------------------------------------- S3

constexpr int S3_TAPS = 12;  // t = -5..6 -> offsets 1..12 from the output

// Quad q = r * wq + c holds outputs 4c .. 4c + 3 of row r. Their sixteen
// inputs x[r, 4c .. 4c + 15] are the float4s of quads q .. q + 3: a quad
// with 4c < win has them all inside its row (win <= W - 12). On the
// 16-byte path (W % 4 == 0) wq = W / 4 and quad q is float4 q of x;
// otherwise wq = ceil(W / 4) and a quad is loaded and stored a float at a
// time, zeros past the row's end.
struct S3Shape {
  unsigned W, wq, nq, win;  // width, quads a row, quads, window
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

__device__ __forceinline__ float s3_weight(int k) {  // float32(0.1 * t), t = k - 6
  return (float)(0.1 * (double)(k - 6));
}

template <bool VEC>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ x, const S3Shape& s,
                                            unsigned q) {
  if (q >= s.nq) return zero4();
  if constexpr (VEC) {
    return reinterpret_cast<const float4*>(x)[q];
  } else {
    const unsigned c = q % s.wq, o = 4 * c, e = (q - c) / s.wq * s.W + o;
    float a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = o + j < s.W ? x[e + j] : 0.0f;
    return make_float4(a[0], a[1], a[2], a[3]);
  }
}

// Quad q's outputs from the float4s a of quads q .. q + 3, stored: summed
// from +0 in the order of t, each step one rounded product and one rounded
// sum (never an fma, whatever -fmad says), the zero tap included (0 * inf
// is NaN in the plain version too); outputs at or past win are 0.
template <bool VEC>
__device__ __forceinline__ void colsum_store(float* __restrict__ out, const S3Shape& s,
                                             unsigned q, const float4 (&a)[4]) {
  const unsigned c = q % s.wq, o = 4 * c;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (o < s.win) {
    const float v[16] = {a[0].x, a[0].y, a[0].z, a[0].w, a[1].x, a[1].y, a[1].z, a[1].w,
                         a[2].x, a[2].y, a[2].z, a[2].w, a[3].x, a[3].y, a[3].z, a[3].w};
#pragma unroll
    for (int k = 1; k <= S3_TAPS; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(s3_weight(k), v[j + k]));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (o + j >= s.win) acc[j] = 0.0f;
  if constexpr (VEC) {
    reinterpret_cast<float4*>(out)[q] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    const unsigned e = (q - c) / s.wq * s.W + o;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (o + j < s.W) out[e + j] = acc[j];
  }
}

// Thread t of a block takes quad t of the block's S3T and loads its float4,
// threads 0-2 also the three quads past them, all before the block stages
// them in shared memory; each thread then reads the float4s of its three
// right-hand neighbours from there.
template <bool VEC>
__global__ void __launch_bounds__(S3T)
    colsum_smem_kernel(const float* __restrict__ x, float* __restrict__ out, S3Shape s) {
  __shared__ float4 staged[S3T + 3];
  const unsigned t = threadIdx.x, q = blockIdx.x * S3T + t;
  const float4 v = load_quad<VEC>(x, s, q);
  const float4 next = t < 3 ? load_quad<VEC>(x, s, q + S3T) : zero4();
  staged[t] = v;
  if (t < 3) staged[S3T + t] = next;
  __syncthreads();
  if (q >= s.nq) return;
  const float4 a[4] = {v, staged[t + 1], staged[t + 2], staged[t + 3]};
  colsum_store<VEC>(out, s, q, a);
}

__device__ __forceinline__ float4 shfl4(float4 v, unsigned src) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src),
                     __shfl_sync(0xffffffffu, v.z, src), __shfl_sync(0xffffffffu, v.w, src));
}

// Lane l of a warp takes quad l of the warp's 32 and loads its float4,
// lanes 0-2 also the three quads past them. Quad q + j (j = 1..3) is in
// lane (l + j) % 32: its own float4 or, for the last j lanes, its second;
// the source lane offers the one that some lane reads, so each
// neighbour's float4 costs one shuffle of each component.
template <bool VEC>
__global__ void __launch_bounds__(S3T)
    colsum_shfl_kernel(const float* __restrict__ x, float* __restrict__ out, S3Shape s) {
  const unsigned lane = threadIdx.x & 31, q = blockIdx.x * S3T + threadIdx.x;
  const float4 v = load_quad<VEC>(x, s, q);
  const float4 next = lane < 3 ? load_quad<VEC>(x, s, q + 32) : zero4();
  float4 a[4] = {v};
#pragma unroll
  for (unsigned j = 1; j < 4; ++j) a[j] = shfl4(lane < j ? next : v, (lane + j) & 31);
  if (q >= s.nq) return;  // after the shuffles, which take the whole warp
  colsum_store<VEC>(out, s, q, a);
}

inline S3Shape colsum_shape(int rows, int W, int win, bool vec) {
  const unsigned wq = vec ? W / 4 : (W + 3) / 4;
  return {(unsigned)W, wq, (unsigned)rows * wq, (unsigned)win};
}

// ------------------------------------------------------------------- S4

__device__ __forceinline__ float chain_step(float acc, float b, float a) {
  return __fadd_rn(__fmul_rn(acc, b), a);
}
__device__ __forceinline__ __nv_bfloat162 chain_step(__nv_bfloat162 acc, __nv_bfloat162 b,
                                                     __nv_bfloat162 a) {
  return __hadd2_rn(__hmul2_rn(acc, b), a);
}
__device__ __forceinline__ __nv_bfloat16 chain_step(__nv_bfloat16 acc, __nv_bfloat16 b,
                                                    __nv_bfloat16 a) {
  return __hadd_rn(__hmul_rn(acc, b), a);
}

// N independent chains, steps outermost so that the N steps of one round
// issue back to back
template <int STEPS, typename L, int N>
__device__ __forceinline__ void run_chains(L (&acc)[N], const L (&av)[N], const L (&bv)[N],
                                           int steps) {
  if constexpr (STEPS >= 0) {
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = chain_step(acc[j], bv[j], av[j]);
  } else {
    for (int s = 0; s < steps; ++s)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = chain_step(acc[j], bv[j], av[j]);
  }
}

// The lanes of one item: 16 bytes (four floats, four bf16x2 pairs) on the
// 16-byte path, one element on the scalar path. E elements an item.
template <typename T, bool VEC>
struct ChainItem;
template <>
struct ChainItem<float, true> {
  using L = float;
  static constexpr int W = 4, E = 4;
};
template <>
struct ChainItem<float, false> {
  using L = float;
  static constexpr int W = 1, E = 1;
};
template <>
struct ChainItem<__nv_bfloat16, true> {
  using L = __nv_bfloat162;
  static constexpr int W = 4, E = 8;
};
template <>
struct ChainItem<__nv_bfloat16, false> {
  using L = __nv_bfloat16;
  static constexpr int W = 1, E = 1;
};

template <typename L, int W>
struct alignas(sizeof(L) * W) Lanes {
  L x[W];
};

template <typename T, bool VEC>
__host__ __device__ constexpr int chain_items() {  // items a thread: S4_CHAINS chains either way
  return S4_CHAINS / ChainItem<T, VEC>::W;
}

template <typename T, bool VEC, int STEPS>
__global__ void __launch_bounds__(S4T)
    mul_add_chain_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                         long long n, int steps) {
  using C = ChainItem<T, VEC>;
  using L = typename C::L;
  using V = Lanes<L, C::W>;
  constexpr int K = chain_items<T, VEC>();
  const long long m = n / C::E;  // whole items; the tail comes after
  const V* av_ = reinterpret_cast<const V*>(a);
  const V* bv_ = reinterpret_cast<const V*>(b);
  V* ov_ = reinterpret_cast<V*>(out);
  for (long long i0 = (long long)blockIdx.x * S4T * K + threadIdx.x; i0 < m;
       i0 += (long long)gridDim.x * S4T * K) {
    L av[S4_CHAINS], bv[S4_CHAINS], acc[S4_CHAINS];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = i0 + k * S4T;
      V x{}, y{};
      if (i < m) {
        x = av_[i];
        y = bv_[i];
      }
#pragma unroll
      for (int w = 0; w < C::W; ++w) {
        av[k * C::W + w] = x.x[w];
        bv[k * C::W + w] = y.x[w];
        acc[k * C::W + w] = x.x[w];
      }
    }
    run_chains<STEPS>(acc, av, bv, steps);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = i0 + k * S4T;
      if (i < m) {
        V o;
#pragma unroll
        for (int w = 0; w < C::W; ++w) o.x[w] = acc[k * C::W + w];
        ov_[i] = o;
      }
    }
  }
  if constexpr (C::E > 1) {  // the n % E tail, one element a thread of block 0
    const long long i = m * C::E + threadIdx.x;
    if (blockIdx.x == 0 && i < n) {
      const T a1[1] = {a[i]}, b1[1] = {b[i]};
      T acc1[1] = {a[i]};
      run_chains<STEPS>(acc1, a1, b1, steps);
      out[i] = acc1[0];
    }
  }
}

template <typename T, bool VEC>
int launch_chain(const void* a, const void* b, void* out, long long n, int steps, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long per_block = (long long)S4T * chain_items<T, VEC>();
  const long long items = n / ChainItem<T, VEC>::E;
  const long long wave = (long long)sms * (2048 / S4T);  // one wave at full occupancy
  const unsigned blocks =
      (unsigned)std::max(1LL, std::min(wave, (items + per_block - 1) / per_block));
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
  if (steps == S4_STEPS)
    mul_add_chain_kernel<T, VEC, S4_STEPS>
        <<<blocks, S4T, 0, (cudaStream_t)stream>>>(pa, pb, po, n, steps);
  else
    mul_add_chain_kernel<T, VEC, -1>
        <<<blocks, S4T, 0, (cudaStream_t)stream>>>(pa, pb, po, n, steps);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace oft

extern "C" {

// S2: `quad` selects the 16-byte path (kernels/probes.py quad_path); H * W < 2^31.
int oft_interleave_rows(const float* a, const float* b, float* out, int H, int W, int quad,
                        void* stream) {
  const unsigned w = quad ? W / 4 : W, n = (unsigned)H * w;
  const unsigned blocks = oft::blocks_for(n, oft::S2T);
  if (quad)
    oft::interleave_rows_kernel<float4><<<blocks, oft::S2T, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b),
        reinterpret_cast<float4*>(out), n, w);
  else
    oft::interleave_rows_kernel<float><<<blocks, oft::S2T, 0, (cudaStream_t)stream>>>(a, b, out,
                                                                                        n, w);
  return (int)cudaGetLastError();
}

int oft_interleave_cols_f2(const float* a, const float* b, float* out, int H, int W, int quad,
                           void* stream) {
  const unsigned n = (unsigned)H * W;
  if (quad)
    oft::interleave_cols_f2_kernel<true>
        <<<oft::blocks_for(n / 4, oft::S2T), oft::S2T, 0, (cudaStream_t)stream>>>(a, b, out, n);
  else
    oft::interleave_cols_f2_kernel<false>
        <<<oft::blocks_for(n, oft::S2T), oft::S2T, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

int oft_interleave_cols_smem(const float* a, const float* b, float* out, int H, int W, int quad,
                             void* stream) {
  const unsigned n = (unsigned)H * W;
  if (quad)
    oft::interleave_cols_smem_kernel<true>
        <<<oft::blocks_for(n, oft::s2_tile<true>()), oft::S2T, 0, (cudaStream_t)stream>>>(
            a, b, out, n);
  else
    oft::interleave_cols_smem_kernel<false>
        <<<oft::blocks_for(n, oft::s2_tile<false>()), oft::S2T, 0, (cudaStream_t)stream>>>(
            a, b, out, n);
  return (int)cudaGetLastError();
}

// S3: `vec` selects the 16-byte path (kernels/probes.py quad_path); rows * W < 2^31.
int oft_colsum_smem(const float* x, float* out, int rows, int W, int win, int vec, void* stream) {
  const oft::S3Shape s = oft::colsum_shape(rows, W, win, vec);
  const unsigned blocks = oft::blocks_for(s.nq, oft::S3T);
  if (vec)
    oft::colsum_smem_kernel<true><<<blocks, oft::S3T, 0, (cudaStream_t)stream>>>(x, out, s);
  else
    oft::colsum_smem_kernel<false><<<blocks, oft::S3T, 0, (cudaStream_t)stream>>>(x, out, s);
  return (int)cudaGetLastError();
}

int oft_colsum_shfl(const float* x, float* out, int rows, int W, int win, int vec, void* stream) {
  const oft::S3Shape s = oft::colsum_shape(rows, W, win, vec);
  const unsigned blocks = oft::blocks_for(s.nq, oft::S3T);
  if (vec)
    oft::colsum_shfl_kernel<true><<<blocks, oft::S3T, 0, (cudaStream_t)stream>>>(x, out, s);
  else
    oft::colsum_shfl_kernel<false><<<blocks, oft::S3T, 0, (cudaStream_t)stream>>>(x, out, s);
  return (int)cudaGetLastError();
}

// S4: `vec` selects the 16-byte path (kernels/probes.py quad_path).
int oft_mul_add_chain_f32(const float* a, const float* b, float* out, long long n, int steps,
                          int vec, void* stream) {
  return vec ? oft::launch_chain<float, true>(a, b, out, n, steps, stream)
             : oft::launch_chain<float, false>(a, b, out, n, steps, stream);
}

int oft_mul_add_chain_bf16(const void* a, const void* b, void* out, long long n, int steps,
                           int vec, void* stream) {
  return vec ? oft::launch_chain<__nv_bfloat16, true>(a, b, out, n, steps, stream)
             : oft::launch_chain<__nv_bfloat16, false>(a, b, out, n, steps, stream);
}

}  // extern "C"
