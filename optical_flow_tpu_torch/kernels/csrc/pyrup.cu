// S1: cv::pyrUp of two planes (the flow's u and v) in one launch.
//
// Replaces the TPU kernel scripts/tpu_pyrup_poc.py::pyrup_pallas
// (pallas_call at :40, kernel :22): the zero-stuffed 2x upsample convolved
// with 2 * [1,4,6,4,1]/16 per axis, rows first, then columns, with
// cv::pyrUp's asymmetric border (index -1 -> 1, index n -> n-1). The
// output is exactly (2Hc, 2Wc). It is the reference-mode inter-level
// upsample of flow/pyramid_loop.py.
//
// Bound on the H100: memory. Per coarse pixel and plane it reads 4 B and
// writes 16 B for 24 operations (about 1 per byte, against the card's 20);
// for (u, v) at 540^2 -> 1080^2, 2.33 MB in and 9.33 MB out take at least
// 3.48 us at 3.35 TB/s. Writes are 4/5 of the bytes.
//
// What held the first design back (one thread per coarse pixel): nine L1
// loads with border index arithmetic on every row and column, three
// vertically adjacent threads loading each coarse row, and two 8-byte
// stores a thread, which leave the store path half used. Design:
// - A thread owns two adjacent coarse columns and walks a strip of S coarse
//   rows. It loads the S+2 coarse rows the strip reads (4 values each: its
//   two columns and one either side) all at once, so each coarse row is
//   loaded once per thread and serves three output-row pairs.
// - Where Wc is even (every output row a multiple of 16 bytes), each output
//   row of the thread is one 16-byte store of 4 values, and a warp stores 512
//   contiguous bytes; the thread's own pair of each coarse row is one 8-byte
//   load. Where Wc is odd (135^2 -> 270^2), the rows start only
//   8-byte aligned: two 8-byte stores, the second dropped for the last
//   thread of a row, whose second column lies past the plane.
// - A warp whose coarse rows and columns lie inside the plane uses plain
//   indices; only a warp at an edge applies the border to its indices.
// - S follows the grid (pyrup_rows): 1 or 2 coarse rows, which won in A/B
//   timing on the card against taller strips at every upsample of the
//   path, as K1's short strips did.
//
// Bit for bit: the sums and products are those of ops/pyramid.py's _up_rows
// then _up_cols, in the same order; with -fmad=false the kernel equals its
// plain version, ops.pyramid.pyr_up, bit for bit.
#include <stdint.h>

#include <cuda_runtime.h>

namespace oft {
namespace {

constexpr float U0 = 0.125f, U1 = 0.5f, U2 = 0.75f, U3 = 0.5f, U4 = 0.125f;
constexpr int UL = 32;  // threads across a block: a warp of column pairs
constexpr int UNY = 4;  // warps of a block, stacked down the plane

// cv::pyrUp's border: -1 -> 1 (0 when the axis has one sample), n -> n-1
// (and anything past n, which feeds only outputs that are not stored).
__device__ __forceinline__ int up_border(int i, int n) {
  if (i < 0) return n > 1 ? 1 : 0;
  return i >= n ? n - 1 : i;
}

// The column pass (_up_cols) of one row-pass row e at coarse columns
// c0-1 .. c0+2, stored at output columns 2c0 .. 2c0+3 of `row`.
template <bool QUAD, bool EDGE>
__device__ __forceinline__ void store_cols(float* row, const float* e, bool second) {
  const float o0 = (U0 * e[0] + U2 * e[1]) + U4 * e[2], o1 = U1 * e[1] + U3 * e[2];
  const float o2 = (U0 * e[1] + U2 * e[2]) + U4 * e[3], o3 = U1 * e[2] + U3 * e[3];
  if (QUAD) {
    *reinterpret_cast<float4*>(row) = make_float4(o0, o1, o2, o3);
  } else {
    *reinterpret_cast<float2*>(row) = make_float2(o0, o1);
    if (!EDGE || second) *reinterpret_cast<float2*>(row + 2) = make_float2(o2, o3);
  }
}

// One thread: coarse rows [r0, r0+S) x columns c0, c0+1 of the Hc x Wc
// plane x -> output rows [2r0, 2r0+2S) x columns [2c0, 2c0+4) of y.
template <int S, bool QUAD, bool EDGE>
__device__ __forceinline__ void pyrup_strip(const float* __restrict__ x, float* __restrict__ y,
                                            int Hc, int Wc, int r0, int c0) {
  int col[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) col[k] = EDGE ? up_border(c0 - 1 + k, Wc) : c0 - 1 + k;
  float in[S + 2][4];  // coarse rows r0-1 .. r0+S
#pragma unroll
  for (int i = 0; i < S + 2; ++i) {
    const int r = EDGE ? up_border(r0 - 1 + i, Hc) : r0 - 1 + i;
    const float* p = x + (size_t)r * Wc;
    if (QUAD && !EDGE) {  // the thread's own pair as one 8-byte load
      const float2 own = __ldg(reinterpret_cast<const float2*>(p + c0));
      in[i][0] = __ldg(p + c0 - 1);
      in[i][1] = own.x;
      in[i][2] = own.y;
      in[i][3] = __ldg(p + c0 + 2);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) in[i][k] = __ldg(p + col[k]);
    }
  }
  const size_t Wo = 2 * (size_t)Wc;
  const bool second = c0 + 1 < Wc;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int r = r0 + i;
    if (EDGE && r >= Hc) break;
    // the row pass (_up_rows): even output row 2r and odd row 2r+1
    float ev[4], od[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ev[k] = (U0 * in[i][k] + U2 * in[i + 1][k]) + U4 * in[i + 2][k];
      od[k] = U1 * in[i + 1][k] + U3 * in[i + 2][k];
    }
    float* top = y + 2 * (size_t)r * Wo + 2 * c0;
    store_cols<QUAD, EDGE>(top, ev, second);
    store_cols<QUAD, EDGE>(top + Wo, od, second);
  }
}

template <int S, bool QUAD>
__global__ void __launch_bounds__(UL * UNY)
    pyrup_strip_kernel(const float* __restrict__ u, const float* __restrict__ v,
                       float* __restrict__ uo, float* __restrict__ vo, int B, int Hc, int Wc) {
  const int c0 = 2 * (blockIdx.x * UL + threadIdx.x);
  const int r0 = (blockIdx.y * UNY + threadIdx.y) * S;
  if (r0 >= Hc || c0 >= Wc) return;
  const int plane = blockIdx.z;  // u planes [0, B), v planes [B, 2B)
  const bool is_v = plane >= B;
  const size_t in_off = (size_t)(is_v ? plane - B : plane) * Hc * Wc;
  const float* x = (is_v ? v : u) + in_off;
  float* y = (is_v ? vo : uo) + in_off * 4;
  // the warp's coarse rows r0-1 .. r0+S and columns (first pair) -1 .. +64
  const int wc0 = 2 * blockIdx.x * UL;
  const bool inside = r0 >= 1 && r0 + S < Hc && wc0 >= 1 && wc0 + 2 * UL < Wc;
  if (inside)
    pyrup_strip<S, QUAD, false>(x, y, Hc, Wc, r0, c0);
  else
    pyrup_strip<S, QUAD, true>(x, y, Hc, Wc, r0, c0);
}

template <int S>
int launch_rows(const float* u, const float* v, float* uo, float* vo, int B, int Hc, int Wc,
                void* stream) {
  const dim3 block(UL, UNY);
  const dim3 grid(((Wc + 1) / 2 + UL - 1) / UL, (Hc + S * UNY - 1) / (S * UNY), 2 * B);
  // 16-byte stores (and 8-byte loads of a thread's pair): every output row
  // a multiple of 16 bytes, every input row of 8, planes aligned
  const bool quad = Wc % 2 == 0 && ((uintptr_t)uo | (uintptr_t)vo) % 16 == 0 &&
                    ((uintptr_t)u | (uintptr_t)v) % 8 == 0;
  if (quad)
    pyrup_strip_kernel<S, true><<<grid, block, 0, (cudaStream_t)stream>>>(u, v, uo, vo, B, Hc, Wc);
  else
    pyrup_strip_kernel<S, false><<<grid, block, 0, (cudaStream_t)stream>>>(u, v, uo, vo, B, Hc, Wc);
  return (int)cudaGetLastError();
}

// The strip height: 2 coarse rows where that grid still gives every SM at
// least UP_WARPS_PER_SM warps (540^2 -> 1080^2), else 1.
constexpr int UP_WARPS_PER_SM = 24;

int pyrup_rows(int B, int Hc, int Wc, int sms) {
  const long across = ((Wc + 1) / 2 + UL - 1) / UL;
  return across * ((Hc + 1) / 2) * 2 * B >= (long)UP_WARPS_PER_SM * sms ? 2 : 1;
}

}  // namespace
}  // namespace oft

extern "C" int oft_pyrup(const float* u, const float* v, float* uo, float* vo, int B, int Hc,
                         int Wc, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (oft::pyrup_rows(B, Hc, Wc, sms) == 2)
    return oft::launch_rows<2>(u, v, uo, vo, B, Hc, Wc, stream);
  return oft::launch_rows<1>(u, v, uo, vo, B, Hc, Wc, stream);
}
