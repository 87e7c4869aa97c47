// Per-row subpixel shear for Hopper, the core of the 3-shear rotation in the
// MIBF training augmentation (ops/augment.py::rotate_3shear):
//
//     out[b, c, v, r] = (1 - f) * x[b, c, v + s, r] + f * x[b, c, v + s + 1, r]
//     s = clip(pad + floor(d[b, r]), 0, 2*pad - 1),   f = d[b, r] - floor(d[b, r])
//
// x is (B, C, S, L) float32 with the shear axis S already zero-padded by pad on
// both sides; out is (B, C, S - 2*pad, L).
//
// Replaces the Pallas TPU kernel mdhs_tpu/ops/shear.py::shear_sublane
// (pl.pallas_call at :93). That kernel padded S to a multiple of 8 and walked
// a statically rotated VMEM copy of the plane over every shift in [0, 2*pad],
// because Mosaic has no dynamic sublane slice. Neither workaround applies on
// the card, where a thread may load any row it likes.
//
// Bit-exact against mdhs_tpu/ops/augment.py::_shear_w and the plain version
// (ops/shear.py::shear_reference): 1 - f, both products and the sum are each
// rounded on their own (__fsub_rn, __fmul_rn, __fadd_rn), so nvcc cannot
// contract the lerp into an FMA.
//
// What bounds it on the H100: bytes. It reads the padded input's W + 1 used
// rows once and writes the output once, with three float operations an
// element: 38.65 MB at (32, 3, 258, 224), 11.5 us at 3.35 TB/s.
//
// Design: a thread owns a column strip. It takes one r and kRows consecutive
// output rows v0 .. v0 + kRows, reads d[b, r] and works out s and f once, then
// issues all kRows + 1 loads of its column, x[v0 + s .. v0 + s + kRows], before
// any arithmetic, slides lo / hi through registers and writes kRows outputs
// with streaming stores (the output is not read again here). A warp is 32
// consecutive r of one strip: s changes by less than a pixel from lane to
// lane (|d'| = tan(th/2) or sin(th) < 1), so each of its loads touches one or
// two 128-byte segments of neighbouring rows, and each input row is fetched
// once by a thread rather than twice (one element's hi is the next one's lo).
// The ragged last strip (W not a multiple of kRows) is masked.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // r per warp
constexpr int kWarps = 4;   // strips per block, stacked along v
constexpr int kRows = 8;    // output rows v a thread owns

__device__ __forceinline__ float lerp(float lo, float hi, float f) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), lo), __fmul_rn(f, hi));
}

__global__ void __launch_bounds__(kLanes * kWarps)
    shear_sublane_kernel(const float* __restrict__ x, const float* __restrict__ d,
                         float* __restrict__ out, int C, int S, int L, int W, int pad) {
  const int r = blockIdx.x * kLanes + threadIdx.x;
  const int v0 = (blockIdx.y * kWarps + threadIdx.y) * kRows;
  if (r >= L || v0 >= W) return;
  const long long bc = blockIdx.z;  // b * C + c
  const int b = static_cast<int>(bc / C);
  const float dr = d[static_cast<long long>(b) * L + r];
  const float d0 = floorf(dr);
  const float f = __fsub_rn(dr, d0);
  const int s = min(max(pad + static_cast<int>(d0), 0), 2 * pad - 1);
  const float* src = x + (bc * S + v0 + s) * L + r;
  float* dst = out + (bc * W + v0) * L + r;
  float col[kRows + 1];
  if (v0 + kRows <= W) {
#pragma unroll
    for (int i = 0; i <= kRows; ++i) col[i] = src[static_cast<long long>(i) * L];
#pragma unroll
    for (int i = 0; i < kRows; ++i) __stcs(dst + static_cast<long long>(i) * L, lerp(col[i], col[i + 1], f));
  } else {
    // the last strip: rows v0 .. W - 1, which read input rows up to W + s <= S - 1
    const int n = W - v0;
#pragma unroll
    for (int i = 0; i <= kRows; ++i) col[i] = i <= n ? src[static_cast<long long>(i) * L] : 0.0f;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < n) __stcs(dst + static_cast<long long>(i) * L, lerp(col[i], col[i + 1], f));
  }
}

}  // namespace

extern "C" int shear_sublane_forward(const void* x, const void* d, void* out, int B, int C, int S,
                                     int L, int pad, void* stream) {
  const int W = S - 2 * pad;
  if (B <= 0 || C <= 0 || L <= 0 || pad <= 0 || W <= 0) return cudaErrorInvalidValue;
  const long long planes = static_cast<long long>(B) * C;
  constexpr int kBlockRows = kWarps * kRows;
  if (planes > 65535 || (W + kBlockRows - 1) / kBlockRows > 65535) return cudaErrorInvalidValue;
  const dim3 block(kLanes, kWarps);
  const dim3 grid((L + kLanes - 1) / kLanes, (W + kBlockRows - 1) / kBlockRows, static_cast<unsigned>(planes));
  shear_sublane_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(d), static_cast<float*>(out), C, S, L,
      W, pad);
  return cudaGetLastError();
}
