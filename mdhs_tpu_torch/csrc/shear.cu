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
// the card: each thread computes one output element from one gather of two
// neighbours.
//
// Bit-exact against mdhs_tpu/ops/augment.py::_shear_w and the plain version
// (ops/shear.py::shear_reference): 1 - f, both products and the sum are each
// rounded on their own (__fsub_rn, __fmul_rn, __fadd_rn), so nvcc cannot
// contract the lerp into an FMA.
//
// What bounds it on the H100: bytes. It reads the padded input once and writes
// the output once, with three float operations an element. Threads run along r,
// the contiguous axis (a warp is 32 consecutive r of one output row v), so loads
// and stores are coalesced; the input rows a warp reads differ only where s
// steps, once every 1/|d'| lanes (|d'| = tan(th/2) or sin(th) < 1 pixel per
// row), so a warp touches a few row segments.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // r per block row (one warp)
constexpr int kRows = 8;    // output rows v per block

__global__ void __launch_bounds__(kLanes * kRows)
    shear_sublane_kernel(const float* __restrict__ x, const float* __restrict__ d,
                         float* __restrict__ out, int C, int S, int L, int W, int pad) {
  const int r = blockIdx.x * kLanes + threadIdx.x;
  const int v = blockIdx.y * kRows + threadIdx.y;
  if (r >= L || v >= W) return;
  const long long bc = blockIdx.z;  // b * C + c
  const int b = static_cast<int>(bc / C);
  const float dr = d[static_cast<long long>(b) * L + r];
  const float d0 = floorf(dr);
  const float f = __fsub_rn(dr, d0);
  const int s = min(max(pad + static_cast<int>(d0), 0), 2 * pad - 1);
  const float* src = x + (bc * S + v + s) * L + r;
  const float lo = src[0];
  const float hi = src[L];
  out[(bc * W + v) * L + r] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), lo), __fmul_rn(f, hi));
}

}  // namespace

extern "C" int shear_sublane_forward(const void* x, const void* d, void* out, int B, int C, int S,
                                     int L, int pad, void* stream) {
  const int W = S - 2 * pad;
  if (B <= 0 || C <= 0 || L <= 0 || pad <= 0 || W <= 0) return cudaErrorInvalidValue;
  const long long planes = static_cast<long long>(B) * C;
  if (planes > 65535 || (W + kRows - 1) / kRows > 65535) return cudaErrorInvalidValue;
  const dim3 block(kLanes, kRows);
  const dim3 grid((L + kLanes - 1) / kLanes, (W + kRows - 1) / kRows, static_cast<unsigned>(planes));
  shear_sublane_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(d), static_cast<float*>(out), C, S, L,
      W, pad);
  return cudaGetLastError();
}
