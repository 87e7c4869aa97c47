// Shared device helpers, and the launchers the sublayer sources call across files:
// the bf16 products (bf16_gemm.cu) and the int8 row quantize (int8_gemm.cu).
// Weights are in PyTorch's nn.Linear layout, W[out, in]: K-major, as the wgmma
// mainloop of gemm_sm90.cuh reads both operands.
#pragma once

#include <cfloat>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mdhs {

using bf16 = __nv_bfloat16;

// Largest dynamic shared memory one block may opt into on sm_90 (227 KB).
constexpr size_t kMaxSmemPerBlock = 232448;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 consecutive bf16 values <-> 8 floats, as one 16-byte access.
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// ---------------------------------------------------------------------------
// The bf16 sublayers' products on the wgmma mainloop (bf16_gemm.cu), each on the plan
// the wrapper made (ops/bf16_gemm.py): tile width, split count, cluster size. ``work`` is
// the split-K workspace, splits * M * N float32 (unused, and may be null, unsplit).
// K is a multiple of 64, N (or H) of 128; a plan the launcher cannot run returns
// cudaErrorInvalidValue.
// ---------------------------------------------------------------------------

// C[M, N] = bf16(act(A[M, K] @ W[N, K]^T + bias)), act 0 none, 1 erf-GELU, 2 tanh-GELU.
// Width 128 or 256; split only at width 128; cluster 1.
cudaError_t launch_bf16_tile_gemm(int act, const bf16* A, const bf16* W, const bf16* bias, bf16* C, float* work,
                                  int M, int N, int K, int width, int splits, int cluster, cudaStream_t stream);

// out[M, H] = LayerNorm((resid + A[M, K] @ W[H, K]^T) + bias) * gamma + beta, float32
// statistics. H <= 1024; width 128; unsplit, a cluster of H / 128 blocks; split, cluster 1.
cudaError_t launch_bf16_ln_gemm(const bf16* A, const bf16* W, const bf16* bias, const bf16* resid,
                                const bf16* gamma, const bf16* beta, bf16* out, float* work, int M, int H, int K,
                                float eps, int width, int splits, int cluster, cudaStream_t stream);

// ---------------------------------------------------------------------------
// The int8 (a8w8) row quantize, int8_gemm.cu. Quantization is symmetric absmax with
// round-half-to-even (rintf), as mdhs_tpu/ops/quant_kernel.py::_rowquant_f32:
//   scale = max(absmax, 1e-8) * float32(1/127);  q = clip(rint(x / scale), -127, 127)
// ---------------------------------------------------------------------------

// q[M, K] int8 and scale[M] float32 from the rows of x[M, K]. Needs K % 8 == 0.
cudaError_t launch_row_quantize(const bf16* x, int8_t* q, float* scale, int M, int K,
                                cudaStream_t stream);

}  // namespace mdhs
