// The int8 (a8w8) row quantize of int8_ffn_block.cu and int8_attention_block.cu
// (x before their first products, ctx before the attention block's output
// projection), the piece the TPU kernels ran inside one grid step on the VPU
// (mdhs_tpu/ops/quant_kernel.py::_rowquant_f32). The sublayers' s8 products run
// on the wgmma mainloop of gemm_sm90.cuh.
//
// What bounds it on the H100: it reads a bf16 row and writes its int8 values
// and one float32 scale, 3 bytes an element, at the memory rate.
#include "common.cuh"

namespace mdhs {
namespace {

// float32(1/127) as the JAX kernel spells it: jnp.float32(1.0 / 127.0), the
// double quotient rounded once to float32.
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

// ---------------------------------------------------------------------------
// row_quantize_kernel: one warp per row, 8 rows a block. The row is read
// twice (absmax, then quantize); the second read comes from L1/L2.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
    row_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                        int M, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const T* xr = x + size_t(row) * K;
  float m = 0.0f;
  for (int c = lane * 8; c < K; c += 256) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  m = warp_max(m);
  const float s = fmaxf(m, 1e-8f) * kInv127;
  int8_t* qr = q + size_t(row) * K;
  for (int c = lane * 8; c < K; c += 256) {
    float v[8];
    load8(xr + c, v);
    union { int8_t b[8]; uint2 u; } pack;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float r = fminf(fmaxf(rintf(v[e] / s), -127.0f), 127.0f);  // IEEE division, half to even
      pack.b[e] = static_cast<int8_t>(__float2int_rn(r));
    }
    *reinterpret_cast<uint2*>(qr + c) = pack.u;
  }
  if (lane == 0) scale[row] = s;
}

template <typename T>
cudaError_t row_quantize(const T* x, int8_t* q, float* scale, int M, int K, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0) return cudaErrorInvalidValue;
  row_quantize_kernel<T><<<(M + 7) / 8, 256, 0, stream>>>(x, q, scale, M, K);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_row_quantize(const bf16* x, int8_t* q, float* scale, int M, int K, cudaStream_t stream) {
  return row_quantize(x, q, scale, M, K, stream);
}

}  // namespace mdhs
