// Shared device helpers and the GEMM launchers used by the sublayer kernels.
//
// Every kernel here is bf16 in, bf16 out, with float32 accumulation on the
// tensor cores through WMMA 16x16x16 fragments (sm_80+ bf16 mma). Weights are
// in PyTorch's nn.Linear layout, W[out, in], so a weight tile read row by row
// from device memory is the col-major B operand of x @ W^T.
#pragma once

#include <cfloat>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace mdhs {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Largest dynamic shared memory one block may opt into on sm_90 (227 KB).
constexpr size_t kMaxSmemPerBlock = 232448;

// ---------------------------------------------------------------------------
// cp.async (sm_80+): 16-byte global -> shared copies that bypass registers.
// With pred == false the 16 destination bytes are zero-filled and the source
// is not read (src-size 0), which masks the ragged edge of a tile.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr, bool pred) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(gmem_ptr),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Epilogues of launch_gemm_bias, applied to the float32 accumulator plus bias
// before the one rounding to bf16.
enum Epilogue : int { kBias = 0, kBiasGeluErf = 1, kBiasGeluTanh = 2 };

// C[M, N] = epi(A[M, K] @ W[N, K]^T + bias[N]).
// Needs N % 128 == 0 and K % 32 == 0; M is any positive count (masked).
cudaError_t launch_gemm_bias(int epilogue, const bf16* A, const bf16* W, const bf16* bias, bf16* C,
                             int M, int N, int K, cudaStream_t stream);

// out[M, N] = LayerNorm(resid + A[M, K] @ W[N, K]^T + bias) * gamma + beta,
// with float32 row statistics. Needs N % 128 == 0, N <= 1024, K % 32 == 0.
cudaError_t launch_gemm_residual_ln(const bf16* A, const bf16* W, const bf16* bias,
                                    const bf16* resid, const bf16* gamma, const bf16* beta,
                                    bf16* out, int M, int N, int K, float eps,
                                    cudaStream_t stream);

// The attention core of attention_block.cu: ctx[B*L, HD] bf16 from the packed
// qkv[B*L, 3*HD] bf16 and the (B, L) float32 key bias; the whole L of one head
// sits in shared memory (the supports() gate of ops/attention_block.py).
cudaError_t launch_attention(const bf16* qkv, const float* bias, bf16* ctx, int B, int L, int HD,
                             int num_heads, float sm_scale, cudaStream_t stream);

// ---------------------------------------------------------------------------
// The int8 (a8w8) row quantize, int8_gemm.cu. Quantization is symmetric absmax with
// round-half-to-even (rintf), as mdhs_tpu/ops/quant_kernel.py::_rowquant_f32:
//   scale = max(absmax, 1e-8) * float32(1/127);  q = clip(rint(x / scale), -127, 127)
// ---------------------------------------------------------------------------

// q[M, K] int8 and scale[M] float32 from the rows of x[M, K]. Needs K % 8 == 0.
cudaError_t launch_row_quantize(const bf16* x, int8_t* q, float* scale, int M, int K,
                                cudaStream_t stream);

}  // namespace mdhs
