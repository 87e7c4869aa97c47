// int8 (a8w8) BERT attention sublayer for Hopper:
//
//     x_i8, sx = rowquant(x)
//     qkv      = bf16(float(x_i8 @ Wqkv_i8^T) * sx * sqkv + bqkv)
//     ctx      = bf16(bf16(softmax_f32(q . k * sm_scale + bias)) @ v)   per head
//     c_i8, sc = rowquant(ctx)
//     out      = LayerNorm((x + float(c_i8 @ Wo_i8^T) * sc * so) + bo)
//
// Replaces the Pallas TPU kernel
// mdhs_tpu/ops/quant_kernel.py::int8_attention_block (pl.pallas_call at
// :230), at the numerics of its _attn_kernel (:147-207): qkv, probabilities
// and ctx rounded to bf16 where it rounds them (:170, :188, :195); scores,
// softmax, residual and LayerNorm in float32 (the softmax stays float32 under
// fast_math, as in the JAX int8 path). Wqkv_i8 (3*HD, HD) and Wo_i8 (HD, HD)
// are quantized once per output channel by the caller (ops/quant.py).
//
// Design. The TPU kernel keeps both int8 weights in VMEM and walks the batch
// one sequence per grid step. Here the sublayer is five launches over device
// memory: row quantize x, gemm_s8 with a bias epilogue (qkv, bf16), the
// attention core of attention_block.cu (one block per 64 queries, head and
// batch row, scores and probabilities in shared memory), row quantize ctx,
// and gemm_s8 with the residual + LayerNorm epilogue (int8_gemm.cu). The
// attention core takes any L whose tile fits the 227 KB of shared memory a
// block may use (L <= 320 at head_dim 64), so the preset's seq 256, which the
// TPU kernel's VMEM budget rejected (quant_kernel.py:311-315), runs here.
//
// What bounds it on the H100: 8*M*HD*HD int8 operations for the projections
// (M = B*L) and 4*B*heads*L*L*D bf16 operations for the core; at B = 512,
// L = 128 that is 0.156 ms + 0.026 ms of tensor-core time, against 0.06 ms
// of memory time for x, out and the weights, so compute bounds the work. The
// qkv, ctx and int8 round trips through device memory are not in the bound.
#include "common.cuh"

// x, out: (B*L, HD) bf16; wqkv: (3*HD, HD) int8 = [Wq; Wk; Wv]; sqkv, bqkv:
// (3*HD,) float32; wo: (HD, HD) int8; so, bo, gamma, beta: (HD,) float32;
// bias: (B, L) float32; scratch x_q (B*L, HD) int8, sx (B*L,) float32, qkv
// (B*L, 3*HD) bf16, ctx (B*L, HD) bf16, c_q (B*L, HD) int8, sc (B*L,)
// float32. Returns the first CUDA error of the five launches, or 0.
extern "C" int int8_attention_block_forward(const void* x, const void* wqkv, const void* sqkv,
                                            const void* bqkv, const void* wo, const void* so,
                                            const void* bo, const void* gamma, const void* beta,
                                            const void* bias, void* x_q, void* sx, void* qkv,
                                            void* ctx, void* c_q, void* sc, void* out, int B, int L,
                                            int HD, int num_heads, float sm_scale, float ln_eps,
                                            void* stream) {
  using mdhs::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  cudaError_t err = mdhs::launch_row_quantize(static_cast<const bf16*>(x), static_cast<int8_t*>(x_q),
                                              static_cast<float*>(sx), M, HD, s);
  if (err != cudaSuccess) return err;
  err = mdhs::launch_gemm_s8(mdhs::kBias, static_cast<const int8_t*>(x_q),
                             static_cast<const int8_t*>(wqkv), static_cast<const float*>(sx),
                             static_cast<const float*>(sqkv), static_cast<const float*>(bqkv),
                             static_cast<bf16*>(qkv), M, 3 * HD, HD, s);
  if (err != cudaSuccess) return err;
  err = mdhs::launch_attention(static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
                               static_cast<bf16*>(ctx), B, L, HD, num_heads, sm_scale, s);
  if (err != cudaSuccess) return err;
  err = mdhs::launch_row_quantize(static_cast<const bf16*>(ctx), static_cast<int8_t*>(c_q),
                                  static_cast<float*>(sc), M, HD, s);
  if (err != cudaSuccess) return err;
  return mdhs::launch_gemm_s8_residual_ln(
      static_cast<const int8_t*>(c_q), static_cast<const int8_t*>(wo), static_cast<const float*>(sc),
      static_cast<const float*>(so), static_cast<const float*>(bo), static_cast<const bf16*>(x),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<bf16*>(out), M, HD,
      HD, ln_eps, s);
}
