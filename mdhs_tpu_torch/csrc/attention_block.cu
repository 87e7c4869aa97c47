// BERT attention sublayer for Hopper:
//
//     out = LayerNorm(x + MHA(x @ Wqkv^T + bqkv; bias) @ Wo^T + bo)
//
// Replaces the Pallas TPU kernel mdhs_tpu/ops/attention_block.py::_impl
// (pl.pallas_call at :110), at the numerics of its _kernel (:46-97):
//   - qkv = x @ Wqkv accumulated in float32, bqkv added in float32, rounded to bf16;
//   - scores in float32 = q . k * sm_scale + bias[b, key];
//   - float32 max-subtracted softmax, probabilities normalised, then rounded to bf16;
//   - ctx = probs @ v accumulated in float32, rounded to bf16;
//   - y = x + ctx @ Wo + bo in float32, LayerNorm with float32 statistics, out bf16.
// Queries at padded positions are computed and attend to the real keys, as
// in the JAX package and HF.
//
// Design. The TPU kernel keeps Wqkv/Wo resident in 16 MB of VMEM and walks a
// sequential grid over the batch. Here the sublayer is three launches on pieces
// the port already has for Hopper, the bf16 twins of int8_attention_block.cu's:
//   1. the QKV product on the bf16 wgmma mainloop (bf16_gemm.cu): qkv =
//      bf16(acc + bqkv), its tile stored through shared memory by TMA
//                                              -> qkv (B*L, 3*HD) bf16
//   2. the attention core: the fused kind of attention_sm90.cuh's mainloop (the
//      kernel fused_attention.cu runs), its tensor maps over the three thirds of
//      the packed qkv (rows 3 HD apart; head_map's pitch), so q, k and v are never
//      copied; two passes over the keys, so each probability is rounded after it
//      is normalised                          -> ctx (B*L, HD) bf16
//   3. the output projection + residual + LayerNorm, the FFN's LayerNorm GEMM with
//      K = HD: clusters of HD / 128 blocks merge their row statistics through
//      distributed shared memory              -> out (B*L, HD) bf16
// Each product runs on the plan the wrapper made (ops/bf16_gemm.py); at few rows
// (batch 1: 18 QKV tiles, 6 LayerNorm blocks) it splits K into float32 partial
// tiles and a row pass (bf16_gemm.cu's header says why), and then steps 1 and 3
// are two launches each. qkv, ctx and the workspace go through device memory; the
// wrapper allocates them.
//
// The gate (ops/attention_block.py::supports) is the route BERT took before this
// design: L up to 464 / 400 / 352 / 320 / 288 / 256 / 240 / 224 at head_dim 8-16,
// 24-32, ..., 120-128, the lengths whose score tile fit the old kernel's shared
// memory, so seq 512 stays on fused_attention as JAX routes it. The core itself
// takes 1 <= L <= 512 and head_dim <= 128 (fused_attention's gate).
//
// What bounds it on the H100: 8*M*HD*HD bf16 operations for the projections
// (M = B*L) and 4*B*heads*L*L*D for the core; at B = 32, L = 128 that is 0.021 ms
// of tensor-core time against 0.0052 ms of memory time for x, out and the weights,
// so compute bounds the work. The qkv and ctx round trips are not in the bound.
#include "attention_sm90.cuh"

namespace mdhs {
namespace {

// fused_attention_kernel's code, over the packed qkv
template <int NC>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    attention_block_core_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const uint32_t* __restrict__ bias,
                                bf16* __restrict__ ctx, float* m_out, float* l_out, int B, int L, int HD, int D,
                                float sm_scale) {
  sm90::attention_sm90<NC, sm90::kFused>(sm90::Args{&tq, &tk, &tv, bias, ctx, m_out, l_out, B, L, HD, D, sm_scale});
}

}  // namespace
}  // namespace mdhs

// x, out: (B*L, HD) bf16; wqkv: (3*HD, HD) bf16 = [Wq; Wk; Wv] in nn.Linear
// layout; bqkv: (3*HD,); wo: (HD, HD); bo, gamma, beta: (HD,); bias: (B, L)
// float32; qkv: (B*L, 3*HD) and ctx: (B*L, HD) bf16 scratch; work: the split-K
// workspace (float32, the larger product's splits * B*L * columns; null when
// neither splits). plan1, plan2: the QKV product's and the output projection's (tile
// width, split count, cluster size). HD a multiple of 128 up to 1024, head_dim a
// multiple of 8 up to 128. Returns the first CUDA error of the launches, or 0.
extern "C" int attention_block_forward(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                                       const void* bo, const void* gamma, const void* beta, const void* bias,
                                       void* qkv, void* ctx, void* work, void* out, int B, int L, int HD,
                                       int num_heads, float sm_scale, float ln_eps, int width1, int splits1,
                                       int cluster1, int width2, int splits2, int cluster2, void* stream) {
  using mdhs::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || num_heads <= 0 || HD % num_heads != 0) return cudaErrorInvalidValue;
  const int M = B * L, N = 3 * HD;
  int device = 0;
  cudaError_t err = mdhs::sm90::bind_device(&device);
  if (err != cudaSuccess) return err;
  float* ws = static_cast<float*>(work);
  bf16* p_qkv = static_cast<bf16*>(qkv);
  err = mdhs::launch_bf16_tile_gemm(0, static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
                                    static_cast<const bf16*>(bqkv), p_qkv, ws, M, N, HD, width1, splits1, cluster1,
                                    s);
  if (err != cudaSuccess) return err;
  // q, k and v are the thirds of each qkv row, its rows 3 HD apart
  err = mdhs::sm90::launch(mdhs::attention_block_core_kernel<1>, mdhs::attention_block_core_kernel<2>, p_qkv,
                           p_qkv + HD, p_qkv + 2 * HD, bias, ctx, nullptr, nullptr, B, L, HD, num_heads, sm_scale,
                           stream, N);
  if (err != cudaSuccess) return err;
  return mdhs::launch_bf16_ln_gemm(static_cast<const bf16*>(ctx), static_cast<const bf16*>(wo),
                                   static_cast<const bf16*>(bo), static_cast<const bf16*>(x),
                                   static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
                                   static_cast<bf16*>(out), ws, M, HD, HD, ln_eps, width2, splits2, cluster2, s);
}
