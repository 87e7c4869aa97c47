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
// memory, each on a piece the port already has for Hopper:
//   1. row quantize x (int8_gemm.cu)          -> x_i8 (M, HD) int8, sx (M) float32
//   2. the QKV product on the s8 wgmma mainloop of gemm_sm90.cuh
//      (persistent grid, TMA ring, 128 x BN tiles: BN 256 where the tiles fill
//      the card, 128 at few rows, wide_tiles), its epilogue the plain version's
//      (float(acc) * sx) * sqkv + bqkv, each step rounded on its own, then bf16:
//      qkv is the plain version's bit for bit. The tile goes out through shared
//      memory and a TMA store, which runs on under the next tile's products;
//      stored from the registers, its 302 MB at the preset's shape held the
//      tensor cores idle for as long as the products took (PERF.md)
//                                              -> qkv (M, 3 HD) bf16
//   3. the attention core: the fused kind of attention_sm90.cuh's mainloop, the
//      kernel fused_attention.cu runs, with its tensor maps over the three
//      thirds of the packed qkv (rows 3 HD apart; head_map's pitch), so q, k and
//      v are never copied; fused_attention's bits on the same q, k, v
//                                              -> ctx (M, HD) bf16
//   4. row quantize ctx (its absmax spans all heads, which are other work items
//      of step 3)                              -> c_i8 (M, HD) int8, sc (M) float32
//   5. the output projection + residual + LayerNorm, the int8 FFN's GEMM2
//      epilogue (epi_sm90.cuh) with K = HD: clusters of HD / 128 blocks
//      merge their row statistics through distributed shared memory
//                                              -> out (M, HD) bf16
// The core's gate (ops/quant_kernel.py::attn_supports) takes 1 <= L <= 512, as
// fused_attention's; the projections take HD a multiple of 128 up to 1024.
//
// What bounds it on the H100: 8*M*HD*HD int8 operations for the projections
// (M = B*L) and 4*B*heads*L*L*D bf16 operations for the core; at B = 512,
// L = 128 that is 0.156 ms + 0.026 ms of tensor-core time, against 0.06 ms
// of memory time for x, out and the weights, so compute bounds the work. The
// qkv, ctx and int8 round trips through device memory are not in the bound.
#include "epi_sm90.cuh"

namespace mdhs {
namespace {

// The QKV product's epilogue: qkv = bf16((float(acc) * sx) * sqkv + bqkv), each step
// rounded on its own, the tile stored through shared memory by TMA (epi_sm90.cuh)
template <int BN_>
using QkvEpi = TileEpi<wg::S8, 0, BN_>;

template <int BN_>
__global__ void __launch_bounds__(wg::THREADS, wg::Cfg<BN_>::BLOCKS_PER_SM)
    attn_s8_qkv_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tout, QkvEpi<BN_> epi, int N, int K) {
  epi.tout = &tout;
  wg::gemm_sm90<wg::S8>(&ta, &tb, epi.M, N, K, epi);
  if (threadIdx.x % 128 == 0) bulk_wait();  // no block leaves before its stores are done
}

// fused_attention_kernel's code, over the packed qkv
template <int NC>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    int8_attention_core_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, const uint32_t* __restrict__ bias,
                               bf16* __restrict__ ctx, float* m_out, float* l_out, int B, int L, int HD, int D,
                               float sm_scale) {
  sm90::attention_sm90<NC, sm90::kFused>(sm90::Args{&tq, &tk, &tv, bias, ctx, m_out, l_out, B, L, HD, D, sm_scale});
}

__global__ void __launch_bounds__(wg::THREADS, wg::Cfg<BN>::BLOCKS_PER_SM)
    attn_s8_out_ln_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, LnEpi<wg::S8> epi,
                          int K) {
  wg::gemm_sm90<wg::S8>(&ta, &tb, epi.M, epi.H, K, epi);
}

}  // namespace
}  // namespace mdhs

// x, out: (B*L, HD) bf16; wqkv: (3*HD, HD) int8 = [Wq; Wk; Wv]; sqkv, bqkv:
// (3*HD,) float32; wo: (HD, HD) int8; so, bo, gamma, beta: (HD,) float32;
// bias: (B, L) float32; scratch x_q (B*L, HD) int8, sx (B*L,) float32, qkv
// (B*L, 3*HD) bf16, ctx (B*L, HD) bf16, c_q (B*L, HD) int8, sc (B*L,)
// float32. HD a multiple of 128 up to 1024, head_dim a multiple of 8 up to
// 128. Returns the first CUDA error of the five launches, or 0.
extern "C" int int8_attention_block_forward(const void* x, const void* wqkv, const void* sqkv,
                                            const void* bqkv, const void* wo, const void* so,
                                            const void* bo, const void* gamma, const void* beta,
                                            const void* bias, void* x_q, void* sx, void* qkv,
                                            void* ctx, void* c_q, void* sc, void* out, int B, int L,
                                            int HD, int num_heads, float sm_scale, float ln_eps,
                                            void* stream) {
  using mdhs::bf16;
  using mdhs::QkvEpi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || HD <= 0 || HD % 128 != 0 || HD > mdhs::kMaxCluster * mdhs::BN || num_heads <= 0 ||
      HD % num_heads != 0)
    return cudaErrorInvalidValue;
  const int M = B * L, N = 3 * HD;
  cudaError_t err = mdhs::launch_row_quantize(static_cast<const bf16*>(x), static_cast<int8_t*>(x_q),
                                              static_cast<float*>(sx), M, HD, s);
  if (err != cudaSuccess) return err;
  int device = 0;
  bool wide = false;
  if ((err = mdhs::sm90::bind_device(&device)) != cudaSuccess) return err;
  if ((err = mdhs::wide_tiles(M, N, &wide)) != cudaSuccess) return err;
  CUtensorMap tx, tc;
  if ((err = mdhs::wg::operand_map<mdhs::wg::S8>(&tx, x_q, M, HD, mdhs::wg::BM)) != cudaSuccess) return err;
  if ((err = mdhs::wg::operand_map<mdhs::wg::S8>(&tc, c_q, M, HD, mdhs::wg::BM)) != cudaSuccess) return err;
  const float* f_sx = static_cast<const float*>(sx);
  const float* f_sqkv = static_cast<const float*>(sqkv);
  const float* f_bqkv = static_cast<const float*>(bqkv);
  bf16* p_qkv = static_cast<bf16*>(qkv);
  err = wide ? mdhs::run_tile<mdhs::wg::S8>(mdhs::attn_s8_qkv_kernel<256>, tx, wqkv, qkv,
                                            QkvEpi<256>{f_sx, f_sqkv, f_bqkv, nullptr, M}, N, HD, s)
             : mdhs::run_tile<mdhs::wg::S8>(mdhs::attn_s8_qkv_kernel<128>, tx, wqkv, qkv,
                                            QkvEpi<128>{f_sx, f_sqkv, f_bqkv, nullptr, M}, N, HD, s);
  if (err != cudaSuccess) return err;
  // q, k and v are the thirds of each qkv row, its rows 3 HD apart
  err = mdhs::sm90::launch(mdhs::int8_attention_core_kernel<1>, mdhs::int8_attention_core_kernel<2>, p_qkv,
                           p_qkv + HD, p_qkv + 2 * HD, bias, ctx, nullptr, nullptr, B, L, HD, num_heads, sm_scale,
                           stream, N);
  if (err != cudaSuccess) return err;
  err = mdhs::launch_row_quantize(static_cast<const bf16*>(ctx), static_cast<int8_t*>(c_q),
                                  static_cast<float*>(sc), M, HD, s);
  if (err != cudaSuccess) return err;
  mdhs::LnEpi<mdhs::wg::S8> ln{};
  ln.sh = static_cast<const float*>(sc);
  ln.s2 = static_cast<const float*>(so);
  ln.b2 = static_cast<const float*>(bo);
  ln.gamma = static_cast<const float*>(gamma);
  ln.beta = static_cast<const float*>(beta);
  ln.x = static_cast<const bf16*>(x);
  ln.out = static_cast<bf16*>(out);
  ln.M = M;
  ln.H = HD;
  ln.eps = ln_eps;
  return mdhs::run_ln(mdhs::attn_s8_out_ln_kernel, tc, wo, ln, HD, s);
}
