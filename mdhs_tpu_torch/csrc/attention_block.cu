// BERT attention sublayer for Hopper:
//
//     out = LayerNorm(x + MHA(x @ Wqkv^T + bqkv; bias) @ Wo^T + bo)
//
// Replaces the Pallas TPU kernel mdhs_tpu/ops/attention_block.py::_impl
// (pl.pallas_call at :110), at the numerics of its _kernel (:46-97):
//   - qkv = x @ Wqkv accumulated in float32, bqkv added in float32, rounded to bf16;
//   - scores in float32 = q . k * sm_scale + bias[b, key];
//   - float32 max-subtracted softmax, probabilities rounded to bf16;
//   - ctx = probs @ v accumulated in float32, rounded to bf16;
//   - y = x + ctx @ Wo + bo in float32, LayerNorm with float32 statistics, out bf16.
// Queries at padded positions are computed and attend to the real keys, as
// in the JAX package and HF.
//
// Design. The TPU kernel keeps Wqkv/Wo resident in 16 MB of VMEM and walks a
// sequential grid over the batch. A Hopper block has at most 227 KB of shared
// memory and blocks run in parallel, so the sublayer is three launches:
//   1. launch_gemm_bias: qkv[B*L, 3*HD] = x @ Wqkv^T + bqkv (gemm.cu);
//   2. attention_kernel: one block per (query tile of 64, head, batch row),
//      with Q, K, V, the float32 scores and the bf16 probabilities of the tile
//      all in shared memory; the scores never reach device memory;
//   3. launch_gemm_residual_ln: out = LN(x + ctx @ Wo^T + bo) (gemm.cu).
// qkv (B*L x 3*HD bf16) and ctx (B*L x HD bf16) go through device memory
// between the launches; the wrapper allocates them. Fusing them away with
// wgmma and TMA is later work.
//
// What bounds it on the H100: the projections are compute-bound GEMMs; the
// attention core is small (2*L*D FLOPs per score) and reads K and V once per
// query tile, so at L <= 256 it is bounded by launch count and the
// shared-memory footprint (one or two blocks per SM), not by HBM.
#include "common.cuh"

namespace mdhs {
namespace {

namespace at {
constexpr int QT = 64;        // query rows per block, 16 per warp
constexpr int THREADS = 128;  // 4 warps
}  // namespace at

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory plan of one attention block. Mirrored in Python by
// mdhs_tpu_torch/ops/attention_block.py::_smem_bytes (the supports() gate).
struct AttnPlan {
  int Lp, Dp;          // L and D rounded up to the 16 of a fragment
  int ldk, lds, ldp;   // pitches: Q/K/V (bf16), scores (float32), probs (bf16)
  size_t q_off, k_off, v_off, s_off, p_off, bytes;
};

__host__ __device__ inline AttnPlan attn_plan(int L, int D) {
  AttnPlan p;
  p.Lp = (L + 15) / 16 * 16;
  p.Dp = (D + 15) / 16 * 16;
  p.ldk = p.Dp + 8;
  p.lds = (p.Lp > p.Dp ? p.Lp : p.Dp) + 4;
  p.ldp = p.Lp + 8;
  p.q_off = 0;
  p.k_off = align128(p.q_off + size_t(at::QT) * p.ldk * sizeof(bf16));
  p.v_off = align128(p.k_off + size_t(p.Lp) * p.ldk * sizeof(bf16));
  p.s_off = align128(p.v_off + size_t(p.Lp) * p.ldk * sizeof(bf16));
  p.p_off = align128(p.s_off + size_t(at::QT) * p.lds * sizeof(float));
  p.bytes = align128(p.p_off + size_t(at::QT) * p.ldp * sizeof(bf16));
  return p;
}

// grid = (ceil(L / 64), num_heads, B). qkv rows are [q | k | v], head h at
// columns h*D .. h*D + D of each third. bias is (B, L) float32, additive.
__global__ void __launch_bounds__(at::THREADS)
    attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                     bf16* __restrict__ ctx, int L, int HD, int D, float sm_scale) {
  using namespace at;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const AttnPlan sp = attn_plan(L, D);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + sp.q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + sp.k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + sp.v_off);
  float* S = reinterpret_cast<float*>(smem_raw + sp.s_off);
  bf16* P = reinterpret_cast<bf16*>(smem_raw + sp.p_off);

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row_stride = 3 * size_t(HD);
  const bf16* base = qkv + size_t(b) * L * row_stride + size_t(h) * D;
  const int cpr = sp.Dp / 8;  // 16-byte chunks per shared-memory row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Q tile and the whole K, V of this head; rows past L and columns past D
  // are zero, so the padded fragments add nothing to any product.
  for (int i = tid; i < QT * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * 8;
    uint4 v = zero;
    if (q0 + r < L && c < D) v = *reinterpret_cast<const uint4*>(base + size_t(q0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(Qs + r * sp.ldk + c) = v;
  }
  for (int i = tid; i < sp.Lp * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * 8;
    uint4 kv = zero, vv = zero;
    if (r < L && c < D) {
      const bf16* src = base + size_t(r) * row_stride + c;
      kv = *reinterpret_cast<const uint4*>(src + HD);
      vv = *reinterpret_cast<const uint4*>(src + 2 * HD);
    }
    *reinterpret_cast<uint4*>(Ks + r * sp.ldk + c) = kv;
    *reinterpret_cast<uint4*>(Vs + r * sp.ldk + c) = vv;
  }
  __syncthreads();

  // From here each warp works on its own 16 query rows only.
  const int r0 = warp * 16;

  // scores = Q K^T (float32 accumulate) -> S
  for (int j = 0; j < sp.Lp / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < sp.Dp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(a, Qs + r0 * sp.ldk + kk, sp.ldk);
      wmma::load_matrix_sync(kb, Ks + (16 * j) * sp.ldk + kk, sp.ldk);
      wmma::mma_sync(acc, a, kb, acc);
    }
    wmma::store_matrix_sync(S + r0 * sp.lds + 16 * j, acc, sp.lds, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax over the L real keys, in float32; probabilities rounded to bf16
  const float* brow = bias + size_t(b) * L;
  for (int r = r0; r < r0 + 16; ++r) {
    float* srow = S + r * sp.lds;
    float m = -FLT_MAX;
    for (int c = lane; c < L; c += 32) {
      const float s = srow[c] * sm_scale + brow[c];
      srow[c] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int c = lane; c < L; c += 32) {
      const float e = expf(srow[c] - m);
      srow[c] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    bf16* prow = P + r * sp.ldp;
    for (int c = lane; c < sp.Lp; c += 32) prow[c] = __float2bfloat16_rn(c < L ? srow[c] * inv : 0.0f);
  }
  __syncwarp();

  // ctx = P V (float32 accumulate) -> back into this warp's rows of S
  for (int n = 0; n < sp.Dp / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < sp.Lp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
      wmma::load_matrix_sync(a, P + r0 * sp.ldp + kk, sp.ldp);
      wmma::load_matrix_sync(vb, Vs + kk * sp.ldk + 16 * n, sp.ldk);
      wmma::mma_sync(acc, a, vb, acc);
    }
    wmma::store_matrix_sync(S + r0 * sp.lds + 16 * n, acc, sp.lds, wmma::mem_row_major);
  }
  __syncwarp();

  const int cpo = D / 8;
  for (int i = lane; i < 16 * cpo; i += 32) {
    const int r = i / cpo, c = (i % cpo) * 8;
    const int q = q0 + r0 + r;
    if (q < L) {
      const float* src = S + (r0 + r) * sp.lds + c;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = src[e];
      store8(ctx + (size_t(b) * L + q) * HD + size_t(h) * D + c, v);
    }
  }
}

}  // namespace

cudaError_t launch_attention(const bf16* qkv, const float* bias, bf16* ctx, int B, int L, int HD,
                             int num_heads, float sm_scale, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || num_heads <= 0 || HD % num_heads != 0) return cudaErrorInvalidValue;
  const int D = HD / num_heads;
  if (D % 8 != 0) return cudaErrorInvalidValue;
  const AttnPlan sp = attn_plan(L, D);
  if (sp.bytes > kMaxSmemPerBlock) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sp.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + at::QT - 1) / at::QT, num_heads, B);
  attention_kernel<<<grid, at::THREADS, sp.bytes, stream>>>(qkv, bias, ctx, L, HD, D, sm_scale);
  return cudaGetLastError();
}

}  // namespace mdhs

// x, out: (B*L, HD) bf16; wqkv: (3*HD, HD) bf16 = [Wq; Wk; Wv] in nn.Linear
// layout; bqkv: (3*HD,); wo: (HD, HD); bo, gamma, beta: (HD,); bias: (B, L)
// float32; qkv: (B*L, 3*HD) and ctx: (B*L, HD) bf16 scratch. Returns the
// first CUDA error of the three launches, or 0.
extern "C" int attention_block_forward(const void* x, const void* wqkv, const void* bqkv,
                                       const void* wo, const void* bo, const void* gamma,
                                       const void* beta, const void* bias, void* qkv, void* ctx,
                                       void* out, int B, int L, int HD, int num_heads,
                                       float sm_scale, float ln_eps, void* stream) {
  using mdhs::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  cudaError_t err = mdhs::launch_gemm_bias(mdhs::kBias, static_cast<const bf16*>(x),
                                           static_cast<const bf16*>(wqkv),
                                           static_cast<const bf16*>(bqkv), static_cast<bf16*>(qkv),
                                           M, 3 * HD, HD, s);
  if (err != cudaSuccess) return err;
  err = mdhs::launch_attention(static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
                               static_cast<bf16*>(ctx), B, L, HD, num_heads, sm_scale, s);
  if (err != cudaSuccess) return err;
  return mdhs::launch_gemm_residual_ln(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<bf16*>(out), M, HD, HD, ln_eps, s);
}
