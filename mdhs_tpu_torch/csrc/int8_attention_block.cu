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
//   2. the QKV product on the s8 wgmma mainloop of int8_gemm_sm90.cuh
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
//      epilogue (int8_ln_sm90.cuh) with K = HD: clusters of HD / 128 blocks
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
#include "int8_ln_sm90.cuh"

namespace mdhs {
namespace {

// ---- bulk (TMA) stores from shared memory, counted in bulk groups by the issuing thread
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// the thread's stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
// the thread's stores are complete
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// qkv = bf16((float(acc) * sx) * sqkv + bqkv), each step rounded on its own (the
// plain version's order; bias_dequant's arithmetic, here a column pair at a time so
// that no more than the accumulators stay live: no spills at 256 columns). Each
// warpgroup writes its 64 rows of the tile into shared memory as the
// 128-byte-swizzled boxes of the output's tensor map (64 columns x 64 rows; a quad's
// 16 bytes of a row land in the chunk the row's swizzle names, so a warp's 8 rows
// fill 32 banks), and one thread stores them with TMA: the writes leave the SM
// while the next tile's products run, and rows past M are clipped by the map.
template <int BN_>
struct QkvEpi {
  static constexpr bool kCluster = false;
  static constexpr int BN = BN_;
  static constexpr int kStages = BN_ == 128 ? 2 : 3;  // a ring stage fewer: room for the tile
  static constexpr uint32_t kExtra = 1024 + s8::BM * BN_ * 2;  // the tile in bf16, 1024-aligned
  const float *sx, *sw, *b;
  const CUtensorMap* tout;  // (M, N) bf16, box (64, 64), set by the kernel
  int M;
  float sa[2];
  uint32_t tile;  // shared-memory address of the staged tile
  __device__ void attach(unsigned char*, uint32_t extra_addr) { tile = (extra_addr + 1023) & ~1023u; }
  __device__ void init() {}
  __device__ void prefetch(const Tile& t, int tid) { load_rows(sa, sx, t, tid, M); }
  __device__ void operator()(int (&acc)[BN / 2], const Tile& t, int cw, int t128) {
    const Lane ln(t, cw, t128);
    const uint32_t half = tile + cw * (64 * BN * 2);  // the warpgroup's rows: BN / 64 boxes of 8 KB
    if (t128 == 0) bulk_wait_read();                  // the last tile's stores have read it
    sm90::named_barrier_sync(1 + cw, 128);
    const int r = 16 * (t128 >> 5) + ((t128 & 31) >> 2);  // rows r, r + 8 of the warpgroup's 64
    const uint32_t row0 = half + r * 128 + 4 * ln.qd, x = (r & 7) << 4;  // row r + 8: 1024 bytes on, same swizzle
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = t.n0 + 8 * j + 2 * ln.qd;
      const float2 w = *reinterpret_cast<const float2*>(sw + col);
      const float2 bb = *reinterpret_cast<const float2*>(b + col);
      const uint32_t a = row0 + (j / 8) * 8192 + (((j % 8) << 4) ^ x);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        st_shared(a + 1024 * i,
                  sm90::pack_bf16(__fadd_rn(dequant(acc[4 * j + 2 * i], sa[i], w.x), bb.x),
                                  __fadd_rn(dequant(acc[4 * j + 2 * i + 1], sa[i], w.y), bb.y)));
    }
    sm90::fence_proxy_async();  // the writes, visible to the bulk copy
    sm90::named_barrier_sync(1 + cw, 128);
    if (t128 == 0) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) tma_store_2d(tout, half + c * 8192, t.n0 + 64 * c, t.m0 + 64 * cw);
      bulk_commit();
    }
  }
};

template <int BN_>
__global__ void __launch_bounds__(s8::THREADS, s8::Cfg<BN_>::BLOCKS_PER_SM)
    attn_s8_qkv_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tout, QkvEpi<BN_> epi, int N, int K) {
  epi.tout = &tout;
  s8::gemm_s8_sm90(&ta, &tb, epi.M, N, K, epi);
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

__global__ void __launch_bounds__(s8::THREADS, s8::Cfg<BN>::BLOCKS_PER_SM)
    attn_s8_out_ln_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, LnEpi epi,
                          int K) {
  s8::gemm_s8_sm90(&ta, &tb, epi.M, epi.H, K, epi);
}

// 2-D map over the (M, N) bf16 qkv, box (64 columns, 64 rows), 128-byte swizzle
cudaError_t qkv_map(CUtensorMap* map, void* qkv, int M, int N) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qkv, dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the QKV product on BN_-column tiles: x_i8 (M, K) by tx, W (N, K), qkv (M, N)
template <int BN_>
cudaError_t run_qkv(const CUtensorMap& tx, const void* wqkv, void* qkv, const QkvEpi<BN_>& epi, int N, int K,
                    cudaStream_t stream) {
  using C = s8::Cfg<BN_, QkvEpi<BN_>::kStages>;
  constexpr uint32_t bytes = C::smem_bytes(QkvEpi<BN_>::kExtra);
  static_assert(bytes * C::BLOCKS_PER_SM + 1024 * C::BLOCKS_PER_SM <= 233472, "attn_s8_qkv_kernel's shared memory");
  CUtensorMap tw, tout;
  cudaError_t err = s8::s8_map(&tw, wqkv, N, K, BN_);
  if (err == cudaSuccess) err = qkv_map(&tout, qkv, epi.M, N);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_s8_qkv_kernel<BN_>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int tiles = (epi.M + s8::BM - 1) / s8::BM * (N / BN_), slots = C::BLOCKS_PER_SM * sms;
  attn_s8_qkv_kernel<BN_><<<tiles < slots ? tiles : slots, s8::THREADS, bytes, stream>>>(tx, tw, tout, epi, N, K);
  return cudaGetLastError();
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
  if ((err = mdhs::s8::s8_map(&tx, x_q, M, HD, mdhs::s8::BM)) != cudaSuccess) return err;
  if ((err = mdhs::s8::s8_map(&tc, c_q, M, HD, mdhs::s8::BM)) != cudaSuccess) return err;
  const float* f_sx = static_cast<const float*>(sx);
  const float* f_sqkv = static_cast<const float*>(sqkv);
  const float* f_bqkv = static_cast<const float*>(bqkv);
  bf16* p_qkv = static_cast<bf16*>(qkv);
  err = wide ? mdhs::run_qkv<256>(tx, wqkv, qkv, QkvEpi<256>{f_sx, f_sqkv, f_bqkv, nullptr, M}, N, HD, s)
             : mdhs::run_qkv<128>(tx, wqkv, qkv, QkvEpi<128>{f_sx, f_sqkv, f_bqkv, nullptr, M}, N, HD, s);
  if (err != cudaSuccess) return err;
  // q, k and v are the thirds of each qkv row, its rows 3 HD apart
  err = mdhs::sm90::launch(mdhs::int8_attention_core_kernel<1>, mdhs::int8_attention_core_kernel<2>, p_qkv,
                           p_qkv + HD, p_qkv + 2 * HD, bias, ctx, nullptr, nullptr, B, L, HD, num_heads, sm_scale,
                           stream, N);
  if (err != cudaSuccess) return err;
  err = mdhs::launch_row_quantize(static_cast<const bf16*>(ctx), static_cast<int8_t*>(c_q),
                                  static_cast<float*>(sc), M, HD, s);
  if (err != cudaSuccess) return err;
  mdhs::LnEpi ln{};
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
