// Multi-head attention core for Hopper, for sequences past attention_block's
// shared-memory gate:
//
//     ctx[b, q, h] = bf16( bf16(softmax_f32(q . k * sm_scale + bias[b, key])) @ v )
//
// on q, k, v in the JAX layout (B, L, heads * D), as separate tensors.
// Replaces the Pallas TPU kernel mdhs_tpu/ops/fused_attention.py::
// _fused_attention_impl (pl.pallas_call at :103), at the numerics of its
// _kernel (:55-89): float32 scores, float32 max-subtracted softmax,
// probabilities normalised and then rounded to bf16, float32 accumulation of
// the PV product, ctx rounded to bf16.
//
// Design. The TPU kernel keeps a head group's (G*L, L) float32 scores in
// VMEM; a Hopper block's 227 KB hold neither those nor a 64 x L float32
// score block next to a ring of K/V tiles at L = 512, so the keys stream
// through shared memory. The kernel is the Hopper mainloop of
// attention_sm90.cuh (a persistent grid over 128-query items, a TMA producer
// warp feeding a ring of 128-key K/V tiles, two consumer warpgroups on wgmma,
// P from registers), run in two passes over the keys, so that each
// probability is rounded to bf16 after it is normalised, exactly as the TPU
// kernel and the plain version round it:
//   pass 0 streams K alone: S = Q K^T, the running row max and row sum of
//          exp(s - max), rescaled when the max grows (float32, registers);
//   pass 1 streams K and V: S again, p = bf16(exp(s - max) / sum), and
//          ctx += P V in the wgmma accumulators.
// The key bias rides beside each tile (-inf past L: probability 0); queries
// past L are computed and not stored. Any L works; the wrapper's gate takes
// 1 <= L <= 512.
//
// What bounds it on the H100: 4*B*heads*L*L*D bf16 operations for QK^T and
// PV against 8*B*L*heads*D bytes of q, k, v and ctx (the bound counts each
// product once). At B = 32, L = 512, 12 heads of 64 that is 25.8 GFLOP (26 us
// at 989 TFLOP/s) and 100.7 MB (30 us at 3.35 TB/s): the bytes bound it. Pass
// 0 repeats Q K^T, 38.7 GFLOP in all, still 39 us of tensor-core time; the
// exponentials (two a score, one in each pass) and the row arithmetic on the
// CUDA cores are what the design leaves above the bound. K and V are read
// once per 128 queries (4 times at L = 512), mostly from L2.
#include "attention_sm90.cuh"

namespace mdhs {
namespace {

// A persistent grid over (128 queries, head, batch row) items. Head h of q, k,
// v is columns h*D .. h*D + D of each (B, L, HD) row. bias is (B, L) float32,
// additive.
template <int NC>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    fused_attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const uint32_t* __restrict__ bias,
                           bf16* __restrict__ ctx, float* m_out, float* l_out, int B, int L, int HD, int D, float sm_scale) {
  sm90::attention_sm90<NC, sm90::kFused>(sm90::Args{&tq, &tk, &tv, bias, ctx, m_out, l_out, B, L, HD, D, sm_scale});
}

}  // namespace
}  // namespace mdhs

// q, k, v, ctx: (B, L, HD) bf16 with HD = num_heads * D, D % 8 == 0, D <= 128;
// bias: (B, L) float32. Returns the launch's CUDA error, or 0.
extern "C" int fused_attention_forward(const void* q, const void* k, const void* v, const void* bias,
                                       void* ctx, int B, int L, int HD, int num_heads, float sm_scale,
                                       void* stream) {
  return mdhs::sm90::launch(mdhs::fused_attention_kernel<1>, mdhs::fused_attention_kernel<2>, q, k, v, bias, ctx,
                            nullptr, nullptr, B, L, HD, num_heads, sm_scale, stream);
}
