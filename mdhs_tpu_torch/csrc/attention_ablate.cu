// The fused attention core with one stage removed, for timing it stage by
// stage on Hopper:
//
//     full     ctx = bf16( bf16(softmax(q . k * sm_scale + bias)) @ v )   (fused_attention)
//     nomax    the softmax without the max subtraction: p = exp(s) / sum exp(s)
//     nosmax   no softmax: p = bf16(s), the score itself
//     nopv     no P V product: ctx's D columns of a head are the first D keys' bf16 p
//     aligned  every head reads (and writes) head 0's columns
//
// on q, k, v in the JAX layout (B, L, heads * D). Replaces the Pallas TPU
// kernel benchmarks/attention_ablate.py::make_kernel (pl.pallas_call at :67):
// the same five modes, the same order of roundings (float32 scores,
// probabilities normalised and then rounded to the input type, float32 P V,
// ctx rounded). The numerics of every mode but full are wrong on purpose.
//
// Design. Each mode is a compile-time variant of the Hopper mainloop that
// fused_attention runs, attention_sm90<NC, kFused, ABL> (attention_sm90.cuh:
// its header comment lists what each ABL changes), so a mode's time minus
// full's is the cost of the removed stage in the production kernel, not in
// another kernel: full is the kFull instantiation, the same code as
// fused_attention_kernel, and gives its bits. One __global__ kernel per
// (NC, mode); attention_ablate_forward selects it by the mode's index.
//
// What bounds it on the H100, at the TPU script's shape (B 256, L 128, 12
// heads of 64, bf16): full, nomax and nosmax read q, k, v and the bias and
// write ctx, 201.5 MB (0.0601 ms at 3.35 TB/s), against 4 B heads L^2 D =
// 12.9 GFLOP of Q K^T and P V (0.0130 ms at 989 TFLOP/s): bytes. nopv reads
// no V and does no P V (151.1 MB, 6.4 GFLOP): bytes. aligned reads one head
// and writes D columns (16.9 MB) but computes all twelve: operations. At L
// 128 an item is one 128-key tile, so the persistent grid's Q double buffer
// and the ring running on between items carry the whole pipeline.
#include "attention_sm90.cuh"

namespace mdhs {
namespace {

template <int NC, int ABL>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    attention_ablate_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const uint32_t* __restrict__ bias,
                            bf16* __restrict__ ctx, float* m_out, float* l_out, int B, int L, int HD, int D,
                            float sm_scale) {
  sm90::attention_sm90<NC, sm90::kFused, ABL>(sm90::Args{&tq, &tk, &tv, bias, ctx, m_out, l_out, B, L, HD, D, sm_scale});
}

template <int ABL>
cudaError_t launch_mode(const void* q, const void* k, const void* v, const void* bias, void* ctx, int B, int L,
                        int HD, int num_heads, float sm_scale, void* stream) {
  return sm90::launch(attention_ablate_kernel<1, ABL>, attention_ablate_kernel<2, ABL>, q, k, v, bias, ctx, nullptr,
                      nullptr, B, L, HD, num_heads, sm_scale, stream);
}

}  // namespace
}  // namespace mdhs

// q, k, v, ctx: (B, L, HD) bf16 with HD = num_heads * D, D % 8 == 0, D <= 128;
// bias: (B, L) float32; mode: the index of full, nomax, nosmax, nopv, aligned
// (sm90::Ablate). aligned leaves ctx's columns past D unwritten. Returns the
// launch's CUDA error, or 0.
extern "C" int attention_ablate_forward(const void* q, const void* k, const void* v, const void* bias, void* ctx,
                                        int B, int L, int HD, int num_heads, float sm_scale, int mode,
                                        void* stream) {
  using namespace mdhs;
  switch (mode) {
    case sm90::kFull:
      return launch_mode<sm90::kFull>(q, k, v, bias, ctx, B, L, HD, num_heads, sm_scale, stream);
    case sm90::kNoMax:
      return launch_mode<sm90::kNoMax>(q, k, v, bias, ctx, B, L, HD, num_heads, sm_scale, stream);
    case sm90::kNoSmax:
      return launch_mode<sm90::kNoSmax>(q, k, v, bias, ctx, B, L, HD, num_heads, sm_scale, stream);
    case sm90::kNoPV:
      return launch_mode<sm90::kNoPV>(q, k, v, bias, ctx, B, L, HD, num_heads, sm_scale, stream);
    case sm90::kAligned:
      return launch_mode<sm90::kAligned>(q, k, v, bias, ctx, B, L, HD, num_heads, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
