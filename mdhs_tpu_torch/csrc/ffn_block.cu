// BERT FFN sublayer for Hopper:
//
//     h   = GELU(x @ W1^T + b1)              (on the float32 accumulator)
//     out = LayerNorm(x + h @ W2^T + b2)     (float32 statistics)
//
// Replaces the Pallas TPU kernel mdhs_tpu/ops/ffn_block.py::_impl
// (pl.pallas_call at :80). act 0 is erf-GELU through CUDA's erff (the JAX
// kernel's polynomial-tanh form is within one bf16 ulp of erf); act 1 is the
// tanh form of the fast_math preset (:45-50).
//
// Design: two launches of the GEMMs in gemm.cu. The (N, Di) bf16
// intermediate h goes through device memory in this first version (the
// wrapper allocates it); the TPU kernel kept it in VMEM, and keeping it on
// chip is the later fusion PR's work. Any row count N works: the last row
// tile is masked, so batch-1 requests run here too (the TPU gate's
// n_rows >= 1024 floor was about its DMA pipelining and does not apply).
//
// What bounds it on the H100: 4*N*H*Di FLOPs against ~2*H*Di weight bytes
// plus 2*N*Di bytes of intermediate traffic each way, so at N = 4096 it is
// compute-bound; at N = 128 (batch 1) it is bound by reading the 9.4 MB of
// bf16 weights.
#include "common.cuh"

extern "C" int ffn_block_forward(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, const void* gamma, const void* beta, void* h,
                                 void* out, int N, int H, int Di, float ln_eps, int act,
                                 void* stream) {
  using mdhs::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int epi;
  switch (act) {
    case 0: epi = mdhs::kBiasGeluErf; break;
    case 1: epi = mdhs::kBiasGeluTanh; break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = mdhs::launch_gemm_bias(epi, static_cast<const bf16*>(x),
                                           static_cast<const bf16*>(w1),
                                           static_cast<const bf16*>(b1), static_cast<bf16*>(h), N,
                                           Di, H, s);
  if (err != cudaSuccess) return err;
  return mdhs::launch_gemm_residual_ln(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<bf16*>(out), N, H, Di, ln_eps, s);
}
