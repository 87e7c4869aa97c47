// BERT FFN sublayer for Hopper:
//
//     h   = GELU(x @ W1^T + b1)              (on the float32 accumulator)
//     out = LayerNorm(x + h @ W2^T + b2)     (float32 statistics)
//
// Replaces the Pallas TPU kernel mdhs_tpu/ops/ffn_block.py::_impl
// (pl.pallas_call at :80). act 0 is erf-GELU through CUDA's erff (the JAX
// kernel's polynomial-tanh form is within one bf16 ulp of erf); act 1 is the
// tanh form of the fast_math preset (:45-50); both in ops/gelu.py's order of
// roundings (epi_sm90.cuh::gelu).
//
// Design: two products on the bf16 wgmma mainloop (bf16_gemm.cu on
// gemm_sm90.cuh), each on the plan the wrapper made (ops/bf16_gemm.py):
//   1. GEMM1: h = bf16(GELU(acc + b1)), its tile stored through shared memory
//      by TMA; 256-column tiles where they fill the card (N = 4096: 384 tiles),
//      else 128;
//   2. GEMM2, K = Di: out = LN((x + acc) + b2) on clusters of H / 128 blocks that
//      merge their row statistics through distributed shared memory.
// Where either product's tiles would leave most SMs idle (batch 1: N = 128 is
// 24 GEMM1 tiles and 6 GEMM2 blocks), it splits K into float32 partial tiles
// and a row pass (bf16_gemm.cu's header says why). The (N, Di) bf16 h goes
// through device memory (the wrapper allocates it, and the workspace); the TPU
// kernel kept it in VMEM, and keeping it on chip is later work. Any row count N
// works: the tensor maps zero-fill the last row tile and the stores are masked.
//
// What bounds it on the H100: 4*N*H*Di bf16 operations against 2*H*Di weight bytes
// and 4*N*H bytes of x and out: at N = 4096 compute (0.039 ms), at N = 128 (batch
// 1) the 9.4 MB of weights (2.8 us).
#include "common.cuh"
#include "attention_sm90.cuh"

// x, out: (N, H) bf16; w1: (Di, H); b1: (Di,); w2: (H, Di); b2, gamma, beta: (H,),
// all bf16; h: (N, Di) bf16 scratch; work: the split-K workspace (float32, the larger
// product's splits * N * columns; null when neither splits). plan1, plan2: GEMM1's and
// GEMM2's (tile width, split count, cluster size). Returns the first CUDA error of the
// launches, or 0.
extern "C" int ffn_block_forward(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                 const void* gamma, const void* beta, void* h, void* work, void* out, int N, int H,
                                 int Di, float ln_eps, int act, int width1, int splits1, int cluster1, int width2,
                                 int splits2, int cluster2, void* stream) {
  using mdhs::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act != 0 && act != 1) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = mdhs::sm90::bind_device(&device);
  if (err != cudaSuccess) return err;
  float* ws = static_cast<float*>(work);
  err = mdhs::launch_bf16_tile_gemm(act + 1, static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                                    static_cast<const bf16*>(b1), static_cast<bf16*>(h), ws, N, Di, H, width1,
                                    splits1, cluster1, s);
  if (err != cudaSuccess) return err;
  return mdhs::launch_bf16_ln_gemm(static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
                                   static_cast<const bf16*>(b2), static_cast<const bf16*>(x),
                                   static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
                                   static_cast<bf16*>(out), ws, N, H, Di, ln_eps, width2, splits2, cluster2, s);
}
