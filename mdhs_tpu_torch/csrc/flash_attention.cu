// BERT's flash-attention core for Hopper: the forward, dK/dV and dQ kernels.
//
//     o[b, i, h] = bf16( sum_j bf16(exp(s_ij - m_i)) v_j / l_i ),
//     s_ij = (q_i . k_j) * sm_scale + (seg[b, i] == seg[b, j] ? 0 : MASK),
//     m_i = max_j s_ij,  l_i = sum_j exp(s_ij - m_i)            (float32)
//
// on q, k, v in the JAX layout (B, L, heads * D) with int32 segment ids
// (B, L), MASK = -0.7 * float32 max. Replaces the Pallas TPU kernels of
// jax.experimental.pallas.ops.tpu.flash_attention (jax 0.9.0) that
// mdhs_tpu/models/bert.py:196-213 calls under attention_impl="flash": the
// forward _flash_attention_impl (pl.pallas_call at :758, body
// _flash_attention_kernel_single_batch :342-482), _flash_attention_bwd_dkv
// (:1121, body :796-940) and _flash_attention_bwd_dq (:1456, body
// :1146-1286). The plain versions are mdhs_tpu_torch/ops/flash_attention.py.
//
// The forward is the Hopper mainloop of attention_sm90.cuh (128 queries a
// block, a TMA producer warp feeding a ring of 128-key K/V tiles and their
// segment ids, two consumer warpgroups on wgmma, P from registers) in one
// pass over the keys: per tile the online row max and sum in registers,
// p = exp(s - m_running) rounded to bf16, o = o * exp(m_prev - m_next) + P V
// in the wgmma accumulators; o / l at the end, and m, l written when the
// backward needs them. p is rounded relative to the running max, where the
// plain version rounds it relative to the final one (the same bf16 step
// either way).
//
// The backward is two kernels of the same shape (attention_bwd_sm90.cuh has
// the design): the dQ kernel, launched first, keeps 128 queries' Q, dO and O
// resident, takes di = rowsum(o * do) from them in its prologue and writes
// it, and streams K, V tiles; the dK/dV kernel keeps 128 keys' K and V
// resident and streams Q, dO tiles with each query's lse, di and segment id.
// Both make S and dP by wgmma from shared memory, p and ds in registers, and
// feed the bf16 P and dS back as register A operands; no atomics, so the
// gradients do not depend on the order the blocks run in.
//
// Masking: with the finite MASK a row whose keys in a tile all differ in
// segment takes them at p = exp(0) = 1 until a matching key raises the max;
// exp(m_prev - m_next) then underflows to 0 and wipes them, as the library's
// rescale does (-inf would give exp(-inf + inf) = NaN). Keys past L get
// p = 0; queries past L are computed on zero rows and not stored. Any L. The
// backward reads the final m, so its pairs across segments are exactly 0.
//
// What bounds it on the H100: the forward does 4*B*heads*L*L*D bf16
// operations against 8*B*L*heads*D bytes (q, k, v, o): at B = 32, L = 512, 12
// heads of 64 that is 26 us of tensor-core time and 30 us of memory time, so
// the bytes bound it; the exponential and the row arithmetic of each score
// on the CUDA cores are what its design leaves above that. The backward's
// five products (S, dP, dV, dK, dQ; S and dP are made in both backward
// kernels, seven in all) are 14*B*heads*L*L*D operations. Each backward kernel
// moves 2*B*L*heads*D bytes for each of six tensors (dQ: q, k, v, o, do read,
// dq written; dK/dV: q, k, v, do read, dk, dv written) and 4*B*heads*L for
// each of m, l and di (dQ writes di, dK/dV reads it): at B = 32, L = 256 that
// is 0.023 ms of bytes a kernel against 0.023 ms of tensor-core time for the
// pair, so the bytes bound both; at L = 512 the operations bound dK/dV. What
// the design leaves above that is, as in the forward, the exponential and the
// score arithmetic on the CUDA cores.

#include "attention_bwd_sm90.cuh"

namespace mdhs {
namespace {

// The forward: the persistent mainloop of attention_sm90.cuh in its one-pass
// form. seg is (B, L) int32; m_out and l_out are (B, heads, L) float32, or
// null when the backward does not need them.
template <int NC>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    flash_forward_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const uint32_t* __restrict__ seg,
                         bf16* __restrict__ out, float* m_out, float* l_out, int B, int L, int HD, int D, float sm_scale) {
  sm90::attention_sm90<NC, sm90::kFlash>(sm90::Args{&tq, &tk, &tv, seg, out, m_out, l_out, B, L, HD, D, sm_scale});
}

// The backward kernels, one signature for both (``to`` is read by dQ only, di is
// written by dQ and read by dK/dV); attention_bwd_sm90.cuh has the design.
template <int NC>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap to, const int* __restrict__ seg,
                        const float* __restrict__ m, const float* __restrict__ l, float* di, bf16* dq, bf16* dk,
                        bf16* dv, int B, int L, int HD, int D, float sm_scale) {
  sm90::bwd::flash_bwd_dq_sm90<NC>(
      sm90::bwd::BwdArgs{&tq, &tk, &tv, &tdo, &to, seg, m, l, di, dq, dk, dv, B, L, HD, D, sm_scale});
}

template <int NC>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap to, const int* __restrict__ seg,
                         const float* __restrict__ m, const float* __restrict__ l, float* di, bf16* dq, bf16* dk,
                         bf16* dv, int B, int L, int HD, int D, float sm_scale) {
  sm90::bwd::flash_bwd_dkv_sm90<NC>(
      sm90::bwd::BwdArgs{&tq, &tk, &tv, &tdo, &to, seg, m, l, di, dq, dk, dv, B, L, HD, D, sm_scale});
}

}  // namespace
}  // namespace mdhs

// q, k, v, out: (B, L, HD) bf16 with HD = num_heads * D, D % 8 == 0, D <= 128; seg:
// (B, L) int32; m, l: (B, num_heads, L) float32, written when not null. Each entry
// returns the launch's CUDA error, or 0.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, const void* seg, void* out,
                                       void* m, void* l, int B, int L, int HD, int num_heads, float sm_scale,
                                       void* stream) {
  if ((m == nullptr) != (l == nullptr)) return cudaErrorInvalidValue;
  return mdhs::sm90::launch(mdhs::flash_forward_kernel<1>, mdhs::flash_forward_kernel<2>, q, k, v, seg, out,
                            static_cast<float*>(m), static_cast<float*>(l), B, L, HD, num_heads, sm_scale, stream);
}

// dout, dk, dv: (B, L, HD) bf16; m, l, di: (B, num_heads, L) float32 (the
// forward's statistics and the di that flash_attention_bwd_dq wrote).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* seg, const void* m,
                                       const void* l, const void* dout, const void* di, void* dk, void* dv, int B,
                                       int L, int HD, int num_heads, float sm_scale, void* stream) {
  using mdhs::bf16;
  return mdhs::sm90::bwd::launch_bwd(
      mdhs::sm90::bwd::kDkv, mdhs::flash_bwd_dkv_kernel<1>, mdhs::flash_bwd_dkv_kernel<2>, q, k, v, dout, nullptr,
      static_cast<const int*>(seg), static_cast<const float*>(m), static_cast<const float*>(l),
      const_cast<float*>(static_cast<const float*>(di)), nullptr, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, L,
      HD, num_heads, sm_scale, stream);
}

// o, dout, dq: (B, L, HD) bf16; m, l: (B, num_heads, L) float32; di: (B, num_heads, L)
// float32, written: rowsum(o * dout) of each head.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* seg, const void* o,
                                      const void* m, const void* l, const void* dout, void* dq, void* di, int B, int L,
                                      int HD, int num_heads, float sm_scale, void* stream) {
  using mdhs::bf16;
  return mdhs::sm90::bwd::launch_bwd(
      mdhs::sm90::bwd::kDq, mdhs::flash_bwd_dq_kernel<1>, mdhs::flash_bwd_dq_kernel<2>, q, k, v, dout, o,
      static_cast<const int*>(seg), static_cast<const float*>(m), static_cast<const float*>(l), static_cast<float*>(di),
      static_cast<bf16*>(dq), nullptr, nullptr, B, L, HD, num_heads, sm_scale, stream);
}
