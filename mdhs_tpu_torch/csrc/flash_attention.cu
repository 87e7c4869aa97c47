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
// The backward kernels walk the other side in tiles of 64 through shared
// memory, one block of 4 warps per (64-row tile, head, batch row), each warp
// owning 16 rows of its tile end to end, so after a tile is loaded only
// __syncwarp is needed. Their products are WMMA bf16 -> float32 16x16x16
// (mma.sync underneath):
//   dK/dV:   K, V resident; per query tile S^T = K Q^T and dP^T = V dO^T,
//            p = exp(s - m) / l, ds = (dp - di) * p * sm_scale, both rounded
//            to bf16, dV += P^T dO and dK += dS^T Q in WMMA accumulators.
//   dQ:      Q, dO resident; per key tile S = Q K^T, dP = dO V^T, ds as
//            above, dQ += dS K.
// No atomics: each output element is summed by one warp in a fixed order,
// so the gradients do not depend on the order the blocks run in.
//
// Masking: with the finite MASK a row whose keys in a tile all differ in
// segment takes them at p = exp(0) = 1 until a matching key raises the max;
// exp(m_prev - m_next) then underflows to 0 and wipes them, as the library's
// rescale does (-inf would give exp(-inf + inf) = NaN). Keys past L get
// p = 0; queries past L are computed on zero rows and not stored. Any L.
//
// What bounds it on the H100: the forward does 4*B*heads*L*L*D bf16
// operations against 8*B*L*heads*D bytes (q, k, v, o): at B = 32, L = 512, 12
// heads of 64 that is 26 us of tensor-core time and 30 us of memory time, so
// the bytes bound it; the exponential and the row arithmetic of each score
// on the CUDA cores are what its design leaves above that. The backward's
// five products (S, dP, dV, dK, dQ; S and dP are made in both backward
// kernels, seven in all) are 10*B*heads*L*L*D operations against about
// 14*B*L*heads*D bytes.
#include <climits>

#include "attention_sm90.cuh"

namespace mdhs {
namespace {

namespace fl {
constexpr int QT = 64;        // rows of a block's own tile, 16 per warp
constexpr int KT = 64;        // rows of each streamed tile
constexpr int THREADS = 128;  // 4 warps
constexpr int MAX_D = 128;    // head_dim bound: ND = Dp / 16 accumulator fragments a warp
}  // namespace fl

enum FlKind : int { kDkv = 0, kDq = 1 };

__host__ __device__ inline size_t fl_align(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory plan of a backward block; fl_prepare refuses a plan past kMaxSmemPerBlock.
struct FlPlan {
  int Dp;              // D rounded up to the 16 of a fragment
  int ldk, lds, ldp;   // pitches: (64, Dp) bf16 tiles, (64, 64|Dp) float32 scratch, (64, 64) bf16 scratch
  size_t tile[4], f32[2], pb[2], words, bytes;
};

__host__ __device__ inline FlPlan fl_plan(int D, int kind) {
  FlPlan p;
  p.Dp = (D + 15) / 16 * 16;
  p.ldk = p.Dp + 8;
  p.lds = (fl::KT > p.Dp ? fl::KT : p.Dp) + 4;
  p.ldp = fl::KT + 8;
  const int nb = kind == kDkv ? 2 : 1;
  size_t off = 0;
  for (int i = 0; i < 4; ++i) {
    p.tile[i] = off;
    off = fl_align(off + size_t(fl::QT) * p.ldk * sizeof(bf16));
  }
  for (int i = 0; i < 2; ++i) {
    p.f32[i] = off;
    off = fl_align(off + size_t(fl::QT) * p.lds * sizeof(float));
  }
  for (int i = 0; i < 2; ++i) {
    p.pb[i] = off;
    if (i < nb) off = fl_align(off + size_t(fl::QT) * p.ldp * sizeof(bf16));
  }
  p.words = off;  // 6 x 64 words: per-row m, l, di, query segment ids, key segment ids
  p.bytes = fl_align(off + 6 * fl::QT * sizeof(float));
  return p;
}

// Rows row0 .. row0 + 64 of one head of a (B, L, HD) tensor into a (64, ldk)
// tile; rows past L and columns past D are zero, so padded fragments add nothing.
__device__ __forceinline__ void fl_load_tile(bf16* dst, const bf16* head, int row0, int L, int HD, int D,
                                             const FlPlan& sp) {
  const int cpr = sp.Dp / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < fl::QT * cpr; i += fl::THREADS) {
    const int r = i / cpr, c = (i % cpr) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L && c < D) val = *reinterpret_cast<const uint4*>(head + size_t(row0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * sp.ldk + c) = val;
  }
}

// Segment ids of rows row0 .. row0 + 64; INT_MIN past L (it matches no real id).
__device__ __forceinline__ void fl_load_seg(int* dst, const int* seg_row, int row0, int L) {
  for (int i = threadIdx.x; i < fl::QT; i += fl::THREADS) dst[i] = row0 + i < L ? seg_row[row0 + i] : INT_MIN;
}

// out[r0 .. r0 + 16, 0 .. 64) = A[r0 .. r0 + 16, :Dp] B[0 .. 64, :Dp]^T (float32),
// A and B (64, ldk) bf16 tiles: this warp's rows of S = Q K^T, S^T = K Q^T, dP = dO V^T or dP^T = V dO^T.
template <int ND>
__device__ __forceinline__ void fl_abt(float* out, const bf16* A, const bf16* B, int r0, const FlPlan& sp) {
#pragma unroll
  for (int j = 0; j < fl::KT / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, A + r0 * sp.ldk + 16 * kk, sp.ldk);
      wmma::load_matrix_sync(b, B + (16 * j) * sp.ldk + 16 * kk, sp.ldk);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(out + r0 * sp.lds + 16 * j, acc, sp.lds, wmma::mem_row_major);
  }
}

// acc[n] += P[r0 .. r0 + 16, 0 .. 64) X[0 .. 64, 16 n .. 16 n + 16): P a (64, ldp)
// bf16 scratch, X a (64, ldk) tile (V, dO, Q or K).
template <int ND>
__device__ __forceinline__ void fl_px(wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, const bf16* P,
                                      const bf16* X, int r0, const FlPlan& sp) {
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int kk = 0; kk < fl::KT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, P + r0 * sp.ldp + 16 * kk, sp.ldp);
      wmma::load_matrix_sync(b, X + (16 * kk) * sp.ldk + 16 * n, sp.ldk);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

// This warp's 16 rows of accumulators to (B, L, HD) bf16 through its rows of
// the float32 scratch S, 8 columns a lane; rows past L are not stored.
template <int ND>
__device__ __forceinline__ void fl_store_acc(bf16* head, const wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc,
                                             float* S, int row0, int r0, int L, int HD, int D, const FlPlan& sp) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < ND; ++n) wmma::store_matrix_sync(S + r0 * sp.lds + 16 * n, acc[n], sp.lds, wmma::mem_row_major);
  __syncwarp();
  const int cpo = D / 8;
  for (int i = lane; i < 16 * cpo; i += 32) {
    const int r = i / cpo, c = (i % cpo) * 8;
    if (row0 + r0 + r < L) {
      float val[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) val[e] = S[(r0 + r) * sp.lds + c + e];
      store8(head + size_t(row0 + r0 + r) * HD + c, val);
    }
  }
}

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

// Per-row statistics of rows row0 .. row0 + 64 (m, l, di from (B, heads, L));
// past L: m 0, l 1, di 0 (their segment id INT_MIN masks every score).
__device__ __forceinline__ void fl_load_stats(float* mq, float* lq, float* dq, const float* m, const float* l,
                                              const float* di, int row0, int L) {
  for (int i = threadIdx.x; i < fl::QT; i += fl::THREADS) {
    const bool in = row0 + i < L;
    mq[i] = in ? m[row0 + i] : 0.0f;
    lq[i] = in ? l[row0 + i] : 1.0f;
    dq[i] = in ? di[row0 + i] : 0.0f;
  }
}

// p = exp(s * sm_scale + mask - m) / l and ds = (dp - di) * p * sm_scale of one
// score, both rounded to bf16 (zero where the pair is outside L).
__device__ __forceinline__ void fl_p_ds(float s, float dp, bool same, bool in, float m, float l, float di,
                                        float sm_scale, bf16* p_out, bf16* ds_out) {
  float p = 0.0f, ds = 0.0f;
  if (in) {
    p = expf(s * sm_scale + (same ? 0.0f : sm90::kMask) - m) / l;
    ds = (dp - di) * p * sm_scale;
  }
  if (p_out != nullptr) *p_out = __float2bfloat16_rn(p);
  *ds_out = __float2bfloat16_rn(ds);
}

// grid = (ceil(L / 64), heads, B): one block per 64 keys of one head of one batch row.
template <int ND>
__global__ void __launch_bounds__(fl::THREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const int* __restrict__ seg, const float* __restrict__ m, const float* __restrict__ l,
                         const bf16* __restrict__ dout, const float* __restrict__ di, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int L, int HD, int D, float sm_scale) {
  using namespace fl;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const FlPlan sp = fl_plan(D, kDkv);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + sp.tile[0]);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + sp.tile[1]);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + sp.tile[2]);
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw + sp.tile[3]);
  float* ST = reinterpret_cast<float*>(smem_raw + sp.f32[0]);
  float* DPT = reinterpret_cast<float*>(smem_raw + sp.f32[1]);
  bf16* PT = reinterpret_cast<bf16*>(smem_raw + sp.pb[0]);
  bf16* DST = reinterpret_cast<bf16*>(smem_raw + sp.pb[1]);
  float* mq = reinterpret_cast<float*>(smem_raw + sp.words);
  float* lq = mq + QT;
  float* diq = lq + QT;
  int* segq = reinterpret_cast<int*>(diq + QT);
  int* segk = segq + QT;

  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = size_t(b) * L * HD + size_t(h) * D;
  const size_t stat = (size_t(b) * gridDim.y + h) * L;
  const int* seg_row = seg + size_t(b) * L;
  fl_load_tile(Ks, k + head, k0, L, HD, D, sp);
  fl_load_tile(Vs, v + head, k0, L, HD, D, sp);
  fl_load_seg(segk, seg_row, k0, L);

  const int r0 = warp * 16;  // this warp's keys
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[ND], dv_acc[ND];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.0f);
    wmma::fill_fragment(dv_acc[n], 0.0f);
  }
  for (int q0 = 0; q0 < L; q0 += QT) {
    __syncthreads();
    fl_load_tile(Qs, q + head, q0, L, HD, D, sp);
    fl_load_tile(dOs, dout + head, q0, L, HD, D, sp);
    fl_load_stats(mq, lq, diq, m + stat, l + stat, di + stat, q0, L);
    fl_load_seg(segq, seg_row, q0, L);
    __syncthreads();
    fl_abt<ND>(ST, Ks, Qs, r0, sp);   // S^T: keys x queries
    fl_abt<ND>(DPT, Vs, dOs, r0, sp);  // dP^T
    __syncwarp();
#pragma unroll
    for (int t = 0; t < QT / 32; ++t) {
      const int c = lane + 32 * t;  // this lane's query of the tile
      const bool in = q0 + c < L;
      const float mc = mq[c], lc = lq[c], dc = diq[c];
      const int sq = segq[c];
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const int i = (r0 + r) * sp.lds + c, o = (r0 + r) * sp.ldp + c;
        fl_p_ds(ST[i], DPT[i], sq == segk[r0 + r], in, mc, lc, dc, sm_scale, PT + o, DST + o);
      }
    }
    __syncwarp();
    fl_px<ND>(dv_acc, PT, dOs, r0, sp);  // dV += P^T dO
    fl_px<ND>(dk_acc, DST, Qs, r0, sp);  // dK += dS^T Q
  }
  fl_store_acc<ND>(dv + head, dv_acc, ST, k0, r0, L, HD, D, sp);
  fl_store_acc<ND>(dk + head, dk_acc, ST, k0, r0, L, HD, D, sp);
}

// grid = (ceil(L / 64), heads, B): one block per 64 queries of one head of one batch row.
template <int ND>
__global__ void __launch_bounds__(fl::THREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const int* __restrict__ seg, const float* __restrict__ m, const float* __restrict__ l,
                        const bf16* __restrict__ dout, const float* __restrict__ di, bf16* __restrict__ dq,
                        int L, int HD, int D, float sm_scale) {
  using namespace fl;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const FlPlan sp = fl_plan(D, kDq);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + sp.tile[0]);
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw + sp.tile[1]);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + sp.tile[2]);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + sp.tile[3]);
  float* S = reinterpret_cast<float*>(smem_raw + sp.f32[0]);
  float* DP = reinterpret_cast<float*>(smem_raw + sp.f32[1]);
  bf16* DS = reinterpret_cast<bf16*>(smem_raw + sp.pb[0]);
  float* mq = reinterpret_cast<float*>(smem_raw + sp.words);
  float* lq = mq + QT;
  float* diq = lq + QT;
  int* segq = reinterpret_cast<int*>(diq + QT);
  int* segk = segq + QT;

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = size_t(b) * L * HD + size_t(h) * D;
  const size_t stat = (size_t(b) * gridDim.y + h) * L;
  const int* seg_row = seg + size_t(b) * L;
  fl_load_tile(Qs, q + head, q0, L, HD, D, sp);
  fl_load_tile(dOs, dout + head, q0, L, HD, D, sp);
  fl_load_stats(mq, lq, diq, m + stat, l + stat, di + stat, q0, L);
  fl_load_seg(segq, seg_row, q0, L);

  const int r0 = warp * 16;  // this warp's queries
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[ND];
#pragma unroll
  for (int n = 0; n < ND; ++n) wmma::fill_fragment(dq_acc[n], 0.0f);
  for (int k0 = 0; k0 < L; k0 += KT) {
    __syncthreads();
    fl_load_tile(Ks, k + head, k0, L, HD, D, sp);
    fl_load_tile(Vs, v + head, k0, L, HD, D, sp);
    fl_load_seg(segk, seg_row, k0, L);
    __syncthreads();
    fl_abt<ND>(S, Qs, Ks, r0, sp);
    fl_abt<ND>(DP, dOs, Vs, r0, sp);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < KT / 32; ++t) {
      const int c = lane + 32 * t;  // this lane's key of the tile
      const bool in = k0 + c < L;
      const int sk = segk[c];
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const int row = r0 + r, i = row * sp.lds + c;
        fl_p_ds(S[i], DP[i], segq[row] == sk, in, mq[row], lq[row], diq[row], sm_scale, nullptr,
                DS + row * sp.ldp + c);
      }
    }
    __syncwarp();
    fl_px<ND>(dq_acc, DS, Ks, r0, sp);  // dQ += dS K
  }
  fl_store_acc<ND>(dq + head, dq_acc, S, q0, r0, L, HD, D, sp);
}

template <typename Kernel>
cudaError_t fl_prepare(Kernel kernel, const FlPlan& sp) {
  if (sp.bytes > kMaxSmemPerBlock) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sp.bytes);
}

struct FlArgs {
  const bf16 *q, *k, *v, *dout;
  const int* seg;
  const float *m_in, *l_in, *di;
  bf16 *out, *dk, *dv;
  int B, L, HD, D;
  float sm_scale;
  cudaStream_t stream;
};

template <int ND>
cudaError_t fl_launch(int kind, const FlArgs& a) {
  const FlPlan sp = fl_plan(a.D, kind);
  const dim3 grid((a.L + fl::QT - 1) / fl::QT, a.HD / a.D, a.B);
  cudaError_t err;
  if (kind == kDkv) {
    if ((err = fl_prepare(flash_bwd_dkv_kernel<ND>, sp)) != cudaSuccess) return err;
    flash_bwd_dkv_kernel<ND><<<grid, fl::THREADS, sp.bytes, a.stream>>>(
        a.q, a.k, a.v, a.seg, a.m_in, a.l_in, a.dout, a.di, a.dk, a.dv, a.L, a.HD, a.D, a.sm_scale);
  } else {
    if ((err = fl_prepare(flash_bwd_dq_kernel<ND>, sp)) != cudaSuccess) return err;
    flash_bwd_dq_kernel<ND><<<grid, fl::THREADS, sp.bytes, a.stream>>>(
        a.q, a.k, a.v, a.seg, a.m_in, a.l_in, a.dout, a.di, a.out, a.L, a.HD, a.D, a.sm_scale);
  }
  return cudaGetLastError();
}

cudaError_t fl_dispatch(int kind, FlArgs a, int num_heads) {
  if (a.B <= 0 || a.B > 65535 || a.L <= 0 || num_heads <= 0 || num_heads > 65535 || a.HD % num_heads != 0)
    return cudaErrorInvalidValue;
  a.D = a.HD / num_heads;
  if (a.D % 8 != 0 || a.D > fl::MAX_D) return cudaErrorInvalidValue;
  switch ((a.D + 15) / 16) {
    case 1: return fl_launch<1>(kind, a);
    case 2: return fl_launch<2>(kind, a);
    case 3: return fl_launch<3>(kind, a);
    case 4: return fl_launch<4>(kind, a);
    case 5: return fl_launch<5>(kind, a);
    case 6: return fl_launch<6>(kind, a);
    case 7: return fl_launch<7>(kind, a);
    case 8: return fl_launch<8>(kind, a);
    default: return cudaErrorInvalidValue;
  }
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
// forward's statistics and rowsum(o * dout)).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* seg, const void* m,
                                       const void* l, const void* dout, const void* di, void* dk, void* dv, int B,
                                       int L, int HD, int num_heads, float sm_scale, void* stream) {
  using mdhs::bf16;
  mdhs::FlArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.seg = static_cast<const int*>(seg);
  a.m_in = static_cast<const float*>(m);
  a.l_in = static_cast<const float*>(l);
  a.dout = static_cast<const bf16*>(dout);
  a.di = static_cast<const float*>(di);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.B = B, a.L = L, a.HD = HD, a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return mdhs::fl_dispatch(mdhs::kDkv, a, num_heads);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* seg, const void* m,
                                      const void* l, const void* dout, const void* di, void* dq, int B, int L, int HD,
                                      int num_heads, float sm_scale, void* stream) {
  using mdhs::bf16;
  mdhs::FlArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.seg = static_cast<const int*>(seg);
  a.m_in = static_cast<const float*>(m);
  a.l_in = static_cast<const float*>(l);
  a.dout = static_cast<const bf16*>(dout);
  a.di = static_cast<const float*>(di);
  a.out = static_cast<bf16*>(dq);
  a.B = B, a.L = L, a.HD = HD, a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return mdhs::fl_dispatch(mdhs::kDq, a, num_heads);
}
