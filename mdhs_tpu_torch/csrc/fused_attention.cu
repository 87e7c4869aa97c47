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
// VMEM. At L = 512 the whole-sequence plan of attention_block.cu needs about
// 355 KB of shared memory, past the 227 KB a Hopper block may use, so this
// kernel streams K and V through shared memory in tiles of 64 keys. One block
// per (64 queries, head, batch row), 4 warps of 16 query rows. Two passes over
// the keys, so that the probabilities are rounded to bf16 after they are
// normalised, exactly as the TPU kernel and the plain version round them:
//   1. scores tile by tile; a running row max and a running row sum of
//      exp(s - max), rescaled when the max grows (float32, in registers);
//   2. scores again; p = exp(s - max) / sum rounded to bf16 in shared memory;
//      ctx += P V on the tensor cores, the accumulators held across tiles.
// Keys past L are masked (probability 0); queries past L are computed and
// not stored. Any L works; the wrapper's gate takes 1 <= L <= 512.
//
// What bounds it on the H100: 4*B*heads*L*L*D bf16 operations for QK^T and
// PV (pass 1 adds a third of that again, which the bound does not count)
// against 8*B*L*heads*D bytes of q, k, v and ctx. At B = 32, L = 512, 12 heads
// of 64 that is 26 us of tensor-core time and 30 us of memory time: the
// bytes bound it. K and V are read once per query tile (8 times at L = 512),
// mostly from L2.
#include "common.cuh"

namespace mdhs {
namespace {

namespace fa {
constexpr int QT = 64;        // query rows per block, 16 per warp
constexpr int KT = 64;        // keys per streamed tile
constexpr int THREADS = 128;  // 4 warps
constexpr int MAX_D = 128;    // head_dim bound: ND = Dp / 16 accumulator fragments a warp
}  // namespace fa

__host__ __device__ inline size_t align_up128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory plan of one block. Mirrored in Python by
// mdhs_tpu_torch/ops/fused_attention.py::_smem_bytes (the supports() gate).
struct FaPlan {
  int Dp;              // D rounded up to the 16 of a fragment
  int ldk, lds, ldp;   // pitches: Q/K/V (bf16), scores (float32), probabilities (bf16)
  size_t q_off, k_off, v_off, s_off, p_off, bytes;
};

__host__ __device__ inline FaPlan fa_plan(int D) {
  FaPlan p;
  p.Dp = (D + 15) / 16 * 16;
  p.ldk = p.Dp + 8;
  p.lds = (fa::KT > p.Dp ? fa::KT : p.Dp) + 4;
  p.ldp = fa::KT + 8;
  p.q_off = 0;
  p.k_off = align_up128(p.q_off + size_t(fa::QT) * p.ldk * sizeof(bf16));
  p.v_off = align_up128(p.k_off + size_t(fa::KT) * p.ldk * sizeof(bf16));
  p.s_off = align_up128(p.v_off + size_t(fa::KT) * p.ldk * sizeof(bf16));
  p.p_off = align_up128(p.s_off + size_t(fa::QT) * p.lds * sizeof(float));
  p.bytes = align_up128(p.p_off + size_t(fa::QT) * p.ldp * sizeof(bf16));
  return p;
}

// grid = (ceil(L / 64), num_heads, B). Head h of q, k, v is columns
// h*D .. h*D + D of each (B, L, HD) row. bias is (B, L) float32, additive.
template <int ND>
__global__ void __launch_bounds__(fa::THREADS)
    fused_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ bias,
                           bf16* __restrict__ ctx, int L, int HD, int D, float sm_scale) {
  using namespace fa;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const FaPlan sp = fa_plan(D);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + sp.q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + sp.k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + sp.v_off);
  float* S = reinterpret_cast<float*>(smem_raw + sp.s_off);
  bf16* P = reinterpret_cast<bf16*>(smem_raw + sp.p_off);

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t head = size_t(b) * L * HD + size_t(h) * D;
  const float* brow = bias + size_t(b) * L;
  const int cpr = sp.Dp / 8;  // 16-byte chunks per shared-memory row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // rows past L and columns past D are zero, so padded fragments add nothing
  auto load_rows = [&](bf16* dst, const bf16* src, int row0, int rows) {
    for (int i = tid; i < rows * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      uint4 val = zero;
      if (row0 + r < L && c < D) val = *reinterpret_cast<const uint4*>(src + head + size_t(row0 + r) * HD + c);
      *reinterpret_cast<uint4*>(dst + r * sp.ldk + c) = val;
    }
  };
  load_rows(Qs, q, q0, QT);

  // From here each warp works on its own 16 query rows.
  const int r0 = warp * 16;
  // S[r0 .. r0+16, 0 .. KT) = Q K^T of the current key tile, float32.
  auto tile_scores = [&]() {
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(a, Qs + r0 * sp.ldk + 16 * kk, sp.ldk);
        wmma::load_matrix_sync(kb, Ks + (16 * j) * sp.ldk + 16 * kk, sp.ldk);
        wmma::mma_sync(acc, a, kb, acc);
      }
      wmma::store_matrix_sync(S + r0 * sp.lds + 16 * j, acc, sp.lds, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // Pass 1: running max and sum of each row (warp-uniform values).
  float mrow[16], lrow[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    mrow[r] = -FLT_MAX;
    lrow[r] = 0.0f;
  }
  for (int k0 = 0; k0 < L; k0 += KT) {
    __syncthreads();  // the previous tile is no longer read
    load_rows(Ks, k, k0, KT);
    __syncthreads();
    tile_scores();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* srow = S + (r0 + r) * sp.lds;
      float s[KT / 32];
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < KT / 32; ++t) {
        const int key = k0 + lane + 32 * t;
        s[t] = key < L ? srow[lane + 32 * t] * sm_scale + brow[key] : -INFINITY;
        m = fmaxf(m, s[t]);
      }
      const float m_new = fmaxf(mrow[r], warp_max(m));
      float e = 0.0f;
#pragma unroll
      for (int t = 0; t < KT / 32; ++t) e += expf(s[t] - m_new);
      lrow[r] = lrow[r] * expf(mrow[r] - m_new) + warp_sum(e);
      mrow[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) lrow[r] = 1.0f / lrow[r];

  // Pass 2: normalised probabilities in bf16, ctx += P V.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[ND];
#pragma unroll
  for (int n = 0; n < ND; ++n) wmma::fill_fragment(o[n], 0.0f);
  for (int k0 = 0; k0 < L; k0 += KT) {
    __syncthreads();
    load_rows(Ks, k, k0, KT);
    load_rows(Vs, v, k0, KT);
    __syncthreads();
    tile_scores();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* srow = S + (r0 + r) * sp.lds;
      bf16* prow = P + (r0 + r) * sp.ldp;
#pragma unroll
      for (int t = 0; t < KT / 32; ++t) {
        const int c = lane + 32 * t, key = k0 + c;
        const float p = key < L ? expf(srow[c] * sm_scale + brow[key] - mrow[r]) * lrow[r] : 0.0f;
        prow[c] = __float2bfloat16_rn(p);
      }
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(a, P + r0 * sp.ldp + 16 * kk, sp.ldp);
        wmma::load_matrix_sync(vb, Vs + (16 * kk) * sp.ldk + 16 * n, sp.ldk);
        wmma::mma_sync(o[n], a, vb, o[n]);
      }
    }
  }

  // ctx through this warp's rows of S (no other warp reads them), 8 columns a lane.
  __syncwarp();
#pragma unroll
  for (int n = 0; n < ND; ++n)
    wmma::store_matrix_sync(S + r0 * sp.lds + 16 * n, o[n], sp.lds, wmma::mem_row_major);
  __syncwarp();
  const int cpo = D / 8;
  for (int i = lane; i < 16 * cpo; i += 32) {
    const int r = i / cpo, c = (i % cpo) * 8;
    const int qi = q0 + r0 + r;
    if (qi < L) {
      const float* src = S + (r0 + r) * sp.lds + c;
      float val[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) val[e] = src[e];
      store8(ctx + head + size_t(qi) * HD + c, val);
    }
  }
}

template <int ND>
cudaError_t launch_nd(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* ctx, int B,
                      int L, int HD, int D, float sm_scale, cudaStream_t stream) {
  const FaPlan sp = fa_plan(D);
  if (sp.bytes > kMaxSmemPerBlock) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_attention_kernel<ND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sp.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + fa::QT - 1) / fa::QT, HD / D, B);
  fused_attention_kernel<ND><<<grid, fa::THREADS, sp.bytes, stream>>>(q, k, v, bias, ctx, L, HD, D, sm_scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdhs

// q, k, v, ctx: (B, L, HD) bf16 with HD = num_heads * D, D % 8 == 0, D <= 128;
// bias: (B, L) float32. Returns the launch's CUDA error, or 0.
extern "C" int fused_attention_forward(const void* q, const void* k, const void* v, const void* bias,
                                       void* ctx, int B, int L, int HD, int num_heads, float sm_scale,
                                       void* stream) {
  using mdhs::bf16;
  if (B <= 0 || L <= 0 || num_heads <= 0 || HD % num_heads != 0) return cudaErrorInvalidValue;
  const int D = HD / num_heads;
  if (D % 8 != 0 || D > mdhs::fa::MAX_D) return cudaErrorInvalidValue;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* bp = static_cast<const float*>(bias);
  auto* cp = static_cast<bf16*>(ctx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return mdhs::launch_nd<1>(qp, kp, vp, bp, cp, B, L, HD, D, sm_scale, s);
    case 2: return mdhs::launch_nd<2>(qp, kp, vp, bp, cp, B, L, HD, D, sm_scale, s);
    case 3: return mdhs::launch_nd<3>(qp, kp, vp, bp, cp, B, L, HD, D, sm_scale, s);
    case 4: return mdhs::launch_nd<4>(qp, kp, vp, bp, cp, B, L, HD, D, sm_scale, s);
    case 5: return mdhs::launch_nd<5>(qp, kp, vp, bp, cp, B, L, HD, D, sm_scale, s);
    case 6: return mdhs::launch_nd<6>(qp, kp, vp, bp, cp, B, L, HD, D, sm_scale, s);
    case 7: return mdhs::launch_nd<7>(qp, kp, vp, bp, cp, B, L, HD, D, sm_scale, s);
    case 8: return mdhs::launch_nd<8>(qp, kp, vp, bp, cp, B, L, HD, D, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}
