// Tiled bf16 GEMMs with fused epilogues, shared by attention_block.cu and
// ffn_block.cu. These are the matrix products the TPU kernels ran on the MXU
// (mdhs_tpu/ops/attention_block.py::_kernel, mdhs_tpu/ops/ffn_block.py::_kernel).
//
// What bounds them on the H100: at the main path's shapes (M = B*L = 4096
// rows, K and N of 768..3072) they are compute-bound in principle (hundreds
// of FLOPs per byte). This first version is a simple correct design: WMMA
// fragments (mma.sync underneath), a two-stage cp.async ring in shared
// memory, 128x128 output tiles. It does not reach the wgmma rate; a later PR
// moves it to wgmma + TMA.
#include "common.cuh"

namespace mdhs {
namespace {

// ---------------------------------------------------------------------------
// gemm_bias_kernel: 128x128 tile per block, 8 warps as 4 (rows) x 2 (cols),
// each warp owning a 32x64 sub-tile = 2x4 accumulator fragments.
// ---------------------------------------------------------------------------
namespace gb {
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // smem row pitch in bf16: 80 bytes, keeps 32-byte fragment alignment
constexpr int THREADS = 256;
constexpr int STAGE = (BM + BN) * LDS;  // bf16 elements per pipeline stage
}  // namespace gb

template <int EPI>
__device__ __forceinline__ float apply_epilogue(float v) {
  if (EPI == kBiasGeluErf) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  if (EPI == kBiasGeluTanh) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.0f + tanhf(inner));
  }
  return v;
}

template <int EPI>
__global__ void __launch_bounds__(gb::THREADS)
    gemm_bias_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                     const bf16* __restrict__ bias, bf16* __restrict__ C, int M, int N, int K) {
  using namespace gb;
  __shared__ __align__(128) bf16 smem[2 * STAGE];  // 40 KB

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  auto load_stage = [&](int stage, int k0) {
    bf16* As = smem + stage * STAGE;
    bf16* Ws = As + BM * LDS;
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = m0 + r < M;
      cp_async16(As + r * LDS + c, A + (size_t)(ok ? m0 + r : 0) * K + k0 + c, ok);
    }
    for (int i = tid; i < BN * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      cp_async16(Ws + r * LDS + c, W + (size_t)(n0 + r) * K + k0 + c, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* As = smem + (kt & 1) * STAGE;
    const bf16* Ws = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], Ws + (wn + 16 * j) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  // Epilogue: one 16x16 fragment at a time through a per-warp float scratch
  // (aliasing the now idle pipeline buffers); each lane finishes 8 columns of
  // one row: + bias, activation, one rounding to bf16, one 16-byte store.
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int grow = m0 + wm + 16 * i + r;
      const int gcol = n0 + wn + 16 * j + c;
      if (grow < M) {
        float b[8], v[8];
        load8(bias + gcol, b);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = apply_epilogue<EPI>(scratch[r * 16 + c + e] + b[e]);
        store8(C + (size_t)grow * N + gcol, v);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// gemm_residual_ln_kernel: a block owns 32 full rows (all N columns), so the
// LayerNorm of a row needs no second pass over device memory. 8 warps split
// the N columns, 16*NF each, with 2 row fragments: 2*NF accumulators a warp.
// ---------------------------------------------------------------------------
namespace gl {
constexpr int BM = 32, BK = 32;
constexpr int LDS = BK + 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
}  // namespace gl

template <int NF>
constexpr size_t gemm_ln_smem_bytes() {
  constexpr int N = 128 * NF;
  constexpr size_t pipeline = 2 * size_t(gl::BM + N) * gl::LDS * sizeof(bf16);
  constexpr size_t rows = size_t(gl::BM) * (N + 4) * sizeof(float);
  return pipeline > rows ? pipeline : rows;
}

template <int NF>
__global__ void __launch_bounds__(gl::THREADS)
    gemm_residual_ln_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                            const bf16* __restrict__ bias, const bf16* __restrict__ resid,
                            const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                            bf16* __restrict__ out, int M, int K, float eps) {
  using namespace gl;
  constexpr int N = 128 * NF;
  constexpr int STAGE = (BM + N) * LDS;
  constexpr int LDY = N + 4;  // float pitch of the row buffer
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int wn = warp * 16 * NF;

  auto load_stage = [&](int stage, int k0) {
    bf16* As = smem + stage * STAGE;
    bf16* Ws = As + BM * LDS;
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = m0 + r < M;
      cp_async16(As + r * LDS + c, A + (size_t)(ok ? m0 + r : 0) * K + k0 + c, ok);
    }
    for (int i = tid; i < N * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      cp_async16(Ws + r * LDS + c, W + (size_t)r * K + k0 + c, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* As = smem + (kt & 1) * STAGE;
    const bf16* Ws = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (16 * i) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Ws + (wn + 16 * j) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // The 32 x N float32 products go to shared memory (aliasing the pipeline),
  // then each warp finishes 4 whole rows: + residual + bias in float32, mean,
  // biased variance of the centred values, normalise, affine, round once.
  float* Y = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(Y + (16 * i) * LDY + wn + 16 * j, acc[i][j], LDY,
                              wmma::mem_row_major);
  __syncthreads();

  constexpr int PER_LANE = N / 32;
  for (int rr = 0; rr < BM / WARPS; ++rr) {
    const int r = warp * (BM / WARPS) + rr;
    const int grow = m0 + r;
    if (grow >= M) break;  // warp-uniform
    const bf16* xrow = resid + (size_t)grow * N;
    float y[PER_LANE];
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int col = lane + 32 * t;
      y[t] = __bfloat162float(xrow[col]) + Y[r * LDY + col] + __bfloat162float(bias[col]);
      s += y[t];
    }
    const float mu = warp_sum(s) / N;
    float q = 0.0f;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      y[t] -= mu;
      q += y[t] * y[t];
    }
    const float inv = rsqrtf(warp_sum(q) / N + eps);
    bf16* orow = out + (size_t)grow * N;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int col = lane + 32 * t;
      orow[col] = __float2bfloat16_rn(y[t] * inv * __bfloat162float(gamma[col]) +
                                      __bfloat162float(beta[col]));
    }
  }
}

template <int NF>
cudaError_t launch_ln(const bf16* A, const bf16* W, const bf16* bias, const bf16* resid,
                      const bf16* gamma, const bf16* beta, bf16* out, int M, int K, float eps,
                      cudaStream_t stream) {
  constexpr size_t bytes = gemm_ln_smem_bytes<NF>();
  static_assert(bytes <= kMaxSmemPerBlock, "gemm_residual_ln tile exceeds shared memory");
  cudaError_t err = cudaFuncSetAttribute(gemm_residual_ln_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + gl::BM - 1) / gl::BM);
  gemm_residual_ln_kernel<NF><<<grid, gl::THREADS, bytes, stream>>>(A, W, bias, resid, gamma, beta,
                                                                     out, M, K, eps);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_gemm_bias(int epilogue, const bf16* A, const bf16* W, const bf16* bias, bf16* C,
                             int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % gb::BN != 0 || K % gb::BK != 0) return cudaErrorInvalidValue;
  const dim3 grid(N / gb::BN, (M + gb::BM - 1) / gb::BM);
  switch (epilogue) {
    case kBias:
      gemm_bias_kernel<kBias><<<grid, gb::THREADS, 0, stream>>>(A, W, bias, C, M, N, K);
      break;
    case kBiasGeluErf:
      gemm_bias_kernel<kBiasGeluErf><<<grid, gb::THREADS, 0, stream>>>(A, W, bias, C, M, N, K);
      break;
    case kBiasGeluTanh:
      gemm_bias_kernel<kBiasGeluTanh><<<grid, gb::THREADS, 0, stream>>>(A, W, bias, C, M, N, K);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_gemm_residual_ln(const bf16* A, const bf16* W, const bf16* bias,
                                    const bf16* resid, const bf16* gamma, const bf16* beta,
                                    bf16* out, int M, int N, int K, float eps,
                                    cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % gl::BK != 0) return cudaErrorInvalidValue;
  switch (N) {
    case 128: return launch_ln<1>(A, W, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 256: return launch_ln<2>(A, W, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 384: return launch_ln<3>(A, W, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 512: return launch_ln<4>(A, W, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 640: return launch_ln<5>(A, W, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 768: return launch_ln<6>(A, W, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 896: return launch_ln<7>(A, W, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 1024: return launch_ln<8>(A, W, bias, resid, gamma, beta, out, M, K, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mdhs

extern "C" const char* mdhs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
