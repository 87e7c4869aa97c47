// int8 (a8w8) building blocks: the row-quantize pass of int8_ffn_block.cu and
// int8_attention_block.cu, and the s8 x s8 -> s32 GEMMs of
// int8_attention_block.cu with the dequantize fused into their epilogues (the
// FFN's products run on int8_gemm_sm90.cuh). These are the pieces the TPU
// kernels ran inside one grid step (mdhs_tpu/ops/quant_kernel.py::_kernel and
// ::_attn_kernel: _rowquant_f32 on the VPU, the int8 MXU dots, the f32
// rescale); here they are separate launches over device memory.
//
// The products run on the tensor cores through mma.sync.m16n8k32 with s8
// operands and s32 accumulators (PTX ISA "Matrix Fragments for
// mma.m16n8k32"): the integer sums are exact, and are converted to float32
// only once, in the epilogue. Tiling follows gemm.cu: 128 x 128 output tiles
// (or 32 whole rows for the LayerNorm epilogue), K in steps of 64 bytes, a
// two-stage cp.async ring. Each shared-memory row is 80 bytes, so the 32-bit
// fragment loads of a warp (8 rows x 4 words) hit 32 distinct banks.
//
// What bounds them on the H100: at the preset's shapes (M = 512 * 128 rows,
// K and N of 768..3072) they are compute-bound (about 1,500 int8 operations
// per byte). mma.sync does not reach the wgmma rate; moving them to wgmma +
// TMA is later work.
#include "common.cuh"

namespace mdhs {
namespace {

// float32(1/127) as the JAX kernel spells it: jnp.float32(1.0 / 127.0), the
// double quotient rounded once to float32.
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// A fragment (16 x 32, row-major) at tile row r0, column kk of a shared tile
// with pitch LDS bytes: rows g and g+8, bytes tig*4.. and 16+tig*4.. .
template <int LDS>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const int8_t* tile, int r0, int kk, int lane) {
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  const int8_t* p0 = tile + (r0 + g) * LDS + kk + t4;
  const int8_t* p1 = p0 + 8 * LDS;
  a[0] = lds32(p0);
  a[1] = lds32(p1);
  a[2] = lds32(p0 + 16);
  a[3] = lds32(p1 + 16);
}

// B fragment (32 x 8, col-major) from W rows n0..n0+7 (W is [N, K], so a
// column of B is a row of W): bytes tig*4.. and 16+tig*4.. of row n0+g.
template <int LDS>
__device__ __forceinline__ void load_b(unsigned (&b)[2], const int8_t* tile, int n0, int kk, int lane) {
  const int8_t* p = tile + (n0 + (lane >> 2)) * LDS + kk + (lane & 3) * 4;
  b[0] = lds32(p);
  b[1] = lds32(p + 16);
}

// (float(acc) * sa) * sw, rounded at each step as the JAX kernel's
// `acc * sx * sw` is (no fused multiply-add).
__device__ __forceinline__ float dequant(int acc, float sa, float sw) {
  return __fmul_rn(__fmul_rn(static_cast<float>(acc), sa), sw);
}

// ---------------------------------------------------------------------------
// row_quantize_kernel: one warp per row, 8 rows a block. The row is read
// twice (absmax, then quantize); the second read comes from L1/L2.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
    row_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                        int M, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const T* xr = x + size_t(row) * K;
  float m = 0.0f;
  for (int c = lane * 8; c < K; c += 256) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  m = warp_max(m);
  const float s = fmaxf(m, 1e-8f) * kInv127;
  int8_t* qr = q + size_t(row) * K;
  for (int c = lane * 8; c < K; c += 256) {
    float v[8];
    load8(xr + c, v);
    union { int8_t b[8]; uint2 u; } pack;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float r = fminf(fmaxf(rintf(v[e] / s), -127.0f), 127.0f);  // IEEE division, half to even
      pack.b[e] = static_cast<int8_t>(__float2int_rn(r));
    }
    *reinterpret_cast<uint2*>(qr + c) = pack.u;
  }
  if (lane == 0) scale[row] = s;
}

template <typename T>
cudaError_t row_quantize(const T* x, int8_t* q, float* scale, int M, int K, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0) return cudaErrorInvalidValue;
  row_quantize_kernel<T><<<(M + 7) / 8, 256, 0, stream>>>(x, q, scale, M, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gemm_s8_kernel: 128 x 128 tile per block, 8 warps as 4 (rows) x 2 (cols),
// each warp a 32 x 64 sub-tile = 2 x 8 m16n8 accumulators (64 int32 a thread).
// ---------------------------------------------------------------------------
namespace g8 {
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // bytes
constexpr int THREADS = 256;
constexpr int STAGE = (BM + BN) * LDS;  // bytes per pipeline stage
}  // namespace g8

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int EPI, typename OutT>
__global__ void __launch_bounds__(g8::THREADS)
    gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                   const float* __restrict__ sa, const float* __restrict__ sw,
                   const float* __restrict__ bias, OutT* __restrict__ C, int M, int N, int K) {
  using namespace g8;
  __shared__ __align__(128) int8_t smem[2 * STAGE];  // 40 KB

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  auto load_stage = [&](int stage, int k0) {
    int8_t* As = smem + stage * STAGE;
    int8_t* Ws = As + BM * LDS;
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const bool ok = m0 + r < M;
      cp_async16(As + r * LDS + c, A + size_t(ok ? m0 + r : 0) * K + k0 + c, ok);
    }
    for (int i = tid; i < BN * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      cp_async16(Ws + r * LDS + c, W + size_t(n0 + r) * K + k0 + c, true);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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
    const int8_t* As = smem + (kt & 1) * STAGE;
    const int8_t* Ws = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) load_a<LDS>(a[i], As, wm + 16 * i, kk, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        unsigned b[2];
        load_b<LDS>(b, Ws, wn + 8 * j, kk, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  // Epilogue straight from the accumulators: thread (g, tig) holds rows g and
  // g+8 of each m-fragment, columns 2*tig and 2*tig+1 of each n-fragment.
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + 16 * i + g + 8 * half;
      if (row >= M) continue;
      const float s_row = sa[row];
      OutT* crow = C + size_t(row) * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn + 8 * j + t2;
        const float v0 = __fadd_rn(dequant(acc[i][j][2 * half], s_row, sw[col]), bias[col]);
        const float v1 = __fadd_rn(dequant(acc[i][j][2 * half + 1], s_row, sw[col + 1]), bias[col + 1]);
        store2(crow + col, v0, v1);
      }
    }
  }
}

template <typename OutT>
cudaError_t gemm_s8(int epilogue, const int8_t* A, const int8_t* W, const float* sa, const float* sw,
                    const float* bias, OutT* C, int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % g8::BN != 0 || K % g8::BK != 0) return cudaErrorInvalidValue;
  const dim3 grid(N / g8::BN, (M + g8::BM - 1) / g8::BM);
  switch (epilogue) {
    case kBias:
      gemm_s8_kernel<kBias, OutT><<<grid, g8::THREADS, 0, stream>>>(A, W, sa, sw, bias, C, M, N, K);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gemm_s8_residual_ln_kernel: a block owns 32 full rows (all N = 128*NF
// columns), so the LayerNorm of a row needs no second pass over device memory.
// 8 warps split the columns, 16*NF each: 2 x 2*NF m16n8 accumulators a warp.
// ---------------------------------------------------------------------------
namespace g8l {
constexpr int BM = 32, BK = 64;
constexpr int LDS = BK + 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
}  // namespace g8l

template <int NF>
constexpr size_t gemm_s8_ln_smem_bytes() {
  constexpr int N = 128 * NF;
  constexpr size_t pipeline = 2 * size_t(g8l::BM + N) * g8l::LDS;
  constexpr size_t rows = size_t(g8l::BM) * (N + 4) * sizeof(float);
  return pipeline > rows ? pipeline : rows;
}

template <int NF>
__global__ void __launch_bounds__(g8l::THREADS)
    gemm_s8_residual_ln_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                               const float* __restrict__ sa, const float* __restrict__ sw,
                               const float* __restrict__ bias, const bf16* __restrict__ resid,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               bf16* __restrict__ out, int M, int K, float eps) {
  using namespace g8l;
  constexpr int N = 128 * NF;
  constexpr int NJ = 2 * NF;  // n-fragments of 8 columns a warp
  constexpr int STAGE = (BM + N) * LDS;
  constexpr int LDY = N + 4;  // float pitch of the row buffer
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int wn = warp * 8 * NJ;

  auto load_stage = [&](int stage, int k0) {
    int8_t* As = smem + stage * STAGE;
    int8_t* Ws = As + BM * LDS;
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const bool ok = m0 + r < M;
      cp_async16(As + r * LDS + c, A + size_t(ok ? m0 + r : 0) * K + k0 + c, ok);
    }
    for (int i = tid; i < N * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      cp_async16(Ws + r * LDS + c, W + size_t(r) * K + k0 + c, true);
    }
  };

  int acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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
    const int8_t* As = smem + (kt & 1) * STAGE;
    const int8_t* Ws = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) load_a<LDS>(a[i], As, 16 * i, kk, lane);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        unsigned b[2];
        load_b<LDS>(b, Ws, wn + 8 * j, kk, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b);
      }
    }
    __syncthreads();
  }

  // The dequantized 32 x N float32 products go to shared memory (aliasing the
  // pipeline), then each warp finishes 4 whole rows: y = (x + d) + b in
  // float32 (the JAX kernel's order), mean, biased variance of the centred
  // values, normalise, affine, one rounding to bf16.
  float* Y = reinterpret_cast<float*>(smem_raw);
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * i + g + 8 * half;
      const float s_row = m0 + r < M ? sa[m0 + r] : 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = wn + 8 * j + t2;
        Y[r * LDY + col] = dequant(acc[i][j][2 * half], s_row, sw[col]);
        Y[r * LDY + col + 1] = dequant(acc[i][j][2 * half + 1], s_row, sw[col + 1]);
      }
    }
  }
  __syncthreads();

  constexpr int PER_LANE = N / 32;
  for (int rr = 0; rr < BM / WARPS; ++rr) {
    const int r = warp * (BM / WARPS) + rr;
    const int grow = m0 + r;
    if (grow >= M) break;  // warp-uniform
    const bf16* xrow = resid + size_t(grow) * N;
    float y[PER_LANE];
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int col = lane + 32 * t;
      y[t] = __fadd_rn(__fadd_rn(__bfloat162float(xrow[col]), Y[r * LDY + col]), bias[col]);
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
    bf16* orow = out + size_t(grow) * N;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int col = lane + 32 * t;
      orow[col] = __float2bfloat16_rn(y[t] * inv * gamma[col] + beta[col]);
    }
  }
}

template <int NF>
cudaError_t launch_s8_ln(const int8_t* A, const int8_t* W, const float* sa, const float* sw,
                         const float* bias, const bf16* resid, const float* gamma, const float* beta,
                         bf16* out, int M, int K, float eps, cudaStream_t stream) {
  constexpr size_t bytes = gemm_s8_ln_smem_bytes<NF>();
  static_assert(bytes <= kMaxSmemPerBlock, "gemm_s8_residual_ln tile exceeds shared memory");
  cudaError_t err = cudaFuncSetAttribute(gemm_s8_residual_ln_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + g8l::BM - 1) / g8l::BM);
  gemm_s8_residual_ln_kernel<NF><<<grid, g8l::THREADS, bytes, stream>>>(A, W, sa, sw, bias, resid, gamma,
                                                                         beta, out, M, K, eps);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_row_quantize(const bf16* x, int8_t* q, float* scale, int M, int K, cudaStream_t stream) {
  return row_quantize(x, q, scale, M, K, stream);
}

cudaError_t launch_gemm_s8(int epilogue, const int8_t* A, const int8_t* W, const float* sa, const float* sw,
                           const float* bias, bf16* C, int M, int N, int K, cudaStream_t stream) {
  return gemm_s8(epilogue, A, W, sa, sw, bias, C, M, N, K, stream);
}

cudaError_t launch_gemm_s8_residual_ln(const int8_t* A, const int8_t* W, const float* sa, const float* sw,
                                       const float* bias, const bf16* resid, const float* gamma,
                                       const float* beta, bf16* out, int M, int N, int K, float eps,
                                       cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % g8l::BK != 0) return cudaErrorInvalidValue;
  switch (N) {
    case 128: return launch_s8_ln<1>(A, W, sa, sw, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 256: return launch_s8_ln<2>(A, W, sa, sw, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 384: return launch_s8_ln<3>(A, W, sa, sw, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 512: return launch_s8_ln<4>(A, W, sa, sw, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 640: return launch_s8_ln<5>(A, W, sa, sw, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 768: return launch_s8_ln<6>(A, W, sa, sw, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 896: return launch_s8_ln<7>(A, W, sa, sw, bias, resid, gamma, beta, out, M, K, eps, stream);
    case 1024: return launch_s8_ln<8>(A, W, sa, sw, bias, resid, gamma, beta, out, M, K, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mdhs
