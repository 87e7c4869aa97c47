// The bf16 sublayers' products on the Hopper wgmma mainloop (gemm_sm90.cuh with
// BF16: TMA ring, wgmma m64nBNk16 .f32.bf16.bf16, persistent grid), shared by
// ffn_block.cu and attention_block.cu:
//
//     tile GEMM:       C   = bf16(act(A @ W^T + b))                  (QKV: no act; FFN GEMM1: GELU)
//     LayerNorm GEMM:  out = LayerNorm((x + A @ W^T) + b) * gamma + beta   (both output products)
//
// These are the matrix products the TPU kernels ran on the MXU
// (mdhs_tpu/ops/attention_block.py::_kernel, mdhs_tpu/ops/ffn_block.py::_kernel),
// at their numerics: float32 accumulation, bias, GELU (ops/gelu.py's order of
// roundings) and the residual in float32, one rounding to bf16; the LayerNorm's
// statistics in float32, the mean and then the centred sum of squares.
//
// The epilogues are the int8 sublayers' (epi_sm90.cuh) on the float32
// accumulator: the tile one stores its bf16 tile through shared memory by TMA;
// the LayerNorm one runs as clusters of H / 128 blocks that merge their rows'
// statistics through distributed shared memory.
//
// The plan. The wrapper (ops/bf16_gemm.py) picks each product's tile width (128,
// or 256 where those tiles fill the card), split count and cluster size, and this
// file launches what it is given. Where the tiles leave most SMs idle (M = 128 is
// 6 blocks for the LayerNorm GEMM at H = 768, 18 for the QKV product, 24 for
// GEMM1), K is split: each (row tile, column tile, split) item writes its float32
// partial tile to a workspace the wrapper allocates (bf16_partial_gemm_kernel),
// and a row pass sums the splits in order and applies the epilogue
// (bias_act_rows_kernel, ln_rows_kernel). A reduction through distributed shared
// memory would keep the partials on chip, but a cluster holds at most 8 blocks
// (16 non-portable): the LayerNorm GEMM's cluster already spans H / 128 = 6 blocks
// for its rows, so it could not split K at all, and the bias GEMMs would reach 72
// blocks only with their whole cluster waiting on its slowest block. The workspace
// costs 4 x S x M x N bytes written and read, 4.7 MB at most at M = 128, which the
// 50 MB L2 holds between the two launches.
//
// What bounds them on the H100: 2 M N K bf16 operations against the weight's 2 N K
// bytes and the activations'; at M = 4096 compute (0.019 ms for an FFN product at
// 989 TFLOP/s), at M = 128 the weights (4.7 MB, 1.4 us at 3.35 TB/s).
#include "epi_sm90.cuh"

namespace mdhs {
namespace {

// ---------------------------------------------------------------------------- kernels
template <int ACT, int BN_>
__global__ void __launch_bounds__(wg::THREADS, wg::Cfg<BN_>::BLOCKS_PER_SM)
    bf16_tile_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                          const __grid_constant__ CUtensorMap tout, TileEpi<wg::BF16, ACT, BN_> epi, int N, int K) {
  epi.tout = &tout;
  wg::gemm_sm90<wg::BF16>(&ta, &tb, epi.M, N, K, epi);
  if (threadIdx.x % 128 == 0) bulk_wait();  // no block leaves before its stores are done
}

__global__ void __launch_bounds__(wg::THREADS, wg::Cfg<BN>::BLOCKS_PER_SM)
    bf16_ln_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                        LnEpi<wg::BF16> epi, int K) {
  wg::gemm_sm90<wg::BF16>(&ta, &tb, epi.M, epi.H, K, epi);
}

// A split's float32 partial tile into work[s] (splits x M x N), from the registers: a
// quad's four float2 stores fill a 32-byte sector of a row.
struct PartialEpi {
  static constexpr bool kCluster = false;
  static constexpr bool kSplit = true;
  static constexpr int BN = mdhs::BN;
  float* work;
  int M, N;
  __device__ void attach(unsigned char*, uint32_t) {}
  __device__ void init() {}
  __device__ void prefetch(const Tile&, int) {}
  __device__ void operator()(float (&acc)[BN / 2], const Tile& t, int cw, int t128) {
    const Lane ln(t, cw, t128);
    float* part = work + static_cast<size_t>(t.s) * M * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = t.n0 + 8 * j + 2 * ln.qd;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (ln.row[i] < M)
          *reinterpret_cast<float2*>(part + static_cast<size_t>(ln.row[i]) * N + col) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
};

__global__ void __launch_bounds__(wg::THREADS, wg::Cfg<BN>::BLOCKS_PER_SM)
    bf16_partial_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                             PartialEpi epi, int K, int splits) {
  wg::gemm_sm90<wg::BF16>(&ta, &tb, epi.M, epi.N, K, epi, splits);
}

// the splits' sum at work[0 .. splits) [i .. i + 4), in split order; the loads of four
// splits are in flight at once
__device__ __forceinline__ float4 split_sum(const float* __restrict__ work, int splits, size_t total, size_t i) {
  float4 v = *reinterpret_cast<const float4*>(work + i);
#pragma unroll 4
  for (int s = 1; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(work + s * total + i);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  return v;
}

// The tile GEMM's row pass after a split: out = bf16(act(sum of the splits + b)), four
// columns a thread.
template <int ACT>
__global__ void __launch_bounds__(256) bias_act_rows_kernel(const float* __restrict__ work, int splits,
                                                            const bf16* __restrict__ b, bf16* __restrict__ out,
                                                            int M, int N) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= total) return;
  const float4 v = split_sum(work, splits, total, i);
  const int col = static_cast<int>(i % N);
  const float2 b01 = ld2(b + col), b23 = ld2(b + col + 2);
  uint2 o;
  o.x = sm90::pack_bf16(activate<ACT>(__fadd_rn(v.x, b01.x)), activate<ACT>(__fadd_rn(v.y, b01.y)));
  o.y = sm90::pack_bf16(activate<ACT>(__fadd_rn(v.z, b23.x)), activate<ACT>(__fadd_rn(v.w, b23.y)));
  *reinterpret_cast<uint2*>(out + i) = o;
}

// the sum of v over the block's H / 4 threads (whole warps, at most 8), on every thread
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // the last call's reads of red are done
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < warps; ++w) t += red[w];
  return t;
}

// The LayerNorm GEMM's row pass after a split: y = (x + sum of the splits) + b, then
// LayerNorm(y) * gamma + beta with the mean and then the centred sum of squares. A block
// a row, H / 4 threads, four columns each: at M = 128 that is 128 blocks, each thread's
// split loads in flight together.
__global__ void __launch_bounds__(kMaxCluster * 32) ln_rows_kernel(const float* __restrict__ work, int splits,
                                                                   const bf16* __restrict__ b,
                                                                   const bf16* __restrict__ x,
                                                                   const bf16* __restrict__ gamma,
                                                                   const bf16* __restrict__ beta,
                                                                   bf16* __restrict__ out, int M, int H, float eps) {
  __shared__ float red[kMaxCluster];
  const int row = blockIdx.x, col = 4 * threadIdx.x;
  const size_t total = static_cast<size_t>(M) * H, i = static_cast<size_t>(row) * H + col;
  const float4 v = split_sum(work, splits, total, i);
  const float2 x01 = ld2(x + i), x23 = ld2(x + i + 2), b01 = ld2(b + col), b23 = ld2(b + col + 2);
  float y[4];
  y[0] = __fadd_rn(__fadd_rn(x01.x, v.x), b01.x);
  y[1] = __fadd_rn(__fadd_rn(x01.y, v.y), b01.y);
  y[2] = __fadd_rn(__fadd_rn(x23.x, v.z), b23.x);
  y[3] = __fadd_rn(__fadd_rn(x23.y, v.w), b23.y);
  const float mu = block_sum((y[0] + y[1]) + (y[2] + y[3]), red) / H;
  float q = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    y[e] -= mu;
    q += y[e] * y[e];
  }
  const float inv = rsqrtf(block_sum(q, red) / H + eps);
  const float2 g01 = ld2(gamma + col), g23 = ld2(gamma + col + 2);
  const float2 e01 = ld2(beta + col), e23 = ld2(beta + col + 2);
  uint2 o;
  o.x = sm90::pack_bf16(y[0] * inv * g01.x + e01.x, y[1] * inv * g01.y + e01.y);
  o.y = sm90::pack_bf16(y[2] * inv * g23.x + e23.x, y[3] * inv * g23.y + e23.y);
  *reinterpret_cast<uint2*>(out + i) = o;
}

// ---------------------------------------------------------------------------- host side
// the split-K product: (row tile, column tile, split) items on a persistent grid, two
// blocks an SM, at most one an item; its partial tiles into work (splits x M x N float32)
cudaError_t run_partial(const CUtensorMap& ta, const void* w, float* work, int M, int N, int K, int splits,
                        cudaStream_t stream) {
  using C = wg::Cfg<BN>;
  constexpr uint32_t bytes = C::smem_bytes(0);
  CUtensorMap tw;
  cudaError_t err = wg::operand_map<wg::BF16>(&tw, w, N, K, BN);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(bf16_partial_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(bytes))) != cudaSuccess)
    return err;
  const int items = (M + wg::BM - 1) / wg::BM * (N / BN) * splits, slots = C::BLOCKS_PER_SM * sms;
  bf16_partial_gemm_kernel<<<items < slots ? items : slots, wg::THREADS, bytes, stream>>>(
      ta, tw, PartialEpi{work, M, N}, K, splits);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t run_tile_gemm(const CUtensorMap& ta, const bf16* W, const bf16* bias, bf16* C, float* work, int M,
                          int N, int K, int width, int splits, cudaStream_t stream) {
  if (splits > 1) {
    cudaError_t err = run_partial(ta, W, work, M, N, K, splits, stream);
    if (err != cudaSuccess) return err;
    const size_t threads = static_cast<size_t>(M) * N / 4;
    bias_act_rows_kernel<ACT><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(work, splits, bias,
                                                                                                C, M, N);
    return cudaGetLastError();
  }
  if (width == 256)
    return run_tile<wg::BF16>(bf16_tile_gemm_kernel<ACT, 256>, ta, W, C,
                              TileEpi<wg::BF16, ACT, 256>{nullptr, nullptr, bias, nullptr, M}, N, K, stream);
  return run_tile<wg::BF16>(bf16_tile_gemm_kernel<ACT, 128>, ta, W, C,
                            TileEpi<wg::BF16, ACT, 128>{nullptr, nullptr, bias, nullptr, M}, N, K, stream);
}

}  // namespace

cudaError_t launch_bf16_tile_gemm(int act, const bf16* A, const bf16* W, const bf16* bias, bf16* C, float* work,
                                  int M, int N, int K, int width, int splits, int cluster, cudaStream_t stream) {
  const int k_steps = K / (wg::BK / 2);
  if (M <= 0 || N <= 0 || N % BN != 0 || K <= 0 || K % (wg::BK / 2) != 0 || (width != 128 && width != 256) ||
      N % width != 0 || splits < 1 || splits > k_steps || (splits > 1 && (width != BN || work == nullptr)) ||
      cluster != 1)
    return cudaErrorInvalidValue;
  CUtensorMap ta;
  cudaError_t err = wg::operand_map<wg::BF16>(&ta, A, M, K, wg::BM);
  if (err != cudaSuccess) return err;
  switch (act) {
    case 0: return run_tile_gemm<0>(ta, W, bias, C, work, M, N, K, width, splits, stream);
    case 1: return run_tile_gemm<1>(ta, W, bias, C, work, M, N, K, width, splits, stream);
    case 2: return run_tile_gemm<2>(ta, W, bias, C, work, M, N, K, width, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16_ln_gemm(const bf16* A, const bf16* W, const bf16* bias, const bf16* resid,
                                const bf16* gamma, const bf16* beta, bf16* out, float* work, int M, int H, int K,
                                float eps, int width, int splits, int cluster, cudaStream_t stream) {
  const int k_steps = K / (wg::BK / 2);
  if (M <= 0 || H <= 0 || H % BN != 0 || H > kMaxCluster * BN || K <= 0 || K % (wg::BK / 2) != 0 || width != BN ||
      splits < 1 || splits > k_steps || cluster != (splits > 1 ? 1 : H / BN) || (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap ta;
  cudaError_t err = wg::operand_map<wg::BF16>(&ta, A, M, K, wg::BM);
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    if ((err = run_partial(ta, W, work, M, H, K, splits, stream)) != cudaSuccess) return err;
    ln_rows_kernel<<<M, H / 4, 0, stream>>>(work, splits, bias, resid, gamma, beta, out, M, H, eps);
    return cudaGetLastError();
  }
  LnEpi<wg::BF16> ln{};
  ln.b2 = bias;
  ln.gamma = gamma;
  ln.beta = beta;
  ln.x = resid;
  ln.out = out;
  ln.M = M;
  ln.H = H;
  ln.eps = eps;
  return run_ln(bf16_ln_gemm_kernel, ta, W, ln, K, stream);
}

}  // namespace mdhs

extern "C" const char* mdhs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The products alone, for the tests and chip_smoke.py: A (M, K), W (N, K), bias (N,), C
// (M, N) bf16; the LayerNorm GEMM's resid, out (M, H), gamma, beta (H,) bf16; work the
// split-K workspace (null unsplit); the plan (width, splits, cluster). Return the first
// CUDA error of the launches, or 0.
extern "C" int bf16_tile_gemm_forward(const void* A, const void* W, const void* bias, void* C, void* work, int M,
                                      int N, int K, int act, int width, int splits, int cluster, void* stream) {
  int device = 0;
  const cudaError_t err = mdhs::sm90::bind_device(&device);
  if (err != cudaSuccess) return err;
  return mdhs::launch_bf16_tile_gemm(act, static_cast<const mdhs::bf16*>(A), static_cast<const mdhs::bf16*>(W),
                                     static_cast<const mdhs::bf16*>(bias), static_cast<mdhs::bf16*>(C),
                                     static_cast<float*>(work), M, N, K, width, splits, cluster,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int bf16_ln_gemm_forward(const void* A, const void* W, const void* bias, const void* resid,
                                    const void* gamma, const void* beta, void* out, void* work, int M, int H, int K,
                                    float eps, int width, int splits, int cluster, void* stream) {
  using mdhs::bf16;
  int device = 0;
  const cudaError_t err = mdhs::sm90::bind_device(&device);
  if (err != cudaSuccess) return err;
  return mdhs::launch_bf16_ln_gemm(static_cast<const bf16*>(A), static_cast<const bf16*>(W),
                                   static_cast<const bf16*>(bias), static_cast<const bf16*>(resid),
                                   static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
                                   static_cast<bf16*>(out), static_cast<float*>(work), M, H, K, eps, width, splits,
                                   cluster, static_cast<cudaStream_t>(stream));
}
