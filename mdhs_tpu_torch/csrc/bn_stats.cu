// Per-channel BatchNorm statistics for Hopper: the mean and the biased variance
// over the rows of a channels-last activation x (R, C), bf16 or float32 in,
// float32 out. Training-mode BatchNorm of the ResNet towers
// (models/norm.py::BatchNorm2d with bn_stats_kernel=True).
//
// Replaces the Pallas TPU kernel mdhs_tpu/ops/bn_stats.py::_impl
// (pl.pallas_call at :138). That kernel ran its row blocks in grid order and
// carried a running Chan combine from one grid step to the next. Blocks on the
// card run in no order and share nothing, so the combine is split in two:
//
//   1. bn_stats_partial_kernel: a block owns 32 channels (one a lane) and a
//      group of consecutive rows. It stages each 128-row tile in shared memory
//      as float32, takes the tile's two-pass statistics (the mean, then the sum
//      of squared deviations from it; never E[x^2] - mu^2, whose cancellation
//      mdhs_tpu/models/norm.py:66-73 measured) and merges the tiles in row
//      order with Chan's combine
//          delta = m_b - m_a;  m = m_a + delta * n_b / n;  M2 = M2_a + M2_b + delta^2 * n_a * n_b / n.
//      It writes one (mean, M2) partial per channel and group.
//   2. bn_stats_combine_kernel: for each channel, Chan's combine over the groups
//      in a fixed order (8 strided chains, then the chains in order); var = M2 / R.
//      The result does not depend on how the blocks were scheduled.
//
// What bounds it on the H100: bytes. x is read from device memory once (the
// second pass of each tile reads shared memory), about five float operations
// an element. A warp reads 32 consecutive channels of one row (64 bytes in bf16,
// 128 in float32), and the wrapper (ops/bn_stats.py::_plan) sizes the row
// groups so the grid holds about eight blocks an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;  // channels per block, one a lane
constexpr int kWarps = 8;  // row strides per block
constexpr int kTile = 128; // rows staged in shared memory at a time

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Chan's combine of (n_b, mean_b, m2_b) into (n_a, mean_a, m2_a); n_a may be 0.
__device__ __forceinline__ void chan_combine(float& n_a, float& mean_a, float& m2_a, float n_b,
                                             float mean_b, float m2_b) {
  if (n_b == 0.0f) return;
  if (n_a == 0.0f) {
    n_a = n_b;
    mean_a = mean_b;
    m2_a = m2_b;
    return;
  }
  const float n = n_a + n_b;
  const float delta = mean_b - mean_a;
  mean_a = mean_a + delta * (n_b / n);
  m2_a = m2_a + m2_b + delta * delta * (n_a * n_b / n);
  n_a = n;
}

template <typename T>
__global__ void __launch_bounds__(kCols * kWarps)
    bn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ pmean,
                            float* __restrict__ pm2, int R, int C, int rows_per_group) {
  __shared__ float tile[kTile][kCols];
  __shared__ float red[kWarps][kCols];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int c = blockIdx.x * kCols + lane;
  const int g = blockIdx.y;
  const int row_begin = g * rows_per_group;
  const int row_end = min(R, row_begin + rows_per_group);
  float n_a = 0.0f, mean_a = 0.0f, m2_a = 0.0f;
  for (int t0 = row_begin; t0 < row_end; t0 += kTile) {
    const int nt = min(kTile, row_end - t0);
    float s = 0.0f;
    for (int r = w; r < nt; r += kWarps) {
      const float v = c < C ? to_float(x[static_cast<size_t>(t0 + r) * C + c]) : 0.0f;
      tile[r][lane] = v;
      s += v;
    }
    red[w][lane] = s;
    __syncthreads();
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += red[k][lane];
    const float mean_b = sum / static_cast<float>(nt);
    __syncthreads();  // every warp has read red before it is reused
    float q = 0.0f;
    for (int r = w; r < nt; r += kWarps) {
      const float dv = tile[r][lane] - mean_b;
      q += dv * dv;
    }
    red[w][lane] = q;
    __syncthreads();
    float m2_b = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) m2_b += red[k][lane];
    chan_combine(n_a, mean_a, m2_a, static_cast<float>(nt), mean_b, m2_b);
    __syncthreads();  // tile and red are rewritten by the next tile
  }
  if (w == 0 && c < C) {
    pmean[static_cast<size_t>(g) * C + c] = mean_a;
    pm2[static_cast<size_t>(g) * C + c] = m2_a;
  }
}

__global__ void __launch_bounds__(kCols * kWarps)
    bn_stats_combine_kernel(const float* __restrict__ pmean, const float* __restrict__ pm2,
                            float* __restrict__ mean, float* __restrict__ var, int R, int C,
                            int groups, int rows_per_group) {
  __shared__ float sn[kWarps][kCols], sm[kWarps][kCols], sq[kWarps][kCols];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int c = blockIdx.x * kCols + lane;
  float n_a = 0.0f, mean_a = 0.0f, m2_a = 0.0f;
  if (c < C) {
    for (int g = w; g < groups; g += kWarps) {
      const float n_b = static_cast<float>(min(rows_per_group, R - g * rows_per_group));
      chan_combine(n_a, mean_a, m2_a, n_b, pmean[static_cast<size_t>(g) * C + c],
                   pm2[static_cast<size_t>(g) * C + c]);
    }
  }
  sn[w][lane] = n_a;
  sm[w][lane] = mean_a;
  sq[w][lane] = m2_a;
  __syncthreads();
  if (w == 0 && c < C) {
    for (int k = 1; k < kWarps; ++k) chan_combine(n_a, mean_a, m2_a, sn[k][lane], sm[k][lane], sq[k][lane]);
    mean[c] = mean_a;
    var[c] = m2_a / static_cast<float>(R);
  }
}

}  // namespace

// dtype: 0 float32, 1 bf16. pmean and pm2 are (groups, C) float32 scratch;
// mean and var are (C,) float32. groups == ceil(R / rows_per_group), and
// rows_per_group is a multiple of the 128-row tile.
extern "C" int bn_stats_forward(const void* x, int dtype, void* pmean, void* pm2, void* mean,
                                void* var, int R, int C, int rows_per_group, int groups,
                                void* stream) {
  if (R <= 0 || C <= 0 || rows_per_group <= 0 || rows_per_group % kTile != 0) return cudaErrorInvalidValue;
  if (groups != (R + rows_per_group - 1) / rows_per_group || groups > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kCols, kWarps);
  const unsigned col_tiles = static_cast<unsigned>((C + kCols - 1) / kCols);
  auto* pm = static_cast<float*>(pmean);
  auto* pq = static_cast<float*>(pm2);
  switch (dtype) {
    case 0:
      bn_stats_partial_kernel<float><<<dim3(col_tiles, groups), block, 0, s>>>(
          static_cast<const float*>(x), pm, pq, R, C, rows_per_group);
      break;
    case 1:
      bn_stats_partial_kernel<__nv_bfloat16><<<dim3(col_tiles, groups), block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), pm, pq, R, C, rows_per_group);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_stats_combine_kernel<<<col_tiles, block, 0, s>>>(pm, pq, static_cast<float*>(mean),
                                                      static_cast<float*>(var), R, C, groups,
                                                      rows_per_group);
  return cudaGetLastError();
}
