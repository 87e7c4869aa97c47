// KANLinear forward for Hopper, float32, over a bank of experts:
//
//     y[e, b, o] = sum_i silu(x[e, b, i]) * Wb[e, o, i]
//                + sum_i sum_c bases_c(x[e, b, i]; grid[e, i, :]) * Ws[e, o, i, c]
//
// x is (E, B, IN), or (B, IN) shared by every expert (x_shared: its expert
// stride is 0, as nn.vmap(in_axes=None) hands layer 0 of the MoE bank one x);
// grid is (E, IN, P), Wb (E, OUT, IN), Ws (E, OUT, IN, C) already scaled;
// y is (E, B, OUT). The bases are the cubic B-splines of efficient-KAN on
// P = 12 knots (grid_size 5, spline_order 3: C = 8 coefficients), by the
// Cox-de Boor recursion with mdhs_tpu/modules/kan.py::b_splines' formula and
// true division.
//
// Replaces the Pallas TPU kernel mdhs_tpu/ops/kan_spline.py::_kernel
// (pl.pallas_call at :114), vmapped over the experts. Like it, this reads the
// product as one GEMM with K = IN * (C + 1) whose A operand (silu(x) and the C
// bases of each input) is made on chip from x and never stored in device
// memory: each block generates the A tile of kInputs inputs at a time in
// shared memory, beside the matching slice of Wb and Ws, and accumulates a
// kRows x kCols output tile in registers. The expert axis is the grid's z.
// The TPU's 128-row and 128-column padding is gone: ragged batch rows,
// outputs (the classifier layer's OUT = 7) and inputs are masked.
//
// Split K: the grid's y also splits the inputs into `splits` ranges, so that a
// layer with few output tiles (OUT = 7: one tile) still fills the card; each
// range writes its partial sums to a float32 workspace, and a second kernel
// adds the ranges in order (the result does not depend on scheduling). With
// one range the first kernel writes y itself.
//
// Only 4 of the 8 cubic bases of an input are nonzero: the recursion runs on
// the window of knots around x's interval, the entries the full recursion
// would compute from nonzero terms, with the same formula (an entry whose
// terms are both zero is exactly zero there too), so the result is the full
// recursion's at a third of its divisions.
//
// What bounds it on the H100: at layer 0 of the baseline MoE head (x (64, 256)
// shared, 4 experts, OUT 1024) operations, 1.21 GFLOP of float32 FMAs
// (18 us at 67 TFLOP/s) against 38.8 MB of weights (11.6 us at 3.35 TB/s).
// The products run as float32 FMAs on the CUDA cores: TF32 tensor cores would
// break float32 parity with the JAX package. This version is simple:
// shared-memory operands, 8 outputs a thread.
#include <cuda_runtime.h>

namespace {

constexpr int kPts = 12;              // knots per input (grid_size + 2 * order + 1)
constexpr int kOrder = 3;             // spline order
constexpr int kCoeff = kPts - 1 - kOrder;  // 8 bases per input
constexpr int kPer = kCoeff + 1;      // K entries per input: silu, then the bases
constexpr int kRows = 32;             // batch rows per block
constexpr int kCols = 64;             // outputs per block
constexpr int kInputs = 8;            // inputs per K chunk
constexpr int kChunkK = kInputs * kPer;  // 72
constexpr int kStride = kChunkK + 1;  // shared row stride (odd: conflict-free columns)
constexpr int kThreads = 256;         // 16 x 16; each thread 2 rows x 4 outputs

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// silu(v) and the kCoeff cubic bases of v on the knots g (kPts of them, in device
// memory: the window reads them at a data-dependent offset) into a[0 .. kCoeff].
__device__ __forceinline__ void basis_row(float v, const float* __restrict__ g, float* a) {
  a[0] = silu(v);
#pragma unroll
  for (int c = 0; c < kCoeff; ++c) a[1 + c] = 0.0f;
  int s = -1;  // the interval g[s] <= v < g[s + 1] (none outside the knots)
#pragma unroll
  for (int j = 0; j < kPts - 1; ++j)
    if (v >= g[j] && v < g[j + 1]) s = j;
  if (s < 0) return;
  // window position p stands for base index j = s - kOrder + p; knot gw[t] = g[s - kOrder + t]
  float gw[2 * kOrder + 2];
#pragma unroll
  for (int t = 0; t < 2 * kOrder + 2; ++t) gw[t] = g[min(max(s - kOrder + t, 0), kPts - 1)];
  float n[kOrder + 2];
#pragma unroll
  for (int p = 0; p < kOrder + 2; ++p) n[p] = p == kOrder ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 1; k <= kOrder; ++k) {
#pragma unroll
    for (int p = kOrder - k; p <= kOrder; ++p) {  // the entries with a nonzero term
      const float left = (v - gw[p]) / (gw[p + k] - gw[p]);
      const float right = (gw[p + k + 1] - v) / (gw[p + k + 1] - gw[p + 1]);
      n[p] = left * n[p] + right * n[p + 1];
    }
  }
#pragma unroll
  for (int p = 0; p <= kOrder; ++p) {
    const int j = s - kOrder + p;
    if (j >= 0 && j < kCoeff) a[1 + j] = n[p];
  }
}

__global__ void __launch_bounds__(kThreads)
    kan_forward_kernel(const float* __restrict__ x, const float* __restrict__ grid,
                       const float* __restrict__ bw, const float* __restrict__ sw,
                       float* __restrict__ out, int E, int B, int IN, int OUT, long long x_expert_stride,
                       int row_tiles, int inputs_per_split) {
  __shared__ float sA[kRows * kStride];  // [row][k]
  __shared__ float sW[kCols * kStride];  // [output][k]

  const int e = blockIdx.z;
  const int split = blockIdx.y / row_tiles;
  const int row0 = (blockIdx.y % row_tiles) * kRows;
  const int col0 = blockIdx.x * kCols;
  const int in_begin = split * inputs_per_split;
  const int in_end = min(IN, in_begin + inputs_per_split);
  const float* xe = x + e * x_expert_stride;
  const float* ge = grid + static_cast<long long>(e) * IN * kPts;
  const float* bwe = bw + static_cast<long long>(e) * OUT * IN;
  const float* swe = sw + static_cast<long long>(e) * OUT * IN * kCoeff;

  const int tn = threadIdx.x % 16;  // outputs tn + 16 j
  const int tm = threadIdx.x / 16;  // rows tm + 16 r
  float acc[2][4] = {};

  for (int i0 = in_begin; i0 < in_end; i0 += kInputs) {
    __syncthreads();  // the previous chunk has been read
    {
      // A tile: one (row, input) pair a thread, rows fastest (kRows * kInputs == kThreads)
      const int m = threadIdx.x % kRows;
      const int i = threadIdx.x / kRows;
      float* a = sA + m * kStride + i * kPer;
      if (row0 + m < B && i0 + i < in_end) {
        basis_row(xe[static_cast<long long>(row0 + m) * IN + i0 + i], ge + static_cast<long long>(i0 + i) * kPts, a);
      } else {
#pragma unroll
        for (int c = 0; c < kPer; ++c) a[c] = 0.0f;
      }
    }
    // W tile: kCols outputs x (kInputs base weights, then kInputs * kCoeff spline
    // weights), each output's runs contiguous in device memory
    for (int idx = threadIdx.x; idx < kCols * kChunkK; idx += kThreads) {
      const int o = idx / kChunkK;
      const int r = idx % kChunkK;
      float w = 0.0f;
      int k;
      if (r < kInputs) {
        k = r * kPer;
        if (col0 + o < OUT && i0 + r < in_end) w = bwe[static_cast<long long>(col0 + o) * IN + i0 + r];
      } else {
        const int i = (r - kInputs) / kCoeff;
        const int c = (r - kInputs) % kCoeff;
        k = i * kPer + 1 + c;
        if (col0 + o < OUT && i0 + i < in_end)
          w = swe[(static_cast<long long>(col0 + o) * IN + i0 + i) * kCoeff + c];
      }
      sW[o * kStride + k] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunkK; ++k) {
      float av[2], wv[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) av[r] = sA[(tm + 16 * r) * kStride + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = sW[(tn + 16 * j) * kStride + k];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] += av[r] * wv[j];
    }
  }

  // y (one split) or this split's slice of the workspace (splits, E, B, OUT)
  float* oe = out + (static_cast<long long>(split) * E + e) * B * OUT;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = row0 + tm + 16 * r;
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = col0 + tn + 16 * j;
      if (o < OUT) oe[static_cast<long long>(m) * OUT + o] = acc[r][j];
    }
  }
}

// y[n] = sum over s of ws[s, n], s in order
__global__ void kan_split_sum_kernel(const float* __restrict__ ws, float* __restrict__ y, long long n,
                                     int splits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float v = ws[idx];
  for (int s = 1; s < splits; ++s) v += ws[s * n + idx];
  y[idx] = v;
}

}  // namespace

// The gate (ops/kan_spline.py::supports): P = 12 knots and spline order 3,
// E at most 65535, row tiles times splits at most 65535. ws holds
// splits * E * B * OUT floats when splits > 1 (unused otherwise);
// inputs_per_split is a multiple of 8.
extern "C" int kan_forward(const void* x, const void* grid, const void* bw, const void* sw, void* y, void* ws,
                           int E, int B, int IN, int OUT, int x_shared, int splits, int inputs_per_split,
                           void* stream) {
  const int row_tiles = (B + kRows - 1) / kRows;
  if (E <= 0 || B <= 0 || IN <= 0 || OUT <= 0 || E > 65535 || splits <= 0 ||
      static_cast<long long>(row_tiles) * splits > 65535 || inputs_per_split % kInputs != 0 ||
      static_cast<long long>(inputs_per_split) * splits < IN || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid_dim((OUT + kCols - 1) / kCols, row_tiles * splits, E);
  const long long x_stride = x_shared ? 0 : static_cast<long long>(B) * IN;
  float* out = static_cast<float*>(splits > 1 ? ws : y);
  kan_forward_kernel<<<grid_dim, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(grid), static_cast<const float*>(bw),
      static_cast<const float*>(sw), out, E, B, IN, OUT, x_stride, row_tiles, inputs_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = static_cast<long long>(E) * B * OUT;
  kan_split_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(y), n, splits);
  return cudaGetLastError();
}
