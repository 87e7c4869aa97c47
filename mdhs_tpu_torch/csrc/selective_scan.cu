// Selective scan (the Mamba recurrence) for Hopper, eval forward, float32:
//
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t        (h in R^N, per (b, d))
//     y_t = <C_t, h_t> + D_skip * x_t
//
// x, dt, y are (batch, L, D); A is (D, N); B, C are (batch, L, N); D_skip is (D,).
//
// Replaces the Pallas TPU kernel mdhs_tpu/ops/selective_scan.py::_scan_kernel
// (pl.pallas_call at :112). That kernel walks 128-channel lane blocks of one
// batch row with an (N, 128) VMEM state, sequentially over L. Here the time
// loop stays sequential inside a thread group, and the state lives in
// registers: a group of T threads owns one (b, d) pair, each thread holding
// the states n = g, g + T, g + 2T, ... (at most kStates of them), so N <= 16 T.
// y_t is the group's sum, taken with shuffles within the T lanes. T = 1 for
// N <= 16 (the baseline's SSM fusion, N 16; MambaVision, N 8), up to T = 8 for
// N <= 128 (the multimodal Mamba fusion).
//
// Each block covers 128 / T channels of one batch row. The row's B and C are
// staged in shared memory kChunk time steps at a time; x_t and dt_t are read
// straight from device memory, coalesced across the block's channels.
//
// What bounds it on the H100: bytes. It reads x and dt once, writes y once
// (12 bytes per (b, t, d)) and does about 6 float operations and one expf per
// state per step. At the baseline fusion's (64, 49, 512), N 16, that is 19.7 MB
// (5.9 us at 3.35 TB/s) for 8192 independent chains of 49 steps; the design
// keeps every chain in registers and makes one pass, and its speed is set by
// the sequential chain length, not by the traffic.
//
// expf, not __expf: the result is held to float32 math (no --use_fast_math).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kStates = 16;    // states per thread
constexpr int kChunk = 32;     // time steps of B and C staged per pass

template <int T>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, const float* __restrict__ Dskip,
                          float* __restrict__ y, int L, int D, int N) {
  extern __shared__ float smem[];  // [2][kChunk][N]: B then C
  float* sB = smem;
  float* sC = smem + kChunk * N;

  const int b = blockIdx.y;
  const int g = threadIdx.x % T;  // lane within the group: states g, g + T, ...
  const int d = blockIdx.x * (kThreads / T) + threadIdx.x / T;
  const bool active = d < D;

  float a[kStates], h[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    const int n = g + T * s;
    a[s] = (active && n < N) ? A[static_cast<long long>(d) * N + n] : 0.0f;
    h[s] = 0.0f;
  }
  const float dskip = active ? Dskip[d] : 0.0f;

  const long long row = static_cast<long long>(b) * L;
  const float* Brow = Bm + row * N;
  const float* Crow = Cm + row * N;
  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int steps = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk has been read
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      sB[i] = Brow[static_cast<long long>(t0) * N + i];
      sC[i] = Crow[static_cast<long long>(t0) * N + i];
    }
    __syncthreads();
    for (int k = 0; k < steps; ++k) {
      const long long off = (row + t0 + k) * D + d;
      const float dt_t = active ? dt[off] : 0.0f;
      const float x_t = active ? x[off] : 0.0f;
      const float dtx = dt_t * x_t;
      const float* bt = sB + k * N;
      const float* ct = sC + k * N;
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < kStates; ++s) {
        const int n = g + T * s;
        if (n < N) {
          h[s] = expf(dt_t * a[s]) * h[s] + dtx * bt[n];
          acc += h[s] * ct[n];
        }
      }
#pragma unroll
      for (int o = T / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o, T);
      if (active && g == 0) y[off] = acc + dskip * x_t;
    }
  }
}

template <int T>
cudaError_t launch(const float* x, const float* dt, const float* A, const float* Bm,
                   const float* Cm, const float* Dskip, float* y, int batch, int L, int D, int N,
                   cudaStream_t stream) {
  constexpr int per_block = kThreads / T;
  const dim3 grid((D + per_block - 1) / per_block, batch);
  const size_t smem = 2 * static_cast<size_t>(kChunk) * N * sizeof(float);
  selective_scan_kernel<T><<<grid, kThreads, smem, stream>>>(x, dt, A, Bm, Cm, Dskip, y, L, D, N);
  return cudaGetLastError();
}

}  // namespace

// Group size T = the smallest power of two with N <= 16 T; the gate
// (ops/selective_scan.py::supports) takes 1 <= N <= 128.
extern "C" int selective_scan_forward(const void* x, const void* dt, const void* A, const void* Bm,
                                      const void* Cm, const void* Dskip, void* y, int batch, int L,
                                      int D, int N, void* stream) {
  if (batch <= 0 || L <= 0 || D <= 0 || N <= 0 || N > 8 * kStates || batch > 65535)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* out = static_cast<float*>(y);
  if (N <= kStates) return launch<1>(f(x), f(dt), f(A), f(Bm), f(Cm), f(Dskip), out, batch, L, D, N, s);
  if (N <= 2 * kStates) return launch<2>(f(x), f(dt), f(A), f(Bm), f(Cm), f(Dskip), out, batch, L, D, N, s);
  if (N <= 4 * kStates) return launch<4>(f(x), f(dt), f(A), f(Bm), f(Cm), f(Dskip), out, batch, L, D, N, s);
  return launch<8>(f(x), f(dt), f(A), f(Bm), f(Cm), f(Dskip), out, batch, L, D, N, s);
}
