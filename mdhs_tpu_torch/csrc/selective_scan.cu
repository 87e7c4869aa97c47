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
// the states n = g, g + T, g + 2T, ... (S of them, N <= S T). y_t is the
// group's sum, taken with shuffles within the T lanes. T = 2 at N <= 16
// (MambaVision's N 8, the baseline's SSM fusion's N 16: S = 8, which measured
// faster on the H100 than T = 4 or 8 there, PERF.md), 8 above (S = 16 at the
// multimodal Mamba fusion's N 128).
//
// A block is 128 threads: 128 / T channels of one batch row. Its x and dt
// tiles (kChunk time steps x its channels) and the row's B and C (kChunk x N,
// zero-filled to T S states, so a step has no branch on n < N)
// come into shared memory by asynchronous copies (cp.async), double-buffered:
// chunk c + 1 is in flight while the chains walk chunk c, reading only
// registers and shared memory. y is staged in shared memory and leaves a
// chunk at a time as whole rows of the block's channels, coalesced. The
// copies are cp.async of 4 bytes, not TMA or cp.async.bulk: those take row
// pitches and starts that are multiples of 16 bytes, and the gate takes any D
// and N (N 17, D 130), while a warp's 4-byte copies of one row are coalesced
// all the same.
//
// What bounds it on the H100: bytes. It reads x and dt once, writes y once
// (12 bytes per (b, t, d)) and does about 7 float operations and one expf per
// state per step. At the baseline fusion's (64, 49, 512), N 16, that is 19.7 MB
// (5.9 us at 3.35 TB/s) for 32,768 chains of 49 steps, which at T = 2 are
// 512 blocks: about 15 warps an SM. Its time is the steps' instructions (an
// expf and 6 float operations a state), not the bytes.
//
// expf, not __expf, and the recurrence's order of operations in a step: the
// result is held to float32 math (no --use_fast_math).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kChunk = 16;     // time steps a copy stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from device memory into shared memory, asynchronously; zero where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory: two copy stages of [x | dt | B | C], then y's chunk.
template <int T, int S>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                          const float* __restrict__ Bm, const float* __restrict__ Cm,
                          const float* __restrict__ Dskip, float* __restrict__ y, int L, int D, int N) {
  constexpr int DC = kThreads / T;  // channels of the block
  constexpr int NP = T * S;         // a step's B and C in shared memory, zero past N: no branch on n < N
  extern __shared__ float smem[];
  constexpr int stage = 2 * kChunk * DC + 2 * kChunk * NP;  // floats of one copy stage
  float* sy = smem + 2 * stage;

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * DC;
  const int g = threadIdx.x % T;  // lane within the group: states g, g + T, ...
  const int ch = threadIdx.x / T;
  const int d = d0 + ch;
  const bool active = d < D;

  float a[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = g + T * s;
    a[s] = (active && n < N) ? A[static_cast<long long>(d) * N + n] : 0.0f;
    h[s] = 0.0f;
  }
  const float dskip = active ? Dskip[d] : 0.0f;

  const long long row = static_cast<long long>(b) * L;
  // chunk c's copies into stage c % 2: x, dt (kChunk x DC, channels fastest), B, C (kChunk x NP)
  auto issue = [&](int c) {
    float* sx = smem + (c & 1) * stage;
    float* sdt = sx + kChunk * DC;
    float* sB = sdt + kChunk * DC;
    float* sC = sB + kChunk * NP;
    const int t0 = c * kChunk, steps = min(kChunk, L - t0);
    for (int i = threadIdx.x; i < kChunk * DC; i += kThreads) {
      const int k = i / DC, j = i % DC;
      const bool ok = k < steps && d0 + j < D;
      const long long off = ok ? (row + t0 + k) * D + d0 + j : 0;
      cp_async4(sx + i, x + off, ok);
      cp_async4(sdt + i, dt + off, ok);
    }
    for (int i = threadIdx.x; i < kChunk * NP; i += kThreads) {
      const int k = i / NP, n = i % NP;
      const bool ok = k < steps && n < N;
      const long long off = ok ? (row + t0 + k) * N + n : 0;
      cp_async4(sB + i, Bm + off, ok);
      cp_async4(sC + i, Cm + off, ok);
    }
    cp_async_commit();
  };

  const int chunks = (L + kChunk - 1) / kChunk;
  issue(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      issue(c + 1);
      cp_async_wait<1>();  // chunk c has landed (c + 1 may still be in flight)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sx = smem + (c & 1) * stage;
    const float* sdt = sx + kChunk * DC;
    const float* sB = sdt + kChunk * DC;
    const float* sC = sB + kChunk * NP;
    const int t0 = c * kChunk, steps = min(kChunk, L - t0);
    for (int k = 0; k < steps; ++k) {
      const float dt_t = sdt[k * DC + ch];
      const float x_t = sx[k * DC + ch];
      const float dtx = dt_t * x_t;
      const float* bt = sB + k * NP;
      const float* ct = sC + k * NP;
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) {  // a state past N has a = B = C = 0: h stays 0
        const int n = g + T * s;
        h[s] = expf(dt_t * a[s]) * h[s] + dtx * bt[n];
        acc += h[s] * ct[n];
      }
#pragma unroll
      for (int o = T / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o, T);
      if (g == 0) sy[k * DC + ch] = acc + dskip * x_t;
    }
    __syncthreads();  // y's chunk is whole, and this stage is read (chunk c + 2 reuses it)
    for (int i = threadIdx.x; i < steps * DC; i += kThreads) {
      const int k = i / DC, j = i % DC;
      if (d0 + j < D) y[(row + t0 + k) * D + d0 + j] = sy[i];
    }
  }
}

template <int T, int S>
cudaError_t launch(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
                   const float* Dskip, float* y, int batch, int L, int D, int N, cudaStream_t stream) {
  constexpr int DC = kThreads / T;
  const dim3 grid((D + DC - 1) / DC, batch);
  const size_t smem = (2 * (2 * static_cast<size_t>(kChunk) * DC + 2 * static_cast<size_t>(kChunk) * T * S) +
                       static_cast<size_t>(kChunk) * DC) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(selective_scan_kernel<T, S>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  selective_scan_kernel<T, S><<<grid, kThreads, smem, stream>>>(x, dt, A, Bm, Cm, Dskip, y, L, D, N);
  return cudaGetLastError();
}

}  // namespace

// Group size T and states a thread S: T 2 at N <= 16 (S 4 or 8), 8 above (S 4, 8 or 16). The gate (ops/selective_scan.py::supports) takes 1 <= N <= 128.
extern "C" int selective_scan_forward(const void* x, const void* dt, const void* A, const void* Bm,
                                      const void* Cm, const void* Dskip, void* y, int batch, int L,
                                      int D, int N, void* stream) {
  if (batch <= 0 || L <= 0 || D <= 0 || N <= 0 || N > 128 || batch > 65535) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* out = static_cast<float*>(y);
  if (N <= 8) return launch<2, 4>(f(x), f(dt), f(A), f(Bm), f(Cm), f(Dskip), out, batch, L, D, N, s);
  if (N <= 16) return launch<2, 8>(f(x), f(dt), f(A), f(Bm), f(Cm), f(Dskip), out, batch, L, D, N, s);
  if (N <= 32) return launch<8, 4>(f(x), f(dt), f(A), f(Bm), f(Cm), f(Dskip), out, batch, L, D, N, s);
  if (N <= 64) return launch<8, 8>(f(x), f(dt), f(A), f(Bm), f(Cm), f(Dskip), out, batch, L, D, N, s);
  return launch<8, 16>(f(x), f(dt), f(A), f(Bm), f(Cm), f(Dskip), out, batch, L, D, N, s);
}
