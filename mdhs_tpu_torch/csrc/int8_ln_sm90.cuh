// The epilogue pieces the int8 (a8w8) sublayers share on the s8 wgmma mainloop
// of int8_gemm_sm90.cuh: the dequantize (JAX's rounding order), a thread's place
// in a tile, the row scales loaded as a tile starts, the choice of tile width,
// and the product + residual + LayerNorm epilogue with its clustered launch.
// int8_ffn_block.cu runs its GEMM2 on it (K = Di, the residual x) and
// int8_attention_block.cu its output projection (K = HD, the residual x). Both
// define their own __global__ functions around these pieces.
//
// The LayerNorm GEMM: a cluster of H / 128 blocks (at most 8, so H <= 1024)
// takes the same 128 rows, one 128-column tile each, two blocks an SM. Each
// block puts its rows' sum of y = (x + dequant) + b over its columns and sum
// of (y - its mean)^2 in its own shared memory; after the hardware cluster
// barrier every block reads all of them through distributed shared memory and
// merges them exactly (Chan's combination) into the row's mean and the
// two-pass variance of the JAX kernels; each block writes its columns of the
// bf16 output from the registers.
//
// The definitions sit in the including file's anonymous namespace, as they did
// in int8_ffn_block.cu, so every kernel built on them keeps its symbol and code.
#pragma once

#include "int8_gemm_sm90.cuh"

namespace mdhs {
namespace {

using s8::Tile;

// (float(acc) * sa) * sw, rounded at each step as the JAX kernel's `acc * sx * sw` is
__device__ __forceinline__ float dequant(int acc, float sa, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sw);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A thread's place in a tile: rows r, r + 8 of its warpgroup's 64, column pairs
// 8 j + 2 qd (s8::wgmma_m64nk32's layout).
struct Lane {
  int row[2], qd;
  __device__ Lane(const Tile& t, int cw, int t128) {
    const int r = t.m0 + 64 * cw + 16 * (t128 >> 5) + ((t128 & 31) >> 2);
    row[0] = r;
    row[1] = r + 8;
    qd = t128 & 3;
  }
};

// The row scales of a thread's two rows, loaded as its tile starts: the loads
// complete under the tile's products, not in the epilogue.
__device__ __forceinline__ void load_rows(float (&v)[2], const float* scale, const Tile& t, int tid, int M) {
  const Lane ln(t, tid >> 7, tid & 127);
#pragma unroll
  for (int i = 0; i < 2; ++i) v[i] = ln.row[i] < M ? scale[ln.row[i]] : 0.0f;
}

constexpr int BN = 128;  // the LayerNorm GEMM's tile width, and an unclustered one's when 256 does not fit

// ---------------------------------------------------------------------------- product + residual + LayerNorm
// Shared memory past the ring: this block's (sum, centred sum of squares) of each
// of the tile's 128 rows, two buffers taken by tile parity. One cluster barrier a
// tile orders the writes before every block's reads; a block writes a buffer again
// two tiles later, after the next barrier, which every block joins only when it has
// read the buffer.
constexpr int kMaxCluster = 8;  // H <= 1024, 128-column tiles
constexpr uint32_t kLnExtra = 2 * 2 * s8::BM * 4;

struct LnEpi {
  static constexpr bool kCluster = true;
  static constexpr int BN = mdhs::BN;
  // A's row scales (h's in the FFN, ctx's in the attention block), W's channel scales,
  // the bias, the LayerNorm's scale and shift; x the residual
  const float *sh, *s2, *b2, *gamma, *beta;
  const bf16* x;
  bf16* out;
  int M, H;
  float eps;
  float sa[2];
  uint32_t xr[BN / 8][2];  // the thread's residual values, bf16 pairs
  float* xbuf;     // this block's buffers: [parity][sum, m2][row]
  uint32_t xaddr;  // their shared-memory address
  __device__ void attach(unsigned char* extra, uint32_t extra_addr) {
    xbuf = reinterpret_cast<float*>(extra);
    xaddr = extra_addr;
  }
  __device__ void init() {}
  // the tile's row scales and the thread's residual values, loaded while its products run
  __device__ void prefetch(const Tile& t, int tid) {
    load_rows(sa, sh, t, tid, M);
    const Lane ln(t, tid >> 7, tid & 127);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        xr[j][i] = ln.row[i] < M ? *reinterpret_cast<const uint32_t*>(x + static_cast<size_t>(ln.row[i]) * H + t.n0 +
                                                                       8 * j + 2 * ln.qd)
                                 : 0u;
  }

  // Rows rl and rl + 8 of the tile: from every block's (sum of y, sum of (y - its own
  // mean)^2) over its 128 columns, the row's mean over all H columns and the two-pass
  // variance's centred sum of squares, merged exactly: sum over blocks c of
  // M2_c + 128 (mean_c - mean)^2. The quad's four threads read a quarter of the blocks
  // each; every thread of every block ends with the same two numbers.
  __device__ void row_stats(float (&sum)[2], float (&m2)[2], const Tile& t, int rl, int qd) {
    const int cs = static_cast<int>(s8::cluster_size());
    const uint32_t buf = 2 * s8::BM * (t.it & 1);  // floats
    if (qd == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xbuf[buf + rl + 8 * i] = sum[i];
        xbuf[buf + s8::BM + rl + 8 * i] = m2[i];
      }
    }
    s8::cluster_sync();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t a_sum = xaddr + 4 * (buf + rl + 8 * i), a_m2 = a_sum + 4 * s8::BM;
      float tot = 0.0f;
      for (int src = qd; src < cs; src += 4) tot += s8::ld_cluster(s8::map_rank(a_sum, src));
      const float mu = quad_sum(tot) / H;
      float q = 0.0f;
      for (int src = qd; src < cs; src += 4) {
        const float d = s8::ld_cluster(s8::map_rank(a_sum, src)) / BN - mu;
        q += s8::ld_cluster(s8::map_rank(a_m2, src)) + BN * (d * d);
      }
      sum[i] = mu;
      m2[i] = quad_sum(q);
    }
  }

  __device__ void operator()(int (&acc)[BN / 2], const Tile& t, int cw, int t128) {
    const Lane ln(t, cw, t128);
    const int rl = 64 * cw + 16 * (t128 >> 5) + ((t128 & 31) >> 2);  // row in the tile
    // y = (x + dequant) + b2 in float32 (the JAX kernel's order), in place
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = t.n0 + 8 * j + 2 * ln.qd;
      const float2 sw = *reinterpret_cast<const float2*>(s2 + col);
      const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[j][i]));
        const float y0 = __fadd_rn(__fadd_rn(xv.x, dequant(acc[4 * j + 2 * i], sa[i], sw.x)), bb.x);
        const float y1 = __fadd_rn(__fadd_rn(xv.y, dequant(acc[4 * j + 2 * i + 1], sa[i], sw.y)), bb.y);
        acc[4 * j + 2 * i] = __float_as_int(y0);
        acc[4 * j + 2 * i + 1] = __float_as_int(y1);
        sum[i] += y0 + y1;
      }
    }
    // this block's mean of each row, then the sum of squares about it
    float mu[2], sq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] = quad_sum(sum[i]);
      mu[i] = sum[i] / BN;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float yc = __int_as_float(acc[4 * j + 2 * i + e]) - mu[i];
          sq[i] += yc * yc;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) sq[i] = quad_sum(sq[i]);
    row_stats(sum, sq, t, rl, ln.qd);  // sum: the row's mean; sq: its centred sum of squares
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) inv[i] = rsqrtf(sq[i] / H + eps);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = t.n0 + 8 * j + 2 * ln.qd;
      const float2 g = *reinterpret_cast<const float2*>(gamma + col);
      const float2 be = *reinterpret_cast<const float2*>(beta + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (ln.row[i] >= M) continue;
        const float o0 = (__int_as_float(acc[4 * j + 2 * i]) - sum[i]) * inv[i] * g.x + be.x;
        const float o1 = (__int_as_float(acc[4 * j + 2 * i + 1]) - sum[i]) * inv[i] * g.y + be.y;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(ln.row[i]) * H + col) =
            __floats2bfloat162_rn(o0, o1);
      }
    }
  }
};

// ---------------------------------------------------------------------------- host side
// Whether an unclustered product over (M, N) takes 256-column tiles, one block an SM:
// where N allows and they fill the card. Their mainloop moves 48 KB of L2 traffic per
// 8.4 M operations rather than 32 KB per 4.2 M, which outweighs the epilogues' overlap
// that two blocks an SM give (PERF.md); at few rows the 128-column tiles' twice as
// many blocks win.
inline cudaError_t wide_tiles(int M, int N, bool* wide) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *wide = err == cudaSuccess && N % 256 == 0 && (M + s8::BM - 1) / s8::BM * (N / 256) >= sms;
  return err;
}

// The product + LayerNorm on ``kernel`` (a __global__ function of the including file that
// runs gemm_s8_sm90 with an LnEpi, taking (ta, tb, epi, K)): ``ta`` maps A (M, K) int8,
// ``w`` is W (H, K) int8. A cluster of H / 128 blocks on each row tile, as many clusters
// as are resident at once, at most one a row tile. Its tiles stay 128 wide, two
// blocks an SM: at 256 (one block an SM) the epilogue's exchange and LayerNorm
// no longer overlap a neighbour's products, and it was slower in the FFN (PERF.md).
template <typename Kernel>
cudaError_t run_ln(Kernel kernel, const CUtensorMap& ta, const void* w, const LnEpi& epi, int K, cudaStream_t stream) {
  using C = s8::Cfg<BN>;
  constexpr uint32_t bytes = C::smem_bytes(kLnExtra);
  static_assert(bytes <= kMaxSmemPerBlock, "the LayerNorm kernel exceeds shared memory");
  CUtensorMap tw;
  cudaError_t err = s8::s8_map(&tw, w, epi.H, K, BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int cs = epi.H / BN;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(s8::THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(cs);
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess) return err;
  if (clusters <= 0) return cudaErrorInvalidConfiguration;
  const int row_tiles = (epi.M + s8::BM - 1) / s8::BM;
  cfg.gridDim = dim3(cs * (row_tiles < clusters ? row_tiles : clusters));
  return cudaLaunchKernelEx(&cfg, kernel, ta, tw, epi, K);
}

}  // namespace
}  // namespace mdhs
