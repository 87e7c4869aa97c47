// The epilogue pieces the sublayers share on the wgmma mainloop of
// gemm_sm90.cuh, for both operand types: a thread's place in a tile, the GELU
// in the plain version's order of roundings, the product + residual +
// LayerNorm epilogue with its clustered launch (LnEpi), and the bf16 tile
// stored through shared memory by TMA (TileEpi). The int8 sublayers read their
// accumulators through the dequantize (JAX's rounding order) and the row
// scales loaded as a tile starts; the bf16 ones take the float32 accumulator
// as it is. The rest of each epilogue is the same code for both:
//   - LnEpi: int8_ffn_block.cu's GEMM2 (K = Di) and int8_attention_block.cu's
//     output projection (K = HD) with S8, bf16_gemm.cu's LayerNorm GEMM (both
//     bf16 sublayers: K = Di and K = HD) with BF16;
//   - TileEpi: int8_attention_block.cu's QKV product with S8, bf16_gemm.cu's
//     QKV product and FFN GEMM1 (bias + GELU) with BF16.
// Each source defines its own __global__ functions around these pieces.
//
// The LayerNorm GEMM: a cluster of H / 128 blocks (at most 8, so H <= 1024)
// takes the same 128 rows, one 128-column tile each, two blocks an SM. Each
// block puts its rows' sum of y = (x + product) + b over its columns and sum
// of (y - its mean)^2 in its own shared memory; after the hardware cluster
// barrier every block reads all of them through distributed shared memory and
// merges them exactly (Chan's combination) into the row's mean and the
// two-pass variance of the JAX kernels; each block writes its columns of the
// bf16 output from the registers.
//
// The definitions sit in the including file's anonymous namespace, so every
// kernel built on them keeps its symbol and code.
#pragma once

#include <type_traits>

#include "gemm_sm90.cuh"

namespace mdhs {
namespace {

using wg::Tile;

template <class Op>
constexpr bool kIsS8 = std::is_same<Op, wg::S8>::value;

// (float(acc) * sa) * sw, rounded at each step as the JAX kernel's `acc * sx * sw` is
__device__ __forceinline__ float dequant(int acc, float sa, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sw);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a float32 value kept in an accumulator register of either type
__device__ __forceinline__ float get_f(int a) { return __int_as_float(a); }
__device__ __forceinline__ float get_f(float a) { return a; }
__device__ __forceinline__ void put_f(int& a, float v) { a = __float_as_int(v); }
__device__ __forceinline__ void put_f(float& a, float v) { a = v; }

// two neighbouring values of a float32 or bf16 vector, as float32
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A thread's place in a tile: rows r, r + 8 of its warpgroup's 64, column pairs
// 8 j + 2 qd (the wgmma accumulator layout, gemm_sm90.cuh).
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

// ops/gelu.py's order of roundings: (0.5 x) * (1 + erf(x * (1 / sqrt 2))) (ACT 0), or
// (0.5 x) * (1 + tanh(sqrt(2 / pi) * (x + ((0.044715 x) x) x))) (ACT 1)
template <int ACT>
__device__ __forceinline__ float gelu(float v) {
  const float half_v = __fmul_rn(0.5f, v);
  if (ACT == 0) return __fmul_rn(half_v, __fadd_rn(1.0f, erff(__fmul_rn(v, 0.70710678118654752f))));
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, v), v), v);
  return __fmul_rn(half_v, __fadd_rn(1.0f, tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(v, cube)))));
}

// A tile epilogue's activation: 0 none, 1 erf-GELU, 2 tanh-GELU (the C interface's act + 1)
template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == 0) return v;
  else return gelu<ACT - 1>(v);
}

constexpr int BN = 128;  // the LayerNorm GEMM's tile width, and an unclustered one's when 256 does not fit

// ---------------------------------------------------------------------------- product + residual + LayerNorm
// Shared memory past the ring: this block's (sum, centred sum of squares) of each
// of the tile's 128 rows, two buffers taken by tile parity. One cluster barrier a
// tile orders the writes before every block's reads; a block writes a buffer again
// two tiles later, after the next barrier, which every block joins only when it has
// read the buffer.
constexpr int kMaxCluster = 8;  // H <= 1024, 128-column tiles
constexpr uint32_t kLnExtra = 2 * 2 * wg::BM * 4;

// y = (x + product) + b2 over H columns, then LayerNorm(y) * gamma + beta in bf16. The
// product: S8, float(acc) * sh[row] * s2[col] (the dequantize; the vectors float32); BF16,
// the float32 accumulator (the vectors bf16, sh and s2 unused).
template <class Op>
struct LnEpi {
  using Vec = std::conditional_t<kIsS8<Op>, float, bf16>;
  static constexpr bool kCluster = true;
  static constexpr int BN = mdhs::BN;
  // A's row scales (h's in the FFN, ctx's in the attention block), W's channel scales,
  // the bias, the LayerNorm's scale and shift; x the residual
  const float *sh, *s2;
  const Vec *b2, *gamma, *beta;
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
    if constexpr (kIsS8<Op>) load_rows(sa, sh, t, tid, M);
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
    const int cs = static_cast<int>(wg::cluster_size());
    const uint32_t buf = 2 * wg::BM * (t.it & 1);  // floats
    if (qd == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xbuf[buf + rl + 8 * i] = sum[i];
        xbuf[buf + wg::BM + rl + 8 * i] = m2[i];
      }
    }
    wg::cluster_sync();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t a_sum = xaddr + 4 * (buf + rl + 8 * i), a_m2 = a_sum + 4 * wg::BM;
      float tot = 0.0f;
      for (int src = qd; src < cs; src += 4) tot += wg::ld_cluster(wg::map_rank(a_sum, src));
      const float mu = quad_sum(tot) / H;
      float q = 0.0f;
      for (int src = qd; src < cs; src += 4) {
        const float d = wg::ld_cluster(wg::map_rank(a_sum, src)) / BN - mu;
        q += wg::ld_cluster(wg::map_rank(a_m2, src)) + BN * (d * d);
      }
      sum[i] = mu;
      m2[i] = quad_sum(q);
    }
  }

  __device__ void operator()(typename Op::Acc (&acc)[BN / 2], const Tile& t, int cw, int t128) {
    const Lane ln(t, cw, t128);
    const int rl = 64 * cw + 16 * (t128 >> 5) + ((t128 & 31) >> 2);  // row in the tile
    // y = (x + product) + b2 in float32 (the JAX kernel's order), in place
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = t.n0 + 8 * j + 2 * ln.qd;
      float2 sw;
      if constexpr (kIsS8<Op>) sw = ld2(s2 + col);
      const float2 bb = ld2(b2 + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[j][i]));
        float p0, p1;
        if constexpr (kIsS8<Op>) {
          p0 = dequant(acc[4 * j + 2 * i], sa[i], sw.x);
          p1 = dequant(acc[4 * j + 2 * i + 1], sa[i], sw.y);
        } else {
          p0 = acc[4 * j + 2 * i];
          p1 = acc[4 * j + 2 * i + 1];
        }
        const float y0 = __fadd_rn(__fadd_rn(xv.x, p0), bb.x);
        const float y1 = __fadd_rn(__fadd_rn(xv.y, p1), bb.y);
        put_f(acc[4 * j + 2 * i], y0);
        put_f(acc[4 * j + 2 * i + 1], y1);
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
          const float yc = get_f(acc[4 * j + 2 * i + e]) - mu[i];
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
      const float2 g = ld2(gamma + col);
      const float2 be = ld2(beta + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (ln.row[i] >= M) continue;
        const float o0 = (get_f(acc[4 * j + 2 * i]) - sum[i]) * inv[i] * g.x + be.x;
        const float o1 = (get_f(acc[4 * j + 2 * i + 1]) - sum[i]) * inv[i] * g.y + be.y;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(ln.row[i]) * H + col) =
            __floats2bfloat162_rn(o0, o1);
      }
    }
  }
};

// ---------------------------------------------------------------------------- the bf16 tile, stored by TMA
// ---- bulk (TMA) stores from shared memory, counted in bulk groups by the issuing thread
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// the thread's stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
// the thread's stores are complete
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// out = bf16(act(product + b)): S8, the product (float(acc) * sx) * sw, each step rounded
// on its own (the int8 plain version's order; bias_dequant's arithmetic, here a column pair
// at a time so that no more than the accumulators stay live: no spills at 256 columns),
// the vectors float32; BF16, the float32 accumulator, the bias bf16. Each warpgroup writes
// its 64 rows of the tile into shared memory as the 128-byte-swizzled boxes of the
// output's tensor map (64 columns x 64 rows; a quad's 16 bytes of a row land in the chunk
// the row's swizzle names, so a warp's 8 rows fill 32 banks), and one thread stores them
// with TMA: the writes leave the SM while the next tile's products run, and rows past M
// are clipped by the map.
template <class Op, int ACT, int BN_>
struct TileEpi {
  using Vec = std::conditional_t<kIsS8<Op>, float, bf16>;
  static constexpr bool kCluster = false;
  static constexpr int BN = BN_;
  static constexpr int kStages = BN_ == 128 ? 2 : 3;  // a ring stage fewer: room for the tile
  static constexpr uint32_t kExtra = 1024 + wg::BM * BN_ * 2;  // the tile in bf16, 1024-aligned
  const float *sx, *sw;  // S8: A's row scales, W's channel scales
  const Vec* b;
  const CUtensorMap* tout;  // (M, N) bf16, box (64, 64), set by the kernel
  int M;
  float sa[2];
  uint32_t tile;  // shared-memory address of the staged tile
  __device__ void attach(unsigned char*, uint32_t extra_addr) { tile = (extra_addr + 1023) & ~1023u; }
  __device__ void init() {}
  __device__ void prefetch(const Tile& t, int tid) {
    if constexpr (kIsS8<Op>) load_rows(sa, sx, t, tid, M);
  }
  __device__ void operator()(typename Op::Acc (&acc)[BN / 2], const Tile& t, int cw, int t128) {
    const Lane ln(t, cw, t128);
    const uint32_t half = tile + cw * (64 * BN * 2);  // the warpgroup's rows: BN / 64 boxes of 8 KB
    if (t128 == 0) bulk_wait_read();                  // the last tile's stores have read it
    sm90::named_barrier_sync(1 + cw, 128);
    const int r = 16 * (t128 >> 5) + ((t128 & 31) >> 2);  // rows r, r + 8 of the warpgroup's 64
    const uint32_t row0 = half + r * 128 + 4 * ln.qd, x = (r & 7) << 4;  // row r + 8: 1024 bytes on, same swizzle
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = t.n0 + 8 * j + 2 * ln.qd;
      float2 w;
      if constexpr (kIsS8<Op>) w = ld2(sw + col);
      const float2 bb = ld2(b + col);
      const uint32_t a = row0 + (j / 8) * 8192 + (((j % 8) << 4) ^ x);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v0, v1;
        if constexpr (kIsS8<Op>) {
          v0 = __fadd_rn(dequant(acc[4 * j + 2 * i], sa[i], w.x), bb.x);
          v1 = __fadd_rn(dequant(acc[4 * j + 2 * i + 1], sa[i], w.y), bb.y);
        } else {
          v0 = activate<ACT>(__fadd_rn(acc[4 * j + 2 * i], bb.x));
          v1 = activate<ACT>(__fadd_rn(acc[4 * j + 2 * i + 1], bb.y));
        }
        st_shared(a + 1024 * i, sm90::pack_bf16(v0, v1));
      }
    }
    sm90::fence_proxy_async();  // the writes, visible to the bulk copy
    sm90::named_barrier_sync(1 + cw, 128);
    if (t128 == 0) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) tma_store_2d(tout, half + c * 8192, t.n0 + 64 * c, t.m0 + 64 * cw);
      bulk_commit();
    }
  }
};

// ---------------------------------------------------------------------------- host side
// 2-D map over an (M, N) bf16 output, box (64 columns, 64 rows), 128-byte swizzle: TileEpi's
inline cudaError_t tile_out_map(CUtensorMap* map, void* out, int M, int N) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The SMs of the current device.
inline cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  return err == cudaSuccess ? cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device) : err;
}

// Whether an unclustered int8 product over (M, N) takes 256-column tiles, one block an
// SM: where N allows and they fill the card. Their mainloop moves 48 KB of L2 traffic per
// 8.4 M operations rather than 32 KB per 4.2 M, which outweighs the epilogues' overlap
// that two blocks an SM give (PERF.md); at few rows the 128-column tiles' twice as
// many blocks win. (The bf16 products take their width from the wrapper's plan.)
inline cudaError_t wide_tiles(int M, int N, bool* wide) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  *wide = err == cudaSuccess && N % 256 == 0 && (M + wg::BM - 1) / wg::BM * (N / 256) >= sms;
  return err;
}

// The tile epilogue's product on ``kernel`` (a __global__ function of the including file
// that runs gemm_sm90<Op> with a TileEpi<Op, ACT, BN>, taking (ta, tw, tout, epi, N, K)):
// ``ta`` maps A (M, K), ``w`` is W (N, K), out (M, N) bf16; a persistent grid, Cfg's
// blocks an SM, at most one a tile.
template <class Op, class Epi, typename Kernel>
cudaError_t run_tile(Kernel kernel, const CUtensorMap& ta, const void* w, void* out, const Epi& epi, int N, int K,
                     cudaStream_t stream) {
  using C = wg::Cfg<Epi::BN, Epi::kStages>;
  constexpr uint32_t bytes = C::smem_bytes(Epi::kExtra);
  static_assert(bytes * C::BLOCKS_PER_SM + 1024 * C::BLOCKS_PER_SM <= 233472, "the tile kernel's shared memory");
  CUtensorMap tw, tout;
  cudaError_t err = wg::operand_map<Op>(&tw, w, N, K, Epi::BN);
  if (err == cudaSuccess) err = tile_out_map(&tout, out, epi.M, N);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes))) !=
      cudaSuccess)
    return err;
  const int tiles = (epi.M + wg::BM - 1) / wg::BM * (N / Epi::BN), slots = C::BLOCKS_PER_SM * sms;
  kernel<<<tiles < slots ? tiles : slots, wg::THREADS, bytes, stream>>>(ta, tw, tout, epi, N, K);
  return cudaGetLastError();
}

// The product + LayerNorm on ``kernel`` (a __global__ function of the including file that
// runs gemm_sm90<Op> with an LnEpi<Op>, taking (ta, tb, epi, K)): ``ta`` maps A (M, K),
// ``w`` is W (H, K). A cluster of H / 128 blocks on each row tile, as many clusters as
// are resident at once, at most one a row tile. Its tiles stay 128 wide, two blocks an
// SM: at 256 (one block an SM) the epilogue's exchange and LayerNorm no longer overlap
// a neighbour's products, and it was slower in the int8 FFN (PERF.md).
template <class Op, typename Kernel>
cudaError_t run_ln(Kernel kernel, const CUtensorMap& ta, const void* w, const LnEpi<Op>& epi, int K,
                   cudaStream_t stream) {
  using C = wg::Cfg<BN>;
  constexpr uint32_t bytes = C::smem_bytes(kLnExtra);
  static_assert(bytes <= kMaxSmemPerBlock, "the LayerNorm kernel exceeds shared memory");
  CUtensorMap tw;
  cudaError_t err = wg::operand_map<Op>(&tw, w, epi.H, K, BN);
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
  cfg.blockDim = dim3(wg::THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(cs);
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess) return err;
  if (clusters <= 0) return cudaErrorInvalidConfiguration;
  const int row_tiles = (epi.M + wg::BM - 1) / wg::BM;
  cfg.gridDim = dim3(cs * (row_tiles < clusters ? row_tiles : clusters));
  return cudaLaunchKernelEx(&cfg, kernel, ta, tw, epi, K);
}

}  // namespace
}  // namespace mdhs
