// Whole-row multi-head attention for the ViT embedders, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel instance_based_loc_tpu/ops/pallas/attention.py:
// _attn_kernel (called from fused_attention). Same function:
//
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h, j] / sqrt(D), j < valid_len)
//                  . v[b, h, j]
//
// with fp32 scores, max, exponent, sum and accumulation, and the output in
// the input type (bf16 or fp32). Query rows at or past valid_len are computed
// like any other row; the caller discards them (the TPU kernel's contract).
//
// Bound at the main path's shape (DINOv2-base embedder: B = 16 crops, H = 12,
// S = 257, D = 64, bf16) on an H100 SXM: reading q, k, v and writing out is
// 4 * 16 * 12 * 257 * 64 * 2 B = 25.3 MB, 7.5 us at 3.35 TB/s; the two
// products are 4 * B * H * S^2 * D = 3.2 GFLOP, 3.3 us at 989 TFLOP/s bf16.
// So the kernel is bound by bytes. The design reads each head's K and V from
// device memory once and keeps every score on chip.
//
// * vit_attention_wgmma (bf16, D = 64): one block per (batch, head) and two
//   blocks per SM: two consumer warpgroups and one producer warp. The
//   producer warp issues TMA loads of the head's whole K and V in 64-key
//   chunks, each completing on its own mbarrier (a head fits in shared
//   memory, so no chunk is reused and the ring never wraps). Each consumer
//   warpgroup takes every other 64-row query tile, loads it by TMA (the next
//   tile's load starts as soon as the last Q.K^T of the current one is
//   done), and per chunk runs Q.K^T as wgmma m64n64k16 from shared memory,
//   an online softmax in fp32 registers, and P.V as wgmma with V read
//   MN-major from shared memory. P goes from the fp32 accumulator into
//   wgmma's register A fragments as a bf16 high part (its top 16 bits) and
//   the bf16-rounded remainder, two products of P.V, so P keeps ~16 bits as
//   the fp32 reference does. A last chunk of at most 16 keys (S = 257: one)
//   takes an m64n16k16 step; a remainder of at most 8 query rows (S = 257:
//   one) goes to the producer warp, in fp32 on the CUDA cores, instead of a
//   64-row tile of its own, which evens the two warpgroups' work. Operand
//   rows are 128 B under the 128-byte swizzle, which TMA writes and wgmma
//   reads without bank conflicts; TMA zero-fills rows past S (a 3-D map per
//   operand: column, row, head); keys at or past valid_len are masked to
//   -inf. The output is written in bf16 from registers.
//   On the card the kernel runs at about SDPA's speed, ~3.5x its bound:
//   192 heads on 132 SMs leave 60 SMs with two, where each tile's steps
//   run one after another, and no one resource is saturated: the tensor
//   cores (the P split's second product costs ~12 %), the softmax's
//   instructions and the bytes each take about a third of the time
//   (PERF.md, Findings).
// * vit_attention_simt (fp32, any even D): each warp takes every
//   fourth row; lanes split the keys for the scores (kept in shared memory)
//   and the columns for P.V, on the CUDA cores. K and V rows carry one word
//   of padding, so 32 lanes reading 32 key rows at one column hit 32 banks.
//   It serves fp32 callers and is not on the main path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_attention.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerBlock = 64;

// CUDA-core kernel (fp32). Shared memory: K and V (valid_len rows each, one
// word of padding per row), then one query row and one score row per warp.
__global__ void __launch_bounds__(kWarps * 32)
    vit_attention_simt(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int s, int d, int valid_len, float scale) {
  using hopper::warp_max;
  using hopper::warp_sum;
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = d + 1;
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + (size_t)valid_len * stride;
  float* q_rows = v_s + (size_t)valid_len * stride;
  float* p_rows = q_rows + kWarps * d;

  const size_t base = (size_t)blockIdx.y * s * d;
  for (int i = threadIdx.x; i < valid_len * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    k_s[r * stride + c] = k[base + i];
    v_s[r * stride + c] = v[base + i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q_w = q_rows + warp * d;
  float* p_w = p_rows + warp * valid_len;
  const int row_end = min(s, (int)(blockIdx.x + 1) * kRowsPerBlock);

  for (int row = blockIdx.x * kRowsPerBlock + warp; row < row_end;
       row += kWarps) {
    const float* q_g = q + base + (size_t)row * d;
    for (int c = lane; c < d; c += 32) q_w[c] = q_g[c] * scale;
    __syncwarp();

    // scores: lane l takes keys l, l + 32, ...
    float m = -INFINITY;
    for (int j = lane; j < valid_len; j += 32) {
      const float* k_row = k_s + (size_t)j * stride;
      float acc = 0.f;
      for (int c = 0; c < d; ++c) acc = fmaf(q_w[c], k_row[c], acc);
      p_w[j] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < valid_len; j += 32) {
      const float p = expf(p_w[j] - m);
      p_w[j] = p;
      l += p;
    }
    l = warp_sum(l);
    __syncwarp();

    // P.V: lane l takes output columns l, l + 32, ...
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* o_g = out + base + (size_t)row * d;
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < valid_len; ++j)
        acc = fmaf(p_w[j], v_s[(size_t)j * stride + c], acc);
      o_g[c] = acc * inv;
    }
    __syncwarp();
  }
}

constexpr int kD = 64;          // head size of the tensor-core kernel
constexpr int kTile = 64;       // query rows per tile, keys per TMA chunk
constexpr int kWarpRows = 8;    // a remainder of <= 8 rows: producer warp
constexpr int kShortChunk = 16; // a last chunk of <= 16 keys: an n16 step
constexpr int kConsumers = 2;   // consumer warpgroups per block
constexpr int kTcThreads = kConsumers * 128 + 32;   // + the producer warp
constexpr int kTileBytes = hopper::kSw128TileBytes;

struct VitMaps {
  CUtensorMap q, k, v;
};

size_t tc_smem_bytes(int valid_len) {
  const size_t chunks = (valid_len + kTile - 1) / kTile;
  return 1024 + (2 * chunks + kConsumers) * kTileBytes +
         (chunks + kConsumers) * sizeof(uint64_t) +
         (kD + chunks * kTile) * sizeof(float);
}

// One step of one query tile over keys key0 .. key0 + N - 1 (N = 64, or 16
// for a last chunk of at most 16 keys): S = Q.K^T, the online softmax
// update (keys at or past valid_len masked), and O += P.V with P as a bf16
// high part (its top 16 bits) and a bf16 remainder. after_qk() runs once S
// has arrived.
template <int N, typename AfterQk>
__device__ __forceinline__ void vit_step(float (&o)[32], float& m_lo,
                                         float& m_hi, float& l_lo,
                                         float& l_hi, uint32_t q_addr,
                                         uint32_t k_addr, uint32_t v_addr,
                                         int key0, int valid_len,
                                         float scale_log2, int t,
                                         AfterQk after_qk) {
  using namespace hopper;
  float sc[N / 2];   // written whole by the first k-step (scale_d = 0)
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)
    wgmma_ss<N>(sc, desc_k_sw128(q_addr, ks), desc_k_sw128(k_addr, ks), ks);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  after_qk();

  if (key0 + N > valid_len) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (key0 + 8 * j + 2 * t + e >= valid_len) {
          sc[4 * j + e] = -INFINITY;
          sc[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
  }
  float cm_lo = -INFINITY, cm_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    cm_lo = fmaxf(cm_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
    cm_hi = fmaxf(cm_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {     // the 4 lanes that share a row
    cm_lo = fmaxf(cm_lo, __shfl_xor_sync(0xffffffffu, cm_lo, x));
    cm_hi = fmaxf(cm_hi, __shfl_xor_sync(0xffffffffu, cm_hi, x));
  }
  // key 0 is valid, so after the first chunk both maxima are finite
  const float mn_lo = fmaxf(m_lo, cm_lo * scale_log2);   // log2 units
  const float mn_hi = fmaxf(m_hi, cm_hi * scale_log2);
  const float a_lo = exp2_fast(m_lo - mn_lo);
  const float a_hi = exp2_fast(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  l_lo *= a_lo;
  l_hi *= a_hi;
  // once the maxima settle, most chunks leave them unchanged (a = 1)
  if (!__all_sync(0xffffffffu, a_lo == 1.f && a_hi == 1.f)) {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j] *= a_lo;
      o[4 * j + 1] *= a_lo;
      o[4 * j + 2] *= a_hi;
      o[4 * j + 3] *= a_hi;
    }
  }

  // P as A fragments of k-step kk (keys 16 kk ..): the high part is the top
  // 16 bits of the fp32 value, the remainder (exact in fp32) rounded to bf16
  uint32_t pa[N / 16][4], pr[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kk + h;
      float p[4];
      p[0] = exp2_fast(fmaf(sc[4 * j], scale_log2, -m_lo));
      p[1] = exp2_fast(fmaf(sc[4 * j + 1], scale_log2, -m_lo));
      p[2] = exp2_fast(fmaf(sc[4 * j + 2], scale_log2, -m_hi));
      p[3] = exp2_fast(fmaf(sc[4 * j + 3], scale_log2, -m_hi));
      l_lo += p[0] + p[1];
      l_hi += p[2] + p[3];
      split_bf16(p[0], p[1], pa[kk][2 * h], pr[kk][2 * h]);
      split_bf16(p[2], p[3], pa[kk][2 * h + 1], pr[kk][2 * h + 1]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    wgmma_m64n64k16_rs(o, pa[kk], desc_mn_sw128(v_addr, kk));
    wgmma_m64n64k16_rs(o, pr[kk], desc_mn_sw128(v_addr, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// The producer warp, once its loads are issued: the last `rows` query rows
// (a remainder too short for a 64-row tile) in fp32 on the CUDA cores, from
// the K and V tiles in shared memory. Lanes split the keys for the scores
// and the columns for P.V.
__device__ __forceinline__ void vit_rows_simt(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const unsigned char* k_s, const unsigned char* v_s, uint64_t* kv_full,
    float* q_row, float* p_row, int s, int rows, int valid_len,
    float scale_log2, int lane) {
  using namespace hopper;
  const int n_chunks = (valid_len + kTile - 1) / kTile;
  for (int c = 0; c < n_chunks; ++c) mbar_wait(kv_full + c, 0);
  for (int r = s - rows; r < s; ++r) {
    for (int c = lane; c < kD; c += 32)
      q_row[c] = __bfloat162float(q[(size_t)r * kD + c]);
    __syncwarp();
    float m = -INFINITY;
    for (int j = lane; j < valid_len; j += 32) {
      const unsigned char* kt = k_s + (j / kTile) * kTileBytes;
      const int jr = j % kTile;
      float acc = 0.f;
#pragma unroll
      for (int cg = 0; cg < kD / 8; ++cg) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(sw128_at(kt, jr, cg * 8));
        const __nv_bfloat16* kv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(q_row[cg * 8 + e], __bfloat162float(kv[e]), acc);
      }
      acc *= scale_log2;
      p_row[j] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < valid_len; j += 32) {
      const float p = exp2f(p_row[j] - m);
      p_row[j] = p;
      l += p;
    }
    l = warp_sum(l);
    __syncwarp();
    const int col = 2 * lane;
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < valid_len; ++j) {
      const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(
          sw128_at(v_s + (j / kTile) * kTileBytes, j % kTile, col));
      a0 = fmaf(p_row[j], __low2float(v2), a0);
      a1 = fmaf(p_row[j], __high2float(v2), a1);
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    *reinterpret_cast<uint32_t*>(out + (size_t)r * kD + col) =
        pack_bf16(a0 * inv, a1 * inv);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kTcThreads, 2)
    vit_attention_wgmma(const __grid_constant__ VitMaps maps,
                        const __nv_bfloat16* __restrict__ q,
                        __nv_bfloat16* __restrict__ out, int s,
                        int valid_len, float scale_log2) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int n_chunks = (valid_len + kTile - 1) / kTile;
  // the rows past the last full tile go to the producer warp if they are
  // few, to a tile of their own otherwise
  const int rem = s % kTile;
  const int warp_rows = rem <= kWarpRows ? rem : 0;
  const int n_tiles = (s - warp_rows + kTile - 1) / kTile;
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + n_chunks * kTileBytes;
  unsigned char* q_s = v_s + n_chunks * kTileBytes;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(q_s + kConsumers * kTileBytes);
  uint64_t* q_full = kv_full + n_chunks;
  float* q_row = reinterpret_cast<float*>(q_full + kConsumers);
  float* p_row = q_row + kD;
  const int head = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t head_base = (size_t)head * s * kD;

  if (threadIdx.x == 0) {
    for (int c = 0; c < n_chunks; ++c) mbar_init(kv_full + c, 1);
    for (int w = 0; w < kConsumers; ++w) mbar_init(q_full + w, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // producer warp: the head's K and V, chunk by chunk in key order
    if (lane == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        mbar_expect_tx(kv_full + c, 2 * kTileBytes);
        tma_load(k_s + c * kTileBytes, &maps.k, kv_full + c, 0, c * kTile,
                 head);
        tma_load(v_s + c * kTileBytes, &maps.v, kv_full + c, 0, c * kTile,
                 head);
      }
    }
    if (warp_rows > 0)
      vit_rows_simt(q + head_base, out + head_base, k_s, v_s, kv_full, q_row,
                    p_row, s, warp_rows, valid_len, scale_log2, lane);
    return;
  }

  // consumer warpgroup wg: query tiles wg, wg + 2, ...
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int g = lane / 4;
  const int t = lane % 4;
  unsigned char* q_tile = q_s + wg * kTileBytes;
  const uint32_t q_addr = smem_u32(q_tile);
  __nv_bfloat16* out_h = out + head_base;
  auto load_q = [&](int tile) {
    mbar_expect_tx(q_full + wg, kTileBytes);
    tma_load(q_tile, &maps.q, q_full + wg, 0, tile * kTile, head);
  };
  if (tid == 0 && wg < n_tiles) load_q(wg);
  uint32_t q_phase = 0;
  for (int tile = wg; tile < n_tiles; tile += kConsumers) {
    mbar_wait(q_full + wg, q_phase);
    q_phase ^= 1;

    // Key chunks c in order: S = Q.K^T, the online softmax, O += P.V. The
    // other warpgroup, and the other block on the SM, overlap this one.
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;   // running max (log2 units)
    float l_lo = 0.f, l_hi = 0.f;               // this lane's share of the sum
    for (int c = 0; c * kTile < valid_len; ++c) {
      const int left = valid_len - c * kTile;
      mbar_wait(kv_full + c, 0);
      const uint32_t k_addr = smem_u32(k_s + c * kTileBytes);
      const uint32_t v_addr = smem_u32(v_s + c * kTileBytes);
      // after the last chunk's Q.K^T the warpgroup is done with q_tile:
      // start loading its next tile
      auto next_q = [&] {
        if (left > kTile) return;
        named_sync(1 + wg, 128);
        if (tid == 0 && tile + kConsumers < n_tiles) load_q(tile + kConsumers);
      };
      if (left <= kShortChunk)
        vit_step<kShortChunk>(o, m_lo, m_hi, l_lo, l_hi, q_addr, k_addr,
                              v_addr, c * kTile, valid_len, scale_log2, t,
                              next_q);
      else
        vit_step<kTile>(o, m_lo, m_hi, l_lo, l_hi, q_addr, k_addr, v_addr,
                        c * kTile, valid_len, scale_log2, t, next_q);
    }

#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
    }
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
    const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    const int r_lo = tile * kTile + (tid / 32) * 16 + g;
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r_lo < s)
        *reinterpret_cast<uint32_t*>(out_h + (size_t)r_lo * kD + col) =
            pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
      if (r_hi < s)
        *reinterpret_cast<uint32_t*>(out_h + (size_t)r_hi * kD + col) =
            pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
    }
  }
}

cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out,
                        int bh, int s, int d, int valid_len, float scale,
                        size_t smem_bytes, cudaStream_t stream) {
  static size_t allowed = 0;
  const cudaError_t err =
      hopper::allow_smem(vit_attention_simt, smem_bytes, &allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  vit_attention_simt<<<grid, kWarps * 32, smem_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, d, valid_len,
      scale);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int bh, int s, int valid_len, float scale,
                         size_t smem_bytes, cudaStream_t stream) {
  static size_t allowed = 0;
  VitMaps maps;
  if (!hopper::encode_bf16_map(&maps.q, q, bh, s, kD, kTile, 64) ||
      !hopper::encode_bf16_map(&maps.k, k, bh, s, kD, kTile, 64) ||
      !hopper::encode_bf16_map(&maps.v, v, bh, s, kD, kTile, 64))
    return cudaErrorNotSupported;
  const cudaError_t err =
      hopper::allow_smem(vit_attention_wgmma, smem_bytes, &allowed);
  if (err != cudaSuccess) return err;
  vit_attention_wgmma<<<bh, kTcThreads, smem_bytes, stream>>>(
      maps, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), s, valid_len,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

bool use_tensor_cores(int d, int elem_bytes) {
  return elem_bytes == 2 && d == kD;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the wrapper checks it
// against the card's limit before launching.
size_t vit_attention_smem_bytes(int d, int valid_len, int elem_bytes) {
  if (use_tensor_cores(d, elem_bytes)) return tc_smem_bytes(valid_len);
  return (2 * (size_t)valid_len * (d + 1) + (size_t)kWarps * (d + valid_len)) *
         sizeof(float);
}

// q, k, v, out: contiguous (bh, s, d) arrays of one type on the current
// device; is_bf16 selects bf16 (1) or fp32 (0). bf16 runs on the tensor
// cores and takes only d = 64; fp32 runs on the CUDA cores. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int vit_attention_launch(const void* q, const void* k, const void* v,
                         void* out, int bh, int s, int d, int valid_len,
                         float scale, int is_bf16, void* stream) {
  const int elem_bytes = is_bf16 ? 2 : 4;
  const size_t smem = vit_attention_smem_bytes(d, valid_len, elem_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_tensor_cores(d, elem_bytes))
    err = launch_wgmma(q, k, v, out, bh, s, valid_len, scale, smem, st);
  else if (is_bf16)
    err = cudaErrorInvalidValue;   // bf16 runs only with d = 64
  else
    err = launch_simt(q, k, v, out, bh, s, d, valid_len, scale, smem, st);
  return (int)err;
}

}  // extern "C"
