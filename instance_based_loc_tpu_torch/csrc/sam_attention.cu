// Attention with decomposed relative-position bias for the SAM image
// encoder's global blocks, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel instance_based_loc_tpu/ops/pallas/sam_attention.py:
// _sam_attn_kernel (called from sam_flash_attention). Same function:
//
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h, j] / sqrt(D)
//                            + bias_h[b, h, i, j / WK] + bias_w[b, h, i, j % WK])
//                  . v[b, h, j]
//
// over S = HK * WK keys. As on the TPU: q, k and v enter the products as
// bf16 with fp32 accumulation, the bias is added and the softmax taken in
// fp32, P is rounded to bf16 for P.V, and the output is written in the
// input type from the fp32 accumulators. (fp32 callers hand in q, k, v
// rounded to bf16, which is what the TPU kernel's DEFAULT-precision dots do
// with fp32 operands.)
//
// Bound at SAM-H's global blocks (B = 1, H = 16, S = 4096, D = 80, bf16) on
// an H100 SXM: the two products are 4 * B * H * S^2 * D = 85.9 GFLOP, 87 us
// at 989 TFLOP/s; reading q, k, v, bias_h, bias_w and writing out is 58.7 MB,
// 18 us at 3.35 TB/s. So the kernel is bound by operations, and the design
// feeds the tensor cores through wgmma, their only full-rate path, with
// operands straight from shared memory:
//
// * one block per (128 query rows, batch * head), one per SM: a producer
//   warpgroup, whose first warp issues every TMA load (the others retire at
//   once) and which gives its registers up with setmaxnreg, and two
//   consumer warpgroups of 64 query rows each, which take them (240 each);
// * Q is loaded once by TMA; K and V stream in 128-key tiles through a ring
//   of three stages, each with a "full" mbarrier (TMA bytes arrived) and an
//   "empty" one (every consumer warp done), so no __syncthreads runs in the
//   key loop. TMA zero-fills rows past S (a 3-D map: column, row, head);
// * Q.K^T is wgmma m64n128k16 with both operands in shared memory; the
//   scores stay in registers through an online softmax in fp32; P is
//   rounded to bf16 into wgmma's register A fragments; P.V is wgmma with V
//   read MN-major from shared memory. The loop is software-pipelined as in
//   FlashAttention-3: Q.K^T of tile ci and P.V of tile ci - 1 are issued
//   together, and the softmax of tile ci runs while P.V is on the tensor
//   cores; no register of an in-flight product is written meanwhile (O is
//   rescaled before P.V is issued, P converted after it is done), so the
//   compiler does not serialise the products;
// * head size 80 (SAM-H): a 160-byte row does not fit the 128-byte swizzle
//   that wgmma reads, so each operand row is split into a 64-column part
//   (128-byte swizzle) and a 16-column part (32-byte swizzle), two maps per
//   operand; Q.K^T adds a fifth k-step on the 16-column parts, and P.V is
//   m64n64k16 plus m64n16k16 into a separate 16-column accumulator;
// * the bias is never expanded in memory. Each warp copies its 16 rows of
//   bias_h into shared memory once, as fp32 scaled by log2(e). When a key
//   grid row is 64 keys (WK = 64, SAM's 1024 px and 768 x 1024 px
//   canvases), a tile is two grid rows: a thread's accumulator columns fall
//   on the same grid columns in every tile, so its 2 rows x 16 bias_w values
//   stay in registers for the whole loop, and bias_h, one value per row and
//   grid row, joins each score only in the row maximum and the exponent.
//   Other widths keep bias_w rows in shared memory too and look both terms
//   up per score (key j -> row j / WK, column j % WK, stepped
//   incrementally); keys past S are masked. The TPU kernel's 0/1 expansion
//   matmuls were a Mosaic workaround and have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_attention.cuh"

namespace {

constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kRows = kConsumers * 64;           // query rows per block
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kChunk = 128;                      // keys per K/V tile
constexpr int kGridRow = 64;   // key-grid width whose rows fill a tile
constexpr int kRowsPerTile = kChunk / kGridRow;
constexpr int kHalves = kChunk / 64;   // 64-row TMA boxes per K/V tile
// K/V ring depth: a tile is released one tile after its Q.K^T (once its
// P.V is done), so the third stage keeps one load in flight ahead
constexpr int kStages = 3;
constexpr int kProducerRegs = 24;
// what the producer warpgroup gives up, shared among the consumers
constexpr int kConsumerRegs =
    (65536 / kThreads + (65536 / kThreads - kProducerRegs) / kConsumers) / 8 * 8;
constexpr float kLog2e = 1.4426950408889634f;

// bytes of one 64-row tile of q, k or v: the 64-column part, plus the
// 16-column part at D = 80
__host__ __device__ constexpr int op_bytes(int d) {
  return hopper::kSw128TileBytes + (d == 80 ? hopper::kSw32TileBytes : 0);
}

// bytes of one kChunk-row tile of k or v: the 64-row boxes of the
// 64-column part, then those of the 16-column part
__host__ __device__ constexpr int kv_bytes(int d) {
  return (kChunk / 64) * op_bytes(d);
}

// fp32 words per shared bias row: a multiple of 32 plus 8, so the 8 rows one
// warp's lanes read start on different banks
__host__ __device__ constexpr int bias_stride(int n) {
  return (n + 31) / 32 * 32 + 8;
}

// Shared bias_w rows per block: none when a key-grid row is half a tile.
__host__ __device__ constexpr int bias_w_stride(int wk) {
  return wk == kGridRow ? 0 : bias_stride(wk);
}

size_t smem_bytes(int d, int hk, int wk) {
  return 1024 + (size_t)kConsumers * op_bytes(d) +
         (size_t)kStages * 2 * kv_bytes(d) +
         (size_t)kRows * (bias_stride(hk) + bias_w_stride(wk)) * sizeof(float) +
         (1 + 2 * kStages) * sizeof(uint64_t);
}

struct SamMaps {
  CUtensorMap q, k, v;                  // 64-column boxes, 128-byte swizzle
  CUtensorMap q_tail, k_tail, v_tail;   // D = 80: 16-column boxes, 32-byte
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(a, b);
}

// Loads `tiles` 64-row tiles of an operand from `row` on: their 64-column
// parts back to back, then their 16-column parts at D = 80.
template <int D>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const CUtensorMap* map,
                                          const CUtensorMap* tail_map,
                                          uint64_t* bar, int row, int head,
                                          int tiles) {
  using namespace hopper;
  for (int i = 0; i < tiles; ++i) {
    tma_load(dst + i * kSw128TileBytes, map, bar, 0, row + 64 * i, head);
    if (D == 80)
      tma_load(dst + tiles * kSw128TileBytes + i * kSw32TileBytes, tail_map,
               bar, 64, row + 64 * i, head);
  }
}

// Thread layout of a consumer warpgroup (hopper_attention.cuh): lane =
// 4 g + t holds rows g and g + 8 of its warp's 16, and columns 8 j + 2 t + e
// of every accumulator: sc[4 j + e] (row g), sc[4 j + 2 + e] (row g + 8).
// kRowTiles: WK == kGridRow, so key tile ci is key-grid rows kRowsPerTile ci
// on.
template <int D, typename T, bool kRowTiles>
__global__ void __launch_bounds__(kThreads, 1)
    sam_attention_wgmma(const __grid_constant__ SamMaps maps,
                        const T* __restrict__ bias_h,
                        const T* __restrict__ bias_w, T* __restrict__ out,
                        int s, int hk, int wk, float scale_log2) {
  using namespace hopper;
  constexpr int kOp = op_bytes(D);
  constexpr int kKv = kv_bytes(D);
  constexpr int kTailAt = kHalves * kSw128TileBytes;   // 16-column part
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* q_s = smem;                        // kConsumers tiles
  unsigned char* ring = q_s + kConsumers * kOp;     // stage: K tile, V tile
  const int hkp = bias_stride(hk);
  const int wkp = bias_w_stride(wk);
  float* bh_s = reinterpret_cast<float*>(ring + kStages * 2 * kKv);
  float* bw_s = bh_s + kRows * hkp;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(bw_s + kRows * wkp);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int head = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int n_chunks = (s + kChunk - 1) / kChunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kConsumers * 4);   // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full, kConsumers * kOp);
      for (int w = 0; w < kConsumers; ++w)
        load_rows<D>(q_s + w * kOp, &maps.q, &maps.q_tail, q_full,
                     row0 + 64 * w, head, 1);
      for (int ci = 0; ci < n_chunks; ++ci) {
        const int st = ci % kStages;
        mbar_wait(empty + st, ((ci / kStages) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * kKv);
        unsigned char* kt = ring + st * 2 * kKv;
        load_rows<D>(kt, &maps.k, &maps.k_tail, full + st, ci * kChunk, head,
                     kHalves);
        load_rows<D>(kt + kKv, &maps.v, &maps.v_tail, full + st, ci * kChunk,
                     head, kHalves);
      }
    }
    return;
  }

  // consumer warpgroup wg: block rows 64 wg ...; this warp's 16 from wr0
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4 - 1;
  const int wr0 = wg * 64 + (warp % 4) * 16;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rl_lo = wr0 + g;   // this lane's rows within the block
  const int rl_hi = rl_lo + 8;
  const int r_lo = row0 + rl_lo;
  const int r_hi = row0 + rl_hi;

  // this warp's bias rows, as fp32 in log2 units; rows past s are zero
  {
    const size_t bh_base = ((size_t)head * s + row0 + wr0) * hk;
    const int bh_end = (s - row0 - wr0) * hk;
    for (int i = lane; i < 16 * hk; i += 32) {
      const int r = i / hk;
      bh_s[(wr0 + r) * hkp + (i - r * hk)] =
          i < bh_end ? to_float(bias_h[bh_base + i]) * kLog2e : 0.f;
    }
    if (!kRowTiles) {
      const size_t bw_base = ((size_t)head * s + row0 + wr0) * wk;
      const int bw_end = (s - row0 - wr0) * wk;
      for (int i = lane; i < 16 * wk; i += 32) {
        const int r = i / wk;
        bw_s[(wr0 + r) * wkp + (i - r * wk)] =
            i < bw_end ? to_float(bias_w[bw_base + i]) * kLog2e : 0.f;
      }
    }
    __syncwarp();
  }
  const float* bh_lo = bh_s + rl_lo * hkp;
  const float* bh_hi = bh_s + rl_hi * hkp;
  const float* bw_lo = bw_s + rl_lo * wkp;
  const float* bw_hi = bw_s + rl_hi * wkp;
  // kRowTiles: this lane's bias_w columns 8 j + 2 t + e, in log2 units
  float bwr_lo[kGridRow / 8][2], bwr_hi[kGridRow / 8][2];
  if (kRowTiles) {
    const T* w_lo = bias_w + ((size_t)head * s + r_lo) * wk;
    const T* w_hi = bias_w + ((size_t)head * s + r_hi) * wk;
#pragma unroll
    for (int j = 0; j < kGridRow / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        bwr_lo[j][e] = r_lo < s ? to_float(w_lo[c]) * kLog2e : 0.f;
        bwr_hi[j][e] = r_hi < s ? to_float(w_hi[c]) * kLog2e : 0.f;
      }
    }
  }

  float o[32], ot[8];   // P.V accumulators: columns 0-63, and 64-79 at D = 80
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) ot[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;   // running max (log2 units)
  float l_lo = 0.f, l_hi = 0.f;               // this lane's share of the sum
  const uint32_t q_addr = smem_u32(q_s + wg * kOp);
  mbar_wait(q_full, 0);

  // S = Q.K^T of the tile in stage st (issued, not waited for)
  auto issue_qk = [&](float (&sc)[kChunk / 2], int st) {
    const uint32_t k_addr = smem_u32(ring + st * 2 * kKv);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<kChunk>(sc, desc_k_sw128(q_addr, ks), desc_k_sw128(k_addr, ks),
                       ks);
    if (D == 80)
      wgmma_ss<kChunk>(sc, desc_k_sw32(q_addr + kSw128TileBytes),
                       desc_k_sw32(k_addr + kTailAt), 1);
    wgmma_commit();
  };
  // O += P.V of the tile in stage st (issued, not waited for)
  auto issue_pv = [&](const uint32_t (&pa)[kChunk / 16][4], int st) {
    const uint32_t v_addr = smem_u32(ring + st * 2 * kKv) + kKv;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      wgmma_m64n64k16_rs(o, pa[kk], desc_mn_sw128(v_addr, kk));
      if (D == 80)
        wgmma_m64n16k16_rs(ot, pa[kk], desc_mn_sw32(v_addr + kTailAt, kk));
    }
    wgmma_commit();
  };
  // Scale, bias and mask the scores of tile ci, update the running max and
  // sum, and turn the scores into P (fp32, in place). Returns the factors by
  // which O must be rescaled.
  auto softmax = [&](float (&sc)[kChunk / 2], int ci, float& a_lo,
                     float& a_hi) {
    const int kc = ci * kChunk;
    float cm_lo = -INFINITY, cm_hi = -INFINITY;
    // per grid row of the tile, the bias_h term each score of that row
    // leaves out until its exponential (0 on the general path)
    float b_lo[kRowsPerTile], b_hi[kRowsPerTile];
    if (kRowTiles) {
      // grid rows kRowsPerTile ci on; with two per tile the second is past
      // the grid when HK is odd. sc keeps q.k scaled plus bias_w; the
      // row's maximum adds bias_h once
#pragma unroll
      for (int half = 0; half < kRowsPerTile; ++half) {
        const int row = kRowsPerTile * ci + half;
        b_lo[half] = b_hi[half] = 0.f;
        float hm_lo = -INFINITY, hm_hi = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < kGridRow / 8; ++jj) {
          const int j = half * (kGridRow / 8) + jj;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[4 * j + e] = fmaf(sc[4 * j + e], scale_log2, bwr_lo[jj][e]);
            sc[4 * j + 2 + e] =
                fmaf(sc[4 * j + 2 + e], scale_log2, bwr_hi[jj][e]);
            hm_lo = fmaxf(hm_lo, sc[4 * j + e]);
            hm_hi = fmaxf(hm_hi, sc[4 * j + 2 + e]);
          }
        }
        if (row < hk) {
          b_lo[half] = bh_lo[row];
          b_hi[half] = bh_hi[row];
          cm_lo = fmaxf(cm_lo, hm_lo + b_lo[half]);
          cm_hi = fmaxf(cm_hi, hm_hi + b_hi[half]);
        } else {
#pragma unroll
          for (int jj = 0; jj < kGridRow / 8; ++jj) {
            const int j = half * (kGridRow / 8) + jj;
            sc[4 * j] = sc[4 * j + 1] = sc[4 * j + 2] = sc[4 * j + 3] =
                -INFINITY;
          }
        }
      }
    } else {
#pragma unroll
      for (int half = 0; half < kRowsPerTile; ++half)
        b_lo[half] = b_hi[half] = 0.f;
      // key jk of this lane's first column: (ky, kx) with jk = ky * wk + kx,
      // stepped by 8 per column block
      int jk = kc + 2 * t;
      int ky = jk / wk;
      int kx = jk - ky * wk;
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        int y = ky, x = kx;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (jk + e < s) {
            sc[4 * j + e] = sc[4 * j + e] * scale_log2 + bh_lo[y] + bw_lo[x];
            sc[4 * j + 2 + e] =
                sc[4 * j + 2 + e] * scale_log2 + bh_hi[y] + bw_hi[x];
          } else {
            sc[4 * j + e] = -INFINITY;
            sc[4 * j + 2 + e] = -INFINITY;
          }
          cm_lo = fmaxf(cm_lo, sc[4 * j + e]);
          cm_hi = fmaxf(cm_hi, sc[4 * j + 2 + e]);
          if (++x == wk) {
            x = 0;
            ++y;
          }
        }
        jk += 8;
        kx += 8;
        while (kx >= wk) {
          kx -= wk;
          ++ky;
        }
      }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {      // the 4 lanes that share a row
      cm_lo = fmaxf(cm_lo, __shfl_xor_sync(0xffffffffu, cm_lo, x));
      cm_hi = fmaxf(cm_hi, __shfl_xor_sync(0xffffffffu, cm_hi, x));
    }
    // key 0 is valid, so after the first tile both maxima are finite
    const float mn_lo = fmaxf(m_lo, cm_lo);
    const float mn_hi = fmaxf(m_hi, cm_hi);
    a_lo = exp2_fast(m_lo - mn_lo);
    a_hi = exp2_fast(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      const int half = j / (kGridRow / 8);
      const float z_lo = m_lo - b_lo[half];
      const float z_hi = m_hi - b_hi[half];
      sc[4 * j] = exp2_fast(sc[4 * j] - z_lo);
      sc[4 * j + 1] = exp2_fast(sc[4 * j + 1] - z_lo);
      sc[4 * j + 2] = exp2_fast(sc[4 * j + 2] - z_hi);
      sc[4 * j + 3] = exp2_fast(sc[4 * j + 3] - z_hi);
      sum_lo += sc[4 * j] + sc[4 * j + 1];
      sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
  };
  // P rounded to bf16 as on the TPU, as the A fragments of k-step kk (keys
  // 16 kk ..)
  auto to_bf16 = [&](const float (&sc)[kChunk / 2],
                     uint32_t (&pa)[kChunk / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kk + h;
        pa[kk][2 * h] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pa[kk][2 * h + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    }
  };
  auto rescale = [&](float a_lo, float a_hi) {
    // once the maxima settle, most tiles leave them unchanged (a = 1)
    if (__all_sync(0xffffffffu, a_lo == 1.f && a_hi == 1.f)) return;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= a_lo;
      o[4 * j + 1] *= a_lo;
      o[4 * j + 2] *= a_hi;
      o[4 * j + 3] *= a_hi;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ot[4 * j] *= a_lo;
      ot[4 * j + 1] *= a_lo;
      ot[4 * j + 2] *= a_hi;
      ot[4 * j + 3] *= a_hi;
    }
  };

  // Software pipeline over tiles ci (stage ci % kStages): the softmax of
  // tile ci runs while the tensor cores compute P.V of tile ci - 1. No
  // register of an in-flight product is written meanwhile: O is rescaled
  // before P.V is issued, and P is converted once P.V is done.
  float sc[kChunk / 2];
  uint32_t pa[kChunk / 16][4];
  float a_lo, a_hi;
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) sc[i] = 0.f;
  mbar_wait(full, 0);
  wgmma_fence();
  issue_qk(sc, 0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(sc, 0, a_lo, a_hi);
  to_bf16(sc, pa);
  for (int ci = 1; ci < n_chunks; ++ci) {
    const int st = ci % kStages;
    mbar_wait(full + st, (ci / kStages) & 1);
    wgmma_fence();
    issue_qk(sc, st);
    rescale(a_lo, a_hi);
    wgmma_fence();
    issue_pv(pa, (ci - 1) % kStages);
    wgmma_wait<1>();                 // Q.K^T of tile ci is done
    fence_regs(sc);
    softmax(sc, ci, a_lo, a_hi);
    wgmma_wait<0>();                 // P.V of tile ci - 1 is done
    fence_regs(o);
    fence_regs(ot);
    if (lane == 0) mbar_arrive(empty + (ci - 1) % kStages);
    to_bf16(sc, pa);
  }
  rescale(a_lo, a_hi);
  wgmma_fence();
  issue_pv(pa, (n_chunks - 1) % kStages);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(ot);

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  T* out_lo = out + ((size_t)head * s + r_lo) * D + 2 * t;
  T* out_hi = out + ((size_t)head * s + r_hi) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (r_lo < s)
      store_pair(out_lo + 8 * j, o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    if (r_hi < s)
      store_pair(out_hi + 8 * j, o[4 * j + 2] * inv_hi,
                 o[4 * j + 3] * inv_hi);
  }
  if (D == 80) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (r_lo < s)
        store_pair(out_lo + 64 + 8 * j, ot[4 * j] * inv_lo,
                   ot[4 * j + 1] * inv_lo);
      if (r_hi < s)
        store_pair(out_hi + 64 + 8 * j, ot[4 * j + 2] * inv_hi,
                   ot[4 * j + 3] * inv_hi);
    }
  }
}

template <int D, typename T, bool kRowTiles>
cudaError_t launch_tiles(const void* q, const void* k, const void* v,
                         const void* bias_h, const void* bias_w, void* out,
                         int bh, int s, int hk, int wk, float scale,
                         size_t smem, cudaStream_t stream) {
  static size_t allowed = 0;
  SamMaps maps = {};
  bool ok = hopper::encode_bf16_map(&maps.q, q, bh, s, D, 64, 64) &&
            hopper::encode_bf16_map(&maps.k, k, bh, s, D, 64, 64) &&
            hopper::encode_bf16_map(&maps.v, v, bh, s, D, 64, 64);
  if (D == 80)
    ok = ok && hopper::encode_bf16_map(&maps.q_tail, q, bh, s, D, 64, 16) &&
         hopper::encode_bf16_map(&maps.k_tail, k, bh, s, D, 64, 16) &&
         hopper::encode_bf16_map(&maps.v_tail, v, bh, s, D, 64, 16);
  if (!ok) return cudaErrorNotSupported;
  const cudaError_t err = hopper::allow_smem(
      sam_attention_wgmma<D, T, kRowTiles>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kRows - 1) / kRows, bh);
  sam_attention_wgmma<D, T, kRowTiles><<<grid, kThreads, smem, stream>>>(
      maps, static_cast<const T*>(bias_h), static_cast<const T*>(bias_w),
      static_cast<T*>(out), s, hk, wk, scale * kLog2e);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias_h, const void* bias_w, void* out, int bh,
                   int s, int hk, int wk, float scale, size_t smem,
                   cudaStream_t stream) {
  return wk == kGridRow
             ? launch_tiles<D, T, true>(q, k, v, bias_h, bias_w, out, bh, s,
                                        hk, wk, scale, smem, stream)
             : launch_tiles<D, T, false>(q, k, v, bias_h, bias_w, out, bh, s,
                                         hk, wk, scale, smem, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the wrapper checks it
// against the card's limit before launching.
size_t sam_attention_smem_bytes(int d, int hk, int wk) {
  return smem_bytes(d, hk, wk);
}

// q, k, v: contiguous (bh, s, d) bf16, 16-byte aligned (TMA); bias_h
// (bh, s, hk), bias_w (bh, s, wk) and out (bh, s, d): contiguous, bf16
// (is_fp32 = 0) or fp32 (is_fp32 = 1); s = hk * wk, d in {64, 80}. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int sam_attention_launch(const void* q, const void* k, const void* v,
                         const void* bias_h, const void* bias_w, void* out,
                         int bh, int s, int d, int hk, int wk, float scale,
                         int is_fp32, void* stream) {
  if (hk * wk != s || (d != 64 && d != 80))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, hk, wk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64)
    err = is_fp32 ? launch<64, float>(q, k, v, bias_h, bias_w, out, bh, s, hk,
                                      wk, scale, smem, st)
                  : launch<64, __nv_bfloat16>(q, k, v, bias_h, bias_w, out,
                                              bh, s, hk, wk, scale, smem, st);
  else
    err = is_fp32 ? launch<80, float>(q, k, v, bias_h, bias_w, out, bh, s, hk,
                                      wk, scale, smem, st)
                  : launch<80, __nv_bfloat16>(q, k, v, bias_h, bias_w, out,
                                              bh, s, hk, wk, scale, smem, st);
  return (int)err;
}

}  // extern "C"
