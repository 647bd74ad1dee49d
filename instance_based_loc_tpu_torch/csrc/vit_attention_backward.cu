// Gradient of the ViT multi-head attention, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's DATOR towers compute attention
// as bf16 einsums and XLA differentiates them
// (instance_based_loc_tpu/models/dator/transreid_vit.py:79-82); the port
// routes the towers through its ViT kernel (vit_attention.cu), and this is
// the backward of that function, ops/attention.py:VitAttentionFunction.
// It computes what ops/attention.py:vit_attention_backward computes, with
// scale = 1 / sqrt(D) and keys at or past valid_len masked:
//
//   P   = softmax(q k^T scale, keys < valid_len)     dP = g v^T
//   D_i = rowsum(P o dP)                              dS = P o (dP - D_i)
//   dq  = dS k scale       dk = dS^T q scale          dv = P^T g
//
// Keys at or past valid_len get dk = dv = 0 exactly; query rows at or past
// valid_len are ordinary rows. Each gradient comes back in the input type.
//
// Bound at the training shape (B*H = 128 * 12 heads, S = 129, D = 64, bf16)
// on an H100 SXM: reading q, k, v, g and writing dq, dk, dv is 7 * 25.36 MB
// = 177.5 MB, 53.0 us at 3.35 TB/s; the five products are 5 * 2 S^2 D B H =
// 16.4 GFLOP, 16.5 us at 989 TFLOP/s bf16. So it is bound by bytes. No
// design here uses atomics: every gradient is deterministic.
//
// * bf16, D = 64, S <= S_max = 144 (the towers' 129, CLIP-B/32's 50):
//   vit_attention_bwd_fused_wgmma, one pass over each head in a persistent
//   kernel (ops/attention.py:backward_kernel picks it). One block per SM
//   walks the heads; one thread issues TMA loads of a head's g, K, q and V
//   (one box each, padded to kPad = 16, 64, 80, 128 or 144 rows and keys,
//   zero past S) into a ring of 7 slots, so the next head's four operands
//   are in flight while this head computes; each operand is read from
//   device memory once, and no scratch goes to device memory. Three
//   warpgroups (no producer warpgroup: at S = 129 the 129th row needs a
//   third 64-row tile, and at 384 threads the 168-register cap leaves none
//   to give away) each take a 64-row tile of the head (the third, at S =
//   129, for one real row) and one key job (a 64-key tile of dk and dv, or
//   the 16 tail keys). Per head (shared-memory map and barriers at the
//   kernel):
//   - S = q K^T for the tile's rows over all kPad keys as one wgmma chain
//     (64 x 144 fp32 in registers), the softmax exact and whole (no online
//     rescaling, no log-sum-exp), P staged to shared memory as a bf16 high
//     part and the bf16-rounded remainder (~16 bits, which the 2e-3 +
//     2^-7 |ref| tolerance needs, below), D = rowsum(P dP) with dP = g V^T
//     one 64-key chunk at a time;
//   - dv = P^T g per key job, P^T read MN-major from the staging (the 16
//     tail keys as dv^T = g^T P, m64n16, the staged tail under the 32-byte
//     swizzle);
//   - each row tile recomputes dP chunk by chunk and overwrites its staged
//     P with dS (hi + lo), then dq = dS K and dk = dS^T q both read dS from
//     shared memory.
//   S and dP never sit in registers together (144 fp32), no dS waits in
//   registers between products and no product takes its A operand from
//   registers: with any of these ptxas ran out of registers for the wgmma
//   pipeline and serialised every wgmma of the kernel (PERF.md).
//   The cost is dP computed twice. On the card it takes 0.147 ms at the
//   training shape (PERF.md): ~21K cycles a head, most of it latency of the
//   phases each head runs one after another.
// * bf16, D = 64, longer heads (DINOv2's 257): two kernels in the
//   FlashAttention-2 order, each one block per (batch, head) with two
//   consumer warpgroups and a producer warpgroup, in the manner of the
//   forward (vit_attention.cu):
//   (a) vit_attention_bwd_dq_wgmma, split by 64-row query tile. The
//       producer loads the head's K and V by TMA, each 64-key chunk on
//       its own mbarrier; each consumer warpgroup loads its Q and g tiles.
//       Over the key chunks it runs S = Q.K^T and dP = g.V^T as wgmma from
//       shared memory and keeps the row's running max, sum and
//       sum(exp . dP) (an online D, rescaled with the max like the sum);
//       then, over the chunks again, it recomputes S and dP, forms the exact
//       P = exp(S scale - lse) and dS = P (dP - D), and accumulates
//       dq += dS.K with dS from registers (bf16 A fragments) and K read
//       MN-major. It writes each row's log-sum-exp and D to an fp32 scratch
//       of B*H*S floats each.
//   (b) vit_attention_bwd_dkdv_wgmma, split by 64-key tile. The producer
//       loads the head's Q and g by TMA, each 64-row chunk on its own
//       mbarrier; each consumer warpgroup loads its K and V tiles and, per
//       query chunk, runs S^T = K.Q^T and dP^T = V.g^T (keys are the rows
//       of the product, so P^T and dS^T land in registers as the A operand
//       the next products need), recomputes P^T from the log-sum-exp and
//       dS^T from D, and accumulates dv += P^T.g and dk += dS^T.Q in fp32
//       registers, written once.
//   P and dS enter their products from registers as a bf16 high part (the
//   top 16 bits) and the bf16-rounded remainder, two products each, so
//   they keep ~16 bits (one bf16 rounding, 2^-9 of a term, missed the
//   2e-3 + 2^-7 |ref| tolerance in about one element per million at the
//   training shape); every product accumulates in fp32. A last chunk of
//   at most 16 keys (pass a) or queries (pass b) takes an m64n16k16 step. A
//   remainder of one query row (pass a) or key (pass b), as at S = 129 and
//   257, goes to the producer warpgroup, in fp32 on the CUDA cores, instead
//   of a 64-row tile of its own: four warps, one per scheduler (a single
//   producer warp, sharing its scheduler with two consumer warps, made this
//   row the block's critical path).
//   Operand rows are 128 B under the 128-byte swizzle; TMA zero-fills rows
//   past S. Reading q, k, v and g twice, the design's floor is ~83 us at
//   the training shape; it took 0.2297-0.2315 ms there (PERF.md).
// * fp32, any D, CUDA cores: the same two passes as simple kernels, one
//   block per 64 rows (a) or keys (b) of a head, each warp one row or key
//   at a time, lanes split the keys (a) or queries (b) for the scores and
//   the columns for the products. Rows carry one word of padding in shared
//   memory. It serves fp32 callers and is not on the main path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_attention.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------ fp32, CUDA cores

constexpr int kWarps = 4;
constexpr int kRowsPerBlock = 64;

// (a) dq, the log-sum-exp and D of rows blockIdx.x * 64 ... of head
// blockIdx.y. Shared memory: K and V (valid_len rows, padded), then per
// warp a q row, a g row, and the row's scores and dP.
__global__ void __launch_bounds__(kWarps * 32)
    vit_attention_bwd_dq_simt(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ g,
                              float* __restrict__ dq, float* __restrict__ lse,
                              float* __restrict__ delta, int s, int d,
                              int valid_len, float scale) {
  using hopper::warp_max;
  using hopper::warp_sum;
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = d + 1;
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + (size_t)valid_len * stride;
  float* rows = v_s + (size_t)valid_len * stride;
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
  float* q_w = rows + (size_t)warp * (2 * d + 2 * valid_len);
  float* g_w = q_w + d;
  float* p_w = g_w + d;
  float* dp_w = p_w + valid_len;
  const int row_end = min(s, (int)(blockIdx.x + 1) * kRowsPerBlock);
  for (int row = blockIdx.x * kRowsPerBlock + warp; row < row_end;
       row += kWarps) {
    const size_t at = base + (size_t)row * d;
    for (int c = lane; c < d; c += 32) {
      q_w[c] = q[at + c] * scale;
      g_w[c] = g[at + c];
    }
    __syncwarp();
    float m = -INFINITY;
    for (int j = lane; j < valid_len; j += 32) {
      const float* k_row = k_s + (size_t)j * stride;
      const float* v_row = v_s + (size_t)j * stride;
      float sc = 0.f, dp = 0.f;
      for (int c = 0; c < d; ++c) {
        sc = fmaf(q_w[c], k_row[c], sc);
        dp = fmaf(g_w[c], v_row[c], dp);
      }
      p_w[j] = sc;
      dp_w[j] = dp;
      m = fmaxf(m, sc);
    }
    m = warp_max(m);
    float l = 0.f, dn = 0.f;
    for (int j = lane; j < valid_len; j += 32) {
      const float p = expf(p_w[j] - m);
      p_w[j] = p;
      l += p;
      dn += p * dp_w[j];
    }
    l = warp_sum(l);
    const float dl = warp_sum(dn) / l;
    const float inv = 1.f / l;
    for (int j = lane; j < valid_len; j += 32)
      p_w[j] = p_w[j] * inv * (dp_w[j] - dl);          // dS
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < valid_len; ++j)
        acc = fmaf(p_w[j], k_s[(size_t)j * stride + c], acc);
      dq[at + c] = acc * scale;
    }
    if (lane == 0) {
      lse[(size_t)blockIdx.y * s + row] = m + logf(l);
      delta[(size_t)blockIdx.y * s + row] = dl;
    }
    __syncwarp();
  }
}

// (b) dk and dv of keys blockIdx.x * 64 ... of head blockIdx.y. Shared
// memory: Q and g (s rows, padded), the head's log-sum-exp and D, then per
// warp a k row, a v row, and the key's P and dS over the queries.
__global__ void __launch_bounds__(kWarps * 32)
    vit_attention_bwd_dkdv_simt(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ g,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv,
                                int s, int d, int valid_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)blockIdx.y * s * d;
  const int key_begin = blockIdx.x * kRowsPerBlock;
  const int key_end = min(s, key_begin + kRowsPerBlock);
  if (key_begin >= valid_len) {     // masked keys: no gradient
    for (int i = threadIdx.x; i < (key_end - key_begin) * d; i += blockDim.x) {
      dk[base + (size_t)key_begin * d + i] = 0.f;
      dv[base + (size_t)key_begin * d + i] = 0.f;
    }
    return;
  }
  const int stride = d + 1;
  float* q_s = reinterpret_cast<float*>(smem);
  float* g_s = q_s + (size_t)s * stride;
  float* lse_s = g_s + (size_t)s * stride;
  float* d_s = lse_s + s;
  float* rows = d_s + s;
  for (int i = threadIdx.x; i < s * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    q_s[r * stride + c] = q[base + i];
    g_s[r * stride + c] = g[base + i];
  }
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    lse_s[i] = lse[(size_t)blockIdx.y * s + i];
    d_s[i] = delta[(size_t)blockIdx.y * s + i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* k_w = rows + (size_t)warp * (2 * d + 2 * s);
  float* v_w = k_w + d;
  float* p_w = v_w + d;
  float* ds_w = p_w + s;
  for (int key = key_begin + warp; key < key_end; key += kWarps) {
    const size_t at = base + (size_t)key * d;
    if (key >= valid_len) {
      for (int c = lane; c < d; c += 32) {
        dk[at + c] = 0.f;
        dv[at + c] = 0.f;
      }
      continue;
    }
    for (int c = lane; c < d; c += 32) {
      k_w[c] = k[at + c] * scale;
      v_w[c] = v[at + c];
    }
    __syncwarp();
    for (int i = lane; i < s; i += 32) {
      const float* q_row = q_s + (size_t)i * stride;
      const float* g_row = g_s + (size_t)i * stride;
      float sc = 0.f, dp = 0.f;
      for (int c = 0; c < d; ++c) {
        sc = fmaf(q_row[c], k_w[c], sc);
        dp = fmaf(g_row[c], v_w[c], dp);
      }
      const float p = expf(sc - lse_s[i]);
      p_w[i] = p;
      ds_w[i] = p * (dp - d_s[i]);
    }
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float a_k = 0.f, a_v = 0.f;
      for (int i = 0; i < s; ++i) {
        a_k = fmaf(ds_w[i], q_s[(size_t)i * stride + c], a_k);
        a_v = fmaf(p_w[i], g_s[(size_t)i * stride + c], a_v);
      }
      dk[at + c] = a_k * scale;
      dv[at + c] = a_v;
    }
    __syncwarp();
  }
}

size_t simt_dq_smem_bytes(int d, int valid_len) {
  return (2 * (size_t)valid_len * (d + 1) +
          (size_t)kWarps * (2 * d + 2 * valid_len)) * sizeof(float);
}

size_t simt_dkdv_smem_bytes(int d, int s) {
  return (2 * (size_t)s * (d + 1) + 2 * (size_t)s +
          (size_t)kWarps * (2 * d + 2 * s)) * sizeof(float);
}

// ------------------------------------------------- bf16, D = 64, wgmma

constexpr int kD = 64;
constexpr int kTile = 64;       // rows per tile, keys per TMA chunk
// A remainder of one row (pass a) or key (pass b) past the last full tile
// goes to the producer warpgroup; a longer one takes a tile of its own. The
// producer's fp32 path costs a block ~3 us a row, a tile ~4.5 us: at the
// training batch, S = 129 / 136 / 144 took 0.110 / 0.357 / 0.140 ms in
// the dq pass with up to 8 rows on the producer
// (perf/torch_attention_backward_timing.py, H100 80GB HBM3, 700 W).
constexpr int kWarpRows = 1;
constexpr int kShortChunk = 16; // a last chunk of <= 16: an n16 step
constexpr int kConsumers = 2;   // consumer warpgroups per block
constexpr int kProducerThreads = 128;   // the producer warpgroup
constexpr int kTcThreads = kConsumers * 128 + kProducerThreads;
constexpr int kProducerBarrier = 1 + kConsumers;   // named barrier id
constexpr int kTileBytes = hopper::kSw128TileBytes;

struct BwdMaps {
  CUtensorMap q, k, v, g;
};

__host__ __device__ inline int ceil_tiles(int n) {
  return (n + kTile - 1) / kTile;
}

// (a): K and V of the head, a Q and a g tile per consumer, barriers, and
// the producer warpgroup's scratch (16-byte aligned): a row's scores and
// dP, 8 floats of reductions, 4 quarters' dq columns.
size_t dq_smem_bytes(int valid_len) {
  const size_t chunks = ceil_tiles(valid_len);
  return 1024 + (2 * chunks + 2 * kConsumers) * kTileBytes +
         (chunks + kConsumers) * sizeof(uint64_t) + 16 +
         (2 * chunks * kTile + 8 + 4 * kD) * sizeof(float);
}

// (b): Q and g of the head, a K and a V tile per consumer, barriers, the
// head's log-sum-exp and D, and the producer warpgroup's scratch (16-byte
// aligned): a key's P and dS, 4 quarters' dk and dv columns.
size_t dkdv_smem_bytes(int s) {
  const size_t chunks = ceil_tiles(s);
  return 1024 + (2 * chunks + 2 * kConsumers) * kTileBytes +
         (chunks + kConsumers) * sizeof(uint64_t) + 16 +
         (4 * chunks * kTile + 4 * 2 * kD) * sizeof(float);
}

// The first 16-byte boundary at or after p (the sizes above carry the
// slack).
__device__ __forceinline__ float* align_16(void* p) {
  return reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(p) + 15) & ~uintptr_t{15});
}

// Two products of a 64-row tile against an N-row one, all bf16 in shared
// memory, K-major over D = 64: x = a.b^T and y = c.e^T, one commit group.
template <int N>
__device__ __forceinline__ void two_products(float (&x)[N / 2],
                                             float (&y)[N / 2], uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t e) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)
    wgmma_ss<N>(x, desc_k_sw128(a, ks), desc_k_sw128(b, ks), ks);
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)
    wgmma_ss<N>(y, desc_k_sw128(c, ks), desc_k_sw128(e, ks), ks);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(x);
  fence_regs(y);
}

// Keys at or past valid_len of an (rows x N keys) accumulator: -inf.
template <int N>
__device__ __forceinline__ void mask_keys(float (&sc)[N / 2], int key0,
                                          int valid_len, int t) {
  if (key0 + N <= valid_len) return;
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

// (a), first sweep, one chunk of N keys: S and dP, then the running max (log2
// units, shared by the 4 lanes of a row), this lane's share of the sum of
// exp and of exp . dP, both rescaled when the max moves.
template <int N>
__device__ __forceinline__ void dq_stats_step(
    float& m_lo, float& m_hi, float& l_lo, float& l_hi, float& d_lo,
    float& d_hi, uint32_t q_addr, uint32_t g_addr, uint32_t k_addr,
    uint32_t v_addr, int key0, int valid_len, float scale_log2, int t) {
  using namespace hopper;
  float sc[N / 2], dp[N / 2];
  two_products<N>(sc, dp, q_addr, k_addr, g_addr, v_addr);
  mask_keys<N>(sc, key0, valid_len, t);
  float cm_lo = -INFINITY, cm_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    cm_lo = fmaxf(cm_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
    cm_hi = fmaxf(cm_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    cm_lo = fmaxf(cm_lo, __shfl_xor_sync(0xffffffffu, cm_lo, x));
    cm_hi = fmaxf(cm_hi, __shfl_xor_sync(0xffffffffu, cm_hi, x));
  }
  // every chunk holds a valid key, so the maxima are finite
  const float mn_lo = fmaxf(m_lo, cm_lo * scale_log2);
  const float mn_hi = fmaxf(m_hi, cm_hi * scale_log2);
  const float a_lo = exp2_fast(m_lo - mn_lo);
  const float a_hi = exp2_fast(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  l_lo *= a_lo;
  l_hi *= a_hi;
  d_lo *= a_lo;
  d_hi *= a_hi;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p_lo = exp2_fast(fmaf(sc[4 * j + e], scale_log2, -m_lo));
      const float p_hi = exp2_fast(fmaf(sc[4 * j + 2 + e], scale_log2, -m_hi));
      l_lo += p_lo;
      l_hi += p_hi;
      d_lo = fmaf(p_lo, dp[4 * j + e], d_lo);
      d_hi = fmaf(p_hi, dp[4 * j + 2 + e], d_hi);
    }
  }
}

// (a), second sweep, one chunk of N keys: S and dP again, P = exp(S scale -
// lse), dS = P (dP - D), and acc += dS.K (dS as bf16 A fragments, its high
// part and remainder, K MN-major).
template <int N>
__device__ __forceinline__ void dq_step(float (&acc)[32], float lse_lo,
                                        float lse_hi, float dl_lo,
                                        float dl_hi, uint32_t q_addr,
                                        uint32_t g_addr, uint32_t k_addr,
                                        uint32_t v_addr, int key0,
                                        int valid_len, float scale_log2,
                                        int t) {
  using namespace hopper;
  float sc[N / 2], dp[N / 2];
  two_products<N>(sc, dp, q_addr, k_addr, g_addr, v_addr);
  mask_keys<N>(sc, key0, valid_len, t);
  uint32_t da[N / 16][4], dr[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kk + h;
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse = e < 2 ? lse_lo : lse_hi;
        const float dl = e < 2 ? dl_lo : dl_hi;
        const float p = exp2_fast(fmaf(sc[4 * j + e], scale_log2, -lse));
        ds[e] = p * (dp[4 * j + e] - dl);
      }
      split_bf16(ds[0], ds[1], da[kk][2 * h], dr[kk][2 * h]);
      split_bf16(ds[2], ds[3], da[kk][2 * h + 1], dr[kk][2 * h + 1]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    wgmma_m64n64k16_rs(acc, da[kk], desc_mn_sw128(k_addr, kk));
    wgmma_m64n64k16_rs(acc, dr[kk], desc_mn_sw128(k_addr, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// A 64-value bf16 row from global memory into fp32 registers (every lane
// reads the same row: one broadcast load per 16 bytes).
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ src,
                                         float (&dst)[kD]) {
#pragma unroll
  for (int cg = 0; cg < kD / 8; ++cg) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + cg * 8);
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[cg * 8 + e] = __bfloat162float(x[e]);
  }
}

// a . row j of `tile` and b . row j of `tile2` (64-row bf16 tiles under the
// 128-byte swizzle), each as two partial sums so the chains are half as
// long.
__device__ __forceinline__ void dot2_rows(const float (&a)[kD],
                                          const float (&b)[kD],
                                          const unsigned char* tile,
                                          const unsigned char* tile2, int j,
                                          float& x, float& y) {
  using hopper::sw128_at;
  float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f;
#pragma unroll
  for (int cg = 0; cg < kD / 8; ++cg) {
    const uint4 ra = *reinterpret_cast<const uint4*>(sw128_at(tile, j, cg * 8));
    const uint4 rb = *reinterpret_cast<const uint4*>(sw128_at(tile2, j, cg * 8));
    const __nv_bfloat16* xa = reinterpret_cast<const __nv_bfloat16*>(&ra);
    const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&rb);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      x0 = fmaf(a[cg * 8 + e], __bfloat162float(xa[e]), x0);
      x1 = fmaf(a[cg * 8 + e + 1], __bfloat162float(xa[e + 1]), x1);
      y0 = fmaf(b[cg * 8 + e], __bfloat162float(xb[e]), y0);
      y1 = fmaf(b[cg * 8 + e + 1], __bfloat162float(xb[e + 1]), y1);
    }
  }
  x = x0 + x1;
  y = y0 + y1;
}

// sum_j w[j] * tiles[j, col .. col + 1] over j0 <= j < j1 (multiples of 4;
// w is zero past the real rows), four rows at a time into independent sums.
// The tiles are consecutive 64-row chunks under the 128-byte swizzle.
__device__ __forceinline__ float2 weighted_cols(const float* w,
                                                const unsigned char* tiles,
                                                int j0, int j1, int col) {
  using hopper::sw128_at;
  float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = j0; j < j1; j += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + j);
    const unsigned char* tile = tiles + (j / kTile) * kTileBytes;
    const float wj[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
          sw128_at(tile, j % kTile + u, col));
      a[u] = fmaf(wj[u], __low2float(x), a[u]);
      b[u] = fmaf(wj[u], __high2float(x), b[u]);
    }
  }
  return make_float2((a[0] + a[1]) + (a[2] + a[3]),
                     (b[0] + b[1]) + (b[2] + b[3]));
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The producer warpgroup's max of x, and sums of x and y, over its 128
// threads (pt its thread index; red: 4 floats of shared memory).
__device__ __forceinline__ float group_max(float x, float* red, int pt) {
  x = hopper::warp_max(x);
  if (pt % 32 == 0) red[pt / 32] = x;
  hopper::named_sync(kProducerBarrier, kProducerThreads);
  x = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  hopper::named_sync(kProducerBarrier, kProducerThreads);
  return x;
}

__device__ __forceinline__ void group_sum2(float& x, float& y, float* red,
                                           int pt) {
  x = hopper::warp_sum(x);
  y = hopper::warp_sum(y);
  if (pt % 32 == 0) {
    red[pt / 32] = x;
    red[4 + pt / 32] = y;
  }
  hopper::named_sync(kProducerBarrier, kProducerThreads);
  x = (red[0] + red[1]) + (red[2] + red[3]);
  y = (red[4] + red[5]) + (red[6] + red[7]);
  hopper::named_sync(kProducerBarrier, kProducerThreads);
}

// Warp pw's quarter [j0, j1) of the rows [0, n4), n4 a multiple of 4, in
// multiples of 4.
__device__ __forceinline__ int2 quarter(int n4, int pw) {
  const int len = round4((n4 + 3) / 4);
  const int j0 = min(n4, pw * len);
  return make_int2(j0, min(n4, j0 + len));
}

// (a), the producer warpgroup once its loads are issued: the last `rows`
// query rows in fp32 on the CUDA cores, from the K and V tiles in shared
// memory. Four warps, one per scheduler, so the work does not queue behind
// the consumer warps' issue. Each thread holds the row's q and g in
// registers; the 128 threads split the keys for the scores and dP, each
// warp a quarter of the keys for dq's columns (two a lane), and warp 0 sums
// the quarters. `scratch` (16-byte aligned) holds the row's scores (then
// dS), dP, the reductions and the quarters' column sums.
__device__ __forceinline__ void dq_rows_simt(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ g,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ lse,
    float* __restrict__ delta, const unsigned char* k_s,
    const unsigned char* v_s, uint64_t* kv_full, float* scratch, int s,
    int rows, int valid_len, float scale, float scale_log2, int pt) {
  using namespace hopper;
  const int n_chunks = ceil_tiles(valid_len);
  const int lane = pt % 32;
  const int pw = pt / 32;
  float* p_row = scratch;
  float* dp_row = p_row + n_chunks * kTile;
  float* red = dp_row + n_chunks * kTile;
  float* part = red + 8;
  for (int c = 0; c < n_chunks; ++c) mbar_wait(kv_full + c, 0);
  const int2 keys = quarter(round4(valid_len), pw);
  for (int r = s - rows; r < s; ++r) {
    float q_row[kD], g_row[kD];
    load_row(q + (size_t)r * kD, q_row);
    load_row(g + (size_t)r * kD, g_row);
    float m = -INFINITY;
    for (int j = pt; j < valid_len; j += kProducerThreads) {
      float sc, dp;
      dot2_rows(q_row, g_row, k_s + (j / kTile) * kTileBytes,
                v_s + (j / kTile) * kTileBytes, j % kTile, sc, dp);
      sc *= scale_log2;
      p_row[j] = sc;
      dp_row[j] = dp;
      m = fmaxf(m, sc);
    }
    m = group_max(m, red, pt);
    float l = 0.f, dn = 0.f;
    for (int j = pt; j < valid_len; j += kProducerThreads) {
      const float p = exp2f(p_row[j] - m);
      p_row[j] = p;
      l += p;
      dn = fmaf(p, dp_row[j], dn);
    }
    group_sum2(l, dn, red, pt);
    const float dl = dn / l;
    const float inv = 1.f / l;
    for (int j = pt; j < round4(valid_len); j += kProducerThreads)
      p_row[j] = j < valid_len ? p_row[j] * inv * (dp_row[j] - dl) : 0.f;
    named_sync(kProducerBarrier, kProducerThreads);
    const int col = 2 * lane;
    *reinterpret_cast<float2*>(part + pw * kD + col) =
        weighted_cols(p_row, k_s, keys.x, keys.y, col);
    named_sync(kProducerBarrier, kProducerThreads);
    if (pw == 0) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        a0 += part[w * kD + col];
        a1 += part[w * kD + col + 1];
      }
      *reinterpret_cast<uint32_t*>(dq + (size_t)r * kD + col) =
          pack_bf16(a0 * scale, a1 * scale);
      if (lane == 0) {
        lse[r] = (m + log2f(l)) * kLn2;
        delta[r] = dl;
      }
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
    vit_attention_bwd_dq_wgmma(const __grid_constant__ BwdMaps maps,
                               const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ g,
                               __nv_bfloat16* __restrict__ dq,
                               float* __restrict__ lse,
                               float* __restrict__ delta, int s,
                               int valid_len, float scale, float scale_log2) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int n_chunks = ceil_tiles(valid_len);
  // a row past the last full tile goes to the producer warpgroup, more rows
  // to a tile of their own
  const int rem = s % kTile;
  const int warp_rows = rem <= kWarpRows ? rem : 0;
  const int n_tiles = ceil_tiles(s - warp_rows);
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + n_chunks * kTileBytes;
  unsigned char* q_s = v_s + n_chunks * kTileBytes;
  unsigned char* g_s = q_s + kConsumers * kTileBytes;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(g_s + kConsumers * kTileBytes);
  uint64_t* qg_full = kv_full + n_chunks;
  float* scratch = align_16(qg_full + kConsumers);
  const int head = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t head_base = (size_t)head * s * kD;
  float* lse_h = lse + (size_t)head * s;
  float* delta_h = delta + (size_t)head * s;

  if (threadIdx.x == 0) {
    for (int c = 0; c < n_chunks; ++c) mbar_init(kv_full + c, 1);
    for (int w = 0; w < kConsumers; ++w) mbar_init(qg_full + w, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // producer warpgroup: the head's K and V, chunk by chunk in key order
    const int pt = threadIdx.x - kConsumers * 128;
    if (pt == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        mbar_expect_tx(kv_full + c, 2 * kTileBytes);
        tma_load(k_s + c * kTileBytes, &maps.k, kv_full + c, 0, c * kTile,
                 head);
        tma_load(v_s + c * kTileBytes, &maps.v, kv_full + c, 0, c * kTile,
                 head);
      }
    }
    if (warp_rows > 0)
      dq_rows_simt(q + head_base, g + head_base, dq + head_base, lse_h,
                   delta_h, k_s, v_s, kv_full, scratch, s, warp_rows,
                   valid_len, scale, scale_log2, pt);
    return;
  }

  // consumer warpgroup wg: query tiles wg, wg + 2, ...
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int gr = lane / 4;
  const int t = lane % 4;
  unsigned char* q_tile = q_s + wg * kTileBytes;
  unsigned char* g_tile = g_s + wg * kTileBytes;
  const uint32_t q_addr = smem_u32(q_tile);
  const uint32_t g_addr = smem_u32(g_tile);
  auto load_qg = [&](int tile) {
    mbar_expect_tx(qg_full + wg, 2 * kTileBytes);
    tma_load(q_tile, &maps.q, qg_full + wg, 0, tile * kTile, head);
    tma_load(g_tile, &maps.g, qg_full + wg, 0, tile * kTile, head);
  };
  if (tid == 0 && wg < n_tiles) load_qg(wg);
  uint32_t phase = 0;
  for (int tile = wg; tile < n_tiles; tile += kConsumers) {
    mbar_wait(qg_full + wg, phase);
    phase ^= 1;

    float m_lo = -INFINITY, m_hi = -INFINITY;   // running max (log2 units)
    float l_lo = 0.f, l_hi = 0.f;               // this lane's share of the sum
    float d_lo = 0.f, d_hi = 0.f;               // ... and of sum(exp . dP)
    for (int c = 0; c * kTile < valid_len; ++c) {
      mbar_wait(kv_full + c, 0);
      const uint32_t k_addr = smem_u32(k_s + c * kTileBytes);
      const uint32_t v_addr = smem_u32(v_s + c * kTileBytes);
      if (valid_len - c * kTile <= kShortChunk)
        dq_stats_step<kShortChunk>(m_lo, m_hi, l_lo, l_hi, d_lo, d_hi, q_addr,
                                   g_addr, k_addr, v_addr, c * kTile,
                                   valid_len, scale_log2, t);
      else
        dq_stats_step<kTile>(m_lo, m_hi, l_lo, l_hi, d_lo, d_hi, q_addr,
                             g_addr, k_addr, v_addr, c * kTile, valid_len,
                             scale_log2, t);
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
      d_lo += __shfl_xor_sync(0xffffffffu, d_lo, x);
      d_hi += __shfl_xor_sync(0xffffffffu, d_hi, x);
    }
    const float lse_lo = m_lo + log2f(l_lo);    // log2 units
    const float lse_hi = m_hi + log2f(l_hi);
    const float dl_lo = d_lo / l_lo;
    const float dl_hi = d_hi / l_hi;
    const int r_lo = tile * kTile + (tid / 32) * 16 + gr;
    const int r_hi = r_lo + 8;
    if (t == 0) {
      if (r_lo < s) {
        lse_h[r_lo] = lse_lo * kLn2;
        delta_h[r_lo] = dl_lo;
      }
      if (r_hi < s) {
        lse_h[r_hi] = lse_hi * kLn2;
        delta_h[r_hi] = dl_hi;
      }
    }

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int c = 0; c * kTile < valid_len; ++c) {
      const uint32_t k_addr = smem_u32(k_s + c * kTileBytes);
      const uint32_t v_addr = smem_u32(v_s + c * kTileBytes);
      if (valid_len - c * kTile <= kShortChunk)
        dq_step<kShortChunk>(acc, lse_lo, lse_hi, dl_lo, dl_hi, q_addr,
                             g_addr, k_addr, v_addr, c * kTile, valid_len,
                             scale_log2, t);
      else
        dq_step<kTile>(acc, lse_lo, lse_hi, dl_lo, dl_hi, q_addr, g_addr,
                       k_addr, v_addr, c * kTile, valid_len, scale_log2, t);
    }
    // the warpgroup is done with its Q and g tiles: load the next ones
    named_sync(1 + wg, 128);
    if (tid == 0 && tile + kConsumers < n_tiles) load_qg(tile + kConsumers);

    __nv_bfloat16* dq_h = dq + head_base;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r_lo < s)
        *reinterpret_cast<uint32_t*>(dq_h + (size_t)r_lo * kD + col) =
            pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (r_hi < s)
        *reinterpret_cast<uint32_t*>(dq_h + (size_t)r_hi * kD + col) =
            pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

// (b), one chunk of N queries (query0 ...) against the warpgroup's 64 keys:
// S^T and dP^T, P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - D) (keys
// at or past valid_len: 0), then dv += P^T.g and dk += dS^T.Q (A from
// registers as high part and remainder, g and Q MN-major). lse_s is in log2
// units, +inf past S.
template <int N>
__device__ __forceinline__ void dkdv_step(float (&dk)[32], float (&dv)[32],
                                          uint32_t k_addr, uint32_t v_addr,
                                          uint32_t q_addr, uint32_t g_addr,
                                          const float* lse_s, const float* d_s,
                                          bool keep_lo, bool keep_hi,
                                          float scale_log2, int t) {
  using namespace hopper;
  float st[N / 2], dpt[N / 2];
  two_products<N>(st, dpt, k_addr, q_addr, v_addr, g_addr);
  uint32_t pa[N / 16][4], pr[N / 16][4], da[N / 16][4], dr[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kk + h;
      const float2 lse = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(d_s + 8 * j + 2 * t);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool keep = e < 2 ? keep_lo : keep_hi;
        const float l = e % 2 ? lse.y : lse.x;
        const float dd = e % 2 ? dl.y : dl.x;
        p[e] = keep ? exp2_fast(fmaf(st[4 * j + e], scale_log2, -l)) : 0.f;
        ds[e] = keep ? p[e] * (dpt[4 * j + e] - dd) : 0.f;
      }
      split_bf16(p[0], p[1], pa[kk][2 * h], pr[kk][2 * h]);
      split_bf16(p[2], p[3], pa[kk][2 * h + 1], pr[kk][2 * h + 1]);
      split_bf16(ds[0], ds[1], da[kk][2 * h], dr[kk][2 * h]);
      split_bf16(ds[2], ds[3], da[kk][2 * h + 1], dr[kk][2 * h + 1]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    wgmma_m64n64k16_rs(dv, pa[kk], desc_mn_sw128(g_addr, kk));
    wgmma_m64n64k16_rs(dv, pr[kk], desc_mn_sw128(g_addr, kk));
    wgmma_m64n64k16_rs(dk, da[kk], desc_mn_sw128(q_addr, kk));
    wgmma_m64n64k16_rs(dk, dr[kk], desc_mn_sw128(q_addr, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
}

// (b), the producer warpgroup once its loads are issued: the last `keys`
// keys in fp32 on the CUDA cores, from the Q and g chunks in shared memory,
// split as in dq_rows_simt: each thread holds the key's k and v in
// registers, the 128 threads split the queries for P and dS, each warp a
// quarter of the queries for dk's and dv's columns, and warp 0 sums the
// quarters. `scratch` (16-byte aligned) holds the key's P and dS over the
// queries, then the quarters' column sums.
__device__ __forceinline__ void dkdv_keys_simt(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const unsigned char* q_s, const unsigned char* g_s, uint64_t* qg_full,
    const float* lse_s, const float* d_s, float* scratch, int s, int keys,
    int valid_len, float scale, float scale_log2, int pt) {
  using namespace hopper;
  const int n_chunks = ceil_tiles(s);
  const int lane = pt % 32;
  const int pw = pt / 32;
  float* p_row = scratch;
  float* ds_row = p_row + n_chunks * kTile;
  float* part = ds_row + n_chunks * kTile;
  for (int c = 0; c < n_chunks; ++c) mbar_wait(qg_full + c, 0);
  const int col = 2 * lane;
  const int2 rows = quarter(round4(s), pw);
  for (int key = s - keys; key < s; ++key) {
    uint32_t* dk_at = reinterpret_cast<uint32_t*>(dk + (size_t)key * kD + col);
    uint32_t* dv_at = reinterpret_cast<uint32_t*>(dv + (size_t)key * kD + col);
    if (key >= valid_len) {
      if (pw == 0) {
        *dk_at = 0u;
        *dv_at = 0u;
      }
      continue;
    }
    float k_row[kD], v_row[kD];
    load_row(k + (size_t)key * kD, k_row);
    load_row(v + (size_t)key * kD, v_row);
    for (int i = pt; i < round4(s); i += kProducerThreads) {
      float p = 0.f, ds = 0.f;     // zero past S
      if (i < s) {
        float sc, dp;
        dot2_rows(k_row, v_row, q_s + (i / kTile) * kTileBytes,
                  g_s + (i / kTile) * kTileBytes, i % kTile, sc, dp);
        p = exp2f(fmaf(sc, scale_log2, -lse_s[i]));
        ds = p * (dp - d_s[i]);
      }
      p_row[i] = p;
      ds_row[i] = ds;
    }
    named_sync(kProducerBarrier, kProducerThreads);
    float* mine = part + pw * 2 * kD;
    *reinterpret_cast<float2*>(mine + col) =
        weighted_cols(ds_row, q_s, rows.x, rows.y, col);
    *reinterpret_cast<float2*>(mine + kD + col) =
        weighted_cols(p_row, g_s, rows.x, rows.y, col);
    named_sync(kProducerBarrier, kProducerThreads);
    if (pw == 0) {
      float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        a0 += part[w * 2 * kD + col];
        a1 += part[w * 2 * kD + col + 1];
        b0 += part[w * 2 * kD + kD + col];
        b1 += part[w * 2 * kD + kD + col + 1];
      }
      *dk_at = pack_bf16(a0 * scale, a1 * scale);
      *dv_at = pack_bf16(b0, b1);
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
    vit_attention_bwd_dkdv_wgmma(const __grid_constant__ BwdMaps maps,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv, int s,
                                 int valid_len, float scale,
                                 float scale_log2) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int n_chunks = ceil_tiles(s);
  // a key past the last full tile goes to the producer warpgroup, more keys
  // to a tile of their own
  const int rem = s % kTile;
  const int warp_keys = rem <= kWarpRows ? rem : 0;
  const int n_tiles = ceil_tiles(s - warp_keys);
  unsigned char* q_s = smem;
  unsigned char* g_s = q_s + n_chunks * kTileBytes;
  unsigned char* k_s = g_s + n_chunks * kTileBytes;
  unsigned char* v_s = k_s + kConsumers * kTileBytes;
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(v_s + kConsumers * kTileBytes);
  uint64_t* kv_full = qg_full + n_chunks;
  float* lse_s = reinterpret_cast<float*>(kv_full + kConsumers);
  float* d_s = lse_s + n_chunks * kTile;
  float* scratch = align_16(d_s + n_chunks * kTile);
  const int head = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t head_base = (size_t)head * s * kD;

  // the head's log-sum-exp (to log2 units) and D; past S, P = 0 and D = 0
  for (int i = threadIdx.x; i < n_chunks * kTile; i += blockDim.x) {
    lse_s[i] = i < s ? lse[(size_t)head * s + i] * kLog2e : INFINITY;
    d_s[i] = i < s ? delta[(size_t)head * s + i] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int c = 0; c < n_chunks; ++c) mbar_init(qg_full + c, 1);
    for (int w = 0; w < kConsumers; ++w) mbar_init(kv_full + w, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // producer warpgroup: the head's Q and g, chunk by chunk in query order
    const int pt = threadIdx.x - kConsumers * 128;
    if (pt == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        mbar_expect_tx(qg_full + c, 2 * kTileBytes);
        tma_load(q_s + c * kTileBytes, &maps.q, qg_full + c, 0, c * kTile,
                 head);
        tma_load(g_s + c * kTileBytes, &maps.g, qg_full + c, 0, c * kTile,
                 head);
      }
    }
    if (warp_keys > 0)
      dkdv_keys_simt(k + head_base, v + head_base, dk + head_base,
                     dv + head_base, q_s, g_s, qg_full, lse_s, d_s, scratch,
                     s, warp_keys, valid_len, scale, scale_log2, pt);
    return;
  }

  // consumer warpgroup wg: key tiles wg, wg + 2, ...
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int gr = lane / 4;
  const int t = lane % 4;
  unsigned char* k_tile = k_s + wg * kTileBytes;
  unsigned char* v_tile = v_s + wg * kTileBytes;
  const uint32_t k_addr = smem_u32(k_tile);
  const uint32_t v_addr = smem_u32(v_tile);
  uint32_t phase = 0;
  for (int tile = wg; tile < n_tiles; tile += kConsumers) {
    const int r_lo = tile * kTile + (tid / 32) * 16 + gr;
    const int r_hi = r_lo + 8;
    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    if (tile * kTile < valid_len) {
      named_sync(1 + wg, 128);    // the last tile's products are done
      if (tid == 0) {
        mbar_expect_tx(kv_full + wg, 2 * kTileBytes);
        tma_load(k_tile, &maps.k, kv_full + wg, 0, tile * kTile, head);
        tma_load(v_tile, &maps.v, kv_full + wg, 0, tile * kTile, head);
      }
      mbar_wait(kv_full + wg, phase);
      phase ^= 1;
      for (int c = 0; c * kTile < s; ++c) {
        mbar_wait(qg_full + c, 0);
        const uint32_t q_addr = smem_u32(q_s + c * kTileBytes);
        const uint32_t g_addr = smem_u32(g_s + c * kTileBytes);
        if (s - c * kTile <= kShortChunk)
          dkdv_step<kShortChunk>(dk_acc, dv_acc, k_addr, v_addr, q_addr,
                                 g_addr, lse_s + c * kTile, d_s + c * kTile,
                                 r_lo < valid_len, r_hi < valid_len,
                                 scale_log2, t);
        else
          dkdv_step<kTile>(dk_acc, dv_acc, k_addr, v_addr, q_addr, g_addr,
                           lse_s + c * kTile, d_s + c * kTile,
                           r_lo < valid_len, r_hi < valid_len, scale_log2,
                           t);
      }
    }
    // keys at or past valid_len: zeros
    __nv_bfloat16* dk_h = dk + head_base;
    __nv_bfloat16* dv_h = dv + head_base;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r_lo < s) {
        const bool keep = r_lo < valid_len;
        *reinterpret_cast<uint32_t*>(dk_h + (size_t)r_lo * kD + col) =
            keep ? pack_bf16(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale)
                 : 0u;
        *reinterpret_cast<uint32_t*>(dv_h + (size_t)r_lo * kD + col) =
            keep ? pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]) : 0u;
      }
      if (r_hi < s) {
        const bool keep = r_hi < valid_len;
        *reinterpret_cast<uint32_t*>(dk_h + (size_t)r_hi * kD + col) =
            keep ? pack_bf16(dk_acc[4 * j + 2] * scale,
                             dk_acc[4 * j + 3] * scale)
                 : 0u;
        *reinterpret_cast<uint32_t*>(dv_h + (size_t)r_hi * kD + col) =
            keep ? pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]) : 0u;
      }
    }
  }
}

// ------------------------------------ bf16, D = 64, fused and persistent

constexpr int kFusedMaxS = 144;           // two 64-key chunks and 16 keys
constexpr int kFusedGroups = 3;           // warpgroups, all of them compute
constexpr int kFusedThreads = kFusedGroups * 128;
constexpr int kRing = 7;                  // operand slots
constexpr int kTmaThread = 2 * 128;       // issues the loads (warpgroup 2)

// A head of S <= kFusedMaxS rows, padded to kPad = NF + NS rows and keys:
// NF keys in 64-key chunks (0, 64 or 128) and NS = 16 tail keys or none.
__host__ __device__ constexpr int fused_pad(int s) {
  return s <= 16 ? 16 : s <= 64 ? 64 : s <= 80 ? 80 : s <= 128 ? 128 : 144;
}

template <int NF, int NS>
struct Fused {
  static constexpr int kPad = NF + NS;
  static constexpr int kSteps = kPad / 16;       // k-steps over kPad
  static constexpr int kBoxBytes = kPad * 128;   // one operand of a head
  // A slot holds at least one 64-row tile, which a row tile reads whole;
  // the rows past the box (and, from the last slot, the 48 rows a third
  // row tile reads past S_max) hold other data, and only give rows past S,
  // which are discarded.
  static constexpr int kSlotBytes = (kPad < 64 ? 64 : kPad) * 128;
  // P (then dS) as bf16, query rows by keys: a 64-key block of kPad rows
  // of 128 B (128-byte swizzle) per 64 keys, then the 16 tail keys as kPad
  // rows of 32 B (32-byte swizzle); one such array for the high parts and
  // one for the remainders
  static constexpr int kBlockBytes = kPad * 128;
  // dq reads its row tile's 64 rows of the staged dS whole; rows past kPad
  // run on into the next block or past the array, so an array holds every
  // row a tile reads of its last 64-key block and of its tail block
  static constexpr int kRowsRead = (kPad + 63) / 64 * 64;
  static constexpr int kTailEnd =
      NF / 64 * kBlockBytes + (NS ? kRowsRead * 32 : 0);
  static constexpr int kBlockEnd =
      NF ? (NF / 64 - 1) * kBlockBytes + kRowsRead * 128 : 0;
  static constexpr int kArrayBytes =
      ((kTailEnd > kBlockEnd ? kTailEnd : kBlockEnd) + 1023) / 1024 * 1024;
  static constexpr size_t kSmemBytes =
      1024 + (size_t)kRing * kSlotBytes + 2 * (size_t)kArrayBytes +
      kRing * sizeof(uint64_t);
  // accumulator arrays of the main and tail keys (one dummy register when
  // a part is absent)
  static constexpr int kMain = NF ? NF / 2 : 1;
  static constexpr int kTail = NS ? NS / 2 : 1;
};

size_t fused_smem_bytes(int s) {
  switch (fused_pad(s)) {
    case 16: return Fused<0, 16>::kSmemBytes;
    case 64: return Fused<64, 0>::kSmemBytes;
    case 80: return Fused<64, 16>::kSmemBytes;
    case 128: return Fused<128, 0>::kSmemBytes;
    default: return Fused<128, 16>::kSmemBytes;
  }
}

// Byte offset in a staging array of the bf16 pair at query row `row`, keys
// 8 j + 2 t and + 1 (j counts 8-key groups over the main keys, then the
// tail's two), for a row with row % 8 == gr: the swizzle then is one XOR
// of the row's base.
template <int NF, int NS>
__device__ __forceinline__ uint32_t stage_at(int j, int row, int gr, int t) {
  using F = Fused<NF, NS>;
  if (j < NF / 8)
    return (j / 8) * F::kBlockBytes +
           ((row * 128 + (gr << 4) + 4 * t) ^ ((j % 8) << 4));
  return NF / 64 * F::kBlockBytes +
         ((row * 32 + (((gr >> 2) & 1) << 4) + 4 * t) ^ ((j - NF / 8) << 4));
}

// dv (or dk / scale) of the 64 keys `key0` ... from the staged P (or dS):
// sum over the kPad query rows of P^T g, with P^T read MN-major from the
// staging arrays (high part and remainder) and g (or q) MN-major from its
// slot.
template <int NF, int NS>
__device__ __forceinline__ void key_tile_product(float (&acc)[32],
                                                 uint32_t hi, uint32_t lo,
                                                 uint32_t rows) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Fused<NF, NS>::kSteps; ++kk) {
    wgmma_m64n64k16_ss_mn(acc, desc_mn_sw128(hi, kk), desc_mn_sw128(rows, kk));
    wgmma_m64n64k16_ss_mn(acc, desc_mn_sw128(lo, kk), desc_mn_sw128(rows, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// The 16 tail keys' dv^T (or dk^T / scale): 64 columns by 16 keys, g^T
// (or q^T) read MN-major from its slot, the staged tail keys MN-major
// under the 32-byte swizzle.
template <int NF, int NS>
__device__ __forceinline__ void tail_keys_product(float (&acc)[8],
                                                  uint32_t rows, uint32_t hi,
                                                  uint32_t lo) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Fused<NF, NS>::kSteps; ++kk) {
    wgmma_m64n16k16_ss_mn(acc, desc_mn_sw128(rows, kk), desc_mn_sw32(hi, kk));
    wgmma_m64n16k16_ss_mn(acc, desc_mn_sw128(rows, kk), desc_mn_sw32(lo, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// Writes a key tile's accumulator (keys key0 + 16 w + g (+ 8), columns
// 8 j + 2 t (+ 1)) times `mul` to out (one head, row-major (S, 64)); keys
// at or past valid_len get zeros, keys past S nothing.
__device__ __forceinline__ void store_key_tile(__nv_bfloat16* out,
                                               const float (&acc)[32],
                                               int key0, int s, int valid_len,
                                               float mul, int warp, int gr,
                                               int t) {
  using hopper::pack_bf16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + warp * 16 + gr + 8 * h;
    if (key >= s) continue;
    const bool keep = key < valid_len;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (size_t)key * kD + 8 * j + 2 * t) =
          keep ? pack_bf16(acc[4 * j + 2 * h] * mul,
                           acc[4 * j + 2 * h + 1] * mul)
               : 0u;
  }
}

// Writes the tail keys' transposed accumulator (columns 16 w + g (+ 8),
// keys key0 + 8 j + 2 t (+ 1)) times `mul` to out, as store_key_tile.
__device__ __forceinline__ void store_tail_keys(__nv_bfloat16* out,
                                                const float (&acc)[8],
                                                int key0, int s, int valid_len,
                                                float mul, int warp, int gr,
                                                int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = warp * 16 + gr + 8 * ((i / 2) % 2);
    const int key = key0 + 8 * (i / 4) + 2 * t + i % 2;
    if (key < s)
      out[(size_t)key * kD + col] =
          __float2bfloat16_rn(key < valid_len ? acc[i] * mul : 0.f);
  }
}

// x, which the compiler may not assume it knows: each phase of the fused
// kernel takes its lane and staging address through this, so that it
// computes its addresses anew and does not keep an earlier phase's equal
// ones (the dS staging's are the P staging's, dk's stores dv's) in
// registers the products need.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// dP of one key chunk (64 keys at key0, or the 16 tail keys): g rows at
// `ga` against V rows at `va`, issued and waited for.
template <int N>
__device__ __forceinline__ void dp_chunk(float (&dp)[N / 2], uint32_t ga,
                                         uint32_t va) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)
    wgmma_ss<N>(dp, desc_k_sw128(ga, ks), desc_k_sw128(va, ks), ks);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dp);
}

// One key chunk of N keys (8-key groups j0 ...) of a warp's rows wrow ...:
// P read back from the staging arrays at `stage` (the words this thread
// wrote), dS = P (dP - D) written over it.
template <int NF, int NS, int N>
__device__ __forceinline__ void ds_in_place(const float (&dp)[N / 2], int j0,
                                            uint32_t stage, int wrow,
                                            const float (&dd)[2], int gr,
                                            int t) {
  using namespace hopper;
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t at =
          stage + stage_at<NF, NS>(j0 + jj, wrow + gr + 8 * h, gr, t);
      float p0, p1;
      unsplit_bf16(ld_shared_u32(at),
                   ld_shared_u32(at + Fused<NF, NS>::kArrayBytes), p0, p1);
      uint32_t whi, wlo;
      split_bf16(p0 * (dp[4 * jj + 2 * h] - dd[h]),
                 p1 * (dp[4 * jj + 2 * h + 1] - dd[h]), whi, wlo);
      st_shared_u32(at, whi);
      st_shared_u32(at + Fused<NF, NS>::kArrayBytes, wlo);
    }
  }
}

// dq / scale of a 64-row tile from the staged dS: dS (K-major from the
// staging arrays at `hi` and `lo`, rows row0 ...) times K (MN-major from
// its slot at `keys`).
template <int NF, int NS>
__device__ __forceinline__ void dq_product(float (&acc)[32], uint32_t hi,
                                           uint32_t lo, int row0,
                                           uint32_t keys) {
  using namespace hopper;
  using F = Fused<NF, NS>;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < F::kSteps; ++kk) {
    const uint64_t b = desc_mn_sw128(keys, kk);
    if (kk < NF / 16) {
      const uint32_t at = kk / 4 * F::kBlockBytes + row0 * 128;
      wgmma_m64n64k16_ss_kmn(acc, desc_k_sw128(hi + at, kk % 4), b);
      wgmma_m64n64k16_ss_kmn(acc, desc_k_sw128(lo + at, kk % 4), b);
    } else {
      const uint32_t at = NF / 64 * F::kBlockBytes + row0 * 32;
      wgmma_m64n64k16_ss_kmn(acc, desc_k_sw32(hi + at), b);
      wgmma_m64n64k16_ss_kmn(acc, desc_k_sw32(lo + at), b);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// One block per SM walks the heads head = blockIdx.x, + gridDim.x, ...
// Three warpgroups; shared memory (from a 1024-byte boundary):
//   ring      kRing slots of max(kPad, 64) x 128 B: the operands g, K, q, V
//             of consecutive heads, in that order, slot n % kRing for the
//             n-th operand the block loads (one TMA box of kPad rows each;
//             rows past S read as zeros)
//   staging   two arrays (bf16 high parts, remainders) of P, then of dS,
//             laid out by stage_at
//   barriers  one mbarrier per slot (TMA bytes arrived)
// Per head, a warpgroup with a row tile computes S and the rows' softmax
// in registers, stages P, and sums D = rowsum(P dP) over dP's key chunks;
// the key jobs take dv = P^T g; then each row tile recomputes dP chunk by
// chunk and turns its staged P into dS in place (each thread rewrites the
// words it wrote); dq = dS K and dk = dS^T q both read the staged dS. No
// product takes an operand from registers and dS never waits in them, so
// the products stay pipelined (ptxas serialises every wgmma of a kernel
// that runs out of registers for one). Block barriers: (0) after S and the
// softmax, once every warpgroup has finished the last head (its dq and dk
// read the staging arrays and its K, q and V slots, which the next head's
// g, K and q now take); (1) P staged; (2) dv done, P read; (3) dS staged
// (g's slot free for the next head's V). A warpgroup runs from its dq and
// dk into the next head's S without waiting.
template <int NF, int NS>
__global__ void __launch_bounds__(kFusedThreads, 1)
    vit_attention_bwd_fused_wgmma(const __grid_constant__ BwdMaps maps,
                                  __nv_bfloat16* __restrict__ dq,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, int bh,
                                  int s, int valid_len, float scale,
                                  float scale_log2) {
  using namespace hopper;
  using F = Fused<NF, NS>;
  constexpr int kAll = (NF + NS) / 2;     // accumulator elements of a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  const uint32_t st_u32 = smem_u32(ring + kRing * F::kSlotBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRing * F::kSlotBytes +
                                               2 * F::kArrayBytes);

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  // Roles: warpgroup w computes query-row tile w (if w < n_rows) and one
  // key job: 64-key tile `job` if job < NF / 64, the 16 tail keys if job ==
  // NF / 64 (and NS), else none. The jobs rotate with n_rows so that a
  // warpgroup without a row tile takes a key tile first.
  const int n_rows = (s + 63) / 64;
  const int job = (wg + 3 - n_rows % 3) % 3;
  const bool has_rows = wg < n_rows;
  const bool key_tile = job < NF / 64;
  const bool tail_keys = NS > 0 && job == NF / 64;
  const int row0 = wg * 64;
  const int wrow = row0 + warp * 16;       // this warp's first row
  // a warp whose rows all lie past kPad (in a last tile) reads other data
  // as its q and g rows; its results are neither staged nor written
  const bool real_rows = wrow < F::kPad;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();

  auto slot = [&](int n) { return ring + (n % kRing) * F::kSlotBytes; };
  // the n-th operand of the block (g, K, q, V of head n / 4) into its slot
  auto issue = [&](int n, int head) {
    const int kind = n % 4;
    const CUtensorMap* map = kind == 0   ? &maps.g
                             : kind == 1 ? &maps.k
                             : kind == 2 ? &maps.q
                                         : &maps.v;
    mbar_expect_tx(full + n % kRing, F::kBoxBytes);
    tma_load(slot(n), map, full + n % kRing, 0, 0, head);
  };
  const bool loader = threadIdx.x == kTmaThread;
  if (loader && blockIdx.x < bh)
    for (int n = 0; n < 4; ++n) issue(n, blockIdx.x);

  int it = 0;
  for (int head = blockIdx.x; head < bh; head += gridDim.x, ++it) {
    const int n0 = 4 * it;
    const bool more = head + gridDim.x < bh;
    for (int n = n0; n < n0 + 4; ++n)
      mbar_wait(full + n % kRing, (n / kRing) & 1);
    const uint32_t g_s = smem_u32(slot(n0));
    const uint32_t k_s = smem_u32(slot(n0 + 1));
    const uint32_t q_s = smem_u32(slot(n0 + 2));
    const uint32_t v_s = smem_u32(slot(n0 + 3));
    const size_t hb = (size_t)head * s * kD;
    int lane = opaque(threadIdx.x % 32);
    int gr = lane / 4;
    int t = lane % 4;

    // ---- row tile: S, and the rows' softmax, whole, in registers
    float sm[F::kMain], st[F::kTail];     // S, then P
    if (has_rows) {
      const uint32_t qa = q_s + row0 * 128;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        if constexpr (NF > 0)
          wgmma_ss<NF>(sm, desc_k_sw128(qa, ks), desc_k_sw128(k_s, ks), ks);
        if constexpr (NS > 0)
          wgmma_ss<16>(st, desc_k_sw128(qa, ks),
                       desc_k_sw128(k_s + NF * 128, ks), ks);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sm);
      fence_regs(st);
      if (real_rows) {
        // each row's kPad keys lie in the 4 lanes of a quad; keys at or
        // past valid_len (and the padding past S) are -inf. Rows past S
        // (zero q and g) get a finite P and dS = 0, and meet zero g and q
        // in dv and dk.
        if (valid_len < NF) {
#pragma unroll
          for (int i = 0; i < NF / 2; ++i)
            if (8 * (i / 4) + 2 * t + i % 2 >= valid_len) sm[i] = -INFINITY;
        }
        if (NS > 0 && valid_len < F::kPad) {
#pragma unroll
          for (int i = 0; i < NS / 2; ++i)
            if (NF + 8 * (i / 4) + 2 * t + i % 2 >= valid_len)
              st[i] = -INFINITY;
        }
        float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kAll; ++i) {
          const float x = i < NF / 2 ? sm[i] : st[i - NF / 2];
          m[(i / 2) % 2] = fmaxf(m[(i / 2) % 2], x);
        }
        float l[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
          m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
          m[h] *= scale_log2;
        }
#pragma unroll
        for (int i = 0; i < kAll; ++i) {
          float& x = i < NF / 2 ? sm[i] : st[i - NF / 2];
          x = exp2_fast(fmaf(x, scale_log2, -m[(i / 2) % 2]));
          l[(i / 2) % 2] += x;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
          l[h] = rcp_fast(l[h]);   // l >= 1: the row's largest term is 1
        }
#pragma unroll
        for (int i = 0; i < kAll; ++i) {
          float& x = i < NF / 2 ? sm[i] : st[i - NF / 2];
          x *= l[(i / 2) % 2];
        }
      } else {
#pragma unroll
        for (int i = 0; i < kAll; ++i)
          (i < NF / 2 ? sm[i] : st[i - NF / 2]) = 0.f;
      }
    }
    __syncthreads();   // (0) every warpgroup is done with the last head
    if (loader && more)       // into the last head's K, q and V slots
      for (int n = 4; n < 7; ++n) issue(n0 + n, head + gridDim.x);
    __syncwarp();

    // ---- P into the staging arrays; D = rowsum(P dP) over dP's chunks
    float dd[2] = {0.f, 0.f};
    if (has_rows) {
      if (real_rows) {
        const uint32_t stage = opaque(st_u32);
#pragma unroll
        for (int j = 0; j < kAll / 4; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            uint32_t whi, wlo;
            if (i < NF / 2)
              split_bf16(sm[i], sm[i + 1], whi, wlo);
            else
              split_bf16(st[i - NF / 2], st[i - NF / 2 + 1], whi, wlo);
            const uint32_t at = stage_at<NF, NS>(j, wrow + gr + 8 * h, gr, t);
            st_shared_u32(stage + at, whi);
            st_shared_u32(stage + F::kArrayBytes + at, wlo);
          }
        }
        fence_proxy_async();
      }
      const uint32_t ga = g_s + row0 * 128;
#pragma unroll
      for (int c = 0; c < NF / 64; ++c) {
        float dp[32];
        dp_chunk<64>(dp, ga, v_s + c * 64 * 128);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dd[(i / 2) % 2] = fmaf(sm[32 * c + i], dp[i], dd[(i / 2) % 2]);
      }
      if constexpr (NS > 0) {
        float dp[8];
        dp_chunk<16>(dp, ga, v_s + NF * 128);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dd[(i / 2) % 2] = fmaf(st[i], dp[i], dd[(i / 2) % 2]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dd[h] += __shfl_xor_sync(0xffffffffu, dd[h], 1);
        dd[h] += __shfl_xor_sync(0xffffffffu, dd[h], 2);
      }
    }
    __syncthreads();   // (1) P staged

    // ---- dv of this warpgroup's keys: P^T g
    lane = opaque(threadIdx.x % 32);
    gr = lane / 4;
    t = lane % 4;
    {
      const uint32_t hi_at = opaque(st_u32) + job * F::kBlockBytes;
      const uint32_t lo_at = hi_at + F::kArrayBytes;
      if (key_tile) {
        float acc[32];
        key_tile_product<NF, NS>(acc, hi_at, lo_at, g_s);
        store_key_tile(dv + hb, acc, 64 * job, s, valid_len, 1.f, warp, gr,
                       t);
      } else if (tail_keys) {
        float acc[8];
        tail_keys_product<NF, NS>(acc, g_s, hi_at, lo_at);
        store_tail_keys(dv + hb, acc, NF, s, valid_len, 1.f, warp, gr, t);
      }
    }
    __syncthreads();   // (2) P read for the last time

    // ---- dS = P (dP - D) in place of P: dP chunk by chunk again, P read
    // back from the staging arrays (the words this thread wrote)
    lane = opaque(threadIdx.x % 32);
    gr = lane / 4;
    t = lane % 4;
    if (has_rows) {
      const uint32_t stage = opaque(st_u32);
      const uint32_t ga = g_s + row0 * 128;
#pragma unroll
      for (int c = 0; c < NF / 64; ++c) {
        float dp[32];
        dp_chunk<64>(dp, ga, v_s + c * 64 * 128);
        if (real_rows) ds_in_place<NF, NS, 64>(dp, 8 * c, stage, wrow, dd, gr, t);
      }
      if constexpr (NS > 0) {
        float dp[8];
        dp_chunk<16>(dp, ga, v_s + NF * 128);
        if (real_rows) ds_in_place<NF, NS, 16>(dp, NF / 8, stage, wrow, dd, gr, t);
      }
      fence_proxy_async();
    }
    __syncthreads();   // (3) dS staged; g and V read for the last time
    if (loader && more)       // the next head's V into this head's g slot
      issue(n0 + 7, head + gridDim.x);
    __syncwarp();

    // ---- dq of the row tile, dS K; dk of the key job, dS^T q
    lane = opaque(threadIdx.x % 32);
    gr = lane / 4;
    t = lane % 4;
    const uint32_t stage = opaque(st_u32);
    if (has_rows) {
      float acc[32];
      dq_product<NF, NS>(acc, stage, stage + F::kArrayBytes, row0, k_s);
      __nv_bfloat16* dq_h = dq + hb;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wrow + gr + 8 * h;
        if (row >= s) continue;
#pragma unroll
        for (int j = 0; j < kD / 8; ++j)
          *reinterpret_cast<uint32_t*>(dq_h + row * kD + 8 * j + 2 * t) =
              pack_bf16(acc[4 * j + 2 * h] * scale,
                        acc[4 * j + 2 * h + 1] * scale);
      }
    }
    const uint32_t hi_at = stage + job * F::kBlockBytes;
    const uint32_t lo_at = hi_at + F::kArrayBytes;
    if (key_tile) {
      float acc[32];
      key_tile_product<NF, NS>(acc, hi_at, lo_at, q_s);
      store_key_tile(dk + hb, acc, 64 * job, s, valid_len, scale, warp, gr,
                     t);
    } else if (tail_keys) {
      float acc[8];
      tail_keys_product<NF, NS>(acc, q_s, hi_at, lo_at);
      store_tail_keys(dk + hb, acc, NF, s, valid_len, scale, warp, gr, t);
    }
  }
}

template <int NF, int NS>
cudaError_t launch_fused(const BwdMaps& maps, void* dq, void* dk, void* dv,
                         int bh, int s, int valid_len, float scale, int grid,
                         cudaStream_t st) {
  static size_t allowed = 0;
  const size_t smem = Fused<NF, NS>::kSmemBytes;
  const cudaError_t err =
      hopper::allow_smem(vit_attention_bwd_fused_wgmma<NF, NS>, smem, &allowed);
  if (err != cudaSuccess) return err;
  vit_attention_bwd_fused_wgmma<NF, NS><<<grid, kFusedThreads, smem, st>>>(
      maps, static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), bh, s, valid_len, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

bool use_tensor_cores(int d, int elem_bytes) {
  return elem_bytes == 2 && d == kD;
}

bool encode_maps(BwdMaps* maps, const void* q, const void* k, const void* v,
                 const void* g, int bh, int s) {
  return hopper::encode_bf16_map(&maps->q, q, bh, s, kD, kTile, 64) &&
         hopper::encode_bf16_map(&maps->k, k, bh, s, kD, kTile, 64) &&
         hopper::encode_bf16_map(&maps->v, v, bh, s, kD, kTile, 64) &&
         hopper::encode_bf16_map(&maps->g, g, bh, s, kD, kTile, 64);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block of the larger of the two passes
// needs; the wrapper checks it against the card's limit before launching.
size_t vit_attention_backward_smem_bytes(int d, int s, int valid_len,
                                         int elem_bytes) {
  if (use_tensor_cores(d, elem_bytes)) {
    const size_t a = dq_smem_bytes(valid_len), b = dkdv_smem_bytes(s);
    return a > b ? a : b;
  }
  const size_t a = simt_dq_smem_bytes(d, valid_len);
  const size_t b = simt_dkdv_smem_bytes(d, s);
  return a > b ? a : b;
}

// q, k, v, g, dq: contiguous (bh, s, d) arrays of one type on the current
// device; lse, delta: bh * s floats, written here for the dk/dv pass.
// is_bf16 selects bf16 (1, tensor cores, d = 64 only) or fp32 (0, CUDA
// cores). Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int vit_attention_backward_dq_launch(const void* q, const void* k,
                                     const void* v, const void* g, void* dq,
                                     float* lse, float* delta, int bh, int s,
                                     int d, int valid_len, float scale,
                                     int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_tensor_cores(d, is_bf16 ? 2 : 4)) {
    static size_t allowed = 0;
    const size_t smem = dq_smem_bytes(valid_len);
    BwdMaps maps;
    if (!encode_maps(&maps, q, k, v, g, bh, s)) return cudaErrorNotSupported;
    err = hopper::allow_smem(vit_attention_bwd_dq_wgmma, smem, &allowed);
    if (err != cudaSuccess) return (int)err;
    vit_attention_bwd_dq_wgmma<<<bh, kTcThreads, smem, st>>>(
        maps, static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dq),
        lse, delta, s, valid_len, scale, scale * kLog2e);
  } else if (is_bf16) {
    return (int)cudaErrorInvalidValue;   // bf16 runs only with d = 64
  } else {
    static size_t allowed = 0;
    const size_t smem = simt_dq_smem_bytes(d, valid_len);
    err = hopper::allow_smem(vit_attention_bwd_dq_simt, smem, &allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((s + kRowsPerBlock - 1) / kRowsPerBlock, bh);
    vit_attention_bwd_dq_simt<<<grid, kWarps * 32, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g),
        static_cast<float*>(dq), lse, delta, s, d, valid_len, scale);
  }
  return (int)cudaGetLastError();
}

// The dk/dv pass: reads q, k, v, g and the dq pass's lse and delta, writes
// dk and dv (contiguous (bh, s, d), the input type). Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int vit_attention_backward_dkdv_launch(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, int bh, int s,
                                       int d, int valid_len, float scale,
                                       int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_tensor_cores(d, is_bf16 ? 2 : 4)) {
    static size_t allowed = 0;
    const size_t smem = dkdv_smem_bytes(s);
    BwdMaps maps;
    if (!encode_maps(&maps, q, k, v, g, bh, s)) return cudaErrorNotSupported;
    err = hopper::allow_smem(vit_attention_bwd_dkdv_wgmma, smem, &allowed);
    if (err != cudaSuccess) return (int)err;
    vit_attention_bwd_dkdv_wgmma<<<bh, kTcThreads, smem, st>>>(
        maps, static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), lse, delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), s,
        valid_len, scale, scale * kLog2e);
  } else if (is_bf16) {
    return (int)cudaErrorInvalidValue;   // bf16 runs only with d = 64
  } else {
    static size_t allowed = 0;
    const size_t smem = simt_dkdv_smem_bytes(d, s);
    err = hopper::allow_smem(vit_attention_bwd_dkdv_simt, smem, &allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((s + kRowsPerBlock - 1) / kRowsPerBlock, bh);
    vit_attention_bwd_dkdv_simt<<<grid, kWarps * 32, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), s, d,
        valid_len, scale);
  }
  return (int)cudaGetLastError();
}

// The longest head the fused kernel takes (S_max).
int vit_attention_backward_fused_max_s() { return kFusedMaxS; }

// Bytes of dynamic shared memory a block of the fused kernel needs at S.
size_t vit_attention_backward_fused_smem_bytes(int s) {
  return fused_smem_bytes(s);
}

// The fused kernel: q, k, v, g bf16, contiguous (bh, s, 64), 16-byte
// aligned; writes dq, dk, dv (the same layout) in one pass over each head,
// with one block per SM of the current device (at most bh). Takes
// 1 <= s <= S_max. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int vit_attention_backward_fused_launch(const void* q, const void* k,
                                        const void* v, const void* g,
                                        void* dq, void* dk, void* dv, int bh,
                                        int s, int valid_len, float scale,
                                        void* stream) {
  if (s < 1 || s > kFusedMaxS || bh < 1) return (int)cudaErrorInvalidValue;
  static int sms = 0;                  // one card per process
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int pad = fused_pad(s);
  BwdMaps maps;
  if (!(hopper::encode_bf16_map(&maps.q, q, bh, s, kD, pad, 64) &&
        hopper::encode_bf16_map(&maps.k, k, bh, s, kD, pad, 64) &&
        hopper::encode_bf16_map(&maps.v, v, bh, s, kD, pad, 64) &&
        hopper::encode_bf16_map(&maps.g, g, bh, s, kD, pad, 64)))
    return (int)cudaErrorNotSupported;
  const int grid = bh < sms ? bh : sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pad) {
    case 16:
      return (int)launch_fused<0, 16>(maps, dq, dk, dv, bh, s, valid_len,
                                      scale, grid, st);
    case 64:
      return (int)launch_fused<64, 0>(maps, dq, dk, dv, bh, s, valid_len,
                                      scale, grid, st);
    case 80:
      return (int)launch_fused<64, 16>(maps, dq, dk, dv, bh, s, valid_len,
                                       scale, grid, st);
    case 128:
      return (int)launch_fused<128, 0>(maps, dq, dk, dv, bh, s, valid_len,
                                       scale, grid, st);
    default:
      return (int)launch_fused<128, 16>(maps, dq, dk, dv, bh, s, valid_len,
                                        scale, grid, st);
  }
}

}  // extern "C"
