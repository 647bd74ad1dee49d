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
// input type. (fp32 callers hand in q, k, v rounded to bf16, which is what
// the TPU kernel's DEFAULT-precision dots do with fp32 operands.)
//
// Bound at SAM-H's global blocks (B = 1, H = 16, S = 4096, D = 80, bf16) on
// an H100 SXM: the two products are 4 * B * H * S^2 * D = 85.9 GFLOP, 87 us
// at 989 TFLOP/s; reading q, k, v, bias_h, bias_w and writing out is 58.7 MB,
// 18 us at 3.35 TB/s. So the kernel is bound by operations. At SAM-B
// (1, 12, 4096, 64): 51.5 GFLOP, 52 us.
//
// The TPU kernel keeps one head's whole K and V in VMEM (1.3 MB at S = 4096,
// D = 80). A block here has at most 227 KB of shared memory, so K and V
// stream through it FlashAttention-2 style:
//
// * one block per (128 query rows, batch * head), 8 warps of 16 rows each;
// * K and V tiles of 64 keys are copied with cp.async into a double buffer,
//   the next tile in flight while the current one is used; rows carry 16
//   bytes of padding so fragment loads (ldmatrix) hit distinct banks;
// * Q.K^T and P.V run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate) with an online softmax, so scores, P and the output
//   accumulator stay in registers: the (S, S) scores never reach memory;
// * the bias is never expanded in memory either. The block copies its 128
//   rows of bias_h (128 x HK) into shared memory once, as fp32 scaled by
//   log2(e). When a key grid row is one key tile (WK = 64, SAM's 1024 px
//   and 768 x 1024 px canvases), tile ci is grid row ci: each score adds
//   the scalar bias_h[i, ci] and bias_w[i, its column], and a lane's 16
//   columns are the same in every tile, so its bias_w values sit in
//   registers for the whole loop. Other widths keep bias_w in shared memory
//   too and look both terms up per score (key j -> row j / WK, column
//   j % WK, stepped incrementally, no division in the inner loop). The TPU
//   kernel's 0/1 expansion matmuls were a Mosaic workaround and have no
//   counterpart here.
//
// Head sizes 64 (SAM-B/L) and 80 (SAM-H): D = 80 is 5 k-steps of the
// m16n8k16 product for Q.K^T and 10 n-tiles for P.V. Tail query rows and
// tail keys (S not a multiple of 128 or 64) are masked. wgmma and TMA are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = kWarps * 16;   // query rows per block
constexpr int kChunk = 64;           // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int kv_stride(int d) { return d + 8; }
// fp32 words per shared bias row: a multiple of 32 plus 8, so the 8 rows one
// warp's lanes read start on different banks
__host__ __device__ constexpr int bias_stride(int n) {
  return (n + 31) / 32 * 32 + 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Copy keys [kc, kc + kChunk) of one head's K and V into shared memory
// (cp.async, one group); keys past s are zero-filled.
template <int D>
__device__ __forceinline__ void load_kv(__nv_bfloat16* k_dst,
                                        __nv_bfloat16* v_dst,
                                        const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, size_t base,
                                        int kc, int s) {
  constexpr int kVecs = D / 8;   // 16-byte vectors per row
  for (int i = threadIdx.x; i < kChunk * kVecs; i += blockDim.x) {
    const int r = i / kVecs;
    const int c = i - r * kVecs;
    const int key = kc + r;
    const int bytes = key < s ? 16 : 0;
    const size_t src = base + (size_t)(key < s ? key : 0) * D + c * 8;
    cp_async16(smem_u32(k_dst + r * kv_stride(D) + c * 8), k + src, bytes);
    cp_async16(smem_u32(v_dst + r * kv_stride(D) + c * 8), v + src, bytes);
  }
  cp_async_commit();
}

// Shared bias_w rows per block: none when a key tile is one grid row.
__host__ __device__ constexpr int bias_w_stride(int wk) {
  return wk == kChunk ? 0 : bias_stride(wk);
}

// Fragment layout (PTX m16n8k16): lane = 4 * g + t. A regs: (row g, cols
// 2t..2t+1), (row g+8, same), (row g, cols 2t+8..), (row g+8, cols 2t+8..).
// B regs: (rows 2t..2t+1, col g), (rows 2t+8.., col g). C: c0,c1 at (row g,
// cols 2t, 2t+1), c2,c3 at (row g+8, same cols).
// kRowTiles: WK == kChunk, so key tile ci is key grid row ci.
template <int D, typename T, bool kRowTiles>
__global__ void __launch_bounds__(kWarps * 32)
    sam_attention_mma(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const T* __restrict__ bias_h,
                      const T* __restrict__ bias_w, T* __restrict__ out,
                      int s, int hk, int wk, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hkp = bias_stride(hk);
  const int wkp = bias_w_stride(wk);
  float* bh_s = reinterpret_cast<float*>(smem);
  float* bw_s = bh_s + kRows * hkp;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(bw_s + kRows * wkp);
  constexpr int kTile = kChunk * kv_stride(D);   // bf16 per K or V tile
  __nv_bfloat16* v_s = k_s + 2 * kTile;

  const size_t base = (size_t)blockIdx.y * s * D;
  const int row0 = blockIdx.x * kRows;
  const int n_chunks = (s + kChunk - 1) / kChunk;
  load_kv<D>(k_s, v_s, k, v, base, 0, s);

  // this block's bias rows, as fp32 in log2 units; rows past s are zero
  {
    const size_t bh_base = ((size_t)blockIdx.y * s + row0) * hk;
    const int bh_end = (s - row0) * hk;
    for (int i = threadIdx.x; i < kRows * hk; i += blockDim.x) {
      const int r = i / hk;
      bh_s[r * hkp + (i - r * hk)] =
          i < bh_end ? to_float(bias_h[bh_base + i]) * kLog2e : 0.f;
    }
    if (!kRowTiles) {
      const size_t bw_base = ((size_t)blockIdx.y * s + row0) * wk;
      const int bw_end = (s - row0) * wk;
      for (int i = threadIdx.x; i < kRows * wk; i += blockDim.x) {
        const int r = i / wk;
        bw_s[r * wkp + (i - r * wk)] =
            i < bw_end ? to_float(bias_w[bw_base + i]) * kLog2e : 0.f;
      }
    }
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rl_lo = warp * 16 + g;   // this lane's rows within the block
  const int rl_hi = rl_lo + 8;
  const int r_lo = row0 + rl_lo;
  const int r_hi = row0 + rl_hi;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    const __nv_bfloat16* q_lo = q + base + (size_t)r_lo * D + c;
    const __nv_bfloat16* q_hi = q + base + (size_t)r_hi * D + c;
    qa[ks][0] = r_lo < s ? *reinterpret_cast<const uint32_t*>(q_lo) : 0u;
    qa[ks][1] = r_hi < s ? *reinterpret_cast<const uint32_t*>(q_hi) : 0u;
    qa[ks][2] = r_lo < s ? *reinterpret_cast<const uint32_t*>(q_lo + 8) : 0u;
    qa[ks][3] = r_hi < s ? *reinterpret_cast<const uint32_t*>(q_hi + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;   // running max (log2 units)
  float l_lo = 0.f, l_hi = 0.f;               // this lane's share of the sum
  const float* bh_lo = bh_s + rl_lo * hkp;
  const float* bh_hi = bh_s + rl_hi * hkp;
  const float* bw_lo = bw_s + rl_lo * wkp;
  const float* bw_hi = bw_s + rl_hi * wkp;
  // kRowTiles: this lane's bias_w columns nt * 8 + 2t + e, in log2 units
  float bwr_lo[kChunk / 8][2], bwr_hi[kChunk / 8][2];
  if (kRowTiles) {
    const T* w_lo = bias_w + ((size_t)blockIdx.y * s + r_lo) * wk;
    const T* w_hi = bias_w + ((size_t)blockIdx.y * s + r_hi) * wk;
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t + e;
        bwr_lo[nt][e] = r_lo < s ? to_float(w_lo[c]) * kLog2e : 0.f;
        bwr_hi[nt][e] = r_hi < s ? to_float(w_hi[c]) * kLog2e : 0.f;
      }
    }
  }

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int kc = ci * kChunk;
    const int stage = ci & 1;
    if (ci + 1 < n_chunks) {
      load_kv<D>(k_s + (stage ^ 1) * kTile, v_s + (stage ^ 1) * kTile, k, v,
                 base, kc + kChunk, s);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = k_s + stage * kTile;
    const __nv_bfloat16* vt = v_s + stage * kTile;

    float sc[kChunk / 8][4];
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    // Q.K^T. ldmatrix.x4: lane i points at row i % 8 of 8x8 matrix i / 8
    // (keys +8 for the upper two matrices, columns +8 for odd ones) and
    // receives (key g; columns 2t, 2t+1) of each: b0, b1 of two n-tiles
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kChunk / 16; ++np) {
        const int key = np * 16 + (lane / 16) * 8 + lane % 8;
        const int col = ks * 16 + (lane / 8 % 2) * 8;
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(kt + key * kv_stride(D) + col));
        mma_bf16(sc[2 * np], qa[ks], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qa[ks], b[2], b[3]);
      }
    }

    float cm_lo = -INFINITY, cm_hi = -INFINITY;
    if (kRowTiles) {
      // grid row ci: every key of the tile is valid (s = hk * kChunk)
      const float b_lo = bh_lo[ci];
      const float b_hi = bh_hi[ci];
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[nt][e] = sc[nt][e] * scale_log2 + (b_lo + bwr_lo[nt][e]);
          sc[nt][2 + e] = sc[nt][2 + e] * scale_log2 + (b_hi + bwr_hi[nt][e]);
          cm_lo = fmaxf(cm_lo, sc[nt][e]);
          cm_hi = fmaxf(cm_hi, sc[nt][2 + e]);
        }
      }
    } else {
      // scale, bias, mask. Key j of this lane's first column: (ky, kx) with
      // j = ky * wk + kx, stepped by 8 per n-tile
      int j = kc + 2 * t;
      int ky = j / wk;
      int kx = j - ky * wk;
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        int y = ky, x = kx;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (j + e < s) {
            sc[nt][e] = sc[nt][e] * scale_log2 + bh_lo[y] + bw_lo[x];
            sc[nt][2 + e] = sc[nt][2 + e] * scale_log2 + bh_hi[y] + bw_hi[x];
          } else {
            sc[nt][e] = -INFINITY;
            sc[nt][2 + e] = -INFINITY;
          }
          cm_lo = fmaxf(cm_lo, sc[nt][e]);
          cm_hi = fmaxf(cm_hi, sc[nt][2 + e]);
          if (++x == wk) {
            x = 0;
            ++y;
          }
        }
        j += 8;
        kx += 8;
        while (kx >= wk) {
          kx -= wk;
          ++ky;
        }
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {      // the 4 lanes that share a row
      cm_lo = fmaxf(cm_lo, __shfl_xor_sync(0xffffffffu, cm_lo, o));
      cm_hi = fmaxf(cm_hi, __shfl_xor_sync(0xffffffffu, cm_hi, o));
    }
    // key 0 is valid, so after the first tile both maxima are finite
    const float mn_lo = fmaxf(m_lo, cm_lo);
    const float mn_hi = fmaxf(m_hi, cm_hi);
    const float a_lo = exp2f(m_lo - mn_lo);
    const float a_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= a_lo;
      acc[nt][1] *= a_lo;
      acc[nt][2] *= a_hi;
      acc[nt][3] *= a_hi;
    }

    // P.V, 16 keys per step; P rounded to bf16 as on the TPU
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(sc[2 * kk + h][0] - m_lo);
        const float p1 = exp2f(sc[2 * kk + h][1] - m_lo);
        const float p2 = exp2f(sc[2 * kk + h][2] - m_hi);
        const float p3 = exp2f(sc[2 * kk + h][3] - m_hi);
        l_lo += p0 + p1;
        l_hi += p2 + p3;
        pa[2 * h] = pack_bf16(p0, p1);
        pa[2 * h + 1] = pack_bf16(p2, p3);
      }
      // V fragments of 16 keys x 16 columns per ldmatrix.x4.trans: lane i
      // points at row i % 8 of matrix i / 8 (keys +8 for odd matrices,
      // columns +8 for the upper two), and receives (keys 2t, 2t+1;
      // column g) of each, the B layout
      const int v_key = kk * 16 + (lane / 8 % 2) * 8 + lane % 8;
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, smem_u32(vt + v_key * kv_stride(D) + np * 16 + lane / 16 * 8));
        mma_bf16(acc[2 * np], pa, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();   // the next iteration overwrites this stage
  }

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r_lo < s)
      store_pair(out + base + (size_t)r_lo * D + c, acc[nt][0] * inv_lo,
                 acc[nt][1] * inv_lo);
    if (r_hi < s)
      store_pair(out + base + (size_t)r_hi * D + c, acc[nt][2] * inv_hi,
                 acc[nt][3] * inv_hi);
  }
}

template <int D, typename T, bool kRowTiles>
cudaError_t launch_tiles(const void* q, const void* k, const void* v,
                         const void* bias_h, const void* bias_w, void* out,
                         int bh, int s, int hk, int wk, float scale,
                         size_t smem, cudaStream_t stream) {
  // raised once per instance and size, not per launch (one card per process)
  static size_t smem_allowed = 0;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        sam_attention_mma<D, T, kRowTiles>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  const dim3 grid((s + kRows - 1) / kRows, bh);
  sam_attention_mma<D, T, kRowTiles><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const T*>(bias_h),
      static_cast<const T*>(bias_w), static_cast<T*>(out), s, hk, wk,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias_h, const void* bias_w, void* out, int bh,
                   int s, int hk, int wk, float scale, size_t smem,
                   cudaStream_t stream) {
  return wk == kChunk
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
  return (size_t)kRows * (bias_stride(hk) + bias_w_stride(wk)) * sizeof(float) +
         (size_t)4 * kChunk * kv_stride(d) * sizeof(__nv_bfloat16);
}

// q, k, v: contiguous (bh, s, d) bf16; bias_h (bh, s, hk), bias_w (bh, s, wk)
// and out (bh, s, d): contiguous, bf16 (is_fp32 = 0) or fp32 (is_fp32 = 1);
// s = hk * wk, d in {64, 80}. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int sam_attention_launch(const void* q, const void* k, const void* v,
                         const void* bias_h, const void* bias_w, void* out,
                         int bh, int s, int d, int hk, int wk, float scale,
                         int is_fp32, void* stream) {
  if (hk * wk != s || (d != 64 && d != 80))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sam_attention_smem_bytes(d, hk, wk);
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
