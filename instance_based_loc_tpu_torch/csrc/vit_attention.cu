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
// So the kernel is bound by memory at ~7.5 us. The design moves no byte it
// need not: each block keeps its (batch, head)'s K and V in shared memory and
// the (S, S) scores never reach device memory.
//
// Two kernels, one block per (tile of 64 query rows, batch * head), four
// warps:
//
// * vit_attention_mma (bf16, D = 64): each warp owns 16 query rows. Q.K^T and
//   P.V run on the tensor cores as mma.sync m16n8k16 (bf16 in, fp32
//   accumulate), with an online softmax over 64-key chunks, so scores, P and
//   the output accumulator stay in registers. P is split into a bf16 high
//   part and a bf16 remainder, two products, so P.V keeps ~16 bits of P as
//   the fp32 reference does. K and V are copied in with cp.async (every copy
//   in flight at once) and sit in shared memory with 16 bytes of padding per
//   row, which puts the 8 rows one fragment load touches on 8 distinct bank
//   groups.
// * vit_attention_simt (fp32, any even D): each warp takes every
//   fourth row; lanes split the keys for the scores (kept in shared memory)
//   and the columns for P.V, on the CUDA cores. K and V rows carry one word
//   of padding, so 32 lanes reading 32 key rows at one column hit 32 banks.
//
// wgmma and TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerBlock = 64;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// CUDA-core kernel (fp32). Shared memory: K and V (valid_len rows each, one
// word of padding per row), then one query row and one score row per warp.
__global__ void __launch_bounds__(kWarps * 32)
    vit_attention_simt(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int s, int d, int valid_len, float scale) {
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

constexpr int kMmaD = 64;        // head size of the tensor-core kernel
constexpr int kChunk = 64;       // keys per online-softmax step
constexpr int kMmaStride = kMmaD + 8;   // bf16 per shared K/V row (16 B pad)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
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

// Fragment layout (PTX m16n8k16): lane = 4 * g + t. A regs: (row g, cols
// 2t..2t+1), (row g+8, same), (row g, cols 2t+8..), (row g+8, cols 2t+8..).
// B regs: (rows 2t..2t+1, col g), (rows 2t+8.., col g). C: c0,c1 at (row g,
// cols 2t, 2t+1), c2,c3 at (row g+8, same cols).
__global__ void __launch_bounds__(kWarps * 32)
    vit_attention_mma(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int s, int valid_len,
                      float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_keys = (valid_len + kChunk - 1) / kChunk * kChunk;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + (size_t)n_keys * kMmaStride;

  const size_t base = (size_t)blockIdx.y * s * kMmaD;
  constexpr int kVecs = kMmaD / 8;        // 16-byte vectors per row
  // every copy in flight at once (cp.async); rows past valid_len are
  // zero-filled (source size 0), so the padded keys hold no stale data
  for (int i = threadIdx.x; i < n_keys * kVecs; i += blockDim.x) {
    const int r = i / kVecs;
    const int c = i - r * kVecs;
    const int bytes = r < valid_len ? 16 : 0;
    const size_t src = base + (size_t)(r < valid_len ? r : 0) * kMmaD + c * 8;
    const uint32_t k_dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(k_s + r * kMmaStride + c * 8));
    const uint32_t v_dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(v_s + r * kMmaStride + c * 8));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(k_dst), "l"(k + src), "r"(bytes));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(v_dst), "l"(v + src), "r"(bytes));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * 16;
  if (row0 >= s) return;                  // warp-uniform; no barrier follows
  const int r_lo = row0 + g;
  const int r_hi = row0 + g + 8;

  uint32_t qa[kMmaD / 16][4];
  #pragma unroll
  for (int ks = 0; ks < kMmaD / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    const __nv_bfloat16* q_lo = q + base + (size_t)r_lo * kMmaD + c;
    const __nv_bfloat16* q_hi = q + base + (size_t)r_hi * kMmaD + c;
    qa[ks][0] = r_lo < s ? *reinterpret_cast<const uint32_t*>(q_lo) : 0u;
    qa[ks][1] = r_hi < s ? *reinterpret_cast<const uint32_t*>(q_hi) : 0u;
    qa[ks][2] = r_lo < s ? *reinterpret_cast<const uint32_t*>(q_lo + 8) : 0u;
    qa[ks][3] = r_hi < s ? *reinterpret_cast<const uint32_t*>(q_hi + 8) : 0u;
  }

  float acc[kMmaD / 8][4];
  #pragma unroll
  for (int nt = 0; nt < kMmaD / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;   // running max (log2 units)
  float l_lo = 0.f, l_hi = 0.f;               // this lane's share of the sum

  for (int kc = 0; kc < n_keys; kc += kChunk) {
    float sc[kChunk / 8][4];
    #pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    // k-steps outer: consecutive mma write different accumulators
    #pragma unroll
    for (int ks = 0; ks < kMmaD / 16; ++ks) {
      #pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        const __nv_bfloat16* k_row =
            k_s + (kc + nt * 8 + g) * kMmaStride + ks * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(k_row);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(k_row + 8);
        mma_bf16(sc[nt], qa[ks], b0, b1);
      }
    }
    float cm_lo = -INFINITY, cm_hi = -INFINITY;
    #pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      #pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = kc + nt * 8 + 2 * t + j < valid_len;
        sc[nt][j] = ok ? sc[nt][j] * scale_log2 : -INFINITY;
        sc[nt][2 + j] = ok ? sc[nt][2 + j] * scale_log2 : -INFINITY;
        cm_lo = fmaxf(cm_lo, sc[nt][j]);
        cm_hi = fmaxf(cm_hi, sc[nt][2 + j]);
      }
    }
    #pragma unroll
    for (int o = 1; o < 4; o <<= 1) {      // the 4 lanes that share a row
      cm_lo = fmaxf(cm_lo, __shfl_xor_sync(0xffffffffu, cm_lo, o));
      cm_hi = fmaxf(cm_hi, __shfl_xor_sync(0xffffffffu, cm_hi, o));
    }
    // key 0 is valid, so after the first chunk both maxima are finite
    const float mn_lo = fmaxf(m_lo, cm_lo);
    const float mn_hi = fmaxf(m_hi, cm_hi);
    const float a_lo = exp2f(m_lo - mn_lo);
    const float a_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
    #pragma unroll
    for (int nt = 0; nt < kMmaD / 8; ++nt) {
      acc[nt][0] *= a_lo;
      acc[nt][1] *= a_lo;
      acc[nt][2] *= a_hi;
      acc[nt][3] *= a_hi;
    }

    #pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      float p[2][4];
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h][0] = exp2f(sc[2 * kk + h][0] - m_lo);
        p[h][1] = exp2f(sc[2 * kk + h][1] - m_lo);
        p[h][2] = exp2f(sc[2 * kk + h][2] - m_hi);
        p[h][3] = exp2f(sc[2 * kk + h][3] - m_hi);
        l_lo += p[h][0] + p[h][1];
        l_hi += p[h][2] + p[h][3];
      }
      uint32_t pa[4], pr[4];              // P as bf16 high part + remainder
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat16 hb[4];
        #pragma unroll
        for (int e = 0; e < 4; ++e) hb[e] = __float2bfloat16_rn(p[h][e]);
        pa[2 * h] = pack_bf16(hb[0], hb[1]);
        pa[2 * h + 1] = pack_bf16(hb[2], hb[3]);
        pr[2 * h] = pack_bf16(p[h][0] - __bfloat162float(hb[0]),
                              p[h][1] - __bfloat162float(hb[1]));
        pr[2 * h + 1] = pack_bf16(p[h][2] - __bfloat162float(hb[2]),
                                  p[h][3] - __bfloat162float(hb[3]));
      }
      // V fragments of 16 keys x 16 columns per ldmatrix.x4.trans: lane i
      // points at row i % 8 of 8x8 matrix i / 8 (keys +8 for odd matrices,
      // columns +8 for the upper two), and receives (keys 2t, 2t+1; column
      // g) of each, the B layout
      uint32_t vb[kMmaD / 8][2];
      const int v_key = kc + kk * 16 + (lane / 8 % 2) * 8 + lane % 8;
      #pragma unroll
      for (int np = 0; np < kMmaD / 16; ++np) {
        const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(
            v_s + v_key * kMmaStride + np * 16 + lane / 16 * 8));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(vb[2 * np][0]), "=r"(vb[2 * np][1]),
              "=r"(vb[2 * np + 1][0]), "=r"(vb[2 * np + 1][1])
            : "r"(addr));
      }
      #pragma unroll
      for (int nt = 0; nt < kMmaD / 8; ++nt)
        mma_bf16(acc[nt], pa, vb[nt][0], vb[nt][1]);
      #pragma unroll
      for (int nt = 0; nt < kMmaD / 8; ++nt)
        mma_bf16(acc[nt], pr, vb[nt][0], vb[nt][1]);
    }
  }

  #pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  #pragma unroll
  for (int nt = 0; nt < kMmaD / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r_lo < s)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r_lo * kMmaD + c) =
          pack_bf16(acc[nt][0] * inv_lo, acc[nt][1] * inv_lo);
    if (r_hi < s)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r_hi * kMmaD + c) =
          pack_bf16(acc[nt][2] * inv_hi, acc[nt][3] * inv_hi);
  }
}

cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out,
                        int bh, int s, int d, int valid_len, float scale,
                        size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_simt, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  vit_attention_simt<<<grid, kWarps * 32, smem_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, d, valid_len,
      scale);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int bh, int s, int valid_len, float scale,
                       size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  vit_attention_mma<<<grid, kWarps * 32, smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      s, valid_len, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

bool use_mma(int d, int elem_bytes) { return elem_bytes == 2 && d == kMmaD; }

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the wrapper checks it
// against the card's limit before launching.
size_t vit_attention_smem_bytes(int d, int valid_len, int elem_bytes) {
  if (use_mma(d, elem_bytes)) {
    const size_t n_keys = (size_t)(valid_len + kChunk - 1) / kChunk * kChunk;
    return 2 * n_keys * kMmaStride * sizeof(__nv_bfloat16);
  }
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
  if (use_mma(d, elem_bytes))
    err = launch_mma(q, k, v, out, bh, s, valid_len, scale, smem, st);
  else if (is_bf16)
    err = cudaErrorInvalidValue;   // bf16 runs only with d = 64
  else
    err = launch_simt(q, k, v, out, bh, s, d, valid_len, scale, smem, st);
  return (int)err;
}

}  // extern "C"
