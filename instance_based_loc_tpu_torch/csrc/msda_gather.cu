// One multi-scale deformable attention level's sample-and-reduce,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel instance_based_loc_tpu/ops/pallas/msda_gather.py:
// _kernel (called from msda_level_gather_pallas), which computes the
// contract of instance_based_loc_tpu/ops/msda.py:_level_gather:
//
//   out[q, h, :] = sum_{t < T} coeff[q, h, t] * float(v[lin[q, h, t], h, :])
//
// for a level's value map v (S, H, D) (bf16 or fp32), per-head row indices
// lin (Q, H, T) int32 (K sampling points x 4 bilinear taps, T = 4K, row
// y * W + x) and folded tap x attention coefficients coeff (Q, H, T) fp32;
// the output (Q, H, D) is fp32. The tap count is a template parameter,
// instantiated for K = 1..8 (T = 4..32); GroundingDINO's default is K = 4.
// Indices outside [0, S) are clamped (the callers' are in range already:
// out-of-range taps carry coefficient 0 and a clamped index). The value map
// is read in the (S, H, D) layout the model holds it in: no head-major copy.
//
// Bound at GroundingDINO@800's level 0 (S = 100 x 100 = 10000, H = 8,
// D = 32, bf16 values) on an H100 SXM, encoder shape Q = 13294: the bytes
// are lin and coeff (Q * H * T * 4 B each), the value map (5.1 MB) and the
// output (13.6 MB). At T = 16 that is 6.8 + 6.8 + 5.1 + 13.6 = 32 MB, 10 us
// at 3.35 TB/s; at T = 8, 25 MB (7.4 us); at T = 32, 46 MB (13.6 us). The
// T multiply-adds per output element (0.11 GFLOP at T = 16) are far below
// any arithmetic bound, so it is bound by bytes at every T. The gathered
// 64-byte rows (Q * H * T of them, 109 MB at T = 16) come from L2: the whole
// value map fits in the 50 MB L2 many times over, which is what the TPU
// kernel tried to get from VMEM.
//
// Design: one thread per (query, head, 8 consecutive channels). The D / 8
// threads of one (query, head) read its T indices and coefficients (as
// 16-byte vectors, the same lines, so the loads coalesce), then each
// gathers T vectors of 8 channels (16 bytes in bf16) and accumulates in
// fp32 registers, and writes 8 fp32 channels. Consecutive threads cover
// consecutive channels, heads and queries, so both the gathers of one tap
// and the output stores are contiguous. D must be a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(pair);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T, int kTaps>
__global__ void __launch_bounds__(kThreads)
    msda_gather(const T* __restrict__ value, const int* __restrict__ lin,
                const float* __restrict__ coeff, float* __restrict__ out,
                int s, int h, int d, long long n_threads) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n_threads) return;
  const int vecs = d / 8;
  const long long qh = tid / vecs;            // (query, head) pair
  const int c = (int)(tid - qh * vecs) * 8;   // first channel
  const int head = (int)(qh % h);

  int idx[kTaps];
  float w[kTaps];
  const int4* lin4 = reinterpret_cast<const int4*>(lin + qh * kTaps);
  const float4* coeff4 = reinterpret_cast<const float4*>(coeff + qh * kTaps);
#pragma unroll
  for (int i = 0; i < kTaps / 4; ++i) {
    const int4 li = lin4[i];
    const float4 cw = coeff4[i];
    idx[4 * i] = li.x; idx[4 * i + 1] = li.y;
    idx[4 * i + 2] = li.z; idx[4 * i + 3] = li.w;
    w[4 * i] = cw.x; w[4 * i + 1] = cw.y;
    w[4 * i + 2] = cw.z; w[4 * i + 3] = cw.w;
  }

  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const int row = min(max(idx[t], 0), s - 1);
    float x[8];
    load8(value + ((size_t)row * h + head) * d + c, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(w[t], x[i], acc[i]);
  }
  float* o = out + qh * d + c;
  *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(o + 4) =
      make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <typename T>
int launch_typed(const T* value, const int* lin, const float* coeff,
                 float* out, int s, int h, int d, long long n_threads,
                 int taps, unsigned blocks, cudaStream_t st) {
  switch (taps) {
#define MSDA_TAPS(N)                                                   \
  case N:                                                              \
    msda_gather<T, N><<<blocks, kThreads, 0, st>>>(value, lin, coeff,  \
                                                   out, s, h, d,       \
                                                   n_threads);         \
    return (int)cudaGetLastError();
    MSDA_TAPS(4) MSDA_TAPS(8) MSDA_TAPS(12) MSDA_TAPS(16)
    MSDA_TAPS(20) MSDA_TAPS(24) MSDA_TAPS(28) MSDA_TAPS(32)
#undef MSDA_TAPS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// value: contiguous (s, h, d), bf16 (is_fp32 = 0) or fp32 (is_fp32 = 1);
// lin (q, h, taps) int32, coeff (q, h, taps) fp32, out (q, h, d) fp32, all
// contiguous; d a multiple of 8, taps one of 4, 8, ..., 32. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int msda_gather_launch(const void* value, const void* lin, const void* coeff,
                       void* out, int s, int h, int d, int q, int taps,
                       int is_fp32, void* stream) {
  if (d % 8 != 0 || s < 1 || h < 1 || q < 0 || taps < 4 || taps > 32 ||
      taps % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_threads = (long long)q * h * (d / 8);
  if (n_threads == 0) return (int)cudaSuccess;
  const long long blocks = (n_threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_fp32)
    return launch_typed(static_cast<const float*>(value),
                        static_cast<const int*>(lin),
                        static_cast<const float*>(coeff),
                        static_cast<float*>(out), s, h, d, n_threads, taps,
                        (unsigned)blocks, st);
  return launch_typed(static_cast<const __nv_bfloat16*>(value),
                      static_cast<const int*>(lin),
                      static_cast<const float*>(coeff),
                      static_cast<float*>(out), s, h, d, n_threads, taps,
                      (unsigned)blocks, st);
}

}  // extern "C"
