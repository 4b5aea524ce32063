// Windowed attention forward for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel `_attn_kernel`, launched by
// `_fused_forward` in vpt_tpu/ops/pallas_attention_impl.py.  Per (batch, head)
// it computes
//     O = softmax(alpha * Q K^T + sum_n R[.., n] * D[n] + maskbias) * V
// with f32 logits and softmax, D[n, i, j] = b_nd[n, (T - t) + i - j] on the
// band 0 <= (T - t) + i - j < bandsize (else 0), maskbias = 0 or -1e9 from a
// (B, t, T) bool mask shared over heads, and W cast to V's dtype before W V
// (f32 accumulation).  Output in q's dtype.
//
// What bounds it on this card: at the 2x chunk shape (B=4, H=16, t=128,
// T=256, d=128) one call does ~1.07 GFLOP (QK^T and W V) against ~24 MB of
// f32 inputs and output, ~45 FLOP per byte.  Without tensor cores that is
// above the f32 ridge point (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/B), so the
// kernel is bound by its f32 operations and by the shared-memory reads that
// feed them; in bf16 the bytes halve and the tensor-core rate would make the
// same work bound by bytes.  The design:
//   * the TPU kernel keeps a whole (T, d) K and V per (b, h) in VMEM; here
//     one block owns (b, h, 32 query rows) and streams 32-key tiles of K, then
//     of V, through shared memory, so a block needs at most ~140 KB and
//     B*H*ceil(t/32) blocks spread over the 132 SMs;
//   * the logits of a query tile (32 x T floats) stay in shared memory
//     between the two passes (T <= 512), so no (B, H, t, T) tensor and no
//     (n, t, T) band table ever reaches device memory: the relative bias is
//     formed from b_nd and R inside the kernel;
//   * K rows are padded to d + 4 floats, so each lane's float4 read of its
//     own key row hits distinct banks, and each K element read from shared
//     memory feeds the four query rows its warp owns.
// No tensor cores yet (no wgmma, no TMA): that is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 32;          // query rows per block
constexpr int KT = 32;          // keys per shared-memory tile (one per lane)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = QT / NWARPS;  // query rows per warp
constexpr int MAX_NBASIS = 16;
constexpr int MAX_KEYS = 512;
constexpr float NEG_BIAS = -1e9f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// the softmax weights take V's dtype before W V, as in the reference
__device__ __forceinline__ float as_value_dtype(float x, const float*) { return x; }
__device__ __forceinline__ float as_value_dtype(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int d, int T, int nbasis, int bandsize) {
  size_t dp = d + 4;
  size_t band = ((size_t)nbasis * bandsize + 3) / 4 * 4;
  return (QT * dp + KT * dp + QT * MAX_NBASIS + band + (size_t)QT * T) * sizeof(float);
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(NTHREADS)
windowed_attention_fwd_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
                              const scalar_t* __restrict__ v, const float* __restrict__ R,
                              const float* __restrict__ b_nd, const uint8_t* __restrict__ mask,
                              scalar_t* __restrict__ out, int H, int t, int T, int nbasis,
                              int bandsize, float alpha) {
  constexpr int DP = D + 4;  // padded row stride
  constexpr int DCOLS = D / 32;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // QT x DP
  float* sKV = sQ + QT * DP;                    // KT x DP, K tiles then V tiles
  float* sR = sKV + KT * DP;                    // QT x MAX_NBASIS
  float* sB = sR + QT * MAX_NBASIS;             // nbasis x bandsize
  float* sS = sB + (nbasis * bandsize + 3) / 4 * 4;  // QT x T logits, then weights

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * QT;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool has_rel = R != nullptr;
  const bool has_mask = mask != nullptr;

  const size_t q_off = ((size_t)bh * t + q0) * D;
  const size_t kv_off = (size_t)bh * T * D;

  for (int idx = tid; idx < QT * D; idx += NTHREADS) {
    int r = idx / D, c = idx % D;
    sQ[r * DP + c] = (q0 + r < t) ? load_f32(q + q_off + (size_t)r * D + c) : 0.f;
  }
  if (has_rel) {
    for (int idx = tid; idx < QT * nbasis; idx += NTHREADS) {
      int r = idx / nbasis, n = idx % nbasis;
      sR[r * MAX_NBASIS + n] = (q0 + r < t) ? R[((size_t)bh * t + q0 + r) * nbasis + n] : 0.f;
    }
    for (int idx = tid; idx < nbasis * bandsize; idx += NTHREADS) sB[idx] = b_nd[idx];
  }

  // pass 1: logits of this warp's ROWS query rows against every key, one key per lane
  for (int kt0 = 0; kt0 < T; kt0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < KT * D; idx += NTHREADS) {
      int r = idx / D, c = idx % D;
      sKV[r * DP + c] = (kt0 + r < T) ? load_f32(k + kv_off + (size_t)(kt0 + r) * D + c) : 0.f;
    }
    __syncthreads();
    float acc[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) acc[rr] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 kk = *reinterpret_cast<const float4*>(sKV + lane * DP + c);
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        float4 qq = *reinterpret_cast<const float4*>(sQ + (warp * ROWS + rr) * DP + c);
        acc[rr] = fmaf(qq.x, kk.x, acc[rr]);
        acc[rr] = fmaf(qq.y, kk.y, acc[rr]);
        acc[rr] = fmaf(qq.z, kk.z, acc[rr]);
        acc[rr] = fmaf(qq.w, kk.w, acc[rr]);
      }
    }
    const int j = kt0 + lane;
    if (j < T) {
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const int i = warp * ROWS + rr;
        const int gi = q0 + i;
        float l = acc[rr] * alpha;
        if (has_rel) {
          const int dd = (T - t) + gi - j;
          if (dd >= 0 && dd < bandsize) {
            for (int n = 0; n < nbasis; ++n) l += sR[i * MAX_NBASIS + n] * sB[n * bandsize + dd];
          }
        }
        if (has_mask && gi < t) l += mask[((size_t)b * t + gi) * T + j] ? 0.f : NEG_BIAS;
        sS[i * T + j] = l;
      }
    }
  }

  // softmax over each of this warp's rows (the warp wrote them itself)
  __syncwarp();
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    float* row = sS + (warp * ROWS + rr) * T;
    float m = -3.402823466e38f;
    for (int j = lane; j < T; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < T; j += 32) {
      float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < T; j += 32) row[j] = as_value_dtype(row[j] / s, v);
  }

  // pass 2: O = W V, lane owns columns lane + 32 m
  float o[ROWS][DCOLS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
    for (int m = 0; m < DCOLS; ++m) o[rr][m] = 0.f;
  for (int kt0 = 0; kt0 < T; kt0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < KT * D; idx += NTHREADS) {
      int r = idx / D, c = idx % D;
      sKV[r * DP + c] = (kt0 + r < T) ? load_f32(v + kv_off + (size_t)(kt0 + r) * D + c) : 0.f;
    }
    __syncthreads();
    const int kmax = min(KT, T - kt0);
    for (int jj = 0; jj < kmax; ++jj) {
      float vv[DCOLS];
#pragma unroll
      for (int m = 0; m < DCOLS; ++m) vv[m] = sKV[jj * DP + lane + 32 * m];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float w = sS[(warp * ROWS + rr) * T + kt0 + jj];
#pragma unroll
        for (int m = 0; m < DCOLS; ++m) o[rr][m] = fmaf(w, vv[m], o[rr][m]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int i = warp * ROWS + rr;
    if (q0 + i < t) {
#pragma unroll
      for (int m = 0; m < DCOLS; ++m) store(out + q_off + (size_t)i * D + lane + 32 * m, o[rr][m]);
    }
  }
}

template <typename scalar_t, int D>
int launch(const void* q, const void* k, const void* v, const float* R, const float* b_nd,
           const uint8_t* mask, void* out, int B, int H, int t, int T, int nbasis, int bandsize,
           float alpha, cudaStream_t stream) {
  auto kernel = windowed_attention_fwd_kernel<scalar_t, D>;
  size_t smem = smem_bytes(D, T, nbasis, bandsize);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (t + QT - 1) / QT);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), R, b_nd, mask, static_cast<scalar_t*>(out), H, t, T,
      nbasis, bandsize, alpha);
  return (int)cudaGetLastError();
}

template <typename scalar_t>
int dispatch_d(const void* q, const void* k, const void* v, const float* R, const float* b_nd,
               const uint8_t* mask, void* out, int B, int H, int t, int T, int d, int nbasis,
               int bandsize, float alpha, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<scalar_t, 64>(q, k, v, R, b_nd, mask, out, B, H, t, T, nbasis, bandsize, alpha, stream);
    case 128:
      return launch<scalar_t, 128>(q, k, v, R, b_nd, mask, out, B, H, t, T, nbasis, bandsize, alpha, stream);
    case 192:
      return launch<scalar_t, 192>(q, k, v, R, b_nd, mask, out, B, H, t, T, nbasis, bandsize, alpha, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, t, d), k and v (B, H, T, d): contiguous, all f32 (is_bf16 = 0) or
// all bf16 (is_bf16 = 1).  R (B, H, t, nbasis) f32 and b_nd (nbasis, bandsize)
// f32, both null for no relative bias.  mask (B, t, T) bool bytes, null for no
// mask.  out (B, H, t, d) in q's dtype.  Returns a cudaError_t (0 = launched).
extern "C" int vpt_windowed_attention_fwd(const void* q, const void* k, const void* v,
                                          const float* R, const float* b_nd, const uint8_t* mask,
                                          void* out, int B, int H, int t, int T, int d,
                                          int nbasis, int bandsize, int is_bf16, float alpha,
                                          void* stream) {
  if (B < 1 || H < 1 || t < 1 || T < 1 || T > MAX_KEYS) return (int)cudaErrorInvalidValue;
  if ((R == nullptr) != (b_nd == nullptr)) return (int)cudaErrorInvalidValue;
  if (R != nullptr && (nbasis < 1 || nbasis > MAX_NBASIS || bandsize < 1 || bandsize > MAX_KEYS))
    return (int)cudaErrorInvalidValue;
  if (R == nullptr) nbasis = bandsize = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k, v, R, b_nd, mask, out, B, H, t, T, d, nbasis, bandsize, alpha, s);
  return dispatch_d<float>(q, k, v, R, b_nd, mask, out, B, H, t, T, d, nbasis, bandsize, alpha, s);
}

extern "C" const char* vpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
