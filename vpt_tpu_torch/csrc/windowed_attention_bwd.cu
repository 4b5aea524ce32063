// Windowed attention backward for Hopper (sm_90a), f32 and bf16: kernel B2.
//
// Replaces the Pallas TPU kernel `_attn_bwd_kernel`, launched by
// `_fused_backward` in vpt_tpu/ops/pallas_attention_impl.py, together with
// the two XLA einsums of `_bwd` that turn its dL output into the relative
// bias gradients.  Per (batch, head), with the forward's
//     L = alpha * Q K^T + sum_n R[.., n] * D[n] + maskbias,   W = softmax(L)
// (D[n, i, j] = b_nd[n, (T - t) + i - j] on the band, else 0; maskbias 0 or
// -1e9), it computes in f32 from f32 copies of q, k, v and dO:
//     dV = W^T dO,   dP = dO V^T,   rowdot_i = sum_j dP_ij W_ij,
//     dL = W * (dP - rowdot),   dQ = alpha dL K,   dK = alpha dL^T Q,
//     dR[i, n] = sum_j dL_ij D[n, i, j],
//     d b_nd[n, delta] = sum_{b, h, i, j: (T - t) + i - j = delta} dL_ij R[i, n].
// W stays f32 for dV (the JAX backward does not round it to bf16 the way the
// forward does); dq, dk, dv round to the input dtype once, at the end.
//
// What bounds it on this card: at the 2x chunk shape (B=4, H=16, t=128,
// T=256, d=128) the five t x T x d products are ~2.7 GFLOP against ~50 MB of
// f32 inputs and outputs, so in f32 without tensor cores it is bound by its
// operations.  The design keeps every (B, H, t, T) tensor and the (n, t, T)
// band table out of device memory:
//   * pass 1, one block per (b, h, 32 query rows) as in B1: recompute the
//     32 x T logits into shared memory, softmax them in place (keeping each
//     row's max and sum), stream V twice (rowdot, then dL in place), stream
//     K for dQ; dR is row-local and reduced from dL and the band table in
//     shared memory; each block writes its partial sums of d b_nd, indexed
//     by band offset, to a (blocks, n, bandsize) f32 scratch;
//   * pass 2, one block per (b, h, 32 keys): dK and dV sum over every query
//     row, and a whole (T, d) f32 pair does not fit one block's shared memory
//     at d = 192, so each block keeps its 32 keys' K and V tiles and streams
//     32-row tiles of Q and dO, rebuilding W_ij = exp(L_ij - max_i) / sum_i
//     and dL_ij from pass 1's row statistics;
//   * pass 3 sums the d b_nd partials in block order, so the result does not
//     depend on the order in which blocks ran.
// A fully masked row has uniform W, exactly as in the forward: the row max
// and sum are stored as they are (not as a log-sum-exp, which would lose the
// row's offsets next to -1e9 in f32).
// No tensor cores yet (no wgmma, no TMA): that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 32;          // query rows per tile
constexpr int KT = 32;          // keys per tile (one per lane)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = QT / NWARPS;  // query rows per warp when lanes own keys
constexpr int KEYS = KT / NWARPS;  // keys per warp when lanes own columns
constexpr int KTP = KT + 1;        // padded row stride of the W and dL tiles
constexpr int MAX_NBASIS = 16;
constexpr int MAX_KEYS = 512;
constexpr float NEG_BIAS = -1e9f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ __forceinline__ size_t band_floats(int nbasis, int bandsize) { return ((size_t)nbasis * bandsize + 3) / 4 * 4; }

size_t rows_smem_bytes(int d, int T, int nbasis, int bandsize) {
  size_t dp = d + 4;
  return (2 * QT * dp + KT * dp + QT * MAX_NBASIS + band_floats(nbasis, bandsize) + (size_t)QT * T) *
         sizeof(float);
}

size_t keys_smem_bytes(int d, int nbasis, int bandsize) {
  size_t dp = d + 4;
  return (2 * KT * dp + 2 * QT * dp + QT * MAX_NBASIS + band_floats(nbasis, bandsize) + 2 * QT * KTP +
          3 * QT) *
         sizeof(float);
}

// rows (r0 .. r0 + n) of a (rows, D) tensor into a (n, DP) f32 tile; zero past `limit`
template <typename scalar_t, int D>
__device__ __forceinline__ void load_tile(float* dst, const scalar_t* src, int r0, int limit, int tid) {
  constexpr int DP = D + 4;
  for (int idx = tid; idx < 32 * D; idx += NTHREADS) {
    int r = idx / D, c = idx % D;
    dst[r * DP + c] = (r0 + r < limit) ? load_f32(src + (size_t)(r0 + r) * D + c) : 0.f;
  }
}

// the dot products of this warp's ROWS rows of `a` with row `lane` of `b`,
// in the same order as the forward kernel's logits
template <int D>
__device__ __forceinline__ void row_dots(float (&acc)[ROWS], const float* a, const float* b, int warp,
                                         int lane) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) acc[rr] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 bb = *reinterpret_cast<const float4*>(b + lane * DP + c);
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      float4 aa = *reinterpret_cast<const float4*>(a + (warp * ROWS + rr) * DP + c);
      acc[rr] = fmaf(aa.x, bb.x, acc[rr]);
      acc[rr] = fmaf(aa.y, bb.y, acc[rr]);
      acc[rr] = fmaf(aa.z, bb.z, acc[rr]);
      acc[rr] = fmaf(aa.w, bb.w, acc[rr]);
    }
  }
}

// logit of query row gi (tile row i) and key j from alpha * q.k
__device__ __forceinline__ float logit(float qk, float alpha, bool has_rel, const float* sR, const float* sB,
                                       int i, int gi, int j, int t, int T, int nbasis, int bandsize,
                                       const uint8_t* mask, int b) {
  float l = qk * alpha;
  if (has_rel) {
    const int dd = (T - t) + gi - j;
    if (dd >= 0 && dd < bandsize) {
      for (int n = 0; n < nbasis; ++n) l += sR[i * MAX_NBASIS + n] * sB[n * bandsize + dd];
    }
  }
  if (mask != nullptr && gi < t) l += mask[((size_t)b * t + gi) * T + j] ? 0.f : NEG_BIAS;
  return l;
}

// pass 1: one block per (b, h, QT query rows)
template <typename scalar_t, int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_rows_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
                const scalar_t* __restrict__ v, const scalar_t* __restrict__ dout,
                const float* __restrict__ R, const float* __restrict__ b_nd,
                const uint8_t* __restrict__ mask, scalar_t* __restrict__ dq, float* __restrict__ dR,
                float* __restrict__ stats, float* __restrict__ partial, int BHt, int H, int t, int T,
                int nbasis, int bandsize, float alpha) {
  constexpr int DP = D + 4;
  constexpr int DCOLS = D / 32;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // QT x DP
  float* sdO = sQ + QT * DP;                    // QT x DP
  float* sKV = sdO + QT * DP;                   // KT x DP: K, V, V, then K tiles
  float* sR = sKV + KT * DP;                    // QT x MAX_NBASIS
  float* sB = sR + QT * MAX_NBASIS;             // nbasis x bandsize
  float* sS = sB + band_floats(nbasis, bandsize);  // QT x T: logits, then W, then dL

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * QT;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool has_rel = R != nullptr;
  const scalar_t* kb = k + (size_t)bh * T * D;
  const scalar_t* vb = v + (size_t)bh * T * D;

  load_tile<scalar_t, D>(sQ, q + (size_t)bh * t * D, q0, t, tid);
  load_tile<scalar_t, D>(sdO, dout + (size_t)bh * t * D, q0, t, tid);
  if (has_rel) {
    for (int idx = tid; idx < QT * nbasis; idx += NTHREADS) {
      int r = idx / nbasis, n = idx % nbasis;
      sR[r * MAX_NBASIS + n] = (q0 + r < t) ? R[((size_t)bh * t + q0 + r) * nbasis + n] : 0.f;
    }
    for (int idx = tid; idx < nbasis * bandsize; idx += NTHREADS) sB[idx] = b_nd[idx];
  }

  // 1. logits of this warp's rows against every key, one key per lane
  float acc[ROWS];
  for (int kt0 = 0; kt0 < T; kt0 += KT) {
    __syncthreads();
    load_tile<scalar_t, D>(sKV, kb, kt0, T, tid);
    __syncthreads();
    row_dots<D>(acc, sQ, sKV, warp, lane);
    const int j = kt0 + lane;
    if (j < T) {
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const int i = warp * ROWS + rr;
        sS[i * T + j] = logit(acc[rr], alpha, has_rel, sR, sB, i, q0 + i, j, t, T, nbasis, bandsize, mask, b);
      }
    }
  }

  // 2. softmax of each of this warp's rows in place, keeping max and sum
  __syncwarp();
  float rmax[ROWS], rsum[ROWS];
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
    for (int j = lane; j < T; j += 32) row[j] = row[j] / s;
    rmax[rr] = m;
    rsum[rr] = s;
  }

  // 3. rowdot_i = sum_j (dO_i . V_j) W_ij
  float rdot[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) rdot[rr] = 0.f;
  for (int kt0 = 0; kt0 < T; kt0 += KT) {
    __syncthreads();
    load_tile<scalar_t, D>(sKV, vb, kt0, T, tid);
    __syncthreads();
    row_dots<D>(acc, sdO, sKV, warp, lane);
    const int j = kt0 + lane;
    if (j < T) {
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) rdot[rr] = fmaf(acc[rr], sS[(warp * ROWS + rr) * T + j], rdot[rr]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) rdot[rr] = warp_sum(rdot[rr]);

  // 4. dL = W * (dO V^T - rowdot), in place (padded rows have dO = 0: dL = 0)
  for (int kt0 = 0; kt0 < T; kt0 += KT) {
    __syncthreads();
    load_tile<scalar_t, D>(sKV, vb, kt0, T, tid);
    __syncthreads();
    row_dots<D>(acc, sdO, sKV, warp, lane);
    const int j = kt0 + lane;
    if (j < T) {
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        float* s = sS + (warp * ROWS + rr) * T + j;
        *s = *s * (acc[rr] - rdot[rr]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int gi = q0 + warp * ROWS + rr;
      if (gi < t) {
        const size_t r = (size_t)bh * t + gi;
        stats[r] = rmax[rr];
        stats[BHt + r] = rsum[rr];
        stats[2 * (size_t)BHt + r] = rdot[rr];
      }
    }
  }

  // 5. dQ = alpha dL K; lane owns columns lane + 32 m
  float o[ROWS][DCOLS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
    for (int m = 0; m < DCOLS; ++m) o[rr][m] = 0.f;
  for (int kt0 = 0; kt0 < T; kt0 += KT) {
    __syncthreads();
    load_tile<scalar_t, D>(sKV, kb, kt0, T, tid);
    __syncthreads();
    const int kmax = min(KT, T - kt0);
    for (int jj = 0; jj < kmax; ++jj) {
      float kk[DCOLS];
#pragma unroll
      for (int m = 0; m < DCOLS; ++m) kk[m] = sKV[jj * DP + lane + 32 * m];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float w = sS[(warp * ROWS + rr) * T + kt0 + jj];
#pragma unroll
        for (int m = 0; m < DCOLS; ++m) o[rr][m] = fmaf(w, kk[m], o[rr][m]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int gi = q0 + warp * ROWS + rr;
    if (gi < t) {
#pragma unroll
      for (int m = 0; m < DCOLS; ++m)
        store(dq + ((size_t)bh * t + gi) * D + lane + 32 * m, alpha * o[rr][m]);
    }
  }

  if (!has_rel) return;
  __syncthreads();  // every warp's dL rows are in sS

  // 6. dR[i, n] = sum_j dL_ij b_nd[n, (T - t) + i - j], row-local
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int i = warp * ROWS + rr;
    const int gi = q0 + i;
    if (gi >= t) continue;  // uniform across the warp
    for (int n = 0; n < nbasis; ++n) {
      float p = 0.f;
      for (int j = lane; j < T; j += 32) {
        const int dd = (T - t) + gi - j;
        if (dd >= 0 && dd < bandsize) p = fmaf(sS[i * T + j], sB[n * bandsize + dd], p);
      }
      p = warp_sum(p);
      if (lane == 0) dR[((size_t)bh * t + gi) * nbasis + n] = p;
    }
  }

  // 7. this block's partial d b_nd[n, dd] = sum_i dL[i, (T - t) + gi - dd] R[i, n]
  const int nb = nbasis * bandsize;
  float* P = partial + ((size_t)bh * gridDim.y + blockIdx.y) * nb;
  for (int idx = tid; idx < nb; idx += NTHREADS) {
    const int n = idx / bandsize, dd = idx % bandsize;
    float p = 0.f;
    for (int i = 0; i < QT && q0 + i < t; ++i) {
      const int j = (T - t) + q0 + i - dd;
      if (j >= 0 && j < T) p = fmaf(sS[i * T + j], sR[i * MAX_NBASIS + n], p);
    }
    P[idx] = p;
  }
}

// pass 2: one block per (b, h, KT keys)
template <typename scalar_t, int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_keys_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
                const scalar_t* __restrict__ v, const scalar_t* __restrict__ dout,
                const float* __restrict__ R, const float* __restrict__ b_nd,
                const uint8_t* __restrict__ mask, const float* __restrict__ stats,
                scalar_t* __restrict__ dk, scalar_t* __restrict__ dv, int BHt, int H, int t, int T,
                int nbasis, int bandsize, float alpha) {
  constexpr int DP = D + 4;
  constexpr int DCOLS = D / 32;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // KT x DP
  float* sV = sK + KT * DP;                     // KT x DP
  float* sQ = sV + KT * DP;                     // QT x DP
  float* sdO = sQ + QT * DP;                    // QT x DP
  float* sR = sdO + QT * DP;                    // QT x MAX_NBASIS
  float* sB = sR + QT * MAX_NBASIS;             // nbasis x bandsize
  float* sW = sB + band_floats(nbasis, bandsize);  // QT x KTP
  float* sdL = sW + QT * KTP;                   // QT x KTP
  float* sStat = sdL + QT * KTP;                // 3 x QT: row max, row sum, rowdot

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int k0 = blockIdx.y * KT;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool has_rel = R != nullptr;

  load_tile<scalar_t, D>(sK, k + (size_t)bh * T * D, k0, T, tid);
  load_tile<scalar_t, D>(sV, v + (size_t)bh * T * D, k0, T, tid);
  if (has_rel) {
    for (int idx = tid; idx < nbasis * bandsize; idx += NTHREADS) sB[idx] = b_nd[idx];
  }

  float gk[KEYS][DCOLS], gv[KEYS][DCOLS];
#pragma unroll
  for (int e = 0; e < KEYS; ++e)
#pragma unroll
    for (int m = 0; m < DCOLS; ++m) gk[e][m] = gv[e][m] = 0.f;

  const int j = k0 + lane;
  for (int q0 = 0; q0 < t; q0 += QT) {
    __syncthreads();
    load_tile<scalar_t, D>(sQ, q + (size_t)bh * t * D, q0, t, tid);
    load_tile<scalar_t, D>(sdO, dout + (size_t)bh * t * D, q0, t, tid);
    if (has_rel) {
      for (int idx = tid; idx < QT * nbasis; idx += NTHREADS) {
        int r = idx / nbasis, n = idx % nbasis;
        sR[r * MAX_NBASIS + n] = (q0 + r < t) ? R[((size_t)bh * t + q0 + r) * nbasis + n] : 0.f;
      }
    }
    for (int idx = tid; idx < 3 * QT; idx += NTHREADS) {
      int s = idx / QT, r = idx % QT;
      sStat[idx] = (q0 + r < t) ? stats[(size_t)s * BHt + (size_t)bh * t + q0 + r] : 0.f;
    }
    __syncthreads();

    // W and dL of this warp's rows against key `lane` of the tile
    float accS[ROWS], accP[ROWS];
    row_dots<D>(accS, sQ, sK, warp, lane);
    row_dots<D>(accP, sdO, sV, warp, lane);
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int i = warp * ROWS + rr;
      const int gi = q0 + i;
      float w = 0.f, dl = 0.f;
      if (gi < t && j < T) {
        const float l = logit(accS[rr], alpha, has_rel, sR, sB, i, gi, j, t, T, nbasis, bandsize, mask, b);
        w = expf(l - sStat[i]) / sStat[QT + i];
        dl = w * (accP[rr] - sStat[2 * QT + i]);
      }
      sW[i * KTP + lane] = w;
      sdL[i * KTP + lane] = dl;
    }
    __syncthreads();

    // dV_j += W_ij dO_i, dK_j += dL_ij Q_i; warp owns keys warp*KEYS + e, lane owns columns
    const int imax = min(QT, t - q0);
    for (int i = 0; i < imax; ++i) {
      float qq[DCOLS], gg[DCOLS];
#pragma unroll
      for (int m = 0; m < DCOLS; ++m) {
        qq[m] = sQ[i * DP + lane + 32 * m];
        gg[m] = sdO[i * DP + lane + 32 * m];
      }
#pragma unroll
      for (int e = 0; e < KEYS; ++e) {
        const float w = sW[i * KTP + warp * KEYS + e];
        const float dl = sdL[i * KTP + warp * KEYS + e];
#pragma unroll
        for (int m = 0; m < DCOLS; ++m) {
          gv[e][m] = fmaf(w, gg[m], gv[e][m]);
          gk[e][m] = fmaf(dl, qq[m], gk[e][m]);
        }
      }
    }
  }

#pragma unroll
  for (int e = 0; e < KEYS; ++e) {
    const int jj = k0 + warp * KEYS + e;
    if (jj < T) {
      const size_t off = ((size_t)bh * T + jj) * D;
#pragma unroll
      for (int m = 0; m < DCOLS; ++m) {
        store(dv + off + lane + 32 * m, gv[e][m]);
        store(dk + off + lane + 32 * m, alpha * gk[e][m]);
      }
    }
  }
}

// pass 3: d b_nd = sum of the per-block partials, in block order
__global__ void db_reduce_kernel(const float* __restrict__ partial, float* __restrict__ db, int nblocks,
                                 int size) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= size) return;
  float s = 0.f;
  for (int blk = 0; blk < nblocks; ++blk) s += partial[(size_t)blk * size + idx];
  db[idx] = s;
}

template <typename scalar_t, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* R,
           const float* b_nd, const uint8_t* mask, void* dq, void* dk, void* dv, float* dR, float* db,
           float* stats, float* partial, int B, int H, int t, int T, int nbasis, int bandsize,
           float alpha, cudaStream_t stream) {
  auto rows = bwd_rows_kernel<scalar_t, D>;
  auto keys = bwd_keys_kernel<scalar_t, D>;
  const size_t rows_smem = rows_smem_bytes(D, T, nbasis, bandsize);
  const size_t keys_smem = keys_smem_bytes(D, nbasis, bandsize);
  cudaError_t err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)keys_smem);
  if (err != cudaSuccess) return (int)err;
  const int BHt = B * H * t;
  const auto* qs = static_cast<const scalar_t*>(q);
  const auto* ks = static_cast<const scalar_t*>(k);
  const auto* vs = static_cast<const scalar_t*>(v);
  const auto* ds = static_cast<const scalar_t*>(dout);
  dim3 rows_grid(B * H, (t + QT - 1) / QT);
  rows<<<rows_grid, NTHREADS, rows_smem, stream>>>(qs, ks, vs, ds, R, b_nd, mask, static_cast<scalar_t*>(dq),
                                                   dR, stats, partial, BHt, H, t, T, nbasis, bandsize, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 keys_grid(B * H, (T + KT - 1) / KT);
  keys<<<keys_grid, NTHREADS, keys_smem, stream>>>(qs, ks, vs, ds, R, b_nd, mask, stats,
                                                   static_cast<scalar_t*>(dk), static_cast<scalar_t*>(dv),
                                                   BHt, H, t, T, nbasis, bandsize, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess || R == nullptr) return (int)err;
  const int size = nbasis * bandsize;
  db_reduce_kernel<<<(size + NTHREADS - 1) / NTHREADS, NTHREADS, 0, stream>>>(
      partial, db, (int)(rows_grid.x * rows_grid.y), size);
  return (int)cudaGetLastError();
}

template <typename scalar_t>
int dispatch_d(const void* q, const void* k, const void* v, const void* dout, const float* R,
               const float* b_nd, const uint8_t* mask, void* dq, void* dk, void* dv, float* dR, float* db,
               float* stats, float* partial, int B, int H, int t, int T, int d, int nbasis, int bandsize,
               float alpha, cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<scalar_t, 64>(q, k, v, dout, R, b_nd, mask, dq, dk, dv, dR, db, stats, partial, B, H, t, T,
                                  nbasis, bandsize, alpha, s);
    case 128:
      return launch<scalar_t, 128>(q, k, v, dout, R, b_nd, mask, dq, dk, dv, dR, db, stats, partial, B, H, t,
                                   T, nbasis, bandsize, alpha, s);
    case 192:
      return launch<scalar_t, 192>(q, k, v, dout, R, b_nd, mask, dq, dk, dv, dR, db, stats, partial, B, H, t,
                                   T, nbasis, bandsize, alpha, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q and dout (B, H, t, d), k and v (B, H, T, d): contiguous, all f32
// (is_bf16 = 0) or all bf16 (is_bf16 = 1).  R (B, H, t, nbasis) f32 and b_nd
// (nbasis, bandsize) f32, both null for no relative bias.  mask (B, t, T)
// bool bytes, null for no mask.  Outputs dq (B, H, t, d), dk and dv
// (B, H, T, d) in the input dtype; dR (B, H, t, nbasis) and db_nd
// (nbasis, bandsize) f32 (unused without R).  Scratch: stats 3 * B * H * t
// f32, partial B * H * ceil(t / 32) * nbasis * bandsize f32 (unused without
// R).  Returns a cudaError_t (0 = launched).
extern "C" int vpt_windowed_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                          const float* R, const float* b_nd, const uint8_t* mask, void* dq,
                                          void* dk, void* dv, float* dR, float* db_nd, float* stats,
                                          float* partial, int B, int H, int t, int T, int d, int nbasis,
                                          int bandsize, int is_bf16, float alpha, void* stream) {
  if (B < 1 || H < 1 || t < 1 || T < 1 || T > MAX_KEYS) return (int)cudaErrorInvalidValue;
  if ((R == nullptr) != (b_nd == nullptr)) return (int)cudaErrorInvalidValue;
  if (R != nullptr && (nbasis < 1 || nbasis > MAX_NBASIS || bandsize < 1 || bandsize > MAX_KEYS ||
                       dR == nullptr || db_nd == nullptr || partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (R == nullptr) nbasis = bandsize = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k, v, dout, R, b_nd, mask, dq, dk, dv, dR, db_nd, stats, partial, B, H,
                                     t, T, d, nbasis, bandsize, alpha, s);
  return dispatch_d<float>(q, k, v, dout, R, b_nd, mask, dq, dk, dv, dR, db_nd, stats, partial, B, H, t, T, d,
                           nbasis, bandsize, alpha, s);
}

extern "C" const char* vpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
