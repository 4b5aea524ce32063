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
// T=256, d=128) the five t x T x d products are 2.68 GFLOP against 46.9 MB
// of f32 inputs and outputs.  At f32 accuracy on the tensor cores (three
// TF32 products at 495 TFLOP/s) the products need 16.3 us and the band's
// bias, dR and d b_nd (f32 contractions of the same kind, in both types)
// 0.4 us, against 14.0 us for the bytes: the least time, 16.7 us, is set by
// the operations in f32 and by the bytes in bf16.  In practice the products
// are the limit (dR and d b_nd still run on the CUDA cores), each
// fragment loaded and split (as in B1) by the warp that uses it, and the
// design takes eight products for the five (the logits once more, dO V^T
// twice more) to keep every (B, H, t, T) tensor out of device memory.
// The design:
//   * every product runs on tensor cores with mma.sync (attention_mma.cuh).
//     In f32 each product splits both operands into TF32 hi + lo parts and
//     takes three TF32 products.  In bf16, Q K^T and dO V^T are one bf16
//     product each; the products of an f32 operand (W or dL) with a bf16 one
//     (dO, K, Q) take two TF32 products, the bf16 side being exact in TF32.
//     The band bias R b_nd is a small TF32 product too, as in B1;
//   * pass 1, one block per (b, h, 64 query rows) with 16 warps, four to
//     each 16 rows (32 rows and 8 warps where shared memory demands): the
//     mask and band bias terms of the block's rows straight into a logit
//     tile in shared memory, alpha Q K^T added over 64-key tiles of K, the
//     softmax in place (keeping each row's max and sum), dO V^T over tiles of
//     V twice (rowdot from the fragments, then dL in place), dQ = dL K over
//     tiles of K; every tile streams through two shared buffers with
//     cp.async, the next in flight while the warps multiply the current one.
//     dR is row-local and reduced from dL and the band table in shared
//     memory (a warp to a row, every n at once), and each block writes its
//     partial sums of d b_nd, by band offset, to a (blocks, n, bandsize) f32
//     scratch;
//   * pass 2, one block per (b, h, 128 keys) with 8 warps, a warp per 16 keys
//     (64 keys and 4 warps where shared memory demands): dK and dV sum over
//     every query row, so each block keeps its keys' K and V tiles and
//     streams 32-row tiles of Q and dO, forming the tile's mask and band bias
//     terms while the copies fly.  K Q^T and V dO^T land in accumulator
//     fragments, W and dL are rebuilt there from pass 1's row statistics, and
//     the fragments feed dV += W^T dO and dK += dL^T Q as they stand
//     (mma_nn_step), so W and dL never leave registers.  At d = 192 the dK
//     and dV accumulators would not fit the registers, so the columns go in
//     two halves, each recomputing the tile's W and dL;
//   * pass 3 sums the d b_nd partials in block order, so the result is the
//     same, bit for bit, from run to run;
//   * past 512 keys, pass 1 walks the keys in chunks of 512 through the same
//     logit tile, recomputing each chunk's logits in three sweeps: the rows'
//     max and sum (an online softmax, as B1's), then rowdot, then dL with dQ
//     (accumulated across chunks in registers), dR and the d b_nd partials
//     (accumulated in place, each entry by the one thread that owns it).
//     Q and dO take turns in the one row tile.  Pass 2 already streams the
//     query rows over tiles of keys and reads pass 1's row statistics.  The
//     band table stays in shared memory whole: bandsize <= 512.
// A fully masked row has uniform W, exactly as in the forward: the row max
// and sum are stored as they are (not as a log-sum-exp, which would lose the
// row's offsets next to -1e9 in f32).  No (B, H, t, T) tensor and no (n, t, T)
// band table reaches device memory.

#include "attention_mma.cuh"

namespace {

using namespace wattn;

constexpr int QUERY_TILE = 32;  // pass 2: query rows per streamed tile
constexpr int BIAS_STRIDE = QUERY_TILE + 8;  // pass 2: row stride of the bias tile, 8 words mod 32
constexpr int REDUCE_THREADS = 256;

template <int D>
__host__ __device__ constexpr int key_pass_cols() {  // dK and dV columns a warp accumulates at once
  return D <= 128 ? D : D / 2;
}

// past KEY_CHUNK keys: a chunk's logit tile, and each row's running max and sum
template <typename T, int D>
size_t rows_smem_bytes(int rows, int T_keys, int nbasis, int bandsize) {
  const size_t tile = (size_t)tile_stride<T, D>() * sizeof(T);
  const size_t band = ((size_t)nbasis * bandsize + 3) / 4 * 4;
  const size_t running = T_keys > KEY_CHUNK ? 2 * rows : 0;
  const int keys = T_keys < KEY_CHUNK ? T_keys : KEY_CHUNK;
  return (rows + 2 * KEY_TILE) * tile + ((size_t)rows * logit_stride(keys) + rows * R_STRIDE +
                                         RowBlock<64>::SPLIT * rows + band + running) * sizeof(float);
}

template <typename T, int D>
size_t keys_smem_bytes(int nwarps, int nbasis, int bandsize) {
  const size_t keys = 16 * nwarps;
  const size_t tile = (size_t)tile_stride<T, D>() * sizeof(T);
  const size_t band = ((size_t)nbasis * bandsize + 3) / 4 * 4;
  return (2 * keys + 2 * QUERY_TILE) * tile +
         (keys * BIAS_STRIDE + QUERY_TILE * R_STRIDE + 3 * QUERY_TILE + band) * sizeof(float);
}

// pass 1: one block per (b, h, ROWS query rows)
template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(RowBlock<ROWS>::NTHREADS)
bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ R, const float* __restrict__ b_nd,
                const uint8_t* __restrict__ mask, T* __restrict__ dq, float* __restrict__ dR,
                float* __restrict__ stats, float* __restrict__ partial, int BHt, int H, int t, int T_keys,
                int nbasis, int bandsize, float alpha) {
  using Block = RowBlock<ROWS>;
  constexpr int NTHREADS = Block::NTHREADS;
  constexpr int SPLIT = Block::SPLIT;
  constexpr int DS = tile_stride<T, D>();
  constexpr int DH = D / SPLIT;         // dQ columns of a warp
  constexpr int KH = KEY_TILE / SPLIT;  // keys of a tile a warp takes
  const int TS = logit_stride(T_keys);
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);  // ROWS x DS: Q, then dO
  T* sKV = sQ + ROWS * DS;              // 2 x KEY_TILE x DS: K, V, V, then K tiles
  float* sS = reinterpret_cast<float*>(sKV + 2 * KEY_TILE * DS);  // ROWS x TS: logits, then W, then dL
  float* sR = sS + ROWS * TS;          // ROWS x R_STRIDE
  float* sRd = sR + ROWS * R_STRIDE;   // SPLIT x ROWS: each part's rowdot partial sums
  float* sB = sRd + SPLIT * ROWS;      // nbasis x bandsize

  const Block rb;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int g = rb.g, c = rb.c, row0 = rb.row0, lane = rb.lane;
  const T* kb = k + (size_t)bh * T_keys * D;
  const T* vb = v + (size_t)bh * T_keys * D;

  // R's rows and the band table, then Q, then K's first tile, each a group of
  // copies in flight while the mask terms load; the bias waits for the first only
  if (nbasis > 0)
    load_bias_inputs_async<NTHREADS>(sR, R + (size_t)bh * t * nbasis, q0, ROWS, t, nbasis, sB, b_nd, bandsize);
  cp_async_commit();
  load_rows_async<T, D>(sQ, DS, q + (size_t)bh * t * D, q0, ROWS, t, tid, NTHREADS);
  cp_async_commit();
  prefetch_tile<T, D, NTHREADS>(sKV, kb, T_keys, 0);
  mask_window<NTHREADS, true>(sS, TS, mask != nullptr ? mask + (size_t)b * t * T_keys : nullptr, q0, ROWS, t, 0,
                              TS - 8, T_keys);
  cp_async_wait<2>();
  __syncthreads();

  // 1. the logits and their softmax W in place, keeping each row's max and sum
  if (nbasis > 0) band_bias_mma<Block::NWARPS>(sS, TS, 1, sR, sB, q0, ROWS, t, T_keys, 0, T_keys, nbasis, bandsize);
  block_logits<T, D, ROWS>(sS, TS, sQ, sKV, kb, T_keys, alpha, true);
  softmax_rows<ROWS, false>(sS, TS, q0, t, stats + (size_t)bh * t, stats + BHt + (size_t)bh * t);

  // 2. dO replaces Q (every warp is past its last read of Q)
  load_rows_async<T, D>(sQ, DS, dout + (size_t)bh * t * D, q0, ROWS, t, tid, NTHREADS);
  cp_async_commit();

  // 3. rowdot_i = sum_j (dO V^T)_ij W_ij over the warp's part of each tile, W
  //    read at the fragment's own positions; then the parts' sums, in a fixed order
  float rd[2] = {0.f, 0.f};  // rows g and g + 8 of the warp
  stream_tiles<T, D, NTHREADS>(sKV, vb, T_keys, false, [&](int kt0, const T* tile) {
    float p[KH / 8][4] = {};
    mma_nt<T, D, KH / 8>(p, sQ + row0 * DS, DS, tile + rb.part * KH * DS, DS, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* wrow = sS + (row0 + g + 8 * h) * TS + kt0 + rb.part * KH + 2 * c;
#pragma unroll
      for (int n = 0; n < KH / 8; ++n) {
        const float2 w = *reinterpret_cast<const float2*>(wrow + n * 8);
        rd[h] = fmaf(p[n][2 * h], w.x, rd[h]);
        rd[h] = fmaf(p[n][2 * h + 1], w.y, rd[h]);
      }
    }
  });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rd[h] = quad_sum(rd[h]);
    if (c == 0) sRd[rb.part * ROWS + row0 + g + 8 * h] = rd[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + g + 8 * h;
    rd[h] = sRd[i];
#pragma unroll
    for (int p = 1; p < SPLIT; ++p) rd[h] += sRd[p * ROWS + i];
    if (rb.part == 0 && c == 0 && q0 + i < t) stats[2 * (size_t)BHt + (size_t)bh * t + q0 + i] = rd[h];
  }

  // 4. dL = W * (dO V^T - rowdot) in place (padding rows have dO = 0, padding keys W = 0: dL = 0)
  stream_tiles<T, D, NTHREADS>(sKV, vb, T_keys, false, [&](int kt0, const T* tile) {
    float p[KH / 8][4] = {};
    mma_nt<T, D, KH / 8>(p, sQ + row0 * DS, DS, tile + rb.part * KH * DS, DS, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* wrow = sS + (row0 + g + 8 * h) * TS + kt0 + rb.part * KH + 2 * c;
#pragma unroll
      for (int n = 0; n < KH / 8; ++n) {
        const float2 w = *reinterpret_cast<const float2*>(wrow + n * 8);
        store2(wrow + n * 8, w.x * (p[n][2 * h] - rd[h]), w.y * (p[n][2 * h + 1] - rd[h]));
      }
    }
  });

  // 5. dQ = alpha dL K over tiles of K, the warp's SPLIT-th of the columns
  float acc[DH / 8][4] = {};
  stream_tiles<T, D, NTHREADS>(sKV, kb, T_keys, false, [&](int kt0, const T* tile) {
    mma_nn_tile<T, DH>(acc, sS + row0 * TS + kt0, TS, tile + rb.part * DH, DS, lane);
  });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gi = q0 + row0 + g + 8 * h;
    if (gi < t) {
      T* row = dq + ((size_t)bh * t + gi) * D + rb.part * DH + 2 * c;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) store2(row + n * 8, alpha * acc[n][2 * h], alpha * acc[n][2 * h + 1]);
    }
  }
  if (nbasis == 0) return;

  // 6. dR[i, n] = sum_j dL_ij b_nd[n, (T - t) + i - j] over the band, a warp
  //    to a row, every n at once
  for (int i = rb.warp; i < ROWS && q0 + i < t; i += Block::NWARPS) {
    const int off = (T_keys - t) + q0 + i;  // band offset of key 0
    const int jlo = max(0, off - bandsize + 1), jhi = min(T_keys - 1, off);
    float acc_n[MAX_NBASIS] = {};
    for (int j = jlo + lane; j <= jhi; j += 32) {
      const float dl = sS[i * TS + j];
#pragma unroll
      for (int n = 0; n < MAX_NBASIS; ++n) {
        if (n < nbasis) acc_n[n] += dl * sB[n * bandsize + off - j];  // uniform condition
      }
    }
    const float x = warp_sum16(acc_n, lane);  // lanes 2n and 2n + 1: the sum for n
    if (lane % 2 == 0 && lane / 2 < nbasis) dR[((size_t)bh * t + q0 + i) * nbasis + lane / 2] = x;
  }

  // 7. this block's partial d b_nd[n, dd] = sum_i dL[i, (T - t) + gi - dd] R[i, n]
  const int nb = nbasis * bandsize;
  float* P = partial + ((size_t)bh * gridDim.y + blockIdx.y) * nb;
  const int nrows = min(ROWS, t - q0);
  for (int idx = tid; idx < nb; idx += NTHREADS) {
    const int n = idx / bandsize, dd = idx % bandsize;
    float s[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, summed in a fixed order
#pragma unroll 4
    for (int i = 0; i < nrows; ++i) {
      const int j = (T_keys - t) + q0 + i - dd;
      if (j >= 0 && j < T_keys) s[i & 3] = fmaf(sS[i * TS + j], sR[i * R_STRIDE + n], s[i & 3]);
    }
    P[idx] = (s[0] + s[1]) + (s[2] + s[3]);
  }
}

// pass 1 for T > KEY_CHUNK keys: three sweeps over chunks of KEY_CHUNK keys,
// each chunk's logits recomputed in every sweep
template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(RowBlock<ROWS>::NTHREADS)
bwd_rows_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ R, const float* __restrict__ b_nd,
                        const uint8_t* __restrict__ mask, T* __restrict__ dq, float* __restrict__ dR,
                        float* __restrict__ stats, float* __restrict__ partial, int BHt, int H, int t, int T_keys,
                        int nbasis, int bandsize, float alpha) {
  using Block = RowBlock<ROWS>;
  constexpr int NTHREADS = Block::NTHREADS;
  constexpr int SPLIT = Block::SPLIT;
  constexpr int DS = tile_stride<T, D>();
  constexpr int DH = D / SPLIT;         // dQ columns of a warp
  constexpr int KH = KEY_TILE / SPLIT;  // keys of a tile a warp takes
  const int TS = logit_stride(KEY_CHUNK);
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);  // ROWS x DS: Q or dO
  T* sKV = sQ + ROWS * DS;              // 2 x KEY_TILE x DS: K and V tiles
  float* sS = reinterpret_cast<float*>(sKV + 2 * KEY_TILE * DS);  // ROWS x TS: a chunk's logits, then W, then dL
  float* sR = sS + ROWS * TS;          // ROWS x R_STRIDE
  float* sRd = sR + ROWS * R_STRIDE;   // SPLIT x ROWS: each part's rowdot partial sums
  float* sB = sRd + SPLIT * ROWS;      // nbasis x bandsize
  float* sM = sB + ((size_t)nbasis * bandsize + 3) / 4 * 4;  // ROWS: running max, then the max
  float* sL = sM + ROWS;                                      // ROWS: running sum, then the sum

  const Block rb;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int g = rb.g, c = rb.c, row0 = rb.row0, lane = rb.lane;
  const T* qb = q + (size_t)bh * t * D;
  const T* ob = dout + (size_t)bh * t * D;
  const T* kb = k + (size_t)bh * T_keys * D;
  const T* vb = v + (size_t)bh * T_keys * D;
  const uint8_t* mask_b = mask != nullptr ? mask + (size_t)b * t * T_keys : nullptr;

  // the first chunk's inputs as in bwd_rows_kernel
  if (nbasis > 0)
    load_bias_inputs_async<NTHREADS>(sR, R + (size_t)bh * t * nbasis, q0, ROWS, t, nbasis, sB, b_nd, bandsize);
  cp_async_commit();
  load_rows_async<T, D>(sQ, DS, qb, q0, ROWS, t, tid, NTHREADS);
  cp_async_commit();
  prefetch_tile<T, D, NTHREADS>(sKV, kb, KEY_CHUNK, 0);
  mask_window<NTHREADS, true>(sS, TS, mask_b, q0, ROWS, t, 0, KEY_CHUNK, T_keys);
  for (int i = tid; i < ROWS; i += NTHREADS) {
    sM[i] = -CUDART_INF_F;
    sL[i] = 0.f;
  }
  cp_async_wait<2>();
  __syncthreads();

  // The logits of chunk [c0, c0 + nc) into sS.  Unless `ready` (the first
  // chunk, whose inputs are in), every warp must be past its last read of sS
  // and the chunk's mask terms and first K tile are fetched here; Q must be
  // in sQ or in flight, committed before this call.
  auto chunk_logits = [&](int c0, int nc, bool ready) {
    if (!ready) {
      prefetch_tile<T, D, NTHREADS>(sKV, kb + (size_t)c0 * D, nc, 0);
      mask_window<NTHREADS, true>(sS, TS, mask_b, q0, ROWS, t, c0, KEY_CHUNK, T_keys);
      __syncthreads();
    }
    if (nbasis > 0) band_bias_mma<Block::NWARPS>(sS, TS, 1, sR, sB, q0, ROWS, t, T_keys, c0, nc, nbasis, bandsize);
    block_logits<T, D, ROWS>(sS, TS, sQ, sKV, kb + (size_t)c0 * D, nc, alpha, true);
  };
  // Q or dO into the row tile, once every warp is past its last read of it
  auto load_rows = [&](const T* src) {
    load_rows_async<T, D>(sQ, DS, src, q0, ROWS, t, tid, NTHREADS);
    cp_async_commit();
  };

  // 1. each row's max and sum over all the keys
  for (int c0 = 0; c0 < T_keys; c0 += KEY_CHUNK) {
    if (c0 > 0) __syncthreads();  // the previous chunk's softmax has read sS
    chunk_logits(c0, min(KEY_CHUNK, T_keys - c0), c0 == 0);
    softmax_rows_online<ROWS, false>(sS, TS, sM, sL, nullptr);
  }
  __syncthreads();
  for (int i = tid; i < ROWS; i += NTHREADS) {
    if (q0 + i < t) {
      stats[(size_t)bh * t + q0 + i] = sM[i];
      stats[BHt + (size_t)bh * t + q0 + i] = sL[i];
    }
  }

  // 2. rowdot_i = sum_j (dO V^T)_ij W_ij, chunk by chunk, as bwd_rows_kernel's step 3
  float rd[2] = {0.f, 0.f};  // rows g and g + 8 of the warp
  for (int c0 = 0; c0 < T_keys; c0 += KEY_CHUNK) {
    const int nc = min(KEY_CHUNK, T_keys - c0);
    __syncthreads();  // every warp is past the previous chunk's reads of sS and sQ
    load_rows(qb);
    chunk_logits(c0, nc, false);
    normalize_rows<ROWS>(sS, TS, sM, sL);
    load_rows(ob);  // every warp is past its last read of Q (block_logits ends with a barrier)
    stream_tiles<T, D, NTHREADS>(sKV, vb + (size_t)c0 * D, nc, false, [&](int kt0, const T* tile) {
      float p[KH / 8][4] = {};
      mma_nt<T, D, KH / 8>(p, sQ + row0 * DS, DS, tile + rb.part * KH * DS, DS, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* wrow = sS + (row0 + g + 8 * h) * TS + kt0 + rb.part * KH + 2 * c;
#pragma unroll
        for (int n = 0; n < KH / 8; ++n) {
          const float2 w = *reinterpret_cast<const float2*>(wrow + n * 8);
          rd[h] = fmaf(p[n][2 * h], w.x, rd[h]);
          rd[h] = fmaf(p[n][2 * h + 1], w.y, rd[h]);
        }
      }
    });
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rd[h] = quad_sum(rd[h]);
    if (c == 0) sRd[rb.part * ROWS + row0 + g + 8 * h] = rd[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + g + 8 * h;
    rd[h] = sRd[i];
#pragma unroll
    for (int p = 1; p < SPLIT; ++p) rd[h] += sRd[p * ROWS + i];
    if (rb.part == 0 && c == 0 && q0 + i < t) stats[2 * (size_t)BHt + (size_t)bh * t + q0 + i] = rd[h];
  }

  // 3. chunk by chunk: dL in place, dQ += alpha dL K, dR and the d b_nd partials
  float acc[DH / 8][4] = {};
  const int nb = nbasis * bandsize;
  float* P = partial + ((size_t)bh * gridDim.y + blockIdx.y) * nb;
  const int nrows = min(ROWS, t - q0);
  for (int c0 = 0; c0 < T_keys; c0 += KEY_CHUNK) {
    const int nc = min(KEY_CHUNK, T_keys - c0);
    __syncthreads();  // every warp is past the previous chunk's reads of sS and sQ
    load_rows(qb);
    chunk_logits(c0, nc, false);
    normalize_rows<ROWS>(sS, TS, sM, sL);
    load_rows(ob);
    stream_tiles<T, D, NTHREADS>(sKV, vb + (size_t)c0 * D, nc, false, [&](int kt0, const T* tile) {
      float p[KH / 8][4] = {};
      mma_nt<T, D, KH / 8>(p, sQ + row0 * DS, DS, tile + rb.part * KH * DS, DS, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* wrow = sS + (row0 + g + 8 * h) * TS + kt0 + rb.part * KH + 2 * c;
#pragma unroll
        for (int n = 0; n < KH / 8; ++n) {
          const float2 w = *reinterpret_cast<const float2*>(wrow + n * 8);
          store2(wrow + n * 8, w.x * (p[n][2 * h] - rd[h]), w.y * (p[n][2 * h + 1] - rd[h]));
        }
      }
    });
    stream_tiles<T, D, NTHREADS>(sKV, kb + (size_t)c0 * D, nc, false, [&](int kt0, const T* tile) {
      mma_nn_tile<T, DH>(acc, sS + row0 * TS + kt0, TS, tile + rb.part * DH, DS, lane);
    });
    if (nbasis == 0) continue;

    // dR[i, n] += sum over the chunk's keys j on the band of dL_ij b_nd[n, (T - t) + i - j]
    for (int i = rb.warp; i < ROWS && q0 + i < t; i += Block::NWARPS) {
      const int off = (T_keys - t) + q0 + i;  // band offset of key 0
      const int jlo = max(c0, off - bandsize + 1), jhi = min(c0 + nc - 1, off);
      float acc_n[MAX_NBASIS] = {};
      for (int j = jlo + lane; j <= jhi; j += 32) {
        const float dl = sS[i * TS + j - c0];
#pragma unroll
        for (int n = 0; n < MAX_NBASIS; ++n) {
          if (n < nbasis) acc_n[n] += dl * sB[n * bandsize + off - j];  // uniform condition
        }
      }
      const float x = warp_sum16(acc_n, lane);  // lanes 2n and 2n + 1: the sum for n
      if (lane % 2 == 0 && lane / 2 < nbasis) {
        float* dst = dR + ((size_t)bh * t + q0 + i) * nbasis + lane / 2;
        *dst = (c0 == 0 ? 0.f : *dst) + x;
      }
    }
    // this block's partial d b_nd[n, dd] += sum_i dL[i, (T - t) + gi - dd] R[i, n] over the chunk's keys
    for (int idx = tid; idx < nb; idx += NTHREADS) {
      const int n = idx / bandsize, dd = idx % bandsize;
      float s[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, summed in a fixed order
#pragma unroll 4
      for (int i = 0; i < nrows; ++i) {
        const int j = (T_keys - t) + q0 + i - dd;
        if (j >= c0 && j < c0 + nc) s[i & 3] = fmaf(sS[i * TS + j - c0], sR[i * R_STRIDE + n], s[i & 3]);
      }
      P[idx] = (c0 == 0 ? 0.f : P[idx]) + ((s[0] + s[1]) + (s[2] + s[3]));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gi = q0 + row0 + g + 8 * h;
    if (gi < t) {
      T* row = dq + ((size_t)bh * t + gi) * D + rb.part * DH + 2 * c;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) store2(row + n * 8, alpha * acc[n][2 * h], alpha * acc[n][2 * h + 1]);
    }
  }
}

// pass 2: one block per (b, h, 16 * NWARPS keys), a warp per 16 keys
template <typename T, int D, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ R, const float* __restrict__ b_nd,
                const uint8_t* __restrict__ mask, const float* __restrict__ stats, T* __restrict__ dk,
                T* __restrict__ dv, int BHt, int H, int t, int T_keys, int nbasis, int bandsize, float alpha) {
  constexpr int KEYS = 16 * NWARPS;
  constexpr int NTHREADS = NWARPS * 32;
  constexpr int DS = tile_stride<T, D>();
  constexpr int DC = key_pass_cols<D>();
  constexpr int NQ = QUERY_TILE / 8;
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);  // KEYS x DS
  T* sV = sK + KEYS * DS;               // KEYS x DS
  T* sQ = sV + KEYS * DS;               // QUERY_TILE x DS
  T* sdO = sQ + QUERY_TILE * DS;        // QUERY_TILE x DS
  float* sBias = reinterpret_cast<float*>(sdO + QUERY_TILE * DS);  // KEYS x BIAS_STRIDE
  float* sR = sBias + KEYS * BIAS_STRIDE;                          // QUERY_TILE x R_STRIDE
  float* sStat = sR + QUERY_TILE * R_STRIDE;                       // 3 x QUERY_TILE: row max, 1 / row sum, rowdot
  float* sB = sStat + 3 * QUERY_TILE;                              // nbasis x bandsize

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int k0 = blockIdx.y * KEYS;
  const T* qb = q + (size_t)bh * t * D;
  const T* ob = dout + (size_t)bh * t * D;
  const uint8_t* mask_b = mask != nullptr ? mask + (size_t)b * t * T_keys : nullptr;

  load_rows_async<T, D>(sK, DS, k + (size_t)bh * T_keys * D, k0, KEYS, T_keys, tid, NTHREADS);
  load_rows_async<T, D>(sV, DS, v + (size_t)bh * T_keys * D, k0, KEYS, T_keys, tid, NTHREADS);
  cp_async_commit();

  for (int c0 = 0; c0 < D; c0 += DC) {
    float gk[DC / 8][4] = {}, gv[DC / 8][4] = {};
    for (int i0 = 0; i0 < t; i0 += QUERY_TILE) {
      __syncthreads();  // the previous query tile is no longer read
      // the tile's R rows (and at first the band table) as one group of
      // copies, its Q and dO rows as the next, so the band bias can start
      // while Q and dO fly
      if (nbasis > 0)
        load_bias_inputs_async<NTHREADS>(sR, R + (size_t)bh * t * nbasis, i0, QUERY_TILE, t, nbasis,
                                         c0 == 0 && i0 == 0 ? sB : nullptr, b_nd, bandsize);
      cp_async_commit();
      load_rows_async<T, D>(sQ, DS, qb, i0, QUERY_TILE, t, tid, NTHREADS);
      load_rows_async<T, D>(sdO, DS, ob, i0, QUERY_TILE, t, tid, NTHREADS);
      cp_async_commit();
      for (int idx = tid; idx < 3 * QUERY_TILE; idx += NTHREADS) {
        const int which = idx / QUERY_TILE, r = idx % QUERY_TILE;
        const float x = (i0 + r < t) ? stats[(size_t)which * BHt + (size_t)bh * t + i0 + r] : 1.f;
        sStat[idx] = which == 1 ? 1.f / x : x;  // the row sum as its reciprocal, as the forward uses it
      }
      mask_window<NTHREADS, false>(sBias, BIAS_STRIDE, mask_b, i0, QUERY_TILE, t, k0, KEYS, T_keys);
      cp_async_wait<1>();
      __syncthreads();

      // the band bias of the tile added while Q and dO fly
      if (nbasis > 0)
        band_bias_mma<NWARPS>(sBias, 1, BIAS_STRIDE, sR, sB, i0, QUERY_TILE, t, T_keys, k0, KEYS, nbasis, bandsize);
      cp_async_wait<0>();
      __syncthreads();

      // L^T and dP^T of the warp's 16 keys against the tile's rows, then W^T and dL^T in place
      float s[NQ][4] = {}, p[NQ][4] = {};
      mma_nt<T, D, NQ>(s, sK + warp * 16 * DS, DS, sQ, DS, lane);
      mma_nt<T, D, NQ>(p, sV + warp * 16 * DS, DS, sdO, DS, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jj = warp * 16 + g + 8 * h;
        const bool key = k0 + jj < T_keys;
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const int li = n * 8 + 2 * c;
          const float2 x = *reinterpret_cast<const float2*>(sBias + jj * BIAS_STRIDE + li);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float w = 0.f, dl = 0.f;
            if (key && i0 + li + e < t) {
              const float l = s[n][2 * h + e] * alpha + (e ? x.y : x.x);
              w = expf(l - sStat[li + e]) * sStat[QUERY_TILE + li + e];
              dl = w * (p[n][2 * h + e] - sStat[2 * QUERY_TILE + li + e]);
            }
            s[n][2 * h + e] = w;
            p[n][2 * h + e] = dl;
          }
        }
      }

      // dV += W^T dO and dK += dL^T Q over the tile's rows, from the fragments as they stand
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float aw[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
        mma_nn_step<T, DC>(gv, aw, sdO + (n * 8 + 2 * c) * DS + c0 + g, DS);
        const float al[4] = {p[n][0], p[n][2], p[n][1], p[n][3]};
        mma_nn_step<T, DC>(gk, al, sQ + (n * 8 + 2 * c) * DS + c0 + g, DS);
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = k0 + warp * 16 + g + 8 * h;
      if (j < T_keys) {
        const size_t off = ((size_t)bh * T_keys + j) * D + c0 + 2 * c;
#pragma unroll
        for (int n = 0; n < DC / 8; ++n) {
          store2(dv + off + n * 8, gv[n][2 * h], gv[n][2 * h + 1]);
          store2(dk + off + n * 8, alpha * gk[n][2 * h], alpha * gk[n][2 * h + 1]);
        }
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

template <typename T, int D, int ROWS>
int launch_rows(const T* q, const T* k, const T* v, const T* dout, const float* R, const float* b_nd,
                const uint8_t* mask, T* dq, float* dR, float* stats, float* partial, int B, int H, int t,
                int T_keys, int nbasis, int bandsize, float alpha, cudaStream_t stream, int* nblocks) {
  auto kernel = T_keys > KEY_CHUNK ? bwd_rows_chunked_kernel<T, D, ROWS> : bwd_rows_kernel<T, D, ROWS>;
  const size_t smem = rows_smem_bytes<T, D>(ROWS, T_keys, nbasis, bandsize);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (t + ROWS - 1) / ROWS);
  *nblocks = (int)(grid.x * grid.y);
  kernel<<<grid, RowBlock<ROWS>::NTHREADS, smem, stream>>>(q, k, v, dout, R, b_nd, mask, dq, dR, stats, partial,
                                                          B * H * t, H, t, T_keys, nbasis, bandsize, alpha);
  return (int)cudaGetLastError();
}

template <typename T, int D, int NWARPS>
int launch_keys(const T* q, const T* k, const T* v, const T* dout, const float* R, const float* b_nd,
                const uint8_t* mask, const float* stats, T* dk, T* dv, int B, int H, int t, int T_keys,
                int nbasis, int bandsize, float alpha, size_t smem, cudaStream_t stream) {
  auto kernel = bwd_keys_kernel<T, D, NWARPS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (T_keys + 16 * NWARPS - 1) / (16 * NWARPS));
  kernel<<<grid, NWARPS * 32, smem, stream>>>(q, k, v, dout, R, b_nd, mask, stats, dk, dv, B * H * t, H, t,
                                              T_keys, nbasis, bandsize, alpha);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q_, const void* k_, const void* v_, const void* dout_, const float* R, const float* b_nd,
           const uint8_t* mask, void* dq_, void* dk_, void* dv_, float* dR, float* db, float* stats,
           float* partial, int B, int H, int t, int T_keys, int nbasis, int bandsize, float alpha,
           cudaStream_t stream) {
  const auto* q = static_cast<const T*>(q_);
  const auto* k = static_cast<const T*>(k_);
  const auto* v = static_cast<const T*>(v_);
  const auto* dout = static_cast<const T*>(dout_);
  auto* dq = static_cast<T*>(dq_);
  auto* dk = static_cast<T*>(dk_);
  auto* dv = static_cast<T*>(dv_);
  int dev = 0, limit = 0, nblocks = 0;
  cudaGetDevice(&dev);
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // pass 1 takes 64-row blocks and pass 2 8-warp blocks where they fit the
  // card's shared memory, else 32-row and 4-warp blocks
  int rc = rows_smem_bytes<T, D>(64, T_keys, nbasis, bandsize) <= (size_t)limit
               ? launch_rows<T, D, 64>(q, k, v, dout, R, b_nd, mask, dq, dR, stats, partial, B, H, t, T_keys,
                                       nbasis, bandsize, alpha, stream, &nblocks)
               : launch_rows<T, D, 32>(q, k, v, dout, R, b_nd, mask, dq, dR, stats, partial, B, H, t, T_keys,
                                       nbasis, bandsize, alpha, stream, &nblocks);
  if (rc != 0) return rc;
  const size_t keys8 = keys_smem_bytes<T, D>(8, nbasis, bandsize);
  rc = keys8 <= (size_t)limit
           ? launch_keys<T, D, 8>(q, k, v, dout, R, b_nd, mask, stats, dk, dv, B, H, t, T_keys, nbasis, bandsize,
                                  alpha, keys8, stream)
           : launch_keys<T, D, 4>(q, k, v, dout, R, b_nd, mask, stats, dk, dv, B, H, t, T_keys, nbasis, bandsize,
                                  alpha, keys_smem_bytes<T, D>(4, nbasis, bandsize), stream);
  if (rc != 0 || R == nullptr) return rc;
  const int size = nbasis * bandsize;
  db_reduce_kernel<<<(size + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, stream>>>(partial, db,
                                                                                                nblocks, size);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* dout, const float* R, const float* b_nd,
               const uint8_t* mask, void* dq, void* dk, void* dv, float* dR, float* db, float* stats,
               float* partial, int B, int H, int t, int T_keys, int d, int nbasis, int bandsize, float alpha,
               cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, dout, R, b_nd, mask, dq, dk, dv, dR, db, stats, partial, B, H, t, T_keys,
                           nbasis, bandsize, alpha, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, R, b_nd, mask, dq, dk, dv, dR, db, stats, partial, B, H, t, T_keys,
                            nbasis, bandsize, alpha, s);
    case 192:
      return launch<T, 192>(q, k, v, dout, R, b_nd, mask, dq, dk, dv, dR, db, stats, partial, B, H, t, T_keys,
                            nbasis, bandsize, alpha, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q and dout (B, H, t, d), k and v (B, H, T, d), any T: contiguous and
// 16-byte aligned, all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1).  R (B,
// H, t, nbasis) f32 and b_nd (nbasis, bandsize <= 512) f32, both null for no
// relative bias.  mask (B, t, T) bool bytes, null for no mask.  Outputs dq (B, H, t,
// d), dk and dv (B, H, T, d) in the input dtype; dR (B, H, t, nbasis) and
// db_nd (nbasis, bandsize) f32 (unused without R).  Scratch: stats
// 3 * B * H * t f32, partial B * H * ceil(t / 32) * nbasis * bandsize f32
// (unused without R; pass 1's blocks have at least 32 rows).  Returns a
// cudaError_t (0 = launched).
extern "C" int vpt_windowed_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                          const float* R, const float* b_nd, const uint8_t* mask, void* dq,
                                          void* dk, void* dv, float* dR, float* db_nd, float* stats,
                                          float* partial, int B, int H, int t, int T, int d, int nbasis,
                                          int bandsize, int is_bf16, float alpha, void* stream) {
  if (B < 1 || H < 1 || t < 1 || T < 1) return (int)cudaErrorInvalidValue;
  if ((R == nullptr) != (b_nd == nullptr)) return (int)cudaErrorInvalidValue;
  if (R != nullptr && (nbasis < 1 || nbasis > MAX_NBASIS || bandsize < 1 || bandsize > MAX_BAND ||
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
