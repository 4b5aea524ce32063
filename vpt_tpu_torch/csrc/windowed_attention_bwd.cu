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
//     (accumulated across chunks in registers at a whole d), dR and the d
//     b_nd partials (accumulated in place, each entry by the one thread that
//     owns it).  At a whole d, Q and dO take turns in the one row tile.
//     Pass 2 already streams the
//     query rows over tiles of keys and reads pass 1's row statistics;
//   * the band table sits in shared memory whole up to 512 offsets; a longer
//     one (attention_memory_size - timesteps > 512, no published model)
//     stays in device memory, and the band bias and dR read it there,
//     through L1 and L2 (the d b_nd partials are in device memory anyway);
//   * d = 256 (hidsize 4096 at 16 heads) takes 16-row blocks of 4 warps in
//     pass 1 and 2-warp blocks in pass 2 where larger ones would not fit
//     the shared memory;
//   * every multiple of 64 above 256 runs one instance with d set at run
//     time (Depth<T, STREAMED>, as in B1), whose shared memory does not
//     depend on d.  Pass 1 (32-row blocks, as B1's) streams K and V tiles 64
//     columns at a time, each with the same chunk of the block's Q or dO
//     rows (Q K^T and dO V^T accumulate over the chunks of a key tile), and
//     dQ takes its columns a chunk at a time.  Pass 2
//     (bwd_keys_streamed_kernel) sums K Q^T and V dO^T of a query tile over
//     the chunks of d, turns them into W^T and dL^T once, keeps those in
//     registers and walks the chunks again, adding W^T dO to dV and dL^T Q
//     to dK a chunk at a time: its work grows linearly in d.  Accumulators
//     that outlive a pass over keys (pass 1's dQ past 512 keys) or over
//     query tiles (pass 2's dK and dV) wait in an f32 scratch in device
//     memory, each entry owned by the one thread that adds to it: no
//     atomics, the same sums in the same order every run.
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
  using DT = Depth<T, D>;
  const size_t band = band_smem_floats(nbasis, bandsize);
  const size_t running = T_keys > KEY_CHUNK ? 2 * rows : 0;
  const int keys = T_keys < KEY_CHUNK ? T_keys : KEY_CHUNK;
  return ((size_t)DT::row_tile(rows) + 2 * DT::kv_buffer(rows)) * sizeof(T) +
         ((size_t)rows * logit_stride(keys) + rows * R_STRIDE + RowBlock<64>::SPLIT * rows + band + running) *
             sizeof(float);
}

template <typename T, int D>
size_t keys_smem_bytes(int nwarps, int nbasis, int bandsize) {
  const size_t keys = 16 * nwarps;
  const size_t tile = (size_t)tile_stride<T, D>() * sizeof(T);
  const size_t band = band_smem_floats(nbasis, bandsize);
  return (2 * keys + 2 * QUERY_TILE) * tile +
         (keys * BIAS_STRIDE + QUERY_TILE * R_STRIDE + 3 * QUERY_TILE + band) * sizeof(float);
}

// pass 2 at the streamed D: two buffers, each a D_CHUNK-column chunk of the
// block's K and V rows and of a query tile's Q and dO rows
template <typename T>
size_t keys_streamed_smem_bytes(int nwarps, int nbasis, int bandsize) {
  const size_t keys = 16 * nwarps;
  const size_t band = band_smem_floats(nbasis, bandsize);
  return 2 * (2 * keys + 2 * QUERY_TILE) * (size_t)Depth<T, STREAMED>::CS * sizeof(T) +
         (keys * BIAS_STRIDE + QUERY_TILE * R_STRIDE + 3 * QUERY_TILE + band) * sizeof(float);
}

// pass 1: one block per (b, h, ROWS query rows); dq_acc is unused here (the
// parameters are those of bwd_rows_chunked_kernel, which the launch may pick instead)
template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(RowBlock<ROWS>::NTHREADS)
bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ R, const float* __restrict__ b_nd,
                const uint8_t* __restrict__ mask, T* __restrict__ dq, float* __restrict__ dR,
                float* __restrict__ stats, float* __restrict__ partial, float* __restrict__ dq_acc, int BHt,
                int H, int t, int T_keys, int d, int nbasis, int bandsize, float alpha) {
  using Block = RowBlock<ROWS>;
  using DT = Depth<T, D>;
  const DT dp(d);
  constexpr int NTHREADS = Block::NTHREADS;
  constexpr int SPLIT = Block::SPLIT;
  constexpr int CH = DT::CHUNK, CS = DT::CS;
  constexpr int DH = CH / SPLIT;        // dQ columns of a warp in a chunk of d
  constexpr int KH = KEY_TILE / SPLIT;  // keys of a tile a warp takes
  const int TS = logit_stride(T_keys);
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);  // DT::row_tile(ROWS): Q, then dO rows whole (none when streamed)
  T* sKV = sQ + DT::row_tile(ROWS);     // 2 x DT::kv_buffer(ROWS): K, V, V, then K tiles (with Q's or dO's chunks)
  float* sS = reinterpret_cast<float*>(sKV + 2 * DT::kv_buffer(ROWS));  // ROWS x TS: logits, then W, then dL
  float* sR = sS + ROWS * TS;          // ROWS x R_STRIDE
  float* sRd = sR + ROWS * R_STRIDE;   // SPLIT x ROWS: each part's rowdot partial sums
  float* sB = sRd + SPLIT * ROWS;      // nbasis x bandsize (up to MAX_BAND)

  const Block rb;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int g = rb.g, c = rb.c, row0 = rb.row0, lane = rb.lane;
  const T* qb = q + (size_t)bh * t * dp.d;
  const T* ob = dout + (size_t)bh * t * dp.d;
  const T* kb = k + (size_t)bh * T_keys * dp.d;
  const T* vb = v + (size_t)bh * T_keys * dp.d;

  // R's rows and the band table, then Q, then K's first tile, each a group of
  // copies in flight while the mask terms load; the bias waits for the first only
  if (nbasis > 0)
    load_bias_inputs_async<NTHREADS>(sR, R + (size_t)bh * t * nbasis, q0, ROWS, t, nbasis, band_copy(sB, bandsize),
                                     b_nd, bandsize);
  cp_async_commit();
  if constexpr (!DT::STREAM) load_rows_async<T, D>(sQ, CS, qb, q0, ROWS, t, tid, NTHREADS);
  cp_async_commit();
  fetch_depth_tile<T, D, ROWS, NTHREADS>(sKV, 0, kb, T_keys, dp, qb, q0, t);
  mask_window<NTHREADS, true>(sS, TS, mask != nullptr ? mask + (size_t)b * t * T_keys : nullptr, q0, ROWS, t, 0,
                              TS - 8, T_keys);
  cp_async_wait<2>();
  __syncthreads();

  // 1. the logits and their softmax W in place, keeping each row's max and sum
  if (nbasis > 0) {
    with_band_table(sB, b_nd, bandsize, [&](const float* band) {
      band_bias_mma<Block::NWARPS>(sS, TS, 1, sR, band, q0, ROWS, t, T_keys, 0, T_keys, nbasis, bandsize);
    });
  }
  block_logits<T, D, ROWS>(sS, TS, sQ, sKV, kb, qb, q0, t, T_keys, dp, alpha, true);
  softmax_rows<ROWS, false>(sS, TS, q0, t, stats + (size_t)bh * t, stats + BHt + (size_t)bh * t);

  // 2. dO replaces Q (every warp is past its last read of Q)
  if constexpr (!DT::STREAM) {
    load_rows_async<T, D>(sQ, CS, ob, q0, ROWS, t, tid, NTHREADS);
    cp_async_commit();
  }

  // dO V^T of the warp's part of a key tile, summed over the tile's chunks of d into p, then body(kt0)
  float p[KH / 8][4];
  auto dp_tiles = [&](const T* src, int nkeys, auto&& body) {
    stream_depth_tiles<T, D, ROWS, NTHREADS>(sKV, src, nkeys, dp, sQ, ob, q0, t, false,
                                             [&](int kt0, int ci, const T* tile, const T* rows) {
      if (ci == 0) {
#pragma unroll
        for (int n = 0; n < KH / 8; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
      }
      mma_nt<T, CH, KH / 8>(p, rows + row0 * CS, CS, tile + rb.part * KH * CS, CS, lane);
      if (ci == dp.chunks - 1) body(kt0);
    });
  };

  // 3. rowdot_i = sum_j (dO V^T)_ij W_ij over the warp's part of each tile, W
  //    read at the fragment's own positions; then the parts' sums, in a fixed order
  float rd[2] = {0.f, 0.f};  // rows g and g + 8 of the warp
  dp_tiles(vb, T_keys, [&](int kt0) {
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
  dp_tiles(vb, T_keys, [&](int kt0) {
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

  // 5. dQ = alpha dL K over tiles of K, a chunk of d at a time (all of it at
  //    a whole d), the warp's SPLIT-th of the chunk's columns
  for (int ci = 0; ci < dp.chunks; ++ci) {
    float acc[DH / 8][4] = {};
    stream_tiles<T, CH, NTHREADS>(sKV, kb + ci * CH, T_keys, false, [&](int kt0, const T* tile) {
      mma_nn_tile<T, DH>(acc, sS + row0 * TS + kt0, TS, tile + rb.part * DH, CS, lane);
    }, dp.d);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = q0 + row0 + g + 8 * h;
      if (gi < t) {
        T* row = dq + ((size_t)bh * t + gi) * dp.d + ci * CH + rb.part * DH + 2 * c;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) store2(row + n * 8, alpha * acc[n][2 * h], alpha * acc[n][2 * h + 1]);
      }
    }
  }
  if (nbasis == 0) return;

  // 6. dR[i, n] = sum_j dL_ij b_nd[n, (T - t) + i - j] over the band, a warp
  //    to a row, every n at once
  with_band_table(sB, b_nd, bandsize, [&](const float* band) {
    for (int i = rb.warp; i < ROWS && q0 + i < t; i += Block::NWARPS) {
      const int off = (T_keys - t) + q0 + i;  // band offset of key 0
      const int jlo = max(0, off - bandsize + 1), jhi = min(T_keys - 1, off);
      float acc_n[MAX_NBASIS] = {};
      for (int j = jlo + lane; j <= jhi; j += 32) {
        const float dl = sS[i * TS + j];
#pragma unroll
        for (int n = 0; n < MAX_NBASIS; ++n) {
          if (n < nbasis) acc_n[n] += dl * band[n * bandsize + off - j];  // uniform condition
        }
      }
      const float x = warp_sum16(acc_n, lane);  // lanes 2n and 2n + 1: the sum for n
      if (lane % 2 == 0 && lane / 2 < nbasis) dR[((size_t)bh * t + q0 + i) * nbasis + lane / 2] = x;
    }
  });

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
// each chunk's logits recomputed in every sweep.  dQ carries from key chunk
// to key chunk in registers at a whole D, in the f32 scratch dq_acc (B, H,
// t, d) at the streamed D.
template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(RowBlock<ROWS>::NTHREADS)
bwd_rows_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ R, const float* __restrict__ b_nd,
                        const uint8_t* __restrict__ mask, T* __restrict__ dq, float* __restrict__ dR,
                                float* __restrict__ stats, float* __restrict__ partial, float* __restrict__ dq_acc,
                        int BHt, int H, int t, int T_keys, int d, int nbasis, int bandsize, float alpha) {
  using Block = RowBlock<ROWS>;
  using DT = Depth<T, D>;
  const DT dp(d);
  constexpr int NTHREADS = Block::NTHREADS;
  constexpr int SPLIT = Block::SPLIT;
  constexpr int CH = DT::CHUNK, CS = DT::CS;
  constexpr int DH = CH / SPLIT;        // dQ columns of a warp in a chunk of d
  constexpr int KH = KEY_TILE / SPLIT;  // keys of a tile a warp takes
  const int TS = logit_stride(KEY_CHUNK);
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);  // DT::row_tile(ROWS): Q or dO rows whole (none when streamed)
  T* sKV = sQ + DT::row_tile(ROWS);     // 2 x DT::kv_buffer(ROWS): K and V tiles (with Q's or dO's chunks)
  float* sS = reinterpret_cast<float*>(sKV + 2 * DT::kv_buffer(ROWS));  // ROWS x TS: a chunk's logits, W, dL
  float* sR = sS + ROWS * TS;          // ROWS x R_STRIDE
  float* sRd = sR + ROWS * R_STRIDE;   // SPLIT x ROWS: each part's rowdot partial sums
  float* sB = sRd + SPLIT * ROWS;      // nbasis x bandsize (up to MAX_BAND)
  float* sM = sB + band_smem_floats(nbasis, bandsize);        // ROWS: running max, then the max
  float* sL = sM + ROWS;                                      // ROWS: running sum, then the sum

  const Block rb;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int g = rb.g, c = rb.c, row0 = rb.row0, lane = rb.lane;
  const T* qb = q + (size_t)bh * t * dp.d;
  const T* ob = dout + (size_t)bh * t * dp.d;
  const T* kb = k + (size_t)bh * T_keys * dp.d;
  const T* vb = v + (size_t)bh * T_keys * dp.d;
  const uint8_t* mask_b = mask != nullptr ? mask + (size_t)b * t * T_keys : nullptr;

  // the first chunk's inputs as in bwd_rows_kernel
  if (nbasis > 0)
    load_bias_inputs_async<NTHREADS>(sR, R + (size_t)bh * t * nbasis, q0, ROWS, t, nbasis, band_copy(sB, bandsize),
                                     b_nd, bandsize);
  cp_async_commit();
  if constexpr (!DT::STREAM) load_rows_async<T, D>(sQ, CS, qb, q0, ROWS, t, tid, NTHREADS);
  cp_async_commit();
  fetch_depth_tile<T, D, ROWS, NTHREADS>(sKV, 0, kb, KEY_CHUNK, dp, qb, q0, t);
  mask_window<NTHREADS, true>(sS, TS, mask_b, q0, ROWS, t, 0, KEY_CHUNK, T_keys);
  for (int i = tid; i < ROWS; i += NTHREADS) {
    sM[i] = -CUDART_INF_F;
    sL[i] = 0.f;
  }
  cp_async_wait<2>();
  __syncthreads();

  // The logits of chunk [c0, c0 + nc) into sS.  Unless `ready` (the first
  // chunk, whose inputs are in), every warp must be past its last read of sS
  // and the chunk's mask terms and first K tile are fetched here; at a whole
  // D, Q must be in sQ or in flight, committed before this call.
  auto chunk_logits = [&](int c0, int nc, bool ready) {
    if (!ready) {
      fetch_depth_tile<T, D, ROWS, NTHREADS>(sKV, 0, kb + (size_t)c0 * dp.d, nc, dp, qb, q0, t);
      mask_window<NTHREADS, true>(sS, TS, mask_b, q0, ROWS, t, c0, KEY_CHUNK, T_keys);
      __syncthreads();
    }
    if (nbasis > 0) {
      with_band_table(sB, b_nd, bandsize, [&](const float* band) {
        band_bias_mma<Block::NWARPS>(sS, TS, 1, sR, band, q0, ROWS, t, T_keys, c0, nc, nbasis, bandsize);
      });
    }
    block_logits<T, D, ROWS>(sS, TS, sQ, sKV, kb + (size_t)c0 * dp.d, qb, q0, t, nc, dp, alpha, true);
  };
  // Q or dO into the row tile at a whole D, once every warp is past its last
  // read of it (at the streamed D they stream with the key tiles)
  auto load_rows = [&](const T* src) {
    if constexpr (!DT::STREAM) {
      load_rows_async<T, D>(sQ, CS, src, q0, ROWS, t, tid, NTHREADS);
      cp_async_commit();
    }
  };
  // dO V^T of the warp's part of a key tile, summed over the tile's chunks of d into p, then body(kt0)
  float p[KH / 8][4];
  auto dp_tiles = [&](const T* src, int nkeys, auto&& body) {
    stream_depth_tiles<T, D, ROWS, NTHREADS>(sKV, src, nkeys, dp, sQ, ob, q0, t, false,
                                             [&](int kt0, int ci, const T* tile, const T* rows) {
      if (ci == 0) {
#pragma unroll
        for (int n = 0; n < KH / 8; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
      }
      mma_nt<T, CH, KH / 8>(p, rows + row0 * CS, CS, tile + rb.part * KH * CS, CS, lane);
      if (ci == dp.chunks - 1) body(kt0);
    });
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
    dp_tiles(vb + (size_t)c0 * dp.d, nc, [&](int kt0) {
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
  float acc[DH / 8][4] = {};  // dQ across the key chunks at a whole D; of one chunk of d at the streamed D
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
    dp_tiles(vb + (size_t)c0 * dp.d, nc, [&](int kt0) {
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
    const bool last = c0 + KEY_CHUNK >= T_keys;
    for (int ci = 0; ci < dp.chunks; ++ci) {
      const int col = ci * CH + rb.part * DH;  // the warp's first dQ column
      const float one[2] = {1.f, 1.f};
      if constexpr (DT::STREAM) {
        if (c0 == 0) {
#pragma unroll
          for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        } else {
          load_frags<DH>(acc, dq_acc + (size_t)bh * t * dp.d, dp.d, q0 + row0, t, col, one, g, c);
        }
      }
      stream_tiles<T, CH, NTHREADS>(sKV, kb + (size_t)c0 * dp.d + ci * CH, nc, false, [&](int kt0, const T* tile) {
        mma_nn_tile<T, DH>(acc, sS + row0 * TS + kt0, TS, tile + rb.part * DH, CS, lane);
      }, dp.d);
      if constexpr (DT::STREAM) {
        if (last) {
          const float a2[2] = {alpha, alpha};
          store_frags<T, DH>(dq + (size_t)bh * t * dp.d, dp.d, q0 + row0, t, col, acc, a2, g, c);
        } else {
          store_frags<float, DH>(dq_acc + (size_t)bh * t * dp.d, dp.d, q0 + row0, t, col, acc, one, g, c);
        }
      }
    }
    if (nbasis == 0) continue;

    // dR[i, n] += sum over the chunk's keys j on the band of dL_ij b_nd[n, (T - t) + i - j]
    with_band_table(sB, b_nd, bandsize, [&](const float* band) {
      for (int i = rb.warp; i < ROWS && q0 + i < t; i += Block::NWARPS) {
        const int off = (T_keys - t) + q0 + i;  // band offset of key 0
        const int jlo = max(c0, off - bandsize + 1), jhi = min(c0 + nc - 1, off);
        float acc_n[MAX_NBASIS] = {};
        for (int j = jlo + lane; j <= jhi; j += 32) {
          const float dl = sS[i * TS + j - c0];
#pragma unroll
          for (int n = 0; n < MAX_NBASIS; ++n) {
            if (n < nbasis) acc_n[n] += dl * band[n * bandsize + off - j];  // uniform condition
          }
        }
        const float x = warp_sum16(acc_n, lane);  // lanes 2n and 2n + 1: the sum for n
        if (lane % 2 == 0 && lane / 2 < nbasis) {
          float* dst = dR + ((size_t)bh * t + q0 + i) * nbasis + lane / 2;
          *dst = (c0 == 0 ? 0.f : *dst) + x;
        }
      }
    });
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
  if constexpr (!DT::STREAM) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = q0 + row0 + g + 8 * h;
      if (gi < t) {
        T* row = dq + ((size_t)bh * t + gi) * dp.d + rb.part * DH + 2 * c;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) store2(row + n * 8, alpha * acc[n][2 * h], alpha * acc[n][2 * h + 1]);
      }
    }
  }
}

// Pass 2's per-query-tile pieces, shared by bwd_keys_kernel and
// bwd_keys_streamed_kernel.

// pass 1's row statistics of query rows [i0, i0 + QUERY_TILE) into sStat:
// the row max, the reciprocal of the row sum (as the forward uses it), rowdot
template <int NTHREADS>
__device__ __forceinline__ void load_query_stats(float* sStat, const float* stats, int BHt, int bh, int t, int i0) {
  for (int idx = threadIdx.x; idx < 3 * QUERY_TILE; idx += NTHREADS) {
    const int which = idx / QUERY_TILE, r = idx % QUERY_TILE;
    const float x = (i0 + r < t) ? stats[(size_t)which * BHt + (size_t)bh * t + i0 + r] : 1.f;
    sStat[idx] = which == 1 ? 1.f / x : x;
  }
}

// L^T and dP^T (the fragments of K Q^T and V dO^T of the warp's 16 keys,
// j0 the first) turned into W^T and dL^T in place, with the tile's mask and
// band bias terms (sBias) and row statistics (sStat)
template <int NQ>
__device__ __forceinline__ void keys_weights(float (&s)[NQ][4], float (&p)[NQ][4], const float* sBias,
                                             const float* sStat, int j0, int k0, int T_keys, int i0, int t,
                                             float alpha, int g, int c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int jj = j0 + g + 8 * h;
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
}

// dV += W^T dO and dK += dL^T Q over the tile's rows, from the fragments as
// they stand; dO and Q are the tile's columns of the accumulators (row stride ld)
template <typename T, int NQ, int DC>
__device__ __forceinline__ void keys_accumulate(float (&gv)[DC / 8][4], float (&gk)[DC / 8][4],
                                                float (&s)[NQ][4], float (&p)[NQ][4], const T* dO,
                                                const T* Q, int ld, int g, int c) {
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const float aw[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
    mma_nn_step<T, DC>(gv, aw, dO + (n * 8 + 2 * c) * ld + g, ld);
    const float al[4] = {p[n][0], p[n][2], p[n][1], p[n][3]};
    mma_nn_step<T, DC>(gk, al, Q + (n * 8 + 2 * c) * ld + g, ld);
  }
}

// the warp's 16 keys' dK and dV on columns [c0, c0 + DC) of rows d apart
template <typename T, int DC>
__device__ __forceinline__ void store_keys(T* dk, T* dv, const float (&gk)[DC / 8][4], const float (&gv)[DC / 8][4],
                                           int bh, int j0, int T_keys, int d, int c0, float alpha, int g, int c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + g + 8 * h;
    if (j < T_keys) {
      const size_t off = ((size_t)bh * T_keys + j) * d + c0 + 2 * c;
#pragma unroll
      for (int n = 0; n < DC / 8; ++n) {
        store2(dv + off + n * 8, gv[n][2 * h], gv[n][2 * h + 1]);
        store2(dk + off + n * 8, alpha * gk[n][2 * h], alpha * gk[n][2 * h + 1]);
      }
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
  float* sB = sStat + 3 * QUERY_TILE;                              // nbasis x bandsize (up to MAX_BAND)

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
                                         c0 == 0 && i0 == 0 ? band_copy(sB, bandsize) : nullptr, b_nd, bandsize);
      cp_async_commit();
      load_rows_async<T, D>(sQ, DS, qb, i0, QUERY_TILE, t, tid, NTHREADS);
      load_rows_async<T, D>(sdO, DS, ob, i0, QUERY_TILE, t, tid, NTHREADS);
      cp_async_commit();
      load_query_stats<NTHREADS>(sStat, stats, BHt, bh, t, i0);
      mask_window<NTHREADS, false>(sBias, BIAS_STRIDE, mask_b, i0, QUERY_TILE, t, k0, KEYS, T_keys);
      cp_async_wait<1>();
      __syncthreads();

      // the band bias of the tile added while Q and dO fly
      if (nbasis > 0)
        with_band_table(sB, b_nd, bandsize, [&](const float* band) {
          band_bias_mma<NWARPS>(sBias, 1, BIAS_STRIDE, sR, band, i0, QUERY_TILE, t, T_keys, k0, KEYS, nbasis, bandsize);
        });
      cp_async_wait<0>();
      __syncthreads();

      // L^T and dP^T of the warp's 16 keys against the tile's rows, then W^T and dL^T in place
      float s[NQ][4] = {}, p[NQ][4] = {};
      mma_nt<T, D, NQ>(s, sK + warp * 16 * DS, DS, sQ, DS, lane);
      mma_nt<T, D, NQ>(p, sV + warp * 16 * DS, DS, sdO, DS, lane);
      keys_weights<NQ>(s, p, sBias, sStat, warp * 16, k0, T_keys, i0, t, alpha, g, c);
      keys_accumulate<T, NQ, DC>(gv, gk, s, p, sdO + c0, sQ + c0, DS, g, c);
    }
    store_keys<T, DC>(dk, dv, gk, gv, bh, k0 + warp * 16, T_keys, D, c0, alpha, g, c);
  }
}

// pass 2 at the streamed D (d set at run time): as bwd_keys_kernel, one
// block per (b, h, 16 * NWARPS keys), with shared memory that does not depend
// on d.  For each query tile the warps sum K Q^T and V dO^T over the chunks
// of d (the chunk of K, V, Q and dO rows streamed through two buffers) and
// turn them into W^T and dL^T once, in registers; then they walk the chunks
// again, with Q and dO alone, adding W^T dO to dV and dL^T Q to dK a chunk
// of columns at a time.  Between query tiles a chunk's dK and dV wait in the
// f32 scratch acc ((2, B, H, T, d): dK, then dV), whose rows belong to this
// block and each entry to the one thread that adds to it; the last query
// tile writes dk and dv.
template <typename T, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
bwd_keys_streamed_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ R, const float* __restrict__ b_nd,
                         const uint8_t* __restrict__ mask, const float* __restrict__ stats, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ acc, int BHt, int H, int t, int T_keys, int d,
                         int nbasis, int bandsize, float alpha) {
  using DT = Depth<T, STREAMED>;
  constexpr int KEYS = 16 * NWARPS;
  constexpr int NTHREADS = NWARPS * 32;
  constexpr int CH = DT::CHUNK, CS = DT::CS;
  constexpr int NQ = QUERY_TILE / 8;
  constexpr int QOFF = 2 * KEYS * CS, OOFF = QOFF + QUERY_TILE * CS;  // Q's and dO's chunks in a buffer
  constexpr int BUF = OOFF + QUERY_TILE * CS;                         // one buffer: K, V, Q and dO chunks
  const DT dp(d);
  extern __shared__ float4 smem4[];
  T* bufs = reinterpret_cast<T*>(smem4);                         // 2 x BUF
  float* sBias = reinterpret_cast<float*>(bufs + 2 * BUF);       // KEYS x BIAS_STRIDE
  float* sR = sBias + KEYS * BIAS_STRIDE;                        // QUERY_TILE x R_STRIDE
  float* sStat = sR + QUERY_TILE * R_STRIDE;                     // 3 x QUERY_TILE: row max, 1 / row sum, rowdot
  float* sB = sStat + 3 * QUERY_TILE;                            // nbasis x bandsize (up to MAX_BAND)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int k0 = blockIdx.y * KEYS;
  const int j0 = k0 + warp * 16;  // the warp's first key
  const T* qb = q + (size_t)bh * t * d;
  const T* ob = dout + (size_t)bh * t * d;
  const T* kb = k + (size_t)bh * T_keys * d;
  const T* vb = v + (size_t)bh * T_keys * d;
  float* acc_k = acc + (size_t)bh * T_keys * d;
  float* acc_v = acc + ((size_t)gridDim.x + bh) * T_keys * d;
  const uint8_t* mask_b = mask != nullptr ? mask + (size_t)b * t * T_keys : nullptr;

  // chunk ci of the query tile's Q and dO rows (from i0), and of the block's
  // K and V rows where `keys`, into buffer ci % 2, committed as one group
  auto fetch = [&](int ci, int i0, bool keys) {
    T* buf = bufs + (ci & 1) * BUF;
    if (keys) {
      load_rows_async<T, CH>(buf, CS, kb + ci * CH, k0, KEYS, T_keys, tid, NTHREADS, d);
      load_rows_async<T, CH>(buf + KEYS * CS, CS, vb + ci * CH, k0, KEYS, T_keys, tid, NTHREADS, d);
    }
    load_rows_async<T, CH>(buf + QOFF, CS, qb + ci * CH, i0, QUERY_TILE, t, tid, NTHREADS, d);
    load_rows_async<T, CH>(buf + OOFF, CS, ob + ci * CH, i0, QUERY_TILE, t, tid, NTHREADS, d);
    cp_async_commit();
  };
  // body(chunk, buffer) on every chunk of d in turn, the next one in flight
  auto walk = [&](int i0, bool keys, auto&& body) {
    fetch(0, i0, keys);
    for (int ci = 0; ci < dp.chunks; ++ci) {
      if (ci + 1 < dp.chunks) {
        fetch(ci + 1, i0, keys);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      body(ci, bufs + (ci & 1) * BUF);
      __syncthreads();  // the buffer is refilled next iteration
    }
  };

  const int ntiles = (t + QUERY_TILE - 1) / QUERY_TILE;
  for (int qt = 0; qt < ntiles; ++qt) {
    const int i0 = qt * QUERY_TILE;
    // the tile's R rows (and at first the band table), statistics and mask
    // terms, then its band bias (every read of these by the previous tile is
    // behind walk's barriers)
    if (nbasis > 0)
      load_bias_inputs_async<NTHREADS>(sR, R + (size_t)bh * t * nbasis, i0, QUERY_TILE, t, nbasis,
                                       qt == 0 ? band_copy(sB, bandsize) : nullptr, b_nd, bandsize);
    cp_async_commit();
    load_query_stats<NTHREADS>(sStat, stats, BHt, bh, t, i0);
    mask_window<NTHREADS, false>(sBias, BIAS_STRIDE, mask_b, i0, QUERY_TILE, t, k0, KEYS, T_keys);
    cp_async_wait<0>();
    __syncthreads();
    if (nbasis > 0)
      with_band_table(sB, b_nd, bandsize, [&](const float* band) {
        band_bias_mma<NWARPS>(sBias, 1, BIAS_STRIDE, sR, band, i0, QUERY_TILE, t, T_keys, k0, KEYS, nbasis,
                              bandsize);
      });

    // L^T and dP^T of the warp's 16 keys against the tile's rows over every
    // chunk of d, then W^T and dL^T in place (walk's barriers order the bias first)
    float s[NQ][4] = {}, p[NQ][4] = {};
    walk(i0, true, [&](int, const T* buf) {
      mma_nt<T, CH, NQ>(s, buf + warp * 16 * CS, CS, buf + QOFF, CS, lane);
      mma_nt<T, CH, NQ>(p, buf + (KEYS + warp * 16) * CS, CS, buf + OOFF, CS, lane);
    });
    keys_weights<NQ>(s, p, sBias, sStat, warp * 16, k0, T_keys, i0, t, alpha, g, c);

    // dV += W^T dO and dK += dL^T Q, a chunk of columns at a time
    const bool first = qt == 0, last = qt == ntiles - 1;
    walk(i0, false, [&](int ci, const T* buf) {
      const float one[2] = {1.f, 1.f};
      float gk[CH / 8][4], gv[CH / 8][4];
      if (first) {
#pragma unroll
        for (int n = 0; n < CH / 8; ++n) {
          gk[n][0] = gk[n][1] = gk[n][2] = gk[n][3] = 0.f;
          gv[n][0] = gv[n][1] = gv[n][2] = gv[n][3] = 0.f;
        }
      } else {
        load_frags<CH>(gk, acc_k, d, j0, T_keys, ci * CH, one, g, c);
        load_frags<CH>(gv, acc_v, d, j0, T_keys, ci * CH, one, g, c);
      }
      keys_accumulate<T, NQ, CH>(gv, gk, s, p, buf + OOFF, buf + QOFF, CS, g, c);
      if (last) {
        store_keys<T, CH>(dk, dv, gk, gv, bh, j0, T_keys, d, ci * CH, alpha, g, c);
      } else {
        store_frags<float, CH>(acc_k, d, j0, T_keys, ci * CH, gk, one, g, c);
        store_frags<float, CH>(acc_v, d, j0, T_keys, ci * CH, gv, one, g, c);
      }
    });
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
                const uint8_t* mask, T* dq, float* dR, float* stats, float* partial, float* dq_acc, int B, int H,
                int t, int T_keys, int d, int nbasis, int bandsize, float alpha, cudaStream_t stream, int* nblocks) {
  auto kernel = T_keys > KEY_CHUNK ? bwd_rows_chunked_kernel<T, D, ROWS> : bwd_rows_kernel<T, D, ROWS>;
  const size_t smem = rows_smem_bytes<T, D>(ROWS, T_keys, nbasis, bandsize);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (t + ROWS - 1) / ROWS);
  *nblocks = (int)(grid.x * grid.y);
  kernel<<<grid, RowBlock<ROWS>::NTHREADS, smem, stream>>>(q, k, v, dout, R, b_nd, mask, dq, dR, stats, partial,
                                                          dq_acc, B * H * t, H, t, T_keys, d, nbasis, bandsize,
                                                          alpha);
  return (int)cudaGetLastError();
}

template <typename T, int D, int NWARPS>
int launch_keys(const T* q, const T* k, const T* v, const T* dout, const float* R, const float* b_nd,
                const uint8_t* mask, const float* stats, T* dk, T* dv, float* dkv_acc, int B, int H, int t,
                int T_keys, int d, int nbasis, int bandsize, float alpha, size_t smem, cudaStream_t stream) {
  dim3 grid(B * H, (T_keys + 16 * NWARPS - 1) / (16 * NWARPS));
  if constexpr (D == STREAMED) {
    auto kernel = bwd_keys_streamed_kernel<T, NWARPS>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, NWARPS * 32, smem, stream>>>(q, k, v, dout, R, b_nd, mask, stats, dk, dv, dkv_acc, B * H * t, H,
                                                t, T_keys, d, nbasis, bandsize, alpha);
  } else {
    auto kernel = bwd_keys_kernel<T, D, NWARPS>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, NWARPS * 32, smem, stream>>>(q, k, v, dout, R, b_nd, mask, stats, dk, dv, B * H * t, H, t,
                                                T_keys, nbasis, bandsize, alpha);
  }
  return (int)cudaGetLastError();
}

// pass 1's rows a block: at a whole D 64 where they fit the card's shared
// memory, else 32, else (d = 256 only) 16; at the streamed D 32, as in B1
template <typename T, int D>
int rows_per_block(int T_keys, int nbasis, int bandsize, int limit) {
  if (D == STREAMED) return 32;
  if (rows_smem_bytes<T, D>(64, T_keys, nbasis, bandsize) <= (size_t)limit) return 64;
  if (D > 192 && rows_smem_bytes<T, D>(32, T_keys, nbasis, bandsize) > (size_t)limit) return 16;
  return 32;
}

// pass 2's warps a block: at a whole D 8 where they fit the card's shared
// memory, else 4, else (d = 256 only) 2; at the streamed D 4, which always
// fit (its 8 do not with the longest band table held in shared memory)
template <typename T, int D>
int key_warps(int nbasis, int bandsize, int limit) {
  if constexpr (D == STREAMED) {
    return 4;
  } else {
    if (keys_smem_bytes<T, D>(8, nbasis, bandsize) <= (size_t)limit) return 8;
    if (D <= 192 || keys_smem_bytes<T, D>(4, nbasis, bandsize) <= (size_t)limit) return 4;
    return 2;
  }
}

template <typename T, int D>
size_t keys_smem(int nwarps, int nbasis, int bandsize) {
  if constexpr (D == STREAMED) {
    return keys_streamed_smem_bytes<T>(nwarps, nbasis, bandsize);
  } else {
    return keys_smem_bytes<T, D>(nwarps, nbasis, bandsize);
  }
}

int smem_limit(int* limit) {
  int dev = 0;
  cudaGetDevice(&dev);
  return (int)cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// f32 scratch floats of the streamed d's accumulators: pass 1's dQ (B, H,
// t, d) past KEY_CHUNK keys, and pass 2's dK and dV (2, B, H, T, d) past one
// query tile; none at a whole d
size_t dq_acc_floats(int B, int H, int t, int T_keys, int d) {
  return streamed_d(d) && T_keys > KEY_CHUNK ? (size_t)B * H * t * d : 0;
}
size_t dkv_acc_floats(int B, int H, int t, int T_keys, int d) {
  return streamed_d(d) && t > QUERY_TILE ? 2 * (size_t)B * H * T_keys * d : 0;
}

// pass 1 at `rows` query rows a block (rows_per_block), pass 2 at `warps` warps (key_warps)
template <typename T, int D>
int launch_pass1(int rows, const T* q, const T* k, const T* v, const T* dout, const float* R, const float* b_nd,
                 const uint8_t* mask, T* dq, float* dR, float* stats, float* partial, float* dq_acc, int B, int H,
                 int t, int T_keys, int d, int nbasis, int bandsize, float alpha, cudaStream_t stream, int* nblocks) {
  if constexpr (D != STREAMED) {
    if (rows == 64)
      return launch_rows<T, D, 64>(q, k, v, dout, R, b_nd, mask, dq, dR, stats, partial, dq_acc, B, H, t, T_keys, d,
                                   nbasis, bandsize, alpha, stream, nblocks);
  }
  if constexpr (D > 192) {
    if (rows == 16)
      return launch_rows<T, D, 16>(q, k, v, dout, R, b_nd, mask, dq, dR, stats, partial, dq_acc, B, H, t, T_keys, d,
                                   nbasis, bandsize, alpha, stream, nblocks);
  }
  return launch_rows<T, D, 32>(q, k, v, dout, R, b_nd, mask, dq, dR, stats, partial, dq_acc, B, H, t, T_keys, d,
                               nbasis, bandsize, alpha, stream, nblocks);
}

template <typename T, int D>
int launch_pass2(int warps, const T* q, const T* k, const T* v, const T* dout, const float* R, const float* b_nd,
                 const uint8_t* mask, const float* stats, T* dk, T* dv, float* dkv_acc, int B, int H, int t,
                 int T_keys, int d, int nbasis, int bandsize, float alpha, size_t smem, cudaStream_t stream) {
  if constexpr (D != STREAMED) {
    if (warps == 8)
      return launch_keys<T, D, 8>(q, k, v, dout, R, b_nd, mask, stats, dk, dv, dkv_acc, B, H, t, T_keys, d, nbasis,
                                  bandsize, alpha, smem, stream);
  }
  if constexpr (D > 192) {
    if (warps == 2)
      return launch_keys<T, D, 2>(q, k, v, dout, R, b_nd, mask, stats, dk, dv, dkv_acc, B, H, t, T_keys, d, nbasis,
                                  bandsize, alpha, smem, stream);
  }
  return launch_keys<T, D, 4>(q, k, v, dout, R, b_nd, mask, stats, dk, dv, dkv_acc, B, H, t, T_keys, d, nbasis,
                              bandsize, alpha, smem, stream);
}

template <typename T, int D>
int launch(const void* q_, const void* k_, const void* v_, const void* dout_, const float* R, const float* b_nd,
           const uint8_t* mask, void* dq_, void* dk_, void* dv_, float* dR, float* db, float* stats,
           float* partial, float* scratch, int B, int H, int t, int T_keys, int d, int nbasis, int bandsize,
           float alpha, cudaStream_t stream) {
  const auto* q = static_cast<const T*>(q_);
  const auto* k = static_cast<const T*>(k_);
  const auto* v = static_cast<const T*>(v_);
  const auto* dout = static_cast<const T*>(dout_);
  auto* dq = static_cast<T*>(dq_);
  auto* dk = static_cast<T*>(dk_);
  auto* dv = static_cast<T*>(dv_);
  float* dq_acc = scratch;
  float* dkv_acc = scratch + dq_acc_floats(B, H, t, T_keys, d);
  int limit = 0, nblocks = 0;
  int rc = smem_limit(&limit);
  if (rc != 0) return rc;
  rc = launch_pass1<T, D>(rows_per_block<T, D>(T_keys, nbasis, bandsize, limit), q, k, v, dout, R, b_nd, mask, dq, dR,
                          stats, partial, dq_acc, B, H, t, T_keys, d, nbasis, bandsize, alpha, stream, &nblocks);
  if (rc != 0) return rc;
  const int warps = key_warps<T, D>(nbasis, bandsize, limit);
  rc = launch_pass2<T, D>(warps, q, k, v, dout, R, b_nd, mask, stats, dk, dv, dkv_acc, B, H, t, T_keys, d, nbasis,
                          bandsize, alpha, keys_smem<T, D>(warps, nbasis, bandsize), stream);
  if (rc != 0 || R == nullptr) return rc;
  const int size = nbasis * bandsize;
  db_reduce_kernel<<<(size + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, stream>>>(partial, db,
                                                                                                nblocks, size);
  return (int)cudaGetLastError();
}

}  // namespace

// The query rows of one block of pass 1 at this shape (64, 32 or 16), which
// size the caller's d b_nd scratch; a negative cudaError_t on failure.
extern "C" int vpt_windowed_attention_bwd_rows(int T, int d, int nbasis, int bandsize, int is_bf16) {
  int limit = 0;
  const int err = smem_limit(&limit);
  if (err != 0) return -err;
  if (T < 1 || !kernel_d(d)) return -(int)cudaErrorInvalidValue;
  return with_depth(d, [&](auto depth) {
    constexpr int D = decltype(depth)::value;
    return is_bf16 ? rows_per_block<__nv_bfloat16, D>(T, nbasis, bandsize, limit)
                   : rows_per_block<float, D>(T, nbasis, bandsize, limit);
  });
}

// The f32 scratch, in floats, that vpt_windowed_attention_bwd needs at this
// shape for its accumulators (0 at a whole d).
extern "C" long long vpt_windowed_attention_bwd_scratch(int B, int H, int t, int T, int d) {
  return (long long)(dq_acc_floats(B, H, t, T, d) + dkv_acc_floats(B, H, t, T, d));
}

// The dynamic shared memory, in bytes, of the backward's pass 1 (pass = 1)
// or pass 2 (pass = 2) at this shape; a negative cudaError_t on failure.
extern "C" int vpt_windowed_attention_bwd_smem(int T, int d, int nbasis, int bandsize, int is_bf16, int pass) {
  int limit = 0;
  const int err = smem_limit(&limit);
  if (err != 0) return -err;
  if (T < 1 || !kernel_d(d) || (pass != 1 && pass != 2)) return -(int)cudaErrorInvalidValue;
  auto bytes = [&](auto type, auto depth) {
    using T_ = decltype(type);
    constexpr int D = decltype(depth)::value;
    if (pass == 1) return (int)rows_smem_bytes<T_, D>(rows_per_block<T_, D>(T, nbasis, bandsize, limit), T, nbasis,
                                                      bandsize);
    return (int)keys_smem<T_, D>(key_warps<T_, D>(nbasis, bandsize, limit), nbasis, bandsize);
  };
  return with_depth(d, [&](auto depth) {
    return is_bf16 ? bytes(__nv_bfloat16(), depth) : bytes(float(), depth);
  });
}

// q and dout (B, H, t, d), k and v (B, H, T, d), d any multiple of 64, any
// T: contiguous and 16-byte aligned, all f32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1).  R (B, H, t, nbasis) f32 and b_nd (nbasis, bandsize) f32,
// any bandsize, both null for no relative bias.  mask (B, t, T) bool bytes,
// null for no mask.  Outputs dq (B, H, t, d), dk and dv (B, H, T, d) in the
// input dtype; dR (B, H, t, nbasis) and db_nd (nbasis, bandsize) f32 (unused
// without R).  Scratch: stats 3 * B * H * t f32, partial B * H * ceil(t /
// rows) * nbasis * bandsize f32 with rows from vpt_windowed_attention_bwd_rows
// (unused without R), and scratch of vpt_windowed_attention_bwd_scratch f32
// (null where that is 0).  Returns a cudaError_t (0 = launched).
extern "C" int vpt_windowed_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                          const float* R, const float* b_nd, const uint8_t* mask, void* dq,
                                          void* dk, void* dv, float* dR, float* db_nd, float* stats,
                                          float* partial, float* scratch, int B, int H, int t, int T, int d,
                                          int nbasis, int bandsize, int is_bf16, float alpha, void* stream) {
  if (B < 1 || H < 1 || t < 1 || T < 1 || !kernel_d(d)) return (int)cudaErrorInvalidValue;
  if ((R == nullptr) != (b_nd == nullptr)) return (int)cudaErrorInvalidValue;
  if (R != nullptr && (nbasis < 1 || nbasis > MAX_NBASIS || bandsize < 1 || dR == nullptr || db_nd == nullptr ||
                       partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (scratch == nullptr && dq_acc_floats(B, H, t, T, d) + dkv_acc_floats(B, H, t, T, d) > 0)
    return (int)cudaErrorInvalidValue;
  if (R == nullptr) nbasis = bandsize = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_depth(d, [&](auto depth) {
    constexpr int D = decltype(depth)::value;
    if (is_bf16)
      return launch<__nv_bfloat16, D>(q, k, v, dout, R, b_nd, mask, dq, dk, dv, dR, db_nd, stats, partial, scratch,
                                      B, H, t, T, d, nbasis, bandsize, alpha, s);
    return launch<float, D>(q, k, v, dout, R, b_nd, mask, dq, dk, dv, dR, db_nd, stats, partial, scratch, B, H, t,
                            T, d, nbasis, bandsize, alpha, s);
  });
}

extern "C" const char* vpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
