// Windowed attention forward for Hopper (sm_90a), f32 and bf16: kernel B1.
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
// T=256, d=128) one call does 1.07 GFLOP of products (Q K^T and W V) against
// 25.6 MB of f32 inputs and output.  At f32 accuracy on the tensor cores
// (three TF32 products at 495 TFLOP/s) the products need 6.5 us, the band
// bias R b_nd (an f32 product too, in both types) 0.1 us, and the bytes
// 7.7 us at 3.35 TB/s: the least time is set by the bytes, in bf16 more
// so.  In practice the f32 products are the limit: every operand fragment is loaded
// from shared memory and split into TF32 hi and lo by the warp that uses
// it, several instructions beside each tensor-core product.  The design:
//   * every product runs on tensor cores with mma.sync (attention_mma.cuh).
//     In f32, Q K^T and W V split both operands into TF32 hi + lo parts and
//     take three TF32 products each; in bf16, Q K^T and bf16(W) V are one
//     bf16 product each (exact products, f32 accumulation).  The band bias
//     R b_nd is a small product too (three TF32 products, nbasis padded to
//     16), scattered from its (row, band offset) tiles to the keys;
//   * one block owns (b, h, 64 query rows) with 16 warps, four to each 16
//     rows (which split each key tile in Q K^T and the columns in W V), so
//     that four warps on each of an SM's four schedulers hide each other's
//     latencies; 32 rows and 8 warps where a 64-row block's shared memory
//     would exceed the card's 227 KB (d = 192 and T = 512 in f32).  64-key
//     tiles of K and then of V stream through two shared buffers with
//     cp.async, the next tile in flight while the warps multiply the current
//     one; B * H * ceil(t / 64) blocks spread over the 132 SMs;
//   * the mask terms (read 4 bytes a load) and the band bias of the block's
//     rows go into the logit tile first, while Q and K's first tile load;
//     Q K^T then adds alpha q.k in the accumulator fragments' own (i, j)
//     positions.  No (n, t, T) band table and no (B, H, t, T) tensor reaches
//     device memory;
//   * the softmax is the reference's exact two-pass one: the logits of the
//     block's rows over all T <= 512 keys stay in shared memory, and the
//     warps normalise them in place (in bf16, W is rounded after it is
//     normalised, as in the reference);
//   * past 512 keys (IDMAgent.predict_actions carries its state, so N frames
//     attend over N + maxlen keys) a second kernel walks the keys in chunks
//     of 512 through the same logit tile: each row's running max and sum
//     carry from chunk to chunk, the output accumulators are rescaled by
//     exp(old max - new max) when the max moves, and the rows are divided by
//     their sum once, at the end (in bf16 the unnormalised weights are
//     rounded).  A fully masked row still gets uniform weights over all T
//     keys;
//   * the band table sits in shared memory whole up to 512 offsets; a longer
//     one (attention_memory_size - timesteps > 512, no published model)
//     stays in device memory, and the band bias reads it there, through L1
//     and L2;
//   * d = 256 (hidsize 4096 at 16 heads) takes 16-row blocks of 4 warps
//     where 32 rows would not fit the shared memory (f32, or long bands);
//   * every multiple of 64 above 256 runs one instance with d set at run
//     time (Depth<T, STREAMED>), whose shared memory does not depend on d:
//     its tiles hold 64 columns, and its blocks 32 rows (twice the blocks of
//     64 rows: a wide head's call has few (b, h) pairs).  Q K^T streams each
//     key tile chunk by chunk together with the same chunk of the block's Q
//     rows, summing into the same accumulators, and W V takes the output's
//     columns a chunk at a time, reading W from the logit tile again.  Past
//     512 keys a chunk's output columns wait in an f32 scratch in device
//     memory (B, H, t, d) between key chunks, each entry owned by the one
//     thread that rescales and adds to it; the last key chunk writes the
//     output.  The wrapper pads any other d with zero columns to the next
//     multiple of 64.

#include "attention_mma.cuh"

namespace {

using namespace wattn;

// past KEY_CHUNK keys: a chunk's logit tile, and each row's running max, sum and rescale factor
template <typename T, int D>
size_t smem_bytes(int rows, int T_keys, int nbasis, int bandsize) {
  using DT = Depth<T, D>;
  const size_t band = band_smem_floats(nbasis, bandsize);
  const size_t running = T_keys > KEY_CHUNK ? 3 * rows : 0;
  const int keys = T_keys < KEY_CHUNK ? T_keys : KEY_CHUNK;
  return ((size_t)DT::row_tile(rows) + 2 * DT::kv_buffer(rows)) * sizeof(T) +
         ((size_t)rows * logit_stride(keys) + rows * R_STRIDE + band + running) * sizeof(float);
}

// T <= KEY_CHUNK keys; scratch is unused here (the parameters are those of
// windowed_attention_fwd_chunked_kernel, which the launch may pick instead)
template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(RowBlock<ROWS>::NTHREADS)
windowed_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                              const float* __restrict__ R, const float* __restrict__ b_nd,
                              const uint8_t* __restrict__ mask, T* __restrict__ out, float* __restrict__ scratch,
                              int H, int t, int T_keys, int d, int nbasis, int bandsize, float alpha) {
  using Block = RowBlock<ROWS>;
  using DT = Depth<T, D>;
  const DT dp(d);
  constexpr int CS = DT::CS;
  constexpr int DH = DT::CHUNK / Block::SPLIT;  // output columns of a warp in a chunk of d
  constexpr bool BF16 = exact_in_tf32<T>::value;
  const int TS = logit_stride(T_keys);
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);  // DT::row_tile(ROWS): the block's Q rows whole (none when streamed)
  T* sKV = sQ + DT::row_tile(ROWS);     // 2 x DT::kv_buffer(ROWS): K tiles (and Q's chunks), then V tiles
  float* sS = reinterpret_cast<float*>(sKV + 2 * DT::kv_buffer(ROWS));  // ROWS x TS: logits, then W
  float* sR = sS + ROWS * TS;                                            // ROWS x R_STRIDE
  float* sB = sR + ROWS * R_STRIDE;                                      // nbasis x bandsize (up to MAX_BAND)

  const Block rb;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;

  // R's rows and the band table, then Q, then K's first tile, each a group of
  // copies in flight while the mask terms load; the bias waits for the first only
  if (nbasis > 0) {
    load_bias_inputs_async<Block::NTHREADS>(sR, R + (size_t)bh * t * nbasis, q0, ROWS, t, nbasis,
                                            band_copy(sB, bandsize), b_nd, bandsize);
  }
  cp_async_commit();
  const T* kb = k + (size_t)bh * T_keys * dp.d;
  const T* qb = q + (size_t)bh * t * dp.d;
  if constexpr (!DT::STREAM) load_rows_async<T, D>(sQ, CS, qb, q0, ROWS, t, tid, Block::NTHREADS);
  cp_async_commit();
  fetch_depth_tile<T, D, ROWS, Block::NTHREADS>(sKV, 0, kb, T_keys, dp, qb, q0, t);
  mask_window<Block::NTHREADS, true>(sS, TS, mask != nullptr ? mask + (size_t)b * t * T_keys : nullptr, q0, ROWS,
                                     t, 0, TS - 8, T_keys);
  cp_async_wait<2>();
  __syncthreads();

  // pass 1: the bias and mask terms, plus alpha Q K^T; then the softmax of each row
  if (nbasis > 0) {
    with_band_table(sB, b_nd, bandsize, [&](const float* band) {
      band_bias_mma<Block::NWARPS>(sS, TS, 1, sR, band, q0, ROWS, t, T_keys, 0, T_keys, nbasis, bandsize);
    });
  }
  block_logits<T, D, ROWS>(sS, TS, sQ, sKV, kb, qb, q0, t, T_keys, dp, alpha, true);
  softmax_rows<ROWS, BF16>(sS, TS, q0, t, nullptr, nullptr);

  // pass 2: O = W V over tiles of V, a chunk of d at a time (all of it at a
  // whole d), the warp's SPLIT-th of the chunk's columns
  const float* wrows = sS + rb.row0 * TS;
  const T* vb = v + (size_t)bh * T_keys * dp.d;
  for (int ci = 0; ci < dp.chunks; ++ci) {
    float o[DH / 8][4] = {};
    stream_tiles<T, DT::CHUNK, Block::NTHREADS>(sKV, vb + ci * DT::CHUNK, T_keys, false, [&](int kt0, const T* tile) {
      if constexpr (BF16) {
        mma_nn_tile_bf16<DH>(o, wrows + kt0, TS, tile + rb.part * DH, CS, rb.lane);
      } else {
        mma_nn_tile<T, DH>(o, wrows + kt0, TS, tile + rb.part * DH, CS, rb.lane);
      }
    }, dp.d);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = q0 + rb.row0 + rb.g + 8 * h;
      if (gi < t) {
        T* orow = out + ((size_t)bh * t + gi) * dp.d + ci * DT::CHUNK + rb.part * DH + 2 * rb.c;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) store2(orow + n * 8, o[n][2 * h], o[n][2 * h + 1]);
      }
    }
  }
}

// The kernel above for T > KEY_CHUNK keys: chunks of KEY_CHUNK keys through
// the one logit tile, with an online softmax across them.  The output's
// accumulators carry from key chunk to key chunk in registers at a whole D,
// in the f32 scratch (B, H, t, d) at the streamed D.
template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(RowBlock<ROWS>::NTHREADS)
windowed_attention_fwd_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                      const float* __restrict__ R, const float* __restrict__ b_nd,
                                      const uint8_t* __restrict__ mask, T* __restrict__ out,
                                      float* __restrict__ scratch, int H, int t, int T_keys, int d, int nbasis,
                                      int bandsize, float alpha) {
  using Block = RowBlock<ROWS>;
  using DT = Depth<T, D>;
  const DT dp(d);
  constexpr int NTHREADS = Block::NTHREADS;
  constexpr int CS = DT::CS;
  constexpr int DH = DT::CHUNK / Block::SPLIT;  // output columns of a warp in a chunk of d
  constexpr bool BF16 = exact_in_tf32<T>::value;
  const int TS = logit_stride(KEY_CHUNK);
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);  // DT::row_tile(ROWS): the block's Q rows whole (none when streamed)
  T* sKV = sQ + DT::row_tile(ROWS);     // 2 x DT::kv_buffer(ROWS): K tiles (and Q's chunks), then V tiles
  float* sS = reinterpret_cast<float*>(sKV + 2 * DT::kv_buffer(ROWS));  // ROWS x TS: a chunk's logits, then exp
  float* sR = sS + ROWS * TS;                                            // ROWS x R_STRIDE
  float* sB = sR + ROWS * R_STRIDE;                                      // nbasis x bandsize (up to MAX_BAND)
  float* sM = sB + band_smem_floats(nbasis, bandsize);                   // ROWS: running max
  float* sL = sM + ROWS;                                                 // ROWS: running sum
  float* sC = sL + ROWS;                                                 // ROWS: this chunk's rescale factor

  const Block rb;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const T* qb = q + (size_t)bh * t * dp.d;
  const T* kb = k + (size_t)bh * T_keys * dp.d;
  const T* vb = v + (size_t)bh * T_keys * dp.d;
  const uint8_t* mask_b = mask != nullptr ? mask + (size_t)b * t * T_keys : nullptr;

  // as the kernel above, for the first chunk
  if (nbasis > 0) {
    load_bias_inputs_async<NTHREADS>(sR, R + (size_t)bh * t * nbasis, q0, ROWS, t, nbasis, band_copy(sB, bandsize),
                                     b_nd, bandsize);
  }
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

  // the output accumulators across the key chunks (registers at a whole D)
  float o[DH / 8][4] = {};
  for (int c0 = 0; c0 < T_keys; c0 += KEY_CHUNK) {
    const int nc = min(KEY_CHUNK, T_keys - c0);
    if (c0 > 0) {  // every warp is past the previous chunk (stream_tiles ends with a barrier)
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
    softmax_rows_online<ROWS, true>(sS, TS, sM, sL, sC);
    __syncthreads();
    float scale[2], inv[2];  // the rows' rescale factor, and on the last chunk 1 / their sum
    const bool last = c0 + KEY_CHUNK >= T_keys;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      scale[h] = sC[rb.row0 + rb.g + 8 * h];
      inv[h] = last ? 1.f / sL[rb.row0 + rb.g + 8 * h] : 1.f;
    }
    const float* wrows = sS + rb.row0 * TS;
    for (int ci = 0; ci < dp.chunks; ++ci) {
      const int col = ci * DT::CHUNK + rb.part * DH;  // the warp's first output column
      if constexpr (DT::STREAM) {
        if (c0 == 0) {
#pragma unroll
          for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
        } else {
          load_frags<DH>(o, scratch + (size_t)bh * t * dp.d, dp.d, q0 + rb.row0, t, col, scale, rb.g, rb.c);
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int n = 0; n < DH / 8; ++n) {
            o[n][2 * h] *= scale[h];
            o[n][2 * h + 1] *= scale[h];
          }
        }
      }
      stream_tiles<T, DT::CHUNK, NTHREADS>(sKV, vb + (size_t)c0 * dp.d + ci * DT::CHUNK, nc, false,
                                           [&](int kt0, const T* tile) {
        if constexpr (BF16) {
          mma_nn_tile_bf16<DH>(o, wrows + kt0, TS, tile + rb.part * DH, CS, rb.lane);
        } else {
          mma_nn_tile<T, DH>(o, wrows + kt0, TS, tile + rb.part * DH, CS, rb.lane);
        }
      }, dp.d);
      if (last) {
        store_frags<T, DH>(out + (size_t)bh * t * dp.d, dp.d, q0 + rb.row0, t, col, o, inv, rb.g, rb.c);
      } else if constexpr (DT::STREAM) {
        const float one[2] = {1.f, 1.f};
        store_frags<float, DH>(scratch + (size_t)bh * t * dp.d, dp.d, q0 + rb.row0, t, col, o, one, rb.g, rb.c);
      }
    }
  }
}

template <typename T, int D, int ROWS>
int launch(const void* q, const void* k, const void* v, const float* R, const float* b_nd, const uint8_t* mask,
           void* out, float* scratch, int B, int H, int t, int T_keys, int d, int nbasis, int bandsize, float alpha,
           cudaStream_t stream) {
  auto kernel = T_keys > KEY_CHUNK ? windowed_attention_fwd_chunked_kernel<T, D, ROWS>
                                   : windowed_attention_fwd_kernel<T, D, ROWS>;
  const size_t smem = smem_bytes<T, D>(ROWS, T_keys, nbasis, bandsize);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (t + ROWS - 1) / ROWS);
  kernel<<<grid, RowBlock<ROWS>::NTHREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                          static_cast<const T*>(v), R, b_nd, mask,
                                                          static_cast<T*>(out), scratch, H, t, T_keys, d, nbasis,
                                                          bandsize, alpha);
  return (int)cudaGetLastError();
}

// A block's query rows: at a whole D 64 where they fit the card's shared
// memory, else 32, else (d = 256 only) 16; at the streamed D 32, which
// always fit and make twice the blocks of 64 (a wide head's call has few
// (b, h) pairs to spread over the SMs)
template <typename T, int D>
int rows_per_block(int T_keys, int nbasis, int bandsize, int limit) {
  if (D == STREAMED) return 32;
  if (smem_bytes<T, D>(64, T_keys, nbasis, bandsize) <= (size_t)limit) return 64;
  if (D > 192 && smem_bytes<T, D>(32, T_keys, nbasis, bandsize) > (size_t)limit) return 16;
  return 32;
}

int smem_limit(int* limit) {
  int dev = 0;
  cudaGetDevice(&dev);
  return (int)cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

template <typename T, int D>
int launch_rows(const void* q, const void* k, const void* v, const float* R, const float* b_nd,
                const uint8_t* mask, void* out, float* scratch, int B, int H, int t, int T_keys, int d, int nbasis,
                int bandsize, float alpha, cudaStream_t stream) {
  int limit = 0;
  const int err = smem_limit(&limit);
  if (err != 0) return err;
  const int rows = rows_per_block<T, D>(T_keys, nbasis, bandsize, limit);
  if constexpr (D != STREAMED) {
    if (rows == 64)
      return launch<T, D, 64>(q, k, v, R, b_nd, mask, out, scratch, B, H, t, T_keys, d, nbasis, bandsize, alpha,
                              stream);
  }
  if constexpr (D > 192) {
    if (rows == 16)
      return launch<T, D, 16>(q, k, v, R, b_nd, mask, out, scratch, B, H, t, T_keys, d, nbasis, bandsize, alpha,
                              stream);
  }
  return launch<T, D, 32>(q, k, v, R, b_nd, mask, out, scratch, B, H, t, T_keys, d, nbasis, bandsize, alpha, stream);
}

// f32 scratch floats a call needs: the output's (B, H, t, d) accumulators at
// the streamed d past KEY_CHUNK keys, else none
size_t scratch_floats(int B, int H, int t, int T_keys, int d) {
  return streamed_d(d) && T_keys > KEY_CHUNK ? (size_t)B * H * t * d : 0;
}

}  // namespace

// q (B, H, t, d), k and v (B, H, T, d), d any multiple of 64, any T:
// contiguous and 16-byte aligned, all f32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1).  R (B, H, t, nbasis) f32 and b_nd (nbasis, bandsize) f32,
// any bandsize, both null for no relative bias.  mask (B, t, T) bool bytes,
// null for no mask.  out (B, H, t, d) in q's dtype.  scratch: f32 of
// vpt_windowed_attention_fwd_scratch floats (null where that is 0).
// Returns a cudaError_t (0 = launched).
extern "C" int vpt_windowed_attention_fwd(const void* q, const void* k, const void* v, const float* R,
                                          const float* b_nd, const uint8_t* mask, void* out, float* scratch, int B,
                                          int H, int t, int T, int d, int nbasis, int bandsize, int is_bf16,
                                          float alpha, void* stream) {
  if (B < 1 || H < 1 || t < 1 || T < 1 || !kernel_d(d)) return (int)cudaErrorInvalidValue;
  if ((R == nullptr) != (b_nd == nullptr)) return (int)cudaErrorInvalidValue;
  if (R != nullptr && (nbasis < 1 || nbasis > MAX_NBASIS || bandsize < 1))
    return (int)cudaErrorInvalidValue;
  if (scratch == nullptr && scratch_floats(B, H, t, T, d) > 0) return (int)cudaErrorInvalidValue;
  if (R == nullptr) nbasis = bandsize = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_depth(d, [&](auto depth) {
    constexpr int D = decltype(depth)::value;
    if (is_bf16)
      return launch_rows<__nv_bfloat16, D>(q, k, v, R, b_nd, mask, out, scratch, B, H, t, T, d, nbasis, bandsize,
                                           alpha, s);
    return launch_rows<float, D>(q, k, v, R, b_nd, mask, out, scratch, B, H, t, T, d, nbasis, bandsize, alpha, s);
  });
}

// The f32 scratch, in floats, that vpt_windowed_attention_fwd needs at this shape.
extern "C" long long vpt_windowed_attention_fwd_scratch(int B, int H, int t, int T, int d) {
  return (long long)scratch_floats(B, H, t, T, d);
}

// The dynamic shared memory, in bytes, of the forward's launch at this shape
// (it does not depend on t or B and H); a negative cudaError_t on failure.
extern "C" int vpt_windowed_attention_fwd_smem(int T, int d, int nbasis, int bandsize, int is_bf16) {
  int limit = 0;
  const int err = smem_limit(&limit);
  if (err != 0) return -err;
  if (T < 1 || !kernel_d(d)) return -(int)cudaErrorInvalidValue;
  return with_depth(d, [&](auto depth) {
    constexpr int D = decltype(depth)::value;
    if (is_bf16) {
      return (int)smem_bytes<__nv_bfloat16, D>(rows_per_block<__nv_bfloat16, D>(T, nbasis, bandsize, limit), T,
                                               nbasis, bandsize);
    }
    return (int)smem_bytes<float, D>(rows_per_block<float, D>(T, nbasis, bandsize, limit), T, nbasis, bandsize);
  });
}

extern "C" const char* vpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
