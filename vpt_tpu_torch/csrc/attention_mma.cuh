// Warp-level tensor-core products shared by the windowed-attention kernels
// B1 (windowed_attention_fwd.cu) and B2 (windowed_attention_bwd.cu).
//
// Every product is mma.sync on 16-row warp tiles, fed from shared memory:
//   * bf16 x bf16 products: one m16n8k16 bf16 mma, f32 accumulate (exact
//     products, so the accuracy of the bf16 inputs);
//   * products with an f32 operand: m16n8k8 TF32 mmas on a split
//     x = hi + lo, hi = tf32(x), lo = x - hi (to_tf32), accumulating
//     a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32.  The dropped a_lo*b_lo term
//     and lo's own rounding are ~2^-21 of the product, so the sum keeps
//     float32 accuracy (not its last bits, but far inside 1e-4) whatever
//     torch.backends.cuda.matmul.allow_tf32 says.  A bf16 operand is exact
//     in TF32 and needs no lo part: f32 x bf16 takes two mmas.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16), with
// g = lane / 4 and c = lane % 4: the f32 accumulator of a 16 x 8 tile holds
// (g, 2c), (g, 2c + 1), (g + 8, 2c), (g + 8, 2c + 1).  Shared-memory tiles of
// Q, K, V and dO keep rows of d + 4 floats or d + 8 bf16, 4 words mod 32, so
// the 32 lanes of a fragment load hit 32 banks; logit tiles keep rows of
// 8 words mod 32 for the same reason with 64-bit accesses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace wattn {

constexpr int MAX_NBASIS = 16;
constexpr int MAX_BAND = 512;   // longest band table (b_nd's second axis) held in shared memory
constexpr int KEY_CHUNK = 512;  // keys whose logits a row block holds in shared memory at once
constexpr int KEY_TILE = 64;             // keys per shared-memory tile of the row-block passes
constexpr int R_STRIDE = MAX_NBASIS + 1;  // row stride of the R tile (odd: rows on distinct banks)
constexpr float NEG_BIAS = -1e9f;

// row stride, in elements, of a (rows, D) tile of Q, K, V or dO in shared memory
template <typename T, int D>
__host__ __device__ constexpr int tile_stride() {
  return D + 16 / (int)sizeof(T);
}

// Head dims.  A kernel instance for D > 0 takes d = D whole: its tiles of Q,
// K, V and dO hold all D columns.  The instance for D = STREAMED takes every
// multiple of D_CHUNK above 256 at run time (hidsize 6144 at 16 heads, 1024
// at 1 head, any wider), with shared memory that does not depend on d: every
// tile holds D_CHUNK columns of its rows.  The products that sum over d (Q
// K^T, dO V^T, K Q^T, V dO^T) stream both operands chunk by chunk into the
// same accumulators; those whose result is d wide (W V, dL K, W^T dO, dL^T Q)
// take the result's columns a chunk at a time.
constexpr int STREAMED = 0;
constexpr int D_CHUNK = 64;

template <typename T, int D>
struct Depth {
  static constexpr bool STREAM = D == STREAMED;
  static constexpr int CHUNK = STREAM ? D_CHUNK : D;  // columns of a shared tile
  static constexpr int CS = tile_stride<T, CHUNK>();  // its row stride
  int d, chunks;  // the head dim and its chunks
  __host__ __device__ explicit Depth(int d_) : d(STREAM ? d_ : D), chunks(STREAM ? d_ / D_CHUNK : 1) {}
  // elements of a row block's row tile: its Q (or dO) rows whole, none when streamed
  __host__ __device__ static constexpr int row_tile(int rows) { return STREAM ? 0 : rows * CS; }
  // elements of each of a row block's two key-tile buffers: a tile of K or V
  // and, when streamed, the same chunk of the block's Q (or dO) rows beside it
  __host__ __device__ static constexpr int kv_buffer(int rows) { return (KEY_TILE + (STREAM ? rows : 0)) * CS; }
};

// the head dims the kernels take: every multiple of D_CHUNK
inline bool kernel_d(int d) { return d > 0 && d % D_CHUNK == 0; }
// those that run the streamed instance: every multiple of D_CHUNK above 256
inline bool streamed_d(int d) { return kernel_d(d) && d > 256; }

// f(std::integral_constant<int, D>()) for the instance that takes head dim d
// (kernel_d(d) holds): D = d at 64, 128, 192 and 256, else D = STREAMED
template <typename F>
auto with_depth(int d, F&& f) {
  switch (d) {
    case 64:
      return f(std::integral_constant<int, 64>());
    case 128:
      return f(std::integral_constant<int, 128>());
    case 192:
      return f(std::integral_constant<int, 192>());
    case 256:
      return f(std::integral_constant<int, 256>());
    default:
      return f(std::integral_constant<int, STREAMED>());
  }
}

// floats of shared memory that hold the band table: the whole (nbasis,
// bandsize) table up to MAX_BAND offsets, none past that.  A longer table
// (attention_memory_size - timesteps > 512) stays in device memory, where
// the warps read it through L1 and L2 (with_band_table).
__host__ __device__ inline int band_smem_floats(int nbasis, int bandsize) {
  return bandsize <= MAX_BAND ? (nbasis * bandsize + 3) / 4 * 4 : 0;
}

// body(table) on the band table where it sits: the shared copy sB up to
// MAX_BAND offsets, else b_nd in device memory.  A branch, not a select of
// the two pointers: a pointer that may be either is read with generic
// loads, slower than the shared path's shared loads.
template <typename Body>
__device__ __forceinline__ void with_band_table(const float* sB, const float* b_nd, int bandsize, Body&& body) {
  if (bandsize <= MAX_BAND) {
    body(sB);
  } else {
    body(b_nd);
  }
}

// the shared copy to fill with the band table, or null where it stays in device memory
__device__ __forceinline__ float* band_copy(float* sB, int bandsize) { return bandsize <= MAX_BAND ? sB : nullptr; }

// row stride, in floats, of a logit tile over T keys padded to whole key tiles
__host__ __device__ inline int logit_stride(int T) {
  return (T + KEY_TILE - 1) / KEY_TILE * KEY_TILE + 8;
}

// x = hi + lo in TF32: hi is x rounded to TF32's 10 mantissa bits (|lo| <=
// 2^-11 |x|), lo the rest, exact in f32.  The tensor cores read the top 19
// bits of a TF32 operand and drop the low 13, which cuts lo to 2^-21 |x|.
// Three integer and f32 operations, no conversion instruction.  A bf16
// value is exact (lo = 0 and unused).
__device__ __forceinline__ void to_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void to_tf32(__nv_bfloat16 x, uint32_t& hi, uint32_t& lo) {
  hi = (uint32_t)__bfloat16_as_ushort(x) << 16;
  lo = 0u;
}

template <typename T>
struct exact_in_tf32 {
  static constexpr bool value = false;
};
template <>
struct exact_in_tf32<__nv_bfloat16> {
  static constexpr bool value = true;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lower half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b from split operands, the small cross terms first
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_split(float (&c)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                          const uint32_t (&bhi)[2], const uint32_t (&blo)[2]) {
  if constexpr (!A_EXACT) mma_tf32(c, alo, bhi);
  if constexpr (!B_EXACT) mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

// acc[n] (16 x 8) += A B^T over the depth D: A is 16 rows of a tile (row
// stride lda), B is NT * 8 rows of a tile (row stride ldb), both row-major
// in D.  "NT": the logits Q K^T and dO V^T, and in B2's key pass K Q^T and
// V dO^T.
template <typename T, int D, int NT>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4], const T* a, int lda, const T* b, int ldb, int lane) {
  const int g = lane >> 2, c = lane & 3;
  if constexpr (exact_in_tf32<T>::value) {
    // bf16: k-steps of 16, pairs of bf16 along the depth in one 32-bit word
    const uint32_t* a0 = reinterpret_cast<const uint32_t*>(a + g * lda) + c;
    const uint32_t* a1 = reinterpret_cast<const uint32_t*>(a + (g + 8) * lda) + c;
    const uint32_t* b0 = reinterpret_cast<const uint32_t*>(b + g * ldb) + c;
    const int bstep = 4 * ldb;  // 8 rows, in words
#pragma unroll 2
    for (int k = 0; k < D / 2; k += 8) {
      const uint32_t af[4] = {a0[k], a1[k], a0[k + 4], a1[k + 4]};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t bf[2] = {b0[n * bstep + k], b0[n * bstep + k + 4]};
        mma_bf16(acc[n], af, bf);
      }
    }
  } else {
    const float* a0 = reinterpret_cast<const float*>(a) + g * lda + c;
    const float* b0 = reinterpret_cast<const float*>(b) + g * ldb + c;
#pragma unroll 2
    for (int k = 0; k < D; k += 8) {
      uint32_t ahi[4], alo[4];
      to_tf32(a0[k], ahi[0], alo[0]);
      to_tf32(a0[8 * lda + k], ahi[1], alo[1]);
      to_tf32(a0[k + 4], ahi[2], alo[2]);
      to_tf32(a0[8 * lda + k + 4], ahi[3], alo[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bhi[2], blo[2];
        to_tf32(b0[n * 8 * ldb + k], bhi[0], blo[0]);
        to_tf32(b0[n * 8 * ldb + k + 4], bhi[1], blo[1]);
        mma_split<false, false>(acc[n], ahi, alo, bhi, blo);
      }
    }
  }
}

// One k-step of 8 of acc (16 x NC) += A B with A in f32 and B from a tile.
// The step's 8 depth indices are taken in the order 0 2 4 6 1 3 5 7, so that
// a = {A(g, 2c), A(g + 8, 2c), A(g, 2c + 1), A(g + 8, 2c + 1)} is both a
// pair of 64-bit loads from a logit tile and an accumulator fragment
// {c0, c2, c1, c3} of a previous product as it stands.  b points at B's
// element (2c, g) of the step (row stride ldb); B is f32 (three mmas) or
// bf16 (two).
template <typename T, int NC>
__device__ __forceinline__ void mma_nn_step(float (&acc)[NC / 8][4], const float (&a)[4], const T* b, int ldb) {
  uint32_t ahi[4], alo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) to_tf32(a[e], ahi[e], alo[e]);
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    uint32_t bhi[2], blo[2];
    to_tf32(b[n * 8], bhi[0], blo[0]);
    to_tf32(b[ldb + n * 8], bhi[1], blo[1]);
    mma_split<false, exact_in_tf32<T>::value>(acc[n], ahi, alo, bhi, blo);
  }
}

// acc (16 x NC) += A B over one key tile of KEY_TILE keys, A the f32 logit
// tile's 16 rows from column 0 of the tile (row stride lda), B the key tile
// (row stride ldb) from column 0 of the wanted columns.
template <typename T, int NC>
__device__ __forceinline__ void mma_nn_tile(float (&acc)[NC / 8][4], const float* a, int lda, const T* b, int ldb,
                                            int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll 2
  for (int k = 0; k < KEY_TILE; k += 8) {
    const float2 top = *reinterpret_cast<const float2*>(a + g * lda + k + 2 * c);
    const float2 bot = *reinterpret_cast<const float2*>(a + (g + 8) * lda + k + 2 * c);
    const float af[4] = {top.x, bot.x, top.y, bot.y};
    mma_nn_step<T, NC>(acc, af, b + (k + 2 * c) * ldb + g, ldb);
  }
}

// acc (16 x NC) += bf16(A) B over one key tile, A already rounded to bf16
// values (B1's softmax weights in bf16 mode) and B a bf16 tile: one bf16 mma
// per 16 keys.
template <int NC>
__device__ __forceinline__ void mma_nn_tile_bf16(float (&acc)[NC / 8][4], const float* a, int lda,
                                                 const __nv_bfloat16* b, int ldb, int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll 2
  for (int k = 0; k < KEY_TILE; k += 16) {
    const float* r0 = a + g * lda + k + 2 * c;
    const float* r1 = r0 + 8 * lda;
    const float2 x0 = *reinterpret_cast<const float2*>(r0), x1 = *reinterpret_cast<const float2*>(r1);
    const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8), x3 = *reinterpret_cast<const float2*>(r1 + 8);
    const uint32_t af[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y), pack_bf16(x2.x, x2.y),
                            pack_bf16(x3.x, x3.y)};
    const __nv_bfloat16* b0 = b + (k + 2 * c) * ldb + g;
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
      const __nv_bfloat16* p = b0 + n * 8;
      const uint32_t bf[2] = {pack_bf16(p[0], p[ldb]), pack_bf16(p[8 * ldb], p[9 * ldb])};
      mma_bf16(acc[n], af, bf);
    }
  }
}

// D columns of rows [r0, r0 + nrows) of a row-major tensor of row stride
// src_ld (limit rows) into a shared tile of row stride `stride`, 16 bytes a
// copy with cp.async; rows at or past `limit` are zero.  The caller commits
// and waits (cp_async_commit, cp_async_wait).
template <typename T, int D>
__device__ __forceinline__ void load_rows_async(T* dst, int stride, const T* src, int r0, int nrows, int limit,
                                                int tid, int nthreads, int src_ld = D) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int idx = tid; idx < nrows * CHUNKS; idx += nthreads) {
    const int r = idx / CHUNKS, col = (idx % CHUNKS) * VEC;
    const bool valid = r0 + r < limit;
    const T* s = valid ? src + (size_t)(r0 + r) * src_ld + col : src;
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + r * stride + col);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(s), "r"(valid ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of the committed groups of copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// tile i (KEY_TILE rows from row i * KEY_TILE, zero past T_keys; D columns
// of rows src_ld apart) of a row-major tensor into buffer i % 2 of two,
// committed as one group
template <typename T, int D, int NTHREADS>
__device__ __forceinline__ void prefetch_tile(T* bufs, const T* src, int T_keys, int i, int src_ld = D) {
  constexpr int DS = tile_stride<T, D>();
  load_rows_async<T, D>(bufs + (i & 1) * KEY_TILE * DS, DS, src, i * KEY_TILE, KEY_TILE, T_keys, threadIdx.x,
                        NTHREADS, src_ld);
  cp_async_commit();
}

// Stream the tiles of D columns of a row-major (T_keys, src_ld) tensor
// through two shared buffers: tile i + 1 is in flight while body(first row,
// tile) works on tile i.  Every thread of the block calls it.  Tile 0 is
// fetched here unless the caller fetched it (prefetch_tile) to overlap it
// with earlier work; copies committed before the call complete before the
// first body.
template <typename T, int D, int NTHREADS, typename Body>
__device__ __forceinline__ void stream_tiles(T* bufs, const T* src, int T_keys, bool first_prefetched,
                                             Body&& body, int src_ld = D) {
  constexpr int DS = tile_stride<T, D>();
  const int ntiles = (T_keys + KEY_TILE - 1) / KEY_TILE;
  if (!first_prefetched) prefetch_tile<T, D, NTHREADS>(bufs, src, T_keys, 0, src_ld);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      prefetch_tile<T, D, NTHREADS>(bufs, src, T_keys, i + 1, src_ld);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(i * KEY_TILE, bufs + (i & 1) * KEY_TILE * DS);
    __syncthreads();  // the buffer is refilled next iteration
  }
}

// Sub-tile s of a product over d into buffer s % 2 of two (Depth::kv_buffer
// elements each), committed as one group: chunk s % chunks of key tile s /
// chunks (KEY_TILE rows, zero past T_keys) of a row-major (T_keys, d) tensor
// and, at the streamed D, the same chunk of rows [r0, r0 + ROWS) of the row
// operand rows_src (a row-major (limit, d) tensor) beside it.
template <typename T, int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void fetch_depth_tile(T* bufs, int s, const T* src, int T_keys, const Depth<T, D>& dp,
                                                 const T* rows_src, int r0, int limit) {
  using DT = Depth<T, D>;
  T* buf = bufs + (s & 1) * DT::kv_buffer(ROWS);
  const int ci = s % dp.chunks;
  load_rows_async<T, DT::CHUNK>(buf, DT::CS, src + ci * DT::CHUNK, (s / dp.chunks) * KEY_TILE, KEY_TILE, T_keys,
                                threadIdx.x, NTHREADS, dp.d);
  if constexpr (DT::STREAM) {
    load_rows_async<T, DT::CHUNK>(buf + KEY_TILE * DT::CS, DT::CS, rows_src + ci * DT::CHUNK, r0, ROWS, limit,
                                  threadIdx.x, NTHREADS, dp.d);
  }
  cp_async_commit();
}

// stream_tiles over the depth as well, for the products that sum over d (Q
// K^T, dO V^T): the sub-tiles of fetch_depth_tile, key tile by key tile and,
// within one, chunk by chunk; body(first key, chunk, key tile, rows) with
// rows the row operand's block rows at the chunk's column 0 (row stride
// Depth::CS): sRows, which holds them whole, at a whole D, the streamed
// chunk at the streamed D.  The caller's prefetch of sub-tile 0 is
// fetch_depth_tile(bufs, 0, ...).  At a whole D this is stream_tiles.
template <typename T, int D, int ROWS, int NTHREADS, typename Body>
__device__ __forceinline__ void stream_depth_tiles(T* bufs, const T* src, int T_keys, const Depth<T, D>& dp,
                                                   const T* sRows, const T* rows_src, int r0, int limit,
                                                   bool first_prefetched, Body&& body) {
  using DT = Depth<T, D>;
  const int n = (T_keys + KEY_TILE - 1) / KEY_TILE * dp.chunks;
  if (!first_prefetched) fetch_depth_tile<T, D, ROWS, NTHREADS>(bufs, 0, src, T_keys, dp, rows_src, r0, limit);
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) {
      fetch_depth_tile<T, D, ROWS, NTHREADS>(bufs, s + 1, src, T_keys, dp, rows_src, r0, limit);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tile = bufs + (s & 1) * DT::kv_buffer(ROWS);
    body((s / dp.chunks) * KEY_TILE, s % dp.chunks, tile, DT::STREAM ? tile + KEY_TILE * DT::CS : sRows);
    __syncthreads();  // the buffer is refilled next iteration
  }
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

// rows [r0, r0 + nrows) of R (rows, nbasis) into a tile of row stride
// R_STRIDE, zero past `limit`, and the (nbasis, bandsize) band table into sB
// (when sB is given), 4 bytes a copy with cp.async; the caller commits
template <int NTHREADS>
__device__ __forceinline__ void load_bias_inputs_async(float* sR, const float* R, int r0, int nrows, int limit,
                                                       int nbasis, float* sB, const float* b_nd, int bandsize) {
  for (int idx = threadIdx.x; idx < nrows * nbasis; idx += NTHREADS) {
    const int r = idx / nbasis, n = idx % nbasis;
    const bool valid = r0 + r < limit;
    copy4_async(sR + r * R_STRIDE + n, valid ? R + (size_t)(r0 + r) * nbasis + n : R, valid);
  }
  if (sB != nullptr) {
    for (int idx = threadIdx.x; idx < nbasis * bandsize; idx += NTHREADS) copy4_async(sB + idx, b_nd + idx, true);
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// sum over the four lanes of a quad (the lanes that share an accumulator row)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// one exchange of warp_sum16: a lane keeps values W .. 2W - 1 (lane bit 2W
// set) or 0 .. W - 1, adds its partner's of the same, and holds W values
template <int W>
__device__ __forceinline__ void exchange_half(float (&x)[16], int lane) {
  const bool upper = lane & (2 * W);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float send = upper ? x[k] : x[k + W];
    const float keep = upper ? x[k + W] : x[k];
    x[k] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * W);
  }
}

// The warp sums of 16 values at once in 16 shuffles (not 16 x 5): each
// exchange halves the values a lane keeps.  On return lanes 2n and 2n + 1
// hold the sum of value n over the warp.
__device__ __forceinline__ float warp_sum16(float (&x)[16], int lane) {
  exchange_half<8>(x, lane);
  exchange_half<4>(x, lane);
  exchange_half<2>(x, lane);
  exchange_half<1>(x, lane);
  return x[0] + __shfl_xor_sync(0xffffffffu, x[0], 1);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The f32 accumulator fragments of a (16, NC) tile to or from rows r0 + g,
// r0 + g + 8 (row h of the fragment) and columns c0 + 8n + 2c, + 1 of a
// row-major matrix of row stride ld, each row times scale[h]; rows at or
// past `limit` are skipped.  A thread reads back what it wrote: the streamed
// D's accumulators that wait in device memory between passes over keys or
// query rows, owned by one thread each.
template <int NC>
__device__ __forceinline__ void load_frags(float (&acc)[NC / 8][4], const float* m, size_t ld, int r0, int limit,
                                           int c0, const float (&scale)[2], int g, int c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    const float* row = m + (size_t)min(r, limit - 1) * ld + c0 + 2 * c;
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
      const float2 x = r < limit ? *reinterpret_cast<const float2*>(row + n * 8) : make_float2(0.f, 0.f);
      acc[n][2 * h] = x.x * scale[h];
      acc[n][2 * h + 1] = x.y * scale[h];
    }
  }
}

template <typename T, int NC>
__device__ __forceinline__ void store_frags(T* m, size_t ld, int r0, int limit, int c0,
                                            const float (&acc)[NC / 8][4], const float (&scale)[2], int g, int c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r < limit) {
      T* row = m + (size_t)r * ld + c0 + 2 * c;
#pragma unroll
      for (int n = 0; n < NC / 8; ++n) store2(row + n * 8, acc[n][2 * h] * scale[h], acc[n][2 * h + 1] * scale[h]);
    }
  }
}

// Row blocks (B1 and B2's first pass): ROWS query rows (64, or 32 or, at
// d = 256, 16 where shared memory demands; 32 at the streamed d), 16 to each
// group of SPLIT warps.  In the products
// over keys a group's warps take a SPLIT-th of every 64-key tile each; in
// the products over the depth d, a SPLIT-th of d each.  Four warps a group
// keep four warps on each of an SM's schedulers to hide each other's
// latencies.
template <int ROWS_>
struct RowBlock {
  static constexpr int ROWS = ROWS_;
  static constexpr int GROUPS = ROWS / 16;
  static constexpr int SPLIT = 4;
  static constexpr int NWARPS = GROUPS * SPLIT;
  static constexpr int NTHREADS = 32 * NWARPS;
  int warp, lane, g, c, row0, part;
  __device__ __forceinline__ RowBlock() {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    g = lane >> 2;
    c = lane & 3;
    row0 = (warp % GROUPS) * 16;  // the warp's first row of the block
    part = warp / GROUPS;         // which SPLIT-th of a key tile or of d
  }
};

// The mask terms of a window of a (rows, T) bool mask as floats: -1e9
// where row r0 + i forbids key c0 + j, else 0, for i < nrows and j < ncols;
// 0 for rows at or past `limit` (padding rows) or no mask.  ROW_MAJOR:
// out[i * ld + j], the row blocks' logit tile, where keys at or past T (the
// padding up to the tile edge) get -inf and so no weight in the softmax;
// else out[j * ld + i], the key pass's bias tile (keys along its rows),
// where they get 0.  Either way neighbouring threads write neighbouring
// words.  All the block's
// threads take part; the loads are unconditional (indices clamped into the
// mask) and 4 bytes at a time where rows and window are 4-byte aligned, so
// they are all in flight at once.
template <int NTHREADS, bool ROW_MAJOR>
__device__ __forceinline__ void mask_window(float* out, int ld, const uint8_t* mask_b, int r0, int nrows, int limit,
                                            int c0, int ncols, int T_keys) {
  const int tid = threadIdx.x;
  const float pad = ROW_MAJOR ? -CUDART_INF_F : 0.f;
  const bool words = mask_b != nullptr && ((uintptr_t)mask_b % 4 == 0) && T_keys % 4 == 0 && c0 % 4 == 0 &&
                     ncols % 4 == 0;
  if (words) {
    const int wcols = ncols / 4;
#pragma unroll 4
    for (int idx = tid; idx < nrows * wcols; idx += NTHREADS) {
      const int i = ROW_MAJOR ? idx / wcols : idx % nrows;
      const int j = 4 * (ROW_MAJOR ? idx % wcols : idx / nrows);
      const int row = min(r0 + i, limit - 1), col = min(c0 + j, T_keys - 4);
      const uint32_t w = *reinterpret_cast<const uint32_t*>(mask_b + (size_t)row * T_keys + col);
      const bool real = r0 + i < limit;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)  // T is a multiple of 4: the word's keys are all real or all padding
        x[e] = c0 + j >= T_keys ? pad : (real && !((w >> (8 * e)) & 0xffu)) ? NEG_BIAS : 0.f;
      if (ROW_MAJOR) {
        *reinterpret_cast<float4*>(out + i * ld + j) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) out[(j + e) * ld + i] = x[e];
      }
    }
  } else {
#pragma unroll 4
    for (int idx = tid; idx < nrows * ncols; idx += NTHREADS) {
      const int i = ROW_MAJOR ? idx / ncols : idx % nrows;
      const int j = ROW_MAJOR ? idx % ncols : idx / nrows;
      float x = c0 + j >= T_keys ? pad : 0.f;
      if (mask_b != nullptr) {
        const uint8_t keep = mask_b[(size_t)min(r0 + i, limit - 1) * T_keys + min(c0 + j, T_keys - 1)];
        if (r0 + i < limit && c0 + j < T_keys && !keep) x = NEG_BIAS;
      }
      out[ROW_MAJOR ? i * ld + j : j * ld + i] = x;
    }
  }
}

// The band bias added on the tensor cores: P = R b_nd, (rows x nbasis) x
// (nbasis x bandsize), b_nd read from sB (shared or device memory, see
// with_band_table), and P[i, dd] goes to key j = (T - t) + r0 + i - dd,
// so each key on the band gets sum_n R[r0 + i, n] b_nd[n, dd] once.  The
// target is out[i * ldi + (j - j0) * ldj] for the rows i < nrows (a
// multiple of 16; sR holds them, row stride R_STRIDE) and the keys j0 <= j <
// j0 + ncols, j < T.  The NWARPS warps share the (16 rows, 8 band offsets)
// tiles that reach those keys; nbasis is padded to 16 with zeros.
template <int NWARPS>
__device__ __forceinline__ void band_bias_mma(float* out, int ldi, int ldj, const float* sR, const float* sB, int r0,
                                              int nrows, int t, int T_keys, int j0, int ncols, int nbasis,
                                              int bandsize) {
  const int lane = threadIdx.x % 32, g = lane >> 2, c = lane & 3;
  const int off = (T_keys - t) + r0;  // band offset of row r0 and key 0
  const int dd_lo = max(0, off - (j0 + ncols - 1)), dd_hi = min(bandsize - 1, off + nrows - 1 - j0);
  if (dd_lo > dd_hi) return;
  const int groups = nrows / 16, tile0 = dd_lo / 8, ntiles = dd_hi / 8 - tile0 + 1;
  for (int task = threadIdx.x / 32; task < groups * ntiles; task += NWARPS) {
    const int row0 = (task % groups) * 16, nt = tile0 + task / groups;
    const float* ra = sR + (row0 + g) * R_STRIDE;
    const float* rb = ra + 8 * R_STRIDE;
    const int col = nt * 8 + g;  // the B fragment's band offset
    float acc[4] = {};
#pragma unroll
    for (int k = 0; k < MAX_NBASIS; k += 8) {
      if (k < nbasis) {  // uniform
        const int n0 = k + c, n1 = k + c + 4;
        uint32_t ahi[4], alo[4], bhi[2], blo[2];
        to_tf32(n0 < nbasis ? ra[n0] : 0.f, ahi[0], alo[0]);
        to_tf32(n0 < nbasis ? rb[n0] : 0.f, ahi[1], alo[1]);
        to_tf32(n1 < nbasis ? ra[n1] : 0.f, ahi[2], alo[2]);
        to_tf32(n1 < nbasis ? rb[n1] : 0.f, ahi[3], alo[3]);
        to_tf32(n0 < nbasis && col < bandsize ? sB[n0 * bandsize + col] : 0.f, bhi[0], blo[0]);
        to_tf32(n1 < nbasis && col < bandsize ? sB[n1 * bandsize + col] : 0.f, bhi[1], blo[1]);
        mma_split<false, false>(acc, ahi, alo, bhi, blo);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + g + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dd = nt * 8 + 2 * c + e;
        const int j = off + i - dd;
        if (dd < bandsize && j >= j0 && j < j0 + ncols && j < T_keys) out[i * ldi + (j - j0) * ldj] += acc[2 * h + e];
      }
    }
  }
}

// The logits of the block's rows: alpha Q K^T over 64-key tiles of K streamed
// through sKV (two buffers; at the streamed D, each tile chunk by chunk of
// its columns, with the same chunk of the block's Q rows), added to the logit
// tile that mask_window and band_bias_mma filled.  sQ holds the block's query
// rows whole at a whole D; qb is this (b, h)'s Q (t rows, the block's from
// q0) and kb its K (sub-tile 0 already fetched where first_prefetched).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void block_logits(float* sS, int TS, const T* sQ, T* sKV, const T* kb, const T* qb,
                                             int q0, int t, int T_keys, const Depth<T, D>& dp, float alpha,
                                             bool first_prefetched) {
  using Block = RowBlock<ROWS>;
  using DT = Depth<T, D>;
  constexpr int KP = KEY_TILE / Block::SPLIT;  // keys of a tile a warp takes
  const Block rb;
  float acc[KP / 8][4];
  stream_depth_tiles<T, D, ROWS, Block::NTHREADS>(sKV, kb, T_keys, dp, sQ, qb, q0, t, first_prefetched,
                                                  [&](int kt0, int ci, const T* tile, const T* rows) {
    if (ci == 0) {
#pragma unroll
      for (int n = 0; n < KP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
    mma_nt<T, DT::CHUNK, KP / 8>(acc, rows + rb.row0 * DT::CS, DT::CS, tile + rb.part * KP * DT::CS, DT::CS, rb.lane);
    if (ci == dp.chunks - 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = sS + (rb.row0 + rb.g + 8 * h) * TS + kt0 + rb.part * KP + 2 * rb.c;
#pragma unroll
        for (int n = 0; n < KP / 8; ++n) {
          const float2 x = *reinterpret_cast<const float2*>(row + n * 8);
          store2(row + n * 8, acc[n][2 * h] * alpha + x.x, acc[n][2 * h + 1] * alpha + x.y);
        }
      }
    }
  });
}

// softmax of the block's rows of the logit tile in place, a warp to two rows
// at a time (their dependent chains interleave); W is rounded to bf16 values
// where ROUND_BF16.  Where row_max and row_sum are given, lane 0 stores each
// real row's max and sum there as they are (not as a log-sum-exp: a fully
// masked row, all logits near -1e9, keeps its offsets exactly).
template <int ROWS, bool ROUND_BF16>
__device__ __forceinline__ void softmax_rows(float* sS, int TS, int q0, int t, float* row_max, float* row_sum) {
  using Block = RowBlock<ROWS>;
  constexpr int PER_LANE = KEY_CHUNK / 32;
  constexpr int AT_ONCE = 2;
  static_assert(ROWS % (Block::NWARPS * AT_ONCE) == 0, "rows split evenly over the warps");
  const Block rb;
  const int Tp = TS - 8;
  for (int r0 = rb.warp * AT_ONCE; r0 < ROWS; r0 += Block::NWARPS * AT_ONCE) {
    float x[AT_ONCE][PER_LANE], m[AT_ONCE], s[AT_ONCE];
#pragma unroll
    for (int a = 0; a < AT_ONCE; ++a) {
      m[a] = -CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        x[a][k] = 32 * k < Tp ? sS[(r0 + a) * TS + rb.lane + 32 * k] : -CUDART_INF_F;  // uniform condition
        m[a] = fmaxf(m[a], x[a][k]);
      }
      m[a] = warp_max(m[a]);
    }
#pragma unroll
    for (int a = 0; a < AT_ONCE; ++a) {
      s[a] = 0.f;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        if (32 * k < Tp) {
          x[a][k] = expf(x[a][k] - m[a]);  // 0 for the padding keys
          s[a] += x[a][k];
        }
      }
      s[a] = warp_sum(s[a]);
    }
#pragma unroll
    for (int a = 0; a < AT_ONCE; ++a) {
      // one reciprocal a row: a division whose dividend underflowed to 0 (a
      // masked key) takes the division's slow path
      const float inv = 1.f / s[a];
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        const float w = x[a][k] * inv;
        if (32 * k < Tp) sS[(r0 + a) * TS + rb.lane + 32 * k] = ROUND_BF16 ? __bfloat162float(__float2bfloat16(w)) : w;
      }
      const int gi = q0 + r0 + a;
      if (row_max != nullptr && rb.lane == 0 && gi < t) {
        row_max[gi] = m[a];
        row_sum[gi] = s[a];
      }
    }
  }
}

// One chunk of KEY_CHUNK keys of an online softmax (keys past KEY_CHUNK): the
// logit tile holds the chunk's logits of the block's rows, and row_max and
// row_sum the rows' max and sum over the keys of the earlier chunks (-inf
// and 0 before the first).  Each row's max moves to cover the chunk, its sum
// is rescaled by exp(old max - new max) (stored in row_scale where given, for
// the caller's accumulators) and gains the chunk's exp(logit - new max),
// which replace the logits in place where STORE.  A warp to two rows at a
// time, as softmax_rows; the padding keys (-inf) get 0.
template <int ROWS, bool STORE>
__device__ __forceinline__ void softmax_rows_online(float* sS, int TS, float* row_max, float* row_sum,
                                                    float* row_scale) {
  using Block = RowBlock<ROWS>;
  constexpr int PER_LANE = KEY_CHUNK / 32;
  constexpr int AT_ONCE = 2;
  static_assert(ROWS % (Block::NWARPS * AT_ONCE) == 0, "rows split evenly over the warps");
  const Block rb;
  const int Tp = TS - 8;
  for (int r0 = rb.warp * AT_ONCE; r0 < ROWS; r0 += Block::NWARPS * AT_ONCE) {
    float x[AT_ONCE][PER_LANE], m_old[AT_ONCE], m[AT_ONCE], s[AT_ONCE];
#pragma unroll
    for (int a = 0; a < AT_ONCE; ++a) {
      m_old[a] = row_max[r0 + a];
      m[a] = m_old[a];
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        x[a][k] = 32 * k < Tp ? sS[(r0 + a) * TS + rb.lane + 32 * k] : -CUDART_INF_F;  // uniform condition
        m[a] = fmaxf(m[a], x[a][k]);
      }
      m[a] = warp_max(m[a]);
    }
#pragma unroll
    for (int a = 0; a < AT_ONCE; ++a) {
      s[a] = 0.f;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        if (32 * k < Tp) {
          x[a][k] = expf(x[a][k] - m[a]);
          s[a] += x[a][k];
        }
      }
      s[a] = warp_sum(s[a]);  // every lane has read row_max and row_sum before lane 0 writes them
    }
#pragma unroll
    for (int a = 0; a < AT_ONCE; ++a) {
      if constexpr (STORE) {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
          if (32 * k < Tp) sS[(r0 + a) * TS + rb.lane + 32 * k] = x[a][k];
        }
      }
      if (rb.lane == 0) {
        const float scale = expf(m_old[a] - m[a]);  // 0 before the first chunk
        row_sum[r0 + a] = row_sum[r0 + a] * scale + s[a];
        row_max[r0 + a] = m[a];
        if (row_scale != nullptr) row_scale[r0 + a] = scale;
      }
    }
  }
}

// The softmax weights of one chunk from its logits in place, given each
// row's max and sum over all the keys: W = exp(logit - max) * (1 / sum), the
// arithmetic of softmax_rows and of B2's key pass.  A warp to a row.
template <int ROWS>
__device__ __forceinline__ void normalize_rows(float* sS, int TS, const float* row_max, const float* row_sum) {
  using Block = RowBlock<ROWS>;
  const Block rb;
  const int Tp = TS - 8;
  for (int r = rb.warp; r < ROWS; r += Block::NWARPS) {
    const float m = row_max[r], inv = 1.f / row_sum[r];
    for (int j = rb.lane; j < Tp; j += 32) sS[r * TS + j] = expf(sS[r * TS + j] - m) * inv;
  }
}

}  // namespace wattn
