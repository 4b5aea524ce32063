// Forward of an f32 3x3 convolution (stride 1, padding 1, NCHW) on Hopper's
// tensor cores at float32 accuracy, with the layer's bias and ReLU: kernel C1.
//
// C1 replaces no TPU kernel: the JAX package leaves its convolutions to XLA,
// so no Pallas kernel of vpt_tpu stands behind them.  It was added because
// the Impala CNN's f32 convolutions are where the port's f32 cells spend
// their time, and cuDNN runs them (TF32 off) on CUDA cores, whose FFMA peak
// is 67 TFLOP/s, or through its FFT engine.
//
// y[n, k, p] = relu(bias[k] + sum_{c, tap} x[n, c, p + tap] * w[k, c, tap])
// is an implicit GEMM with M = N*H*W output pixels, N = C_out and K = 9*C_in.
// What bounds it on this card: the products.  At the IDM's first conv (1,024
// frames, 128 -> 256 channels at 128x128) one call is 9.9 TFLOP against
// 25.8 GB of input and output, so at f32 accuracy on the tensor cores (three
// TF32 products at 495 TFLOP/s, 165 TFLOP/s of f32 work) the products need
// 60 ms and the bytes 7.7 ms at 3.35 TB/s.  The design:
//   * accuracy: every product is a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, where
//     x = hi + lo, hi = x rounded to TF32 and lo = the rest rounded to TF32
//     (split_tf32), as B1 and B2 split their f32 operands
//     (csrc/attention_mma.cuh); lo is rounded here, not left to the tensor
//     cores' truncation.  The dropped a_lo*b_lo and lo's rounding are ~2^-22
//     of a product.  Never one TF32 product, and nothing depends on torch's
//     allow_tf32 flags;
//   * the sum: the tensor cores' accumulation truncates, so a sum over all
//     of K kept there drifts one way as K grows (8-20x cuDNN's f32 error at
//     the CNN's shapes).  Each chunk of 8 input channels (27 products of 8
//     terms) is summed on the tensor cores from zero into `part`, which is
//     then added to the running sum `acc` in f32 registers, rounded to
//     nearest: C1's error is then 0.3-0.6x cuDNN's (PERF.md section 6);
//   * the products are wgmma m64nBNk8 TF32 instructions: A (pixels x
//     channels) from registers, B (channels x output channels) from shared
//     memory.  TF32 wgmma reads only K-major operands from shared memory, and
//     an NCHW strip is pixel-major; from registers A's layout is free.  Each
//     warp loads its A fragments from the strip and splits them in
//     registers, then its warpgroup issues the three products;
//   * a block is two warpgroups that own 128 * MW consecutive output pixels
//     of one image and BN output channels: template instances (BN, MW) =
//     (128, 1), (96, 2) and (64, 2), picked from C_out and the image width
//     (pick_tiles).  For every chunk of 8 input channels a strip of the
//     input rows the tile covers plus its one-row, one-column halo comes
//     into shared memory once (cp.async, zero-filled past the image's edges
//     and past C_in), and the nine taps read it as shifted views: each input
//     value crosses device memory once per tile, not nine times.  Channel
//     planes of the strip sit 8 words mod 32 apart, so the 32 lanes of a
//     fragment load hit 32 banks;
//   * the weights are split into TF32 hi and lo planes once per call by
//     split_weights_kernel, into a scratch the wrapper allocates, already in
//     the order a stage holds them: per (BN-channel tile, channel chunk) one
//     contiguous block of [plane][tap][4-channel half][BN/8][8][4], the
//     K-major, unswizzled layout of wgmma's B operand (8x16-byte core
//     matrices: 128 bytes to the next 8 output channels, 16*BN bytes to the
//     next 4 input channels);
//   * two stages in a ring: the next chunk's strip and weights load while
//     the warps multiply this one's.  Each tap's A fragments are split while
//     the previous tap's products run (wgmma.wait_group 1);
//   * the epilogue adds the bias, where the layer has one, applies the
//     ReLU, and writes NCHW: each store of a warp fills whole 32-byte
//     sectors (8 consecutive pixels of 4 channels);
//   * no atomics and no workspace beyond the split weights: every output is
//     summed by one thread in one order, so two calls give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int THREADS = 256;  // two warpgroups
constexpr int KC = 8;         // input channels a stage holds: one k8 step a tap
constexpr int TAPS = 9;
constexpr int STAGES = 2;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use on the H100

// floats of one stage's split weights: [plane 2][tap 9][KC channels][BN]
__host__ __device__ constexpr int wstage_floats(int bn) { return 2 * TAPS * KC * bn; }

// x = hi + lo, both TF32 (the low 13 mantissa bits zero), each rounded to
// nearest with ties away from zero, as cvt.rna.tf32.f32 rounds
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of an accumulator across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma's shared-memory matrix descriptor, no swizzle: start address, LBO
// (the next core matrix along K) and SBO (the next 8 rows along N), in
// 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return (uint64_t)((addr >> 4) & 0x3fff) | ((uint64_t)((lbo_bytes >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3fff) << 32);
}

// d (64 x BN, f32) += a (64 x 8, TF32, registers) * b (8 x BN, TF32, shared
// memory, K-major).  Fragment of a, with g = lane / 4, t = lane % 4 and w the
// warp of the warpgroup: a[0] (16w + g, t), a[1] (16w + g + 8, t), a[2]
// (16w + g, t + 4), a[3] (16w + g + 8, t + 4).  Accumulator: d[4j + v] is
// (16w + g + 8 (v / 2), 8j + 2t + v % 2).
template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

// the shape of one call, with its tiles and strip geometry
struct Geometry {
  int N, C, K, H, W;
  int bn;       // output channels a block owns
  int mw;       // 64-pixel row blocks a warpgroup owns: a block owns 128 * mw output pixels
  int nchunks;  // channel chunks: ceil(C / KC)
  int ntiles;   // output-channel tiles: ceil(K / BN)
  int tiles;    // pixel tiles of one image: ceil(H * W / (128 * mw))
  int rows;     // strip rows: the rows a tile's pixels span, and the halo row above and below
  int sw;       // strip row stride: W + 8 floats, image columns at 4 .. W + 3, the halo at 3 and W + 4
  int plane;    // strip channel stride: rows * sw or more, 8 mod 32
};

__host__ __device__ constexpr int stage_floats(const Geometry& g, int bn) {
  return KC * g.plane + wstage_floats(bn);
}

// The weights (K, C, 3, 3) split into TF32 hi and lo planes, in the order the
// stages load them: [K tile][channel chunk][plane][tap][4-channel half][BN / 8][8][4],
// zero past K and C.
__global__ void split_weights_kernel(const float* __restrict__ w, float* __restrict__ out, int C, int K,
                                     int nchunks, int bn, int64_t total) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int e = (int)(i % 4), r = (int)((i / 4) % 8);
  const int64_t cores = i / 32;
  const int ncore = (int)(cores % (bn / 8));
  const int64_t rest = cores / (bn / 8);
  const int half = (int)(rest % 2), tap = (int)((rest / 2) % TAPS), plane = (int)((rest / (2 * TAPS)) % 2);
  const int64_t blocks = rest / (4 * TAPS);
  const int chunk = (int)(blocks % nchunks), nt = (int)(blocks / nchunks);
  const int n = nt * bn + ncore * 8 + r, c = chunk * KC + half * 4 + e;
  const float v = (n < K && c < C) ? w[((int64_t)n * C + c) * TAPS + tap] : 0.f;
  const uint32_t hi = rna_tf32(v);
  out[i] = __uint_as_float(plane == 0 ? hi : rna_tf32(v - __uint_as_float(hi)));
}

template <int BN, int MW>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wsplit,
                       const float* __restrict__ bias, float* __restrict__ y, const Geometry g, const int relu) {
  constexpr int BM = 128 * MW;  // output pixels a block owns
  extern __shared__ __align__(128) float smem[];
  const int sf = stage_floats(g, BN);
  const int tid = threadIdx.x;
  const int nt = blockIdx.x % g.ntiles;
  const int pt = blockIdx.x / g.ntiles;
  const int img = pt / g.tiles;
  const int p_first = (pt - img * g.tiles) * BM;  // the tile's first output pixel in its image
  const int row0 = p_first / g.W;                  // its first output row; strip row 0 is input row row0 - 1
  const int HW = g.H * g.W;

  // the halo columns, which no load writes, are zero in every stage
  for (int i = tid; i < STAGES * KC * g.rows; i += THREADS) {
    float* row = smem + (i / (KC * g.rows)) * sf + ((i / g.rows) % KC) * g.plane + (i % g.rows) * g.sw;
    row[3] = 0.f;
    row[g.W + 4] = 0.f;
  }

  const int w4 = g.W / 4;
  const int per_ch = g.rows * w4;
  // stage s <- channel chunk c: the strip 16 bytes a copy (zeros above and
  // below the image and past C), then the chunk's split weights, contiguous
  auto load_stage = [&](int c, int s) {
    float* in = smem + s * sf;
    for (int i = tid; i < KC * per_ch; i += THREADS) {
      const int j = i / per_ch, rem = i - j * per_ch, r = rem / w4, seg = rem - r * w4;
      const int ch = c * KC + j, inrow = row0 - 1 + r;
      const bool ok = ch < g.C && inrow >= 0 && inrow < g.H;
      const float* src = ok ? x + ((((int64_t)img * g.C + ch) * g.H + inrow) * g.W + 4 * seg) : x;
      cp_async16(in + j * g.plane + r * g.sw + 4 + 4 * seg, src, ok ? 16 : 0);
    }
    float* wdst = in + KC * g.plane;
    const float* wsrc = wsplit + (int64_t)(nt * g.nchunks + c) * wstage_floats(BN);
    for (int i = tid; i < wstage_floats(BN) / 4; i += THREADS) cp_async16(wdst + 4 * i, wsrc + 4 * i, 16);
  };

  // this thread's fragment rows: pixels p_first + (wg * MW + i) * 64 + 16 * warp + lane / 4 (+ 8),
  // as strip offsets of (pixel, channel lane % 4) at tap (0, 0); channel + 4 lies 4 planes on
  const int lane = tid % 32, warp = (tid / 32) % 4, wg = tid / 128;
  int q[MW][2];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p_first + (wg * MW + i) * 64 + 16 * warp + lane / 4 + 8 * h;
      const int r = p / g.W;
      q[i][h] = (lane % 4) * g.plane + (r - row0) * g.sw + (p - r * g.W) + 3;
    }
  }
  const int q4 = 4 * g.plane;

  // acc: the sum over the finished channel chunks, in f32 registers; part:
  // this chunk's, on the tensor cores
  float acc[MW][BN / 2], part[MW][BN / 2];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[i][j] = part[i][j] = 0.f;
    fence_regs(part[i]);
  }

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < g.nchunks) load_stage(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < g.nchunks; ++c) {
    const int s = c % STAGES;
    const int next = c + STAGES - 1;
    if (next < g.nchunks) load_stage(next, next % STAGES);  // into the stage the last chunk used
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this chunk's copies have landed
    fence_proxy_async();
    __syncthreads();
    const float* in = smem + s * sf;
    // B of (plane, tap) starts (plane * 9 + tap) * 8 * BN floats on: 2 * BN 16-byte units
    const uint64_t desc0 = make_desc(smem_addr(in + KC * g.plane), 16 * BN, 128);
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const float* a = in + (tap / 3) * g.sw + tap % 3;
      uint32_t ahi[MW][4], alo[MW][4];
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        split_tf32(a[q[i][0]], ahi[i][0], alo[i][0]);
        split_tf32(a[q[i][1]], ahi[i][1], alo[i][1]);
        split_tf32(a[q[i][0] + q4], ahi[i][2], alo[i][2]);
        split_tf32(a[q[i][1] + q4], ahi[i][3], alo[i][3]);
      }
      const uint64_t bhi = desc0 + (uint64_t)(tap * 2 * BN);
      const uint64_t blo = desc0 + (uint64_t)((TAPS + tap) * 2 * BN);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < MW; ++i) {  // the small cross terms first; a chunk's first product overwrites part
        Wgmma<BN>::mma(part[i], alo[i], bhi, tap > 0);
        Wgmma<BN>::mma(part[i], ahi[i], blo, 1);
        Wgmma<BN>::mma(part[i], ahi[i], bhi, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the last tap's products are done: their A registers are free
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      fence_regs(part[i]);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[i][j] += part[i][j];
    }
    __syncthreads();  // every warpgroup is done with stage s before a later chunk loads into it
  }

#pragma unroll
  for (int i = 0; i < MW; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p_first + (wg * MW + i) * 64 + 16 * warp + lane / 4 + 8 * h;
      if (p >= HW) continue;
      float* out = y + (int64_t)img * g.K * HW + p;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int n = nt * BN + 8 * j + 2 * (lane % 4) + v;
          if (n >= g.K) continue;
          float val = acc[i][4 * j + 2 * h + v];
          if (bias != nullptr) val += bias[n];
          if (relu && val < 0.f) val = 0.f;
          out[(int64_t)n * HW] = val;
        }
      }
    }
  }
}

// The tiles, picked from C_out and the image width.  Output channels: the
// tile of 96, 128 or 64 that pads K least, in that order on a tie (96
// divides the 3x policy's 192 and 384, 128 the others' 128, 256 and 512).
// Pixels: 128-channel tiles take 128-pixel blocks (accumulators and their
// chunk partials fill 128 of a thread's registers either way) where a row
// is at most 64 pixels, so a block spans two rows or more and its halo adds
// at most as many rows as it holds; on wider rows 256-pixel blocks of 64
// channels take their place, whose two rows share their halo.  On the H100
// these were the faster at every main-path shape (PERF.md section 6).
void pick_tiles(int K, int W, int& bn, int& mw) {
  auto padded = [K](int t) { return (K + t - 1) / t * t; };
  bn = 96;
  for (int t : {128, 64}) {
    if (padded(t) < padded(bn)) bn = t;
  }
  mw = 2;
  if (bn == 128) {
    if (W <= 64) {
      mw = 1;
    } else {
      bn = 64;
    }
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

Geometry geometry(int N, int C, int K, int H, int W) {
  Geometry g{N, C, K, H, W};
  pick_tiles(K, W, g.bn, g.mw);
  const int bm = 128 * g.mw;
  g.nchunks = (C + KC - 1) / KC;
  g.ntiles = (K + g.bn - 1) / g.bn;
  g.tiles = (int)(((int64_t)H * W + bm - 1) / bm);
  // a tile starts at a multiple of bm: its first column is a multiple of gcd(bm, W), at most W - gcd
  g.rows = (bm - 1 + W - gcd(bm, W)) / W + 1 + 2;
  g.sw = W + 8;
  const int dense = g.rows * g.sw;
  g.plane = dense + ((8 - dense) % 32 + 32) % 32;
  return g;
}

int64_t smem_bytes(const Geometry& g) { return (int64_t)STAGES * stage_floats(g, g.bn) * 4; }

// a call C1 cannot make: cudaErrorInvalidValue
bool unsupported(int N, int C, int K, int H, int W) {
  if (N < 1 || C < 1 || K < 1 || H < 1 || W < 4 || W % 4 != 0 || W > 4096) return true;
  const Geometry g = geometry(N, C, K, H, W);
  return smem_bytes(g) > MAX_SMEM || (int64_t)g.ntiles * N * g.tiles > 0x7fffffff;
}

template <int BN, int MW>
cudaError_t launch(const float* x, const float* w, const float* bias, float* y, float* wsplit, const Geometry& g,
                   int relu, cudaStream_t stream) {
  const int64_t total = (int64_t)g.ntiles * g.nchunks * wstage_floats(BN);
  split_weights_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(w, wsplit, g.C, g.K, g.nchunks, BN,
                                                                           total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the limit belongs to the current device's context: set it on every launch
  err = cudaFuncSetAttribute(conv3x3_fwd_kernel<BN, MW>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((int64_t)g.ntiles * g.N * g.tiles);
  conv3x3_fwd_kernel<BN, MW><<<blocks, THREADS, (size_t)smem_bytes(g), stream>>>(x, wsplit, bias, y, g, relu);
  return cudaGetLastError();
}

}  // namespace

// floats of the split-weight scratch a call with C input and K output channels at width W needs
extern "C" int64_t vpt_conv3x3_fwd_scratch(int C, int K, int W) {
  int bn, mw;
  pick_tiles(K, W, bn, mw);
  return (int64_t)((K + bn - 1) / bn) * ((C + KC - 1) / KC) * wstage_floats(bn);
}

// y (N, K, H, W) = relu?(conv3x3(x (N, C, H, W), w (K, C, 3, 3), stride 1, padding 1) + bias (K) or 0),
// all f32, contiguous, x 16-byte aligned; wsplit holds vpt_conv3x3_fwd_scratch(C, K, W) floats.
// Returns the launches' CUDA error code (0 on success).
extern "C" int vpt_conv3x3_fwd(const float* x, const float* w, const float* bias, float* y, float* wsplit, int N,
                               int C, int K, int H, int W, int relu, void* stream) {
  if (unsupported(N, C, K, H, W)) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(N, C, K, H, W);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.bn == 128) return (int)launch<128, 1>(x, w, bias, y, wsplit, g, relu, s);
  if (g.bn == 96) return (int)launch<96, 2>(x, w, bias, y, wsplit, g, relu, s);
  return (int)launch<64, 2>(x, w, bias, y, wsplit, g, relu, s);
}

extern "C" const char* vpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
