// Fused double-conv trunk block (kernel K3), forward and backward, written
// for Hopper's tensor cores in fp32-accurate 3xTF32.
//
// Replaces the Pallas TPU kernel mmlf_tpu/ops/pallas/conv_block.py:
// fused_double_conv, forward _fwd / _fwd_kernel and backward
// _fused_bwd_rule / _bwd_kernel.  One trunk block, NCHW float32:
//
//   z   = [relu]([si * x + ti])          input stage (previous block's BN+ReLU)
//   y1  = relu(conv2x2_pad1(z) + b1)     (B, Cout, H+1, W+1), never saved
//   y2  = conv2x2_pad0(y1) + b2          (B, Cout, H, W)
//   ps  = sum y2, pss = sum y2^2         per channel over (B, H, W)
//
// The backward recomputes y1 from x (the residuals are x and y2 only) and
// gives dx, dsi, dti, dW1, db1, dW2, db2 from dy2, dps, dpss:
//
//   g2  = dy2 + dps + 2 y2 dpss,  db2 = sum g2
//   dy1 = [y1 > 0] dgrad2(g2),    db1 = sum dy1
//   dW2 = sum g2 (x) taps(y1),    dW1 = sum dy1 (x) taps(z)
//   dz  = dgrad1(dy1), masked by [si x + ti > 0] when relu_in;
//   dsi = sum dz x, dti = sum dz (affine_in), dx = dz si.
//
// Zero padding is in z, after the input stage: a tap outside the image reads
// 0, not relu(ti).  relu' at 0 is 0 on both relus.
//
// Precision: 3xTF32.  Every operand a, whatever its value, is split as
// a = hi + lo with hi = tf32(a) and lo = tf32(a - hi) (cvt.rna.tf32.f32; a -
// hi is exact in fp32), and each product is lo*hi' + hi*lo' + hi*hi' (the two
// small cross terms first), lo*lo' dropped.  hi + lo carries 22 of a's 24
// significant bits, so a dot product stays within a small factor of an fp32
// FFMA dot product's error against float64, where one TF32 product (11 bits)
// is ~500x off.  The tensor core rounds its fp32 sums its own way (measured
// on the card with mma.sync: one chain over all of K ends 20-160x further
// from float64 than fp32, and biased), so each chain of wgmma runs over one
// 16-deep stage only and is then added into fp32 registers; the partial
// sums over images and pixel chunks are added in fp64.
//
// What bounds it on an H100 SXM: operations.  At the recipe's out_net shape
// (B 64, 96x96, 280 -> 280) the forward is 2 * 4 * 280^2 * (97^2 + 96^2) * 64
// = 0.75 TFLOP and the backward's five GEMMs (y1 again, two dgrads, two
// wgrads) 1.87 TFLOP, against 1.3 GB of x and y2 (0.4 ms of bytes).  An
// fp32-accurate product costs three TF32 products: at 495 / 3 = 165
// TFLOP/s of the tensor cores the bound is 4.5 ms forward and 11.4 ms
// backward (at the 67 TFLOP/s fp32 FFMA peak of the CUDA cores it was 11.2
// and 28.0 ms).
//
// Design:
//   * One tensor-core GEMM core serves all seven GEMMs of the block:
//     out[row][col] = sum_k A[k][row] Bm[k][col] over stages of 16 k.  A
//     block owns TM = 128 MI rows x TN columns; TN is the output width
//     padded to 8 (280 runs as 2 x 144, 108 as 112, 70 as 72, 27 as 32, 2
//     as 8).
//   * conv2x2 (y1, y2, dgrad2 with the [y1 > 0] mask, dgrad1): rows are
//     pixels m = (b, oy, ox), columns output channels, k = ci*4 + tap (the
//     OIHW order: the weights are K-major as they are, and the weight
//     gradient comes out in their layout).  wgrad (dW1, dW2): rows are the
//     (ci, tap) columns of the implicit im2col, columns output channels, k
//     the pixels of a chunk.
//   * Warp-specialised: two consumer warpgroups run the products (wgmma
//     m64nTNk8 .tf32 on MI row tiles each) and their fp32 sums; two
//     producer warpgroups fill a ring of STAGES stages with cp.async (zero
//     fill; 4-byte gathers of the 2x2 taps, 16-byte weight chunks) and
//     transform each stage: the input stage, the zero padding (a tap
//     outside the image is 0 after the stage), the split into (hi, lo), and
//     the four operand tiles (A hi, A lo, B hi, B lo) written K-major with
//     the 64-byte swizzle, which tf32 wgmma needs (both operands K-major;
//     NCHW pixels are not).  NBUF operand buffers and named barriers pass
//     stages between the roles; setmaxnreg gives the consumers the
//     registers for two accumulator sets.
//   * Epilogue through shared memory: the accumulators go to a (TN, TM)
//     tile, then each consumer writes one row (pixel or im2col column) of
//     every channel, so stores to NCHW are coalesced along pixel rows.
//     conv2x2 adds the bias and the ReLU, or masks by [y1 > 0] for dy1.
//   * Two launches per forward, with a transient y1 buffer; the saved
//     residuals stay x and y2.
//   * Cross-block sums (ps, pss, db1, db2, dsi, dti): per-(channel, image)
//     partials from plane_kernel, then a fixed-order sum over the images.
//     The weight gradients split the pixel reduction into chunks (enough
//     blocks to fill the card, at most WGRAD_MAX_CHUNK pixels each), each
//     block writes its partial tile and sum_rows_kernel adds the chunks in
//     order.  No atomics: every sum is deterministic.
//   * dgrad of a k=2 conv is a k=2 conv with the kernel flipped in space and
//     in/out swapped, pad 1 <-> pad 0; the caller passes those weights.
//   * What holds it from the bound (measured on the card, 280 -> 280
//     forward): the consumers alone would take ~1.5x the bound; the
//     producers set the time.  The proxy fence that publishes their
//     operand tiles to the tensor cores also waits for their cp.async
//     copies in flight (without it the block would take ~0.57x as long),
//     so the next step is copies that the fence does not wait for (bulk or
//     TMA copies, which run in the async proxy).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // two warpgroups; a GEMM block has 2 x
constexpr int BK = 16;         // GEMM depth of one stage
constexpr int STAGES = 4;      // cp.async ring
constexpr int NBUF = 3;        // operand buffers between producers and consumers
// registers a thread, moved by setmaxnreg: 2 x 128 x (176 + 80) = 65536
constexpr int CONSUMER_REGS = 176, PRODUCER_REGS = 80;
constexpr int WGRAD_TARGET_BLOCKS = 2 * 132;
constexpr long long WGRAD_MAX_CHUNK = 4096;   // pixels per wgrad partial

enum { IN_AFFINE = 1, IN_RELU = 2 };
enum { EPI_BIAS = 0, EPI_BIAS_RELU = 1, EPI_MASK = 2 };
enum { PLANE_STATS = 0, PLANE_G2 = 1, PLANE_SUM = 2, PLANE_IN_BWD = 3 };

__device__ __forceinline__ float in_stage(float v, float s, float t,
                                          int flags) {
  if (flags & IN_AFFINE) v = fmaf(v, s, t);
  if (flags & IN_RELU) v = fmaxf(v, 0.f);
  return v;
}

// (hi, lo) = (tf32(a), tf32(a - hi)), round to nearest, ties away.
__device__ __forceinline__ float2 split_tf32(float a) {
  uint32_t hi, lo;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(a));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(a - __uint_as_float(hi)));
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// asynchronous copies to shared memory; zero fill when !valid (src is then
// not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared-memory writes of the threads -> reads of the tensor cores' async
// proxy (before the barrier that publishes them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Operand tiles in shared memory are K-major with the 64-byte swizzle: a
// row holds a stage's 16 k (64 bytes, four 16-byte chunks), 8 rows form a
// 512-byte atom, and chunk c of row r sits at position c ^ ((r >> 1) & 3),
// so that the tensor cores' reads and the producers' 16-byte stores of 8
// consecutive rows hit every bank once.  Offset in floats of (row, k):
__device__ __forceinline__ int op_offset(int row, int k) {
  const int r = row & 7;
  return (row >> 3) * 128 + r * 16 + (((k >> 2) ^ (r >> 1)) & 3) * 4 +
         (k & 3);
}

// wgmma matrix descriptor of such a tile (512-byte aligned): start
// address, stride byte offset 512 B between 8-row atoms, 64-byte swizzle.
// The second 8-deep half of a stage starts 32 bytes in.
__device__ __forceinline__ uint64_t op_desc(const float* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(512 >> 4) << 32 | (uint64_t)2 << 62;
}

// d (m64 x N, fp32) = [d +] A (m64 x k8, tf32) B (N x k8, tf32)^T, both
// operands from shared memory (descriptors), K-major; scale_d = 0 overwrites
// d.  Accumulator layout: d[4 j + r] is row 16 warp + lane/4 + 8 (r >> 1),
// column 8 j + 2 (lane % 4) + (r & 1).
__device__ __forceinline__ void wgmma_tf32(float (&d)[4], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[36], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "%36, %37, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[56], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "%56, %57, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[72], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b), "r"(scale_d));
}

// One pixel's 2x2 input neighbourhood: its offset in x and which of the
// four taps (0,0), (0,1), (1,0), (1,1) lie inside the image.  Offsets are
// 32-bit: the host entry points refuse tensors of 2^31 elements or more.
struct Taps {
  int base;                    // offset of (b, 0, iy0, ix0) in x
  int inside;                  // bit t: tap t inside the image

  __device__ void at(int b, int oy, int ox, int cin, int hin, int win,
                     int pad, bool valid) {
    const int iy0 = oy - pad, ix0 = ox - pad;
    base = b * cin * hin * win + iy0 * win + ix0;
    const bool r0 = valid && iy0 >= 0 && iy0 < hin;
    const bool r1 = valid && iy0 + 1 >= 0 && iy0 + 1 < hin;
    const bool c0 = ix0 >= 0 && ix0 < win;
    const bool c1 = ix0 + 1 >= 0 && ix0 + 1 < win;
    inside = (r0 && c0) | (r0 && c1) << 1 | (r1 && c0) << 2 |
             (r1 && c1) << 3;
  }

  // Copy the four taps of channel ci (zeros outside the image or past the
  // last channel) to dst[0], dst[step], dst[2 step], dst[3 step].
  __device__ void copy(const float* __restrict__ x, int ci, int cin, int hw,
                       int win, float* dst, int step) const {
    const bool ok = ci < cin;
    const int o = base + ci * hw;
    const int off[4] = {0, 1, win, win + 1};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool v = ok && (inside >> t & 1);
      cp_async4(dst + t * step, v ? x + o + off[t] : x, v);
    }
  }
};

// Block tile: TM = 128 MI rows x TN columns, TN a multiple of 8 up to 256.
// A block is four warpgroups: two consumers (each MI m64 x TN products of
// wgmma and their fp32 sums) and two producers (the copies and the
// transform), THREADS threads each side.
template <int MI_, int TN_>
struct Cfg {
  static constexpr int MI = MI_, TN = TN_;
  static constexpr int TM = 128 * MI;
  static constexpr int ACC = TN / 2;               // fp32 sums a thread, m64
  // operand tiles of one stage, floats: A hi, A lo (TM x 16), B hi, B lo
  static constexpr int OPA = TM * BK, OPB = TN * BK;
  static constexpr int OP = 2 * (OPA + OPB);
  // cp.async ring, floats a slot: A (16 x TM, row stride TM + 1); B conv
  // (TN x 16, row stride 20) or wgrad (16 x TN, row stride TN + 1)
  static constexpr int RA = TM + 1, RB = TN + 1, RBC = BK + 4;
  static constexpr int RAW_A = BK * RA;
  static constexpr int RAW_B = TN * RBC > BK * RB ? TN * RBC : BK * RB;
  static constexpr int MAIN = 4 * (NBUF * OP + STAGES * (RAW_A + RAW_B)) +
                              STAGES * THREADS;
  static constexpr int OA = TM + 4;                // epilogue tile stride
  static constexpr int EPI = 4 * TN * OA;
  static constexpr int SMEM = MAIN > EPI ? MAIN : EPI;
  static_assert(TN % 8 == 0 && TN <= 256, "wgmma N");
  static_assert(SMEM <= 220 * 1024, "shared memory (+ si, ti)");
};

// 280 -> 144 + 144, 108 -> 112, 70 -> 72, 27 -> 32, 2 -> 8
using Cfg144 = Cfg<1, 144>;
using Cfg112 = Cfg<1, 112>;
using Cfg72 = Cfg<2, 72>;
using Cfg32 = Cfg<2, 32>;
using Cfg8 = Cfg<2, 8>;

// Views of the dynamic shared memory: NBUF buffers of a stage's operand
// tiles, the cp.async ring, the wgrad tap masks, si and ti, and the
// epilogue's output tile over the first three.
template <class C>
struct Smem {
  float* op;                   // [NBUF][A hi, A lo, B hi, B lo]
  float* raw_a;
  float* raw_b;
  unsigned char* mask;
  float* out;
  float* st;                   // si, ti (affine input stage)

  __device__ explicit Smem(unsigned char* base) {
    op = reinterpret_cast<float*>(base);
    raw_a = op + NBUF * C::OP;
    raw_b = raw_a + STAGES * C::RAW_A;
    mask = reinterpret_cast<unsigned char*>(raw_b + STAGES * C::RAW_B);
    out = reinterpret_cast<float*>(base);
    st = reinterpret_cast<float*>(base + C::SMEM);
  }
  __device__ float* a_hi(int buf) const { return op + buf * C::OP; }
  __device__ float* a_lo(int buf) const { return a_hi(buf) + C::OPA; }
  __device__ float* b_hi(int buf) const { return a_lo(buf) + C::OPA; }
  __device__ float* b_lo(int buf) const { return b_hi(buf) + C::OPB; }
};

// Named barriers: the producers among themselves, the consumers among
// themselves, "operands of buffer b are ready" for each consumer
// warpgroup (producers arrive, that warpgroup waits) and "buffer b is
// free" (consumers arrive, producers wait).
constexpr int BAR_PRODUCERS = 1, BAR_CONSUMERS = 2;
__device__ __forceinline__ int bar_full(int buf, int wg) {
  return 3 + 2 * buf + wg;
}
__device__ __forceinline__ int bar_empty(int buf) { return 3 + 2 * NBUF + buf; }

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// One stage's products into t (overwritten): for each 8-deep half the two
// cross terms lo*hi' and hi*lo', then the two hi*hi' terms.
template <class C>
__device__ __forceinline__ void stage_products(const Smem<C>& sm, int buf,
                                               int wg,
                                               float (&t)[C::MI][C::ACC]) {
  const uint64_t bh = op_desc(sm.b_hi(buf)), bl = op_desc(sm.b_lo(buf));
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
    const int row0 = (wg * C::MI + mi) * 64;
    const uint64_t ah = op_desc(sm.a_hi(buf) + row0 * BK);
    const uint64_t al = op_desc(sm.a_lo(buf) + row0 * BK);
    // +32 bytes (2 in descriptor units) = the second 8-deep half
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wgmma_tf32(t[mi], al + 2 * h, bh + 2 * h, h);
      wgmma_tf32(t[mi], ah + 2 * h, bl + 2 * h, 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      wgmma_tf32(t[mi], ah + 2 * h, bh + 2 * h, 1);
  }
}

// Consumer side of out[row][col] = sum_k A[k][row] Bm[k][col] over `steps`
// stages of 16 k: each stage's products in the tensor cores, then added
// into fp32 registers; the result is left as the (TN, TM) tile
// sm.out[col * OA + row].  Thread ct = threadIdx.x < THREADS.
template <class C>
__device__ __forceinline__ void consume(const Smem<C>& sm, int steps) {
  const int ct = threadIdx.x, wg = ct >> 7;
  float acc[C::MI][C::ACC], t[C::MI][C::ACC];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) acc[mi][i] = t[mi][i] = 0.f;

  for (int kt = 0; kt < steps; ++kt) {
    const int buf = kt % NBUF;
    bar_sync(bar_full(buf, wg), THREADS + 128);
    wgmma_fence();
    stage_products<C>(sm, buf, wg, t);
    wgmma_commit();
    wgmma_wait_all();
    if (kt + NBUF < steps) bar_arrive(bar_empty(buf), 2 * THREADS);
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) acc[mi][i] += t[mi][i];
  }
  // the last stage's operands were read: the tile may overwrite them
  bar_sync(BAR_CONSUMERS, THREADS);
  const int warp = (ct >> 5) & 3, lane = ct & 31;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) {
      const int row = (wg * C::MI + mi) * 64 + warp * 16 + (lane >> 2) +
                      ((i >> 1) & 1) * 8;
      const int col = (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
      sm.out[col * C::OA + row] = acc[mi][i];
    }
  bar_sync(BAR_CONSUMERS, THREADS);
}

// Producer side: the loader copies a stage into the ring (issue) and
// writes its split operand tiles into buffer kt % NBUF (transform), up to
// NBUF stages ahead of the consumers.  A stage's raw copies are complete
// and published by the producers' barrier before any producer transforms
// it (a thread may transform what another copied).  Each stage's copies
// are issued after the fence that publishes the previous tiles: the fence
// waits for the thread's copies in flight.
template <class C, class Loader>
__device__ __forceinline__ void produce(Loader& ld, const Smem<C>& sm,
                                        int steps) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) ld.issue(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<STAGES - 2>();
    bar_sync(BAR_PRODUCERS, THREADS);
    const int buf = kt % NBUF;
    if (kt >= NBUF) bar_sync(bar_empty(buf), 2 * THREADS);
    ld.transform(kt, kt % STAGES, buf);
    fence_proxy_async();
    bar_arrive(bar_full(buf, 0), THREADS + 128);
    bar_arrive(bar_full(buf, 1), THREADS + 128);
    // after the fence: it waits for this thread's copies in flight, and
    // the newest of those are now one stage old
    if (kt + STAGES - 1 < steps)
      ld.issue(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ void store_split4(float* hi, float* lo, int off,
                                             const float (&v)[4]) {
  float4 h, l;
  float2 s = split_tf32(v[0]);
  h.x = s.x; l.x = s.y;
  s = split_tf32(v[1]);
  h.y = s.x; l.y = s.y;
  s = split_tf32(v[2]);
  h.z = s.x; l.z = s.y;
  s = split_tf32(v[3]);
  h.w = s.x; l.w = s.y;
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
}

// conv2x2 operands: rows are pixels, k = ci*4 + tap, a stage is 4 input
// channels.  Producer thread pt copies and transforms the 4 taps (one
// 16-byte chunk of k) of pixel pt % TM in channels pt / TM + TPP j.  The
// weight tile (TN x 16 k of the K-major (N, 4 Cin) weight) is copied 16
// bytes a thread with k fastest (coalesced) and transformed with n fastest
// (conflict-free).
template <class C>
struct ConvLoader {
  static constexpr int TPP = THREADS / C::TM;        // threads per pixel
  static constexpr int CPT = 4 / TPP;                // channels a thread
  static constexpr int WPT = (4 * C::TN + THREADS - 1) / THREADS;
  const Smem<C>& sm;
  const float* __restrict__ x;
  const float* __restrict__ w;
  int flags, cin, hw, win, n_out, n0, pt, row, c0;
  Taps taps;

  __device__ void issue(int kt, int slot) const {
    float* ra = sm.raw_a + slot * C::RAW_A;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = c0 + TPP * j;
      taps.copy(x, kt * 4 + c, cin, hw, win, ra + c * 4 * C::RA + row, C::RA);
    }
    float* rb = sm.raw_b + slot * C::RAW_B;
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int e = pt + i * THREADS;
      if (e >= 4 * C::TN) break;
      const int n = e >> 2, c = e & 3;
      const bool ok = kt * 4 + c < cin && n0 + n < n_out;
      cp_async16(rb + n * C::RBC + c * 4,
                 ok ? w + (long long)(n0 + n) * 4 * cin + kt * BK + c * 4 : w,
                 ok);
    }
  }

  __device__ void transform(int kt, int slot, int buf) const {
    const float* ra = sm.raw_a + slot * C::RAW_A;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = c0 + TPP * j, ci = kt * 4 + c;
      const bool ok = ci < cin;
      float s = 1.f, t = 0.f;
      if ((flags & IN_AFFINE) && ok) {
        s = sm.st[ci];
        t = sm.st[cin + ci];
      }
      float v[4];
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const bool in = ok && (taps.inside >> tap & 1);
        v[tap] = in ? in_stage(ra[(c * 4 + tap) * C::RA + row], s, t, flags)
                    : 0.f;
      }
      store_split4(sm.a_hi(buf), sm.a_lo(buf), op_offset(row, c * 4), v);
    }
    const float* rb = sm.raw_b + slot * C::RAW_B;
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int e = pt + i * THREADS;
      if (e >= 4 * C::TN) break;
      const int n = e % C::TN, c = e / C::TN;
      const float4 q = *reinterpret_cast<const float4*>(rb + n * C::RBC +
                                                        c * 4);
      const float v[4] = {q.x, q.y, q.z, q.w};
      store_split4(sm.b_hi(buf), sm.b_lo(buf), op_offset(n, c * 4), v);
    }
  }
};

// wgrad operands: rows are the im2col columns (ci, tap) from k0, k the
// pixels of the chunk, 16 a stage.  Producer thread pt copies pixel lane
// pt % 16 of channels pt / 16 + 16 j and of gradient channels pt / 16 +
// 16 i; its tap mask for each slot waits in sm.mask until the transform.
template <class C>
struct WgradLoader {
  static constexpr int APT = C::TM / 64;             // channels a thread
  static constexpr int GPT = (C::TN + 15) / 16;
  const Smem<C>& sm;
  const float* __restrict__ g;
  const float* __restrict__ x;
  int flags, cin, hin, win, ho, wo, n_out, n0, k0, pad, pt, p, q;
  long long m, m_end;
  int b, oy, ox;

  __device__ void issue(int, int slot) {
    const bool pv = m < m_end;
    Taps taps;
    taps.at(b, oy, ox, cin, hin, win, pad, pv);
    sm.mask[slot * THREADS + pt] = (unsigned char)taps.inside;
    float* ra = sm.raw_a + slot * C::RAW_A + p * C::RA;
#pragma unroll
    for (int j = 0; j < APT; ++j) {
      const int c = q + 16 * j;
      taps.copy(x, k0 / 4 + c, cin, hin * win, win, ra + c * 4, 1);
    }
    float* rb = sm.raw_b + slot * C::RAW_B + p * C::RB;
    const int hwo = ho * wo;
    const long long gbase = (long long)b * n_out * hwo + oy * wo + ox;
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int n = q + 16 * i;
      if (n >= C::TN) break;
      const bool ok = pv && n0 + n < n_out;
      cp_async4(rb + n, ok ? g + gbase + (long long)(n0 + n) * hwo : g, ok);
    }
    // this thread's pixel of the next stage
    m += BK;
    ox += BK;
    while (ox >= wo) {
      ox -= wo;
      if (++oy == ho) {
        oy = 0;
        ++b;
      }
    }
  }

  __device__ void transform(int, int slot, int buf) const {
    const int inside = sm.mask[slot * THREADS + pt];
    const float* ra = sm.raw_a + slot * C::RAW_A + p * C::RA;
    float* ahi = sm.a_hi(buf);
    float* alo = sm.a_lo(buf);
#pragma unroll
    for (int j = 0; j < APT; ++j) {
      const int c = q + 16 * j, ci = k0 / 4 + c;
      const bool ok = ci < cin;
      float s = 1.f, t = 0.f;
      if ((flags & IN_AFFINE) && ok) {
        s = sm.st[ci];
        t = sm.st[cin + ci];
      }
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const bool in = ok && (inside >> tap & 1);
        const float2 z =
            split_tf32(in ? in_stage(ra[c * 4 + tap], s, t, flags) : 0.f);
        const int off = op_offset(c * 4 + tap, p);
        ahi[off] = z.x;
        alo[off] = z.y;
      }
    }
    const float* rb = sm.raw_b + slot * C::RAW_B + p * C::RB;
    float* bhi = sm.b_hi(buf);
    float* blo = sm.b_lo(buf);
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int n = q + 16 * i;
      if (n >= C::TN) break;
      const float2 z = split_tf32(rb[n]);
      const int off = op_offset(n, p);
      bhi[off] = z.x;
      blo[off] = z.y;
    }
  }
};

// si, ti into shared memory, read by every stage's transform.
template <class C>
__device__ __forceinline__ void stage_affine(const Smem<C>& sm,
                                             const float* __restrict__ si,
                                             const float* __restrict__ ti,
                                             int flags, int cin) {
  if (flags & IN_AFFINE)
    for (int i = threadIdx.x; i < cin; i += 2 * THREADS) {
      sm.st[i] = __ldg(si + i);
      sm.st[cin + i] = __ldg(ti + i);
    }
  __syncthreads();
}

// out (B, N, Ho, Wo) = conv2x2(in_stage(x), pad) with x (B, Cin, Hin, Win),
// Ho = Hin + 2 pad - 1; w is the K-major (N, 4 Cin) GEMM weight (OIHW
// flattened), k = ci*4 + tap.
template <class C>
__global__ void __launch_bounds__(2 * THREADS, 1)
conv2x2_kernel(const float* __restrict__ x, const float* __restrict__ si,
               const float* __restrict__ ti, int flags,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ mask, float* __restrict__ out,
               int B, int cin, int hin, int win, int n_out, int pad,
               int epi) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Smem<C> sm(smem);
  stage_affine<C>(sm, si, ti, flags, cin);
  const int ho = hin + 2 * pad - 1, wo = win + 2 * pad - 1;
  const int hwo = ho * wo;
  const long long M = (long long)B * hwo;
  const long long m0 = (long long)blockIdx.x * C::TM;
  const int n0 = blockIdx.y * C::TN;
  const int steps = (cin + 3) / 4;
  const bool consumer = threadIdx.x < THREADS;
  const int row = threadIdx.x % C::TM;

  // this thread's pixel (producers: staging; consumers: epilogue)
  const long long m = m0 + row;
  const bool valid = m < M;
  int b = 0, r = 0;
  if (valid) {
    b = (int)(m / hwo);
    r = (int)(m - (long long)b * hwo);
  }
  if (consumer) {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<C>(sm, steps);
    if (!valid) return;
    const long long obase = (long long)b * n_out * hwo + r;
    for (int n = threadIdx.x / C::TM; n < C::TN; n += THREADS / C::TM) {
      if (n0 + n >= n_out) break;
      const long long o = obase + (long long)(n0 + n) * hwo;
      float v = sm.out[n * C::OA + row];
      if (epi == EPI_MASK) {
        v = __ldg(mask + o) > 0.f ? v : 0.f;
      } else {
        if (bias != nullptr) v += __ldg(bias + n0 + n);
        if (epi == EPI_BIAS_RELU) v = fmaxf(v, 0.f);
      }
      out[o] = v;
    }
  } else {
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = threadIdx.x - THREADS;
    const int oy = r / wo, ox = r - oy * wo;
    ConvLoader<C> ld{sm, x, w, flags, cin, hin * win, win, n_out, n0, pt,
                     row, pt / C::TM, {}};
    ld.taps.at(b, oy, ox, cin, hin, win, pad, valid);
    produce<C>(ld, sm, steps);
  }
}

// Weight gradient of one conv2x2: part[chunk][n][k] = sum over the chunk's
// pixels m of g[b, n, oy, ox] * A[k][m], A the implicit im2col of
// in_stage(x) with the conv's pad (as in conv2x2_kernel).
template <class C>
__global__ void __launch_bounds__(2 * THREADS, 1)
wgrad_kernel(const float* __restrict__ g, const float* __restrict__ x,
             const float* __restrict__ si, const float* __restrict__ ti,
             int flags, float* __restrict__ part, int B, int cin, int hin,
             int win, int n_out, int pad, long long chunk_len) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Smem<C> sm(smem);
  stage_affine<C>(sm, si, ti, flags, cin);
  const int ho = hin + 2 * pad - 1, wo = win + 2 * pad - 1;
  const int hwo = ho * wo;
  const long long M = (long long)B * hwo;
  const int K = 4 * cin;
  const int k0 = blockIdx.x * C::TM, n0 = blockIdx.y * C::TN;
  const long long m_begin = (long long)blockIdx.z * chunk_len;
  const long long m_end = m_begin + chunk_len < M ? m_begin + chunk_len : M;
  const int steps = (int)((m_end - m_begin + BK - 1) / BK);

  if (threadIdx.x < THREADS) {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<C>(sm, steps);
    const int row = threadIdx.x % C::TM, k = k0 + row;
    if (k >= K) return;
    float* dst = part + (long long)blockIdx.z * n_out * K + k;
    for (int n = threadIdx.x / C::TM; n < C::TN; n += THREADS / C::TM) {
      if (n0 + n >= n_out) break;
      dst[(long long)(n0 + n) * K] = sm.out[n * C::OA + row];
    }
  } else {
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = threadIdx.x - THREADS;
    WgradLoader<C> ld{sm, g, x, flags, cin, hin, win, ho, wo, n_out, n0, k0,
                      pad, pt, pt % 16, pt / 16, m_begin + pt % 16, m_end,
                      0, 0, 0};
    if (ld.m < M) {
      ld.b = (int)(ld.m / hwo);
      const int r = (int)(ld.m - (long long)ld.b * hwo);
      ld.oy = r / wo;
      ld.ox = r - ld.oy * wo;
    }
    produce<C>(ld, sm, steps);
  }
}

// Sum of one value per thread over the block, in a fixed order; the result
// is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();             // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// One block per (channel c, image b) plane of hw pixels; writes the
// per-plane partial sums part[0][b][c] (and part[1][b][c]).
//   PLANE_STATS:  sum t, sum t^2                       (t = y2)
//   PLANE_G2:     g = t + dps + 2 u dpss -> out; sum g (t = dy2, u = y2)
//   PLANE_SUM:    sum t                                (t = dy1)
//   PLANE_IN_BWD: out holds dz; dz *= [pre > 0]; sums dz x and dz; out = dz si
//                 (t = x)
template <int MODE>
__global__ void __launch_bounds__(THREADS)
plane_kernel(const float* __restrict__ t, const float* __restrict__ u,
             const float* __restrict__ pa, const float* __restrict__ pb,
             int flags, float* __restrict__ out, float* __restrict__ part,
             int B, int C, int hw) {
  __shared__ float red[THREADS / 32];
  const int c = blockIdx.x, b = blockIdx.y;
  const long long base = ((long long)b * C + c) * hw;
  float s1 = 0.f, s2 = 0.f;
  float a = 0.f, d = 0.f;
  if (MODE == PLANE_G2) {
    a = __ldg(pa + c);
    d = 2.f * __ldg(pb + c);
  }
  if (MODE == PLANE_IN_BWD) {
    a = (flags & IN_AFFINE) ? __ldg(pa + c) : 1.f;
    d = (flags & IN_AFFINE) ? __ldg(pb + c) : 0.f;
  }
  for (int i = threadIdx.x; i < hw; i += THREADS) {
    const long long o = base + i;
    const float v = __ldg(t + o);
    if (MODE == PLANE_STATS) {
      s1 += v;
      s2 = fmaf(v, v, s2);
    } else if (MODE == PLANE_G2) {
      const float g = v + a + d * __ldg(u + o);
      out[o] = g;
      s1 += g;
    } else if (MODE == PLANE_SUM) {
      s1 += v;
    } else {
      float dz = out[o];
      if ((flags & IN_RELU) && !(in_stage(v, a, d, flags & IN_AFFINE) > 0.f))
        dz = 0.f;
      s1 = fmaf(dz, v, s1);
      s2 += dz;
      out[o] = (flags & IN_AFFINE) ? dz * a : dz;
    }
  }
  const float r1 = block_sum(s1, red);
  if (threadIdx.x == 0) part[(long long)b * C + c] = r1;
  if (MODE == PLANE_STATS || MODE == PLANE_IN_BWD) {
    const float r2 = block_sum(s2, red);
    if (threadIdx.x == 0) part[(long long)B * C + (long long)b * C + c] = r2;
  }
}

// out[j] = sum_{s < S} part[s * L + j], s in order, summed in fp64 (the
// partials of a 590k-pixel sum are large and alike: an fp32 running sum
// would round each addition at the total's scale).
__global__ void __launch_bounds__(THREADS)
sum_rows_kernel(const float* __restrict__ part, int S, long long L,
                float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j >= L) return;
  double s = 0.0;
  for (int k = 0; k < S; ++k) s += __ldg(part + (long long)k * L + j);
  out[j] = (float)s;
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// The block tile for n_out output channels: the narrowest that holds them
// (wider outputs take 144-column tiles).
enum Tile { TILE8, TILE32, TILE72, TILE112, TILE144 };

Tile pick_tile(int n_out) {
  return n_out <= 8 ? TILE8 : n_out <= 32 ? TILE32 : n_out <= 72 ? TILE72
                            : n_out <= 112 ? TILE112 : TILE144;
}

struct TileShape {
  int tm, tn;
};

TileShape tile_shape(int n_out) {
  switch (pick_tile(n_out)) {
    case TILE8: return {Cfg8::TM, Cfg8::TN};
    case TILE32: return {Cfg32::TM, Cfg32::TN};
    case TILE72: return {Cfg72::TM, Cfg72::TN};
    case TILE112: return {Cfg112::TM, Cfg112::TN};
    default: return {Cfg144::TM, Cfg144::TN};
  }
}

template <class C>
cudaError_t launch_conv(const float* x, const float* si, const float* ti,
                        int flags, const float* w, const float* bias,
                        const float* mask, float* out, int B, int cin,
                        int hin, int win, int n_out, int pad, int epi,
                        cudaStream_t st) {
  // + si, ti; past ~7k channels the card refuses it (no int overflow)
  const int smem = C::SMEM + 8 * (cin < (1 << 20) ? cin : 1 << 20);
  const cudaError_t e = cudaFuncSetAttribute(
      conv2x2_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) {
    cudaGetLastError();          // returned here: not left for a later check
    return e;
  }
  const long long M = (long long)B * (hin + 2 * pad - 1) * (win + 2 * pad - 1);
  const dim3 grid(ceil_div(M, C::TM), ceil_div(n_out, C::TN));
  conv2x2_kernel<C><<<grid, 2 * THREADS, smem, st>>>(
      x, si, ti, flags, w, bias, mask, out, B, cin, hin, win, n_out, pad,
      epi);
  return cudaGetLastError();
}

cudaError_t conv2x2(const float* x, const float* si, const float* ti,
                    int flags, const float* w, const float* bias,
                    const float* mask, float* out, int B, int cin, int hin,
                    int win, int n_out, int pad, int epi, cudaStream_t st) {
#define MMLF_CONV(CFG)                                                      \
  return launch_conv<CFG>(x, si, ti, flags, w, bias, mask, out, B, cin, hin, \
                          win, n_out, pad, epi, st)
  switch (pick_tile(n_out)) {
    case TILE8: MMLF_CONV(Cfg8);
    case TILE32: MMLF_CONV(Cfg32);
    case TILE72: MMLF_CONV(Cfg72);
    case TILE112: MMLF_CONV(Cfg112);
    default: MMLF_CONV(Cfg144);
  }
#undef MMLF_CONV
}

// Pixel chunking of one weight gradient: enough blocks to fill the card,
// chunks a multiple of BK pixels long and at most WGRAD_MAX_CHUNK.
struct Chunks {
  long long len;
  int count;
};

Chunks wgrad_chunks(int B, int cin, int hin, int win, int n_out, int pad) {
  const long long M = (long long)B * (hin + 2 * pad - 1) * (win + 2 * pad - 1);
  const TileShape t = tile_shape(n_out);
  const int tiles = ceil_div(4 * cin, t.tm) * ceil_div(n_out, t.tn);
  long long want = ceil_div(WGRAD_TARGET_BLOCKS, tiles);
  if (want < ceil_div(M, WGRAD_MAX_CHUNK)) want = ceil_div(M, WGRAD_MAX_CHUNK);
  const long long most = ceil_div(M, 16 * BK);
  if (want > most) want = most;
  if (want < 1) want = 1;
  Chunks c;
  c.len = (long long)ceil_div(ceil_div(M, want), BK) * BK;
  c.count = ceil_div(M, c.len);
  return c;
}

template <class C>
cudaError_t launch_wgrad(const float* g, const float* x, const float* si,
                         const float* ti, int flags, float* part, int B,
                         int cin, int hin, int win, int n_out, int pad,
                         Chunks ch, cudaStream_t st) {
  // + si, ti; past ~7k channels the card refuses it (no int overflow)
  const int smem = C::SMEM + 8 * (cin < (1 << 20) ? cin : 1 << 20);
  const cudaError_t e = cudaFuncSetAttribute(
      wgrad_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) {
    cudaGetLastError();          // returned here: not left for a later check
    return e;
  }
  const dim3 grid(ceil_div(4 * cin, C::TM), ceil_div(n_out, C::TN),
                  ch.count);
  wgrad_kernel<C><<<grid, 2 * THREADS, smem, st>>>(
      g, x, si, ti, flags, part, B, cin, hin, win, n_out, pad, ch.len);
  return cudaGetLastError();
}

cudaError_t wgrad(const float* g, const float* x, const float* si,
                  const float* ti, int flags, float* part, float* dw, int B,
                  int cin, int hin, int win, int n_out, int pad,
                  cudaStream_t st) {
  const Chunks ch = wgrad_chunks(B, cin, hin, win, n_out, pad);
#define MMLF_WGRAD(CFG)                                                    \
  launch_wgrad<CFG>(g, x, si, ti, flags, part, B, cin, hin, win, n_out, pad, \
                    ch, st)
  cudaError_t err;
  switch (pick_tile(n_out)) {
    case TILE8: err = MMLF_WGRAD(Cfg8); break;
    case TILE32: err = MMLF_WGRAD(Cfg32); break;
    case TILE72: err = MMLF_WGRAD(Cfg72); break;
    case TILE112: err = MMLF_WGRAD(Cfg112); break;
    default: err = MMLF_WGRAD(Cfg144);
  }
#undef MMLF_WGRAD
  if (err != cudaSuccess) return err;
  const long long L = (long long)n_out * 4 * cin;
  sum_rows_kernel<<<ceil_div(L, THREADS), THREADS, 0, st>>>(part, ch.count, L,
                                                            dw);
  return cudaGetLastError();
}

cudaError_t sum_images(const float* part, int B, int C, float* out,
                       cudaStream_t st) {
  sum_rows_kernel<<<ceil_div(C, THREADS), THREADS, 0, st>>>(part, B, C, out);
  return cudaGetLastError();
}

bool bad_shape(int B, int cin, int H, int W, int cout) {
  return B < 1 || B > 65535 || cin < 1 || cout < 1 || H < 1 || W < 1 ||
         (long long)B * (cin > cout ? cin : cout) * (H + 1) * (W + 1) >=
             (1LL << 31);
}

long long wgrad_scratch(int B, int cin, int H, int W, int cout) {
  const Chunks c2 = wgrad_chunks(B, cout, H + 1, W + 1, cout, 0);
  const Chunks c1 = wgrad_chunks(B, cin, H, W, cout, 1);
  const long long s2 = (long long)c2.count * cout * 4 * cout;
  const long long s1 = (long long)c1.count * cout * 4 * cin;
  return s1 > s2 ? s1 : s2;
}

}  // namespace

#define MMLF_TRY(call)                       \
  do {                                       \
    const cudaError_t e_ = (call);           \
    if (e_ != cudaSuccess) return (int)e_;   \
  } while (0)

extern "C" {

// Floats of the wgrad scratch that mmlf_conv_block_bwd needs.
long long mmlf_conv_block_wgrad_scratch(int B, int cin, int H, int W,
                                        int cout) {
  return wgrad_scratch(B, cin, H, W, cout);
}

// Forward.  x (B, Cin, H, W); si, ti (Cin) (read only with affine_in); w1
// (Cout, 4 Cin) and w2 (Cout, 4 Cout) GEMM weights (OIHW flattened: K-major,
// k = ci*4 + tap); b1, b2 (Cout).  Writes y1 (B, Cout, H+1, W+1, scratch), y2
// (B, Cout, H, W), part (2 B Cout, scratch), ps and pss (Cout).
int mmlf_conv_block_fwd(const float* x, const float* si, const float* ti,
                        const float* w1, const float* b1, const float* w2,
                        const float* b2, float* y1, float* y2, float* part,
                        float* ps, float* pss, int B, int cin, int H, int W,
                        int cout, int relu_in, int affine_in, int device,
                        void* stream) {
  if (bad_shape(B, cin, H, W, cout)) return (int)cudaErrorInvalidValue;
  MMLF_TRY(cudaSetDevice(device));
  const cudaStream_t st = (cudaStream_t)stream;
  const int flags = (affine_in ? IN_AFFINE : 0) | (relu_in ? IN_RELU : 0);
  MMLF_TRY(conv2x2(x, si, ti, flags, w1, b1, nullptr, y1, B, cin, H, W,
                   cout, 1, EPI_BIAS_RELU, st));
  MMLF_TRY(conv2x2(y1, nullptr, nullptr, 0, w2, b2, nullptr, y2, B, cout,
                   H + 1, W + 1, cout, 0, EPI_BIAS, st));
  plane_kernel<PLANE_STATS><<<dim3(cout, B), THREADS, 0, st>>>(
      y2, nullptr, nullptr, nullptr, 0, nullptr, part, B, cout, H * W);
  MMLF_TRY(cudaGetLastError());
  MMLF_TRY(sum_images(part, B, cout, ps, st));
  MMLF_TRY(sum_images(part + (long long)B * cout, B, cout, pss, st));
  return (int)cudaSuccess;
}

// Backward.  Inputs as the forward's, plus w1dg (Cin, 4 Cout) and w2dg
// (Cout, 4 Cout), the GEMM weights of the two dgrad convs (kernels flipped
// in space, in/out swapped, OIHW flattened); y2, dy2 (B, Cout, H, W); dps, dpss (Cout).
// Scratch: y1 and dy1 (B, Cout, H+1, W+1), g2 (B, Cout, H, W), wpart
// (mmlf_conv_block_wgrad_scratch floats), bpart (2 B max(Cin, Cout)).
// Writes dx (B, Cin, H, W), dw1 (Cout, 4 Cin), dw2 (Cout, 4 Cout), db1, db2
// (Cout), dsi, dti (Cin; zeros without affine_in).
int mmlf_conv_block_bwd(const float* x, const float* si, const float* ti,
                        const float* w1, const float* b1,
                        const float* w1dg, const float* w2dg,
                        const float* y2, const float* dy2, const float* dps,
                        const float* dpss, float* y1, float* g2, float* dy1,
                        float* wpart, float* bpart, float* dx, float* dw1,
                        float* db1, float* dw2, float* db2, float* dsi,
                        float* dti, int B, int cin, int H, int W, int cout,
                        int relu_in, int affine_in, int device,
                        void* stream) {
  if (bad_shape(B, cin, H, W, cout)) return (int)cudaErrorInvalidValue;
  MMLF_TRY(cudaSetDevice(device));
  const cudaStream_t st = (cudaStream_t)stream;
  const int flags = (affine_in ? IN_AFFINE : 0) | (relu_in ? IN_RELU : 0);
  const int H1 = H + 1, W1 = W + 1;

  // y1 again, from the x residual
  MMLF_TRY(conv2x2(x, si, ti, flags, w1, b1, nullptr, y1, B, cin, H, W,
                   cout, 1, EPI_BIAS_RELU, st));
  // g2 and db2
  plane_kernel<PLANE_G2><<<dim3(cout, B), THREADS, 0, st>>>(
      dy2, y2, dps, dpss, 0, g2, bpart, B, cout, H * W);
  MMLF_TRY(cudaGetLastError());
  MMLF_TRY(sum_images(bpart, B, cout, db2, st));
  // dy1 = [y1 > 0] dgrad2(g2) and db1
  MMLF_TRY(conv2x2(g2, nullptr, nullptr, 0, w2dg, nullptr, y1, dy1, B, cout,
                   H, W, cout, 1, EPI_MASK, st));
  plane_kernel<PLANE_SUM><<<dim3(cout, B), THREADS, 0, st>>>(
      dy1, nullptr, nullptr, nullptr, 0, nullptr, bpart, B, cout, H1 * W1);
  MMLF_TRY(cudaGetLastError());
  MMLF_TRY(sum_images(bpart, B, cout, db1, st));
  // dz = dgrad1(dy1) into dx, then the input stage's backward in place
  MMLF_TRY(conv2x2(dy1, nullptr, nullptr, 0, w1dg, nullptr, nullptr, dx, B,
                   cout, H1, W1, cin, 0, EPI_BIAS, st));
  if (flags) {
    plane_kernel<PLANE_IN_BWD><<<dim3(cin, B), THREADS, 0, st>>>(
        x, nullptr, si, ti, flags, dx, bpart, B, cin, H * W);
    MMLF_TRY(cudaGetLastError());
  }
  if (affine_in) {
    MMLF_TRY(sum_images(bpart, B, cin, dsi, st));
    MMLF_TRY(sum_images(bpart + (long long)B * cin, B, cin, dti, st));
  } else {
    MMLF_TRY(cudaMemsetAsync(dsi, 0, sizeof(float) * cin, st));
    MMLF_TRY(cudaMemsetAsync(dti, 0, sizeof(float) * cin, st));
  }
  // weight gradients: dW2 = sum g2 (x) taps(y1), dW1 = sum dy1 (x) taps(z)
  MMLF_TRY(wgrad(g2, y1, nullptr, nullptr, 0, wpart, dw2, B, cout, H1, W1,
                 cout, 0, st));
  MMLF_TRY(wgrad(dy1, x, si, ti, flags, wpart, dw1, B, cin, H, W, cout, 1,
                 st));
  return (int)cudaSuccess;
}

const char* mmlf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
