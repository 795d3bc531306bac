// Fused double-conv trunk block (kernel K3), forward and backward, written
// for Hopper's tensor cores: float32 canvases in fp32-accurate 3xTF32, and
// bfloat16 canvases (--bf16) in one bf16 product (see "bfloat16 instance").
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
// The forward's options also make it the counterpart of the probe script's
// Pallas kernel scripts/pallas_block_probe.py (fused_block): no input stage,
// FWD_RELU_OUT (y2 = relu(...)), FWD_NO_STATS (no sums), y1 kept by the
// caller.  Its bound is the forward's (operations), and its design the
// forward's: the probe's canvas becomes NCHW in the wrapper.
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
// from float64 than fp32, and biased; with wgmma summing all of K with a
// stage in flight, the 280 -> 280 y2 ended 4.5x further than cuDNN's fp32,
// past the 4x its check allows), so each chain of wgmma runs over one
// 16-deep stage only and is then added into fp32 registers (CHAIN 1); the
// partial sums over images and pixel chunks are added in fp64.
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
//     registers for two accumulator sets: the chain of tensor-core sums
//     and the fp32 sums it is added into (consume).
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
//
// bfloat16 instance (the TPU kernel's native one: --bf16 --pallas_trunk).
// The canvases x, y1, y2 and dx are bf16, the weights are rounded to bf16,
// si, ti, the biases, the sums and the weight gradients stay fp32, and the
// rounding points are the TPU kernel's:
//   forward   z  = [relu](bf16(bf16(x * bf16(si)) + bf16(ti)))
//             y1 = bf16(relu(W1 taps(z) + b1)),  y2 = bf16(acc2 + b2),
//             ps, pss from the fp32 acc2 + b2 (before y2 is rounded);
//   backward  g2 = dy2 + dps + 2 y2 dpss in fp32 (db2 sums it), rounded to
//             bf16 for its products; dy1 = [y1 > 0] acc in fp32 (db1 sums
//             it), rounded for its products; the input stage's relu' takes
//             pre = x si + ti in fp32 with fp32 si, ti; dx = bf16(dz si).
// Every GEMM takes bf16 operands in wgmma m64nNk16 .bf16 with fp32 sums:
// one product where 3xTF32 takes three, so no split.  A stage is 32 k (one
// 64-byte operand row holds 16 bf16 pairs, 8 input channels of a conv), so
// the swizzled tiles and the descriptors keep their byte layout.  The
// consumers keep a stage's products in flight and sum chains of CHAIN = 4
// stages in the wgmma accumulators before adding them into fp32 registers
// (consume).  Measured on the card against the plain version in float64:
// chains over a whole wgrad chunk (128 stages) put dW2 12-15x further than
// cuDNN's fp32 wgrad, past the 4x its check allows; chains of 8 kept every
// output within 3.3x but put 1.01-1.07x as many of the probe block's y2
// values more than a bf16 ulp off as cuDNN's fp32 does (the check allows
// 1x); chains of 4 keep 3.3x and 0.57x and are as fast as 8 (chains of 2:
// 1.8x, 0.43x, a ~2% slower backward).  Four operand buffers (NBUF) keep
// the producers' lead with a stage in flight.
//   * The conv GEMMs (y1, y2, dgrad2, dgrad1) are fed by a ring of channel
//     spans (SpanLoader).  A tile's TM output pixels are consecutive in
//     (b, oy, ox), and the tap (0, 0) of pixel (oy, ox) sits at (oy - pad)
//     win + ox - pad of its channel plane, a non-decreasing offset, so in
//     each image the tile touches, the in-image taps of a channel lie in
//     one run of the plane: from max(0, that offset of its first pixel) to
//     min(hw, that of its last + win + 2), about TM + win elements.  For
//     each channel of a stage (producer warp c copies channel c), each run
//     is widened outward to 16-byte chunks and copied with one
//     cp.async.bulk that completes on the slot's mbarrier.  The stage's
//     weight rows (the caller's stage-major copy, (steps, N, 32), each
//     row's four 16-byte chunks already in their swizzled places) go
//     straight into the operand buffer with one more, a stage ahead.  Bulk
//     copies run in the async proxy, so the fence that publishes the
//     operand tiles waits for none of them, and the ring of STAGES slots
//     runs ahead.  The producers wait on the mbarrier, read every tap of
//     the stage with 2-byte shared loads (unmasked: a tap outside the
//     image reads whatever lies there), apply the input stage to bf16
//     pairs (mul.rn / add.rn .bf16x2 round each lane once, as the fp32
//     operation and its rounding to bf16 do: a product or sum of two bf16
//     values that fp32 rounds at all lies far from a bf16 rounding
//     boundary) and the zero padding as lane masks, and write the swizzled
//     A tile 16 bytes (two channels) at a time.  A slot's region for a
//     channel holds span_elems elements, computed at launch for the shape;
//     a run never leaves its plane, and its chunks never leave the
//     allocation, which the caller pads to a 16-byte multiple.  The span
//     ring is ~6-8 KB a stage (the word ring: 16.5 KB), so the narrow
//     tiles take 256 rows as fp32's do.  What holds it from the bound
//     (measured on the card with k3_variants.py, 280 -> 280 forward,
//     5.9-6.0 ms): the producers' transform.  With no products at all the
//     block takes 5.5 ms (the producers alone), with the transform left
//     out 4.7 ms (the copies, the consumers and the epilogue).
//   * The weight gradients (dW2 = sum g2 (x) taps(y1), dW1 = sum dy1 (x)
//     taps(z)) are fed by spans too (WgradSpanLoader).  There A's rows are
//     the im2col columns (ci, tap) of 32 x channels, B's the gradient's TN
//     output channels, and k the 32 pixels of a stage, consecutive in (b,
//     oy, ox).  So in each image that a group of WGRAD_GROUP stages
//     touches, the taps of one x channel lie in one run of its plane (the
//     rule above, for the group's pixels), and the group's values of one
//     gradient channel in one run of that channel's plane.  Each run is
//     copied, widened to 16-byte chunks, with one cp.async.bulk on the
//     mbarrier of its half of a two-group ring, a group ahead; a half
//     holds 32 x regions of span_a elements and TN gradient regions of
//     span_b, computed at launch for the shape (wgrad_span_a,
//     wgrad_span_b: groups start at known multiples, so a group touches a
//     known number of images).  Copies go by groups because each costs the
//     card a fixed time: a copy a channel and stage (176 a stage at 280 ->
//     280) took longer than the word ring, and 4 stages a group cut that
//     to a quarter; the ring's 227 KB leave no room for larger groups at
//     280 -> 280.  When a group is issued, the producers also write its
//     pixel table: each pixel's offsets in an x region and a gradient
//     region, its in-image taps and its part of the chunk shifts.  In the
//     transform a warp instruction writes two rows of a tile, a lane one
//     4-byte word (two pixels): its loads read 32 consecutive elements of
//     one or two regions and its stores 128 bytes, so neither conflicts in
//     the banks.  The lanes apply the input stage on bf16 pairs and the
//     masks (taps outside the image, pixels past the chunk's end).  The
//     consumers free an operand buffer on an mbarrier, so the producer
//     warps do not wait for each other every stage.  The operands, the
//     stages and the chunks are those of the word ring that came before.
//     What holds it from the bound (measured on the card with
//     k3_variants.py, 280 -> 280, 6.2-6.4 ms for both): the transform.
//     Without it the wgrads take 3.1 ms (the copies, the consumers and the
//     epilogue), with no products 5.8 ms (the producers alone).
// Bound on an H100 SXM: operations at the dense bf16 tensor-core peak, 989
// TFLOP/s: 0.76 ms forward and 1.9 ms backward at 280 -> 280, B 64, 96x96.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;   // two warpgroups; a GEMM block has 2 x
constexpr int STAGES = 4;      // slots of the cp.async ring or the span ring
// registers a thread, moved by setmaxnreg: 2 x 128 x (176 + 80) = 65536
constexpr int CONSUMER_REGS = 176, PRODUCER_REGS = 80;
constexpr int WGRAD_TARGET_BLOCKS = 2 * 132;
constexpr int WGRAD_GROUP = 4;  // stages of a bf16 wgrad span copy group
constexpr long long WGRAD_MAX_CHUNK = 4096;   // pixels per wgrad partial

// The two instances: the element of the canvases and operands, the GEMM
// depth of a stage (64 bytes of an operand row), the operand tiles a side
// (3xTF32: hi and lo), the operand buffers between producers and consumers
// (NBUF) and the stages a chain of tensor-core sums runs before it is added
// into fp32 registers (CHAIN, see consume).  bf16 values are held as their
// 16 bits.
struct Tf32x3 {
  using T = float;
  using R = float;               // an element of the cp.async ring
  static constexpr int BK = 16;
  static constexpr int NOP = 2;
  // the word ring's 256-row tiles have room for three buffers; a chain of
  // one stage, see "Precision"
  static constexpr int NBUF = 3, CHAIN = 1;
  // elements a row of the K-major GEMM weight (Cout, 4 Cin)
  static __host__ __device__ int ldw(int cin) { return 4 * cin; }
};

struct Bf16 {
  using T = uint16_t;
  static constexpr int BK = 32;
  static constexpr int NOP = 1;
  static constexpr int NBUF = 4, CHAIN = 4;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}
__device__ __forceinline__ uint16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float rbf(float v) { return to_f(f2bf(v)); }
// Two bf16 lanes at once, each rounded once, as the fp32 operation then
// f2bf rounds it: a product or sum of two bf16 values that fp32 rounds at
// all lies far from any bf16 rounding boundary.
__device__ __forceinline__ uint32_t mul_bf2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t relu_bf2(uint32_t a) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}
// the bf16 value v (exactly representable) in both lanes
__device__ __forceinline__ uint32_t splat_bf2(float v) {
  return (__float_as_uint(v) >> 16) * 0x10001u;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint16_t* p, float v) { *p = f2bf(v); }

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
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// mbarriers (shared memory, 8 bytes each) that bulk copies complete on.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// after mbarrier.init, before any other thread uses the barriers
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// this thread's arrival, announcing `bytes` more bytes of copies to come
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16) from global to shared memory, both 16-byte
// aligned, in the async proxy; completes on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
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

// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asm statements that issue and wait for wgmma (the registers
// belong to the tensor cores in between).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
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

// The same products with bf16 operands, m64nNk16: a 32-byte operand row
// (16 k) per instruction, both operands K-major (no transpose).
__device__ __forceinline__ void wgmma_bf16(float (&d)[4], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[36], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "%36, %37, p, 1, 1, 0, 0;\n}\n"
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

__device__ __forceinline__ void wgmma_bf16(float (&d)[56], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "%56, %57, p, 1, 1, 0, 0;\n}\n"
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

__device__ __forceinline__ void wgmma_bf16(float (&d)[72], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p, 1, 1, 0, 0;\n}\n"
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
template <int MI_, int TN_, class P_>
struct GemmTile {
  using P = P_;
  using T = typename P::T;
  static constexpr int MI = MI_, TN = TN_, BK = P::BK, NBUF = P::NBUF;
  static constexpr int TM = 128 * MI;
  static constexpr int ACC = TN / 2;               // fp32 sums a thread, m64
  // operand tiles of one stage, 32-bit words (a row is 64 bytes: 16 tf32 or
  // 16 bf16 pairs): A (TM rows), B (TN rows); hi and lo for 3xTF32
  static constexpr int OPA = TM * 16, OPB = TN * 16;
  static constexpr int OP = P::NOP * (OPA + OPB);
  static constexpr int OA = TM + 4;                // epilogue tile stride
  static constexpr int EPI = 4 * TN * OA;
  // buffer b is free: the consumers' arrivals on an mbarrier (else the
  // named barrier bar_empty, which all producers wait on together)
  static constexpr bool EMPTY_MBAR = false;
  static_assert(TN % 8 == 0 && TN <= 256, "wgmma N");
  static_assert(NBUF <= 4, "named barriers");
};

// A float32 tile fed by the cp.async ring of words (ConvLoader,
// WgradLoader).
template <int MI_, int TN_, class P_>
struct Cfg : GemmTile<MI_, TN_, P_> {
  using G = GemmTile<MI_, TN_, P_>;
  using R = typename P_::R;
  static constexpr bool SPANS = false;
  // cp.async ring, 4-byte entries a slot: A (BK x TM, row stride TM + 1);
  // B conv (TN weight rows of a stage, 80 bytes apart) or wgrad (BK x TN,
  // row stride TN + 1)
  static constexpr int RA = G::TM + 1, RB = TN_ + 1, RBC = 20;
  static constexpr int RAW_A = G::BK * RA;
  static constexpr int RAW_B =
      TN_ * RBC > G::BK * RB ? TN_ * RBC : G::BK * RB;
  static constexpr int MAIN = 4 * G::NBUF * G::OP +
                              4 * STAGES * (RAW_A + RAW_B) + STAGES * THREADS;
  static constexpr int SMEM = MAIN > G::EPI ? MAIN : G::EPI;
  static_assert(sizeof(R) == 4, "ring entries of 4 bytes");
  static_assert(SMEM <= 220 * 1024, "shared memory (+ si, ti)");
};

// A bf16 conv tile fed by the span ring (SpanLoader): a slot holds the
// stage's 8 channel regions of `span` elements each (a launch parameter,
// span_elems); the weight rows go straight to the operand buffers.  The
// mbarriers (STAGES slots, NBUF weight tiles) sit after the main
// area or the epilogue tile, whichever is larger.
template <int MI_, int TN_>
struct SpanCfg : GemmTile<MI_, TN_, Bf16> {
  using G = GemmTile<MI_, TN_, Bf16>;
  static constexpr bool SPANS = true;
  static constexpr int CPS = Bf16::BK / 4;         // channels a stage
  static __host__ __device__ long long area(int span) {
    const long long main =
        4LL * G::NBUF * G::OP + 2LL * STAGES * CPS * span;
    return main > G::EPI ? main : G::EPI;
  }
  // + the mbarriers; si and ti follow
  static __host__ __device__ long long smem(int span) {
    return area(span) + 8 * (STAGES + G::NBUF);
  }
};

// A bf16 wgrad tile fed by the span ring (WgradSpanLoader): two halves,
// each a copy group's CA x-channel regions of span_a elements, then its TN
// gradient-channel regions of span_b (launch parameters, wgrad_span_a and
// wgrad_span_b).  After the ring: room for the transform's unmasked tap
// loads past it, then (after the epilogue tile, if that is larger) the
// two halves' pixel tables and their mbarriers.
template <int TN_>
struct WgradSpanCfg : GemmTile<1, TN_, Bf16> {
  using G = GemmTile<1, TN_, Bf16>;
  static constexpr bool SPANS = true, EMPTY_MBAR = true;
  static constexpr int CA = G::TM / 4;             // x channels a tile
  static constexpr int PIX = WGRAD_GROUP * G::BK;  // pixels a copy group
  static __host__ __device__ long long slot_elems(int span_a, int span_b) {
    return (long long)CA * span_a + (long long)TN_ * span_b;
  }
  static __host__ __device__ long long area(int span_a, int span_b,
                                            int win) {
    const long long main = 4LL * G::NBUF * G::OP +
                           4LL * slot_elems(span_a, span_b) +
                           ((2LL * (win + 8) + 15) & ~15LL);
    return main > G::EPI ? main : G::EPI;
  }
  // + the pixel tables and the mbarriers; si and ti follow
  static __host__ __device__ long long smem(int span_a, int span_b,
                                            int win) {
    return area(span_a, span_b, win) + 2 * 16LL * PIX + 8 * (2 + G::NBUF);
  }
};

// 280 -> 144 + 144, 108 -> 112, 70 -> 72, 27 -> 32, 2 -> 8.  The narrow
// tiles take 256 rows (MI = 2); the wide ones 128, since the consumers'
// two accumulator sets leave no registers for two.  fp32 takes the word
// ring, the bf16 convs the span ring; the bf16 wgrads, on spans too, keep
// the 128 rows of the word ring they had (their pixel chunking, and so the
// order of their sums, depends on the tile).
struct WordTiles {
  using T144 = Cfg<1, 144, Tf32x3>;
  using T112 = Cfg<1, 112, Tf32x3>;
  using T72 = Cfg<2, 72, Tf32x3>;
  using T32 = Cfg<2, 32, Tf32x3>;
  using T8 = Cfg<2, 8, Tf32x3>;
};

struct SpanTiles {
  using T144 = SpanCfg<1, 144>;
  using T112 = SpanCfg<1, 112>;
  using T72 = SpanCfg<2, 72>;
  using T32 = SpanCfg<2, 32>;
  using T8 = SpanCfg<2, 8>;
};

struct WgradSpanTiles {
  using T144 = WgradSpanCfg<144>;
  using T112 = WgradSpanCfg<112>;
  using T72 = WgradSpanCfg<72>;
  using T32 = WgradSpanCfg<32>;
  using T8 = WgradSpanCfg<8>;
};

// The conv and wgrad tiles of an instance: the word ring for fp32, spans
// for bf16.
template <class P>
using ConvTiles =
    typename std::conditional<P::NOP == 1, SpanTiles, WordTiles>::type;
template <class P>
using WgradTiles =
    typename std::conditional<P::NOP == 1, WgradSpanTiles, WordTiles>::type;

// Views of the dynamic shared memory common to both rings: NBUF buffers of
// a stage's operand tiles, the epilogue's output tile over them (and over
// the ring after them), and si, ti after the whole.
template <class C>
struct OpSmem {
  float* op;                   // [NBUF][A hi, (A lo), B hi, (B lo)]
  float* out;
  float* st;                   // si, ti (affine input stage)

  __device__ OpSmem(unsigned char* base, long long st_offset)
      : op(reinterpret_cast<float*>(base)),
        out(reinterpret_cast<float*>(base)),
        st(reinterpret_cast<float*>(base + st_offset)) {}
  __device__ float* a_hi(int buf) const { return op + buf * C::OP; }
  __device__ float* a_lo(int buf) const { return a_hi(buf) + C::OPA; }
  __device__ float* b_hi(int buf) const {
    return a_hi(buf) + C::P::NOP * C::OPA;
  }
  __device__ float* b_lo(int buf) const { return b_hi(buf) + C::OPB; }
};

// ... with the cp.async ring of words and the wgrad tap masks.
template <class C>
struct Smem : OpSmem<C> {
  using R = typename C::R;
  R* raw_a;
  R* raw_b;
  unsigned char* mask;

  __device__ explicit Smem(unsigned char* base, int = 0, int = 0, int = 0)
      : OpSmem<C>(base, C::SMEM) {
    raw_a = reinterpret_cast<R*>(this->op + C::NBUF * C::OP);
    raw_b = raw_a + STAGES * C::RAW_A;
    mask = reinterpret_cast<unsigned char*>(raw_b + STAGES * C::RAW_B);
  }
};

// ... with the span ring: slot s holds the channel regions ring + s CPS
// span and full[s] completes when they arrived; wfull[b] completes when
// the weight rows of operand buffer b arrived.
template <class C>
struct SpanSmem : OpSmem<C> {
  uint16_t* ring;
  uint64_t* full;
  uint64_t* wfull;
  int span;

  __device__ SpanSmem(unsigned char* base, int span_)
      : OpSmem<C>(base, C::smem(span_)), span(span_) {
    ring = reinterpret_cast<uint16_t*>(this->op + C::NBUF * C::OP);
    full = reinterpret_cast<uint64_t*>(base + C::area(span_));
    wfull = full + STAGES;
  }
};

// ... with the wgrad's span ring: half h holds x region c at ring + h slot
// + c span_a and gradient region n at ring + h slot + CA span_a + n
// span_b; pix + h PIX is its pixel table and full[h] completes when its
// runs arrived; empty[b] completes when the consumers have read operand
// buffer b.
template <class C>
struct WgradSpanSmem : OpSmem<C> {
  uint16_t* ring;
  int4* pix;
  uint64_t* full;
  uint64_t* empty;
  int span_a, span_b, slot;

  __device__ WgradSpanSmem(unsigned char* base, int span_a_, int span_b_,
                           int win)
      : OpSmem<C>(base, C::smem(span_a_, span_b_, win)), span_a(span_a_),
        span_b(span_b_), slot((int)C::slot_elems(span_a_, span_b_)) {
    ring = reinterpret_cast<uint16_t*>(this->op + C::NBUF * C::OP);
    pix = reinterpret_cast<int4*>(base + C::area(span_a_, span_b_, win));
    full = reinterpret_cast<uint64_t*>(pix + 2 * C::PIX);
    empty = full + 2;
  }
};

// Named barriers (16, id 0 is __syncthreads'): the producers among
// themselves, the consumers among themselves, "operands of buffer b are
// ready" for each consumer warpgroup (producers arrive, that warpgroup
// waits) and "buffer b is free" (consumers arrive, producers wait), for up
// to 4 buffers.
constexpr int BAR_PRODUCERS = 1, BAR_CONSUMERS = 2;
__device__ __forceinline__ int bar_full(int buf, int wg) {
  return 3 + 2 * buf + wg;
}
__device__ __forceinline__ int bar_empty(int buf) { return 11 + buf; }

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// One stage's products into d: the stage's first product adds into d when
// add is 1 and overwrites it when 0.  3xTF32: for each 8-deep half the two
// cross terms lo*hi' and hi*lo', then the two hi*hi' terms.  bf16: the two
// 16-deep halves.  A row is 64 bytes (16 words).
template <class C>
__device__ __forceinline__ void stage_products(const OpSmem<C>& sm, int buf,
                                               int wg,
                                               float (&d)[C::MI][C::ACC],
                                               int add) {
  const uint64_t bh = op_desc(sm.b_hi(buf));
  if constexpr (C::P::NOP == 1) {
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
      const int row0 = (wg * C::MI + mi) * 64;
      const uint64_t ah = op_desc(sm.a_hi(buf) + row0 * 16);
      // +32 bytes (2 in descriptor units) = the second 16-deep half
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_bf16(d[mi], ah + 2 * h, bh + 2 * h, add | h);
    }
  } else {
    const uint64_t bl = op_desc(sm.b_lo(buf));
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
      const int row0 = (wg * C::MI + mi) * 64;
      const uint64_t ah = op_desc(sm.a_hi(buf) + row0 * 16);
      const uint64_t al = op_desc(sm.a_lo(buf) + row0 * 16);
      // +32 bytes (2 in descriptor units) = the second 8-deep half
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_tf32(d[mi], al + 2 * h, bh + 2 * h, add | h);
        wgmma_tf32(d[mi], ah + 2 * h, bl + 2 * h, 1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_tf32(d[mi], ah + 2 * h, bh + 2 * h, 1);
    }
  }
}

// Consumer side of out[row][col] = sum_k A[k][row] Bm[k][col] over `steps`
// stages; the result is left as the (TN, TM) tile sm.out[col * OA + row].
// Thread ct = threadIdx.x < THREADS.  The stages go in chains of J =
// P::CHAIN: a chain's products add up in the wgmma accumulators t (its
// first one overwrites them), and a stage's products stay in flight while
// the consumers pass the next stage's barrier and issue its products; after
// each commit they wait until only that stage is pending, so the one before
// is complete and its operand buffer is freed.  At a chain's end they wait
// for all, free its last buffer and add t into the fp32 sums acc.  The
// tensor cores round their own sums another way than fp32, so chains are
// short (3xTF32 one stage, see "Precision"; bf16 four, see "bfloat16
// instance"); J = 1 waits for every stage.  A buffer is freed with
// C::EMPTY_MBAR by lane 0 of each warp on empty[buf], else by all on the
// named barrier bar_empty(buf).  The epilogue's tile overwrites the
// operand buffers after the last chain.
template <class C>
__device__ __forceinline__ void consume(const OpSmem<C>& sm, int steps,
                                        uint64_t* empty = nullptr) {
  constexpr int J = C::P::CHAIN, NBUF = C::NBUF;
  const int ct = threadIdx.x, wg = ct >> 7;
  float acc[C::MI][C::ACC], t[C::MI][C::ACC];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) acc[mi][i] = t[mi][i] = 0.f;
  auto release = [&](int kt) {   // stage kt's operands were read
    if (kt + NBUF >= steps) return;
    if constexpr (C::EMPTY_MBAR) {
      if ((ct & 31) == 0) mbar_arrive(empty + kt % NBUF);
    } else {
      bar_arrive(bar_empty(kt % NBUF), 2 * THREADS);
    }
  };

  for (int k0 = 0; k0 < steps; k0 += J) {
    const int n = steps - k0 < J ? steps - k0 : J;
    for (int j = 0; j < n; ++j) {
      const int kt = k0 + j, buf = kt % NBUF;
      bar_sync(bar_full(buf, wg), THREADS + 128);
      wgmma_fence();
      stage_products<C>(sm, buf, wg, t, j > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (j > 0) release(kt - 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) fence_regs(t[mi]);
    release(k0 + n - 1);
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
  constexpr int NBUF = C::NBUF;
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

// conv2x2 operands, float32: rows are pixels, k = ci*4 + tap, a stage is
// BK / 4 input channels.  Producer thread pt copies and transforms the 4
// taps of pixel pt % TM in channels pt / TM + TPP j.  The weight tile (TN x
// BK of the K-major (N, ldw) weight) is copied 16 bytes a thread with k
// fastest (coalesced) and transformed with n fastest (conflict-free).
template <class C>
struct ConvLoader {
  using T = typename C::T;
  using R = typename C::R;
  static constexpr int CPS = C::BK / 4;              // channels a stage
  static constexpr int TPP = THREADS / C::TM;        // threads per pixel
  static constexpr int CPT = CPS / TPP;              // channels a thread
  static constexpr int EPC = 16 / (int)sizeof(T);    // elements a chunk
  static constexpr int WPT = (4 * C::TN + THREADS - 1) / THREADS;
  static_assert(C::P::NOP == 2, "the bf16 conv takes SpanLoader");
  const Smem<C>& sm;
  const T* __restrict__ x;
  const T* __restrict__ w;
  int flags, cin, hw, win, n_out, n0, pt, row, c0;
  Taps taps;

  __device__ void issue(int kt, int slot) const {
    R* ra = sm.raw_a + slot * C::RAW_A;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = c0 + TPP * j;
      taps.copy(x, kt * CPS + c, cin, hw, win, ra + c * 4 * C::RA + row,
                C::RA);
    }
    R* rb = sm.raw_b + slot * C::RAW_B;
    const int ldw = C::P::ldw(cin);
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int e = pt + i * THREADS;
      if (e >= 4 * C::TN) break;
      const int n = e >> 2, c = e & 3;
      const int k = kt * C::BK + c * EPC;
      const bool ok = k < ldw && n0 + n < n_out;
      cp_async16(rb + n * C::RBC + c * 4,
                 ok ? w + (long long)(n0 + n) * ldw + k : w, ok);
    }
  }

  __device__ void transform(int kt, int slot, int buf) const {
    const R* ra = sm.raw_a + slot * C::RAW_A;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = c0 + TPP * j, ci = kt * CPS + c;
      const bool ok = ci < cin;
      float s = 1.f, t = 0.f;
      if ((flags & IN_AFFINE) && ok) {
        s = sm.st[ci];
        t = sm.st[cin + ci];
      }
      float v[4];
#pragma unroll
      for (int tap = 0; tap < 4; ++tap)
        v[tap] = ra[(c * 4 + tap) * C::RA + row];
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const bool in = ok && (taps.inside >> tap & 1);
        v[tap] = in ? in_stage(v[tap], s, t, flags) : 0.f;
      }
      store_split4(sm.a_hi(buf), sm.a_lo(buf), op_offset(row, c * 4), v);
    }
    const R* rb = sm.raw_b + slot * C::RAW_B;
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

// Slot room of a run of L elements copied in whole 16-byte chunks: it
// starts at most 7 elements before its first and ends at most 7 after its
// last (span_elems and the header comment).
__host__ __device__ __forceinline__ int run_cap(int len) {
  return (len + 14) & ~7;
}

// Offset in x's channel plane (may be negative: padding) of the tap (0, 0)
// of output pixel r of an image.
__device__ __forceinline__ int tap_base(int r, int wo, int win, int pad) {
  const int oy = r / wo;
  return (oy - pad) * win + (r - oy * wo) - pad;
}

// conv2x2 operands, bfloat16, from channel spans (the header's "bfloat16
// instance").  The tile's TM pixels are consecutive in (b, oy, ox), so in
// each image they touch, the in-image taps of one channel lie in one run
// [lo, hi) of the channel plane: lo = max(0, tap_base(first pixel)), hi =
// min(hw, tap_base(last pixel) + win + 2).  Run r of the tile (image b0 +
// r) is copied for every channel of a stage, widened to 16-byte chunks,
// into region c of the slot at R_r = run_cap(run 0) + (r - 1)
// run_cap(hw) (runs between the first and the last cover whole planes), by
// one bulk copy on the slot's mbarrier.  The transform reads each tap with
// a 2-byte shared load.
template <class C>
struct SpanLoader {
  static constexpr int CPS = C::CPS;                 // channels a stage
  static constexpr int TPP = THREADS / C::TM;        // threads per pixel
  static constexpr int CPT = CPS / TPP;              // channels a thread
  const SpanSmem<C>& sm;
  const uint16_t* __restrict__ x;
  const uint16_t* __restrict__ w;
  int flags, cin, hw, win, n_out, n0, pt, row, c0;
  // the tile's runs: first image, count, run 0's [lo0, lo0 + len0), the
  // last run's end
  int b0, nr, lo0, len0, hi_last;
  // this thread's pixel: the masks of its taps' bf16 lanes (taps (0,0),
  // (0,1); (1,0), (1,1): all ones inside the image), the offset of its tap
  // (0, 0) in a channel region less the region's chunk shift, and the
  // plane offset q of its run's start at channel 0 (the shift of channel ci
  // is (q + ci hw) % 8)
  uint32_t m01, m23;
  int d, q;

  // Warp c of the producers copies channel c of the stage, lane r (+ 32 k)
  // its run r.  Lane 0 announces the warp's bytes before any of them is
  // copied: the phase cannot complete early.
  __device__ void issue(int kt, int slot) const {
    static_assert(THREADS / 32 == CPS, "a producer warp a channel");
    uint64_t* bar = sm.full + slot;
    const int c = pt >> 5, ci = kt * CPS + c;
    int bytes = 0;
    if (ci < cin)
      for (int r = pt & 31; r < nr; r += 32) {
        const int p = ((b0 + r) * cin + ci) * hw;
        const int lo = r == 0 ? lo0 : 0, hi = r == nr - 1 ? hi_last : hw;
        bytes += 2 * (((p + hi + 7) & ~7) - ((p + lo) & ~7));
      }
    bytes = __reduce_add_sync(0xffffffffu, bytes);
    if ((pt & 31) == 0) mbar_arrive_expect(bar, bytes);
    __syncwarp();
    uint16_t* ring = sm.ring + (slot * CPS + c) * sm.span;
    if (ci < cin)
      for (int r = pt & 31; r < nr; r += 32) {
        const int p = ((b0 + r) * cin + ci) * hw;
        const int lo = r == 0 ? lo0 : 0, hi = r == nr - 1 ? hi_last : hw;
        const int s = (p + lo) & ~7, e = (p + hi + 7) & ~7;
        const int dst = r == 0 ? 0 : run_cap(len0) + (r - 1) * run_cap(hw);
        bulk_copy(ring + dst, x + s, 2 * (e - s), bar);
      }
  }

  // The weight rows of stage kt (the caller's stage-major copy, each row's
  // 16-byte chunks already in their swizzled places) straight into operand
  // buffer buf, by the last thread.  Rows past n_out keep stale values:
  // their columns are never stored.
  __device__ void issue_weights(int kt, int buf) const {
    if (pt != THREADS - 1) return;
    const int nv = n_out - n0 < C::TN ? n_out - n0 : C::TN;
    mbar_arrive_expect(sm.wfull + buf, 64 * nv);
    bulk_copy(sm.b_hi(buf), w + ((long long)kt * n_out + n0) * 32, 64 * nv,
              sm.wfull + buf);
  }

  __device__ void transform(int kt, int slot, int buf) const {
    mbar_wait(sm.full + slot, (kt / STAGES) & 1);
    // every load of the stage first, then the stores (a store to the
    // operand tile could alias a later load for all the compiler knows)
    const uint16_t* ring = sm.ring + slot * CPS * sm.span;
    const int c_first = c0 * CPT, ci0 = kt * CPS + c_first;
    const int off[4] = {0, 1, win, win + 1};
    uint32_t h[CPT][2];          // taps (0,0), (0,1); (1,0), (1,1)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const uint16_t* p =
          ring + (c_first + j) * sm.span + d + ((q + (ci0 + j) * hw) & 7);
      // unmasked: a tap outside the image, or of a channel past cin, reads
      // whatever lies there, at most win + 1 elements before a channel
      // region (in the operand buffers) or win + 8 past it (in the next
      // region, or the room the launch leaves past the ring), and is masked
      // below
      uint32_t v[4];
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) v[tap] = p[off[tap]];
      h[j][0] = v[0] | v[1] << 16;
      h[j][1] = v[2] | v[3] << 16;
    }
    // the input stage on bf16 pairs, then the taps outside the image (and
    // the channels past cin) to 0; k = 4c .. 4c + 3 of channel c, two
    // channels a 16-byte chunk
#pragma unroll
    for (int j = 0; j < CPT; j += 2) {
      uint32_t u[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int ci = ci0 + j + jj;
        uint32_t z01 = h[j + jj][0], z23 = h[j + jj][1];
        if ((flags & IN_AFFINE) && ci < cin) {
          const uint32_t s2 = __float_as_uint(sm.st[ci]);
          const uint32_t t2 = __float_as_uint(sm.st[cin + ci]);
          z01 = add_bf2(mul_bf2(z01, s2), t2);
          z23 = add_bf2(mul_bf2(z23, s2), t2);
        }
        if (flags & IN_RELU) {
          z01 = relu_bf2(z01);
          z23 = relu_bf2(z23);
        }
        const bool ok = ci < cin;
        u[2 * jj] = ok ? z01 & m01 : 0u;
        u[2 * jj + 1] = ok ? z23 & m23 : 0u;
      }
      *reinterpret_cast<uint4*>(sm.a_hi(buf) +
                                op_offset(row, 2 * (c_first + j))) =
          make_uint4(u[0], u[1], u[2], u[3]);
    }
  }

  // The tile's runs, and this thread's pixel m (valid: m < M) of image b,
  // r in it.
  __device__ void at(long long m0, long long M, int hwo, int wo, int pad,
                     bool valid, int b, int r) {
    const long long m_last = (m0 + C::TM < M ? m0 + C::TM : M) - 1;
    b0 = (int)(m0 / hwo);
    const int bl = (int)(m_last / hwo);
    nr = bl - b0 + 1;
    const int rf = (int)(m0 - (long long)b0 * hwo);
    const int rl = (int)(m_last - (long long)bl * hwo);
    const int bf = tap_base(rf, wo, win, pad);
    lo0 = bf > 0 ? bf : 0;
    const int end = tap_base(rl, wo, win, pad) + win + 2;
    hi_last = end < hw ? end : hw;
    len0 = (nr == 1 ? hi_last : hw) - lo0;

    Taps taps;
    taps.at(b, r / wo, r % wo, cin, hw / win, win, pad, valid);
    const int inside = taps.inside;    // 0 past the last pixel
    m01 = (inside & 1 ? 0xFFFFu : 0u) | (inside & 2 ? 0xFFFF0000u : 0u);
    m23 = (inside & 4 ? 0xFFFFu : 0u) | (inside & 8 ? 0xFFFF0000u : 0u);
    d = q = 0;
    if (valid) {
      const int rr = b - b0, lo = rr == 0 ? lo0 : 0;
      const int dst = rr == 0 ? 0 : run_cap(len0) + (rr - 1) * run_cap(hw);
      d = dst + tap_base(r, wo, win, pad) - lo;
      q = b * cin * hw + lo;
    }
  }
};

// Producer side over the span ring: the producers issue each stage's bulk
// copies STAGES - 1 stages ahead; every producer waits on the slot's
// mbarrier and transforms it into buffer kt % NBUF, up to NBUF stages
// ahead of the consumers.  The producers' barrier at the top of a stage
// means that all of them are done with the slot the new copies overwrite
// (each read it before its fence).  The weight rows of stage kt + 1 go to
// their buffer as soon as the consumers have freed it, one stage ahead.
// The fence that publishes the tiles waits for none of the copies: they
// run in the async proxy.
template <class C>
__device__ __forceinline__ void produce_spans(const SpanLoader<C>& ld,
                                              int steps) {
  constexpr int NBUF = C::NBUF;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < steps) ld.issue(s, s);
  ld.issue_weights(0, 0);
  for (int kt = 0; kt < steps; ++kt) {
    bar_sync(BAR_PRODUCERS, THREADS);
    if (kt + STAGES - 1 < steps)
      ld.issue(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    const int buf = kt % NBUF;
    ld.transform(kt, kt % STAGES, buf);
    if (kt + 1 < steps) {
      const int next = (kt + 1) % NBUF;
      if (kt + 1 >= NBUF) bar_sync(bar_empty(next), 2 * THREADS);
      ld.issue_weights(kt + 1, next);
    }
    mbar_wait(ld.sm.wfull + buf, (kt / NBUF) & 1);
    fence_proxy_async();
    bar_arrive(bar_full(buf, 0), THREADS + 128);
    bar_arrive(bar_full(buf, 1), THREADS + 128);
  }
}

// wgrad operands, float32: rows are the im2col columns (ci, tap) from k0,
// k the pixels of the chunk, BK a stage.  Producer thread pt copies pixel
// lane pt % BK of channels pt / BK + NG j and of gradient channels pt / BK
// + NG i; its tap mask for each slot waits in sm.mask until the transform.
template <class C>
struct WgradLoader {
  using T = typename C::T;
  using R = typename C::R;
  static constexpr int NG = THREADS / C::BK;         // lane groups
  static constexpr int APT = C::TM / 4 / NG;         // channels a thread
  static constexpr int GPT = (C::TN + NG - 1) / NG;
  static_assert(C::P::NOP == 2, "the bf16 wgrad takes WgradSpanLoader");
  const Smem<C>& sm;
  const T* __restrict__ g;
  const T* __restrict__ x;
  int flags, cin, hin, win, ho, wo, n_out, n0, k0, pad, pt, p, q;
  long long m, m_end;
  int b, oy, ox;

  __device__ void issue(int, int slot) {
    const bool pv = m < m_end;
    Taps taps;
    taps.at(b, oy, ox, cin, hin, win, pad, pv);
    const int hwo = ho * wo;
    const long long gbase = (long long)b * n_out * hwo + oy * wo + ox;
    // bits 4 and 5 (the index parities of the x and g offsets) are not
    // read; storing them keeps the schedule ptxas gives this loop (without
    // them the 280 -> 280 backward took 0.8% longer on the card)
    sm.mask[slot * THREADS + pt] = (unsigned char)(
        taps.inside | (taps.base & 1) << 4 | (int)(gbase & 1) << 5);
    R* ra = sm.raw_a + slot * C::RAW_A + p * C::RA;
#pragma unroll
    for (int j = 0; j < APT; ++j) {
      const int c = q + NG * j;
      taps.copy(x, k0 / 4 + c, cin, hin * win, win, ra + c * 4, 1);
    }
    R* rb = sm.raw_b + slot * C::RAW_B + p * C::RB;
    const T* gp = g + gbase + (long long)(n0 + q) * hwo;
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int n = q + NG * i;
      if (n >= C::TN) break;
      const bool ok = pv && n0 + n < n_out;
      cp_async4(rb + n, ok ? gp : g, ok);
      gp += (long long)NG * hwo;
    }
    // this thread's pixel of the next stage
    m += C::BK;
    ox += C::BK;
    while (ox >= wo) {
      ox -= wo;
      if (++oy == ho) {
        oy = 0;
        ++b;
      }
    }
  }

  __device__ void transform(int, int slot, int buf) const {
    const int inside = sm.mask[slot * THREADS + pt];   // bits 0-3 read
    const R* ra = sm.raw_a + slot * C::RAW_A + p * C::RA;
    float* ahi = sm.a_hi(buf);
    float* alo = sm.a_lo(buf);
#pragma unroll
    for (int j = 0; j < APT; ++j) {
      const int c = q + NG * j, ci = k0 / 4 + c;
      const bool ok = ci < cin;
      float s = 1.f, t = 0.f;
      if ((flags & IN_AFFINE) && ok) {
        s = sm.st[ci];
        t = sm.st[cin + ci];
      }
      float v[4];
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) v[tap] = ra[c * 4 + tap];
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const bool in = ok && (inside >> tap & 1);
        const float z = in ? in_stage(v[tap], s, t, flags) : 0.f;
        const float2 zs = split_tf32(z);
        const int off = op_offset(c * 4 + tap, p);
        ahi[off] = zs.x;
        alo[off] = zs.y;
      }
    }
    const R* rb = sm.raw_b + slot * C::RAW_B + p * C::RB;
    float* bhi = sm.b_hi(buf);
    float* blo = sm.b_lo(buf);
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int n = q + NG * i;
      if (n >= C::TN) break;
      const float2 z = split_tf32(rb[n]);
      const int off = op_offset(n, p);
      bhi[off] = z.x;
      blo[off] = z.y;
    }
  }
};

// wgrad operands, bfloat16, from spans (the header's "bfloat16 instance").
// The copies go by groups of D = WGRAD_GROUP stages (PIX pixels): a
// group's pixels are consecutive in (b, oy, ox), so in each image they
// touch, the taps of one x channel lie in one run [lo, hi) of its plane:
// lo = max(0, tap_base(first pixel)), hi = min(hw, tap_base(last pixel) +
// win + 2), and the group's values of one gradient channel in one run of
// that channel's plane.  Run r of a group (image b0 + r) goes to offset 0
// (r = 0) or run_cap(run 0) + (r - 1) run_cap(plane) of the channel's
// region (runs between the first and the last cover whole planes); the
// two halves of the ring hold two groups.  Copy item e = 8 lane + warp of
// the producers (x channel k0 / 4 + e, or gradient channel n0 + e - CA)
// is one bulk copy a run, all issued at the first stage of the group
// before.  (A warp stalls while its lanes issue bulk copies, so the items
// are spread over the 8 warps; spread over the stages of the group before
// as well, the last ones landed too late.)  In the transform, a warp
// instruction writes two rows of a tile, lane (hi16, k) = (lane >> 4,
// lane & 15) word k (pixels 2 k, 2 k + 1) of the second row if hi16: row
// pairs (c, dy) of the A tile, taps (dy, 0) and (dy, 1) of x channel c
// (pair w + 8 i of warp w), and gradient rows 2 q, 2 q + 1 (pair q = w +
// 8 i).  So the lanes of a load read 32 consecutive elements of a region
// or two, and those of a store 128 bytes.
template <class C>
struct WgradSpanLoader {
  static constexpr int BK = C::BK, CA = C::CA, D = WGRAD_GROUP;
  static constexpr int PIX = C::PIX, ITEMS = CA + C::TN;
  static constexpr int APT = CA * 2 / 8;            // A row pairs a thread
  static constexpr int BPT = (C::TN / 2 + 7) / 8;   // B row pairs a thread
  static constexpr int VALID_BIT = 12;     // pixel-table bit: m < m_end
  static_assert(THREADS == 256 && BK == 32 && CA * 2 % 8 == 0,
                "8 producer warps; 16 words a row; lane = pixel");
  static_assert(ITEMS <= THREADS && PIX <= THREADS,
                "a copy item, a table pixel, a thread");
  const WgradSpanSmem<C>& sm;
  const uint16_t* __restrict__ g;
  const uint16_t* __restrict__ x;
  int flags, cin, hin, win, hw, wo, hwo, n_out, n0, k0, pad, pt;
  int m_begin, m_end;
  // the runs of the group planned last: its first image and run count,
  // the x runs' first start, last end and run 0's slot room, and the
  // gradient runs' likewise
  int b0, nr, lo_a, hi_a, cap_a, r0, hi_g, cap_g;
  // the input stage of this thread's channels (pt >> 6) + 4 i: bf16 si in
  // the low half, ti in the high half
  uint32_t st[APT];

  __device__ void load_affine() {
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int ci = k0 / 4 + (pt >> 6) + 4 * i;
      st[i] = 0;
      if ((flags & IN_AFFINE) && ci < cin)
        st[i] = __byte_perm(__float_as_uint(sm.st[ci]),
                            __float_as_uint(sm.st[cin + ci]), 0x5410);
    }
  }

  // Image, offset in its (Ho, Wo) plane and tap (0, 0) offset in x's
  // plane of pixel m.
  __device__ void pixel(int m, int& b, int& r, int& tb) const {
    b = m / hwo;
    r = m - b * hwo;
    const int oy = r / wo;
    tb = (oy - pad) * win + (r - oy * wo) - pad;
  }

  // The runs of this thread's copy item: f(source, chunked start, chunked
  // end, slot place) for each.
  template <class F>
  __device__ void item_runs(int half, F f) const {
    const int e = 8 * (pt & 31) + (pt >> 5);
    const uint16_t* src;
    int p, step, plane, lo, hi, cap0;
    uint16_t* dst = sm.ring + half * sm.slot;
    if (e < CA && k0 / 4 + e < cin) {
      src = x;
      p = (b0 * cin + k0 / 4 + e) * hw;
      step = cin * hw;
      plane = hw;
      lo = lo_a;
      hi = hi_a;
      cap0 = cap_a;
      dst += e * sm.span_a;
    } else if (e >= CA && e < ITEMS && n0 + e - CA < n_out) {
      src = g;
      p = (b0 * n_out + n0 + e - CA) * hwo;
      step = n_out * hwo;
      plane = hwo;
      lo = r0;
      hi = hi_g;
      cap0 = cap_g;
      dst += CA * sm.span_a + (e - CA) * sm.span_b;
    } else {
      return;
    }
    for (int rr = 0; rr < nr; ++rr) {
      const int q = p + rr * step;
      const int s = (q + (rr ? 0 : lo)) & ~7;
      const int end = (q + (rr == nr - 1 ? hi : plane) + 7) & ~7;
      f(src, s, end, dst + (rr ? cap0 + (rr - 1) * run_cap(plane) : 0));
    }
  }

  // Issue group G into ring half `half`: its runs (from its first and last
  // pixels), its pixel table (warps 0 .. D - 1, lane = pixel), each warp's
  // bytes on the half's mbarrier, then the copies.  A table entry holds the
  // pixel's x-region offset of its tap (0, 0) less the run's chunk shift
  // (.x), its gradient-region offset likewise (.y), and (.z) its in-image
  // taps (bits 0-3), the shifts' pixel parts mod 8 (x: bits 4-6, gradient:
  // 8-10; a channel adds its plane offset) and VALID_BIT.  Lane 0 of each
  // warp announces the warp's bytes before any of them is copied: the
  // phase cannot complete early.
  __device__ void issue(int G, int half) {
    const int m0 = m_begin + G * PIX;
    const int m1 = (m0 + PIX < m_end ? m0 + PIX : m_end) - 1;
    int bl, rl, t0, tl;
    pixel(m0, b0, r0, t0);
    pixel(m1, bl, rl, tl);
    nr = bl - b0 + 1;
    lo_a = t0 > 0 ? t0 : 0;
    hi_a = tl + win + 2 < hw ? tl + win + 2 : hw;
    cap_a = run_cap((nr == 1 ? hi_a : hw) - lo_a);
    hi_g = rl + 1;
    cap_g = run_cap((nr == 1 ? hi_g : hwo) - r0);
    if (pt < PIX) {
      int4 e = make_int4(0, 0, 0, 0);
      const int m = m0 + pt;
      if (m < m_end) {
        int b, r, tb;
        pixel(m, b, r, tb);
        const int rr = b - b0, la = rr ? 0 : lo_a, lg = rr ? 0 : r0;
        const int oy = r / wo;
        Taps taps;
        taps.at(b, oy, r - oy * wo, cin, hin, win, pad, true);
        e.x = (rr ? cap_a + (rr - 1) * run_cap(hw) : 0) + tb - la;
        e.y = (rr ? cap_g + (rr - 1) * run_cap(hwo) : 0) + r - lg;
        e.z = taps.inside | ((b * cin * hw + la) & 7) << 4 |
              ((b * n_out * hwo + lg) & 7) << 8 | 1 << VALID_BIT;
      }
      sm.pix[half * PIX + pt] = e;
    }
    int bytes = 0;
    item_runs(half, [&](const uint16_t*, int s, int end, uint16_t*) {
      bytes += 2 * (end - s);
    });
    bytes = __reduce_add_sync(0xffffffffu, bytes);
    if ((pt & 31) == 0) mbar_arrive_expect(sm.full + half, bytes);
    __syncwarp();
    item_runs(half, [&](const uint16_t* src, int s, int end, uint16_t* dst) {
      bulk_copy(dst, src + s, 2 * (end - s), sm.full + half);
    });
  }

  // The bf16 lanes of a pair of pixels kept by `bit` of their table words.
  __device__ static uint32_t lanes(int z0, int z1, int bit) {
    return (z0 >> bit & 1 ? 0xFFFFu : 0u) | (z1 >> bit & 1 ? 0xFFFF0000u : 0u);
  }

  __device__ void transform(int kt, int buf) const {
    const int half = kt / D & 1;
    mbar_wait(sm.full + half, kt / D >> 1 & 1);
    // every load of the stage first, then the stores (a store to the
    // operand tile could alias a later load for all the compiler knows)
    const int w = pt >> 5, hi16 = pt >> 4 & 1, k = pt & 15, dy = w & 1;
    const uint16_t* ring = sm.ring + half * sm.slot;
    const int4* px = sm.pix + half * PIX + kt % D * BK + 2 * k;
    const int4 e0 = px[0], e1 = px[1];
    // A: taps (dy, hi16) of pixels 2 k, 2 k + 1 of channels ca + 4 i.  The
    // chunk shift of channel ci is (q + ci hw) & 7, so it steps by 4 hw & 7
    // (0 or 4) with i.  A tap outside the image, or of a channel past cin,
    // reads whatever lies there, at most win + 1 elements before the
    // channel's region (in the operand buffers) or win + 8 past it (in the
    // next region, or the room the launch leaves past the ring), and is
    // masked below.
    const int ca = k0 / 4 + (w >> 1);
    int oa0[2], oa1[2];
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int sc = (unsigned)(ca + 4 * odd) * (unsigned)hw & 7u;
      oa0[odd] = e0.x + (((e0.z >> 4) + sc) & 7);
      oa1[odd] = e1.x + (((e1.z >> 4) + sc) & 7);
    }
    const uint16_t* pa = ring + (w >> 1) * sm.span_a + dy * win + hi16;
    uint32_t a[APT];
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const uint16_t* p = pa + 4 * i * sm.span_a;
      a[i] = (uint32_t)p[oa0[i & 1]] | (uint32_t)p[oa1[i & 1]] << 16;
    }
    // B: rows nb + 16 i; their chunk shift (q + (n0 + n) hwo) & 7 does not
    // step with i
    const int nb = 2 * w + hi16;
    const int sg = (unsigned)(n0 + nb) * (unsigned)hwo & 7u;
    const int ob0 = e0.y + (((e0.z >> 8) + sg) & 7);
    const int ob1 = e1.y + (((e1.z >> 8) + sg) & 7);
    const uint16_t* pb = ring + CA * sm.span_a + nb * sm.span_b;
    uint32_t gv[BPT];
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const uint16_t* p = pb + 16 * i * sm.span_b;
      gv[i] = nb + 16 * i < C::TN
                  ? (uint32_t)p[ob0] | (uint32_t)p[ob1] << 16
                  : 0u;
    }
    // A: the input stage on bf16 pairs, then the taps outside the image
    // (and the pixels past the chunk's end) to 0; row c * 4 + tap, 16 rows
    // (256 words) further a step
    const int tap = 2 * dy + hi16;
    const uint32_t ma = lanes(e0.z, e1.z, tap);
    uint32_t* ahi = reinterpret_cast<uint32_t*>(sm.a_hi(buf)) +
                    op_offset(4 * (w >> 1) + tap, k);
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int ci = ca + 4 * i;
      if (ci >= cin) break;
      uint32_t u = a[i];
      if (flags & IN_AFFINE)
        u = add_bf2(mul_bf2(u, __byte_perm(st[i], 0, 0x1010)),
                    __byte_perm(st[i], 0, 0x3232));
      if (flags & IN_RELU) u = relu_bf2(u);
      ahi[256 * i] = u & ma;
    }
    // B: the pixels past the chunk's end to 0; rows past n_out are never
    // stored (their columns are not either)
    const uint32_t mv = lanes(e0.z, e1.z, VALID_BIT);
    uint32_t* bhi = reinterpret_cast<uint32_t*>(sm.b_hi(buf)) +
                    op_offset(nb, k);
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int n = nb + 16 * i;
      if (n < C::TN && n0 + n < n_out) bhi[256 * i] = gv[i] & mv;
    }
  }
};

// Producer side over the wgrad's span ring: group 0 is issued before the
// loop, group G + 1 at the first stage of group G, into the other half of
// the ring.  Every producer waits on the half's mbarrier and
// transforms stage kt into buffer kt % NBUF once the consumers have freed
// that (on an mbarrier: the producers do not wait for each other there,
// so a warp's latencies overlap the others' work).  The producers'
// barrier at the first stage of a group means that all of them are done
// with the half (and its pixel table) that the next group overwrites;
// within a group nothing they share is overwritten.
template <class C>
__device__ __forceinline__ void produce_wgrad_spans(WgradSpanLoader<C>& ld,
                                                    int steps) {
  constexpr int D = WGRAD_GROUP, NBUF = C::NBUF;
  const int groups = (steps + D - 1) / D;
  ld.issue(0, 0);
  for (int kt = 0; kt < steps; ++kt) {
    const int G = kt / D;
    if (kt % D == 0) {
      bar_sync(BAR_PRODUCERS, THREADS);
      if (G + 1 < groups) ld.issue(G + 1, (G + 1) & 1);
    }
    const int buf = kt % NBUF;
    if (kt >= NBUF) mbar_wait(ld.sm.empty + buf, (kt / NBUF - 1) & 1);
    ld.transform(kt, buf);
    fence_proxy_async();
    bar_arrive(bar_full(buf, 0), THREADS + 128);
    bar_arrive(bar_full(buf, 1), THREADS + 128);
  }
}

// si, ti into shared memory, read by every stage's transform (rounded to
// bf16 for the bf16 instance's input stage; for the span transform, both
// lanes of a bf16 pair).
template <class C>
__device__ __forceinline__ void stage_affine(const OpSmem<C>& sm,
                                             const float* __restrict__ si,
                                             const float* __restrict__ ti,
                                             int flags, int cin) {
  if (flags & IN_AFFINE)
    for (int i = threadIdx.x; i < cin; i += 2 * THREADS) {
      float s = __ldg(si + i), t = __ldg(ti + i);
      if constexpr (C::P::NOP == 1) {
        s = rbf(s);
        t = rbf(t);
      }
      if constexpr (C::SPANS) {     // both bf16 lanes of a pair, as bits
        s = __uint_as_float(splat_bf2(s));
        t = __uint_as_float(splat_bf2(t));
      }
      sm.st[i] = s;
      sm.st[cin + i] = t;
    }
  __syncthreads();
}

// out (B, N, Ho, Wo) = conv2x2(in_stage(x), pad) with x (B, Cin, Hin, Win),
// Ho = Hin + 2 pad - 1.  fp32: w is the K-major (N, 4 Cin) GEMM weight
// (OIHW flattened, k = ci*4 + tap).  bf16: w is stage-major (steps, N, 32)
// (K zero-padded to whole stages), x is 16-byte aligned and its allocation
// runs on to the next 16-byte boundary, and span is span_elems.  out_f,
// when given, also takes the fp32 values (bf16: y2 before rounding).
template <class C, class O>
__global__ void __launch_bounds__(2 * THREADS, 1)
conv2x2_kernel(const typename C::T* __restrict__ x,
               const float* __restrict__ si, const float* __restrict__ ti,
               int flags, const typename C::T* __restrict__ w,
               const float* __restrict__ bias,
               const typename C::T* __restrict__ mask, O* __restrict__ out,
               float* __restrict__ out_f, int B, int cin, int hin, int win,
               int n_out, int pad, int epi, int span) {
  extern __shared__ __align__(1024) unsigned char smem[];
  using S = typename std::conditional<C::SPANS, SpanSmem<C>, Smem<C>>::type;
  const S sm(smem, span);
  if constexpr (C::SPANS) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s)
        mbar_init(sm.full + s, THREADS / 32);
      for (int b = 0; b < C::NBUF; ++b) mbar_init(sm.wfull + b, 1);
      fence_mbar_init();
    }
  }
  stage_affine<C>(sm, si, ti, flags, cin);     // and the block's barrier
  const int ho = hin + 2 * pad - 1, wo = win + 2 * pad - 1;
  const int hwo = ho * wo;
  const long long M = (long long)B * hwo;
  const long long m0 = (long long)blockIdx.x * C::TM;
  const int n0 = blockIdx.y * C::TN;
  const int steps = (cin + C::BK / 4 - 1) / (C::BK / 4);
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
        v = to_f(__ldg(mask + o)) > 0.f ? v : 0.f;
      } else {
        if (bias != nullptr) v += __ldg(bias + n0 + n);
        if (epi == EPI_BIAS_RELU) v = fmaxf(v, 0.f);
      }
      put(out + o, v);
      if (out_f != nullptr) out_f[o] = v;
    }
  } else {
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = threadIdx.x - THREADS;
    if constexpr (C::SPANS) {
      SpanLoader<C> ld{sm, x, w, flags, cin, hin * win, win, n_out, n0, pt,
                       row, pt / C::TM};
      ld.at(m0, M, hwo, wo, pad, valid, b, r);
      produce_spans<C>(ld, steps);
    } else {
      const int oy = r / wo, ox = r - oy * wo;
      ConvLoader<C> ld{sm, x, w, flags, cin, hin * win, win, n_out, n0, pt,
                       row, pt / C::TM, {}};
      ld.taps.at(b, oy, ox, cin, hin, win, pad, valid);
      produce<C>(ld, sm, steps);
    }
  }
}

// Weight gradient of one conv2x2: part[chunk][n][k] = sum over the chunk's
// pixels m of g[b, n, oy, ox] * A[k][m], A the implicit im2col of
// in_stage(x) with the conv's pad (as in conv2x2_kernel).  Chunks are whole
// stages long (the last one ragged).  bf16: g and x are 16-byte aligned
// and their allocations run on to the next 16-byte boundary, and span_a,
// span_b are wgrad_span_a, wgrad_span_b.
template <class C>
__global__ void __launch_bounds__(2 * THREADS, 1)
wgrad_kernel(const typename C::T* __restrict__ g,
             const typename C::T* __restrict__ x,
             const float* __restrict__ si, const float* __restrict__ ti,
             int flags, float* __restrict__ part, int B, int cin, int hin,
             int win, int n_out, int pad, long long chunk_len, int span_a,
             int span_b) {
  extern __shared__ __align__(1024) unsigned char smem[];
  using S =
      typename std::conditional<C::SPANS, WgradSpanSmem<C>, Smem<C>>::type;
  const S sm(smem, span_a, span_b, win);
  if constexpr (C::SPANS) {
    if (threadIdx.x == 0) {
      for (int h = 0; h < 2; ++h) mbar_init(sm.full + h, THREADS / 32);
      for (int b = 0; b < C::NBUF; ++b)
        mbar_init(sm.empty + b, THREADS / 32);
      fence_mbar_init();
    }
  }
  stage_affine<C>(sm, si, ti, flags, cin);     // and the block's barrier
  const int ho = hin + 2 * pad - 1, wo = win + 2 * pad - 1;
  const int hwo = ho * wo;
  const long long M = (long long)B * hwo;
  const int K = 4 * cin;
  const int k0 = blockIdx.x * C::TM, n0 = blockIdx.y * C::TN;
  const long long m_begin = (long long)blockIdx.z * chunk_len;
  const long long m_end = m_begin + chunk_len < M ? m_begin + chunk_len : M;
  const int steps = (int)((m_end - m_begin + C::BK - 1) / C::BK);

  if (threadIdx.x < THREADS) {
    setmaxnreg_inc<CONSUMER_REGS>();
    if constexpr (C::EMPTY_MBAR)
      consume<C>(sm, steps, sm.empty);
    else
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
    if constexpr (C::SPANS) {
      WgradSpanLoader<C> ld{sm, g, x, flags, cin, hin, win, hin * win, wo,
                            hwo, n_out, n0, k0, pad, pt, (int)m_begin,
                            (int)m_end};
      ld.load_affine();
      produce_wgrad_spans<C>(ld, steps);
    } else {
      // this thread's pixel lane of the first stage
      const long long m = m_begin + pt % C::BK;
      int b = 0, oy = 0, ox = 0;
      if (m < M) {
        b = (int)(m / hwo);
        const int r = (int)(m - (long long)b * hwo);
        oy = r / wo;
        ox = r - oy * wo;
      }
      WgradLoader<C> ld{sm, g, x, flags, cin, hin, win, ho, wo, n_out, n0,
                        k0, pad, pt, pt % C::BK, pt / C::BK, m, m_end, b, oy,
                        ox};
      produce<C>(ld, sm, steps);
    }
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
// per-plane partial sums part[0][b][c] (and part[1][b][c]).  Sums are fp32
// whatever the element types TI (t, u) and TO (out).
//   PLANE_STATS:  sum t, sum t^2                       (t = y2, fp32)
//   PLANE_G2:     g = t + dps + 2 u dpss -> out; sum g (t = dy2, u = y2)
//   PLANE_SUM:    sum t; out (if given) = t            (t = dy1, fp32)
//   PLANE_IN_BWD: dz = in [pre > 0]; sums dz x and dz; out = dz si
//                 (t = x; in and out may be one buffer)
template <int MODE, class TI, class TO>
__global__ void __launch_bounds__(THREADS)
plane_kernel(const TI* __restrict__ t, const TI* __restrict__ u,
             const float* __restrict__ pa, const float* __restrict__ pb,
             int flags, const float* in, TO* out, float* __restrict__ part,
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
    const float v = to_f(__ldg(t + o));
    if (MODE == PLANE_STATS) {
      s1 += v;
      s2 = fmaf(v, v, s2);
    } else if (MODE == PLANE_G2) {
      const float g = v + a + d * to_f(__ldg(u + o));
      put(out + o, g);
      s1 += g;
    } else if (MODE == PLANE_SUM) {
      s1 += v;
      if (out != nullptr) put(out + o, v);
    } else {
      float dz = in[o];
      if ((flags & IN_RELU) && !(in_stage(v, a, d, flags & IN_AFFINE) > 0.f))
        dz = 0.f;
      s1 = fmaf(dz, v, s1);
      s2 += dz;
      put(out + o, (flags & IN_AFFINE) ? dz * a : dz);
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

// The wgrad tile of instance P for n_out output channels.
template <class P>
TileShape wgrad_tile(int n_out) {
  using Tl = WgradTiles<P>;
  switch (pick_tile(n_out)) {
    case TILE8: return {Tl::T8::TM, Tl::T8::TN};
    case TILE32: return {Tl::T32::TM, Tl::T32::TN};
    case TILE72: return {Tl::T72::TM, Tl::T72::TN};
    case TILE112: return {Tl::T112::TM, Tl::T112::TN};
    default: return {Tl::T144::TM, Tl::T144::TN};
  }
}

// Elements of one channel region of a span slot: enough for the runs of
// any tile of TM pixels (see SpanLoader).  A tile touches at most nimg
// images; its runs hold at most TM + nimg (win + 1) elements, with pad 0 at
// most ceil(TM / wo) + nimg more (a row of output pixels steps one element
// further in x than its width), and never more than nimg whole planes; each
// run adds at most 14 elements of 16-byte chunking (run_cap).
int span_elems(int tm, int B, int hin, int win, int pad) {
  const long long wo = win + 2 * pad - 1, hwo = (hin + 2 * pad - 1) * wo;
  const long long hw = (long long)hin * win;
  long long nimg = (tm - 1 + hwo - 1) / hwo + 1;
  if (nimg > B) nimg = B;
  long long need = tm + nimg * (win + 1);
  if (pad == 0) need += (tm + wo - 1) / wo + nimg;
  if (need > nimg * hw) need = nimg * hw;
  need = (need + 14 * nimg + 7) / 8 * 8;
  return need < (1 << 24) ? (int)need : 1 << 24;
}

template <class C, class O>
cudaError_t launch_conv(const typename C::T* x, const float* si,
                        const float* ti, int flags, const typename C::T* w,
                        const float* bias, const typename C::T* mask, O* out,
                        float* out_f, int B, int cin, int hin, int win,
                        int n_out, int pad, int epi, cudaStream_t st) {
  int span = 0;
  long long main = 0;
  if constexpr (C::SPANS) {
    span = span_elems(C::TM, B, hin, win, pad);
    // + room for the unmasked tap loads past the ring (SpanLoader)
    main = C::smem(span) + 2LL * (win + 8);
  } else {
    main = C::SMEM;
  }
  // + si, ti; past the card's 227 KB it refuses the launch
  const long long want = main + 8LL * cin;
  if (want > 232448) return cudaErrorInvalidValue;
  const int smem = (int)want;
  const cudaError_t e = cudaFuncSetAttribute(
      conv2x2_kernel<C, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) {
    cudaGetLastError();          // returned here: not left for a later check
    return e;
  }
  const long long M = (long long)B * (hin + 2 * pad - 1) * (win + 2 * pad - 1);
  const dim3 grid(ceil_div(M, C::TM), ceil_div(n_out, C::TN));
  conv2x2_kernel<C, O><<<grid, 2 * THREADS, smem, st>>>(
      x, si, ti, flags, w, bias, mask, out, out_f, B, cin, hin, win, n_out,
      pad, epi, span);
  return cudaGetLastError();
}

template <class P, class O>
cudaError_t conv2x2(const typename P::T* x, const float* si, const float* ti,
                    int flags, const typename P::T* w, const float* bias,
                    const typename P::T* mask, O* out, float* out_f, int B,
                    int cin, int hin, int win, int n_out, int pad, int epi,
                    cudaStream_t st) {
  using Tl = ConvTiles<P>;
#define MMLF_CONV(CFG)                                                      \
  return launch_conv<typename Tl::CFG, O>(x, si, ti, flags, w, bias, mask, \
                                          out, out_f, B, cin, hin, win,     \
                                          n_out, pad, epi, st)
  switch (pick_tile(n_out)) {
    case TILE8: MMLF_CONV(T8);
    case TILE32: MMLF_CONV(T32);
    case TILE72: MMLF_CONV(T72);
    case TILE112: MMLF_CONV(T112);
    default: MMLF_CONV(T144);
  }
#undef MMLF_CONV
}

// Pixel chunking of one weight gradient: enough blocks to fill the card,
// chunks a multiple of one stage's pixels long and at most
// WGRAD_MAX_CHUNK.
struct Chunks {
  long long len;
  int count;
};

template <class P>
Chunks wgrad_chunks(int B, int cin, int hin, int win, int n_out, int pad) {
  constexpr int bk = P::BK;
  const long long M = (long long)B * (hin + 2 * pad - 1) * (win + 2 * pad - 1);
  const TileShape t = wgrad_tile<P>(n_out);
  const int tiles = ceil_div(4 * cin, t.tm) * ceil_div(n_out, t.tn);
  long long want = ceil_div(WGRAD_TARGET_BLOCKS, tiles);
  if (want < ceil_div(M, WGRAD_MAX_CHUNK)) want = ceil_div(M, WGRAD_MAX_CHUNK);
  const long long most = ceil_div(M, 16 * bk);
  if (want > most) want = most;
  if (want < 1) want = 1;
  Chunks c;
  c.len = (long long)ceil_div(ceil_div(M, want), bk) * bk;
  c.count = ceil_div(M, c.len);
  return c;
}

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Images that a bf16 wgrad copy group's pix pixels touch at most: a group
// starts at m_begin + G pix, a multiple of gcd(chunk length, pix), so at a
// multiple of g = gcd(that, hwo) in its image, at most hwo - g.
long long wgrad_images(int B, long long hwo, long long len, int pix) {
  const long long g = gcd(gcd(len, pix), hwo);
  const long long n = (hwo - g + pix - 1) / hwo + 1;
  return n < B ? n : B;
}

// Elements of one x-channel region of a wgrad span slot: enough for the
// runs of any copy group of pix pixels (see WgradSpanLoader).  A run is at
// most its pixels long, plus win + 1: at pad 1 only in a group that lies
// in one image (a group's pixels at the end of an image have their taps'
// run end at the plane's end, those at its start have it begin at the
// plane's start); at pad 0 in every image, plus one element a row wrap (a
// row of output pixels steps one element further in x than its width).
// Each run adds at most 14 elements of 16-byte chunking (run_cap).
int wgrad_span_a(int B, int hin, int win, int pad, long long len) {
  constexpr int pix = WGRAD_GROUP * Bf16::BK;
  const long long wo = win + 2 * pad - 1, hwo = (hin + 2 * pad - 1) * wo;
  const long long nimg = wgrad_images(B, hwo, len, pix);
  long long need = pix + (pad ? 1 : nimg) * (win + 1);
  if (!pad) need += (pix + wo - 1) / wo + nimg;
  if (need > nimg * hin * win) need = nimg * hin * win;
  need = (need + 14 * nimg + 7) / 8 * 8;
  return need < (1 << 24) ? (int)need : 1 << 24;
}

// ... of one gradient-channel region: its runs hold the group's pixels.
// 32 more than a multiple of 64 elements, so that the two regions a warp
// reads at once (rows 2 q, 2 q + 1) lie 64 bytes apart in the banks.
int wgrad_span_b(int B, long long hwo, long long len) {
  constexpr int pix = WGRAD_GROUP * Bf16::BK;
  const long long nimg = wgrad_images(B, hwo, len, pix);
  long long need = (pix < nimg * hwo ? pix : nimg * hwo) + 14 * nimg;
  need = need <= 32 ? 32 : 32 + (need - 32 + 63) / 64 * 64;
  return need < (1 << 24) ? (int)need : 1 << 24;
}

template <class C>
cudaError_t launch_wgrad(const typename C::T* g, const typename C::T* x,
                         const float* si, const float* ti, int flags,
                         float* part, int B, int cin, int hin, int win,
                         int n_out, int pad, Chunks ch, cudaStream_t st) {
  int span_a = 0, span_b = 0;
  long long main = 0;
  if constexpr (C::SPANS) {
    span_a = wgrad_span_a(B, hin, win, pad, ch.len);
    span_b = wgrad_span_b(
        B, (long long)(hin + 2 * pad - 1) * (win + 2 * pad - 1), ch.len);
    main = C::smem(span_a, span_b, win);
  } else {
    main = C::SMEM;
  }
  // + si, ti; past the card's 227 KB it refuses the launch
  const long long want = main + 8LL * cin;
  if (want > 232448) return cudaErrorInvalidValue;
  const int smem = (int)want;
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
      g, x, si, ti, flags, part, B, cin, hin, win, n_out, pad, ch.len,
      span_a, span_b);
  return cudaGetLastError();
}

template <class P>
cudaError_t wgrad(const typename P::T* g, const typename P::T* x,
                  const float* si, const float* ti, int flags, float* part,
                  float* dw, int B, int cin, int hin, int win, int n_out,
                  int pad, cudaStream_t st) {
  using Tl = WgradTiles<P>;
  const Chunks ch = wgrad_chunks<P>(B, cin, hin, win, n_out, pad);
#define MMLF_WGRAD(CFG)                                                    \
  launch_wgrad<typename Tl::CFG>(g, x, si, ti, flags, part, B, cin, hin,  \
                                 win, n_out, pad, ch, st)
  cudaError_t err;
  switch (pick_tile(n_out)) {
    case TILE8: err = MMLF_WGRAD(T8); break;
    case TILE32: err = MMLF_WGRAD(T32); break;
    case TILE72: err = MMLF_WGRAD(T72); break;
    case TILE112: err = MMLF_WGRAD(T112); break;
    default: err = MMLF_WGRAD(T144);
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

// The bf16 conv's bulk copies read 16-byte chunks.
bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

bool bad_shape(int B, int cin, int H, int W, int cout) {
  return B < 1 || B > 65535 || cin < 1 || cout < 1 || H < 1 || W < 1 ||
         (long long)B * (cin > cout ? cin : cout) * (H + 1) * (W + 1) >=
             (1LL << 31);
}

template <class P>
long long wgrad_scratch(int B, int cin, int H, int W, int cout) {
  const Chunks c2 = wgrad_chunks<P>(B, cout, H + 1, W + 1, cout, 0);
  const Chunks c1 = wgrad_chunks<P>(B, cin, H, W, cout, 1);
  const long long s2 = (long long)c2.count * cout * 4 * cout;
  const long long s1 = (long long)c1.count * cout * 4 * cin;
  return s1 > s2 ? s1 : s2;
}

// Options of the forward (the probe's fused block, scripts/
// pallas_block_probe.py fused_block, is the forward with FWD_RELU_OUT and
// FWD_NO_STATS, no input stage, and y1 kept by the caller).
enum { FWD_RELU_OUT = 1, FWD_NO_STATS = 2 };

// The forward of either instance: y1, y2 and, for bf16, its fp32 values y2f
// (scratch) from which ps and pss are summed.  opts: FWD_RELU_OUT applies a
// ReLU to y2 in conv 2's epilogue, FWD_NO_STATS skips the sums (y2f, part,
// ps and pss are then not touched and may be null).
template <class P>
cudaError_t block_fwd(const typename P::T* x, const float* si,
                      const float* ti, const typename P::T* w1,
                      const float* b1, const typename P::T* w2,
                      const float* b2, typename P::T* y1, typename P::T* y2,
                      float* y2f, float* part, float* ps, float* pss, int B,
                      int cin, int H, int W, int cout, int flags, int opts,
                      cudaStream_t st) {
  const bool stats_on = !(opts & FWD_NO_STATS);
  cudaError_t e = conv2x2<P>(x, si, ti, flags, w1, b1, nullptr, y1, nullptr,
                             B, cin, H, W, cout, 1, EPI_BIAS_RELU, st);
  if (e != cudaSuccess) return e;
  e = conv2x2<P>(y1, nullptr, nullptr, 0, w2, b2, nullptr, y2,
                 stats_on ? y2f : nullptr, B, cout, H + 1, W + 1, cout, 0,
                 (opts & FWD_RELU_OUT) ? EPI_BIAS_RELU : EPI_BIAS, st);
  if (e != cudaSuccess || !stats_on) return e;
  const float* stats = y2f != nullptr ? y2f : (const float*)y2;
  plane_kernel<PLANE_STATS, float, float><<<dim3(cout, B), THREADS, 0, st>>>(
      stats, nullptr, nullptr, nullptr, 0, nullptr, (float*)nullptr, part, B,
      cout, H * W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = sum_images(part, B, cout, ps, st);
  if (e != cudaSuccess) return e;
  return sum_images(part + (long long)B * cout, B, cout, pss, st);
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
  return wgrad_scratch<Tf32x3>(B, cin, H, W, cout);
}

// Floats of the wgrad scratch that mmlf_conv_block_bwd_bf16 needs.
long long mmlf_conv_block_wgrad_scratch_bf16(int B, int cin, int H, int W,
                                             int cout) {
  return wgrad_scratch<Bf16>(B, cin, H, W, cout);
}

// Forward.  x (B, Cin, H, W); si, ti (Cin) (read only with affine_in); w1
// (Cout, 4 Cin) and w2 (Cout, 4 Cout) GEMM weights (OIHW flattened: K-major,
// k = ci*4 + tap); b1, b2 (Cout).  Writes y1 (B, Cout, H+1, W+1), y2
// (B, Cout, H, W), part (2 B Cout, scratch), ps and pss (Cout).  opts:
// FWD_RELU_OUT, FWD_NO_STATS (part, ps and pss unused, may be null).
int mmlf_conv_block_fwd(const float* x, const float* si, const float* ti,
                        const float* w1, const float* b1, const float* w2,
                        const float* b2, float* y1, float* y2, float* part,
                        float* ps, float* pss, int B, int cin, int H, int W,
                        int cout, int relu_in, int affine_in, int opts,
                        int device, void* stream) {
  if (bad_shape(B, cin, H, W, cout)) return (int)cudaErrorInvalidValue;
  MMLF_TRY(cudaSetDevice(device));
  const int flags = (affine_in ? IN_AFFINE : 0) | (relu_in ? IN_RELU : 0);
  MMLF_TRY(block_fwd<Tf32x3>(x, si, ti, w1, b1, w2, b2, y1, y2, nullptr,
                             part, ps, pss, B, cin, H, W, cout, flags, opts,
                             (cudaStream_t)stream));
  return (int)cudaSuccess;
}

// Forward, bfloat16 canvases (bf16 as 16-bit words).  x (B, Cin, H, W)
// bf16; si, ti, b1, b2 fp32; w1 (Cin8 / 8, Cout, 32) and w2 (Cout8 / 8,
// Cout, 32) bf16 GEMM weights, stage-major: K zero-padded to whole stages
// (C8 = C rounded up to 8), then the 32 k of each stage for every output
// channel in turn.  x, y1 and the weights are 16-byte aligned, and the
// allocations of x and y1 run on to the next 16-byte boundary (the bulk
// copies read whole 16-byte chunks).  Writes y1 (bf16), y2 (bf16), y2f
// (B, Cout, H, W, fp32 scratch), part, ps and pss as the fp32 forward
// (with FWD_NO_STATS none of y2f, part, ps, pss, which may be null).
int mmlf_conv_block_fwd_bf16(const uint16_t* x, const float* si,
                             const float* ti, const uint16_t* w1,
                             const float* b1, const uint16_t* w2,
                             const float* b2, uint16_t* y1, uint16_t* y2,
                             float* y2f, float* part, float* ps, float* pss,
                             int B, int cin, int H, int W, int cout,
                             int relu_in, int affine_in, int opts, int device,
                             void* stream) {
  if (bad_shape(B, cin, H, W, cout)) return (int)cudaErrorInvalidValue;
  if (misaligned(x) || misaligned(y1) || misaligned(w1) || misaligned(w2))
    return (int)cudaErrorMisalignedAddress;
  MMLF_TRY(cudaSetDevice(device));
  const int flags = (affine_in ? IN_AFFINE : 0) | (relu_in ? IN_RELU : 0);
  MMLF_TRY(block_fwd<Bf16>(x, si, ti, w1, b1, w2, b2, y1, y2, y2f, part, ps,
                           pss, B, cin, H, W, cout, flags, opts,
                           (cudaStream_t)stream));
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
  using P = Tf32x3;

  // y1 again, from the x residual
  MMLF_TRY(conv2x2<P>(x, si, ti, flags, w1, b1, nullptr, y1, nullptr, B, cin,
                      H, W, cout, 1, EPI_BIAS_RELU, st));
  // g2 and db2
  plane_kernel<PLANE_G2, float, float><<<dim3(cout, B), THREADS, 0, st>>>(
      dy2, y2, dps, dpss, 0, nullptr, g2, bpart, B, cout, H * W);
  MMLF_TRY(cudaGetLastError());
  MMLF_TRY(sum_images(bpart, B, cout, db2, st));
  // dy1 = [y1 > 0] dgrad2(g2) and db1
  MMLF_TRY(conv2x2<P>(g2, nullptr, nullptr, 0, w2dg, nullptr, y1, dy1,
                      nullptr, B, cout, H, W, cout, 1, EPI_MASK, st));
  plane_kernel<PLANE_SUM, float, float><<<dim3(cout, B), THREADS, 0, st>>>(
      dy1, nullptr, nullptr, nullptr, 0, nullptr, (float*)nullptr, bpart, B,
      cout, H1 * W1);
  MMLF_TRY(cudaGetLastError());
  MMLF_TRY(sum_images(bpart, B, cout, db1, st));
  // dz = dgrad1(dy1) into dx, then the input stage's backward in place
  MMLF_TRY(conv2x2<P>(dy1, nullptr, nullptr, 0, w1dg, nullptr, nullptr, dx,
                      nullptr, B, cout, H1, W1, cin, 0, EPI_BIAS, st));
  if (flags) {
    plane_kernel<PLANE_IN_BWD, float, float>
        <<<dim3(cin, B), THREADS, 0, st>>>(x, nullptr, si, ti, flags, dx, dx,
                                           bpart, B, cin, H * W);
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
  MMLF_TRY(wgrad<P>(g2, y1, nullptr, nullptr, 0, wpart, dw2, B, cout, H1, W1,
                    cout, 0, st));
  MMLF_TRY(wgrad<P>(dy1, x, si, ti, flags, wpart, dw1, B, cin, H, W, cout, 1,
                    st));
  return (int)cudaSuccess;
}

// Backward, bfloat16 canvases.  x, y2, dy2 bf16; w1 (Cin8 / 8, Cout, 32),
// w1dg (Cout8 / 8, Cin, 32), w2dg (Cout8 / 8, Cout, 32) bf16 GEMM weights,
// stage-major as in the forward; si, ti, b1, dps, dpss fp32.  Scratch: y1
// (bf16, B, Cout, H+1, W+1), g2 (bf16, B, Cout, H, W), dy1 (fp32) and dy1h
// (bf16) (B, Cout, H+1, W+1), dz (fp32, B, Cin, H, W), wpart
// (mmlf_conv_block_wgrad_scratch_bf16 floats), bpart (2 B max(Cin, Cout)).
// x, y1, g2, dy1h and the weights are 16-byte aligned, and the allocations
// of x, y1, g2 and dy1h run on to the next 16-byte boundary.  Writes dx
// (bf16, B, Cin, H, W) and the fp32 dw1, db1, dw2, db2, dsi, dti as the
// fp32 backward.
int mmlf_conv_block_bwd_bf16(const uint16_t* x, const float* si,
                             const float* ti, const uint16_t* w1,
                             const float* b1, const uint16_t* w1dg,
                             const uint16_t* w2dg, const uint16_t* y2,
                             const uint16_t* dy2, const float* dps,
                             const float* dpss, uint16_t* y1, uint16_t* g2,
                             float* dy1, uint16_t* dy1h, float* dz,
                             float* wpart, float* bpart, uint16_t* dx,
                             float* dw1, float* db1, float* dw2, float* db2,
                             float* dsi, float* dti, int B, int cin, int H,
                             int W, int cout, int relu_in, int affine_in,
                             int device, void* stream) {
  if (bad_shape(B, cin, H, W, cout)) return (int)cudaErrorInvalidValue;
  if (misaligned(x) || misaligned(y1) || misaligned(g2) ||
      misaligned(dy1h) || misaligned(w1) || misaligned(w1dg) ||
      misaligned(w2dg))
    return (int)cudaErrorMisalignedAddress;
  MMLF_TRY(cudaSetDevice(device));
  const cudaStream_t st = (cudaStream_t)stream;
  const int flags = (affine_in ? IN_AFFINE : 0) | (relu_in ? IN_RELU : 0);
  const int H1 = H + 1, W1 = W + 1;
  using P = Bf16;

  // y1 again, from the x residual
  MMLF_TRY(conv2x2<P>(x, si, ti, flags, w1, b1, nullptr, y1, nullptr, B, cin,
                      H, W, cout, 1, EPI_BIAS_RELU, st));
  // g2 (fp32, summed into db2; stored as bf16 for its products)
  plane_kernel<PLANE_G2, uint16_t, uint16_t>
      <<<dim3(cout, B), THREADS, 0, st>>>(dy2, y2, dps, dpss, 0, nullptr, g2,
                                          bpart, B, cout, H * W);
  MMLF_TRY(cudaGetLastError());
  MMLF_TRY(sum_images(bpart, B, cout, db2, st));
  // dy1 = [y1 > 0] dgrad2(g2) in fp32, db1 from it, dy1h its bf16 copy
  MMLF_TRY(conv2x2<P>(g2, nullptr, nullptr, 0, w2dg, nullptr, y1, dy1,
                      nullptr, B, cout, H, W, cout, 1, EPI_MASK, st));
  plane_kernel<PLANE_SUM, float, uint16_t>
      <<<dim3(cout, B), THREADS, 0, st>>>(dy1, nullptr, nullptr, nullptr, 0,
                                          nullptr, dy1h, bpart, B, cout,
                                          H1 * W1);
  MMLF_TRY(cudaGetLastError());
  MMLF_TRY(sum_images(bpart, B, cout, db1, st));
  // dz = dgrad1(dy1) in fp32, then the input stage's backward into dx
  MMLF_TRY(conv2x2<P>(dy1h, nullptr, nullptr, 0, w1dg, nullptr, nullptr, dz,
                      nullptr, B, cout, H1, W1, cin, 0, EPI_BIAS, st));
  plane_kernel<PLANE_IN_BWD, uint16_t, uint16_t>
      <<<dim3(cin, B), THREADS, 0, st>>>(x, nullptr, si, ti, flags, dz, dx,
                                         bpart, B, cin, H * W);
  MMLF_TRY(cudaGetLastError());
  if (affine_in) {
    MMLF_TRY(sum_images(bpart, B, cin, dsi, st));
    MMLF_TRY(sum_images(bpart + (long long)B * cin, B, cin, dti, st));
  } else {
    MMLF_TRY(cudaMemsetAsync(dsi, 0, sizeof(float) * cin, st));
    MMLF_TRY(cudaMemsetAsync(dti, 0, sizeof(float) * cin, st));
  }
  // weight gradients: dW2 = sum g2 (x) taps(y1), dW1 = sum dy1 (x) taps(z)
  MMLF_TRY(wgrad<P>(g2, y1, nullptr, nullptr, 0, wpart, dw2, B, cout, H1, W1,
                    cout, 0, st));
  MMLF_TRY(wgrad<P>(dy1h, x, si, ti, flags, wpart, dw1, B, cin, H, W, cout, 1,
                    st));
  return (int)cudaSuccess;
}

const char* mmlf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
