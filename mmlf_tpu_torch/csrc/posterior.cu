// Laplace-mixture posterior for the shift ensemble (ESE), written for Hopper.
//
// Replaces the Pallas TPU kernel mmlf_tpu/ops/pallas/posterior.py
// (_mixture_kernel / laplace_mixture_posterior).  It computes
//
//     out[p, j] = (1/K) * sum_k exp(-|bins[j] - m[k,p]| / v[k,p]) / (2 v[k,p])
//
// for K members, Kb bins and P pixels, and writes the bins-last (P, Kb)
// layout that the ensemble returns, so no transpose pass follows.
//
// What bounds it on an H100 SXM: at the ESE shape (K = Kb = 70,
// P = 512^2) it evaluates K*Kb*P = 1.28e9 exponentials.  MUFU.EX2, the
// special-function units' exponential, gives 16 results per clock per SM:
// 132 SMs * 16 * ~1.98 GHz = ~4.2e12/s, so ~0.31 ms if every exponential
// took it.  The bytes are two (K, P) reads and one (P, Kb) write, ~220 MB,
// ~0.07 ms at 3.35 TB/s.  A MUFU term costs four issue slots (sub, mul,
// ex2, fma) where the special-function unit takes eight clocks per warp,
// so the issue slots and the fp32 pipe are half idle.  The kernel
// therefore splits the exponentials between the two pipes: a fixed share
// of each thread's bins takes exp2_poly (exp2_poly.cuh: clamp, split,
// five FFMAs, exponent add; 13 issue slots, none on the MUFU), the rest
// ex2.approx.ftz (one MUFU.EX2).  Counting issue slots, the two would
// balance at 8 (1 - f) = 4 + 9 f, f ~ 0.24; on the card a polynomial term
// costs more than its 13 slots and the fastest share is one bin of the
// nine a thread holds at Kb = 70 (2 of 9 and more are slower: PERF.md).
// The share is fixed at compile time by the bin's slot in the unrolled
// loop (slot i takes the polynomial when i % 5 == 4), so no warp
// diverges.  The member loop is unrolled twice.  Up to 9 bins a thread
// (Kb <= 72) the launch bound caps registers for 5 resident blocks a SM
// (48, no spills; left alone the unrolled loop takes 64 and 4 blocks, and
// runs slower); more bins a thread (a finer --val_disp_step) need more
// accumulators than 48 registers hold, and take no cap.
//
// The rest of the design keeps everything else off that path:
//   * -log2(e)/v and 1/(2v) are computed once per (member, pixel), at
//     staging, and reused for every bin;
//   * each term's argument is |bin - m| * s (sub, mul).  Folding it into
//     one FFMA on a staged m*s (fma(bin, s, -m*s)) would save an issue
//     slot, but the rounding of m*s then sits in every argument near
//     m = bin, and the output's error against float64 grows past 4x the
//     plain fp32 version's;
//   * sums stay in fp32 registers across the member loop;
//   * a block stages its pixels' (m, s, c) for a chunk of 32 members in
//     shared memory with coalesced reads, one 16-byte entry per member
//     and pixel, so each term reads no device memory and each member
//     costs one shared-memory load;
//   * the block's (pixels x bins) tile is staged in shared memory and
//     written out as one contiguous, coalesced run of the (P, Kb) output.
//
// Layout: a block owns TILE_P = 32 consecutive pixels.  Lane l of every
// warp owns pixel p0 + l; warp w owns bins w, w + WARPS, w + 2*WARPS, ...,
// BPT of them per pass (a template parameter: ceil(Kb / 8) up to 16, so 9
// at Kb = 70; more bins take more passes).
// The ragged pixel edge is masked in the kernel; there is no padding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exp2_poly.cuh"

namespace {

constexpr int TILE_P = 32;
constexpr int WARPS = 8;
constexpr int THREADS = TILE_P * WARPS;
constexpr int MAX_BPT = 16;     // bins per thread and pass, at most
constexpr int MEMBER_CHUNK = 32;
// shared memory: the output tile (TILE_P x n_bins) plus the staged
// (MEMBER_CHUNK x TILE_P) member entries of four floats; 256 bins keep it
// within 48 KB
constexpr int MAX_BINS = 256;
constexpr int POLY_EVERY = 5;   // bin slot i % POLY_EVERY == 4: polynomial
constexpr int LEAN_BPT = 9;     // up to here, registers for 5 blocks a SM

__device__ __forceinline__ constexpr bool takes_poly(int i) {
  return i % POLY_EVERY == POLY_EVERY - 1;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int BPT>
__global__ void __launch_bounds__(THREADS, BPT <= LEAN_BPT ? 5 : 1)
mixture_posterior_kernel(const float* __restrict__ means,
                         const float* __restrict__ scales,
                         const float* __restrict__ bins,
                         float* __restrict__ out,
                         int n_members, long long n_pixels, int n_bins) {
  extern __shared__ float smem[];
  float* tile = smem;                            // [TILE_P][n_bins]
  // [MEMBER_CHUNK][TILE_P] of (m, s = -log2(e) / v, c = 1 / (2 v), pad)
  float4* staged = reinterpret_cast<float4*>(smem + TILE_P * n_bins);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long p0 = (long long)blockIdx.x * TILE_P;
  const float inv_k = 1.0f / (float)n_members;
  const float log2e = 1.4426950408889634f;

  for (int b0 = 0; b0 < n_bins; b0 += WARPS * BPT) {
    // this warp's bins in this pass: b0 + warp + i * WARPS, i < BPT.  Every
    // warp computes exactly BPT of them (a bin past n_bins repeats the last
    // one and is dropped at the store), so the exponential loop below
    // carries no per-bin predicate
    float bin[BPT];
    float acc[BPT];
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      bin[i] = bins[min(b0 + warp + i * WARPS, n_bins - 1)];
      acc[i] = 0.0f;
    }

    for (int k0 = 0; k0 < n_members; k0 += MEMBER_CHUNK) {
      const int kc = min(MEMBER_CHUNK, n_members - k0);
      // stage the chunk's locations and per-(member, pixel) factors once
      // for the block: coalesced reads, one division per member and pixel
      // (a pixel past the edge gets c = 0 and adds nothing)
      __syncthreads();
      for (int idx = threadIdx.x; idx < kc * TILE_P; idx += THREADS) {
        const int kk = idx / TILE_P;
        const long long p = p0 + (idx % TILE_P);
        float m = 0.0f, s = 0.0f, c = 0.0f;
        if (p < n_pixels) {
          m = means[(long long)(k0 + kk) * n_pixels + p];
          const float rv = 1.0f / scales[(long long)(k0 + kk) * n_pixels + p];
          s = -log2e * rv;    // exp(-d/v) == 2^(-d*log2e/v)
          c = 0.5f * rv;
        }
        staged[idx] = make_float4(m, s, c, 0.0f);
      }
      __syncthreads();

#pragma unroll 2
      for (int kk = 0; kk < kc; ++kk) {
        const float4 e = staged[kk * TILE_P + lane];
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
          // the exponent, <= 0: -|bin - m| * log2(e) / v
          const float x = fabsf(bin[i] - e.x) * e.y;
          const float t = takes_poly(i) ? mmlf::exp2_poly(x) : ex2_approx(x);
          acc[i] = fmaf(e.z, t, acc[i]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int j = b0 + warp + i * WARPS;
      if (j < n_bins) tile[lane * n_bins + j] = acc[i] * inv_k;
    }
  }
  __syncthreads();

  // the block's pixels are consecutive, so its part of the (P, Kb) output
  // is one contiguous run of n_valid * n_bins floats
  const long long left = n_pixels - p0;
  const int n_valid = left < TILE_P ? (int)left : TILE_P;
  const int count = n_valid * n_bins;
  float* dst = out + p0 * n_bins;
  for (int i = threadIdx.x; i < count; i += THREADS) dst[i] = tile[i];
}

}  // namespace

extern "C" {

// The largest bin count one launch takes (the shared-memory tile's limit).
int mmlf_posterior_max_bins() { return MAX_BINS; }

// Launch on `stream` (a cudaStream_t as an opaque pointer).  Returns the
// cudaError_t of the launch; 0 is success.  Does not synchronize.
int mmlf_posterior_launch(const void* means, const void* scales,
                          const void* bins, void* out, int n_members,
                          long long n_pixels, int n_bins, int device,
                          void* stream) {
  if (n_bins < 1 || n_bins > MAX_BINS || n_members < 1 || n_pixels < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_pixels + TILE_P - 1) / TILE_P;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem =
      sizeof(float) * TILE_P * ((size_t)n_bins + 4 * MEMBER_CHUNK);
  // the fewest bins per thread that cover n_bins in one pass (up to 16)
  const int bpt = min(MAX_BPT, (n_bins + WARPS - 1) / WARPS);
  const dim3 grid((unsigned)blocks);
  cudaStream_t st = (cudaStream_t)stream;
  const float* m = (const float*)means;
  const float* v = (const float*)scales;
  const float* b = (const float*)bins;
  float* o = (float*)out;
  switch (bpt) {
#define MMLF_CASE(N)                                                       \
  case N:                                                                 \
    mixture_posterior_kernel<N><<<grid, THREADS, smem, st>>>(             \
        m, v, b, o, n_members, n_pixels, n_bins);                         \
    break;
    MMLF_CASE(1) MMLF_CASE(2) MMLF_CASE(3) MMLF_CASE(4)
    MMLF_CASE(5) MMLF_CASE(6) MMLF_CASE(7) MMLF_CASE(8)
    MMLF_CASE(9) MMLF_CASE(10) MMLF_CASE(11) MMLF_CASE(12)
    MMLF_CASE(13) MMLF_CASE(14) MMLF_CASE(15) MMLF_CASE(16)
#undef MMLF_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* mmlf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
