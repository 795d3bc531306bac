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
// P = 512^2) it evaluates K*Kb*P = 1.28e9 exponentials.  The exponential
// runs on the special-function units (MUFU.EX2), 16 per clock per SM:
// 132 SMs * 16 * ~1.98 GHz = ~4.2e12/s, so ~0.31 ms.  The rest of the work
// per term is three fp32 ops (sub, mul, fma), 3.8e9 ops in all, ~0.06 ms
// at 67 TFLOP/s; the bytes are two (K, P) reads and one (P, Kb) write,
// ~220 MB, ~0.07 ms at 3.35 TB/s.  So the kernel is bound by the
// exponentials.  Its design keeps everything else off that path:
//   * -log2(e)/v and 1/(2v) are computed once per (member, pixel), at
//     staging, and reused for every bin; each term is then sub, mul, ex2,
//     fma;
//   * the exponential is ex2.approx.ftz on a pre-scaled argument (one MUFU
//     op, no range-reduction sequence);
//   * sums stay in fp32 registers across the member loop;
//   * a block stages its pixels' locations and factors for a chunk of 32
//     members in shared memory with coalesced reads, so the exponential
//     loop never waits on device memory and each value is read once;
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

namespace {

constexpr int TILE_P = 32;
constexpr int WARPS = 8;
constexpr int THREADS = TILE_P * WARPS;
constexpr int MAX_BPT = 16;     // bins per thread and pass, at most
constexpr int MEMBER_CHUNK = 32;
// shared memory: the output tile (TILE_P x n_bins) plus three staged
// (MEMBER_CHUNK x TILE_P) member arrays; 256 bins keep it under 48 KB
constexpr int MAX_BINS = 256;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int BPT>
__global__ void __launch_bounds__(THREADS)
mixture_posterior_kernel(const float* __restrict__ means,
                         const float* __restrict__ scales,
                         const float* __restrict__ bins,
                         float* __restrict__ out,
                         int n_members, long long n_pixels, int n_bins) {
  extern __shared__ float smem[];
  float* tile = smem;                            // [TILE_P][n_bins]
  float* st_m = smem + TILE_P * n_bins;          // [MEMBER_CHUNK][TILE_P]
  float* st_s = st_m + MEMBER_CHUNK * TILE_P;    // -log2(e) / v
  float* st_c = st_s + MEMBER_CHUNK * TILE_P;    // 1 / (2 v)

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
        st_m[idx] = m;
        st_s[idx] = s;
        st_c[idx] = c;
      }
      __syncthreads();

      for (int kk = 0; kk < kc; ++kk) {
        const float m = st_m[kk * TILE_P + lane];
        const float s = st_s[kk * TILE_P + lane];
        const float c = st_c[kk * TILE_P + lane];
#pragma unroll
        for (int i = 0; i < BPT; ++i)
          acc[i] = fmaf(c, ex2_approx(fabsf(bin[i] - m) * s), acc[i]);
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
      sizeof(float) * TILE_P * ((size_t)n_bins + 3 * MEMBER_CHUNK);
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
