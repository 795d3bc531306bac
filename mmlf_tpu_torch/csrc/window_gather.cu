// Training-window gather from the packed scene pyramid, written for Hopper.
//
// Replaces the Pallas TPU kernel mmlf_tpu/ops/pallas/window_gather.py
// (_gather_kernel / pallas_window_gather).  For every sample b it copies
// one win x win window of scene s[b] at pyramid level lev[b], starting at
// row wy[b] and column wx[b], from three packed fields:
//
//   img  (S, Hf, Wf, CI)        -> out_img (B, win, win, CI)  fp32 or bf16
//   aux  (S, Hf, Wf * 8)        -> out_aux (B, win, win * 8)
//   mpi  (S, Hf, Wf * 64)       -> out_mpi (B, win, win * 64)   (optional)
//
// It is a pure copy and reads only the selected level.  The packed layout
// and the padded channel counts are kept, so the output is bit-identical
// to the TPU kernel's.  The image field is float32, or bfloat16 under
// --cache_bf16 (the TPU kernel returns it in the cache's dtype); aux and
// mpi are always float32.  The kernel moves 16-byte words and only the
// image row's word count depends on the element size.
//
// What bounds it on an H100 SXM: bytes.  Each window row of a field is
// one contiguous run in both the source and the output (64 KiB of img,
// 4 KiB of aux and 32 KiB of mpi at win = 128, CI = 128), so the work is
// B * win * win * (CI * e + (8 [+ 64]) * 4) bytes read and the same
// written, e the image element's bytes: 1.14 GB at B = 64 without the MPI
// field, ~0.34 ms at 3.35 TB/s, and 0.60 GB, ~0.18 ms, with a bf16 image
// field.  The
// design keeps every access a 16-byte vector on consecutive addresses:
//   * one block per (window row, sample); it reads the sample's scene,
//     level and offsets once and picks the level's base pointers from a
//     table passed by value (up to MAX_LEVELS levels);
//   * the block's threads walk the three row runs with float4 loads and
//     stores, neighbouring threads on neighbouring 16-byte words;
//   * without the MPI field the block skips it, so those bytes are never
//     read.
// TMA bulk copies and persistent blocks are left to a later version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;
constexpr int AUX_CH = 8;
constexpr int MPI_CH = 64;

struct Levels {
  const float4* img[MAX_LEVELS];
  const float4* aux[MAX_LEVELS];
  const float4* mpi[MAX_LEVELS];
  int height[MAX_LEVELS];
  int width[MAX_LEVELS];
};

__device__ __forceinline__ void copy_run(const float4* __restrict__ src,
                                         float4* __restrict__ dst, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(THREADS)
window_gather_kernel(Levels lv, const int* __restrict__ idx, int n_batch,
                     int win, int img4, int with_mpi,
                     float4* __restrict__ out_img,
                     float4* __restrict__ out_aux,
                     float4* __restrict__ out_mpi) {
  const int r = blockIdx.x;            // window row
  const int b = blockIdx.y;            // sample
  const int s = idx[b];
  const int lev = idx[n_batch + b];
  const int wy = idx[2 * n_batch + b];
  const int wx = idx[3 * n_batch + b];
  const long long row = (long long)s * lv.height[lev] + wy + r;
  const long long pix = row * lv.width[lev] + wx;   // first source pixel
  const long long out_row = (long long)b * win + r;

  copy_run(lv.img[lev] + pix * img4, out_img + out_row * win * img4,
           win * img4);
  constexpr int aux4 = AUX_CH / 4;
  copy_run(lv.aux[lev] + pix * aux4, out_aux + out_row * win * aux4,
           win * aux4);
  if (with_mpi) {
    constexpr int mpi4 = MPI_CH / 4;
    copy_run(lv.mpi[lev] + pix * mpi4, out_mpi + out_row * win * mpi4,
             win * mpi4);
  }
}

}  // namespace

extern "C" {

int mmlf_window_gather_max_levels() { return MAX_LEVELS; }

// img / aux / mpi: host arrays of n_levels device pointers (mpi may hold
// nulls when with_mpi is 0); heights / widths: host arrays of the levels'
// Hf and Wf; idx: device int32 (4, n_batch) = scene, level, wy, wx;
// img_bytes: 4 (float32) or 2 (bfloat16) bytes an image element.  The
// caller validates the indices against the level shapes.
int mmlf_window_gather_launch(const void* const* img, const void* const* aux,
                              const void* const* mpi, const int* heights,
                              const int* widths, int n_levels,
                              const void* idx, int n_batch, int win, int ci,
                              int img_bytes, int with_mpi, void* out_img,
                              void* out_aux,
                              void* out_mpi, int device, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_batch < 1 ||
      n_batch > 65535 || win < 1 || ci < 1 ||
      (img_bytes != 2 && img_bytes != 4) || (ci * img_bytes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const bool used = l < n_levels;
    lv.img[l] = used ? (const float4*)img[l] : nullptr;
    lv.aux[l] = used ? (const float4*)aux[l] : nullptr;
    lv.mpi[l] = used && with_mpi ? (const float4*)mpi[l] : nullptr;
    lv.height[l] = used ? heights[l] : 0;
    lv.width[l] = used ? widths[l] : 0;
  }
  const dim3 grid((unsigned)win, (unsigned)n_batch);
  window_gather_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      lv, (const int*)idx, n_batch, win, ci * img_bytes / 16, with_mpi,
      (float4*)out_img, (float4*)out_aux, (float4*)out_mpi);
  return (int)cudaGetLastError();
}

const char* mmlf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
